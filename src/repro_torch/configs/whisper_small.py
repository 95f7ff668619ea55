"""whisper-small [audio]: 12L enc + 12L dec, d768 12H (kv=12) ff3072
vocab51865 — enc-dec; conv/mel frontend is a stub (precomputed frame
embeddings, 1500 frames).  decode_32k exercises the decoder KV cache at
32k synthetically (real whisper caps at 448 tokens — noted, not skipped);
long_500k skipped (full-attention decoder). [arXiv:2212.04356; unverified]"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch_id="whisper-small", family="audio", n_layers=12, d_model=768,
    n_heads=12, n_kv_heads=12, d_ff=3072, vocab=51865, head_dim=64,
    encoder_layers=12, n_frontend_tokens=1500, norm="layernorm", act="gelu")

SMOKE = ModelConfig(
    arch_id="whisper-small-smoke", family="audio", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=4, d_ff=128, vocab=512, head_dim=16,
    encoder_layers=2, n_frontend_tokens=12, norm="layernorm", act="gelu",
    dtype="float32", param_dtype="float32")
