"""llama-3.2-vision-11b [vlm]: 40L d4096 32H (GQA kv=8) ff14336
vocab128256 — cross-attention image layers every 5th layer; vision
frontend is a stub (precomputed patch embeddings, 1600 tokens).
Full attention => long_500k skipped.
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch_id="llama-3.2-vision-11b", family="vlm", n_layers=40, d_model=4096,
    n_heads=32, n_kv_heads=8, d_ff=14336, vocab=128256, head_dim=128,
    cross_attn_every=5, n_frontend_tokens=1600, norm="rms", act="swiglu",
    rope_theta=500000.0)

SMOKE = ModelConfig(
    arch_id="llama-3.2-vision-smoke", family="vlm", n_layers=4, d_model=64,
    n_heads=4, n_kv_heads=2, d_ff=128, vocab=512, head_dim=16,
    cross_attn_every=2, n_frontend_tokens=8,
    dtype="float32", param_dtype="float32")
