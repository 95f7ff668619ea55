"""olmo-1b [dense]: 16L d2048 16H (kv=16) ff8192 vocab50304 — OLMo's
non-parametric LayerNorm, tied embeddings. [arXiv:2402.00838; hf]"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch_id="olmo-1b", family="dense", n_layers=16, d_model=2048,
    n_heads=16, n_kv_heads=16, d_ff=8192, vocab=50304, head_dim=128,
    norm="nonparam", act="swiglu", tie_embeddings=True)

SMOKE = ModelConfig(
    arch_id="olmo-1b-smoke", family="dense", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=4, d_ff=256, vocab=512, head_dim=16,
    norm="nonparam", act="swiglu", tie_embeddings=True,
    dtype="float32", param_dtype="float32")
