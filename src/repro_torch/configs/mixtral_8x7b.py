"""mixtral-8x7b [moe]: 32L d4096 32H (GQA kv=8) ff14336 vocab32000,
8 experts top-2, sliding-window attention (4096).  SWA bounds the KV
cache, so the long_500k decode cell RUNS for this arch.
[arXiv:2401.04088; hf]"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch_id="mixtral-8x7b", family="moe", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=8, d_ff=14336, vocab=32000, head_dim=128,
    moe_experts=8, moe_top_k=2, window=4096, norm="rms", act="swiglu")

SMOKE = ModelConfig(
    arch_id="mixtral-8x7b-smoke", family="moe", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=2, d_ff=96, vocab=512, head_dim=16,
    moe_experts=4, moe_top_k=2, window=8, moe_capacity_factor=8.0,
    norm="rms", act="swiglu",
    dtype="float32", param_dtype="float32")
