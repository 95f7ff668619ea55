"""llama4-scout-17b-16e [moe]: 48L d5120 40H (GQA kv=8) ff8192
vocab202048, MoE 16 experts top-1.  Treated as full attention (its iRoPE
chunking is out of scope) => long_500k skipped.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch_id="llama4-scout-17b-a16e", family="moe", n_layers=48,
    d_model=5120, n_heads=40, n_kv_heads=8, d_ff=8192, vocab=202048,
    head_dim=128, moe_experts=16, moe_top_k=1, norm="rms", act="swiglu")

SMOKE = ModelConfig(
    arch_id="llama4-scout-smoke", family="moe", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=2, d_ff=96, vocab=512, head_dim=16,
    moe_experts=4, moe_top_k=1, moe_capacity_factor=8.0,
    norm="rms", act="swiglu",
    dtype="float32", param_dtype="float32")
