"""llama3-405b [dense]: 126L d16384 128H (GQA kv=8) ff53248 vocab128256.
[arXiv:2407.21783; unverified]

Params are bf16 for this arch (``param_dtype``), as in the reference,
whose train_4k cell keeps bf16 AdamW moments too."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch_id="llama3-405b", family="dense", n_layers=126, d_model=16384,
    n_heads=128, n_kv_heads=8, d_ff=53248, vocab=128256, head_dim=128,
    norm="rms", act="swiglu", param_dtype="bfloat16", rope_theta=500000.0)

SMOKE = ModelConfig(
    arch_id="llama3-405b-smoke", family="dense", n_layers=3, d_model=128,
    n_heads=8, n_kv_heads=2, d_ff=256, vocab=512, head_dim=16,
    norm="rms", act="swiglu", dtype="float32", param_dtype="float32")
