"""granite-3-8b [dense]: 40L d4096 32H (GQA kv=8) ff12800 vocab49155.
[hf:ibm-granite/granite-3.0-2b-base family; hf]"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch_id="granite-3-8b", family="dense", n_layers=40, d_model=4096,
    n_heads=32, n_kv_heads=8, d_ff=12800, vocab=49155, head_dim=128,
    norm="rms", act="swiglu")

SMOKE = ModelConfig(
    arch_id="granite-3-8b-smoke", family="dense", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=2, d_ff=160, vocab=512, head_dim=16,
    norm="rms", act="swiglu", dtype="float32", param_dtype="float32")
