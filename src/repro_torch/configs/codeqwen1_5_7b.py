"""codeqwen1.5-7b [dense]: 32L d4096 32H (kv=32, MHA-style) ff13440
vocab92416. [hf:Qwen/CodeQwen1.5-7B; hf]"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch_id="codeqwen1.5-7b", family="dense", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=32, d_ff=13440, vocab=92416, head_dim=128,
    norm="rms", act="swiglu", rope_theta=1000000.0)

SMOKE = ModelConfig(
    arch_id="codeqwen1.5-7b-smoke", family="dense", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=4, d_ff=192, vocab=512, head_dim=16,
    norm="rms", act="swiglu", dtype="float32", param_dtype="float32")
