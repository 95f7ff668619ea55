"""rwkv6-1.6b "Finch" [ssm]: 24L d2048 ff7168 vocab65536 — attention-free,
data-dependent decay; 32 heads of dim 64.  O(1) state => long_500k runs.
[arXiv:2404.05892; unverified]"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch_id="rwkv6-1.6b", family="ssm", n_layers=24, d_model=2048,
    n_heads=32, n_kv_heads=32, d_ff=7168, vocab=65536, head_dim=64)

SMOKE = ModelConfig(
    arch_id="rwkv6-1.6b-smoke", family="ssm", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=4, d_ff=128, vocab=512, head_dim=16,
    dtype="float32", param_dtype="float32")
