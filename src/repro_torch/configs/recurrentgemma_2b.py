"""recurrentgemma-2b [hybrid]: 26L d2560 10H (MQA kv=1) ff7680
vocab256000 — RG-LRU + local attention (window 2048), 1 attn per 2
recurrent blocks.  Bounded state => long_500k runs.
[arXiv:2402.19427; hf]"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch_id="recurrentgemma-2b", family="hybrid", n_layers=26, d_model=2560,
    n_heads=10, n_kv_heads=1, d_ff=7680, vocab=256000, head_dim=256,
    window=2048, block_pattern=("rglru", "rglru", "attn"), rglru_dim=2560,
    logit_softcap=30.0, tie_embeddings=True)

SMOKE = ModelConfig(
    arch_id="recurrentgemma-smoke", family="hybrid", n_layers=5, d_model=64,
    n_heads=2, n_kv_heads=1, d_ff=128, vocab=512, head_dim=32,
    window=8, block_pattern=("rglru", "rglru", "attn"), rglru_dim=64,
    dtype="float32", param_dtype="float32")
