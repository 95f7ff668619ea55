from repro_torch.kernels.rglru.ops import rglru
from repro_torch.kernels.rglru.ref import rglru_plain

__all__ = ["rglru", "rglru_plain"]
