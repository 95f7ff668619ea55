from repro_torch.hw.spec import (H100, H100Spec, dominant_term,
                                 matmul_class)

__all__ = ["H100", "H100Spec", "dominant_term", "matmul_class"]
