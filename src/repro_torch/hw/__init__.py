from repro_torch.hw.spec import (H100, H100Spec, KNL, ClusterSpec,
                                 KnlLikeSpec, dominant_term, matmul_class)

__all__ = ["H100", "H100Spec", "KNL", "ClusterSpec", "KnlLikeSpec",
           "dominant_term", "matmul_class"]
