from repro_torch.data.pipeline import (DataConfig, MmapTokens, Prefetcher,
                                       SyntheticLM, make_source)

__all__ = ["DataConfig", "SyntheticLM", "MmapTokens", "make_source",
           "Prefetcher"]
