from repro_torch.optim.adamw import (AdamWConfig, abstract_opt_state,
                                     adamw_update, clip_by_global_norm,
                                     global_norm, init_opt_state, schedule_lr)
from repro_torch.optim.compression import (CompressionConfig, compress,
                                           init_error_state, wire_bytes)

__all__ = ["AdamWConfig", "adamw_update", "init_opt_state",
           "abstract_opt_state", "schedule_lr", "global_norm",
           "clip_by_global_norm", "CompressionConfig", "compress",
           "init_error_state", "wire_bytes"]
