from repro_torch.serving.engine import (Request, ServeEngine, WaveStats,
                                        prefill_payload_graph, wave_op_graph)
from repro_torch.serving.kvcache import cache_shardings, kv_cache_pspec

__all__ = ["ServeEngine", "Request", "WaveStats", "prefill_payload_graph",
           "wave_op_graph", "kv_cache_pspec", "cache_shardings"]
