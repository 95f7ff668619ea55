from repro_torch.serving.engine import (Request, ServeEngine, WaveStats,
                                        prefill_payload_graph, wave_op_graph)

__all__ = ["ServeEngine", "Request", "WaveStats", "prefill_payload_graph",
           "wave_op_graph"]
