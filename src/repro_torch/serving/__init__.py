from repro_torch.serving.engine import (Request, ServeEngine, WaveStats,
                                        wave_op_graph)

__all__ = ["ServeEngine", "Request", "WaveStats", "wave_op_graph"]
