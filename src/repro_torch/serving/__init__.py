from repro_torch.serving.engine import Request, ServeEngine, WaveStats

__all__ = ["ServeEngine", "Request", "WaveStats"]
