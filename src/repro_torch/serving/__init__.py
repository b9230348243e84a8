from repro_torch.serving.engine import Request, ServingEngine

__all__ = ["Request", "ServingEngine"]
