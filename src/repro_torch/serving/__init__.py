"""Serving runtime: continuous-batching engine over the decode-step API."""
from repro_torch.serving.engine import Request, RequestState, ServingEngine

__all__ = ["Request", "RequestState", "ServingEngine"]
