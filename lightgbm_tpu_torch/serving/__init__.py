"""Hardened prediction service over the device-resident inference engine.

Layers (each importable on its own):

    errors    typed failures with HTTP statuses
    wire      binary request/response framing for /predict
    registry  named models, checksum-verified atomic hot-swap, load-time launch
    breaker   per-entry circuit breaker: closed, degraded, open, half-open
    batcher   micro-batching worker: coalesce, admit, shed, dispatch
    service   in-process facade: validation, warmup, replicas, canary,
              health, stats
    http      stdlib ThreadingHTTPServer front (/predict /models /healthz
              /statz /metrics /debug/flight)

See docs/SERVING.md for the batching contract (the JAX package's service;
its AOT warm start has no counterpart here: the CUDA kernel compiles no
shapes).
"""
from .batcher import MicroBatcher
from .breaker import CircuitBreaker
from .errors import (BreakerOpen, DeadlineExceeded, InvalidRequest, ModelLoadError,
                     ModelNotFound, Overloaded, ServiceClosed, ServingError)
from .http import ServingHTTPServer, serve
from .registry import ModelEntry, ModelRegistry
from .service import PredictionService

__all__ = [
    "BreakerOpen", "CircuitBreaker", "DeadlineExceeded", "InvalidRequest", "MicroBatcher", "ModelEntry",
    "ModelLoadError", "ModelNotFound", "ModelRegistry", "Overloaded",
    "PredictionService", "ServiceClosed", "ServingError",
    "ServingHTTPServer", "serve",
]
