"""Typed serving errors: the port's copy of kubeflow_tpu/serving/errors.py.

    DeadlineExceeded  -> HTTP 504
    Overloaded        -> HTTP 429 + Retry-After
    BatcherClosed     -> never reaches the wire: ModelServer.predict
                         retries the replacement batcher or falls back
                         to the direct path (hot-swap / drain races)

They live apart from model_server.py so the transport can classify an
exception without importing the batching plane.
"""

from __future__ import annotations


class ServingError(RuntimeError):
    """Base of the typed serving failures."""


class BatcherClosed(ServingError):
    """Raised by submit() on a closed batcher; callers holding a stale
    reference (hot-swap races, drain) retry against the replacement."""


class DeadlineExceeded(ServingError):
    """The request's deadline passed before its result was ready."""


class Overloaded(ServingError):
    """Admission refused: queue depth or in-flight cap reached.
    ``retry_after_s`` rides to the HTTP ``Retry-After`` header."""

    def __init__(self, message: str, retry_after_s: float = 1.0):
        super().__init__(message)
        self.retry_after_s = float(retry_after_s)
