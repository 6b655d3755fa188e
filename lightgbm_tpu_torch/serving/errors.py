"""Typed serving errors, each carrying its HTTP status.

The reference's C API reports every failure as -1 + a thread-local string
(LGBM_GetLastError); a long-lived prediction service needs callers to
distinguish "back off" (Overloaded) from "your request is malformed"
(InvalidRequest) from "you waited too long" (DeadlineExceeded) without
string-matching. Every error maps to one HTTP status in serving/http.py and
is importable for in-process callers; nothing here subclasses
LightGBMError, so a service embedded in a training process can catch
serving failures without swallowing training fatals.
"""
from __future__ import annotations


class ServingError(Exception):
    """Base of every typed serving failure."""

    status = 500
    code = "internal_error"


class InvalidRequest(ServingError):
    """Malformed payload: ragged rows, wrong feature count, oversize batch,
    or (opt-in per model) non-finite values — named column included. Always
    raised at the service boundary, never after a device dispatch."""

    status = 400
    code = "invalid_request"


class ModelNotFound(ServingError):
    """No model registered under the requested name."""

    status = 404
    code = "model_not_found"


class ModelLoadError(ServingError):
    """A staged upload failed verification (checksum mismatch, damaged
    sidecar, unparseable model text). The previously serving version — if
    any — is untouched."""

    status = 400
    code = "model_load_error"


class Overloaded(ServingError):
    """Admission queue full: the request was rejected WITHOUT being
    enqueued (bounded memory under flood). HTTP surface: 429 + Retry-After."""

    status = 429
    code = "overloaded"


class BreakerOpen(Overloaded):
    """The model's circuit breaker is OPEN after repeated device dispatch
    failures: its traffic is shed, not answered anywhere else, until the
    cooldown lets a half-open probe try the card again. HTTP surface: 503
    + Retry-After."""

    status = 503
    code = "breaker_open"


class DeadlineExceeded(ServingError):
    """The request's deadline budget expired — either shed from the queue
    before device dispatch, or still in flight when the caller's wait ran
    out. The batch it rode in is never blocked on it."""

    status = 504
    code = "deadline_exceeded"


class ServiceClosed(ServingError):
    """The service is shutting down; pending and new requests fail fast."""

    status = 503
    code = "service_closed"
