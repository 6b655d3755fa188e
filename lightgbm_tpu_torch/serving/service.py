"""PredictionService: the in-process serving facade.

Counterpart of the JAX package's ``serving/service.py``. Wires the
registry, breaker and micro-batchers into one object with the surface the
HTTP front exposes: predict with a deadline, load/unload with checksum
verification, a staged canary, health and stats. Request validation happens
HERE, at the service boundary, before any row is enqueued, so a malformed
payload (ragged rows, wrong feature count, oversize batch, opt-in
non-finite values) costs a typed InvalidRequest naming the problem and
never a device dispatch.

The service runs its models on the CUDA card unless it is built with
``device="cpu"``; with no card it raises at construction.

The service polls telemetry.signals() (every `signal_poll_s`) into the
breaker, so a burst of graph captures or kernel builds, or the card's
memory high-water past the breaker's limit, degrades chunk sizes before
anything fails. An entry whose breaker is OPEN has its requests shed with
a typed 503 (errors.BreakerOpen), never answered on the CPU: /healthz says
"degraded" while any entry's breaker is not closed, and the shed requests
and device failures are counted on /statz, /metrics and /healthz.

Fleet dispatch: `replicas=N` runs N MicroBatcher workers in one process;
each model entry is pinned to a replica at load (round-robin, sticky,
forgotten at unload), so two hot models coalesce and dispatch concurrently
instead of serializing through one worker. On the card each replica's
worker dispatches on its own CUDA stream. The breaker is shared but sharded
per entry (breaker.py).

Not carried: the JAX package's AOT warm-start sidecars (its ``.aot``
bundles of compiled per-bucket executables): the CUDA kernel compiles no
shapes, so there is nothing to warm-start. A row-sharded entry
(``shard_rows``) splits each batch of at least that many rows over the
gang's ranks (parallel/predict.py).
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np

from .. import telemetry, tracing
from ..config import resolve_device
from ..health import first_nonfinite_column
from ..utils.log import Log
from .batcher import MicroBatcher
from .breaker import CLOSED, CircuitBreaker
from .errors import InvalidRequest, ModelNotFound, ServiceClosed
from .registry import ModelRegistry


class PredictionService:
    def __init__(self, device: Optional[str] = None,
                 breaker: Optional[CircuitBreaker] = None,
                 max_batch_rows: int = 4096, max_queue_rows: int = 32768,
                 min_bucket: int = 256, batch_window_s: float = 0.001,
                 max_request_rows: Optional[int] = None,
                 default_timeout_s: Optional[float] = None,
                 signal_poll_s: float = 0.25, replicas: int = 1) -> None:
        self.device = resolve_device(device)
        self.registry = ModelRegistry(self.device)
        self.breaker = breaker or CircuitBreaker()
        self._batchers = [
            MicroBatcher(self.breaker, max_batch_rows=max_batch_rows,
                         max_queue_rows=max_queue_rows, min_bucket=min_bucket,
                         batch_window_s=batch_window_s, device=self.device,
                         name=f"lgbm-serve-batcher-{i}")
            for i in range(max(1, int(replicas)))]
        # replica 0 keeps the single-batcher attribute
        self.batcher = self._batchers[0]
        # model entry name -> replica index: round-robin at first sight,
        # dropped at unload, so a reloaded fleet rebalances
        self._placement: Dict[str, int] = {}
        self._placement_next = 0
        self._placement_lock = threading.Lock()
        self.max_request_rows = max_request_rows or self.batcher.max_batch_rows
        self.default_timeout_s = default_timeout_s
        self.signal_poll_s = signal_poll_s
        self._last_signal_poll = 0.0
        self._started = time.monotonic()
        self._closed = False
        # the staged canary: at most one candidate, None when inactive (the
        # predict hot path pays one is-None check)
        self._canary: Optional[Dict[str, Any]] = None
        self._canary_lock = threading.Lock()
        self._canary_promotions = 0
        self._canary_rollbacks = 0
        # a rollback's flight dump, recorded under the canary lock and
        # written after its release
        self._pending_dump: Optional[str] = None

    # ------------------------------------------------------------ placement

    def _batcher_for(self, name: str) -> MicroBatcher:
        """The replica this entry is pinned to (round-robin at first sight;
        stable until unload)."""
        if len(self._batchers) == 1:
            return self.batcher
        with self._placement_lock:
            idx = self._placement.get(name)
            if idx is None:
                idx = self._placement_next % len(self._batchers)
                self._placement[name] = idx
                self._placement_next += 1
        return self._batchers[idx]

    def _forget_placement(self, name: str) -> None:
        with self._placement_lock:
            self._placement.pop(name, None)

    def placement(self) -> Dict[str, int]:
        with self._placement_lock:
            return dict(self._placement)

    # -------------------------------------------------------------- models

    def load_model(self, name: str, shard_rows: Optional[int] = None,
                   **kwargs: Any) -> Dict[str, Any]:
        """Registry load (which launches the traversal on the service's
        device before publishing), pinning to a replica, and a warmup, so
        the new version's first live request finds its pack on the device.
        With `shard_rows`, a batch of at least that many rows is split over
        the gang's ranks (parallel/predict.py: every rank's service must
        take the same batches), as the booster's pred_shard_rows."""
        if shard_rows is not None and int(shard_rows) < 1:
            raise InvalidRequest(f"shard_rows must be a positive row count, got {shard_rows}")
        entry = self.registry.load(name, **kwargs)
        if shard_rows is not None:
            entry.booster.params["pred_shard_rows"] = int(shard_rows)
        self.breaker.register_entry(name)
        self._batcher_for(name)  # pin the replica before any traffic
        self.warmup(name)
        # warmup builds and captures are expected, not churn
        self.breaker.rebaseline(telemetry.signals())
        return entry.info()

    def unload_model(self, name: str) -> bool:
        self._forget_placement(name)
        self.breaker.forget_entry(name)
        return self.registry.unload(name)

    def models(self) -> List[Dict[str, Any]]:
        return self.registry.info()

    def warmup(self, name: str) -> None:
        """Dispatch one batch of zeros (raw and transformed outputs) on the
        entry's replica stream: packs the ensemble onto the device. The
        kernel has no compiled shapes, so one row count is as good as all."""
        entry = self.registry.get(name)
        zeros = np.zeros((self.batcher.min_bucket, max(entry.n_features, 1)),
                         dtype=np.float32)
        stream = self._batcher_for(name).stream
        for raw in (False, True):
            if stream is not None:
                import torch

                with torch.cuda.stream(stream):
                    entry.predict(zeros, raw)
            else:
                entry.predict(zeros, raw)

    # -------------------------------------------------------------- canary

    def start_canary(self, name: str, *, fraction: float = 0.1,
                     promote_after: int = 32, **kwargs: Any) -> Dict[str, Any]:
        """Stage a candidate for `name` behind a traffic split: every
        round(1/fraction)-th predict of `name` routes to the candidate until
        it serves `promote_after` requests with the breaker closed (full
        swap) or shows pressure (rollback). `kwargs` is load_model's payload
        (booster= / model_str= / path=), kept so promotion replays the exact
        load. One canary at a time: a newer candidate supersedes the
        current one."""
        if not 0.0 < fraction <= 1.0:
            raise ValueError(f"canary fraction must be in (0, 1], got {fraction}")
        canary_name = f"{name}!canary"
        with self._canary_lock:
            if self._canary is not None:
                self._resolve_canary_locked(False, "superseded by a newer candidate")
            entry = self.registry.load(canary_name, **kwargs)
            self.breaker.register_entry(canary_name)
            self.warmup(canary_name)
            self.breaker.rebaseline(telemetry.signals())
            self._canary = {
                "model": name,
                "canary": canary_name,
                "fraction": float(fraction),
                "every": max(1, int(round(1.0 / float(fraction)))),
                "promote_after": int(promote_after),
                "served": 0,
                "seen": 0,
                "payload": dict(kwargs),
                "version": entry.version,
            }
        self._maybe_dump()
        tracing.note("canary_started", model=name, fraction=float(fraction),
                     promote_after=int(promote_after))
        if telemetry.enabled():
            telemetry.emit("canary_started", model=name, fraction=float(fraction),
                           promote_after=int(promote_after))
        return entry.info()

    def _canary_route(self, model: str):
        """The canary's entry when THIS request is the candidate's turn,
        else None. Breaker pressure seen here rolls the canary back first."""
        with self._canary_lock:
            entry = self._canary_route_locked(model)
        self._maybe_dump()
        return entry

    def _canary_route_locked(self, model: str):
        c = self._canary
        if c is None or c["model"] != model:
            return None
        if self.breaker.info()["state"] != CLOSED:
            self._resolve_canary_locked(False, "breaker pressure during canary window")
            return None
        c["seen"] += 1
        if c["seen"] % c["every"] != 0:
            return None
        try:
            return self.registry.get(c["canary"])
        except ModelNotFound:
            self._canary = None
            return None

    def _canary_served(self, model: str) -> None:
        with self._canary_lock:
            c = self._canary
            if c is not None and c["model"] == model:
                c["served"] += 1
                if c["served"] >= c["promote_after"] \
                        and self.breaker.info()["state"] == CLOSED:
                    self._resolve_canary_locked(True, "served its window clean")
        self._maybe_dump()

    def resolve_canary(self, promote: bool, reason: str = "") -> bool:
        """Finish the canary now: promote the candidate to the primary
        slot, or roll it back and keep serving the current model. Returns
        False when no canary is active."""
        with self._canary_lock:
            out = self._resolve_canary_locked(promote, reason)
        self._maybe_dump()
        return out

    def _maybe_dump(self) -> None:
        """Write the flight dump a locked canary transition recorded, with
        the canary lock released (the dump does file I/O)."""
        tag, self._pending_dump = self._pending_dump, None
        if tag is not None:
            tracing.dump_flight(tag)

    def _resolve_canary_locked(self, promote: bool, reason: str) -> bool:
        c = self._canary
        if c is None:
            return False
        self._canary = None
        if promote:
            self.registry.load(c["model"], **c["payload"])
            self.warmup(c["model"])
            self.breaker.rebaseline(telemetry.signals())
            self.registry.unload(c["canary"])
            self._forget_placement(c["canary"])
            self.breaker.forget_entry(c["canary"])
            self._canary_promotions += 1
            Log.info("serving: canary for %r promoted after %d canary requests (%s)",
                     c["model"], c["served"], reason)
            tracing.note("canary_promoted", model=c["model"], served=c["served"])
            if telemetry.enabled():
                telemetry.emit("canary_promoted", model=c["model"], served=c["served"])
        else:
            self.registry.unload(c["canary"])
            self._forget_placement(c["canary"])
            self.breaker.forget_entry(c["canary"])
            self._canary_rollbacks += 1
            Log.warning("serving: canary for %r rolled back after %d canary requests: "
                        "%s; primary keeps serving", c["model"], c["served"],
                        reason or "unspecified")
            tracing.note("canary_rolled_back", model=c["model"], served=c["served"],
                         reason=reason)
            if telemetry.enabled():
                telemetry.emit("canary_rolled_back", model=c["model"],
                               served=c["served"], reason=reason)
            self._pending_dump = "canary_rollback"
        return True

    def canary_info(self) -> Dict[str, Any]:
        with self._canary_lock:
            c = self._canary
            out = {"active": c is not None,
                   "promoted": self._canary_promotions,
                   "rolled_back": self._canary_rollbacks}
            if c is not None:
                out.update(model=c["model"], fraction=c["fraction"],
                           served=c["served"], promote_after=c["promote_after"])
            return out

    # ------------------------------------------------------------- predict

    def predict(self, model: str, rows: Any, raw_score: bool = False,
                timeout_s: Optional[float] = None,
                span: Optional[tracing.Span] = None) -> np.ndarray:
        """`span` is the request-scoped trace span; the HTTP front passes
        one carrying the inbound traceparent context (and finishes it
        after serialize), an in-process caller gets one made — and
        finished — here, so every admitted request is traced either way."""
        own_span = span is None
        if own_span:
            span = tracing.start_span("serve_request")
        t_parse = time.perf_counter()
        try:
            if self._closed:
                raise ServiceClosed("service is shutting down")
            self._poll_signals()
            entry = self.registry.get(model)
            X = self._validate(entry, rows)
            span.add_stage("parse", time.perf_counter() - t_parse)
            timeout = (timeout_s if timeout_s is not None
                       else self.default_timeout_s)
            batcher = self._batcher_for(entry.name)
            if self._canary is not None:
                canary_entry = self._canary_route(model)
                if canary_entry is not None:
                    try:
                        out = self._batcher_for(canary_entry.name).submit(
                            canary_entry, X, raw_score, timeout, span=span)
                    except Exception as exc:  # noqa: BLE001 - rolled back, answered
                        # the candidate failed a live request: roll it back
                        # and answer from the primary
                        self.resolve_canary(False, f"candidate request failed: {exc}")
                        return batcher.submit(entry, X, raw_score, timeout, span=span)
                    self._canary_served(model)
                    return out
            return batcher.submit(entry, X, raw_score, timeout, span=span)
        finally:
            if own_span:
                span.finish()

    def _validate(self, entry, rows: Any) -> np.ndarray:
        if isinstance(rows, np.ndarray) and rows.dtype == np.float32 \
                and rows.ndim == 2 and rows.flags["C_CONTIGUOUS"]:
            # binary-wire fast path: the decoder already produced exactly
            # the dtype/layout the batcher dispatches, so the f64 round
            # trip below (a full copy per request) is skipped; the shape
            # and finiteness checks still run on the view
            X = rows
        else:
            try:
                X = np.asarray(rows, dtype=np.float64)
            except (ValueError, TypeError) as exc:
                raise InvalidRequest(f"rows are not a numeric matrix: {exc}")
        if X.ndim == 1:
            X = X.reshape(1, -1)
        if X.ndim != 2:
            raise InvalidRequest(
                f"rows must be a 2-D matrix, got {X.ndim}-D")
        if X.shape[0] == 0:
            raise InvalidRequest("empty request: no rows")
        if X.shape[0] > self.max_request_rows:
            raise InvalidRequest(
                f"request has {X.shape[0]} rows, per-request limit is "
                f"{self.max_request_rows}; split the request")
        if entry.n_features > 0 and X.shape[1] != entry.n_features:
            raise InvalidRequest(
                f"request rows have {X.shape[1]} features, model "
                f"'{entry.name}' v{entry.version} expects {entry.n_features}")
        if entry.reject_nonfinite:
            col = first_nonfinite_column(X)
            if col is not None:
                raise InvalidRequest(
                    f"non-finite value in feature column {col}; model "
                    f"'{entry.name}' was registered with reject_nonfinite "
                    "(NaN-as-missing disabled)")
        if X.dtype == np.float32 and X.flags["C_CONTIGUOUS"]:
            return X
        return np.ascontiguousarray(X, dtype=np.float32)

    # ------------------------------------------------------------- signals

    def _poll_signals(self) -> None:
        now = time.monotonic()
        if now - self._last_signal_poll < self.signal_poll_s:
            return
        self._last_signal_poll = now
        self.breaker.note_signals(telemetry.signals())

    # -------------------------------------------------------------- health

    def _batcher_stats(self) -> Dict[str, Any]:
        """Fleet-aggregate batcher counters: sums for counts, the worst
        replica's latency quantiles (a replica's tail is the fleet's)."""
        per = [b.stats() for b in self._batchers]
        if len(per) == 1:
            return per[0]
        agg: Dict[str, Any] = {}
        for st in per:
            for k, v in st.items():
                if k in ("p50_ms", "p99_ms"):
                    agg[k] = max(agg.get(k, 0.0), v)
                else:
                    agg[k] = agg.get(k, 0) + v
        return agg

    def healthz(self) -> Dict[str, Any]:
        stats = self._batcher_stats()
        breaker = self.breaker.info()
        status = "ok"
        if breaker["state"] != CLOSED:
            status = "degraded"
        if self._closed:
            status = "closing"
        return {
            "status": status,
            "uptime_s": round(time.monotonic() - self._started, 3),
            "device": str(self.device),
            "models": len(self.registry.names()),
            "rejected_uploads": self.registry.rejected_uploads,
            "breaker": breaker,
            "breaker_shed": stats.get("breaker_shed", 0),
            "device_failures": stats.get("device_failures", 0),
            "replicas": len(self._batchers),
            "queue": stats,
        }

    def readyz(self) -> Dict[str, Any]:
        ready = not self._closed and bool(self.registry.names())
        return {"ready": ready, "models": self.registry.names()}

    def stats(self) -> Dict[str, Any]:
        # imported here: a serving front does not load the streaming package
        # until its stats are read
        from ..streaming import drift

        return {
            "canary": self.canary_info(),
            "drift": drift.latest(),
            "batcher": self._batcher_stats(),
            "replicas": {"count": len(self._batchers), "placement": self.placement(),
                         "batchers": [b.stats() for b in self._batchers]},
            "breaker": self.breaker.info(),
            "models": self.registry.info(),
            "swaps": self.registry.swaps,
            "rejected_uploads": self.registry.rejected_uploads,
            # per-stage request-path quantiles (tracing histograms); the
            # /metrics flatten turns these into serve_stages_* gauges
            "stages": tracing.stage_summary("serve_request"),
            "flight": {
                "enabled": tracing.enabled(),
                "records": tracing.recorder().total,
                "dropped": tracing.recorder().dropped,
                "last_dump_path": tracing.last_dump_path(),
            },
        }

    def close(self) -> None:
        self._closed = True
        for b in self._batchers:
            b.close()
