"""Micro-batching dispatch core: coalesce, bound, shed.

Concurrent requests for the same (model version, raw_score) are coalesced
by a single worker thread into one device dispatch of at most
`max_batch_rows` rows; a larger batch is cut into chunks of that size.

Admission is bounded by total queued ROWS (not request count — one 4096-row
request occupies what 4096 single-row requests would): past the bound,
submit raises Overloaded WITHOUT enqueuing, so a flood cannot grow memory.
Each request may carry a deadline budget; expired requests are shed at
batch-assembly time — before any device dispatch — and a caller whose wait
runs out raises DeadlineExceeded immediately without blocking the batch
its rows ride in.

The breaker (serving/breaker.py) is consulted per batch: DEGRADED caps the
chunk rows, and OPEN sheds the batch before any dispatch, failing each of
its requests with BreakerOpen (HTTP 503 + Retry-After), counted
(`n_breaker_shed`, the `serve_breaker_shed` counter, on /statz, /metrics and
/healthz). A device dispatch that raises is counted
(`serve_dispatch_failures`), emitted, fed to the breaker, and fails every
request of its batch (HTTP 500); it is retried nowhere, and no chunk is ever
answered on the CPU of a service that runs on the card.

Batches are not padded: the JAX package pads to power-of-two buckets so
its jit cache holds one executable per bucket, and the CUDA kernel has no
compiled shapes to bound. Rows are independent, so a request's answer is
bit-identical whichever batch it rides in.

On the card each batcher's worker dispatches on a CUDA stream of its own
(`stream`), so the replicas of a service (service.py) overlap their
uploads, kernels and copies back; the traversal allocates its scratch per
call, so two streams share nothing but the read-only packed ensembles.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import telemetry, tracing
from ..ops.partition import bucket_size
from ..utils import faults
from ..utils.log import Log
from ..utils.timer import global_timer
from .breaker import CircuitBreaker
from .errors import (BreakerOpen, DeadlineExceeded, Overloaded,
                     ServiceClosed, ServingError)
from .registry import ModelEntry


class _Request:
    __slots__ = ("entry", "rows", "raw_score", "deadline", "event",
                 "result", "error", "cancelled", "t_submit", "t_submit_pc",
                 "span")

    def __init__(self, entry: ModelEntry, rows: np.ndarray, raw_score: bool,
                 deadline: Optional[float],
                 span: Optional[tracing.Span] = None) -> None:
        self.entry = entry
        self.rows = rows
        self.raw_score = raw_score
        self.deadline = deadline  # absolute monotonic, None = unbounded
        self.event = threading.Event()
        self.result: Optional[np.ndarray] = None
        self.error: Optional[ServingError] = None
        self.cancelled = False
        self.t_submit = time.monotonic()
        self.t_submit_pc = time.perf_counter()  # stage-mark clock basis
        self.span = span

    def key(self) -> Tuple[int, bool]:
        # entry identity, not name: a hot-swap mid-queue splits the batch,
        # so every response comes from the version it was admitted under
        return (id(self.entry), self.raw_score)


class MicroBatcher:
    def __init__(self, breaker: CircuitBreaker,
                 max_batch_rows: int = 4096, max_queue_rows: int = 32768,
                 min_bucket: int = 256, batch_window_s: float = 0.001,
                 device=None, name: str = "lgbm-serve-batcher") -> None:
        self.breaker = breaker
        # the worker's own CUDA stream on the card (None elsewhere)
        self.stream = None
        if device is not None and torch.device(device).type == "cuda":
            self.stream = torch.cuda.Stream(device=torch.device(device))
        self.max_batch_rows = bucket_size(max(1, max_batch_rows), 1)
        self.max_queue_rows = max_queue_rows
        self.min_bucket = bucket_size(max(1, min_bucket), 1)
        self.batch_window_s = batch_window_s
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._queue: deque = deque()
        self._queued_rows = 0
        self._closed = False
        self._latencies_ms: deque = deque(maxlen=4096)
        # lifetime counters (instance-local: global_timer counters are
        # process-wide and shared across services/tests)
        self.n_requests = 0
        self.n_rows = 0
        self.n_batches = 0
        self.n_overloaded = 0
        self.n_deadline_shed = 0
        self.n_deadline_wait_expired = 0
        self.n_device_failures = 0
        self.n_breaker_shed = 0
        self._worker = threading.Thread(target=self._run, name=name, daemon=True)
        self._worker.start()

    # -------------------------------------------------------------- submit

    def submit(self, entry: ModelEntry, rows: np.ndarray, raw_score: bool,
               timeout_s: Optional[float] = None,
               span: Optional[tracing.Span] = None) -> np.ndarray:
        """Enqueue one request and block until its batch answers, its
        deadline expires, or the service closes."""
        n = int(rows.shape[0])
        deadline = (time.monotonic() + timeout_s
                    if timeout_s is not None else None)
        req = _Request(entry, rows, raw_score, deadline, span=span)
        with self._lock:
            if self._closed:
                raise ServiceClosed("service is shutting down")
            if self._queued_rows + n > self.max_queue_rows:
                self.n_overloaded += 1
                global_timer.add_count("serve_overloaded", 1)
                if span is not None:
                    span.finish(terminal="rejected")
                raise Overloaded(
                    f"admission queue full ({self._queued_rows} rows "
                    f"queued, request adds {n}, limit "
                    f"{self.max_queue_rows}); retry with backoff")
            self._queue.append(req)
            self._queued_rows += n
            global_timer.set_count("serve_queue_depth", self._queued_rows)
            self._cond.notify_all()
        remaining = None
        if deadline is not None:
            remaining = max(0.0, deadline - time.monotonic())
        if not req.event.wait(remaining):
            req.cancelled = True  # worker skips it at assembly time
            self.n_deadline_wait_expired += 1
            global_timer.add_count("serve_deadline_expired", 1)
            if span is not None:
                span.add_stage("shed",
                               time.perf_counter() - req.t_submit_pc)
                span.finish(terminal="shed")
            raise DeadlineExceeded(
                f"deadline of {timeout_s:.3f}s expired while "
                f"{'queued' if req.result is None else 'in flight'}")
        if req.error is not None:
            raise req.error
        lat_ms = (time.monotonic() - req.t_submit) * 1000.0
        with self._lock:
            self._latencies_ms.append(lat_ms)
            self.n_requests += 1
            self.n_rows += n
        return req.result

    # -------------------------------------------------------------- worker

    def _shed_locked(self, now: float) -> None:
        """Drop cancelled/expired requests before they cost a dispatch."""
        live: deque = deque()
        for req in self._queue:
            expired = req.deadline is not None and now >= req.deadline
            if req.cancelled or expired:
                self._queued_rows -= int(req.rows.shape[0])
                if req.span is not None:
                    # terminal stage: shed requests account their whole
                    # queued life to `shed`
                    req.span.add_stage(
                        "shed", time.perf_counter() - req.t_submit_pc)
                    req.span.finish(terminal="shed")
                if not req.cancelled:
                    req.error = DeadlineExceeded(
                        "deadline expired before dispatch; request shed "
                        "from the queue")
                    req.event.set()
                self.n_deadline_shed += 1
                global_timer.add_count("serve_deadline_shed", 1)
            else:
                live.append(req)
        self._queue = live
        global_timer.set_count("serve_queue_depth", self._queued_rows)

    def _collect(self) -> List[_Request]:
        """Pull one batch of same-key requests; [] means 'loop again'."""
        with self._lock:
            if not self._queue:
                if self._closed:
                    return []
                self._cond.wait(0.05)
            self._shed_locked(time.monotonic())
            if not self._queue:
                return []
            if (self.batch_window_s > 0
                    and self._queued_rows < self.min_bucket):
                # one coalescing beat: let concurrent submitters land so
                # they share the dispatch instead of each paying their own
                self._cond.wait(self.batch_window_s)
                self._shed_locked(time.monotonic())
                if not self._queue:
                    return []
            key = self._queue[0].key()
            taken: List[_Request] = []
            rows = 0
            keep: deque = deque()
            for req in self._queue:
                n = int(req.rows.shape[0])
                # the head is always taken — even oversized (the dispatch
                # loop chunks it) — so assembly can never spin on it
                if req.key() == key and (not taken
                                         or rows + n <= self.max_batch_rows):
                    taken.append(req)
                    rows += n
                else:
                    keep.append(req)
            self._queue = keep
            self._queued_rows -= rows
            global_timer.set_count("serve_queue_depth", self._queued_rows)
            return taken

    def _run(self) -> None:
        while True:
            with self._lock:
                if self._closed:
                    return
            batch = self._collect()
            if not batch:
                continue
            try:
                if self.stream is not None:
                    with torch.cuda.stream(self.stream):
                        self._dispatch(batch)
                else:
                    self._dispatch(batch)
            except Exception as exc:  # worker must outlive any batch
                Log.warning("serving: batch dispatch error: %s", exc)
                tracing.note("batcher_exception", error=repr(exc)[:400],
                             requests=len(batch))
                # the postmortem is recorded before a waiter sees the failure
                tracing.dump_flight("batcher_exception")
                for req in batch:
                    req.error = ServingError(f"prediction failed: {exc}")
                    req.event.set()

    def _predict_chunk(self, entry: ModelEntry, chunk: np.ndarray,
                       raw_score: bool,
                       stages: Dict[str, float]) -> np.ndarray:
        t = time.perf_counter()
        X = chunk if chunk.dtype == np.float32 and chunk.flags["C_CONTIGUOUS"] \
            else np.ascontiguousarray(chunk, dtype=np.float32)
        t_dev = time.perf_counter()
        stages["assembly"] += t_dev - t
        try:
            faults.on_serve_dispatch()
            # `device` covers upload, kernel and the copy of the answer back:
            # Booster.predict returns host arrays, so `d2h` reads near zero
            out = entry.predict(X, raw_score)
        except Exception as exc:
            # counted and fed to the breaker here; _run fails the batch
            self.breaker.on_failure(exc, entry=entry.name)
            self.n_device_failures += 1
            global_timer.add_count("serve_dispatch_failures", 1)
            tracing.note("serve_dispatch_failed", error=repr(exc)[:400],
                         model=entry.name, rows=int(X.shape[0]))
            if telemetry.enabled():
                telemetry.emit("serve_dispatch_failed", error=str(exc),
                               model=entry.name, rows=int(X.shape[0]))
            raise
        self.breaker.on_success(entry=entry.name)
        t_d2h = time.perf_counter()
        stages["device"] += t_d2h - t_dev
        res = np.asarray(out)
        stages["d2h"] += time.perf_counter() - t_d2h
        return res

    def _shed_open(self, batch: List[_Request], entry: ModelEntry) -> None:
        """OPEN: fail the batch before any dispatch (HTTP 503)."""
        self.n_breaker_shed += len(batch)
        global_timer.add_count("serve_breaker_shed", len(batch))
        err = BreakerOpen(
            f"model '{entry.name}': circuit breaker open after repeated device "
            f"dispatch failures; retry after its {self.breaker.cooldown_s:g} s cooldown")
        for req in batch:
            if req.span is not None:
                req.span.finish(terminal="rejected")
            req.error = err
            req.event.set()

    def _dispatch(self, batch: List[_Request]) -> None:
        entry = batch[0].entry
        raw_score = batch[0].raw_score
        t_asm = time.perf_counter()
        batch_span = tracing.start_span("serve_batch", record_stats=False)
        for req in batch:
            if req.span is not None:
                # queue_wait: submit to the moment its batch starts work
                req.span.add_stage("queue_wait", t_asm - req.t_submit_pc)
                batch_span.link(req.span.span_id)
        # the entry's breaker shard: one tenant's faulting model sheds its
        # own load without opening the breaker for the rest
        decision = self.breaker.decide(entry.name)
        if decision.shed:
            batch_span.finish(terminal="rejected")
            self._shed_open(batch, entry)
            return
        stages = {"assembly": 0.0, "device": 0.0, "d2h": 0.0}
        X = (batch[0].rows if len(batch) == 1
             else np.concatenate([r.rows for r in batch], axis=0))
        stages["assembly"] += time.perf_counter() - t_asm
        n = int(X.shape[0])
        cap = self.max_batch_rows
        if decision.max_rows is not None:
            cap = min(cap, bucket_size(max(1, decision.max_rows), 1))
        outs = []
        with global_timer.scope("serve_batch"):
            for start in range(0, n, cap):
                outs.append(self._predict_chunk(
                    entry, X[start:start + cap], raw_score, stages))
        t = time.perf_counter()
        out = outs[0] if len(outs) == 1 else np.concatenate(outs, axis=0)
        stages["d2h"] += time.perf_counter() - t
        self.n_batches += 1
        global_timer.add_count("serve_batches", 1)
        if telemetry.enabled():
            telemetry.emit("serve_batch", model=entry.name, version=entry.version, rows=n,
                           requests=len(batch))
        pos = 0
        for req in batch:
            k = int(req.rows.shape[0])
            # a member rides the whole batch, so the batch's stage walls
            # ARE its stage walls (the cost of coalescing is queue_wait)
            if req.span is not None:
                for stage, dur in stages.items():
                    req.span.add_stage(stage, dur)
            req.result = out[pos:pos + k]
            pos += k
            req.event.set()
        for stage, dur in stages.items():
            batch_span.add_stage(stage, dur)
        batch_span.attrs.update(rows=n, requests=len(batch),
                                model=entry.name, version=entry.version)
        batch_span.finish()

    # --------------------------------------------------------------- stats

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            lats = sorted(self._latencies_ms)
            stats = {
                "queue_rows": self._queued_rows,
                "requests": self.n_requests,
                "rows": self.n_rows,
                "batches": self.n_batches,
                "overloaded": self.n_overloaded,
                "deadline_shed": self.n_deadline_shed,
                "deadline_wait_expired": self.n_deadline_wait_expired,
                "device_failures": self.n_device_failures,
                "breaker_shed": self.n_breaker_shed,
            }
        if lats:
            stats["p50_ms"] = lats[len(lats) // 2]
            stats["p99_ms"] = lats[min(len(lats) - 1,
                                       int(len(lats) * 0.99))]
        return stats

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._cond.notify_all()
        self._worker.join(timeout=5.0)
        with self._lock:
            for req in self._queue:
                req.error = ServiceClosed("service is shutting down")
                req.event.set()
            self._queue.clear()
            self._queued_rows = 0
            global_timer.set_count("serve_queue_depth", 0)
