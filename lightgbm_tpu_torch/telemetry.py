"""Structured telemetry: event stream, Chrome-trace export, watchers.

Counterpart of the JAX package's ``telemetry.py``. The reference's
observability is a timer table printed at exit under -DUSE_TIMETAG
(include/LightGBM/utils/common.h:979-1063); this module is an event bus
with machine-readable, per-iteration records:

  * In-process aggregator, on while a session is active: every event type
    counted, every `global_timer.scope` span captured through `span_hook`.
  * JSONL sink: one object per line in ``<dir>/events.jsonl``, written
    whole through checkpoint.py's atomic temp+fsync+os.replace writer, so a
    crash never leaves a torn file; ``<dir>/metrics.prom`` (exposition.py)
    at the same cadence.
  * Chrome trace-event exporter: ``<dir>/trace.json`` loadable in Perfetto
    or chrome://tracing: B/E span pairs on one track (tid) per timer label,
    "C" counter tracks for the card's memory samples.

Two watchers, mapped from the TPU's to the card's failure modes:

  * Compile watcher. The port has no jit: what it compiles is CUDA graph
    captures (the wave learner's tree graphs at the first use of a width,
    `ops/cuda_build.py:CountedGraph`, the categorical scan's graph) and
    nvcc builds of the kernels (`ops/cuda_build.py:CudaLibrary`). Each
    calls `note_compile`; captures plus builds are ``compiles``, builds
    alone ``kernel_compiles``. A function compiled past a threshold warns
    once (a width that keeps changing recaptures). The hook only counts.
  * Memory gauge. Samples ``torch.cuda.memory_stats(device)`` of every
    initialized card and keeps the high-water mark as
    ``hbm_high_water_bytes``. It reads the peak of ALLOCATED bytes
    (``allocated_bytes.all.peak``), not of reserved ones: reserved bytes
    include the caching allocator's free blocks and the graphs' private
    pools, which stay reserved after a capture whatever the run uses, so
    the allocated peak is the figure that follows the working set and that
    a caller can hold against ``torch.cuda.max_memory_allocated``. A no-op
    on the CPU (and before the card is first used), as the JAX gauge is on
    a backend without memory stats.

Enable with the ``telemetry_dir`` param or $LGBM_TPU_TELEMETRY;
``start(None)`` runs an aggregate-only session (no files). With no session
an emit is one module-global None check, and hot-path call sites guard
payload building behind `enabled()`. Nothing emits from inside a captured
graph: the learners emit on the host, at launch and at finalize.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from collections import Counter
from typing import Any, Dict, Iterator, List, Optional, Tuple

from .utils.log import Log
from .utils.timer import global_timer

ENV_VAR = "LGBM_TPU_TELEMETRY"
EVENTS_FILE = "events.jsonl"
TRACE_FILE = "trace.json"
# rewrite the JSONL sink every this-many events (plus once at close)
FLUSH_EVERY = 256
# warn when one function compiles this many times in a session
RECOMPILE_WARN_THRESHOLD = 8

_session: Optional["TelemetrySession"] = None


def enabled() -> bool:
    """True while a session is recording. Hot paths check this before
    building event payloads."""
    return _session is not None


def session() -> Optional["TelemetrySession"]:
    return _session


def emit(ev: str, **fields: Any) -> None:
    """Record one structured event; a None check when disabled."""
    s = _session
    if s is not None:
        s.emit(ev, **fields)


def sample_hbm() -> int:
    """Sample the card's memory stats into the active session (no-op when
    disabled or on the CPU). Returns the high-water."""
    s = _session
    return s.hbm.sample() if s is not None else 0


def note_compile(fn: str, kernel: bool) -> None:
    """A CUDA graph capture (`kernel` False) or an nvcc build of a kernel
    library (`kernel` True) happened. The process-wide counters always
    tick; an active session's watcher records it too."""
    global_timer.add_count("compiles", 1)
    if kernel:
        global_timer.add_count("kernel_compiles", 1)
    s = _session
    if s is not None and s.recompiles is not None:
        s.recompiles.record(fn, kernel)


def signals() -> Dict[str, int]:
    """Watcher snapshot for adaptive consumers (the serving breaker polls
    it between batches): compiles and kernel compiles the active session
    saw, and the card's memory high-water. Zeros with no session."""
    s = _session
    if s is None:
        return {"compiles": 0, "kernel_compiles": 0, "hbm_high_water_bytes": 0}
    return s.signal_snapshot()


def resolve_dir(params: Optional[Dict[str, Any]]) -> str:
    """Output dir from the `telemetry_dir` param, else $LGBM_TPU_TELEMETRY."""
    return str((params or {}).get("telemetry_dir") or "") or os.environ.get(ENV_VAR, "")


def start(out_dir: Optional[str], **kwargs: Any) -> "TelemetrySession":
    """Begin a session. `out_dir=None` -> aggregate-only (no files). At most
    one session is active per process; a second start() keeps the first."""
    global _session
    if _session is not None:
        Log.warning("Telemetry session already active; keeping it")
        return _session
    _session = TelemetrySession(out_dir, **kwargs)
    return _session


def stop() -> Optional[Dict[str, Any]]:
    """Close the active session (flush sinks, restore hooks); returns its
    summary dict, or None if no session was active."""
    global _session
    s, _session = _session, None
    return s.close() if s is not None else None


@contextlib.contextmanager
def capture(out_dir: Optional[str], **kwargs: Any) -> Iterator["TelemetrySession"]:
    """Session as a context manager (closes even when the body raises)."""
    s = start(out_dir, **kwargs)
    try:
        yield s
    finally:
        if _session is s:
            stop()


class _CompileWatcher:
    """Counts compiles per function name; warns once per function on churn."""

    def __init__(self, sess: "TelemetrySession") -> None:
        self._sess = sess
        self.per_fn: Counter = Counter()
        self.kernel_total = 0
        self._warned: set = set()

    def record(self, fn: str, kernel: bool) -> None:
        self.per_fn[fn] += 1
        if kernel:
            self.kernel_total += 1
        self._sess.emit("compile", fn=fn, n_for_fn=self.per_fn[fn], kernel=kernel)
        if self.per_fn[fn] >= self._sess.recompile_warn and fn not in self._warned:
            self._warned.add(fn)
            Log.warning("Recompile churn: %r compiled %d times in this session",
                        fn, self.per_fn[fn])

    @property
    def total(self) -> int:
        return int(sum(self.per_fn.values()))


def _initialized_cards():
    """The CUDA devices this process has touched (none on the CPU)."""
    try:
        import torch

        if not torch.cuda.is_available() or not torch.cuda.is_initialized():
            return []
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    except Exception:  # noqa: BLE001 - an observation never fails the caller
        return []


class _CardMemory:
    """One card as the gauge reads it: `memory_stats()` of the allocator."""

    def __init__(self, device) -> None:
        self.device = device

    def memory_stats(self) -> Dict[str, int]:
        import torch

        return torch.cuda.memory_stats(self.device)

    def __str__(self) -> str:
        return str(self.device)


class _HbmGauge:
    """Per-card memory high-water from the allocator's statistics.

    `devices` is injectable for tests (objects with a memory_stats()
    method); by default every initialized card. No card -> 0."""

    def __init__(self, sess: "TelemetrySession", devices=None) -> None:
        self._sess = sess
        self._devices = devices
        self.high_water: Dict[str, int] = {}

    def _device_list(self):
        if self._devices is not None:
            return self._devices
        return [_CardMemory(d) for d in _initialized_cards()]

    def sample(self) -> int:
        for d in self._device_list():
            try:
                stats = d.memory_stats()
            except Exception:  # noqa: BLE001 - a card without stats
                stats = None
            if not stats:
                continue
            used = int(stats.get("allocated_bytes.all.peak",
                                 stats.get("allocated_bytes.all.current", 0)) or 0)
            name = str(d)
            if used > self.high_water.get(name, -1):
                self.high_water[name] = used
            self._sess.counter_sample(f"hbm:{name}", used)
        top = max(self.high_water.values(), default=0)
        if top:
            global_timer.set_count("hbm_high_water_bytes", top)
        return top


class TelemetrySession:
    """One recording window: event list + aggregate counts + timer spans,
    flushed to JSONL + Chrome trace at close when `out_dir` is set."""

    def __init__(self, out_dir: Optional[str] = None, label: str = "train",
                 flush_every: int = FLUSH_EVERY,
                 recompile_warn: int = RECOMPILE_WARN_THRESHOLD,
                 devices=None, watch_compiles: bool = True) -> None:
        self.out_dir = out_dir or None
        self.label = label
        self.flush_every = max(1, int(flush_every))
        self.recompile_warn = int(recompile_warn)
        self.t0 = time.perf_counter()
        self.events: List[Dict[str, Any]] = []
        self.aggregate: Counter = Counter()  # event type -> count
        self.spans: List[Tuple[str, float, float]] = []  # (label, t0, t1) rel
        self._counter_samples: List[Tuple[str, float, int]] = []
        self._counters0 = dict(global_timer.counters)
        self._closed = False
        self._summary: Dict[str, Any] = {}
        if self.out_dir:
            os.makedirs(self.out_dir, exist_ok=True)
        # timer scopes on for the session (they feed the trace), any earlier
        # hook chained; both restored at close
        self._prev_timer_enabled = global_timer.enabled
        self._prev_span_hook = global_timer.span_hook
        global_timer.enabled = True
        global_timer.span_hook = self._on_span
        self.hbm = _HbmGauge(self, devices)
        self.recompiles = _CompileWatcher(self) if watch_compiles else None
        self.emit("session_start", label=label, wall_time=time.time(),
                  timer_epoch=global_timer.epoch, pid=os.getpid())

    def _now(self) -> float:
        return time.perf_counter() - self.t0

    def emit(self, ev: str, **fields: Any) -> None:
        rec: Dict[str, Any] = {"ev": ev, "t": round(self._now(), 6)}
        rec.update(fields)
        self.events.append(rec)
        self.aggregate[ev] += 1
        if self.out_dir and len(self.events) % self.flush_every == 0:
            self._flush_jsonl()

    def _on_span(self, label: str, start: float, end: float) -> None:
        self.spans.append((label, start - self.t0, end - self.t0))
        if self._prev_span_hook is not None:
            self._prev_span_hook(label, start, end)

    def add_span(self, label: str, start: float, end: float) -> None:
        """Record an externally timed span (perf_counter seconds): the
        tracing module feeds finished request and iteration stage spans
        here, so the Chrome trace is one timeline. Clamped at the session
        start."""
        t0 = max(0.0, start - self.t0)
        t1 = max(t0, end - self.t0)
        self.spans.append((label, t0, t1))

    def counter_sample(self, name: str, value: int) -> None:
        """Timestamped gauge sample (a "C" counter trace track)."""
        self._counter_samples.append((name, self._now(), int(value)))

    def counter_deltas(self) -> Dict[str, int]:
        """Session-scoped view of global_timer counters: accumulators as
        the delta since the session started, gauges at their level."""
        out: Dict[str, int] = {}
        for k, v in global_timer.counters.items():
            if k in global_timer.gauges:
                out[k] = int(v)
            else:
                d = int(v) - int(self._counters0.get(k, 0))
                if d:
                    out[k] = d
        return out

    def signal_snapshot(self) -> Dict[str, int]:
        """This session's watcher figures (the signals() payload), callable
        after stop() has detached the module global."""
        return {
            "compiles": self.recompiles.total if self.recompiles is not None else 0,
            "kernel_compiles": (self.recompiles.kernel_total
                                if self.recompiles is not None else 0),
            "hbm_high_water_bytes": max(self.hbm.high_water.values(), default=0),
        }

    def close(self) -> Dict[str, Any]:
        if self._closed:
            return self._summary
        self._closed = True
        self.hbm.sample()
        sig = self.signal_snapshot()
        summary: Dict[str, Any] = {
            "label": self.label,
            "duration_s": round(self._now(), 6),
            "events": {k: int(v) for k, v in sorted(self.aggregate.items())},
            "n_spans": len(self.spans),
            "compile_count": sig["compiles"],
            "kernel_compile_count": sig["kernel_compiles"],
            "hbm_high_water_bytes": sig["hbm_high_water_bytes"],
            "timer_totals": {k: round(global_timer.totals[k], 6)
                             for k in sorted(global_timer.totals)},
            "timer_counts": {k: int(global_timer.counts[k])
                             for k in sorted(global_timer.counts)},
            "counters": dict(sorted(self.counter_deltas().items())),
        }
        self.emit("session_end", **summary)
        global_timer.span_hook = self._prev_span_hook
        global_timer.enabled = self._prev_timer_enabled
        if self.out_dir:
            self._flush_jsonl()
            self._write_trace()
            Log.info("Telemetry written to %s (%d events, %d spans)",
                     self.out_dir, len(self.events), len(self.spans))
        self._summary = summary
        return summary

    # --- sinks -----------------------------------------------------------
    def _flush_jsonl(self) -> None:
        from .checkpoint import atomic_write_text
        from .exposition import SNAPSHOT_FILE, write_snapshot

        text = "".join(json.dumps(e, sort_keys=True, default=_jsonable) + "\n"
                       for e in self.events)
        atomic_write_text(os.path.join(self.out_dir, EVENTS_FILE), text)
        # a Prometheus textfile snapshot of the live counters, so a
        # node-exporter collector scrapes a running train like /metrics
        try:
            write_snapshot(os.path.join(self.out_dir, SNAPSHOT_FILE),
                           signals=self.signal_snapshot())
        except Exception:  # noqa: BLE001 - a scrape failure never kills a train
            pass

    def _write_trace(self) -> None:
        from .checkpoint import atomic_write_text

        trace = build_chrome_trace(self.spans, self._counter_samples, label=self.label)
        atomic_write_text(os.path.join(self.out_dir, TRACE_FILE),
                          json.dumps(trace, default=_jsonable))


def _jsonable(obj: Any) -> Any:
    """JSON fallback for numpy and torch scalars and arrays in payloads."""
    for attr in ("item", "tolist"):
        fn = getattr(obj, attr, None)
        if fn is not None:
            try:
                return fn()
            except Exception:  # noqa: BLE001 - try the next form
                pass
    return str(obj)


def build_chrome_trace(spans: List[Tuple[str, float, float]],
                       counter_samples: List[Tuple[str, float, int]],
                       label: str = "train") -> Dict[str, Any]:
    """Trace-event JSON: B/E pairs on one track (tid) per span label (labels
    never self-nest, so per-label tracks need no nesting bookkeeping), plus
    "C" counter events per gauge name. ts is µs from the session start;
    sorted by ts with E before B at ties, longer spans opening first and
    closing last, so Perfetto never sees a child close after its parent."""
    labels = sorted({s[0] for s in spans})
    tid_of = {lbl: i + 1 for i, lbl in enumerate(labels)}
    events: List[Dict[str, Any]] = [{
        "name": "process_name", "ph": "M", "pid": 0, "tid": 0,
        "args": {"name": f"lightgbm_tpu:{label}"},
    }]
    for lbl, tid in tid_of.items():
        events.append({"name": "thread_name", "ph": "M", "pid": 0,
                       "tid": tid, "args": {"name": lbl}})
    timed: List[Tuple[int, int, int, Dict[str, Any]]] = []
    for lbl, t0, t1 in spans:
        b = int(round(t0 * 1e6))
        e = max(int(round(t1 * 1e6)), b)
        dur = e - b
        tid = tid_of[lbl]
        timed.append((b, 1, -dur, {"name": lbl, "ph": "B", "pid": 0, "tid": tid, "ts": b}))
        timed.append((e, 0, dur, {"name": lbl, "ph": "E", "pid": 0, "tid": tid, "ts": e}))
    for name, t, value in counter_samples:
        ts = int(round(t * 1e6))
        timed.append((ts, 2, 0, {"name": name, "ph": "C", "pid": 0, "tid": 0,
                                 "ts": ts, "args": {"bytes": value}}))
    timed.sort(key=lambda x: x[:3])
    events.extend(ev for _, _, _, ev in timed)
    return {"traceEvents": events, "displayTimeUnit": "ms"}
