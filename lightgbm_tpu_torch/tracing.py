"""Request-path tracing + always-on flight recorder.

Counterpart of the JAX package's ``tracing.py``.

* Every serving request carries a `Span` with monotonic stage marks
  (`parse`, `queue_wait`, `assembly`, `device`, `d2h`, `serialize`; shed
  requests end in a terminal `shed` stage), trace context rides the W3C
  ``traceparent`` header end to end, and per-stage log-bucketed streaming
  histograms aggregate into p50/p99 figures surfaced on ``/statz`` and
  ``/metrics`` (`quantile_gauges`). Training iterations are spans too.

* The `FlightRecorder` is an always-on bounded ring buffer — O(1) locked
  append, fixed memory cap, no I/O on the hot path, works with
  ``telemetry_dir`` unset — holding the most recent events, finished spans
  and counter snapshots. It is dumped (checkpoint.py's atomic writer) on
  breaker->OPEN, health rollback, a fault injection firing, unhandled
  exceptions in ``engine.train`` or the batcher worker, a canary rollback,
  and on demand through ``GET /debug/flight``.

``note()`` stays O(1) and allocation-bounded. Everything is stdlib: ids
from ``os.urandom``, time from ``time.perf_counter`` (the telemetry
sessions' basis, so finished spans feed the Chrome-trace export).
``LGBM_TPU_FLIGHT=0`` turns the recorder off (every entry point returns
early); results are bit-identical either way. ``LGBM_TPU_FLIGHT_DIR`` pins
the dump directory; otherwise dumps land in the active telemetry session's
dir, or stay in memory (``last_dump()``) when neither exists.
"""
from __future__ import annotations

import math
import os
import re
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from .utils.timer import global_timer

# --------------------------------------------------------------------------
# W3C trace context (stdlib traceparent parse/generate)
# --------------------------------------------------------------------------

_TRACEPARENT_RE = re.compile(
    r"^([0-9a-f]{2})-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$")


def new_trace_id() -> str:
    return os.urandom(16).hex()


def new_span_id() -> str:
    return os.urandom(8).hex()


def parse_traceparent(header: Optional[str]) -> Optional[Tuple[str, str]]:
    """``traceparent`` -> (trace_id, parent_span_id), or None when the
    header is absent/malformed (caller starts a fresh trace — the W3C
    "restart" behaviour, never an error)."""
    if not header:
        return None
    m = _TRACEPARENT_RE.match(header.strip().lower())
    if m is None:
        return None
    version, trace_id, parent_id = m.group(1), m.group(2), m.group(3)
    if version == "ff":  # forbidden version
        return None
    if trace_id == "0" * 32 or parent_id == "0" * 16:
        return None
    return trace_id, parent_id


def format_traceparent(trace_id: str, span_id: str,
                       flags: str = "01") -> str:
    return f"00-{trace_id}-{span_id}-{flags}"


# --------------------------------------------------------------------------
# log-bucketed streaming histograms -> p50/p99 stage gauges
# --------------------------------------------------------------------------

_HIST_BASE_S = 1e-6     # bucket 0 upper bound: 1 microsecond
_HIST_GROWTH = 1.25     # geometric bucket growth
_HIST_BUCKETS = 96      # 1.25**96 * 1µs ≈ 2e3 s — covers any sane stage
_LOG_GROWTH = math.log(_HIST_GROWTH)


class StageHistogram:
    """Fixed-size log-bucketed histogram: O(1) record, bounded memory,
    quantiles read from bucket upper bounds (conservative — a reported
    p99 is an upper bound on the true p99 within one bucket width)."""

    __slots__ = ("counts", "n", "total_s")

    def __init__(self) -> None:
        self.counts = [0] * _HIST_BUCKETS
        self.n = 0
        self.total_s = 0.0

    def record(self, duration_s: float) -> None:
        if duration_s < 0.0:
            duration_s = 0.0
        if duration_s <= _HIST_BASE_S:
            idx = 0
        else:
            idx = min(_HIST_BUCKETS - 1,
                      1 + int(math.log(duration_s / _HIST_BASE_S)
                              / _LOG_GROWTH))
        self.counts[idx] += 1
        self.n += 1
        self.total_s += duration_s

    def quantile_s(self, q: float) -> float:
        """Nearest-rank quantile as the matched bucket's upper bound."""
        if self.n == 0:
            return 0.0
        rank = max(1, min(self.n, int(math.ceil(q * self.n))))
        seen = 0
        for idx, c in enumerate(self.counts):
            seen += c
            if seen >= rank:
                return _HIST_BASE_S * (_HIST_GROWTH ** idx)
        return _HIST_BASE_S * (_HIST_GROWTH ** (_HIST_BUCKETS - 1))


# --------------------------------------------------------------------------
# spans
# --------------------------------------------------------------------------

class Span:
    """One traced unit of work with ordered, accumulating stage marks.

    Stages are durations, not timestamps: ``add_stage`` accumulates under
    the same name (a chunked dispatch adds ``device`` once per chunk), and
    the Chrome-trace export lays stages out contiguously from ``t0``.
    ``finish`` is idempotent — whichever side reaches it first (the HTTP
    handler's ``finally`` or the batcher shedding the request) records the
    span exactly once.
    """

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "t0", "t1",
                 "stages", "terminal", "links", "attrs", "record_stats",
                 "_finished")

    def __init__(self, name: str, trace_id: Optional[str] = None,
                 parent_id: Optional[str] = None,
                 record_stats: bool = True) -> None:
        self.name = name
        self.trace_id = trace_id or new_trace_id()
        self.span_id = new_span_id()
        self.parent_id = parent_id
        self.t0 = time.perf_counter()
        self.t1: Optional[float] = None
        self.stages: Dict[str, float] = {}
        self.terminal: Optional[str] = None
        self.links: List[str] = []
        self.attrs: Dict[str, Any] = {}
        self.record_stats = record_stats
        self._finished = False

    def traceparent(self) -> str:
        return format_traceparent(self.trace_id, self.span_id)

    def add_stage(self, stage: str, duration_s: float) -> None:
        if self._finished:
            return
        self.stages[stage] = self.stages.get(stage, 0.0) + float(duration_s)

    def link(self, span_id: str) -> None:
        self.links.append(span_id)

    def finish(self, terminal: Optional[str] = None) -> None:
        if self._finished:
            return
        self._finished = True
        self.t1 = time.perf_counter()
        if terminal is not None:
            self.terminal = terminal
        _finish_span(self)


def start_span(name: str, traceparent: Optional[str] = None,
               parent: Optional[Span] = None,
               record_stats: bool = True) -> Span:
    """New span; inbound ``traceparent`` (honored when well-formed) or a
    parent span supplies trace ancestry, else a fresh trace starts."""
    trace_id = parent_id = None
    if parent is not None:
        trace_id, parent_id = parent.trace_id, parent.span_id
    else:
        parsed = parse_traceparent(traceparent)
        if parsed is not None:
            trace_id, parent_id = parsed
    return Span(name, trace_id=trace_id, parent_id=parent_id,
                record_stats=record_stats)


# --------------------------------------------------------------------------
# flight recorder (always-on bounded ring buffer)
# --------------------------------------------------------------------------

DEFAULT_CAPACITY = 2048
# one write per reason per interval: postmortems want the FIRST dump after
# an incident, not a dump per firing while a fault storm is in progress
DUMP_MIN_INTERVAL_S = 1.0

DUMP_FORMAT = "lgbm-flight"
DUMP_VERSION = 1

_enabled = os.environ.get("LGBM_TPU_FLIGHT", "1").lower() not in (
    "0", "off", "false", "no")


def enabled() -> bool:
    return _enabled


def set_enabled(on: bool) -> None:
    """Test hook: flips the compile-out switch at runtime (the env var
    ``LGBM_TPU_FLIGHT=0`` sets the process-wide default)."""
    global _enabled
    _enabled = bool(on)


class FlightRecorder:
    """Bounded ring of (seq, t, kind, fields) records.

    Append is a lock + index arithmetic + one slot store: O(1), no
    allocation beyond the record itself, no I/O ever. `snapshot()` walks
    the ring in sequence order; `dropped` counts evicted records so a
    dump states exactly how much history it lost."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY) -> None:
        self.capacity = max(16, int(capacity))
        self._slots: List[Optional[Tuple[int, float, str, Dict[str, Any]]]] \
            = [None] * self.capacity
        self._seq = 0
        self._lock = threading.Lock()

    def note(self, kind: str, fields: Dict[str, Any]) -> None:
        with self._lock:
            seq = self._seq
            self._seq = seq + 1
            self._slots[seq % self.capacity] = (
                seq, time.perf_counter(), kind, fields)

    def snapshot(self) -> List[Dict[str, Any]]:
        with self._lock:
            slots = [s for s in self._slots if s is not None]
        slots.sort(key=lambda s: s[0])
        out = []
        for seq, t, kind, fields in slots:
            rec = {"seq": seq, "t": round(t, 6), "kind": kind}
            rec.update(fields)
            out.append(rec)
        return out

    @property
    def total(self) -> int:
        with self._lock:
            return self._seq

    @property
    def dropped(self) -> int:
        with self._lock:
            return max(0, self._seq - self.capacity)

    def reset(self) -> None:
        with self._lock:
            self._slots = [None] * self.capacity
            self._seq = 0


_recorder = FlightRecorder(
    int(os.environ.get("LGBM_TPU_FLIGHT_CAP", DEFAULT_CAPACITY)))
_stats_lock = threading.Lock()
_stage_stats: Dict[Tuple[str, str], StageHistogram] = {}
_last_dump: Optional[Dict[str, Any]] = None
_last_dump_path: Optional[str] = None
_last_dump_ts: Dict[str, float] = {}


def recorder() -> FlightRecorder:
    return _recorder


def note(kind: str, **fields: Any) -> None:
    """The always-on recorder append: O(1), allocation-bounded, no I/O.
    Callers pass cheap already-computed scalars only."""
    if not _enabled:
        return
    _recorder.note(kind, fields)


def _finish_span(span: Span) -> None:
    if not _enabled:
        return
    if span.record_stats and span.stages:
        with _stats_lock:
            for stage, dur in span.stages.items():
                hist = _stage_stats.get((span.name, stage))
                if hist is None:
                    hist = _stage_stats[(span.name, stage)] = StageHistogram()
                hist.record(dur)
    rec: Dict[str, Any] = {
        "name": span.name,
        "trace_id": span.trace_id,
        "span_id": span.span_id,
        "t0": round(span.t0, 6),
        "t1": round(span.t1 or span.t0, 6),
        "stages_ms": {k: round(v * 1000.0, 4)
                      for k, v in span.stages.items()},
    }
    if span.parent_id:
        rec["parent_id"] = span.parent_id
    if span.terminal:
        rec["terminal"] = span.terminal
    if span.links:
        rec["links"] = list(span.links)
    if span.attrs:
        rec["attrs"] = dict(span.attrs)
    _recorder.note("span", rec)
    # unified trace: finished spans land in the active telemetry session
    # so build_chrome_trace exports serving + training in one timeline
    from . import telemetry
    if telemetry.enabled():
        sess = telemetry.session()
        if sess is not None:
            t = span.t0
            for stage, dur in span.stages.items():
                sess.add_span(f"{span.name}.{stage}", t, t + dur)
                t += dur


# --------------------------------------------------------------------------
# stage quantiles (for /statz, /metrics, bench)
# --------------------------------------------------------------------------

def stage_summary(span_name: str) -> Dict[str, Dict[str, float]]:
    """{stage: {count, p50_ms, p99_ms, total_ms}} for one span family."""
    out: Dict[str, Dict[str, float]] = {}
    with _stats_lock:
        items = [(k[1], h) for k, h in _stage_stats.items()
                 if k[0] == span_name]
    for stage, hist in sorted(items):
        out[stage] = {
            "count": hist.n,
            "p50_ms": round(hist.quantile_s(0.50) * 1000.0, 4),
            "p99_ms": round(hist.quantile_s(0.99) * 1000.0, 4),
            "total_ms": round(hist.total_s * 1000.0, 4),
        }
    return out


def quantile_gauges() -> Dict[str, float]:
    """Flat gauge map for the exposition renderer:
    ``<span>_stage_<stage>_p50_ms`` / ``..._p99_ms``."""
    out: Dict[str, float] = {}
    with _stats_lock:
        items = sorted(_stage_stats.items())
    for (name, stage), hist in items:
        if hist.n == 0:
            continue
        out[f"{name}_stage_{stage}_p50_ms"] = round(
            hist.quantile_s(0.50) * 1000.0, 4)
        out[f"{name}_stage_{stage}_p99_ms"] = round(
            hist.quantile_s(0.99) * 1000.0, 4)
    return out


def reset_stats() -> None:
    with _stats_lock:
        _stage_stats.clear()


# --------------------------------------------------------------------------
# flight dumps
# --------------------------------------------------------------------------

def resolve_flight_dir() -> Optional[str]:
    """Dump directory: ``LGBM_TPU_FLIGHT_DIR`` env, else the active
    telemetry session's out_dir, else None (in-memory dump only)."""
    env = os.environ.get("LGBM_TPU_FLIGHT_DIR")
    if env:
        return env
    from . import telemetry
    sess = telemetry.session()
    if sess is not None and sess.out_dir:
        return sess.out_dir
    return None


def build_dump(reason: str,
               extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """The postmortem document: recent ring contents + counter snapshot +
    stage quantiles. Pure in-memory assembly — writing is dump_flight's
    job."""
    from . import telemetry

    with _stats_lock:
        span_names = sorted({k[0] for k in _stage_stats})
    dump: Dict[str, Any] = {
        "format": DUMP_FORMAT,
        "version": DUMP_VERSION,
        "reason": reason,
        "wall_time": time.time(),
        "pid": os.getpid(),
        "capacity": _recorder.capacity,
        "total_records": _recorder.total,
        "dropped": _recorder.dropped,
        "telemetry_enabled": telemetry.enabled(),
        "events": _recorder.snapshot(),
        "counters": {k: int(v) for k, v in
                     sorted(global_timer.counters.items())},
        "gauges": sorted(global_timer.gauges),
        "stage_summary": {name: stage_summary(name)
                          for name in span_names},
    }
    if extra:
        dump["extra"] = extra
    return dump


def dump_flight(reason: str, extra: Optional[Dict[str, Any]] = None,
                force: bool = False) -> Optional[str]:
    """Dump the recorder for a postmortem. Returns the written path (or
    None when rate-limited, disabled, or no directory resolves — the
    in-memory copy is still retrievable via ``last_dump()``). Never
    raises: a failing postmortem write must not take down serving."""
    global _last_dump, _last_dump_path
    if not _enabled:
        return None
    now = time.monotonic()
    if not force:
        last = _last_dump_ts.get(reason)
        if last is not None and now - last < DUMP_MIN_INTERVAL_S:
            return None
    _last_dump_ts[reason] = now
    try:
        dump = build_dump(reason, extra)
    except Exception:  # pragma: no cover - assembly must never propagate
        return None
    _last_dump = dump
    global_timer.add_count("flight_dumps", 1)
    out_dir = resolve_flight_dir()
    if not out_dir:
        _last_dump_path = None
        return None
    try:
        import json

        from .checkpoint import atomic_write_text

        os.makedirs(out_dir, exist_ok=True)
        # latest-per-reason filename keeps the on-disk footprint bounded
        # under a fault storm; the ring inside each dump carries the
        # history of the preceding firings anyway
        safe = re.sub(r"[^a-zA-Z0-9_.-]", "_", reason)
        path = os.path.join(out_dir, f"flight-{safe}.json")
        atomic_write_text(path, json.dumps(dump, indent=1, sort_keys=True))
        _last_dump_path = path
        return path
    except Exception:  # pragma: no cover - best-effort postmortem I/O
        _last_dump_path = None
        return None


def last_dump() -> Optional[Dict[str, Any]]:
    return _last_dump


def last_dump_path() -> Optional[str]:
    return _last_dump_path


def reset() -> None:
    """Test hook: fresh recorder ring + stage stats + dump rate-limits."""
    global _last_dump, _last_dump_path
    _recorder.reset()
    reset_stats()
    _last_dump = None
    _last_dump_path = None
    _last_dump_ts.clear()
