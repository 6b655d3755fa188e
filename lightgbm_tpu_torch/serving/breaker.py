"""Graceful-degradation circuit breaker for the serving dispatch path.

Counterpart of the JAX package's ``serving/breaker.py``. Four states,
ordered by how much they trust the card:

    CLOSED     normal dispatch, full-size chunks
    DEGRADED   device dispatch with a reduced chunk cap, entered on pressure
               SIGNALS (a burst of graph captures or kernel builds, the
               card's memory high-water past a limit, from the telemetry
               watchers) rather than failures
    OPEN       repeated dispatch failures: the entry's traffic is SHED with
               a typed 503 (errors.BreakerOpen), counted and visible
               (serve_breaker_shed on /statz, /metrics and /healthz). It is
               not answered anywhere else: the port has no host path, so a
               card fault never moves work to the CPU
    HALF_OPEN  cooldown expired: the next dispatch is a device PROBE; one
               failure re-opens, `probe_successes` straight successes close

State is sharded PER MODEL ENTRY: `decide` / `on_success` / `on_failure`
take the entry name, and each name walks the state machine on its own, so
one tenant whose model keeps faulting sheds ITS OWN load while every other
entry stays on full-size device dispatch. The default shard ("") serves
direct callers that pass no entry. Aggregate views (the `state` property,
the top of `info()`, the `serve_breaker_state` gauge) report the WORST
shard.

The batcher workers drive the transitions around each dispatch, and the
service feeds `note_signals()` from telemetry.signals(); every method is
locked so health endpoints can read the state from other threads. The
worst shard's state code is the `serve_breaker_state` gauge (0=closed
1=degraded 2=open 3=half-open); every transition is a warning, a
flight-recorder note and a telemetry event, and an opening dumps the
flight recorder.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, Dict, Optional

from .. import telemetry, tracing
from ..utils.log import Log
from ..utils.timer import global_timer

CLOSED = "closed"
DEGRADED = "degraded"
OPEN = "open"
HALF_OPEN = "half_open"

_STATE_CODE = {CLOSED: 0, DEGRADED: 1, OPEN: 2, HALF_OPEN: 3}
# ordering for the aggregate worst-shard view: how little the state
# trusts the device (half-open outranks degraded: it is mid-outage)
_SEVERITY = {CLOSED: 0, DEGRADED: 1, HALF_OPEN: 2, OPEN: 3}

DEFAULT_ENTRY = ""


class Decision:
    """What the worker should do with the next dispatch. `shed` (OPEN) is
    the JAX breaker's `use_host`: the same state, a different answer."""

    __slots__ = ("shed", "max_rows", "probe")

    def __init__(self, shed: bool, max_rows: Optional[int],
                 probe: bool) -> None:
        self.shed = shed
        self.max_rows = max_rows  # chunk-row cap, None = no extra cap
        self.probe = probe


class _Shard:
    """Per-entry state-machine variables (all mutated under the breaker
    lock — a shard has no lock of its own)."""

    __slots__ = ("state", "fail_streak", "success_streak", "opened_at")

    def __init__(self) -> None:
        self.state = CLOSED
        self.fail_streak = 0
        self.success_streak = 0
        self.opened_at = 0.0


class CircuitBreaker:
    def __init__(self, fail_threshold: int = 3, recovery_successes: int = 8,
                 probe_successes: int = 3, cooldown_s: float = 2.0,
                 degraded_rows: int = 256,
                 compile_churn_limit: int = 8,
                 hbm_limit_bytes: int = 0,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.fail_threshold = max(1, fail_threshold)
        self.recovery_successes = max(1, recovery_successes)
        self.probe_successes = max(1, probe_successes)
        self.cooldown_s = cooldown_s
        self.degraded_rows = degraded_rows
        self.compile_churn_limit = compile_churn_limit
        self.hbm_limit_bytes = hbm_limit_bytes
        self._clock = clock
        self._lock = threading.Lock()
        self._shards: Dict[str, _Shard] = {DEFAULT_ENTRY: _Shard()}
        self._last_compiles: Optional[int] = None
        self.transitions = 0
        # unconditional transition history: a breaker flap must leave a
        # trace even with telemetry off (surfaced in info() -> /statz,
        # mirrored into the flight recorder)
        self.last_transitions: deque = deque(maxlen=16)
        self._pending_dump: Optional[Dict[str, Any]] = None
        global_timer.set_count("serve_breaker_state", 0)

    # --------------------------------------------------------------- state

    def _shard(self, entry: str) -> _Shard:
        # callers hold self._lock
        sh = self._shards.get(entry)
        if sh is None:
            sh = self._shards[entry] = _Shard()
        return sh

    def _worst(self) -> _Shard:
        # callers hold self._lock
        return max(self._shards.values(), key=lambda s: _SEVERITY[s.state])

    @property
    def state(self) -> str:
        """Aggregate: the worst shard's state."""
        with self._lock:
            return self._worst().state

    def register_entry(self, entry: str) -> None:
        """Create the entry's shard (no-op if present) — the service calls
        this at model load so pressure signals observed before the first
        request still land on the entry."""
        with self._lock:
            self._shard(entry)

    def forget_entry(self, entry: str) -> None:
        """Drop an unloaded entry's shard so its terminal state cannot pin
        the aggregate view (the default shard is never dropped)."""
        if entry == DEFAULT_ENTRY:
            return
        with self._lock:
            self._shards.pop(entry, None)
            code = _STATE_CODE[self._worst().state]
        global_timer.set_count("serve_breaker_state", code)

    def _move(self, entry: str, sh: _Shard, new_state: str, why: str) -> None:
        # callers hold self._lock
        if new_state == sh.state:
            return
        old = sh.state
        sh.state = new_state
        sh.fail_streak = 0
        sh.success_streak = 0
        self.transitions += 1
        if new_state == OPEN:
            sh.opened_at = self._clock()
        global_timer.set_count("serve_breaker_state",
                               _STATE_CODE[self._worst().state])
        label = f"entry {entry!r}" if entry else "default entry"
        Log.warning("serving: breaker[%s] %s -> %s (%s)",
                    entry or "-", old, new_state, why)
        self.last_transitions.append({
            "old": old, "new": new_state, "reason": why, "entry": entry,
            "wall_time": time.time(), "transition": self.transitions})
        tracing.note("breaker_transition", old=old, new=new_state,
                     reason=why, entry=entry)
        if new_state == OPEN:
            # the postmortem dump does I/O — defer it until the caller
            # releases self._lock (see _maybe_dump)
            self._pending_dump = {
                "breaker": {"state": new_state, "reason": why,
                            "entry": entry, "label": label,
                            "transitions": self.transitions}}
        if telemetry.enabled():
            telemetry.emit("breaker_transition", old=old, new=new_state,
                           reason=why, entry=entry)

    def _maybe_dump(self) -> None:
        """Fire the deferred breaker-open flight dump outside the lock."""
        with self._lock:
            pending, self._pending_dump = self._pending_dump, None
        if pending is not None:
            tracing.dump_flight("breaker_open", extra=pending)

    # ------------------------------------------------------------ dispatch

    def decide(self, entry: str = DEFAULT_ENTRY) -> Decision:
        """Routing for the entry's next dispatch. In OPEN, a lapsed
        cooldown flips the shard to HALF_OPEN here so the very next batch
        is the probe."""
        with self._lock:
            sh = self._shard(entry)
            if sh.state == OPEN:
                if self._clock() - sh.opened_at >= self.cooldown_s:
                    self._move(entry, sh, HALF_OPEN,
                               "cooldown elapsed, probing device")
                else:
                    return Decision(True, None, False)
            if sh.state == HALF_OPEN:
                return Decision(False, self.degraded_rows, True)
            if sh.state == DEGRADED:
                return Decision(False, self.degraded_rows, False)
            return Decision(False, None, False)

    def on_success(self, entry: str = DEFAULT_ENTRY) -> None:
        with self._lock:
            sh = self._shard(entry)
            sh.fail_streak = 0
            sh.success_streak += 1
            if (sh.state == HALF_OPEN
                    and sh.success_streak >= self.probe_successes):
                self._move(entry, sh, CLOSED, f"{self.probe_successes} "
                           "probe dispatches succeeded")
            elif (sh.state == DEGRADED
                    and sh.success_streak >= self.recovery_successes):
                self._move(entry, sh, CLOSED, f"{self.recovery_successes} "
                           "clean dispatches at reduced chunk size")

    def on_failure(self, exc: BaseException,
                   entry: str = DEFAULT_ENTRY) -> None:
        with self._lock:
            sh = self._shard(entry)
            sh.success_streak = 0
            sh.fail_streak += 1
            if sh.state == HALF_OPEN:
                self._move(entry, sh, OPEN, f"probe dispatch failed: {exc}")
            elif sh.fail_streak >= self.fail_threshold:
                self._move(entry, sh, OPEN, f"{sh.fail_streak} consecutive "
                           f"dispatch failures (last: {exc})")
        self._maybe_dump()

    # ------------------------------------------------------------- signals

    def note_signals(self, signals: Dict[str, int]) -> None:
        """Pressure signals from telemetry.signals(): a compile burst or a
        memory high-water breach degrades every CLOSED shard (smaller
        chunks) without waiting for an outright failure; the signals are
        process-wide, so no single entry can be blamed. When named shards
        exist the default shard is left alone: it carries no traffic to
        recover through, and the aggregate view must not stay pinned at
        DEGRADED after every live entry has recovered."""
        compiles = int(signals.get("compiles", 0))
        hbm = int(signals.get("hbm_high_water_bytes", 0))
        with self._lock:
            prev = self._last_compiles
            self._last_compiles = compiles
            churn = (prev is not None
                     and compiles - prev >= self.compile_churn_limit)
            pressure = (self.hbm_limit_bytes
                        and hbm >= self.hbm_limit_bytes)
            if not churn and not pressure:
                return
            named = [e for e in self._shards if e != DEFAULT_ENTRY]
            for entry in (named or [DEFAULT_ENTRY]):
                sh = self._shards[entry]
                if sh.state != CLOSED:
                    continue
                if churn:
                    self._move(entry, sh, DEGRADED, "recompile churn: "
                               f"{compiles - prev} compiles since last check")
                else:
                    self._move(entry, sh, DEGRADED,
                               f"HBM high-water {hbm} >= limit "
                               f"{self.hbm_limit_bytes}")

    def rebaseline(self, signals: Dict[str, int]) -> None:
        """Reset the compile-churn baseline: called after a model load,
        whose warmup builds and captures are expected and must not read as
        churn."""
        with self._lock:
            self._last_compiles = int(signals.get("compiles", 0))

    def info(self) -> Dict[str, Any]:
        with self._lock:
            worst = self._worst()
            out = {
                "state": worst.state,
                "fail_streak": worst.fail_streak,
                "success_streak": worst.success_streak,
                "transitions": self.transitions,
                "degraded_rows": self.degraded_rows,
                "last_transitions": list(self.last_transitions),
            }
            entries = {e: {"state": sh.state,
                           "fail_streak": sh.fail_streak,
                           "success_streak": sh.success_streak}
                       for e, sh in self._shards.items() if e != DEFAULT_ENTRY}
            if entries:
                out["entries"] = entries
            return out
