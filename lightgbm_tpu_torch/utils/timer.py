"""Per-label accumulating wall-clock timer.

Counterpart of the reference's Common::Timer/FunctionTimer RAII scopes
(include/LightGBM/utils/common.h:979-1063) that feed `global_timer`, printed
at exit under -DUSE_TIMETAG: a context manager / decorator that accumulates
per-label seconds when LGBM_TPU_TIMETAG is set (or a telemetry session
records), plus always-on integer work counters. The scopes time the host:
on the CUDA card they close when the host returns, which for a kernel
launch is before the device finishes (kernel times come from CUDA events,
not from here).

The timer is also the span source of the telemetry stack (telemetry.py): a
session installs `span_hook`, every closed scope reports (label, start,
end) to it, and the Chrome-trace exporter turns those into B/E events.
`new_epoch()` gives each engine.train() call a fresh accumulation window
(counters survive: tests and the smoke read them after training).
`scope_hooks` see every scope open and close, with timing off too: the
sync sanitizer (utils/sanitize.py) installs its pair to keep each thread's
stack of open labels and charge a host read to the innermost one.
"""
from __future__ import annotations

import contextlib
import functools
import os
import time
from collections import defaultdict
from typing import Callable, Dict, Iterator, List, Optional, Tuple


class GlobalTimer:
    def __init__(self) -> None:
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.counters: Dict[str, int] = defaultdict(int)
        # labels published via set_count (levels, not accumulations)
        self.gauges: set = set()
        self.enabled = bool(os.environ.get("LGBM_TPU_TIMETAG"))
        self.epoch = 0
        # telemetry sink: span_hook(label, t0, t1) on every closed scope
        # (perf_counter seconds); None when no session records
        self.span_hook: Optional[Callable[[str, float, float], None]] = None
        # (enter(label), exit(label)) pairs; empty unless the sanitizer runs
        self.scope_hooks: List[Tuple[Callable[[str], None], Callable[[str], None]]] = []

    @contextlib.contextmanager
    def scope(self, label: str) -> Iterator[None]:
        hooks = self.scope_hooks
        for enter, _ in hooks:
            enter(label)
        if not self.enabled:
            try:
                yield
            finally:
                for _, leave in hooks:
                    leave(label)
            return
        start = time.perf_counter()
        try:
            yield
        finally:
            end = time.perf_counter()
            self.totals[label] += end - start
            self.counts[label] += 1
            if self.span_hook is not None:
                self.span_hook(label, start, end)
            for _, leave in hooks:
                leave(label)

    def add_count(self, label: str, n: int) -> None:
        """Accumulate a work counter (rows predicted, chunks streamed, ...).
        Always on, unlike the wall-clock scopes: counters are cheap ints."""
        self.counters[label] += int(n)

    def set_count(self, label: str, n: int) -> None:
        """Set a gauge counter (a level, not an accumulation)."""
        self.counters[label] = int(n)
        self.gauges.add(label)

    def report(self) -> str:
        lines = ["LightGBM-TPU timer summary:"]
        # deterministic: totals descending, equal totals tie-broken by label
        for label in sorted(self.totals, key=lambda k: (-self.totals[k], k)):
            lines.append(f"  {label}: {self.totals[label]:.3f}s ({self.counts[label]} calls)")
        for label in sorted(self.counters):
            lines.append(f"  {label}: {self.counters[label]}")
        return "\n".join(lines)

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()
        self.counters.clear()

    def new_epoch(self) -> int:
        """Start a fresh per-run window: wall-clock totals and call counts
        reset, work counters survive. Returns the new epoch id, which
        telemetry records carry."""
        self.totals.clear()
        self.counts.clear()
        self.epoch += 1
        return self.epoch


global_timer = GlobalTimer()


def timed(label: str):
    """Decorator form of global_timer.scope."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with global_timer.scope(label):
                return fn(*args, **kwargs)

        return wrapper

    return deco
