"""Prometheus text exposition for the telemetry counter namespace.

Counterpart of the JAX package's ``exposition.py``, with the same metric
names (``lgbm_tpu_`` prefix), so one scrape configuration reads either
package. One renderer, two transports: the serving HTTP server mounts it
at ``GET /metrics`` (serving/http.py) and training writes the same text as
a ``metrics.prom`` snapshot into the telemetry dir at every flush
(telemetry.py). Everything renders from namespaces that already exist:
`telemetry.signals()` (compiles and the card's memory high-water),
`global_timer.counters` (work counters and gauges: rows histogrammed,
waves, the serving queue depth and breaker state...), the tracing stage
quantiles and `global_timer.totals`/`counts` (per-scope seconds and calls).

Exposition format 0.0.4 (text/plain). Naming:

  * accumulating counters  -> ``lgbm_tpu_<name>_total``
  * gauges (set_count)     -> ``lgbm_tpu_<name>``
  * timer scopes           -> ``lgbm_tpu_stage_seconds_total{stage="..."}``
                              and ``lgbm_tpu_stage_calls_total{stage=...}``
  * signals                -> ``lgbm_tpu_compiles_total``,
                              ``lgbm_tpu_kernel_compiles_total``,
                              ``lgbm_tpu_hbm_high_water_bytes``
"""
from __future__ import annotations

import re
from typing import Any, Dict, List, Mapping, Optional, Tuple

from . import telemetry, tracing
from .utils.timer import global_timer

PREFIX = "lgbm_tpu"
CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"
SNAPSHOT_FILE = "metrics.prom"

# counter-namespace keys the signals() snapshot owns; skipped in the
# generic counter walk so each figure appears once
_SIGNAL_OWNED = ("compiles", "kernel_compiles", "hbm_high_water_bytes")

_NAME_OK = re.compile(r"[^a-zA-Z0-9_]")


def _metric_name(raw: str, suffix: str = "") -> str:
    name = _NAME_OK.sub("_", raw.strip())
    if name and name[0].isdigit():
        name = "_" + name
    return f"{PREFIX}_{name}{suffix}"


def _escape_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt(v: Any) -> str:
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


class _Writer:
    def __init__(self) -> None:
        self.lines: List[str] = []
        self._typed: set = set()

    def sample(self, name: str, mtype: str, value: Any, help_text: str = "",
               labels: Optional[Mapping[str, str]] = None) -> None:
        if name not in self._typed:
            self._typed.add(name)
            if help_text:
                self.lines.append(f"# HELP {name} {help_text}")
            self.lines.append(f"# TYPE {name} {mtype}")
        label_s = ""
        if labels:
            inner = ",".join(f'{k}="{_escape_label(str(v))}"'
                             for k, v in sorted(labels.items()))
            label_s = "{" + inner + "}"
        self.lines.append(f"{name}{label_s} {_fmt(value)}")

    def text(self) -> str:
        return "\n".join(self.lines) + "\n" if self.lines else ""


def render_metrics(extra: Optional[Mapping[str, Any]] = None,
                   signals: Optional[Mapping[str, int]] = None) -> str:
    """The full exposition document as a string.

    `extra` adds flat name->number gauges (the serving handler passes the
    service's stats); names are sanitized into the ``lgbm_tpu_`` namespace.
    `signals` overrides the live `telemetry.signals()` read: the close-time
    snapshot passes the closing session's own figures."""
    w = _Writer()
    sig = telemetry.signals() if signals is None else signals
    # the HELP strings are the JAX package's, word for word, so the two
    # packages' documents are byte-identical; in this package `compiles`
    # counts CUDA graph captures and nvcc builds, `kernel_compiles` the
    # builds, and the high-water is the card's peak of allocated bytes
    w.sample(_metric_name("compiles", "_total"), "counter",
             sig.get("compiles", 0),
             "XLA jit cache misses seen by the recompile watcher")
    w.sample(_metric_name("kernel_compiles", "_total"), "counter",
             sig.get("kernel_compiles", 0),
             "Pallas/Mosaic kernel compiles (subset of compiles)")
    w.sample(_metric_name("hbm_high_water_bytes"), "gauge",
             sig.get("hbm_high_water_bytes", 0),
             "Peak per-device HBM bytes in use this session")
    w.sample(_metric_name("telemetry_enabled"), "gauge",
             1 if telemetry.enabled() else 0,
             "1 while a telemetry session is recording")
    for key in sorted(global_timer.counters):
        if key in _SIGNAL_OWNED:
            continue
        value = global_timer.counters[key]
        if key in global_timer.gauges:
            w.sample(_metric_name(key), "gauge", value,
                     "level gauge from the global_timer counter namespace")
        else:
            w.sample(_metric_name(key, "_total"), "counter", value,
                     "work counter from the global_timer counter namespace")
    for key, value in sorted(tracing.quantile_gauges().items()):
        w.sample(_metric_name(key), "gauge", value,
                 "stage latency quantile from the tracing histograms (ms)")
    sec_name = f"{PREFIX}_stage_seconds_total"
    calls_name = f"{PREFIX}_stage_calls_total"
    for label in sorted(global_timer.totals):
        w.sample(sec_name, "counter", global_timer.totals[label],
                 "accumulated wall seconds per timer scope",
                 labels={"stage": label})
    for label in sorted(global_timer.counts):
        w.sample(calls_name, "counter", global_timer.counts[label],
                 "closed-scope count per timer scope",
                 labels={"stage": label})
    for key in sorted(extra or {}):
        val = (extra or {})[key]
        if isinstance(val, bool) or not isinstance(val, (int, float)):
            continue
        w.sample(_metric_name(key), "gauge", val,
                 "point-in-time gauge supplied by the exposition caller")
    return w.text()


def parse_exposition(text: str) -> Dict[Tuple[str, Tuple[Tuple[str, str], ...]], float]:
    """Minimal 0.0.4 parser for tests and tools: sample lines to
    {(name, ((label, value), ...)): float}. Raises ValueError on a
    malformed sample line."""
    out: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = re.match(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)'
                     r'(?:\{([^}]*)\})?\s+(\S+)$', line)
        if m is None:
            raise ValueError(f"malformed exposition line: {line!r}")
        labels: List[Tuple[str, str]] = []
        if m.group(2):
            for part in re.findall(r'([a-zA-Z_][a-zA-Z0-9_]*)="([^"]*)"', m.group(2)):
                labels.append(part)
        out[(m.group(1), tuple(labels))] = float(m.group(3))
    return out


def write_snapshot(path: str, extra: Optional[Mapping[str, Any]] = None,
                   signals: Optional[Mapping[str, int]] = None) -> str:
    """Render and atomically write the exposition text to `path` (the
    training-side textfile-collector hand-off). Returns the text."""
    from .checkpoint import atomic_write_text

    text = render_metrics(extra, signals=signals)
    atomic_write_text(path, text)
    return text
