"""The port's Prometheus exposition on the CPU, against the JAX package's.

Contract: `render_metrics` is BYTE-EQUAL to the JAX package's
`render_metrics` on the same counters, gauges, timer totals and calls,
stage quantiles, signals and extra gauges; the document parses, and
`write_snapshot` writes the same text.
"""
import numpy as np
import pytest

from lightgbm_tpu_torch import exposition, telemetry, tracing
from lightgbm_tpu_torch.utils.timer import global_timer
from tests.test_torch_ref import jax_ref  # noqa: F401

STATE = {
    "counters": {"device_hist_rows": 123456, "device_waves": 42, "serve_batches": 7,
                 "wave_k": 21, "serve_queue_depth": 0, "serve_breaker_state": 2,
                 "odd-name.with chars": 3, "9starts_with_digit": 1},
    "gauges": {"wave_k", "serve_queue_depth", "serve_breaker_state"},
    "totals": {"tree_device": 1.25, "find_best_split": 0.000123456789,
               "update_score": 2.0},
    "counts": {"tree_device": 10, "find_best_split": 300, "update_score": 10},
}
SIGNALS = {"compiles": 5, "kernel_compiles": 2, "hbm_high_water_bytes": 123456789}
EXTRA = {"serve_batcher_requests": 256, "serve_breaker_transitions": 3,
         "serve_flight_enabled": 1, "serve_p99_ms": 1.75, "flag": True,
         "text": "not a number"}
SPANS = [("serve_request", {"parse": 1e-4, "device": 2.5e-3}),
         ("serve_request", {"parse": 3e-4, "device": 1.5e-3}),
         ("train_iteration", {"boost": 0.02})]


def _install(timer, monkeypatch):
    from collections import defaultdict

    for name in ("counters", "totals", "counts"):
        d = defaultdict(int if name != "totals" else float)
        d.update(STATE[name])
        monkeypatch.setattr(timer, name, d)
    monkeypatch.setattr(timer, "gauges", set(STATE["gauges"]))


def _spans(tr):
    tr.reset()
    for name, stages in SPANS:
        span = tr.start_span(name)
        for stage, dur in stages.items():
            span.add_stage(stage, dur)
        span.finish()


@pytest.mark.parametrize("with_extra", [False, True])
def test_render_byte_equal_to_jax(jax_ref, monkeypatch, with_extra):
    from lightgbm_tpu import exposition as jax_expo
    from lightgbm_tpu import telemetry as jax_tel
    from lightgbm_tpu import tracing as jax_tracing
    from lightgbm_tpu.utils.timer import global_timer as jax_timer

    assert not telemetry.enabled() and not jax_tel.enabled()
    _install(global_timer, monkeypatch)
    _install(jax_timer, monkeypatch)
    try:
        _spans(tracing)
        _spans(jax_tracing)
        extra = EXTRA if with_extra else None
        ours = exposition.render_metrics(extra, signals=SIGNALS)
        theirs = jax_expo.render_metrics(extra, signals=SIGNALS)
    finally:
        tracing.reset()
        jax_tracing.reset()
    assert ours == theirs
    parsed = exposition.parse_exposition(ours)
    assert parsed[("lgbm_tpu_compiles_total", ())] == 5
    assert parsed[("lgbm_tpu_device_hist_rows_total", ())] == 123456
    assert parsed[("lgbm_tpu_wave_k", ())] == 21
    assert parsed[("lgbm_tpu_stage_seconds_total", (("stage", "tree_device"),))] == 1.25
    assert ("lgbm_tpu_serve_request_stage_device_p99_ms", ()) in parsed
    if with_extra:
        assert parsed[("lgbm_tpu_serve_batcher_requests", ())] == 256
        assert ("lgbm_tpu_text", ()) not in parsed


def test_signal_owned_counters_appear_once(monkeypatch):
    monkeypatch.setattr(global_timer, "counters", {"compiles": 9, "kernel_compiles": 1,
                                                   "hbm_high_water_bytes": 4})
    monkeypatch.setattr(global_timer, "gauges", {"hbm_high_water_bytes"})
    monkeypatch.setattr(global_timer, "totals", {})
    monkeypatch.setattr(global_timer, "counts", {})
    text = exposition.render_metrics(signals=SIGNALS)
    samples = [ln for ln in text.splitlines() if not ln.startswith("#")]
    assert sum(ln.startswith("lgbm_tpu_compiles_total ") for ln in samples) == 1
    assert sum(ln.startswith("lgbm_tpu_hbm_high_water_bytes ") for ln in samples) == 1
    assert exposition.parse_exposition(text)[("lgbm_tpu_compiles_total", ())] == 5


def test_parse_rejects_malformed_lines():
    with pytest.raises(ValueError):
        exposition.parse_exposition("lgbm_tpu_x{stage=\"a\"} 1 2\n")
    assert exposition.parse_exposition("# HELP x y\n\nlgbm_tpu_x 3\n") == {
        ("lgbm_tpu_x", ()): 3.0}


def test_write_snapshot_writes_the_rendered_text(tmp_path):
    path = str(tmp_path / "metrics.prom")
    text = exposition.write_snapshot(path, extra={"unit_gauge": np.float64(2.5).item()},
                                     signals=SIGNALS)
    with open(path) as fh:
        assert fh.read() == text
    assert exposition.parse_exposition(text)[("lgbm_tpu_unit_gauge", ())] == 2.5
