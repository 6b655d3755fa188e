"""The port's telemetry layer on the CPU: sessions, sinks, watchers, the
Chrome trace against the JAX package's exporter, and training with
telemetry on against telemetry off.

Contracts:

* `build_chrome_trace` returns a document EQUAL (as JSON values) to the
  JAX package's on the same spans and counter samples, ties and nesting
  included;
* a run with a session (``telemetry_dir`` or $LGBM_TPU_TELEMETRY) writes
  ``events.jsonl``, ``trace.json`` and ``metrics.prom``, and its model text
  is byte-equal to the same run with telemetry off; $LGBM_TPU_PROFILE
  writes a torch.profiler trace;
* the disabled path costs under 1% of an iteration (the JAX package's
  budget, tests/test_telemetry.py:357).
"""
import json
import os
import time

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import exposition, telemetry
from lightgbm_tpu_torch.telemetry import build_chrome_trace
from lightgbm_tpu_torch.treelearner.device import DeviceTreeLearner
from lightgbm_tpu_torch.utils.timer import global_timer
from tests.test_torch_ref import jax_ref  # noqa: F401

PARAMS = {"objective": "binary", "num_leaves": 7, "device_type": "cpu",
          "verbosity": -1, "min_data_in_leaf": 5}


@pytest.fixture(autouse=True)
def _no_session():
    telemetry.stop()
    yield
    telemetry.stop()


def _data(seed=3, n=600, f=6):
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, f)).astype(np.float32)
    y = (X[:, 0] - 0.5 * X[:, 1] + 0.5 * rng.normal(size=n) > 0).astype(np.float64)
    return X, y


def _events(d):
    with open(os.path.join(d, telemetry.EVENTS_FILE)) as fh:
        return [json.loads(line) for line in fh]


# ------------------------------------------------------ the Chrome trace

TRACE_CASES = [
    # outer contains inner; a zero-length span and an exact tie stress the
    # E-before-B order (the JAX package's tests/test_telemetry.py:335)
    ([("outer", 0.0, 0.010), ("inner", 0.002, 0.004), ("inner", 0.004, 0.004),
      ("outer", 0.010, 0.020)], [("hbm:dev", 0.001, 5)]),
    # equal starts and ends on two labels, a counter at a span edge
    ([("a", 0.0, 0.005), ("b", 0.0, 0.005), ("a", 0.005, 0.0050004),
      ("c", 1e-7, 2e-7)], [("hbm:cuda:0", 0.005, 7), ("hbm:cuda:0", 0.0, 1)]),
    ([], []),
]


@pytest.mark.parametrize("case", range(len(TRACE_CASES)))
def test_chrome_trace_equals_jax(jax_ref, case):
    from lightgbm_tpu.telemetry import build_chrome_trace as jax_trace

    spans, samples = TRACE_CASES[case]
    ours = build_chrome_trace(spans, samples, label="unit")
    assert ours == jax_trace(spans, samples, label="unit")
    evs = [e for e in ours["traceEvents"] if e["ph"] != "M"]
    assert all(b["ts"] <= a["ts"] for b, a in zip(evs, evs[1:]))


def test_chrome_trace_nests_containment():
    spans, samples = TRACE_CASES[0]
    evs = [e for e in build_chrome_trace(spans, samples, label="unit")["traceEvents"]
           if e["ph"] != "M"]
    at_10ms = [(e["ph"], e["name"]) for e in evs if e["ts"] == 10000]
    assert at_10ms.index(("E", "outer")) < at_10ms.index(("B", "outer"))
    c = [e for e in evs if e["ph"] == "C"]
    assert len(c) == 1 and c[0]["args"]["bytes"] == 5


# ------------------------------------------- training with a session


def test_telemetry_dir_writes_sinks_and_is_bit_identical(tmp_path):
    X, y = _data()
    d = str(tmp_path / "tel")
    on = lt.train({**PARAMS, "telemetry_dir": d}, lt.Dataset(X, label=y), 4)
    off = lt.train(PARAMS, lt.Dataset(X, label=y), 4)
    assert on.model_to_string() == off.model_to_string()
    assert sorted(os.listdir(d)) == ["events.jsonl", "metrics.prom", "trace.json"]
    evs = _events(d)
    kinds = [e["ev"] for e in evs]
    assert kinds[0] == "session_start" and kinds[-1] == "session_end"
    assert kinds.count("iteration") == 4 and kinds.count("train_begin") == 1
    its = [e for e in evs if e["ev"] == "iteration"]
    assert [e["iteration"] for e in its] == [0, 1, 2, 3]
    assert all(e["num_trees"] == i + 1 for i, e in enumerate(its))
    with open(os.path.join(d, "trace.json")) as fh:
        trace = json.load(fh)
    names = {e["name"] for e in trace["traceEvents"] if e["ph"] == "B"}
    assert {"tree_train", "find_best_split", "train_iteration.boost"} <= names
    with open(os.path.join(d, "metrics.prom")) as fh:
        metrics = exposition.parse_exposition(fh.read())
    assert ("lgbm_tpu_compiles_total", ()) in metrics
    assert not telemetry.enabled()


def test_env_var_enables_telemetry_and_profile_writes_trace(tmp_path, monkeypatch):
    X, y = _data()
    d, prof = str(tmp_path / "env"), str(tmp_path / "prof")
    monkeypatch.setenv("LGBM_TPU_TELEMETRY", d)
    monkeypatch.setenv("LGBM_TPU_PROFILE", prof)
    lt.train(PARAMS, lt.Dataset(X, label=y), 2)
    assert os.path.exists(os.path.join(d, "events.jsonl"))
    traces = os.listdir(prof)
    assert len(traces) == 1 and traces[0].endswith(".json")
    with open(os.path.join(prof, traces[0])) as fh:
        names = {e.get("name") for e in json.load(fh)["traceEvents"]}
    assert any(n and "aten::" in n for n in names)


def test_wave_learner_emits_tree_wave_events(tmp_path):
    """A GBDT whose learner is the wave learner (on the CPU the factory picks
    the serial one): a tree_wave event a tree, from the host, after the
    tree's results; and the perfmodel gauges of its buffers published."""
    X, y = _data(n=400)
    ds = lt.Dataset(X, label=y)
    bst = lt.Booster({**PARAMS, "num_iterations": 3}, ds)
    bst._gbdt.tree_learner = DeviceTreeLearner(bst._gbdt.config, ds._handle,
                                               torch.device("cpu"))
    d = str(tmp_path / "wave")
    with telemetry.capture(d):
        for _ in range(3):
            bst.update()
    evs = _events(d)
    waves = [e for e in evs if e["ev"] == "tree_wave"]
    assert len(waves) == 3
    assert all(e["waves"] >= 1 and e["committed"] <= e["speculated"] for e in waves)
    G, N = ds._handle.bins.shape
    assert global_timer.counters["device_carry_bytes_per_wave"] == G * N + N * 5 * 4
    assert global_timer.counters["device_hist_bytes_per_row"] == G + 16


# ---------------------------------------------------------- the watchers


def test_compile_watcher_splits_kernel_builds_and_warns(capsys):
    with telemetry.capture(None, recompile_warn=3) as s:
        for _ in range(3):
            telemetry.note_compile("tree_graph", kernel=False)
        telemetry.note_compile("histogram.cu", kernel=True)
        assert telemetry.signals() == {"compiles": 4, "kernel_compiles": 1,
                                       "hbm_high_water_bytes": 0}
    assert "Recompile churn: 'tree_graph' compiled 3 times" in capsys.readouterr().out
    assert s.aggregate["compile"] == 4
    assert telemetry.signals()["compiles"] == 0  # no session: zeros


class _FakeCard:
    def __init__(self, name, peaks):
        self.name, self.peaks = name, list(peaks)

    def memory_stats(self):
        return {"allocated_bytes.all.peak": self.peaks.pop(0)} if self.peaks else {}

    def __str__(self):
        return self.name


def test_hbm_gauge_tracks_high_water_and_counter_track(tmp_path):
    cards = [_FakeCard("cuda:0", [100, 300, 200]), _FakeCard("cuda:1", [50])]
    d = str(tmp_path / "hbm")
    with telemetry.capture(d, devices=cards):
        assert telemetry.sample_hbm() == 100
        assert telemetry.sample_hbm() == 300
        summary_before = telemetry.session().signal_snapshot()
    assert summary_before["hbm_high_water_bytes"] == 300
    assert global_timer.counters["hbm_high_water_bytes"] == 300
    with open(os.path.join(d, "trace.json")) as fh:
        c = [e for e in json.load(fh)["traceEvents"] if e["ph"] == "C"]
    assert [e["args"]["bytes"] for e in c if e["name"] == "hbm:cuda:0"] == [100, 300, 200]


def test_hbm_gauge_is_a_noop_on_the_cpu():
    with telemetry.capture(None):
        assert telemetry.sample_hbm() == 0


def test_counter_deltas_scope_accumulators_to_the_session():
    global_timer.add_count("unit_acc", 5)
    global_timer.set_count("unit_gauge", 9)
    with telemetry.capture(None) as s:
        global_timer.add_count("unit_acc", 2)
        deltas = s.counter_deltas()
    assert deltas["unit_acc"] == 2 and deltas["unit_gauge"] == 9


def test_second_start_keeps_first_and_capture_closes_on_exception(tmp_path):
    first = telemetry.start(None)
    assert telemetry.start(str(tmp_path / "x")) is first
    telemetry.stop()
    with pytest.raises(RuntimeError):
        with telemetry.capture(str(tmp_path / "y")):
            raise RuntimeError("boom")
    assert not telemetry.enabled()
    assert os.path.exists(str(tmp_path / "y" / "events.jsonl"))


def test_session_restores_timer_hooks():
    before = (global_timer.enabled, global_timer.span_hook)
    with telemetry.capture(None):
        assert global_timer.enabled and global_timer.span_hook is not None
        with global_timer.scope("unit_scope"):
            pass
        assert telemetry.session().spans[-1][0] == "unit_scope"
    assert (global_timer.enabled, global_timer.span_hook) == before


def test_jsonl_flush_cadence(tmp_path):
    d = str(tmp_path / "flush")
    with telemetry.capture(d, flush_every=4):
        for i in range(3):
            telemetry.emit("unit", i=i)
        assert len(_events(d)) == 4  # session_start + 3: the 4th event flushed
        telemetry.emit("unit", i=3)
        assert len(_events(d)) == 4


def test_event_payloads_jsonable_for_tensors(tmp_path):
    d = str(tmp_path / "json")
    with telemetry.capture(d):
        telemetry.emit("unit", scalar=torch.tensor(3.5), vec=torch.arange(3),
                       npv=np.float32(1.5))
    rec = [e for e in _events(d) if e["ev"] == "unit"][0]
    assert rec["scalar"] == 3.5 and rec["vec"] == [0, 1, 2] and rec["npv"] == 1.5


# ----------------------------------------------------- the overhead budget

# a generous stand-in for the enabled()/emit() call sites an iteration hits
_CALL_SITES_PER_ITER = 2000


def test_disabled_overhead_under_one_percent():
    assert not telemetry.enabled()
    n = 100_000
    t0 = time.perf_counter()
    for _ in range(n):
        telemetry.emit("hot", a=1)
    emit_cost = (time.perf_counter() - t0) / n
    t0 = time.perf_counter()
    for _ in range(n):
        telemetry.enabled()
    guard_cost = (time.perf_counter() - t0) / n
    X, y = _data(n=2000, f=20)
    lt.train(PARAMS, lt.Dataset(X, label=y), 1)
    rounds = 5
    t0 = time.perf_counter()
    lt.train(PARAMS, lt.Dataset(X, label=y), rounds)
    iter_wall = (time.perf_counter() - t0) / rounds
    worst = max(emit_cost, guard_cost)
    modeled_pct = 100.0 * _CALL_SITES_PER_ITER * worst / iter_wall
    assert modeled_pct < 1.0, (
        f"disabled telemetry path: {modeled_pct:.3f}% modeled overhead "
        f"({worst * 1e9:.0f} ns a site x {_CALL_SITES_PER_ITER} sites vs "
        f"{iter_wall * 1e3:.1f} ms an iteration)")


# ------------------------------------------------------------ fingerprint


def test_fingerprint_and_world_fingerprint(monkeypatch):
    from lightgbm_tpu_torch import checkpoint, fingerprint

    monkeypatch.setenv("LGBM_TPU_UNIT_FLAG", "1")
    fp = fingerprint.fingerprint()
    assert fp["torch_version"] == str(torch.__version__)
    assert fp["flags"]["LGBM_TPU_UNIT_FLAG"] == "1"
    assert fp["schema_version"] == fingerprint.LEDGER_SCHEMA_VERSION
    assert {"git_sha", "cuda_version", "device_kind", "card", "power_limit"} <= fp.keys()
    # the sidecar's world block keeps its keys; checkpoint.py imports it from here
    world = fingerprint.world_fingerprint("cpu")
    assert checkpoint.world_fingerprint is fingerprint.world_fingerprint
    assert world == {"process_count": 1, "mesh_shape": [1], "device_kinds": ["cpu"],
                     "torch_version": str(torch.__version__),
                     "cuda_version": str(torch.version.cuda)}


def test_fingerprint_reads_the_card_identity(monkeypatch):
    """The card's name and power limit are nvidia-smi's strings; where it is
    absent or fails they are "unknown" and nothing raises."""
    import subprocess

    from lightgbm_tpu_torch import fingerprint

    class Done:
        returncode, stdout = 0, "NVIDIA H100 80GB HBM3, 700.00 W\nNVIDIA H100 80GB HBM3, 700.00 W\n"

    real_run = subprocess.run

    def fake_run(cmd, *a, **kw):
        return Done() if cmd[0] == "nvidia-smi" else real_run(cmd, *a, **kw)

    monkeypatch.setattr(subprocess, "run", fake_run)
    assert fingerprint.card_identity() == "NVIDIA H100 80GB HBM3, 700.00 W"
    fp = fingerprint.fingerprint()
    assert (fp["card"], fp["power_limit"]) == ("NVIDIA H100 80GB HBM3", "700.00 W")

    def missing(cmd, *a, **kw):
        if cmd[0] == "nvidia-smi":
            raise FileNotFoundError(cmd[0])
        return real_run(cmd, *a, **kw)

    monkeypatch.setattr(subprocess, "run", missing)
    assert fingerprint.card_identity() is None
    fp = fingerprint.fingerprint()
    assert (fp["card"], fp["power_limit"]) == ("unknown", "unknown")
