"""Drift detection and the bin refresh (streaming/drift.py, RowBlockStore.
maybe_refresh_bins) on the CPU, against the JAX package's streaming/drift.py.

Contracts:

* QuantileSketch holds the JAX sketch's retained values byte for byte on
  the same pushes (levels, counts, parity), through merges and
  `merge_ranked`; quantile samples, PSI and edge overflow equal;
* refitted mappers and the feature and group LUTs equal the JAX package's;
* a planted `drift_shift` latches the alarm with a flight dump, and the
  refresh restores the shifted feature's resolution, leaving a published
  model's text and predictions as they were;
* `sketch_corrupt` drops the sketch and keeps the feature's cut points;
* with drift off no monitor exists and no sketch work runs (by counter),
  and the models equal a drift-on run's that never refreshes;
* the service's stats carry `drift.latest()`.
"""
import json

import numpy as np
import pytest

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import tracing
from lightgbm_tpu_torch.serving import PredictionService
from lightgbm_tpu_torch.streaming import ContinuousTrainer, RowBlockStore, drift
from lightgbm_tpu_torch.streaming.drift import QuantileSketch, merge_ranked
from lightgbm_tpu_torch.utils import faults
from lightgbm_tpu_torch.utils.timer import global_timer
from tests.test_torch_ref import jax_ref  # noqa: F401

BASE = {"objective": "binary", "num_leaves": 15, "learning_rate": 0.1, "verbosity": -1,
        "min_data_in_leaf": 5, "device_type": "cpu"}


@pytest.fixture(autouse=True)
def _disarm_faults():
    yield
    faults.clear()


def _chunks(seed=3, n=2048, f=8, shift_from=None, shift_feature=0):
    rng = np.random.RandomState(seed)
    X = rng.standard_normal((n, f))
    y = (X[:, 1] + 0.3 * X[:, 2] > 0).astype(np.float64)
    if shift_from is not None:
        X[shift_from:, shift_feature] = X[shift_from:, shift_feature] * 3.0 + 10.0
    return X, y


def _same_sketch(a, b):
    assert (a.k, a.nonzero_n, a.zero_n, a.nan_n, a._parity) == \
        (b.k, b.nonzero_n, b.zero_n, b.nan_n, b._parity)
    assert len(a.levels) == len(b.levels)
    for la, lb in zip(a.levels, b.levels):
        assert la.dtype == lb.dtype and la.tobytes() == lb.tobytes()


def _columns(seed, n_blocks=12):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n_blocks):
        col = rng.standard_normal(rng.randint(50, 400)) * (1 + i)
        col[rng.rand(col.size) < 0.1] = 0.0
        col[rng.rand(col.size) < 0.03] = np.nan
        out.append(col)
    return out


@pytest.mark.parametrize("k", [8, 64, 256])
def test_sketch_retains_the_jax_sketchs_values(jax_ref, k):
    from lightgbm_tpu.streaming import drift as jdrift

    ours, theirs = QuantileSketch(k), jdrift.QuantileSketch(k)
    for col in _columns(k):
        ours.update(col)
        theirs.update(col)
        _same_sketch(ours, theirs)
    for m in (1, 17, 500):
        assert ours.quantile_sample(m).tobytes() == theirs.quantile_sample(m).tobytes()
    assert ours.healthy() and theirs.healthy()


def test_merge_and_merge_ranked_equal_jax(jax_ref):
    from lightgbm_tpu.streaming import drift as jdrift

    shards = []
    for r in range(4):
        ours, theirs = QuantileSketch(32), jdrift.QuantileSketch(32)
        for col in _columns(10 + r, n_blocks=4):
            ours.update(col)
            theirs.update(col)
        shards.append((r, ours, theirs))
    order = [2, 0, 3, 1]  # arrival order: the merge canonicalizes on rank
    merged = merge_ranked([(shards[i][0], shards[i][1]) for i in order])
    jmerged = jdrift.merge_ranked([(shards[i][0], shards[i][2]) for i in order])
    _same_sketch(merged, jmerged)
    _same_sketch(merged, merge_ranked([(r, s) for r, s, _ in shards]))
    a = shards[0][1].copy().merge(shards[1][1])
    b = shards[0][2].copy().merge(shards[1][2])
    _same_sketch(a, b)
    with pytest.raises(ValueError, match="distinct ranks"):
        merge_ranked([(0, shards[0][1]), (0, shards[1][1])])


def test_psi_and_edge_overflow_equal_jax(jax_ref):
    from lightgbm_tpu.io.binning import BinMapper as JaxMapper
    from lightgbm_tpu.streaming import drift as jdrift
    from lightgbm_tpu_torch.io.binning import BinMapper

    rng = np.random.RandomState(4)
    ref, cur = rng.randint(0, 50, 20).astype(float), rng.randint(0, 50, 20).astype(float)
    assert drift.DriftMonitor.psi(ref, cur) == jdrift.DriftMonitor.psi(ref, cur)
    vals = rng.standard_normal(3000)
    ours, theirs = BinMapper(), JaxMapper()
    for m in (ours, theirs):
        m.find_bin(vals, 3000, 63)
    cur = np.bincount(ours.values_to_bins(vals * 3 + 1), minlength=ours.num_bin).astype(float)
    ref = np.bincount(ours.values_to_bins(vals), minlength=ours.num_bin).astype(float)
    assert drift.DriftMonitor.edge_overflow(ours, ref, cur) == \
        jdrift.DriftMonitor.edge_overflow(theirs, ref, cur) > 0.1


def _stores(jax_ref, monkeypatch, X, y, step=256, **kw):
    from lightgbm_tpu.streaming import RowBlockStore as JaxStore

    monkeypatch.setenv("LGBM_TPU_DRIFT", "1")
    ours, theirs = RowBlockStore(params=dict(BASE), **kw), JaxStore(params=dict(BASE), **kw)
    for lo in range(0, X.shape[0], step):
        ours.push_rows(X[lo:lo + step], label=y[lo:lo + step])
        theirs.push_rows(X[lo:lo + step], label=y[lo:lo + step])
    return ours, theirs


def _dicts(mappers):
    return json.dumps([m.to_dict() for m in mappers], sort_keys=True)


def test_refit_mappers_and_luts_equal_jax(jax_ref, monkeypatch):
    from lightgbm_tpu.streaming import drift as jdrift

    rng = np.random.RandomState(6)
    X, y = _chunks(n=3072, f=8, shift_from=1024, shift_feature=0)
    # columns 5-7 never nonzero together: EFB bundles them into one group
    owner = rng.randint(0, 6, 3072)
    X[:, 5:] = np.where(owner[:, None] == np.arange(3)[None, :], X[:, 5:], 0.0)
    ours, theirs = _stores(jax_ref, monkeypatch, X, y, bin_sample_rows=1024)
    for j in range(8):
        _same_sketch(ours._drift.sketches[j], theirs._drift.sketches[j])
    assert any(g.is_multi for g in ours._layout.groups)
    for j, mapper in enumerate(ours._layout.mappers):
        a = ours._drift.refit_mapper(j, mapper)
        b = theirs._drift.refit_mapper(j, theirs._layout.mappers[j])
        assert (a is None) == (b is None)
        if a is not None:
            assert _dicts([a]) == _dicts([b])
            assert np.array_equal(drift.feature_bin_lut(mapper, a),
                                  jdrift.feature_bin_lut(theirs._layout.mappers[j], b))
    assert ours.maybe_refresh_bins(force=True) and theirs.maybe_refresh_bins(force=True)
    assert ours.layout_generation == theirs.layout_generation == 1
    assert _dicts(ours._layout.mappers) == _dicts(theirs._layout.mappers)
    a, b = ours.finalize(), theirs.finalize()
    assert np.array_equal(a.bins, b.bins)


def test_alarm_and_refresh_restore_resolution(monkeypatch, tmp_path):
    tracing.reset()  # an earlier alarm in this process rate-limits the dump
    monkeypatch.setenv("LGBM_TPU_DRIFT", "1")
    monkeypatch.setenv("LGBM_TPU_DRIFT_CHECK_ROWS", "512")
    monkeypatch.setenv("LGBM_TPU_FLIGHT_DIR", str(tmp_path))
    faults.install("drift_shift@1024:0")
    X, y = _chunks(n=3072)
    store = RowBlockStore(params=dict(BASE), bin_sample_rows=1024)
    tr = ContinuousTrainer(dict(BASE), store, num_boost_round=3)
    store.push_rows(X[:1024], label=y[:1024])
    published = tr.step()
    old_text = published.model_to_string()
    old_preds = published.predict(X[:256], raw_score=True)
    alarms = global_timer.counters.get("drift_alarms", 0)
    for lo in range(1024, 3072, 256):
        store.push_rows(X[lo:lo + 256], label=y[lo:lo + 256])
    mon = store._drift
    assert mon.alarmed and mon.alarm_feature == 0
    assert global_timer.counters["drift_alarms"] == alarms + 1
    assert (tmp_path / "flight-drift_alarm.json").exists()
    assert drift.latest()["max_psi"] >= mon.threshold
    assert global_timer.counters["drift_psi_milli_max"] >= 1000 * mon.threshold
    shifted = X[1024:2048, 0] * 3.0 + 10.0  # what the fault made of them
    before = len(np.unique(store._layout.mappers[0].values_to_bins(shifted)))
    assert store.maybe_refresh_bins() is True
    assert store.layout_generation == 1 and not mon.alarmed
    new_bins = store._layout.mappers[0].values_to_bins(shifted)
    assert len(np.unique(new_bins)) > 4 * max(before, 1)
    assert (new_bins >= store._layout.mappers[0].num_bin - 2).mean() < 0.2
    assert published.model_to_string() == old_text
    np.testing.assert_array_equal(published.predict(X[:256], raw_score=True), old_preds)
    assert tr.step() is not None and tr.generation == 2


def test_sketch_corrupt_drops_the_sketch_and_keeps_cut_points(monkeypatch):
    monkeypatch.setenv("LGBM_TPU_DRIFT", "1")
    monkeypatch.setenv("LGBM_TPU_DRIFT_CHECK_ROWS", "256")
    faults.install("sketch_corrupt@2")
    X, y = _chunks(n=2048, f=6)
    store = RowBlockStore(params=dict(BASE), bin_sample_rows=512)
    for lo in range(0, 2048, 256):
        store.push_rows(X[lo:lo + 256], label=y[lo:lo + 256])
    assert not store._drift.sketches[2].healthy()
    dropped = global_timer.counters.get("drift_sketch_discarded", 0)
    old = store._layout.mappers[2]
    assert store.maybe_refresh_bins(force=True) is True
    assert store._layout.mappers[2] is old
    assert global_timer.counters["drift_sketch_discarded"] == dropped + 1
    assert store._drift.sketches[2].healthy()


def test_drift_off_does_no_sketch_work(monkeypatch):
    """With LGBM_TPU_DRIFT unset no monitor exists and no sketch update or
    check runs (counted, not timed); the model equals a drift-on run's."""
    X, y = _chunks(n=1536, f=6)
    updates = []
    real_update = QuantileSketch.update

    def counting(self, col):
        updates.append(1)
        return real_update(self, col)

    monkeypatch.setattr(QuantileSketch, "update", counting)

    def run():
        store = RowBlockStore(params=dict(BASE), bin_sample_rows=512)
        for lo in range(0, 1536, 256):
            store.push_rows(X[lo:lo + 256], label=y[lo:lo + 256])
        return store, lt.train(dict(BASE), store.to_basic_dataset(params=dict(BASE)),
                               num_boost_round=3)

    monkeypatch.delenv("LGBM_TPU_DRIFT", raising=False)
    checks = global_timer.counters.get("drift_checks", 0)
    off_store, off_model = run()
    assert off_store._drift is None
    assert updates == [] and global_timer.counters.get("drift_checks", 0) == checks
    monkeypatch.setenv("LGBM_TPU_DRIFT", "1")
    on_store, on_model = run()
    assert on_store._drift is not None and len(updates) == 6 * 6
    assert global_timer.counters["drift_checks"] > checks
    assert off_model.model_to_string() == on_model.model_to_string()


def test_service_stats_carry_drift():
    svc = PredictionService(device="cpu")
    try:
        assert svc.stats()["drift"] == drift.latest()
    finally:
        svc.close()
