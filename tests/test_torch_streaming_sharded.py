"""Gang-sharded streaming (lightgbm_tpu_torch/streaming/sharded.py) on the
CPU, after the JAX package's tests/test_streaming_sharded.py.

Contracts:
* tree_learner=data under a budget 4x below the plane, on a gloo gang of
  4 ranks: ShardedStreamedTreeLearner, byte-equal to the single-card
  streamed learner for float on snapped gradients (the CPU ranks add
  float32 images) and for quantized on any gradients, with `stream_shards`
  4; each rank uploads only the blocks it owns (b % 4 == rank) (JAX :89);
* the wire gauge `stream_ici_bytes_per_wave` is perfmodel's closed form,
  the same at 1,024 and 2,048 rows, and the bytes counted at the
  collectives are that gauge times the leaf histograms (JAX :116);
* the factory routes data under a budget to the sharded learner (the plane
  never uploads whole) and refuses feature and voting (JAX :141-170);
* the layout fit from rank-merged sketches is the raw-prefix fit, cut
  points, EFB groups and plane, at 4 and 7 shards in one process and over
  the gang's all-gather (JAX :176);
* round-robin placement is pinned at push, with per-shard watermarks, and
  `reshard` re-takes it (JAX :216); the pod drift alarm and refresh replay
  byte-identically (JAX :236);
* a worker lost mid-refit is typed (every rank's watchdog), the
  generation rolls back with the watermark pinned, the gang shrinks from 4
  to 2 in place, the store reshards and the resumed refit is the
  undisturbed model (JAX :270-341);
* a shard's block cache refuses a block it does not own.

Held against the JAX package (`jax_ref`) on the same inputs: the sharded
fit's cut points, EFB groups and plane at 4 and 7 shards against its
ShardedRowBlockStore; the pod drift alarm and the refreshed cut points
under drift_shift against its PodDriftMonitor; the gang's float model on
snapped gradients, at the same budget, against its streamed learner's.
"""
import json

import numpy as np
import pytest

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import perfmodel
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.io.dataset import Dataset as CoreDataset
from lightgbm_tpu_torch.streaming import (PodDriftMonitor, RowBlockStore, ShardedRowBlockStore,
                                          ShardedStreamedTreeLearner, StreamedTreeLearner)
from lightgbm_tpu_torch.streaming.learner import BLOCK_ROWS_ENV, BUDGET_ENV, _BlockCache
from lightgbm_tpu_torch.utils import faults
from lightgbm_tpu_torch.utils.log import LightGBMError
from tests.test_torch_dart_rf import _op_by_op
from tests.test_torch_ref import jax_ref  # noqa: F401
from tests.torch_gang import data, run_gang, snapped_logloss

BASE = {"objective": "binary", "num_leaves": 15, "learning_rate": 0.1, "min_data_in_leaf": 5}
CPU = {"device_type": "cpu", "verbosity": -1}
BLOCK = 256
# 12 features, one group each: 8 blocks of 2,048 rows, 2 of them a rank's budget
ENV = {BUDGET_ENV: str(2 * BLOCK * 12), BLOCK_ROWS_ENV: str(BLOCK)}
CONFIGS = [(dict(BASE, tree_learner="data"), True, 2048),
           (dict(BASE, tree_learner="data", use_quantized_grad=True), False, 2048),
           (dict(BASE, tree_learner="data", use_quantized_grad=True), False, 1024)]
ROUNDS = 4


@pytest.fixture(autouse=True)
def _disarm():
    yield
    faults.clear()


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    return run_gang("sharded_stream", 4, tmp_path_factory.mktemp("stream"), CONFIGS, ENV,
                    ROUNDS, (1500, 256, 1024), timeout=60)


def _single(monkeypatch, params, fobj, n_rows):
    for k, v in ENV.items():
        monkeypatch.setenv(k, v)
    X, y = data(3, n=n_rows, f=12)
    p = dict(params, tree_learner="serial", **CPU)
    if fobj:
        p["objective"] = snapped_logloss
    bst = lt.train(p, lt.Dataset(X, label=y), num_boost_round=ROUNDS)
    assert type(bst._gbdt.tree_learner) is StreamedTreeLearner
    return bst.model_to_string()


@pytest.mark.parametrize("j", [0, 1], ids=["float-snapped", "quantized"])
def test_sharded_streamed_byte_equal_to_single_card(gang, monkeypatch, j):
    want = _single(monkeypatch, *CONFIGS[j])
    for rank, res in enumerate(gang):
        got = res["models"][j]
        assert got["learner"] == "ShardedStreamedTreeLearner"
        assert got["counters"]["stream_shards"] == 4
        assert got["model"] == want
        assert got["uploaded"] == [rank, rank + 4]  # its own blocks only
        assert got["counters"]["stream_h2d_blocks"] == 2


def test_sharded_streamed_float_equals_jax_streamed(gang, jax_ref, monkeypatch):
    from lightgbm_tpu.streaming import StreamedTreeLearner as JaxStreamed

    for k, v in ENV.items():
        monkeypatch.setenv(k, v)
    params, _, n_rows = CONFIGS[0]
    X, y = data(3, n=n_rows, f=12)
    _op_by_op(monkeypatch)
    ref = jax_ref.train(dict(params, tree_learner="serial", objective=snapped_logloss, **CPU),
                        jax_ref.Dataset(X, label=y), num_boost_round=ROUNDS)
    assert type(ref._gbdt.tree_learner) is JaxStreamed
    for res in gang:
        assert res["models"][0]["model"] == ref.model_to_string()


def test_sharded_wire_gauge_is_closed_form_and_n_independent(gang):
    for res in gang:
        gauges = []
        for got in res["models"][1:]:
            c = got["counters"]
            want = perfmodel.stream_ici_bytes_per_wave(got["groups"], got["bins"], 3, 4)
            assert c["stream_ici_bytes_per_wave"] == c["device_ici_bytes_per_wave"] == want
            assert c["stream_ici_bytes"] == want * c["stream_leaf_histograms"]
            gauges.append(want)
        assert gauges[0] == gauges[1]  # 2,048 and 1,024 rows


def test_streaming_factory_routes_data_to_sharded(monkeypatch):
    X, y = data(3, n=512, f=12)
    monkeypatch.setenv(BUDGET_ENV, "64k")
    bst = lt.Booster(params=dict(BASE, tree_learner="data", **CPU),
                     train_set=lt.Dataset(X, label=y))
    learner = bst._gbdt.tree_learner
    assert isinstance(learner, ShardedStreamedTreeLearner)
    assert learner.bins_dev is None and learner.num_shards == 1


@pytest.mark.parametrize("kind", ["feature", "voting"])
def test_streaming_rejects_plane_resident_learners(monkeypatch, kind):
    X, y = data(3, n=512, f=12)
    monkeypatch.setenv(BUDGET_ENV, "64k")
    with pytest.raises(LightGBMError, match="serial or data only"):
        lt.train(dict(BASE, tree_learner=kind, **CPU), lt.Dataset(X, label=y),
                 num_boost_round=1)


def _sparse_chunks(seed=11, n=1500, f=8):
    rng = np.random.RandomState(seed)
    X = rng.standard_normal((n, f))
    X[X < -1.2] = 0.0
    X[rng.rand(n, f) < 0.01] = np.nan
    return X, (np.nan_to_num(X[:, 0]) + 0.3 * np.nan_to_num(X[:, 1]) > 0).astype(np.float64)


@pytest.mark.parametrize("shards", [4, 7])
def test_sharded_fit_matches_raw_prefix_fit(shards):
    from lightgbm_tpu_torch.utils.timer import global_timer

    X, y = _sparse_chunks()
    params = dict(BASE, **CPU)

    def fill(store):
        for lo in range(0, 1500, 256):
            store.push_rows(X[lo:lo + 256], label=y[lo:lo + 256])
        return store

    merges = global_timer.counters.get("stream_sketch_merges", 0)
    base = fill(RowBlockStore(params=params, bin_sample_rows=1024))
    sh = fill(ShardedRowBlockStore(params=params, bin_sample_rows=1024, num_shards=shards))
    assert global_timer.counters["stream_sketch_merges"] > merges
    for ma, mb in zip(base._layout.mappers, sh._layout.mappers):
        assert ma.num_bin == mb.num_bin
        assert np.array_equal(np.asarray(ma.bin_upper_bound, float),
                              np.asarray(mb.bin_upper_bound, float), equal_nan=True)
    assert sh._group_lists == base._group_lists
    a, b = base.finalize(), sh.finalize()
    assert np.array_equal(a.bins, b.bins)
    pushed = lt.train(dict(params), sh.to_basic_dataset(params=params), num_boost_round=2)
    direct = lt.train(dict(params), base.to_basic_dataset(params=params), num_boost_round=2)
    assert pushed.model_to_string() == direct.model_to_string()


def _cut_dicts(mappers):
    return json.dumps([m.to_dict() for m in mappers], sort_keys=True)


def _push(store, X, y):
    for lo in range(0, X.shape[0], 256):
        store.push_rows(X[lo:lo + 256], label=y[lo:lo + 256])
    return store


@pytest.mark.parametrize("shards", [4, 7])
def test_sharded_fit_equals_jax_sharded_store(jax_ref, shards):
    from lightgbm_tpu.streaming import ShardedRowBlockStore as JaxSharded

    X, y = _sparse_chunks()
    params = dict(BASE, **CPU)
    ours = _push(ShardedRowBlockStore(params=params, bin_sample_rows=1024, num_shards=shards),
                 X, y)
    theirs = _push(JaxSharded(params=dict(params), bin_sample_rows=1024, num_shards=shards),
                   X, y)
    assert ours._block_owner == theirs._block_owner
    assert _cut_dicts(ours._layout.mappers) == _cut_dicts(theirs._layout.mappers)
    assert ours._group_lists == theirs._group_lists
    a, b = ours.finalize(), theirs.finalize()
    assert np.array_equal(a.bins, np.asarray(b.bins))
    np.testing.assert_array_equal(np.asarray(a.metadata.label), np.asarray(b.metadata.label))


def test_sharded_fit_over_the_gang_matches_raw_prefix_fit(gang):
    for res in gang:
        assert res["fit"] == {"cuts": True, "groups": True, "plane": True, "shards": 4}


def test_shard_watermarks_pin_round_robin_placement():
    X, y = data(3, n=900, f=6)
    store = ShardedRowBlockStore(params=dict(BASE, **CPU), num_shards=4)
    sizes = [256, 256, 256, 132]
    lo = 0
    for sz in sizes:
        store.push_rows(X[lo:lo + sz], label=y[lo:lo + sz])
        lo += sz
    assert store._block_owner == [0, 1, 2, 3]
    assert [store.shard_rows(r) for r in range(4)] == sizes
    store.reshard(2)
    assert store.num_shards == 2 and store._block_owner == [0, 1, 0, 1]
    assert (store.shard_rows(0), store.shard_rows(1)) == (512, 388)


def test_pod_drift_alarm_refresh_deterministic(monkeypatch):
    monkeypatch.setenv("LGBM_TPU_DRIFT", "1")
    monkeypatch.setenv("LGBM_TPU_DRIFT_CHECK_ROWS", "512")

    def run():
        faults.clear()
        faults.install("drift_shift@1024:0")
        rng = np.random.RandomState(3)
        X = rng.standard_normal((3072, 8))
        y = (X[:, 1] + 0.3 * X[:, 2] > 0).astype(np.float64)
        store = ShardedRowBlockStore(params=dict(BASE, **CPU), bin_sample_rows=1024,
                                     num_shards=4)
        for lo in range(0, 3072, 256):
            store.push_rows(X[lo:lo + 256], label=y[lo:lo + 256])
        mon = store._drift
        assert isinstance(mon, PodDriftMonitor)
        assert mon.alarmed and mon.alarm_feature == 0
        assert store.maybe_refresh_bins() is True and store.layout_generation == 1
        return [tuple(m.bin_upper_bound) for m in store._layout.mappers], store.finalize().bins

    cuts1, bins1 = run()
    cuts2, bins2 = run()
    assert cuts1 == cuts2 and np.array_equal(bins1, bins2)


def test_pod_drift_alarm_and_refresh_equal_jax(jax_ref, monkeypatch):
    from lightgbm_tpu.streaming import PodDriftMonitor as JaxPod
    from lightgbm_tpu.streaming import ShardedRowBlockStore as JaxSharded
    from lightgbm_tpu.utils import faults as jax_faults

    monkeypatch.setenv("LGBM_TPU_DRIFT", "1")
    monkeypatch.setenv("LGBM_TPU_DRIFT_CHECK_ROWS", "512")
    rng = np.random.RandomState(3)
    X = rng.standard_normal((3072, 8))
    y = (X[:, 1] + 0.3 * X[:, 2] > 0).astype(np.float64)
    stores = []
    for pkg_faults, cls in ((faults, ShardedRowBlockStore), (jax_faults, JaxSharded)):
        pkg_faults.clear()
        pkg_faults.install("drift_shift@1024:0")
        try:
            stores.append(_push(cls(params=dict(BASE, **CPU), bin_sample_rows=1024,
                                    num_shards=4), X, y))
        finally:
            pkg_faults.clear()
    ours, theirs = stores
    assert isinstance(ours._drift, PodDriftMonitor) and isinstance(theirs._drift, JaxPod)
    assert ours._drift.alarmed and theirs._drift.alarmed
    assert ours._drift.alarm_feature == theirs._drift.alarm_feature == 0
    assert _cut_dicts(ours._layout.mappers) == _cut_dicts(theirs._layout.mappers)
    assert ours.maybe_refresh_bins() is True and theirs.maybe_refresh_bins() is True
    assert ours.layout_generation == theirs.layout_generation == 1
    assert _cut_dicts(ours._layout.mappers) == _cut_dicts(theirs._layout.mappers)
    assert np.array_equal(ours.finalize().bins, np.asarray(theirs.finalize().bins))


def test_worker_lost_mid_refit_shrinks_4_to_2_byte_identical(tmp_path):
    params = dict(BASE, tree_learner="data", use_quantized_grad=True)
    env = {BUDGET_ENV: "64k", BLOCK_ROWS_ENV: "256"}
    out = run_gang("flywheel_shrink", 4, tmp_path, params, env, str(tmp_path / "ck"),
                   str(tmp_path / "store2"), 2, 5.0, timeout=60)
    for rank, res in enumerate(out):
        assert res["lost"] and res["generation"] == 0 and res["inflight"] == 1200
        assert res["shards_before"] == 4
        if rank < 2:
            assert res["shards_after"] == 2 and res["generation_after"] == 1
            assert res["resumed"] == res["straight"] == out[0]["straight"]


def test_block_cache_refuses_a_foreign_block():
    plane = np.arange(4 * 1024, dtype=np.uint8).reshape(4, 1024)
    cache = _BlockCache(plane, 256, 2, "cpu", shard=(1, 2))
    assert cache.owned == [1, 3]
    np.testing.assert_array_equal(cache.get(3).numpy(), plane[:, 768:])
    with pytest.raises(ValueError, match="belongs to shard 0"):
        cache.get(2)
    assert cache.uploaded == {3}


def test_plane_bytes_cover_four_budgets():
    X, y = data(3, n=2048, f=12)
    core = CoreDataset.from_matrix(X, label=y, config=Config(dict(BASE)))
    assert core.bins.shape[0] == 12  # one group a feature, as ENV assumes
    assert core.bins.size >= 4 * int(ENV[BUDGET_ENV])
