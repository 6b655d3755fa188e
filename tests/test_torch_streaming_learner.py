"""The out-of-core streamed learner (streaming/learner.py) on the CPU.

Contracts:

* `parse_budget_bytes` reads a budget as the JAX package does;
* LGBM_TPU_HBM_BUDGET routes training to a StreamedTreeLearner whose plane
  never reaches the device whole (`bins_dev is None`);
* under a starved budget (blocks of 256 rows, 2 of them cached, the plane
  at least 4x the budget) the model text is byte-equal to the port's
  resident serial learner's for plain, bagged, `feature_fraction` and
  quantized training, on the built-in binary objective's gradients (the
  carried histogram continues the plain version's float32 sums in the
  leaf's row order); when the plane fits, byte-equal as well;
* byte-equal to the JAX package's streamed learner on snapped gradients
  (the JAX split search op by op);
* the blocked score update is bit-equal to the resident traversal, the
  carried histogram to one resident call, in either mode;
* the uploads' bytes are the blocks' `stream_block_bytes` plus the group
  rows, the JAX package's formula.
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import perfmodel
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.io.dataset import Dataset as CoreDataset
from lightgbm_tpu_torch.ops.hist_cuda import HistogramCarry, histogram
from lightgbm_tpu_torch.ops.histogram import _build_histogram_rows_plain, fixed_point_exponents
from lightgbm_tpu_torch.ops.partition import pad_indices
from lightgbm_tpu_torch.ops.score import add_tree_to_score
from lightgbm_tpu_torch.streaming import StreamedTreeLearner
from lightgbm_tpu_torch.streaming.learner import (BLOCK_ROWS_ENV, BUDGET_ENV, block_runs,
                                                  parse_budget_bytes)
from lightgbm_tpu_torch.treelearner.serial import SerialTreeLearner
from lightgbm_tpu_torch.utils.timer import global_timer
from tests.test_torch_dart_rf import _op_by_op
from tests.test_torch_ref import jax_ref  # noqa: F401
from tests.test_torch_train import snapped_logloss

BASE = {"objective": "binary", "num_leaves": 15, "learning_rate": 0.1, "verbosity": -1,
        "min_data_in_leaf": 5, "device_type": "cpu"}


def _data(seed=3, n=2048, f=12):
    rng = np.random.RandomState(seed)
    X = rng.standard_normal((n, f)).astype(np.float32)
    y = (X[:, 0] - 0.5 * X[:, 1] + rng.standard_normal(n) * 0.3 > 0)
    return X, y.astype(np.float64)


def _model(params, X, y, rounds=5):
    return lt.train(dict(params), lt.Dataset(X, label=y), num_boost_round=rounds)


def _starve(monkeypatch, params, X, y):
    """Blocks of 256 rows, a budget of 2 blocks; returns the plane's bytes
    and the budget."""
    core = CoreDataset.from_matrix(X, label=y, config=Config(dict(params)))
    plane = core.bins.size * core.bins.dtype.itemsize
    budget = 2 * core.bins.shape[0] * 256
    monkeypatch.setenv(BLOCK_ROWS_ENV, "256")
    monkeypatch.setenv(BUDGET_ENV, str(budget))
    return plane, budget


def test_parse_budget_bytes(jax_ref):
    from lightgbm_tpu.streaming.learner import parse_budget_bytes as jax_parse

    for text in ("64k", "1.5m", "2g", "12345", "", None, "0", "junk", " 7M "):
        assert parse_budget_bytes(text) == jax_parse(text), text
    assert parse_budget_bytes("64k") == 64 << 10
    assert parse_budget_bytes("junk") is None


def test_budget_routes_to_the_streamed_learner(monkeypatch):
    X, y = _data(n=512)
    monkeypatch.setenv(BUDGET_ENV, "64k")
    bst = lt.Booster(params=dict(BASE), train_set=lt.Dataset(X, label=y))
    learner = bst._gbdt.tree_learner
    assert isinstance(learner, StreamedTreeLearner)
    assert learner.bins_dev is None  # the plane never goes to the device whole
    monkeypatch.delenv(BUDGET_ENV)
    bst = lt.Booster(params=dict(BASE), train_set=lt.Dataset(X, label=y))
    assert type(bst._gbdt.tree_learner) is SerialTreeLearner


@pytest.mark.parametrize("extra", [
    pytest.param({}, id="plain"),
    pytest.param({"bagging_fraction": 0.7, "bagging_freq": 1}, id="bagged"),
    pytest.param({"feature_fraction": 0.8}, id="featfrac"),
    pytest.param({"use_quantized_grad": True}, id="quantized"),
])
def test_starved_budget_byte_equal_to_resident(monkeypatch, extra):
    X, y = _data()
    params = {**BASE, **extra}
    resident = _model(params, X, y)
    plane, budget = _starve(monkeypatch, params, X, y)
    assert plane >= 4 * budget
    before = global_timer.counters.get("stream_h2d_cold", 0) \
        + global_timer.counters.get("stream_h2d_prefetched", 0)
    streamed = _model(params, X, y)
    assert isinstance(streamed._gbdt.tree_learner, StreamedTreeLearner)
    assert streamed._gbdt.tree_learner._cache.peak <= 2
    # blocks came and went: the budget really was starved
    assert global_timer.counters["stream_h2d_cold"] \
        + global_timer.counters["stream_h2d_prefetched"] - before > 8
    assert resident.model_to_string() == streamed.model_to_string()
    np.testing.assert_array_equal(resident.predict(X, raw_score=True),
                                  streamed.predict(X, raw_score=True))


def test_plane_that_fits_is_byte_equal(monkeypatch):
    X, y = _data(n=1024)
    resident = _model(BASE, X, y)
    monkeypatch.setenv(BUDGET_ENV, "1g")
    streamed = _model(BASE, X, y)
    cache = streamed._gbdt.tree_learner._cache
    assert cache.capacity >= cache.n_blocks
    assert resident.model_to_string() == streamed.model_to_string()


@pytest.mark.parametrize("extra", [{}, {"bagging_fraction": 0.7, "bagging_freq": 1}],
                         ids=["plain", "bagged"])
def test_snapped_gradients_byte_equal_to_jax_streamed(jax_ref, monkeypatch, extra):
    from lightgbm_tpu.streaming import StreamedTreeLearner as JaxStreamed

    X, y = _data(n=1536)
    params = {**BASE, **extra, "objective": snapped_logloss}
    _starve(monkeypatch, {**BASE, **extra}, X, y)
    port = _model(params, X, y, rounds=4)
    assert isinstance(port._gbdt.tree_learner, StreamedTreeLearner)
    _op_by_op(monkeypatch)
    ref = jax_ref.train(dict(params), jax_ref.Dataset(X, label=y), num_boost_round=4)
    assert isinstance(ref._gbdt.tree_learner, JaxStreamed)
    assert port.model_to_string() == ref.model_to_string()


def _learner(monkeypatch, X, y, params=BASE):
    _starve(monkeypatch, params, X, y)
    bst = lt.Booster(params=dict(params), train_set=lt.Dataset(X, label=y))
    return bst, bst._gbdt.tree_learner


def test_blocked_score_update_bit_equal_to_resident(monkeypatch):
    X, y = _data(n=1500)
    bst, learner = _learner(monkeypatch, X, y)
    for _ in range(3):
        bst.update()
    core = bst._gbdt.train_set
    bins = torch.from_numpy(core.bins)
    rng = np.random.RandomState(0)
    score = torch.from_numpy(rng.standard_normal(1500).astype(np.float32))
    sets = {"all": np.arange(1500), "oob": np.sort(rng.choice(1500, 400, replace=False)),
            "unsorted": rng.permutation(1500)[:700]}
    for tree in bst._gbdt.models:
        for name, rows in sets.items():
            padded = torch.from_numpy(pad_indices(rows.astype(np.int32), 1500))
            want = add_tree_to_score(tree, core, bins, score, padded, 1500)
            got = learner.add_tree_to_score_blocked(tree, score, padded)
            assert torch.equal(got, want), name


@pytest.mark.parametrize("quantized", [False, True])
def test_carried_histogram_equals_one_resident_call(quantized):
    """The carried mode's plain version over a leaf's runs of blocks, in
    block order, against one resident call over all its rows."""
    rng = np.random.RandomState(1)
    G, N, B, block = 5, 3000, 32, 256
    bins = torch.from_numpy(rng.randint(0, B, size=(G, N)).astype(np.uint8))
    if quantized:
        gh = torch.from_numpy(rng.randint(-8, 9, size=(N + 1, 3)).astype(np.int8))
    else:
        gh = torch.from_numpy(rng.standard_normal((N + 1, 3)).astype(np.float32))
    gh[N] = 0
    exps = None if quantized else fixed_point_exponents(gh, N)
    for rows in (np.arange(N), np.sort(rng.choice(N, 700, replace=False)),
                 rng.choice(N, 300, replace=False)):  # the last one unsorted
        idx = torch.from_numpy(rows.astype(np.int32))
        want = _build_histogram_rows_plain(bins, gh, idx, B)
        carry = HistogramCarry()
        runs = block_runs(idx, block)
        for i, (b, s, e) in enumerate(runs):
            lo, hi = b * block, min(N, (b + 1) * block)
            out = histogram(bins[:, lo:hi].contiguous(), gh[lo:hi], (idx[s:e] - lo).int(),
                            B, count=e - s, exponents=exps, carry=carry,
                            last=i + 1 == len(runs))
        assert carry.calls == len(runs)
        assert torch.equal(out, want)


def test_carried_histogram_float_mode_needs_the_trees_exponents():
    bins = torch.zeros((2, 8), dtype=torch.uint8)
    gh = torch.ones((9, 3), dtype=torch.float32)
    with pytest.raises(ValueError, match="exponents"):
        histogram(bins, gh, torch.arange(8, dtype=torch.int32), 4, count=8,
                  carry=HistogramCarry())


def test_h2d_bytes_are_blocks_and_group_rows(jax_ref, monkeypatch):
    from lightgbm_tpu.perfmodel import stream_block_bytes as jax_block_bytes

    X, y = _data(n=1500)
    names = ("stream_h2d_bytes", "stream_h2d_blocks", "stream_h2d_rows")
    before = {k: global_timer.counters.get(k, 0) for k in names}
    bst, learner = _learner(monkeypatch, X, y)
    for _ in range(2):
        bst.update()
    moved = {k: global_timer.counters.get(k, 0) - before[k] for k in names}
    G, N = learner.dataset.bins.shape
    cache = learner._cache
    assert perfmodel.stream_block_bytes(256, G, 1) == jax_block_bytes(256, G, 1) == G * 256
    # every block is 256 rows but the last (1500 = 5 x 256 + 220): the
    # bytes are those of the blocks uploaded and of the group rows
    assert cache.n_blocks == 6
    assert moved["stream_h2d_blocks"] > 0 and moved["stream_h2d_rows"] > 0
    lower = (moved["stream_h2d_blocks"] * G * 220 + moved["stream_h2d_rows"] * N)
    upper = (moved["stream_h2d_blocks"] * perfmodel.stream_block_bytes(256, G, 1)
             + moved["stream_h2d_rows"] * N)
    assert lower <= moved["stream_h2d_bytes"] <= upper


def test_h2d_stage_in_the_attribution():
    report = perfmodel.attribution(
        {"hist_root": 0.5, "hist_children": 0.25}, {"stream_h2d_bytes": 64_000_000,
                                                    "stream_h2d_us": 2_000_000},
        total_s=1.0, device_kind="NVIDIA H100 80GB HBM3")
    h2d = report["stages"]["stream_h2d"]
    assert h2d["overlapped"] and h2d["fraction"] == 0.0
    assert h2d["model_bytes"] == 64_000_000
    assert h2d["model_s"] == pytest.approx(64e6 / 64e9)
    assert report["fractions_sum"] == pytest.approx(1.0)
    assert perfmodel.h2d_bound_ms(64e9, "NVIDIA H100 80GB HBM3") == pytest.approx(1e3)
    assert perfmodel.h2d_bound_ms(1.0, "a CPU") is None


def test_serial_module_loads_the_streamed_learner_alone():
    """The serial learner's module brings the streamed learner's, which
    subclasses SerialTreeLearner, and none of the streaming package's
    other modules (the package exports lazily): the tree learner's factory
    pulls in no trainer, store or drift monitor."""
    import subprocess
    import sys
    from pathlib import Path

    code = ("import sys; import lightgbm_tpu_torch.treelearner.serial as s; "
            "print(s.streamed.StreamedTreeLearner.__bases__ == (s.SerialTreeLearner,)); "
            "print(sorted(m for m in sys.modules if m.startswith('lightgbm_tpu_torch.streaming')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=Path(__file__).resolve().parents[1], timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[:2] == [
        "True", "['lightgbm_tpu_torch.streaming', 'lightgbm_tpu_torch.streaming.learner']"]
