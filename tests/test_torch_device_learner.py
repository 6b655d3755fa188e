"""The port's wave learner (treelearner/device.py) against the JAX package's
(``lightgbm_tpu/treelearner/device.py``, jitted, with its XLA fallbacks as
it runs on the CPU), and the port's own invariants, each the mirror of a
test in ``tests/test_device_learner.py``.

Contracts, on grid-snapped gradients and data without NaN:

* `grow_tree_on_device`, K in {1, 4, 21}, with and without a bag: the split
  log (rec_store) equal in every column but split_gain, which is within 4
  ULP of the un-shifted gain (jitted, XLA rounds the gain a few ULP apart
  from the same function run op by op, as the port runs it; ROADMAP Queue
  3); the leaf ids, final leaf count, rows histogrammed and wave count
  exactly equal;
* a GBDT whose learner is each package's wave learner, 5 rounds on 2,000 x
  8 rows: with snapped `fobj` gradients the model texts equal but for
  split_gain (4 ULP); with the built-in binary and regression objectives
  split for split, as tests/test_torch_train.py holds the serial learner.
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.io.dataset import Dataset as CoreDataset
from lightgbm_tpu_torch.models.gbdt import GBDT
from lightgbm_tpu_torch.objectives import create_objective
from lightgbm_tpu_torch.ops import split as ts
from lightgbm_tpu_torch.treelearner.device import (DeviceTreeLearner, DevicePartition,
                                                   grow_tree_on_device)
from lightgbm_tpu_torch.utils.timer import global_timer
from tests.test_torch_ref import jax_ref  # noqa: F401
from tests.test_torch_train import _assert_split_for_split, snapped_logloss

CPU = torch.device("cpu")
N, F = 2000, 8


def _data(seed=0, n=N):
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, F))
    y = (X[:, 0] + X[:, 1] - 0.5 * X[:, 2] + 0.3 * rng.normal(size=n) > 0).astype(float)
    return X, y


def _gain_within_4_ulp(got, ref, sum_g, sum_h, params):
    """|got - ref| <= 4 ULP of the un-shifted gain (gain + the parent's
    leaf gain), float32."""
    l1, l2, _, _, min_gain, max_delta = (torch.tensor(v, dtype=torch.float32)
                                         for v in params[:6])
    shift = ts.leaf_gain(torch.from_numpy(sum_g), torch.from_numpy(sum_h), l1, l2,
                         max_delta).numpy() + min_gain.numpy()
    ulp = np.spacing(np.abs(ref + shift).astype(np.float32))
    return bool((np.abs(got - ref) <= 4 * ulp).all())


@pytest.fixture(scope="module")
def learners(jax_ref):
    """The two packages' wave learners on the same 2,000 x 8 data."""
    from lightgbm_tpu.config import Config as JConfig
    from lightgbm_tpu.io.dataset import Dataset as JDataset
    from lightgbm_tpu.treelearner.device import DeviceTreeLearner as JLearner

    X, y = _data()
    params = {"objective": "binary", "num_leaves": 31, "min_data_in_leaf": 5,
              "verbosity": -1}
    jl = JLearner(JConfig(params), JDataset.from_matrix(X, label=y, config=JConfig(params)))
    tl = DeviceTreeLearner(Config(params), CoreDataset.from_matrix(X, label=y,
                                                                  config=Config(params)), CPU)
    rng = np.random.RandomState(1)
    g = np.round(rng.normal(0, 0.4, N) * 16) / 16
    h = np.round(rng.uniform(0.0625, 0.25, N) * 16) / 16
    gh = np.stack([g, h, np.ones(N)], 1).astype(np.float32)
    out = rng.rand(N) < 0.3
    return jl, tl, gh, out


@pytest.mark.parametrize("bagged", [False, True], ids=["full", "bagged"])
@pytest.mark.parametrize("K", [1, 4, 21])
def test_grow_tree_matches_jax(learners, K, bagged):
    import jax.numpy as jnp
    from lightgbm_tpu.treelearner.device import grow_tree_on_device as jax_grow

    jl, tl, gh, out = learners
    leaf0 = np.zeros(N, np.int32)
    gh = gh.copy()
    if bagged:
        leaf0[out] = -1
        gh[out] = 0.0
    L = tl.config.num_leaves
    ref = jax_grow(jnp.copy(jl.bins_dev), jnp.asarray(gh), jnp.asarray(leaf0), jl.meta,
                   jl.tables, jl.params_dev, jnp.ones(F, bool), L, jl.group_bin_padded,
                   jl.config.max_depth, batch=K, bagged=bagged)
    rec_ref, leaf_ref, n_ref, rows_ref, waves_ref = (np.asarray(a) for a in ref)
    rec, leaf_id, n_cur, hist_rows, n_waves = grow_tree_on_device(
        tl.bins_dev, torch.from_numpy(gh), torch.from_numpy(leaf0), tl.meta, tl.tables,
        tl.params_dev, None, L, tl.group_bin_padded, tl.config.max_depth, batch=K,
        bagged=bagged)
    assert rec.shape == rec_ref.shape and rec.dtype == np.float32
    gain = 4  # rec_store column of split_gain
    np.testing.assert_array_equal(np.delete(rec, gain, 1), np.delete(rec_ref, gain, 1))
    params = tl.params_dev.numpy()
    assert _gain_within_4_ulp(rec[:, gain], rec_ref[:, gain], rec[:, 8] + rec[:, 11],
                              rec[:, 9] + rec[:, 12], params)
    np.testing.assert_array_equal(leaf_id.numpy(), leaf_ref)
    assert (n_cur, hist_rows, n_waves) == (int(n_ref), int(rows_ref), int(waves_ref))
    assert n_cur == L
    if bagged:
        assert (leaf_id.numpy()[out] == -1).all()


def _wave_boosters(jax_ref, monkeypatch, params, fobj, rounds=5, seed=0):
    """A Booster of each package whose GBDT grows its trees with that
    package's wave learner (width 21, the adaptive controller off on both
    sides: the width changes no model, and each JAX width compiles anew)."""
    from lightgbm_tpu.treelearner.device import DeviceTreeLearner as JLearner

    monkeypatch.setenv("LGBM_TPU_ADAPTIVE_WAVE", "0")
    monkeypatch.setenv("LGBM_TPU_ASYNC", "0")
    X, y = _data(seed)
    out = []
    for pkg in (lt, jax_ref):
        ds = pkg.Dataset(X, label=y)
        bst = pkg.Booster(params=dict(params, device_type="cpu"), train_set=ds)
        gbdt = bst._gbdt
        if pkg is lt:
            learner = DeviceTreeLearner(gbdt.config, ds._handle, CPU)
            learner._adaptive_wave = False
        else:
            learner = JLearner(gbdt.config, ds._handle)
        gbdt.tree_learner = learner
        for _ in range(rounds):
            if bst.update(fobj=fobj):
                break
        out.append(bst)
    return out


def _trees(text):
    """Model text -> [{key: value}] per tree."""
    out = []
    for line in text.splitlines():
        if line.startswith("Tree="):
            out.append({})
        elif out and "=" in line:
            key, value = line.split("=", 1)
            out[-1][key] = value
    return out


def test_gbdt_snapped_model_text_matches_jax(jax_ref, monkeypatch):
    params = {"objective": "none", "num_leaves": 15, "verbosity": -1}
    port, ref = _wave_boosters(jax_ref, monkeypatch, params, snapped_logloss)
    assert port.num_trees() == ref.num_trees() == 5
    a, b = port.model_to_string(), ref.model_to_string()
    assert [ln.split("=", 1)[0] for ln in a.splitlines()] == \
        [ln.split("=", 1)[0] for ln in b.splitlines()]
    for la, lb in zip(a.splitlines(), b.splitlines()):
        key = la.split("=", 1)[0]
        if key not in ("split_gain", "tree_sizes"):
            assert la == lb, (la, lb)
    for ta, tb in zip(_trees(a), _trees(b)):
        x, y = (np.array(t["split_gain"].split(), np.float32) for t in (ta, tb))
        # the un-shifted gain adds the parent's leaf gain, out**2 * sum_h
        # (lambda_l1 = max_delta_step = 0, lambda_l2 = 0), out being the
        # parent's output before shrinkage by the learning rate of 0.1
        out = np.array(ta["internal_value"].split(), np.float32) / np.float32(0.1)
        sum_h = np.array(ta["internal_weight"].split(), np.float32)
        ulp = np.spacing(np.abs(y) + out * out * sum_h)
        assert (np.abs(x - y) <= 4 * ulp).all(), (x, y)


@pytest.mark.parametrize("objective", ["binary", "regression"])
def test_gbdt_builtin_objective_split_for_split(jax_ref, monkeypatch, objective):
    params = {"objective": objective, "num_leaves": 15, "verbosity": -1}
    port, ref = _wave_boosters(jax_ref, monkeypatch, params, None, seed=1)
    _assert_split_for_split(port.model_to_string(), ref.model_to_string(),
                            value_rtol=1e-5, gain_rtol=1e-4)
    X, _ = _data(1)
    np.testing.assert_allclose(port.predict(X), ref.predict(X), rtol=1e-5, atol=1e-6)


def _port_gbdt(X, y, params, wave=21, adaptive=True):
    cfg = Config({**params, "device_type": "cpu"})
    ds = CoreDataset.from_matrix(X, label=y, config=cfg)
    bst = GBDT(cfg, ds, create_objective(cfg.objective, cfg), CPU)
    learner = DeviceTreeLearner(cfg, ds, CPU, wave=wave)
    learner._adaptive_wave = adaptive
    bst.tree_learner = learner
    return bst, learner


def _regression_data(n=1200, seed=2):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, F)
    y = 2 * X[:, 0] - X[:, 1] + np.sin(3 * X[:, 2]) + 0.1 * rng.randn(n)
    return X, y


REG = {"objective": "regression", "num_leaves": 31, "min_data_in_leaf": 5,
       "verbosity": -1}


def test_model_text_independent_of_wave_width_and_controller():
    """The wave width changes only how much speculative work a wave does,
    never which splits win: byte-equal models for every width, with the
    adaptive controller on or off, and the controller shrinks the width on
    this low-commit-rate data and histograms fewer rows."""
    X, y = _regression_data()
    texts, rows, widths = {}, {}, {}
    for wave, adaptive in ((21, True), (21, False), (4, False), (1, False)):
        global_timer.counters.pop("device_hist_rows", None)
        bst, learner = _port_gbdt(X, y, REG, wave, adaptive)
        ks = []
        for _ in range(6):
            if bst.train_one_iter():
                break
            ks.append(learner.wave_k)
        texts[(wave, adaptive)] = bst.to_model().to_string()
        rows[(wave, adaptive)] = global_timer.counters["device_hist_rows"]
        widths[(wave, adaptive)] = ks
    assert len(set(texts.values())) == 1
    assert all(k == 21 for k in widths[(21, False)])
    assert widths[(21, True)][-1] < 21, widths
    assert rows[(21, True)] < rows[(21, False)], rows
    assert global_timer.counters.get("wave_k") == 1  # the last run's width


def test_hist_rows_bounded():
    """Rows histogrammed per tree stay O(rows in selected leaves): root N
    plus the smaller children, under 4N even with narrow waves, where an
    O(N * waves) formulation would pass 8N."""
    X, y = _regression_data(n=2000, seed=3)
    bst, learner = _port_gbdt(X, y, REG, wave=4)
    global_timer.counters.pop("device_hist_rows", None)
    bst.train_one_iter()
    assert 0 < learner.last_hist_rows <= 4 * len(y)
    assert global_timer.counters["device_hist_rows"] == learner.last_hist_rows


def test_bagging_leaves_out_of_bag_rows_at_minus_one():
    X, y = _data(4, n=1200)
    bst, learner = _port_gbdt(X, y, {"objective": "binary", "num_leaves": 7,
                                     "verbosity": -1})
    grads, hess = bst.objective.get_gradients(bst.score[0])
    gh = torch.cat([torch.stack([grads, hess, torch.ones_like(grads)], 1),
                    torch.zeros((1, 3))])
    bag = np.sort(np.random.RandomState(0).choice(1200, 800, replace=False))
    tree = learner.train(gh, bag)
    assert tree.num_leaves > 1
    part = learner.partition
    assert isinstance(part, DevicePartition)
    assert sum(part.count(i) for i in range(tree.num_leaves)) == 800
    assert (part.ids_host == -1).sum() == 400
    rows = np.sort(np.concatenate([part.indices(i).numpy()
                                   for i in range(tree.num_leaves)]))
    np.testing.assert_array_equal(rows, bag)
    for i in range(tree.num_leaves):
        idx = part.indices(i).numpy()
        assert len(idx) == part.count(i) and (np.diff(idx) > 0).all()


def test_stops_on_no_gain():
    """Constant labels: the first tree fits the mean, the next finds no
    split with positive gain and training stops."""
    rng = np.random.RandomState(5)
    X = rng.randn(400, 4)
    bst, _ = _port_gbdt(X, np.ones(400), {"objective": "regression", "num_leaves": 31,
                                          "boost_from_average": False,
                                          "verbosity": -1})
    assert bst.train_one_iter() or bst.train_one_iter()


def test_batched_split_search_bit_equal_to_one_leaf():
    """The leaf batch of the split search: each leaf's record equals the
    one-leaf call's bits, on unsnapped histograms too."""
    X, y = _data(6)
    cfg = Config({"objective": "binary", "device_type": "cpu"})
    ds = CoreDataset.from_matrix(X, label=y, config=cfg)
    learner = DeviceTreeLearner(cfg, ds, CPU)
    rng = np.random.RandomState(7)
    G, B = learner.bins_dev.shape[0], learner.group_bin_padded
    hists = torch.from_numpy(np.abs(rng.normal(size=(6, G, B, 3))).astype(np.float32))
    hists[..., 2] = torch.from_numpy(rng.randint(0, 40, size=(6, G, B)).astype(np.float32))
    totals = hists[:, 0].sum(dim=1)
    mask = torch.from_numpy(rng.rand(F) < 0.7)
    batched = ts.find_best_split(hists, totals, learner.meta, learner.params_dev, mask)
    fh = ts.gather_feature_hist(hists, learner.meta, totals)
    per_feature = ts.per_feature_best(fh, totals, learner.meta, learner.params_dev, mask)
    for i in range(hists.shape[0]):
        one = ts.find_best_split(hists[i], totals[i], learner.meta, learner.params_dev,
                                 mask)
        assert torch.equal(batched[i].view(torch.int32), one.view(torch.int32))
        assert torch.equal(per_feature[i].view(torch.int32), ts.per_feature_best(
            fh[i], totals[i], learner.meta, learner.params_dev, mask).view(torch.int32))
