"""Quantized-gradient training (use_quantized_grad) through the port's two
learners against the JAX package's, at device_type=cpu.

Contracts, on grid-snapped custom gradients (every scaled histogram sum,
split sum and renewal sum is then exact in float32, in any order; the
stochastic rounding draws are jax.random's bit for bit):

* the serial learner: model text byte-equal to the JAX serial learner with
  its split search run op by op (as tests/test_torch_train.py runs it):
  leaf renewal off and on, with bagging, and a 3-class multiclass;
* the wave learner: `grow_tree_on_device` on quantized gradients against
  the JAX grower's quantized mode (K = 4 with a bag, K = 21 without), and
  a GBDT whose learner is each package's wave learner: the split log and
  model text equal but split_gain, which is within 4 ULP of the un-shifted
  gain (jitted, XLA rounds it a few ULP apart from the same function run
  op by op; ROADMAP Queue 3), with renewal on and bagging, binary and
  3-class;
* the serial learner on the built-in objectives: split for split within
  the float tolerances of tests/test_torch_train.py (its root totals sum
  the scaled bins exactly in float64 where the JAX one sums them in
  float32);
* the async pipeline stays off when the learner is quantized;
* on the built-in binary objective the quantized model's AUC stays within
  0.003 of the float model's (tests/test_quantized.py's margin).
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.io.dataset import Dataset as CoreDataset
from lightgbm_tpu_torch.models.gbdt import GBDT
from lightgbm_tpu_torch.objectives import create_objective
from lightgbm_tpu_torch.ops.quantize import prng_key, quantize_gh, split_key
from lightgbm_tpu_torch.treelearner.device import DeviceTreeLearner, grow_tree_on_device
from tests.test_torch_device_learner import _gain_within_4_ulp
from tests.test_torch_multiclass import _assert_text_equal_but_gain, snapped_softmax
from tests.test_torch_ref import jax_ref  # noqa: F401
from tests.test_torch_train import _assert_split_for_split, _data, snapped_logloss

CPU = torch.device("cpu")
QUANT = {"use_quantized_grad": True, "num_grad_quant_bins": 4, "verbosity": -1}
BAGGED = {"bagging_fraction": 0.7, "bagging_freq": 1}


def _op_by_op(monkeypatch):
    """The JAX serial learner's split search run op by op."""
    import jax
    from lightgbm_tpu.ops.split import find_best_split
    from lightgbm_tpu.treelearner import serial

    def op_by_op(*args):
        with jax.disable_jit():
            return find_best_split(*args)

    monkeypatch.setattr(serial, "find_best_split", op_by_op)


@pytest.mark.parametrize("renew,bagging", [(False, {}), (True, {}), (True, BAGGED)],
                         ids=["renew_off", "renew_on", "renew_on-bagged"])
def test_serial_snapped_model_text_byte_equal(jax_ref, monkeypatch, renew, bagging):
    X, y = _data()
    params = {"objective": snapped_logloss, "num_leaves": 15, "device_type": "cpu",
              "quant_train_renew_leaf": renew, **QUANT, **bagging}
    port = lt.train(dict(params), lt.Dataset(X, label=y), num_boost_round=3)
    _op_by_op(monkeypatch)
    ref = jax_ref.train(dict(params), jax_ref.Dataset(X, label=y), num_boost_round=3)
    assert port.num_trees() == 3
    assert port.model_to_string() == ref.model_to_string()


def test_serial_multiclass_snapped_model_text_byte_equal(jax_ref, monkeypatch):
    """3 trees an iteration from one learner: its key splits once a tree, in
    class order, as the JAX learner's does."""
    from tests.test_torch_multiclass import _data as mc_data

    X, y = mc_data()
    params = {"objective": snapped_softmax, "num_class": 3, "num_leaves": 7,
              "min_data_in_leaf": 10, "device_type": "cpu", "quant_train_renew_leaf": True,
              "feature_fraction_bynode": 0.8, **QUANT}
    port = lt.train(dict(params), lt.Dataset(X, label=y), num_boost_round=2)
    _op_by_op(monkeypatch)
    ref = jax_ref.train(dict(params), jax_ref.Dataset(X, label=y), num_boost_round=2)
    assert port.num_trees() == 6
    assert port.model_to_string() == ref.model_to_string()


@pytest.mark.parametrize("objective", ["binary", "regression"])
def test_serial_builtin_objective_split_for_split(jax_ref, objective):
    X, y = _data(with_nan=False, seed=1)
    params = {"objective": objective, "num_leaves": 15, "device_type": "cpu",
              "quant_train_renew_leaf": True, **QUANT}
    port = lt.train(dict(params), lt.Dataset(X, label=y), num_boost_round=5)
    ref = jax_ref.train(dict(params), jax_ref.Dataset(X, label=y), num_boost_round=5)
    _assert_split_for_split(port.model_to_string(), ref.model_to_string(),
                            value_rtol=1e-5, gain_rtol=1e-4)


@pytest.fixture(scope="module")
def learners(jax_ref):
    """The two packages' quantized wave learners on the same 2,000 x 8 data,
    and one tree's quantized gradients of snapped float gradients."""
    from lightgbm_tpu.config import Config as JConfig
    from lightgbm_tpu.io.dataset import Dataset as JDataset
    from lightgbm_tpu.treelearner.device import DeviceTreeLearner as JLearner

    X, y = _data(with_nan=False)
    n = len(X)
    params = {"objective": "binary", "num_leaves": 31, "min_data_in_leaf": 5, **QUANT}
    jl = JLearner(JConfig(params), JDataset.from_matrix(X, label=y, config=JConfig(params)))
    tl = DeviceTreeLearner(Config(params), CoreDataset.from_matrix(X, label=y,
                                                                  config=Config(params)), CPU)
    rng = np.random.RandomState(1)
    g = (np.round(rng.normal(0, 0.4, n) * 16) / 16).astype(np.float32)
    h = (np.round(rng.uniform(0.0625, 0.25, n) * 16) / 16).astype(np.float32)
    _, sub = split_key(prng_key(3))
    gh, scale = quantize_gh(torch.from_numpy(g), torch.from_numpy(h), sub, 4, True)
    out = rng.rand(n) < 0.3
    return jl, tl, gh[:-1], scale, out


@pytest.mark.parametrize("K,bagged", [(4, True), (21, False)], ids=["4-bagged", "21-full"])
def test_grow_tree_quantized_matches_jax(learners, K, bagged):
    import jax.numpy as jnp
    from lightgbm_tpu.treelearner.device import grow_tree_on_device as jax_grow

    jl, tl, gh, scale, out = learners
    n = gh.shape[0]
    leaf0 = np.zeros(n, np.int32)
    gh = gh.clone()
    if bagged:
        leaf0[out] = -1
        gh[torch.from_numpy(out)] = 0
    L = tl.config.num_leaves
    F = len(tl.meta.real_feature)
    ref = jax_grow(jnp.copy(jl.bins_dev), jnp.asarray(gh.numpy()), jnp.asarray(leaf0),
                   jl.meta, jl.tables, jl.params_dev, jnp.ones(F, bool), L,
                   jl.group_bin_padded, jl.config.max_depth, batch=K, bagged=bagged,
                   quantized=True, scale_vec=jnp.asarray(scale.numpy()))
    rec_ref, leaf_ref, n_ref, rows_ref, waves_ref = (np.asarray(a) for a in ref)
    rec, leaf_id, n_cur, hist_rows, n_waves = grow_tree_on_device(
        tl.bins_dev, gh, torch.from_numpy(leaf0), tl.meta, tl.tables, tl.params_dev, None,
        L, tl.group_bin_padded, tl.config.max_depth, batch=K, bagged=bagged, scale=scale)
    gain = 4  # rec_store column of split_gain
    np.testing.assert_array_equal(np.delete(rec, gain, 1), np.delete(rec_ref, gain, 1))
    assert _gain_within_4_ulp(rec[:, gain], rec_ref[:, gain], rec[:, 8] + rec[:, 11],
                              rec[:, 9] + rec[:, 12], tl.params_dev.numpy())
    np.testing.assert_array_equal(leaf_id.numpy(), leaf_ref)
    assert (n_cur, hist_rows, n_waves) == (int(n_ref), int(rows_ref), int(waves_ref))
    assert n_cur == L


def _wave_boosters(jax_ref, monkeypatch, X, y, params, fobj, rounds):
    """A Booster of each package whose GBDT grows its trees with that
    package's quantized wave learner (width 21 or `wave`, the adaptive
    controller off on both sides)."""
    from lightgbm_tpu.treelearner.device import DeviceTreeLearner as JLearner

    monkeypatch.setenv("LGBM_TPU_ADAPTIVE_WAVE", "0")
    monkeypatch.setenv("LGBM_TPU_ASYNC", "0")
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


def test_wave_gbdt_snapped_model_text_matches_jax(jax_ref, monkeypatch):
    X, y = _data(with_nan=False)
    params = {"objective": "none", "num_leaves": 15, "quant_train_renew_leaf": True,
              **QUANT, **BAGGED}
    port, ref = _wave_boosters(jax_ref, monkeypatch, X, y, params, snapped_logloss, 4)
    assert port.num_trees() == ref.num_trees() == 4
    _assert_text_equal_but_gain(port.model_to_string(), ref.model_to_string(), 0.1)


def test_wave_gbdt_multiclass_snapped_model_text_matches_jax(jax_ref, monkeypatch):
    from tests.test_torch_multiclass import _data as mc_data

    X, y = mc_data()
    params = {"objective": "none", "num_class": 3, "num_leaves": 7, "min_data_in_leaf": 10,
              "quant_train_renew_leaf": True, **QUANT, **BAGGED}
    port, ref = _wave_boosters(jax_ref, monkeypatch, X, y, params, snapped_softmax, 2)
    assert port.num_trees() == ref.num_trees() == 6
    _assert_text_equal_but_gain(port.model_to_string(), ref.model_to_string(), 0.1)


def test_async_pipeline_stays_off_when_quantized():
    """The async pipeline's score update writes the learner's split-log leaf
    values, which renewal rewrites afterwards: the JAX package keeps the
    pipeline off for a quantized learner (gbdt.py:248), and so does the
    port."""
    X, y = _data(with_nan=False)
    for quantized in (False, True):
        # a learning rate exact in float32: the pipeline's other condition
        cfg = Config({"objective": "binary", "num_leaves": 15, "device_type": "cpu",
                      "learning_rate": 0.125, "use_quantized_grad": quantized,
                      "verbosity": -1})
        ds = CoreDataset.from_matrix(X, label=y, config=cfg)
        gbdt = GBDT(cfg, ds, create_objective(cfg.objective, cfg), CPU)
        gbdt.tree_learner = DeviceTreeLearner(cfg, ds, CPU)
        assert gbdt._async_enabled() is not quantized
        for _ in range(3):
            gbdt.train_one_iter()
        assert (gbdt._pending is None) == quantized  # a tree left pending, or none
    assert gbdt.tree_learner.quantized and gbdt.iter_ == 3


def _auc(y, p):
    order = np.argsort(p)
    ranks = np.empty(len(p))
    ranks[order] = np.arange(1, len(p) + 1)
    n_pos = y.sum()
    n_neg = len(y) - n_pos
    return (ranks[y == 1].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg)


def test_quantized_auc_close_to_float():
    """tests/test_quantized.py's check, on the port: 4 bins, renewal on."""
    rng = np.random.RandomState(0)
    X = rng.randn(3000, 10)
    y = (X[:, 0] * 2.0 - X[:, 1] + 0.5 * X[:, 2] * X[:, 3] + rng.randn(3000) * 0.3
         > 0).astype(np.float64)
    base = {"objective": "binary", "num_leaves": 15, "learning_rate": 0.1,
            "min_data_in_leaf": 20, "verbosity": -1, "device_type": "cpu"}
    auc = {}
    for name, extra in (("float", {}), ("quant", {"use_quantized_grad": True,
                                                  "num_grad_quant_bins": 4,
                                                  "quant_train_renew_leaf": True})):
        bst = lt.train({**base, **extra}, lt.Dataset(X, label=y), num_boost_round=30)
        auc[name] = _auc(y, bst.predict(X))
    assert auc["quant"] > auc["float"] - 0.003, auc
