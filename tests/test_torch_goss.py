"""GOSS (models/sample_strategy.py `GOSSStrategy`, `goss_select`) against
the JAX package's: its jitted device selection `_goss_select` and its host
path, and GBDTs that train with GOSS through each package's wave and
serial learners.

Contracts:

* the selection, on binary [1, N] and 3-class [3, N] gradients with ties,
  NaN and -0.0 in the |g·h| score, at (top_rate, other_rate) of (0.2,
  0.1), (0.5, 0.5) and a case that samples nothing (the top takes every
  row): the in-bag mask and the rescaled g and h bit-equal to the jitted
  JAX `_goss_select` on the same drawn positions, and the bag and
  gradients equal to the JAX host path's (and to the port's copy of it);
* training, 6 rounds at learning rate 0.5 (GOSS samples from round 3 on)
  on grid-snapped `fobj` gradients, which the multiplier 0.8 / 0.1 = 8
  keeps snapped: the model text byte-equal to the JAX GBDT's (the JAX
  selection on its device path, LGBM_TPU_GOSS_DEVICE=1 for the JAX side),
  but the wave learner's split_gain, within 4 ULP (ROADMAP Queue 3); the
  serial learner's JAX search run op by op; binary and 3-class; the
  out-of-bag index set the train score is updated through bit-equal;
* the bag reaches the wave learner as a mask on the gradients' device and
  the out-of-bag set is built there (no host indices are made);
  `boosting=goss` trains the same model as `data_sample_strategy=goss`.
"""
from functools import partial

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.models.sample_strategy import (DeviceBag, GOSSStrategy,
                                                       create_sample_strategy, goss_select)
from lightgbm_tpu_torch.treelearner.device import DeviceTreeLearner
from lightgbm_tpu_torch.utils.log import LightGBMError
from tests.test_torch_multiclass import _assert_text_equal_but_gain, snapped_softmax
from tests.test_torch_ref import jax_ref  # noqa: F401
from tests.test_torch_train import snapped_logloss

CPU = torch.device("cpu")
N = 1000
RATES = [(0.2, 0.1), (0.5, 0.5), (0.9996, 0.0003)]


def _gradients(C, seed):
    """[C, N] float32 g and h on small grids (many ties), with NaN and
    -0.0 among the gradients."""
    rng = np.random.RandomState(seed)
    g = rng.choice(np.array([-0.5, -0.25, -0.0, 0.0, 0.25, 0.5, 1.5], np.float32), (C, N))
    h = rng.choice(np.array([0.25, 0.5, 1.0], np.float32), (C, N))
    g[rng.rand(C, N) < 0.01] = np.nan
    return g.astype(np.float32), h.astype(np.float32)


def _bits(a):
    """float32 bits, every NaN one pattern."""
    a = np.asarray(a, dtype=np.float32)
    return np.where(np.isnan(a), np.float32(np.nan), a).view(np.int32)


def _strategy(top, other, lr=0.5, C=1):
    cfg = Config({"data_sample_strategy": "goss", "top_rate": top, "other_rate": other,
                  "learning_rate": lr, "device_type": "cpu"})
    return create_sample_strategy(cfg, N, None, C)


@pytest.mark.parametrize("rates", RATES, ids=["0.2-0.1", "0.5-0.5", "none-sampled"])
@pytest.mark.parametrize("C", [1, 3], ids=["binary", "3-class"])
def test_selection_bit_equal_to_jax(jax_ref, monkeypatch, C, rates):
    import jax
    import jax.numpy as jnp
    from lightgbm_tpu.config import Config as JConfig
    from lightgbm_tpu.models import sample_strategy as jss

    top, other = rates
    strat = _strategy(top, other, C=C)
    assert isinstance(strat, GOSSStrategy)
    top_k, n_rest, n_sampled = strat.sizes()
    assert (n_sampled == 0) == (rates == RATES[2])
    g, h = _gradients(C, seed=C)
    it = 5
    pos = strat.draw_positions(it)
    assert len(pos) == n_sampled

    # the jitted JAX selection on the same positions
    jg, jh = (jnp.asarray(a[0] if C == 1 else a) for a in (g, h))
    select = jax.jit(partial(jss._goss_select, top_k=top_k))
    jmask, jgr, jhr = select(jg, jh, jnp.asarray(pos.astype(np.int32)),
                             jnp.float32(strat.multiplier()))
    mask, gr, hr = goss_select(torch.from_numpy(g), torch.from_numpy(h),
                               torch.from_numpy(pos.astype(np.int64)), strat.multiplier(),
                               top_k)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    assert int(mask.sum()) == top_k + n_sampled
    np.testing.assert_array_equal(_bits(gr.numpy()).reshape(-1), _bits(jgr).reshape(-1))
    np.testing.assert_array_equal(_bits(hr.numpy()).reshape(-1), _bits(jhr).reshape(-1))

    # the strategy's bag, against the JAX host path and the port's copy of it
    bag, gb, hb = strat.bagging(it, torch.from_numpy(g), torch.from_numpy(h))
    assert isinstance(bag, DeviceBag) and bag.n_bag == top_k + n_sampled
    monkeypatch.setenv("LGBM_TPU_GOSS_DEVICE", "0")
    jstrat = jss.create_sample_strategy(
        JConfig({"data_sample_strategy": "goss", "top_rate": top, "other_rate": other,
                 "learning_rate": 0.5}), N, None, C)
    jbag, jgh, jhh = jstrat.bagging(it, jg, jh)
    np.testing.assert_array_equal(bag.indices, np.asarray(jbag))
    np.testing.assert_array_equal(_bits(gb.numpy()).reshape(-1), _bits(jgh).reshape(-1))
    np.testing.assert_array_equal(_bits(hb.numpy()).reshape(-1), _bits(jhh).reshape(-1))
    hbag, hg, hh = strat.bagging_host(it, torch.from_numpy(g), torch.from_numpy(h))
    np.testing.assert_array_equal(hbag, bag.indices)
    np.testing.assert_array_equal(_bits(hg.numpy()), _bits(gb.numpy()))
    np.testing.assert_array_equal(_bits(hh.numpy()), _bits(hb.numpy()))


def test_warm_up_and_checks():
    """No sampling while iteration < int(1 / learning_rate); the rates'
    checks are the reference's."""
    strat = _strategy(0.2, 0.1, lr=0.1)
    g, h = (torch.from_numpy(a) for a in _gradients(1, 0))
    for it in range(10):
        assert strat.bagging(it, g, h)[0] is None
    assert isinstance(strat.bagging(10, g, h)[0], DeviceBag)
    for top, other in ((0.7, 0.4), (0.0, 0.1)):
        with pytest.raises(LightGBMError):
            _strategy(top, other)


def _data(seed=0, n=1200, f=8):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f)
    y = (X[:, 0] - 0.7 * X[:, 1] + rng.randn(n) * 0.3 > 0).astype(float)
    return X, y


def _labels3(seed=0, n=1200):
    X, _ = _data(seed, n)
    y = np.digitize(X[:, 0] + 0.5 * X[:, 1], [-0.4, 0.4]).astype(float)
    return X, y


GOSS = {"objective": "none", "num_leaves": 15, "learning_rate": 0.5,
        "data_sample_strategy": "goss", "top_rate": 0.2, "other_rate": 0.1,
        "min_data_in_leaf": 5, "verbosity": -1}
ROUNDS = 6


def _goss_boosters(jax_ref, monkeypatch, params, fobj, X, y, wave):
    """A Booster of each package trained ROUNDS rounds with GOSS, each
    GBDT growing with its package's wave learner (width 21, the adaptive
    controller and the JAX pipeline off) or its serial learner (the JAX
    search op by op)."""
    import jax
    from lightgbm_tpu.ops.split import find_best_split
    from lightgbm_tpu.treelearner import serial
    from lightgbm_tpu.treelearner.device import DeviceTreeLearner as JLearner

    def op_by_op(*args):
        with jax.disable_jit():
            return find_best_split(*args)

    monkeypatch.setenv("LGBM_TPU_GOSS_DEVICE", "1")
    monkeypatch.setenv("LGBM_TPU_ADAPTIVE_WAVE", "0")
    monkeypatch.setenv("LGBM_TPU_ASYNC", "0")
    if not wave:
        monkeypatch.setattr(serial, "find_best_split", op_by_op)
    out = []
    for pkg in (lt, jax_ref):
        ds = pkg.Dataset(X, label=y)
        bst = pkg.Booster(params=dict(params, device_type="cpu"), train_set=ds)
        gbdt = bst._gbdt
        if wave and pkg is lt:
            gbdt.tree_learner = DeviceTreeLearner(gbdt.config, ds._handle, CPU)
            gbdt.tree_learner._adaptive_wave = False
        elif wave:
            gbdt.tree_learner = JLearner(gbdt.config, ds._handle)
        for _ in range(ROUNDS):
            if bst.update(fobj=fobj):
                break
        out.append(bst)
    return out


CASES = [("binary", "wave"), ("binary", "serial"), ("3-class", "wave"), ("3-class", "serial")]


@pytest.mark.parametrize("task,learner", CASES, ids=[f"{t}-{k}" for t, k in CASES])
def test_training_matches_jax(jax_ref, monkeypatch, task, learner):
    if task == "binary":
        X, y = _data()
        params, fobj, C = GOSS, snapped_logloss, 1
    else:
        X, y = _labels3()
        params, fobj, C = {**GOSS, "num_class": 3, "num_leaves": 7}, snapped_softmax, 3
    port, ref = _goss_boosters(jax_ref, monkeypatch, params, fobj, X, y, learner == "wave")
    assert port.num_trees() == ref.num_trees() == ROUNDS * C
    a, b = port.model_to_string(), ref.model_to_string()
    if learner == "wave":
        _assert_text_equal_but_gain(a, b, 0.5)
    else:
        assert a == b
    # the last iteration sampled: its out-of-bag set, built on each side
    # from its device bag, and the scores it updated
    pg, rg = port._gbdt, ref._gbdt
    assert isinstance(pg._cur_bag, DeviceBag)
    assert pg._cur_bag.n_bag == rg._cur_bag.n_bag
    np.testing.assert_array_equal(pg._oob_padded.numpy(), np.asarray(rg._oob_padded))
    np.testing.assert_array_equal(pg.score.numpy().reshape(-1),
                                  np.asarray(rg.score).reshape(-1))


def test_wave_learner_takes_the_mask_and_oob_stays_on_device(monkeypatch):
    """The DeviceBag's mask seeds the wave learner's leaf ids (bagged-out
    rows at -1) and the GBDT's out-of-bag set comes from the mask; the
    bag's host indices are never made."""
    X, y = _data()
    bst = lt.Booster({**GOSS, "objective": "binary", "device_type": "cpu"},
                     lt.Dataset(X, label=y))
    gbdt = bst._gbdt
    gbdt.tree_learner = DeviceTreeLearner(gbdt.config, bst.train_set._handle, CPU)
    for _ in range(4):
        bst.update()
    bag = gbdt._cur_bag
    assert isinstance(bag, DeviceBag) and bag._host is None
    ids = gbdt.tree_learner.partition.leaf_ids_dev()
    np.testing.assert_array_equal((ids >= 0).numpy(), bag.mask.numpy())
    oob = gbdt._oob_padded.numpy()
    real = oob[oob < len(X)]
    np.testing.assert_array_equal(real, np.nonzero(~bag.mask.numpy())[0])
    assert (oob[len(real):] == len(X)).all()
    assert bag._host is None
    np.testing.assert_allclose(gbdt.score[0].numpy(), bst.predict(X, raw_score=True),
                               rtol=0, atol=1e-6)


def test_boosting_goss_alias():
    X, y = _data()
    base = {"objective": "binary", "num_leaves": 15, "learning_rate": 0.5,
            "device_type": "cpu", "verbosity": -1}
    a = lt.train({**base, "boosting": "goss"}, lt.Dataset(X, label=y), num_boost_round=5)
    b = lt.train({**base, "data_sample_strategy": "goss"}, lt.Dataset(X, label=y),
                 num_boost_round=5)
    assert isinstance(a._gbdt.sample_strategy, GOSSStrategy)
    assert a.num_trees() == b.num_trees() == 5
    for ta, tb in zip(a._gbdt.models, b._gbdt.models):
        assert ta.to_string() == tb.to_string()
