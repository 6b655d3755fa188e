"""The Booster surface (basic.py `dump_model`, `feature_importance`,
`lower_bound`, `upper_bound`, `reset_parameter`; callback.py
`reset_parameter`; models/tree.py `to_json`, models/serialize.py
`dump_json`) against the JAX package.

Contracts:

* `dump_model` of a model text equal to the JAX package's `dump_model` of
  the same text, numeric and categorical models; `feature_importance`
  (split counts int64, gains float64), `lower_bound` and `upper_bound`
  equal to the JAX package's, on loaded and on trained Boosters;
* a `reset_parameter` callback that sets parameters to their configured
  values leaves the model byte-equal to a run without it, categorical data
  included: the serial learner's regularizers keep their 11 entries. The
  JAX package's do not (it rebuilds 6), and its categorical splits vanish
  (fault 2, ROADMAP Queue 3);
* a learning-rate schedule, and a `num_leaves` change at round 3, train
  the JAX package's model (snapped gradients, its search op by op);
* the wave learner's async pipeline and its synchronous path bit-identical
  under a rate schedule and a `num_leaves` change (new wave buffers), the
  pipeline leaving trees pending.
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.treelearner.device import DeviceTreeLearner
from tests.test_torch_categorical import _cat_data, _op_by_op
from tests.test_torch_ref import jax_ref  # noqa: F401
from tests.test_torch_train import snapped_logloss

CPU = torch.device("cpu")


def _numeric_data(seed=0, n=1500):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 6)
    X[rng.rand(n, 6) < 0.03] = np.nan
    y = (np.nan_to_num(X[:, 0]) - 0.7 * np.nan_to_num(X[:, 1])
         + rng.randn(n) * 0.3 > 0).astype(float)
    return X, y


def _models():
    """A numeric and a categorical model text, trained by the port."""
    base = {"objective": "binary", "num_leaves": 7, "device_type": "cpu", "verbosity": -1}
    X, y = _numeric_data()
    num = lt.train(base, lt.Dataset(X, label=y), num_boost_round=4)
    Xc, yc = _cat_data()
    cat = lt.train(base, lt.Dataset(Xc, label=yc, categorical_feature=[0]),
                   num_boost_round=4)
    return {"numeric": num, "categorical": cat}


@pytest.fixture(scope="module")
def models():
    return _models()


@pytest.mark.parametrize("kind", ["numeric", "categorical"])
def test_dump_model_and_importance_match_jax(jax_ref, models, kind):
    trained = models[kind]
    text = trained.model_to_string()
    loaded = lt.Booster(model_str=text, params={"device_type": "cpu"})
    ref = jax_ref.Booster(model_str=text)
    want = ref.dump_model()
    assert loaded.dump_model() == want
    assert trained.dump_model() == want
    if kind == "categorical":
        nodes = [t["tree_structure"] for t in want["tree_info"]]
        assert any(n.get("decision_type") == "==" for n in nodes)
    for bst in (loaded, trained):
        for kind_ in ("split", "gain"):
            got = bst.feature_importance(kind_)
            exp = ref.feature_importance(kind_)
            assert got.dtype == (np.float64 if kind_ == "gain" else np.int64)
            np.testing.assert_array_equal(got, exp)
        assert bst.lower_bound() == ref.lower_bound()
        assert bst.upper_bound() == ref.upper_bound()
    np.testing.assert_array_equal(loaded.feature_importance("split", iteration=2),
                                  ref.feature_importance("split", iteration=2))
    assert loaded.dump_model(num_iteration=2) == ref.dump_model(num_iteration=2)


def _cat_run(pkg, callbacks, rounds=4):
    X, y = _cat_data()
    params = {"objective": "binary", "num_leaves": 7, "learning_rate": 0.1,
              "device_type": "cpu", "verbosity": -1}
    return pkg.train(params, pkg.Dataset(X, label=y, categorical_feature=[0]),
                     num_boost_round=rounds, callbacks=callbacks)


def test_reset_to_configured_values_is_a_no_op():
    """lambda_l1 set to its default value before every round: the serial
    learner's 11 regularizers are rebuilt in place, and the categorical
    lanes read the same max_cat_to_onehot, max_cat_threshold, cat_l2,
    cat_smooth and min_data_per_group."""
    plain = _cat_run(lt, None)
    reset = _cat_run(lt, [lt.reset_parameter(lambda_l1=[0.0] * 4,
                                             learning_rate=[0.1] * 4)])
    assert reset.model_to_string() == plain.model_to_string()
    assert sum(t.num_cat for t in reset._gbdt.models) > 0
    assert reset._gbdt.tree_learner.params_dev.shape == (11,)


def test_jax_reset_parameter_drops_categorical_splits(jax_ref):
    """Fault 2 of the JAX reference (ROADMAP Queue 3): its reset_parameter
    rebuilds the serial learner's regularizers with 6 entries, the
    categorical lanes read the rest out of bounds, and with lambda_l1 set
    to its default no tree keeps a categorical split."""
    plain = _cat_run(jax_ref, None)
    reset = _cat_run(jax_ref, [jax_ref.reset_parameter(lambda_l1=[0.0] * 4)])
    assert sum(t.num_cat for t in plain._gbdt.models) > 0
    assert sum(t.num_cat for t in reset._gbdt.models) == 0
    assert reset.model_to_string() != plain.model_to_string()


SCHEDULES = {
    "learning_rate": {"learning_rate": [0.5, 0.25, 0.25, 0.125, 0.125, 0.5]},
    "num_leaves": {"num_leaves": [15, 15, 15, 5, 5, 9]},
}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedule_matches_jax(jax_ref, monkeypatch, name):
    X, y = _numeric_data(seed=1)
    params = {"objective": snapped_logloss, "num_leaves": 15, "learning_rate": 0.5,
              "device_type": "cpu", "verbosity": -1}
    _op_by_op(monkeypatch)
    out = []
    for pkg in (lt, jax_ref):
        out.append(pkg.train(dict(params), pkg.Dataset(X, label=y), num_boost_round=6,
                             callbacks=[pkg.reset_parameter(**SCHEDULES[name])]))
    port, ref = out
    assert port.model_to_string() == ref.model_to_string()
    if name == "num_leaves":
        leaves = [t.num_leaves for t in port._gbdt.models]
        assert max(leaves[3:5]) <= 5 and max(leaves[:3]) > 5, leaves


def _wave_booster(X, y, asyn):
    bst = lt.Booster({"objective": "binary", "num_leaves": 15, "learning_rate": 0.5,
                      "min_data_in_leaf": 5, "metric": "None", "device_type": "cpu",
                      "verbosity": -1}, lt.Dataset(X, label=y))
    gbdt = bst._gbdt
    gbdt.tree_learner = DeviceTreeLearner(gbdt.config, bst.train_set._handle, CPU)
    gbdt._async_pipeline = asyn
    return bst


def test_async_bit_identical_to_sync_under_a_schedule():
    """reset_parameter between Booster.update() rounds, as the callback
    does: the rate halves twice and num_leaves changes once. The pending
    tree is finalized with the rate it was grown under; the pipeline keeps
    running at every float32-exact rate."""
    X, y = _numeric_data(seed=2, n=900)
    rates = [0.5, 0.5, 0.25, 0.25, 0.125, 0.125, 0.125, 0.5]
    leaves = [15, 15, 15, 15, 9, 9, 15, 15]
    runs, pending = {}, 0
    for asyn in (True, False):
        bst = _wave_booster(X, y, asyn)
        params = {"learning_rate": 0.5, "num_leaves": 15}
        for it in range(len(rates)):
            new = {k: v for k, v in (("learning_rate", rates[it]), ("num_leaves", leaves[it]))
                   if params[k] != v}
            if new:
                bst.reset_parameter(new)
                params.update(new)
            bst.update()
            pending += asyn and bst._gbdt._pending is not None
        runs[asyn] = (bst.model_to_string(), bst._gbdt.score.numpy().copy())
    assert pending >= 4
    assert runs[True][0] == runs[False][0]
    np.testing.assert_array_equal(runs[True][1], runs[False][1])
    shrink = [float(line.split("=")[1]) for line in runs[True][0].splitlines()
              if line.startswith("shrinkage=")]
    assert shrink[1:] == rates[1:]
