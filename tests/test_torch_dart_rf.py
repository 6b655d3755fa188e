"""DART and random-forest boosting in the port against the JAX package, on
the CPU (the serial learner).

Contracts (2,000 x 8 rows, 15 leaves, 5 rounds; the JAX split search run
op by op, as tests/test_torch_train.py runs it):

* DART on grid-snapped custom gradients (`fobj`): each iteration's drop set
  equal to the JAX package's, and the model text byte-equal, in standard
  mode with weighted drop, with `uniform_drop`, in `xgboost_dart_mode` and
  with `max_drop=2`; the train score equal to predict(raw_score=True)
  within 1e-3 (tests/test_boosting_modes.py's tolerance; the maximum gap is
  printed);
* RF on L2 with labels on a 1/64 grid whose mean is 1 (every gradient
  init - label is then on the grid and every sum of them exact), bagging
  0.5: the model text byte-equal; the train score the average of the
  trees' outputs within 1e-5;
* RF on the built-in binary objective: split for split against the JAX
  package with values within rtol 1e-5 / atol 1e-6 and gains within rtol
  1e-4 (tests/test_torch_train.py's tolerances: the histograms of the
  constant gradients sum in another order on each side);
* RF refuses a run without bagging or column sampling, a custom objective
  and an init score, with the JAX package's messages.
"""
import numpy as np
import pytest

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.utils.log import LightGBMError
from tests.test_torch_ref import jax_ref  # noqa: F401
from tests.test_torch_train import _assert_split_for_split, _data, snapped_logloss
from tests.torch_grid_data import grid_regression

ROUNDS = 5
SCORE_GAP = 1e-3  # train score against predict(raw_score=True), DART
AVERAGE_GAP = 1e-5  # RF's train score against the mean of its trees' outputs
DART = {"boosting": "dart", "objective": "none", "num_leaves": 7, "device_type": "cpu",
        "verbosity": -1, "drop_rate": 0.5, "skip_drop": 0.2, "learning_rate": 0.3}
DART_CASES = {"weighted": {}, "uniform_drop": {"uniform_drop": True},
              "xgboost_dart_mode": {"xgboost_dart_mode": True}, "max_drop_2": {"max_drop": 2}}
RF = {"boosting": "rf", "num_leaves": 15, "device_type": "cpu", "verbosity": -1,
      "bagging_fraction": 0.5, "bagging_freq": 1}


def _op_by_op(monkeypatch):
    """The JAX serial learner's split search run op by op."""
    import jax
    from lightgbm_tpu.ops.split import find_best_split
    from lightgbm_tpu.treelearner import serial

    def op_by_op(*args):
        with jax.disable_jit():
            return find_best_split(*args)

    monkeypatch.setattr(serial, "find_best_split", op_by_op)


def _dart_run(pkg, extra, X, y):
    bst = pkg.Booster({**DART, **extra}, pkg.Dataset(X, label=y))
    drops = []
    for _ in range(ROUNDS):
        bst.update(fobj=snapped_logloss)
        drops.append(list(bst._gbdt.drop_index))
    return bst, drops


@pytest.mark.parametrize("case", list(DART_CASES))
def test_dart_snapped_model_text_byte_equal(jax_ref, monkeypatch, case):
    X, y = _data(seed=5)
    port, port_drops = _dart_run(lt, DART_CASES[case], X, y)
    gap = float(np.abs(port._gbdt.score[0].numpy() - port.predict(X, raw_score=True)).max())
    print(f"dart ({case}): drops {port_drops}; train score against predict: max gap {gap:.3g}")
    assert gap <= SCORE_GAP
    assert sum(len(d) for d in port_drops) > 0
    if case == "max_drop_2":
        assert max(len(d) for d in port_drops) == 2
    _op_by_op(monkeypatch)
    ref, ref_drops = _dart_run(jax_ref, DART_CASES[case], X, y)
    assert port_drops == ref_drops
    assert port.model_to_string() == ref.model_to_string()


def test_rf_grid_labels_model_text_byte_equal(jax_ref, monkeypatch):
    X, y = grid_regression()
    params = {**RF, "objective": "regression"}
    port = lt.train(dict(params), lt.Dataset(X, label=y), num_boost_round=ROUNDS)
    trees = np.stack([lt.Booster(model_str=port.model_to_string(), params={"device_type": "cpu"})
                      .predict(X, raw_score=True, start_iteration=i, num_iteration=1)
                      for i in range(ROUNDS)])
    np.testing.assert_allclose(port._gbdt.score[0].numpy(), trees.mean(axis=0),
                               rtol=0, atol=AVERAGE_GAP)
    assert "average_output" in port.model_to_string()
    _op_by_op(monkeypatch)
    ref = jax_ref.train(dict(params), jax_ref.Dataset(X, label=y), num_boost_round=ROUNDS)
    assert port.model_to_string() == ref.model_to_string()
    np.testing.assert_array_equal(port.predict(X), ref.predict(X))


def test_rf_binary_split_for_split(jax_ref):
    X, y = _data(with_nan=False, seed=6)
    params = {**RF, "objective": "binary", "feature_fraction": 0.8}
    port = lt.train(dict(params), lt.Dataset(X, label=y), num_boost_round=5)
    ref = jax_ref.train(dict(params), jax_ref.Dataset(X, label=y), num_boost_round=5)
    _assert_split_for_split(port.model_to_string(), ref.model_to_string(),
                            value_rtol=1e-5, gain_rtol=1e-4)
    np.testing.assert_allclose(port.predict(X), ref.predict(X), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("how,message", [
    ("no_bagging", "Random forest needs bagging"),
    ("custom_objective", "do not support custom objective"),
    ("init_score", "Cannot use init_score in RF mode"),
])
def test_rf_refusals(how, message):
    X, y = _data(with_nan=False)
    params = {**RF, "objective": "binary"}
    kwargs = {}
    if how == "no_bagging":
        params["bagging_freq"] = 0
    elif how == "custom_objective":
        params["objective"] = snapped_logloss
    else:
        kwargs["init_score"] = np.zeros(len(y))
    with pytest.raises(LightGBMError, match=message):
        lt.train(params, lt.Dataset(X, label=y, **kwargs), num_boost_round=2)
