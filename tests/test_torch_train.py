"""`lightgbm_tpu_torch.train` against `lightgbm_tpu.train` at
device_type=cpu: the serial learner, the GBDT driver and the engine.

Contracts (2,000 x 8 rows, num_leaves=15, 5 rounds, feature_fraction_bynode
1.0 and 0.8):

* grid-snapped custom gradients (`fobj`): the model text is byte-equal to
  the JAX package's. The JAX side runs its split search op by op
  (`jax.disable_jit` around `find_best_split`), as PyTorch runs: jitted, XLA
  fuses the gain arithmetic and rounds the gains a few ULP apart from the
  same function run op by op (and, on a leaf whose missing bin is empty, may
  then prefer the default-left lane of an exact tie);
* the built-in objectives: split for split (features, thresholds, decision
  types, children, counts byte-equal) with leaf and internal values within
  rtol 1e-5 / atol 1e-6 and gains within rtol 1e-4 — histograms sum in
  another order on each side, so sums differ in the last bits, and a leaf
  whose gradients nearly cancel carries that into its value as absolute
  error.
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.io.dataset import Dataset as CoreDataset
from lightgbm_tpu_torch.treelearner.serial import (create_tree_learner,
                                                   device_growth_applies)
from lightgbm_tpu_torch.utils.log import LightGBMError
from tests.test_torch_ref import jax_ref  # noqa: F401

N, F = 2000, 8
FLOAT_KEYS = ("leaf_value", "internal_value", "leaf_weight", "internal_weight")


def _data(with_nan=True, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(N, F))
    if with_nan:
        X[rng.rand(N, F) < 0.05] = np.nan
    y = (X[:, 0] + np.nan_to_num(X[:, 1]) - 0.5 * np.nan_to_num(X[:, 2])
         + 0.3 * rng.normal(size=N) > 0).astype(np.float64)
    return X, y


def snapped_logloss(preds, dataset):
    """Binary logloss gradients snapped to a 2**-4 grid: every histogram and
    split sum of them is exact in float32, whatever the summation order."""
    p = 1.0 / (1.0 + np.exp(-preds))
    label = dataset.get_label()
    grad = np.round((p - label) * 16) / 16
    hess = np.round(np.maximum(p * (1.0 - p), 1.0 / 16) * 16) / 16
    return grad, hess


def _params(objective, bynode, **extra):
    return {"objective": objective, "num_leaves": 15, "device_type": "cpu",
            "feature_fraction_bynode": bynode, "verbosity": -1, **extra}


def _fields(text):
    """Model text as a list of (key, value) lines."""
    return [tuple(line.split("=", 1)) if "=" in line else (line, None)
            for line in text.splitlines()]


def _assert_split_for_split(port, ref, value_rtol, gain_rtol):
    a, b = _fields(port), _fields(ref)
    assert [k for k, _ in a] == [k for k, _ in b]
    for (key, va), (_, vb) in zip(a, b):
        if key == "tree_sizes" or va == vb:
            continue
        if key in FLOAT_KEYS or key == "split_gain":
            x = np.array(va.split(), dtype=np.float64)
            y = np.array(vb.split(), dtype=np.float64)
            rtol = gain_rtol if key == "split_gain" else value_rtol
            atol = 0.0 if value_rtol == 0.0 or key == "split_gain" else 1e-6
            np.testing.assert_allclose(x, y, rtol=rtol, atol=atol, err_msg=key)
        else:
            assert va == vb, key


@pytest.mark.parametrize("bynode", [1.0, 0.8])
def test_snapped_gradients_model_text_byte_equal(jax_ref, monkeypatch, bynode):
    import jax
    from lightgbm_tpu.ops.split import find_best_split
    from lightgbm_tpu.treelearner import serial

    def op_by_op(*args):
        with jax.disable_jit():
            return find_best_split(*args)

    X, y = _data()
    params = _params(snapped_logloss, bynode)
    port = lt.train(dict(params), lt.Dataset(X, label=y), num_boost_round=5)
    monkeypatch.setattr(serial, "find_best_split", op_by_op)
    ref = jax_ref.train(dict(params), jax_ref.Dataset(X, label=y),
                        num_boost_round=5)
    assert port.model_to_string() == ref.model_to_string()
    assert port.current_iteration() == 5 and port.num_trees() == 5


@pytest.mark.parametrize("bynode", [1.0, 0.8])
@pytest.mark.parametrize("objective", ["binary", "regression"])
def test_builtin_objective_split_for_split(jax_ref, objective, bynode):
    X, y = _data(with_nan=False, seed=1)
    params = _params(objective, bynode)
    port = lt.train(dict(params), lt.Dataset(X, label=y), num_boost_round=5)
    ref = jax_ref.train(dict(params), jax_ref.Dataset(X, label=y),
                        num_boost_round=5)
    _assert_split_for_split(port.model_to_string(), ref.model_to_string(),
                            value_rtol=1e-5, gain_rtol=1e-4)
    np.testing.assert_allclose(port.predict(X), ref.predict(X), rtol=1e-5,
                               atol=1e-6)


def test_bagging_valid_sets_and_early_stopping(jax_ref):
    """Bagging (the out-of-bag rows scored in bin space), a validation set
    scored through the traversal, early stopping and the recorded evals.
    Ten rounds: further on, this data meets a near-tie between two
    thresholds (tree 12) that the last-bit noise of the histograms decides
    one way in each package."""
    X, y = _data(with_nan=False, seed=2)
    Xv, yv = _data(with_nan=False, seed=3)
    params = _params("binary", 0.8, bagging_fraction=0.7, bagging_freq=2,
                     metric="binary_logloss,auc", early_stopping_round=3)
    results = []
    for pkg in (lt, jax_ref):
        train = pkg.Dataset(X, label=y)
        valid = train.create_valid(Xv, label=yv)
        evals = {}
        bst = pkg.train(dict(params), train, num_boost_round=10,
                        valid_sets=[valid], valid_names=["val"],
                        callbacks=[pkg.record_evaluation(evals)])
        results.append((bst, evals))
    (port, port_evals), (ref, ref_evals) = results
    _assert_split_for_split(port.model_to_string(), ref.model_to_string(),
                            value_rtol=1e-5, gain_rtol=1e-4)
    assert port.best_iteration == ref.best_iteration
    assert sorted(port_evals["val"]) == ["auc", "binary_logloss"]
    for name in ("auc", "binary_logloss"):
        np.testing.assert_allclose(port_evals["val"][name], ref_evals["val"][name],
                                   rtol=1e-5)


def test_trained_model_reloads_and_predicts():
    X, y = _data(seed=4)
    bst = lt.train(_params("binary", 0.8), lt.Dataset(X, label=y),
                   num_boost_round=4)
    loaded = lt.Booster(model_str=bst.model_to_string(),
                        params={"device_type": "cpu"})
    np.testing.assert_array_equal(loaded.predict(X, raw_score=True),
                                  bst.predict(X, raw_score=True))
    np.testing.assert_array_equal(loaded.predict(X, pred_leaf=True),
                                  bst.predict(X, pred_leaf=True))
    # the training score is the model's own prediction, row for row
    np.testing.assert_allclose(bst._gbdt.score[0].numpy(),
                               bst.predict(X, raw_score=True), rtol=1e-6, atol=1e-6)


def test_wave_learner_configuration_is_refused_on_the_card(monkeypatch):
    """No longer refused: on the card the factory grows a dense numeric
    configuration without per-node sampling with the wave learner
    (DeviceTreeLearner), as the JAX package does; on the CPU, and with
    feature_fraction_bynode < 1, it takes the serial learner. The card's
    learners are stood in for here (the CPU has no card to put their
    tensors on); tests/test_torch_cuda_train.py builds the real one."""
    from lightgbm_tpu_torch.treelearner import device, serial

    X, y = _data(with_nan=False)
    ds = CoreDataset.from_matrix(X, label=y)
    card, cpu = torch.device("cuda"), torch.device("cpu")
    assert device_growth_applies(card, Config({"feature_fraction_bynode": 1.0}), ds)
    assert not device_growth_applies(card, Config({"feature_fraction_bynode": 0.8}), ds)
    assert not device_growth_applies(cpu, Config({}), ds)

    class Stand:
        def __init__(self, *args):
            self.args = args

    class WaveStand(Stand):
        pass

    class SerialStand(Stand):
        pass

    monkeypatch.setattr(device, "DeviceTreeLearner", WaveStand)
    monkeypatch.setattr(serial, "SerialTreeLearner", SerialStand)
    wave = create_tree_learner("serial", card, Config({}), ds)
    assert type(wave) is WaveStand and wave.args[2] == card
    bynode = create_tree_learner("serial", card, Config({"feature_fraction_bynode": 0.8}),
                                 ds)
    assert type(bynode) is SerialStand
    monkeypatch.undo()
    host = create_tree_learner("serial", cpu, Config({}), ds)
    assert type(host) is serial.SerialTreeLearner
    assert not isinstance(host, device.DeviceTreeLearner)


# what is still refused, with the environment that asks for it and the
# message: every module is ported; a streaming budget with the feature or
# voting learner, which need the whole plane on the device, is refused as
# the JAX package refuses it (data under a budget is the gang-sharded
# streamed learner)
REFUSED = [
    ({"tree_learner": "feature"}, {"LGBM_TPU_HBM_BUDGET": "1000000"}, "distributed learners",
     "serial or data only"),
]


@pytest.mark.parametrize("extra,env,what,message", REFUSED,
                         ids=[w for _, _, w, _ in REFUSED])
def test_unported_features_are_refused(monkeypatch, extra, env, what, message):
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    X, y = _data(with_nan=False)
    with pytest.raises(LightGBMError, match=message):
        lt.train(_params("binary", 0.8, **extra), lt.Dataset(X, label=y),
                 num_boost_round=2)


def test_hbm_budget_routes_to_the_streamed_learner(monkeypatch):
    from lightgbm_tpu_torch.streaming import StreamedTreeLearner

    X, y = _data(with_nan=False)
    resident = lt.train(_params("binary", 0.8), lt.Dataset(X, label=y), num_boost_round=2)
    monkeypatch.setenv("LGBM_TPU_HBM_BUDGET", "64M")
    bst = lt.train(_params("binary", 0.8), lt.Dataset(X, label=y), num_boost_round=2)
    assert isinstance(bst._gbdt.tree_learner, StreamedTreeLearner)
    assert bst._gbdt.tree_learner.bins_dev is None
    assert bst.model_to_string() == resident.model_to_string()

