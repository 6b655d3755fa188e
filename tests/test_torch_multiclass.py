"""Multiclass training in the port against the JAX package, on the CPU.

Contracts (tolerances stated where the frameworks' float32 `exp` and `log`
round apart):

* softmax gradients and hessians on the same float32 [C, N] scores: rtol
  1e-6, atol 1e-7 (the softmax's exp and its sum); one-vs-all's, a binary
  logloss for each class: rtol 2e-6, atol 1e-6, the binary objective's
  tolerance in tests/test_torch_objectives.py (one value in 21,000 of the
  OVA case here lands 2.4e-6 apart in relative terms); `init`'s class
  probabilities, `boost_from_score` and `class_need_train`: exact (host float64 on the same labels); a label out
  of [0, C) is fatal in both;
* multi_logloss, multi_error (top-k 1 and 2, ties counted as correct) and
  auc_mu (with and without auc_mu_weights): rtol 1e-6;
* grid-snapped softmax `fobj` gradients, C = 3: the model text byte-equal
  to the JAX package's through the serial learner (feature_fraction_bynode
  0.8; the JAX split search run op by op) and through the wave learner,
  with and without bagging (each package's wave learner swapped into its
  GBDT; split_gain within 4 ULP of the un-shifted gain, ROADMAP Queue 3);
* the built-in softmax and OVA objectives: split for split (features,
  thresholds, decision types, children, counts equal; values within rtol
  1e-5 / atol 1e-6, gains within rtol 1e-4), through both learners;
* predict: [N, C] probabilities summing to 1 within 1e-6, raw scores, and
  pred_leaf [N, C x iterations] against the JAX package on the same model
  text; the model text round-trips bit-equal, num_class and
  num_tree_per_iteration written; early stopping on multi_logloss stops
  where the JAX package's does, the recorded multi_logloss and multi_error
  within rtol 1e-5, auc_mu within 1e-4 (a rank statistic of scores that
  differ in their last bits).
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.io.metadata import Metadata
from lightgbm_tpu_torch.metrics import create_metric
from lightgbm_tpu_torch.objectives import create_objective
from lightgbm_tpu_torch.treelearner.device import DeviceTreeLearner
from lightgbm_tpu_torch.utils.log import LightGBMError
from tests.test_torch_ref import jax_ref  # noqa: F401
from tests.test_torch_train import _assert_split_for_split

CPU = torch.device("cpu")
N, F, C = 1200, 6, 3
GRAD_RTOL, GRAD_ATOL = 1e-6, 1e-7
OVA_RTOL, OVA_ATOL = 2e-6, 1e-6  # BinaryLogloss's, tests/test_torch_objectives.py
METRIC_RTOL = 1e-6


def _labels(rng, n, num_class, absent=()):
    label = rng.randint(0, num_class, size=n)
    for k in absent:  # a class with no row: it does not train
        label[label == k] = (k + 1) % num_class
    return label.astype(np.float64)


def _data(seed=0, n=N, num_class=C):
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, F))
    signal = X[:, 0] + 0.8 * X[:, 1] - 0.5 * X[:, 2] + 0.3 * rng.normal(size=n)
    edges = np.quantile(signal, np.linspace(0, 1, num_class + 1)[1:-1])
    return X, np.digitize(signal, edges).astype(np.float64)


def _metadata(label, weight, jax_ref):
    from lightgbm_tpu.io.metadata import Metadata as JaxMetadata

    md, jmd = Metadata(len(label)), JaxMetadata(len(label))
    for m in (md, jmd):
        m.set_label(label)
        if weight is not None:
            m.set_weights(weight)
    return md, jmd


OBJECTIVE_CASES = [("multiclass", 3, ()), ("multiclass", 7, ()), ("multiclass", 7, (4,)),
                   ("multiclassova", 3, ()), ("multiclassova", 7, (4,))]


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
@pytest.mark.parametrize("case", OBJECTIVE_CASES,
                         ids=[f"{o}-{c}{'-absent' if a else ''}" for o, c, a in OBJECTIVE_CASES])
def test_gradients_init_and_boost_match_jax(jax_ref, case, weighted):
    import jax
    import jax.numpy as jnp
    from lightgbm_tpu.config import Config as JaxConfig
    from lightgbm_tpu.objectives import create_objective as jax_objective

    name, num_class, absent = case
    rng = np.random.RandomState(num_class + 10 * weighted + len(absent))
    n = 3000
    label = _labels(rng, n, num_class, absent)
    weight = rng.uniform(0.5, 2.0, size=n) if weighted else None
    md, jmd = _metadata(label, weight, jax_ref)
    params = {"objective": name, "num_class": num_class}
    obj = create_objective(name, Config(params))
    ref = jax_objective(name, JaxConfig(params))
    obj.init(md, n, CPU)
    ref.init(jmd, n)
    assert obj.num_model_per_iteration == num_class
    score = (rng.normal(size=(num_class, n)) * 2).astype(np.float32)
    grad, hess = obj.get_gradients(torch.from_numpy(score))
    rgrad, rhess = jax.jit(ref.get_gradients)(jnp.asarray(score))
    assert grad.dtype == hess.dtype == torch.float32
    assert grad.shape == hess.shape == (num_class, n)
    rtol, atol = (GRAD_RTOL, GRAD_ATOL) if name == "multiclass" else (OVA_RTOL, OVA_ATOL)
    np.testing.assert_allclose(grad.numpy(), np.asarray(rgrad), rtol=rtol, atol=atol)
    np.testing.assert_allclose(hess.numpy(), np.asarray(rhess), rtol=rtol, atol=atol)
    if name == "multiclass":
        np.testing.assert_array_equal(obj.class_init_probs, ref.class_init_probs)
    for c in range(num_class):
        assert obj.boost_from_score(c) == ref.boost_from_score(c)
        assert obj.class_need_train(c) == ref.class_need_train(c)
    assert [obj.class_need_train(c) for c in absent] == [False] * len(absent)
    assert obj.to_string() == ref.to_string()
    raw = score.T.copy()
    np.testing.assert_allclose(obj.convert_output(torch.from_numpy(raw)).numpy(),
                               np.asarray(ref.convert_output(jnp.asarray(raw))),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("bad", [-1, 3], ids=["negative", "num_class"])
@pytest.mark.parametrize("name", ["multiclass", "multiclassova"])
def test_out_of_range_label_is_fatal(jax_ref, name, bad):
    """A label outside [0, C) is fatal for softmax in both packages; OVA
    takes it as a row of no class in both (a 0/1 label for each class)."""
    from lightgbm_tpu.config import Config as JaxConfig
    from lightgbm_tpu.objectives import create_objective as jax_objective

    label = np.array([0, 1, 2, 1, bad], dtype=np.float64)
    md, jmd = _metadata(label, None, jax_ref)
    params = {"objective": name, "num_class": C}
    obj = create_objective(name, Config(params))
    ref = jax_objective(name, JaxConfig(params))
    if name == "multiclass":
        with pytest.raises(LightGBMError, match="Label must be in"):
            obj.init(md, len(label), CPU)
        with pytest.raises(Exception, match="Label must be in"):
            ref.init(jmd, len(label))
    else:
        obj.init(md, len(label), CPU)
        ref.init(jmd, len(label))
        for c in range(C):
            assert obj.class_need_train(c) == ref.class_need_train(c)


METRIC_CASES = [("multi_logloss", {}), ("multi_error", {}),
                ("multi_error", {"multi_error_top_k": 2}), ("auc_mu", {}),
                ("auc_mu", {"auc_mu_weights": [0, 1, 2, 1, 0, 3, 2, 3, 0]})]


@pytest.mark.parametrize("objective", ["multiclass", "multiclassova"])
@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
@pytest.mark.parametrize("case", METRIC_CASES,
                         ids=["logloss", "error", "error-top2", "auc_mu", "auc_mu-weights"])
def test_metrics_match_jax(jax_ref, case, weighted, objective):
    """Scores rounded to 0.25 so that classes tie within a row (multi_error
    counts a tie as correct) and pair margins tie across rows (auc_mu)."""
    import jax.numpy as jnp
    from lightgbm_tpu.config import Config as JaxConfig
    from lightgbm_tpu.metrics import create_metric as jax_metric
    from lightgbm_tpu.objectives import create_objective as jax_objective

    name, extra = case
    rng = np.random.RandomState(3 + weighted)
    n = 2000
    label = _labels(rng, n, C)
    weight = rng.uniform(0.5, 2.0, size=n) if weighted else None
    score = (np.round(rng.normal(size=(C, n)) * 4) / 4).astype(np.float32)
    assert (np.sort(score, axis=0)[-1] == np.sort(score, axis=0)[-2]).any()  # ties
    md, jmd = _metadata(label, weight, jax_ref)
    cfg = {"objective": objective, "num_class": C, "metric": name, **extra}
    metric, ref = create_metric(name, Config(cfg)), jax_metric(name, JaxConfig(cfg))
    metric.init(md, n, CPU)
    ref.init(jmd, n)
    obj, robj = create_objective(objective, Config(cfg)), jax_objective(objective,
                                                                        JaxConfig(cfg))
    got = metric.eval(torch.from_numpy(score), obj)
    want = ref.eval(jnp.asarray(score), robj)
    assert metric.name == ref.name and metric.greater_is_better == ref.greater_is_better
    np.testing.assert_allclose(got, want, rtol=METRIC_RTOL)
    # without an objective the scores go through softmax, as the JAX package's
    np.testing.assert_allclose(metric.eval(torch.from_numpy(score), None),
                               ref.eval(jnp.asarray(score), None), rtol=METRIC_RTOL)


def snapped_softmax(preds, dataset):
    """Softmax gradients snapped to a 2**-4 grid, class-major as the
    packages' fobj path reshapes them: every histogram and split sum is
    exact in float32, whatever the summation order."""
    p = np.exp(preds - preds.max(axis=1, keepdims=True))
    p /= p.sum(axis=1, keepdims=True)
    onehot = np.eye(preds.shape[1])[dataset.get_label().astype(int)]
    grad = np.round((p - onehot) * 16) / 16
    factor = preds.shape[1] / (preds.shape[1] - 1.0)
    hess = np.round(np.maximum(factor * p * (1.0 - p), 1.0 / 16) * 16) / 16
    return grad.T.ravel(), hess.T.ravel()


def _trees(text):
    out = []
    for line in text.splitlines():
        if line.startswith("Tree="):
            out.append({})
        elif out and "=" in line:
            key, value = line.split("=", 1)
            out[-1][key] = value
    return out


def _assert_text_equal_but_gain(a, b, rate):
    """Model texts equal line for line but split_gain (and tree_sizes),
    each gain within 4 ULP of the un-shifted gain: the gain plus the
    parent's leaf gain out**2 * sum_h (lambda_l1 = lambda_l2 = 0), out the
    parent's output before shrinkage."""
    assert [ln.split("=", 1)[0] for ln in a.splitlines()] == \
        [ln.split("=", 1)[0] for ln in b.splitlines()]
    for la, lb in zip(a.splitlines(), b.splitlines()):
        if la.split("=", 1)[0] not in ("split_gain", "tree_sizes"):
            assert la == lb, (la, lb)
    for ta, tb in zip(_trees(a), _trees(b)):
        if "split_gain" not in ta:
            continue
        x, y = (np.array(t["split_gain"].split(), np.float32) for t in (ta, tb))
        out = np.array(ta["internal_value"].split(), np.float32) / np.float32(rate)
        sum_h = np.array(ta["internal_weight"].split(), np.float32)
        ulp = np.spacing(np.abs(y) + out * out * sum_h)
        assert (np.abs(x - y) <= 4 * ulp).all(), (x, y)


def _wave_boosters(jax_ref, monkeypatch, params, fobj, rounds=3, seed=0):
    """A Booster of each package whose GBDT grows its trees with that
    package's wave learner (width 21, the adaptive controller off on both
    sides, the JAX pipeline off: C > 1 trains synchronously in both)."""
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


SNAPPED = {"objective": "none", "num_class": C, "num_leaves": 7, "min_data_in_leaf": 10,
           "verbosity": -1}


def test_snapped_model_text_byte_equal_serial(jax_ref, monkeypatch):
    """The serial learner with per-node sampling, 3 trees an iteration."""
    import jax
    from lightgbm_tpu.ops.split import find_best_split
    from lightgbm_tpu.treelearner import serial

    def op_by_op(*args):
        with jax.disable_jit():
            return find_best_split(*args)

    X, y = _data()
    params = {**SNAPPED, "device_type": "cpu", "feature_fraction_bynode": 0.8,
              "objective": snapped_softmax}
    port = lt.train(dict(params), lt.Dataset(X, label=y), num_boost_round=3)
    monkeypatch.setattr(serial, "find_best_split", op_by_op)
    ref = jax_ref.train(dict(params), jax_ref.Dataset(X, label=y), num_boost_round=3)
    assert port.model_to_string() == ref.model_to_string()
    assert port.num_trees() == 3 * C and port.current_iteration() == 3


@pytest.mark.parametrize("bagging", [{}, {"bagging_fraction": 0.7, "bagging_freq": 1}],
                         ids=["full", "bagged"])
def test_snapped_model_text_byte_equal_wave(jax_ref, monkeypatch, bagging):
    port, ref = _wave_boosters(jax_ref, monkeypatch, {**SNAPPED, **bagging},
                               snapped_softmax)
    assert port.num_trees() == ref.num_trees() == 3 * C
    _assert_text_equal_but_gain(port.model_to_string(), ref.model_to_string(), 0.1)


BUILTIN = [("multiclass", "serial"), ("multiclassova", "serial"),
           ("multiclass", "wave"), ("multiclassova", "wave")]


@pytest.mark.parametrize("objective,learner", BUILTIN,
                         ids=[f"{o}-{k}" for o, k in BUILTIN])
def test_builtin_objective_split_for_split(jax_ref, monkeypatch, objective, learner):
    params = {"objective": objective, "num_class": C, "num_leaves": 7,
              "min_data_in_leaf": 10, "verbosity": -1}
    X, y = _data(seed=1)
    if learner == "serial":
        port = lt.train({**params, "device_type": "cpu"}, lt.Dataset(X, label=y),
                        num_boost_round=3)
        ref = jax_ref.train({**params, "device_type": "cpu"}, jax_ref.Dataset(X, label=y),
                            num_boost_round=3)
    else:
        port, ref = _wave_boosters(jax_ref, monkeypatch, params, None, seed=1)
    assert port.num_trees() == ref.num_trees() == 3 * C
    _assert_split_for_split(port.model_to_string(), ref.model_to_string(),
                            value_rtol=1e-5, gain_rtol=1e-4)
    np.testing.assert_allclose(port.predict(X), ref.predict(X), rtol=1e-5, atol=1e-6)


def test_predict_pred_leaf_and_round_trip(jax_ref):
    """[N, C] probabilities summing to 1, raw scores and pred_leaf against
    the JAX package on the port's own model text; the text round-trips."""
    X, y = _data(seed=2)
    params = {"objective": "multiclass", "num_class": C, "num_leaves": 7,
              "device_type": "cpu", "verbosity": -1}
    bst = lt.train(dict(params), lt.Dataset(X, label=y), num_boost_round=4)
    text = bst.model_to_string()
    assert f"num_class={C}" in text.splitlines()
    assert f"num_tree_per_iteration={C}" in text.splitlines()
    prob = bst.predict(X)
    assert prob.shape == (N, C)
    np.testing.assert_allclose(prob.sum(axis=1), 1.0, atol=1e-6)
    leaf = bst.predict(X, pred_leaf=True)
    assert leaf.shape == (N, 4 * C)
    loaded = lt.Booster(model_str=text, params={"device_type": "cpu"})
    np.testing.assert_array_equal(loaded.predict(X), prob)
    np.testing.assert_array_equal(loaded.predict(X, raw_score=True),
                                  bst.predict(X, raw_score=True))
    np.testing.assert_array_equal(loaded.predict(X, pred_leaf=True), leaf)
    assert loaded.model_to_string() == text
    ref = jax_ref.Booster(model_str=text)
    np.testing.assert_array_equal(np.asarray(ref.predict(X, pred_leaf=True)), leaf)
    np.testing.assert_allclose(bst.predict(X, raw_score=True),
                               np.asarray(ref.predict(X, raw_score=True)), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(prob, np.asarray(ref.predict(X)), rtol=1e-5, atol=1e-6)
    # the training score is the model's own raw prediction, class for class
    np.testing.assert_allclose(bst._gbdt.score.numpy().T, bst.predict(X, raw_score=True),
                               rtol=1e-6, atol=1e-6)


def test_early_stopping_on_multi_logloss(jax_ref):
    X, y = _data(seed=3)
    Xv, yv = _data(seed=4, n=400)
    params = {"objective": "multiclass", "num_class": C, "num_leaves": 7,
              "learning_rate": 0.5, "device_type": "cpu", "verbosity": -1,
              "metric": "multi_logloss,multi_error,auc_mu", "early_stopping_round": 2,
              "first_metric_only": True}
    results = []
    for pkg in (lt, jax_ref):
        train = pkg.Dataset(X, label=y)
        evals = {}
        bst = pkg.train(dict(params), train, num_boost_round=30,
                        valid_sets=[train.create_valid(Xv, label=yv)], valid_names=["val"],
                        callbacks=[pkg.record_evaluation(evals)])
        results.append((bst, evals))
    (port, port_evals), (ref, ref_evals) = results
    assert port.best_iteration == ref.best_iteration < 30
    for name in ("multi_logloss", "multi_error"):
        np.testing.assert_allclose(port_evals["val"][name], ref_evals["val"][name],
                                   rtol=1e-5)
    # auc_mu ranks pair margins: the two trainings' scores differ in their
    # last bits (as the built-in objectives' values do), which reorders
    # near-tied margins; on equal scores it is held to rtol 1e-6 above
    np.testing.assert_allclose(port_evals["val"]["auc_mu"], ref_evals["val"]["auc_mu"],
                               atol=1e-4)
