"""Custom metrics on validation sets (ROADMAP Queue 3 fault 9 of the
reference, repaired in the port).

The python package's contract: `Booster.eval_valid(feval)` evaluates each
feval on every validation set after that set's built-in metrics, `train`
records it, `cv` evaluates it on every fold, and the estimators wrap a
callable `eval_metric` into a feval, keeping only metric names in
`params["metric"]`. The JAX package drops a feval on validation data and
its estimators raise on a callable; each test shows that gap beside the
port's answer. Data: 500 x 4 normal rows, label x0 > 0, 400 / 100 split, 7
leaves, 3 rounds. The built-in metrics stay equal to the JAX package's
within rtol 1e-6 (the scores sum in other orders).
"""
import numpy as np
import pytest

import lightgbm_tpu_torch as lt
from tests.test_torch_ref import jax_ref  # noqa: F401

PARAMS = {"objective": "binary", "num_leaves": 7, "device_type": "cpu", "verbosity": -1}


def _data():
    rng = np.random.RandomState(0)
    X = rng.normal(size=(500, 4))
    y = (X[:, 0] > 0).astype(np.float64)
    return X[:400], y[:400], X[400:], y[400:]


def mean_score(preds, data):
    return "mean_score", float(np.mean(preds)), True


def _record(pkg, feval):
    Xt, yt, Xv, yv = _data()
    train = pkg.Dataset(Xt, label=yt)
    valid = pkg.Dataset(Xv, label=yv, reference=train)
    evals = {}
    bst = pkg.train(dict(PARAMS), train, num_boost_round=3, valid_sets=[train, valid],
                    valid_names=["train", "valid"], feval=feval,
                    callbacks=[pkg.record_evaluation(evals)])
    return bst, evals


def test_train_records_feval_on_the_valid_set(jax_ref):
    bst, evals = _record(lt, mean_score)
    ref_bst, ref_evals = _record(jax_ref, mean_score)
    assert list(evals["valid"]) == ["binary_logloss", "mean_score"]
    assert list(ref_evals["valid"]) == ["binary_logloss"]  # the JAX gap
    np.testing.assert_allclose(evals["valid"]["binary_logloss"],
                               ref_evals["valid"]["binary_logloss"], rtol=1e-6)
    _, _, Xv, _ = _data()
    raw = bst.predict(Xv, raw_score=True)
    assert evals["valid"]["mean_score"][-1] == pytest.approx(float(np.mean(raw)), rel=1e-6)


def test_eval_valid_orders_each_set_and_takes_lists():
    Xt, yt, Xv, yv = _data()
    train = lt.Dataset(Xt, label=yt)
    bst = lt.Booster(dict(PARAMS, metric="auc"), train)
    bst.add_valid(lt.Dataset(Xv[:50], label=yv[:50], reference=train), "a")
    bst.add_valid(lt.Dataset(Xv[50:], label=yv[50:], reference=train), "b")
    bst.update()

    def two(preds, data):
        return [("n_rows", float(data.num_data()), True), ("max", float(preds.max()), True)]

    got = bst.eval_valid([mean_score, two])
    assert [(d, m) for d, m, _, _ in got] == [
        ("a", "auc"), ("a", "mean_score"), ("a", "n_rows"), ("a", "max"),
        ("b", "auc"), ("b", "mean_score"), ("b", "n_rows"), ("b", "max")]
    assert got[2][2] == 50.0 and got[6][2] == 50.0
    assert bst.eval_valid() == [r for r in got if r[1] == "auc"]


def test_cv_evaluates_feval_on_every_fold(jax_ref):
    Xt, yt, _, _ = _data()
    folds = []

    def per_fold(preds, data):
        folds.append(data.num_data())
        return mean_score(preds, data)

    out = lt.cv(dict(PARAMS), lt.Dataset(Xt, label=yt), num_boost_round=3, nfold=4,
                feval=per_fold, stratified=False)
    assert len(out["valid mean_score-mean"]) == 3
    assert folds == [100] * 12  # 4 folds x 3 rounds
    ref = jax_ref.cv(dict(PARAMS), jax_ref.Dataset(Xt, label=yt), num_boost_round=3,
                     nfold=4, feval=mean_score, stratified=False)
    assert "valid mean_score-mean" not in ref  # the JAX gap
    np.testing.assert_allclose(out["valid binary_logloss-mean"],
                               ref["valid binary_logloss-mean"], rtol=1e-6)


def accuracy(y_true, y_pred):
    return "accuracy", float(np.mean((y_pred > 0) == (y_true > 0.5))), True


def weighted(y_true, y_pred, weight):
    return "n_weighted", float(len(y_true) if weight is None else weight.sum()), True


@pytest.mark.parametrize("eval_metric", [accuracy, ["auc", accuracy], [accuracy, weighted]])
def test_estimator_wraps_callable_eval_metric(jax_ref, eval_metric):
    Xt, yt, Xv, yv = _data()
    clf = lt.LGBMClassifier(n_estimators=3, num_leaves=7, device_type="cpu")
    clf.fit(Xt, yt, eval_set=[(Xv, yv)], eval_metric=eval_metric)
    res = clf.evals_result_["valid_0"]
    metrics = eval_metric if isinstance(eval_metric, list) else [eval_metric]
    names = [{accuracy: "accuracy", weighted: "n_weighted"}.get(m, m) for m in metrics]
    assert set(names) <= set(res) and all(len(res[n]) == 3 for n in names)
    raw = clf.predict(Xv, raw_score=True)
    assert res["accuracy"][-1] == accuracy(yv, raw)[1]
    if weighted in metrics:
        assert res["n_weighted"] == [len(yv)] * 3
    ref = jax_ref.LGBMClassifier(n_estimators=3, num_leaves=7, device_type="cpu")
    with pytest.raises((TypeError, AttributeError)):  # the JAX gap: a function as a name
        ref.fit(Xt, yt, eval_set=[(Xv, yv)], eval_metric=eval_metric)


def test_estimator_string_metric_unchanged(jax_ref):
    Xt, yt, Xv, yv = _data()
    kw = dict(n_estimators=3, num_leaves=7, device_type="cpu")
    clf = lt.LGBMClassifier(**kw).fit(Xt, yt, eval_set=[(Xv, yv)], eval_metric="auc")
    ref = jax_ref.LGBMClassifier(**kw).fit(Xt, yt, eval_set=[(Xv, yv)], eval_metric="auc")
    assert list(clf.evals_result_["valid_0"]) == list(ref.evals_result_["valid_0"])
    np.testing.assert_allclose(clf.evals_result_["valid_0"]["auc"],
                               ref.evals_result_["valid_0"]["auc"], rtol=1e-6)
