"""The scikit-learn estimators of the port (`lightgbm_tpu_torch.sklearn`),
on the CPU.

Contracts:

* `_lgb_params`, the estimator's parameters mapped to LightGBM's, equal to
  the JAX package's dict for dict, for each estimator, with defaults, with
  explicit parameters, a `random_state` and extra keyword parameters;
* each estimator's model text byte-equal to `engine.train` with those
  parameters on the same data (the classifier's labels encoded as
  `classes_` orders them), and its recorded evaluations equal to
  `record_evaluation`'s;
* the classifier: string classes, `classes_`, `n_classes_`, probabilities
  [N, 2] or [N, C] summing to 1, `predict` in the original labels, an
  eval_set's labels encoded the same way; the ranker: `group` required,
  `eval_group` required with an eval set, `eval_at` reaching the NDCG
  metric; the fitted attributes, `clone` and `get_params`;
* the ranker fitted in both packages: split for split (values within rtol
  1e-5 / atol 1e-6, gains rtol 1e-4), the same feature importances,
  predictions within 1e-5.
"""
import numpy as np
import pytest

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.sklearn import LGBMClassifier, LGBMRanker, LGBMRegressor
from tests.test_torch_ref import jax_ref  # noqa: F401
from tests.test_torch_train import _assert_split_for_split
from tests.torch_rank_data import rank_data

CPU = {"device_type": "cpu"}
SMALL = {"n_estimators": 4, "num_leaves": 7, "min_child_samples": 10}


def _regression(seed=0, n=800):
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, 5))
    return X, X[:, 0] * 2 - X[:, 1] + 0.3 * rng.normal(size=n)


PARAM_CASES = {
    "defaults": {},
    "explicit": {"boosting_type": "gbdt", "num_leaves": 15, "max_depth": 5,
                 "learning_rate": 0.05, "n_estimators": 7, "subsample_for_bin": 1000,
                 "min_split_gain": 0.1, "min_child_weight": 0.01, "min_child_samples": 5,
                 "subsample": 0.8, "subsample_freq": 2, "colsample_bytree": 0.9,
                 "reg_alpha": 0.1, "reg_lambda": 0.2, "random_state": 11},
    "kwargs": {"objective": "huber", "alpha": 0.7, "device_type": "cpu", "max_bin": 63},
}


@pytest.mark.parametrize("case", list(PARAM_CASES))
@pytest.mark.parametrize("name", ["LGBMRegressor", "LGBMClassifier", "LGBMRanker"])
def test_lgb_params_match_jax(jax_ref, name, case):
    from lightgbm_tpu import sklearn as jax_sklearn

    est = getattr(lt, name)(**PARAM_CASES[case])
    ref = getattr(jax_sklearn, name)(**PARAM_CASES[case])
    assert est._lgb_params() == ref._lgb_params()
    assert est.get_params() == ref.get_params()


def _engine_text(params, X, y, rounds, **dataset):
    return lt.train(params, lt.Dataset(X, label=y, **dataset),
                    num_boost_round=rounds).model_to_string()


def test_regressor_model_text_equals_engine_train():
    from sklearn.base import clone

    X, y = _regression()
    est = LGBMRegressor(**SMALL, **CPU)
    est.fit(X, y, eval_set=[(X[:200], y[:200])], eval_metric="l1")
    params = {**est._lgb_params(), "objective": "regression"}
    assert est.booster_.model_to_string() == _engine_text(params, X, y, SMALL["n_estimators"])
    evals = {}
    lt.train({**params, "metric": "l1"}, lt.Dataset(X, label=y), SMALL["n_estimators"],
             valid_sets=[lt.Dataset(X[:200], label=y[:200])],
             callbacks=[lt.record_evaluation(evals)])
    assert est.evals_result_ == evals == est.best_score_
    assert est.n_features_ == est.n_features_in_ == 5
    assert est.feature_importances_.shape == (5,) and est.feature_name_ == [
        f"Column_{i}" for i in range(5)]
    np.testing.assert_array_equal(est.predict(X), est.booster_.predict(X))
    twin = clone(est)
    assert twin.get_params() == est.get_params()
    with pytest.raises(ValueError, match="Number of features"):
        est.predict(X[:, :3])


@pytest.mark.parametrize("n_classes", [2, 3])
def test_classifier_classes_and_model_text(n_classes):
    X, signal = _regression(seed=1)
    edges = np.quantile(signal, np.linspace(0, 1, n_classes + 1)[1:-1])
    names = np.array(["low", "mid", "top"][:n_classes])
    labels = names[np.digitize(signal, edges)]
    est = LGBMClassifier(**SMALL, **CPU)
    est.fit(X, labels, eval_set=[(X[:300], labels[:300])])
    assert list(est.classes_) == sorted(names) and est.n_classes_ == n_classes
    encoded = np.searchsorted(est.classes_, labels).astype(np.float64)
    params = {**est._lgb_params(),
              "objective": "binary" if n_classes == 2 else "multiclass"}
    assert est.booster_.model_to_string() == _engine_text(params, X, encoded,
                                                          SMALL["n_estimators"])
    proba = est.predict_proba(X)
    assert proba.shape == (len(X), n_classes)
    np.testing.assert_allclose(proba.sum(axis=1), 1.0, rtol=1e-6)
    np.testing.assert_array_equal(est.predict(X), est.classes_[np.argmax(proba, axis=1)])
    metric = "binary_logloss" if n_classes == 2 else "multi_logloss"
    assert list(est.evals_result_["valid_0"]) == [metric]


def test_ranker_model_text_eval_at_and_refusals():
    X, y, sizes = rank_data()
    est = LGBMRanker(**SMALL, **CPU)
    with pytest.raises(ValueError, match="group"):
        est.fit(X, y)
    with pytest.raises(ValueError, match="Eval_group"):
        est.fit(X, y, group=sizes, eval_set=[(X, y)])
    est.fit(X, y, group=sizes, eval_set=[(X[:200], y[:200])], eval_group=[[100, 100]],
            eval_at=[1, 3])
    params = {**est._lgb_params(), "objective": "lambdarank"}
    assert params["eval_at"] == [1, 3]
    assert est.booster_.model_to_string() == _engine_text(params, X, y, SMALL["n_estimators"],
                                                          group=sizes)
    assert list(est.evals_result_["valid_0"]) == ["ndcg@1", "ndcg@3"]
    assert all(len(v) == SMALL["n_estimators"] for v in est.evals_result_["valid_0"].values())


def test_ranker_matches_jax(jax_ref):
    from lightgbm_tpu.sklearn import LGBMRanker as JaxRanker

    X, y, sizes = rank_data(seed=2)
    port = LGBMRanker(**SMALL, **CPU).fit(X, y, group=sizes)
    ref = JaxRanker(**SMALL, **CPU).fit(X, y, group=sizes)
    _assert_split_for_split(port.booster_.model_to_string(), ref.booster_.model_to_string(),
                            value_rtol=1e-5, gain_rtol=1e-4)
    np.testing.assert_array_equal(port.feature_importances_, ref.feature_importances_)
    np.testing.assert_allclose(port.predict(X), ref.predict(X), rtol=1e-5, atol=1e-5)
