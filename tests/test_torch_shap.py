"""SHAP contributions (`shap.py:predict_contrib`, `predict(pred_contrib=
True)`) against the JAX package's.

Contracts, on models the port trains on the CPU from seeded data (binary
with NaN, binary with a categorical feature, 3-class multiclass): the
contributions of both packages' Boosters loaded from the same model text
are within rtol 1e-12 (float64 TreeSHAP, the same arithmetic); each row's
contributions sum to the raw score within rtol 1e-5 (float64 against the
float32 traversal); `num_iteration` and `start_iteration` select trees as
predict does; linear trees are refused in both packages.
"""
import numpy as np
import pytest

import lightgbm_tpu_torch as lt
from tests.test_torch_ref import jax_ref  # noqa: F401

CPU = {"device_type": "cpu", "verbosity": -1}


def _binary():
    rng = np.random.RandomState(0)
    X = rng.normal(size=(800, 5))
    X[rng.rand(800, 5) < 0.05] = np.nan
    y = (np.nan_to_num(X[:, 0]) - np.nan_to_num(X[:, 2]) > 0).astype(float)
    return {"objective": "binary", "num_leaves": 15}, lt.Dataset(X, label=y), X, 1


def _categorical():
    rng = np.random.RandomState(1)
    X = rng.normal(size=(900, 4))
    X[:, 2] = rng.randint(0, 10, size=900)
    y = ((X[:, 0] > 0) ^ np.isin(X[:, 2], [1, 4, 7])).astype(float)
    return ({"objective": "binary", "num_leaves": 15},
            lt.Dataset(X, label=y, categorical_feature=[2]), X, 1)


def _multiclass():
    rng = np.random.RandomState(2)
    X = rng.normal(size=(900, 4))
    y = ((X[:, 0] > 0).astype(int) + (X[:, 1] > 0.5).astype(int)).astype(float)
    return {"objective": "multiclass", "num_class": 3, "num_leaves": 7}, lt.Dataset(
        X, label=y), X, 3


@pytest.mark.parametrize("case", [_binary, _categorical, _multiclass],
                         ids=["binary_nan", "categorical", "multiclass"])
def test_contrib_equals_jax_and_adds_up(jax_ref, case):
    params, train_set, X, C = case()
    bst = lt.train({**params, **CPU}, train_set, num_boost_round=6)
    text = bst.model_to_string()
    rows = X[:60]
    port = lt.Booster(model_str=text, params=CPU)
    ref = jax_ref.Booster(model_str=text, params=CPU)
    got = port.predict(rows, pred_contrib=True)
    assert got.shape == (60, C * (X.shape[1] + 1)) and got.dtype == np.float64
    np.testing.assert_allclose(got, ref.predict(rows, pred_contrib=True), rtol=1e-12,
                               atol=1e-15)
    raw = port.predict(rows, raw_score=True).reshape(60, C)
    sums = got.reshape(60, C, X.shape[1] + 1).sum(axis=2)
    np.testing.assert_allclose(sums, raw, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(bst.predict(rows, pred_contrib=True), got)
    for kw in ({"num_iteration": 2}, {"start_iteration": 3}):
        np.testing.assert_allclose(port.predict(rows, pred_contrib=True, **kw),
                                   ref.predict(rows, pred_contrib=True, **kw),
                                   rtol=1e-12, atol=1e-15)


def test_linear_trees_refused_in_both(jax_ref):
    rng = np.random.RandomState(3)
    X = rng.uniform(-2, 2, size=(600, 3))
    y = 2 * X[:, 0] + rng.normal(size=600) * 0.1
    bst = lt.train({"objective": "regression", "num_leaves": 7, "linear_tree": True, **CPU},
                   lt.Dataset(X, label=y), num_boost_round=2)
    with pytest.raises(ValueError, match="linear-tree"):
        bst.predict(X[:5], pred_contrib=True)
    ref = jax_ref.Booster(model_str=bst.model_to_string(), params=CPU)
    with pytest.raises(ValueError, match="linear-tree"):
        ref.predict(X[:5], pred_contrib=True)


def test_tree_walk_equals_the_traversal():
    """`Tree.predict_leaf_index` (the host walk SHAP takes) lands on the
    leaves the traversal's leaf mode gives, NaN and categories included."""
    params, train_set, X, _ = _categorical()
    bst = lt.train({**params, **CPU}, train_set, num_boost_round=4)
    rows = np.vstack([X[:50], np.full((1, X.shape[1]), np.nan)])
    leaves = bst.predict(rows, pred_leaf=True)
    walked = np.array([[t.predict_leaf_index(r) for t in bst._gbdt.models] for r in rows])
    np.testing.assert_array_equal(walked, leaves)
