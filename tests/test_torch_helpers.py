"""The port's host helpers against the JAX package's, on the same inputs.

`Tree.predict` (one row's value on the host), `Dataset.feature_num_bin`,
`Dataset.construct_histogram_np` and `Metric.factor_to_bigger_better` touch
no card: each is the JAX package's few lines of host code, copied into the
port. Contracts: `Tree.predict` equals the JAX tree's exactly on numeric,
categorical, NaN-missing and linear trees (a linear leaf whose feature is
NaN or infinite falls back to the leaf's value), both packages reading the
same model text; `feature_num_bin` equals on every feature of a dataset
with an EFB bundle and a categorical feature; `construct_histogram_np` is
byte-equal on every group, over all rows and a subset;
`factor_to_bigger_better` equals on every metric of the registry.
"""
import numpy as np
import pytest

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.io.dataset import Dataset
from lightgbm_tpu_torch.models.serialize import GBDTModel
from lightgbm_tpu_torch.models.synthetic import make_rows, random_model
from tests.test_torch_ref import jax_ref  # noqa: F401

CAT = (2, 5)


def _model_pair(jax_ref, text):
    from lightgbm_tpu.models.serialize import GBDTModel as JModel

    return GBDTModel.from_string(text), JModel.from_string(text)


def _assert_trees_predict_equal(port, ref, rows):
    assert len(port.trees) == len(ref.trees)
    for tree, jtree in zip(port.trees, ref.trees):
        for row in rows:
            got, want = tree.predict(row), jtree.predict(row)
            assert isinstance(got, float)
            assert np.float64(got).tobytes() == np.float64(want).tobytes()


@pytest.mark.parametrize("cat", [(), CAT], ids=["numeric", "categorical"])
def test_tree_predict_equals_jax(jax_ref, cat):
    """Numeric splits of every missing type (NaN and exact zeros among the
    rows), categorical bitsets, constant and stump trees."""
    rng = np.random.RandomState(7 + len(cat))
    text = random_model(rng, 8, 6, 15, cat_features=cat, stump_every=4).to_string()
    port, ref = _model_pair(jax_ref, text)
    assert any(t.num_leaves == 1 for t in port.trees)
    assert any(t.num_cat > 0 for t in port.trees) == bool(cat)
    rows = make_rows(np.random.RandomState(3), 300, 8, cat, nan_frac=0.1, zero_frac=0.1)
    _assert_trees_predict_equal(port, ref, rows.astype(np.float64))


def test_tree_predict_linear_equals_jax(jax_ref):
    """Linear leaves: leaf_const plus the coefficients, and the leaf's value
    where a feature of the leaf's model is NaN, +inf or -inf."""
    rng = np.random.RandomState(11)
    X = rng.uniform(-2, 2, size=(1500, 3))
    y = np.where(X[:, 0] > 0, 2.0 * X[:, 1] + 1.0, -1.5 * X[:, 1]) + 0.5 * X[:, 2]
    X[::37, 1] = np.nan
    params = {"objective": "regression", "num_leaves": 7, "linear_tree": True,
              "linear_lambda": 0.01, "device_type": "cpu", "verbosity": -1}
    text = lt.train(params, lt.Dataset(X, label=y), num_boost_round=4).model_to_string()
    port, ref = _model_pair(jax_ref, text)
    assert all(t.is_linear for t in port.trees)
    assert any(t.leaf_features[i] for t in port.trees for i in range(t.num_leaves))
    rows = rng.uniform(-2, 2, size=(120, 3))
    rows[0::6, 1] = np.nan
    rows[1::6, 1] = np.inf
    rows[2::6, 2] = -np.inf
    rows[3::6, 0] = np.nan
    _assert_trees_predict_equal(port, ref, rows)
    # a NaN or inf among a linear leaf's features gives the leaf's value
    hits = 0
    for tree in port.trees:
        for row in rows:
            leaf = tree.predict_leaf_index(row)
            if any(not np.isfinite(row[f]) for f in tree.leaf_features[leaf]):
                assert tree.predict(row) == float(tree.leaf_value[leaf])
                hits += 1
    assert hits > 0


def _bundled_matrix(seed=5, n=3000):
    """Numeric columns, a categorical column and six mutually exclusive
    sparse columns that EFB bundles into one group."""
    rng = np.random.RandomState(seed)
    X = np.zeros((n, 10))
    X[:, 0] = rng.normal(size=n)
    X[:, 1] = rng.exponential(size=n)
    X[:, 2] = rng.randint(0, 12, n)
    X[:, 3] = rng.normal(size=n)
    X[rng.rand(n) < 0.05, 3] = np.nan
    hot = rng.randint(0, 12, n)
    for j in range(6):
        X[hot == j, 4 + j] = rng.uniform(0.5, 2.0, (hot == j).sum())
    y = (X[:, 0] + (X[:, 2] % 3) - X[:, 4] > 0.5).astype(np.float64)
    return X, y


def _dataset_pair(jax_ref):
    from lightgbm_tpu.config import Config as JConfig
    from lightgbm_tpu.io.dataset import Dataset as JDataset

    X, y = _bundled_matrix()
    params = {"objective": "binary", "max_bin": 63, "verbosity": -1}
    port = Dataset.from_matrix(X, label=y, config=Config(params), categorical_feature=[2])
    ref = JDataset.from_matrix(X, label=y, config=JConfig(params), categorical_feature=[2])
    return port, ref


def test_feature_num_bin_equals_jax(jax_ref):
    port, ref = _dataset_pair(jax_ref)
    assert port.num_features == ref.num_features
    assert any(len(g.feature_indices) > 1 for g in port.groups)  # an EFB bundle
    assert any(m.bin_type != 0 for m in port.mappers)  # the categorical feature
    got = [port.feature_num_bin(f) for f in range(port.num_features)]
    assert got == [ref.feature_num_bin(f) for f in range(ref.num_features)]
    assert all(isinstance(b, int) and b >= 2 for b in got)


@pytest.mark.parametrize("subset", [False, True], ids=["all_rows", "row_subset"])
def test_construct_histogram_np_byte_equal_to_jax(jax_ref, subset):
    port, ref = _dataset_pair(jax_ref)
    rng = np.random.RandomState(9)
    grad = rng.normal(size=port.num_data).astype(np.float32)
    hess = rng.uniform(0.1, 1.0, port.num_data).astype(np.float32)
    rows = np.sort(rng.choice(port.num_data, 700, replace=False)) if subset else None
    assert port.num_groups == ref.num_groups
    for g in range(port.num_groups):
        got = port.construct_histogram_np(g, grad, hess, rows)
        want = ref.construct_histogram_np(g, grad, hess, rows)
        assert got.dtype == want.dtype == np.float64 and got.shape == want.shape
        assert got.tobytes() == want.tobytes()
        assert got[:, 2].sum() == (700 if subset else port.num_data)


def test_factor_to_bigger_better_equals_jax_on_every_metric(jax_ref):
    from lightgbm_tpu.config import Config as JConfig
    from lightgbm_tpu.metrics import (binary as jb, multiclass as jm,  # noqa: F401
                                      rank as jr, regression as jg, xentropy as jx)
    from lightgbm_tpu.metrics.registry import METRIC_REGISTRY as JREG
    from lightgbm_tpu_torch.metrics import (binary, multiclass, rank,  # noqa: F401
                                            regression, xentropy)
    from lightgbm_tpu_torch.metrics.registry import METRIC_REGISTRY

    assert sorted(METRIC_REGISTRY) == sorted(JREG)
    seen = set()
    for name, cls in METRIC_REGISTRY.items():
        got = cls(Config({"metric": name})).factor_to_bigger_better
        want = JREG[name](JConfig({"metric": name})).factor_to_bigger_better
        assert got == want and got in (1.0, -1.0), name
        seen.add(got)
    assert seen == {1.0, -1.0}
