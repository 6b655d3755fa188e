"""The port's binning and Dataset against the JAX package's: bin mappers,
feature groups and the bin plane must be exactly equal, for a training set
and for a validation set aligned to it."""
import json

import numpy as np
import pytest

from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.io.dataset import Dataset
from tests.test_torch_ref import jax_ref  # noqa: F401


def _matrix(seed, n, f):
    """Dense features with NaNs, exact zeros, a constant column, a skewed
    column and a few distinct values, made from a seed with numpy."""
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, f))
    X[rng.rand(n, f) < 0.05] = np.nan
    X[rng.rand(n, f) < 0.1] = 0.0
    X[:, 1] = 3.0
    X[:, 2] = np.round(rng.exponential(size=n) ** 3, 2)
    X[:, 3] = rng.randint(0, 4, size=n)
    return X, (X[:, 0] > 0).astype(np.float64)


CASES = [
    ("default", 1500, 8, {}),
    ("max_bin_15", 1500, 6, {"max_bin": 15}),
    ("zero_as_missing", 1200, 6, {"zero_as_missing": True}),
    ("min_data_in_bin", 900, 5, {"min_data_in_bin": 40, "min_data_in_leaf": 5}),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_bins_equal_jax(jax_ref, case):
    from lightgbm_tpu.config import Config as JaxConfig
    from lightgbm_tpu.io.dataset import Dataset as JaxDataset

    _, n, f, params = case
    X, y = _matrix(len(params) + n, n, f)
    Xv, yv = _matrix(7 + n, n // 3, f)
    ref = JaxDataset.from_matrix(X, label=y, config=JaxConfig(dict(params)))
    port = Dataset.from_matrix(X, label=y, config=Config(dict(params)))
    # through JSON: the bin bounds hold a NaN, which is never == itself
    assert [json.dumps(m.to_dict()) for m in port.mappers] == \
        [json.dumps(m.to_dict()) for m in ref.mappers]
    assert port.used_features == ref.used_features
    assert [g.feature_indices for g in port.groups] == \
        [g.feature_indices for g in ref.groups]
    assert port.bins.dtype == ref.bins.dtype
    np.testing.assert_array_equal(port.bins, ref.bins)
    np.testing.assert_array_equal(port.group_bin_counts(), ref.group_bin_counts())
    assert port.feature_infos() == ref.feature_infos()
    for j in port.used_features:
        for b in (0, port.mappers[j].num_bin // 2):
            assert port.real_threshold(j, b) == ref.real_threshold(j, b)
    # a validation set bins against the training set's mappers
    ref_v = JaxDataset.from_matrix(Xv, label=yv, config=JaxConfig(dict(params)),
                                   reference=ref)
    port_v = Dataset.from_matrix(Xv, label=yv, config=Config(dict(params)),
                                 reference=port)
    np.testing.assert_array_equal(port_v.bins, ref_v.bins)
    np.testing.assert_array_equal(port_v.metadata.label, ref_v.metadata.label)


def test_sparse_input_bins_like_dense(jax_ref):
    from scipy import sparse

    X, y = _matrix(3, 800, 6)
    X = np.nan_to_num(X)
    dense = Dataset.from_matrix(X, label=y)
    csr = Dataset.from_matrix(sparse.csr_matrix(X), label=y)
    np.testing.assert_array_equal(csr.bins, dense.bins)


def test_metadata_weights_and_init_score(jax_ref):
    from lightgbm_tpu.io.dataset import Dataset as JaxDataset

    X, y = _matrix(4, 600, 4)
    w = np.random.RandomState(5).uniform(0.5, 2.0, size=600)
    init = np.random.RandomState(6).normal(size=600)
    ref = JaxDataset.from_matrix(X, label=y, weight=w, init_score=init)
    port = Dataset.from_matrix(X, label=y, weight=w, init_score=init)
    for name in ("label", "weights", "init_score"):
        a, b = getattr(port.metadata, name), getattr(ref.metadata, name)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
