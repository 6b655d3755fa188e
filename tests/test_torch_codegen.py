"""`models/codegen.py:model_to_cpp` (convert_model) against the JAX
package's.

Contracts, on models the port trains on the CPU from seeded data (binary
with a categorical feature and NaN, 3-class multiclass, linear trees):
the generated C++ text is byte-equal to the JAX package's `model_to_cpp`
of the same model text; compiled with g++ and loaded through ctypes, its
`Predict` is within rtol 1e-5, atol 1e-7 (1e-6 for linear trees) of
`Booster.predict` (the JAX test's contract, tests/test_codegen.py:49).
"""
import ctypes
import subprocess

import numpy as np
import pytest

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.models.codegen import model_to_cpp
from lightgbm_tpu_torch.models.serialize import GBDTModel
from tests.test_torch_ref import jax_ref  # noqa: F401


def compile_model(src: str, tmp_path, name: str) -> ctypes.CDLL:
    cpp, lib = tmp_path / f"{name}.cpp", tmp_path / f"{name}.so"
    cpp.write_text(src)
    subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-o", str(lib), str(cpp)],
                   check=True, capture_output=True)
    return ctypes.CDLL(str(lib))


def predict_native(lib, X, n_out):
    out = np.empty((X.shape[0], n_out))
    row = np.empty(X.shape[1])
    buf = np.empty(n_out)
    ptr = ctypes.POINTER(ctypes.c_double)
    for i in range(X.shape[0]):
        row[:] = X[i]
        lib.Predict(row.ctypes.data_as(ptr), buf.ctypes.data_as(ptr))
        out[i] = buf
    return out


def _binary_categorical():
    rng = np.random.RandomState(0)
    n = 1500
    X = rng.randn(n, 5)
    X[:, 3] = rng.randint(0, 8, size=n)
    X[rng.rand(n) < 0.05, 1] = np.nan
    y = ((X[:, 0] > 0) ^ np.isin(X[:, 3], [2, 5])).astype(np.float64)
    return ({"objective": "binary", "num_leaves": 15}, lt.Dataset(X, label=y,
            categorical_feature=[3]), X, 8, 1, 1e-7)


def _multiclass():
    rng = np.random.RandomState(1)
    X = rng.randn(1000, 4)
    y = ((X[:, 0] > 0).astype(int) + (X[:, 1] > 0).astype(int)).astype(float)
    return ({"objective": "multiclass", "num_class": 3, "num_leaves": 7},
            lt.Dataset(X, label=y), X, 5, 3, 1e-7)


def _linear():
    rng = np.random.RandomState(2)
    X = rng.uniform(-2, 2, size=(1200, 3))
    y = np.where(X[:, 0] > 0, 2 * X[:, 1], -X[:, 1]) + rng.randn(1200) * 0.05
    return ({"objective": "regression", "num_leaves": 7, "linear_tree": True},
            lt.Dataset(X, label=y), X, 5, 1, 1e-6)


@pytest.mark.parametrize("case", [_binary_categorical, _multiclass, _linear],
                         ids=["binary_categorical_nan", "multiclass", "linear_tree"])
def test_model_to_cpp_byte_equal_and_compiles(jax_ref, tmp_path, case):
    from lightgbm_tpu.models.codegen import model_to_cpp as ref_model_to_cpp
    from lightgbm_tpu.models.serialize import GBDTModel as RefModel

    params, train_set, X, rounds, n_out, atol = case()
    bst = lt.train({**params, "device_type": "cpu", "verbosity": -1}, train_set,
                   num_boost_round=rounds)
    text = bst.model_to_string()
    src = model_to_cpp(GBDTModel.from_string(text))
    assert src == ref_model_to_cpp(RefModel.from_string(text))
    lib = compile_model(src, tmp_path, "model")
    native = predict_native(lib, X, n_out)
    want = bst.predict(X).reshape(len(X), n_out)
    np.testing.assert_allclose(native, want, rtol=1e-5, atol=atol)
    assert lib.NumPredictionOutputs() == n_out
