"""The C API's streaming handles (LGBM_DatasetCreateStreaming,
LGBM_DatasetPushRows, LGBM_DatasetPushRowsByCSR over capi/impl.py and
streaming/ingest.py) driven through ctypes as a C client drives them.

Contracts: pushed rows (dense float64 and float32, CSR) with SetField's
label train, through BoosterCreate and UpdateOneIter, the model text of
`engine.train` on a RowBlockStore fed the same blocks; GetNumData and
GetNumFeature read the store; a push whose start_row is not the rows pushed
so far fails with its message in LGBM_GetLastError, as does a push into a
handle that is not a streaming dataset.
"""
import ctypes

import numpy as np
import pytest

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import capi
from lightgbm_tpu_torch.streaming import RowBlockStore

PARAMS = b"objective=binary num_leaves=15 verbosity=-1 device_type=cpu num_iterations=3"


@pytest.fixture(scope="module")
def lib():
    return capi.load()


def _check(lib, ret):
    assert ret == 0, lib.LGBM_GetLastError().decode()


def _data(seed=0, n=600, f=8):
    rng = np.random.RandomState(seed)
    X = np.ascontiguousarray(rng.randn(n, f))
    X[X < -1.0] = 0.0
    y = (X[:, 0] - X[:, 1] > 0).astype(np.float32)
    return X, y


def _csr(M):
    indptr, indices, values = [0], [], []
    for row in M:
        nz = np.flatnonzero(row)
        indices.extend(nz.tolist())
        values.extend(row[nz].tolist())
        indptr.append(len(indices))
    return (np.asarray(indptr, np.int64), np.asarray(indices, np.int32),
            np.asarray(values, np.float64))


def _push_csr(lib, ds, M, start_row):
    ip, ix, vals = _csr(M)
    return lib.LGBM_DatasetPushRowsByCSR(ds, ip.ctypes.data, 3, ix.ctypes.data, vals.ctypes.data,
                                         1, len(ip), len(vals), M.shape[1], start_row)


def _model_text(lib, bst):
    n = ctypes.c_int64()
    _check(lib, lib.LGBM_BoosterSaveModelToString(bst, 0, -1, 0, 0, ctypes.byref(n), None))
    buf = ctypes.create_string_buffer(n.value)
    _check(lib, lib.LGBM_BoosterSaveModelToString(bst, 0, -1, 0, n.value, ctypes.byref(n), buf))
    return buf.value.decode()


@pytest.mark.parametrize("ncol", [0, 8])
def test_pushed_rows_train_the_python_routes_model(lib, ncol):
    X, y = _data()
    X32 = np.ascontiguousarray(X[200:400], dtype=np.float32)
    ds = ctypes.c_void_p()
    _check(lib, lib.LGBM_DatasetCreateStreaming(ncol, b"verbosity=-1", ctypes.byref(ds)))
    _check(lib, lib.LGBM_DatasetPushRows(ds, np.ascontiguousarray(X[:200]).ctypes.data, 1, 200,
                                         8, 0))
    _check(lib, lib.LGBM_DatasetPushRows(ds, X32.ctypes.data, 0, 200, 8, 200))
    _check(lib, _push_csr(lib, ds, X[400:], 400))
    _check(lib, lib.LGBM_DatasetSetField(ds, b"label", y.ctypes.data, len(y), 0))
    nd, nf = ctypes.c_int32(), ctypes.c_int32()
    _check(lib, lib.LGBM_DatasetGetNumData(ds, ctypes.byref(nd)))
    _check(lib, lib.LGBM_DatasetGetNumFeature(ds, ctypes.byref(nf)))
    assert (nd.value, nf.value) == (600, 8)
    bst = ctypes.c_void_p()
    _check(lib, lib.LGBM_BoosterCreate(ds, PARAMS, ctypes.byref(bst)))
    fin = ctypes.c_int()
    for _ in range(3):
        _check(lib, lib.LGBM_BoosterUpdateOneIter(bst, ctypes.byref(fin)))
    text = _model_text(lib, bst)
    _check(lib, lib.LGBM_BoosterFree(bst))
    _check(lib, lib.LGBM_DatasetFree(ds))

    store = RowBlockStore(params={"verbosity": -1})
    store.push_rows(X[:200]).push_rows(X32).push_csr(*_csr(X[400:]), 8)
    store.set_label(y)
    params = dict(tok.split("=") for tok in PARAMS.decode().split())
    direct = lt.train(params, store.to_basic_dataset(), num_boost_round=3)
    assert text == direct.model_to_string()


def test_non_sequential_push_fails_through_last_error(lib):
    X, _ = _data(n=100)
    ds = ctypes.c_void_p()
    _check(lib, lib.LGBM_DatasetCreateStreaming(8, b"", ctypes.byref(ds)))
    _check(lib, lib.LGBM_DatasetPushRows(ds, X.ctypes.data, 1, 100, 8, 0))
    assert lib.LGBM_DatasetPushRows(ds, X.ctypes.data, 1, 100, 8, 0) == -1
    assert b"non-sequential" in lib.LGBM_GetLastError()
    assert _push_csr(lib, ds, X[:10], 50) == -1
    assert b"start_row=50" in lib.LGBM_GetLastError()
    _check(lib, lib.LGBM_DatasetFree(ds))


def test_non_streaming_handle_is_rejected(lib):
    X, y = _data(n=100)
    ds = ctypes.c_void_p()
    _check(lib, lib.LGBM_DatasetCreateFromMat(X.ctypes.data, 1, 100, 8, 1, b"device_type=cpu",
                                              None, ctypes.byref(ds)))
    assert lib.LGBM_DatasetPushRows(ds, X.ctypes.data, 1, 100, 8, 0) == -1
    assert b"not a streaming dataset" in lib.LGBM_GetLastError()
    assert _push_csr(lib, ds, X, 0) == -1
    assert b"not a streaming dataset" in lib.LGBM_GetLastError()
    _check(lib, lib.LGBM_DatasetFree(ds))
