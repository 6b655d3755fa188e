"""The C API (`capi/lgbm_capi.c` over `capi/impl.py`) driven as a C client
drives it: ctypes calls the exported LGBM_* symbols of the library g++
builds at first use, in this process; one test links a C program against
it. The workflow is the JAX package's tests/test_capi.py: CreateFromMat ->
SetField -> BoosterCreate -> UpdateOneIter -> PredictForMat -> SaveModel ->
CreateFromModelfile, the model-string round trip and the predict types,
CSR against dense rows, error reporting.

Contracts: the header declares the JAX package's DECLS
(capi/build_capi.py) word for word and the library exports each of them;
every answer through the C API is bit-equal to the same call on the
Booster (and CSR to dense rows); a model through SaveModel and
CreateFromModelfile predicts bit-equal; errors return -1 with the message
in LGBM_GetLastError; the streaming handles push rows that train
(tests/test_torch_capi_streaming.py holds them to the Python route).
Boosters loaded from a model name no device, so the tests that load one
stand the CPU in for the card (`resolve_device`).
"""
import ctypes
import os
import subprocess

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import basic, capi
from tests.test_torch_ref import jax_ref  # noqa: F401

CPU_PARAMS = b"objective=binary num_leaves=15 verbosity=-1 device_type=cpu"
DOUBLE_P = ctypes.POINTER(ctypes.c_double)


@pytest.fixture(scope="module")
def lib():
    return capi.load()


@pytest.fixture
def cpu_as_card(monkeypatch):
    monkeypatch.setattr(basic, "resolve_device", lambda device_type: torch.device("cpu"))


def _check(lib, ret):
    assert ret == 0, lib.LGBM_GetLastError().decode()


def _data(seed=0, n=600, f=6):
    rng = np.random.RandomState(seed)
    X = np.ascontiguousarray(rng.randn(n, f))
    y = (X[:, 0] - X[:, 1] > 0).astype(np.float32)
    return X, y


def _dataset(lib, X, y, params=b"max_bin=63 device_type=cpu"):
    ds = ctypes.c_void_p()
    _check(lib, lib.LGBM_DatasetCreateFromMat(X.ctypes.data, 1, X.shape[0], X.shape[1], 1,
                                              params, None, ctypes.byref(ds)))
    _check(lib, lib.LGBM_DatasetSetField(ds, b"label", y.ctypes.data, len(y), 0))
    return ds


def _booster(lib, ds, rounds, params=CPU_PARAMS):
    bst = ctypes.c_void_p()
    _check(lib, lib.LGBM_BoosterCreate(ds, params, ctypes.byref(bst)))
    fin = ctypes.c_int()
    for _ in range(rounds):
        _check(lib, lib.LGBM_BoosterUpdateOneIter(bst, ctypes.byref(fin)))
    return bst


def _predict(lib, bst, X, predict_type=0, width=1):
    out = np.zeros(X.shape[0] * width)
    n = ctypes.c_int64()
    _check(lib, lib.LGBM_BoosterPredictForMat(bst, X.ctypes.data, 1, X.shape[0], X.shape[1],
                                              1, predict_type, 0, -1, b"", ctypes.byref(n),
                                              out.ctypes.data_as(DOUBLE_P)))
    assert n.value == out.size
    return out


def test_header_declares_the_jax_surface(jax_ref, lib):
    from lightgbm_tpu.capi.build_capi import DECLS

    assert capi.declarations() == DECLS
    sigs = capi.signatures()
    assert len(sigs) == 23 and all(name in DECLS for name in sigs)
    for name in sigs:
        assert getattr(lib, name)  # exported


def test_end_to_end(lib, tmp_path, cpu_as_card):
    X, y = _data()
    ds = _dataset(lib, X, y)
    nd, nf = ctypes.c_int32(), ctypes.c_int32()
    _check(lib, lib.LGBM_DatasetGetNumData(ds, ctypes.byref(nd)))
    _check(lib, lib.LGBM_DatasetGetNumFeature(ds, ctypes.byref(nf)))
    assert (nd.value, nf.value) == X.shape
    bst = _booster(lib, ds, 10)
    it, total = ctypes.c_int(), ctypes.c_int()
    _check(lib, lib.LGBM_BoosterGetCurrentIteration(bst, ctypes.byref(it)))
    _check(lib, lib.LGBM_BoosterNumberOfTotalModel(bst, ctypes.byref(total)))
    assert it.value == 10 and total.value == 10
    preds = _predict(lib, bst, X)
    want = lt.train({"objective": "binary", "num_leaves": 15, "verbosity": -1,
                     "device_type": "cpu", "max_bin": 63},
                    lt.Dataset(X, label=y), num_boost_round=10)
    np.testing.assert_array_equal(preds, want.predict(X))
    assert ((preds > 0.5) == y).mean() > 0.9

    model_file = str(tmp_path / "capi_model.txt").encode()
    _check(lib, lib.LGBM_BoosterSaveModel(bst, 0, -1, 0, model_file))
    nit, bst2 = ctypes.c_int(), ctypes.c_void_p()
    _check(lib, lib.LGBM_BoosterCreateFromModelfile(model_file, ctypes.byref(nit),
                                                    ctypes.byref(bst2)))
    assert nit.value == 10
    np.testing.assert_array_equal(_predict(lib, bst2, X), preds)
    for h in (bst, bst2):
        _check(lib, lib.LGBM_BoosterFree(h))
    _check(lib, lib.LGBM_DatasetFree(ds))


def test_model_string_round_trip_and_predict_types(lib, cpu_as_card):
    X, y = _data(1, n=400, f=5)
    ds = _dataset(lib, X, y)
    bst = _booster(lib, ds, 5, b"objective=binary num_leaves=7 verbosity=-1 device_type=cpu")
    out_len = ctypes.c_int64()
    _check(lib, lib.LGBM_BoosterSaveModelToString(bst, 0, -1, 0, 8, ctypes.byref(out_len),
                                                  ctypes.create_string_buffer(8)))
    size = out_len.value
    buf = ctypes.create_string_buffer(size)
    _check(lib, lib.LGBM_BoosterSaveModelToString(bst, 0, -1, 0, size,
                                                  ctypes.byref(out_len), buf))
    model_str = buf.value
    assert model_str.startswith(b"tree") and len(model_str) + 1 == size
    nit, bst2 = ctypes.c_int(), ctypes.c_void_p()
    _check(lib, lib.LGBM_BoosterLoadModelFromString(model_str, ctypes.byref(nit),
                                                    ctypes.byref(bst2)))
    assert nit.value == 5
    ref = lt.Booster(model_str=model_str.decode(), params={"device_type": "cpu"})
    n, f = X.shape
    np.testing.assert_array_equal(_predict(lib, bst2, X, 1), ref.predict(X, raw_score=True))
    np.testing.assert_array_equal(_predict(lib, bst2, X, 2, 5),
                                  ref.predict(X, pred_leaf=True).ravel())
    contrib = _predict(lib, bst2, X, 3, f + 1)
    np.testing.assert_array_equal(contrib, ref.predict(X, pred_contrib=True).ravel())
    np.testing.assert_allclose(contrib.reshape(n, f + 1).sum(axis=1),
                               ref.predict(X, raw_score=True), rtol=1e-5, atol=1e-6)
    classes = ctypes.c_int()
    _check(lib, lib.LGBM_BoosterGetNumClasses(bst2, ctypes.byref(classes)))
    assert classes.value == 1


def test_create_from_file_with_valid_data(lib, tmp_path):
    X, y = _data(2, n=800)
    path = str(tmp_path / "train.tsv")
    np.savetxt(path, np.column_stack([y, X]), delimiter="\t", fmt="%.17g")
    np.savetxt(path + ".weight", np.linspace(0.5, 2.0, len(y)), fmt="%.17g")
    ds, valid = ctypes.c_void_p(), ctypes.c_void_p()
    _check(lib, lib.LGBM_DatasetCreateFromFile(path.encode(), b"device_type=cpu", None,
                                               ctypes.byref(ds)))
    _check(lib, lib.LGBM_DatasetCreateFromMat(X[:200].ctypes.data, 1, 200, X.shape[1], 1,
                                              b"device_type=cpu", ds, ctypes.byref(valid)))
    _check(lib, lib.LGBM_DatasetSetField(valid, b"label", y[:200].ctypes.data, 200, 0))
    bst = _booster(lib, ds, 3)
    _check(lib, lib.LGBM_BoosterAddValidData(bst, valid))
    want = lt.train({"objective": "binary", "num_leaves": 15, "verbosity": -1,
                     "device_type": "cpu"}, lt.Dataset(path), num_boost_round=3)
    np.testing.assert_array_equal(_predict(lib, bst, X), want.predict(X))


def test_predict_for_csr_matches_mat(lib):
    rng = np.random.RandomState(3)
    n, f = 300, 5
    X = rng.randn(n, f)
    X[rng.rand(n, f) < 0.4] = 0.0
    X = np.ascontiguousarray(X)
    ds = _dataset(lib, X, (X[:, 0] > 0).astype(np.float32))
    bst = _booster(lib, ds, 5, b"objective=binary num_leaves=7 verbosity=-1 device_type=cpu")
    dense = _predict(lib, bst, X)
    rows, cols = np.nonzero(X)
    values = np.ascontiguousarray(X[rows, cols])
    indices = np.ascontiguousarray(cols, dtype=np.int32)
    for ip_type, ip_dtype in ((2, np.int32), (3, np.int64)):
        indptr = np.concatenate([[0], np.cumsum(np.bincount(rows, minlength=n))]).astype(
            ip_dtype)
        out, out_len = np.zeros(n), ctypes.c_int64()
        _check(lib, lib.LGBM_BoosterPredictForCSR(
            bst, indptr.ctypes.data, ip_type, indices.ctypes.data, values.ctypes.data, 1,
            indptr.size, values.size, f, 0, 0, -1, b"", ctypes.byref(out_len),
            out.ctypes.data_as(DOUBLE_P)))
        assert out_len.value == n
        np.testing.assert_array_equal(out, dense)
    ret = lib.LGBM_BoosterPredictForCSR(bst, indptr.ctypes.data, 0, indices.ctypes.data,
                                        values.ctypes.data, 1, indptr.size, values.size, f,
                                        0, 0, -1, b"", ctypes.byref(out_len),
                                        out.ctypes.data_as(DOUBLE_P))
    assert ret == -1 and b"indptr_type" in lib.LGBM_GetLastError()


def test_error_reporting(lib):
    out = ctypes.c_int32()
    assert lib.LGBM_DatasetGetNumData(ctypes.c_void_p(999999), ctypes.byref(out)) == -1
    assert b"invalid handle" in lib.LGBM_GetLastError()
    ds = ctypes.c_void_p()  # a Dataset is constructed at first use, as in JAX
    _check(lib, lib.LGBM_DatasetCreateFromFile(b"/nonexistent/data.tsv", b"", None,
                                               ctypes.byref(ds)))
    assert lib.LGBM_DatasetGetNumData(ds, ctypes.byref(out)) == -1
    assert b"No such file" in lib.LGBM_GetLastError()


def test_streaming_handles_push_rows_that_train(lib):
    X, y = _data(n=300)
    ds = ctypes.c_void_p()
    _check(lib, lib.LGBM_DatasetCreateStreaming(X.shape[1], b"", ctypes.byref(ds)))
    _check(lib, lib.LGBM_DatasetPushRows(ds, X.ctypes.data, 1, 300, X.shape[1], 0))
    _check(lib, lib.LGBM_DatasetSetField(ds, b"label", y.ctypes.data, len(y), 0))
    bst = _booster(lib, ds, 2)
    it = ctypes.c_int()
    _check(lib, lib.LGBM_BoosterGetCurrentIteration(bst, ctypes.byref(it)))
    assert it.value == 2
    _check(lib, lib.LGBM_BoosterFree(bst))
    _check(lib, lib.LGBM_DatasetFree(ds))


def test_a_c_program_starts_python(lib, tmp_path):
    """Linked into a C program, the first call starts Python and imports
    the package from the repository root baked in at build time."""
    src = tmp_path / "prog.c"
    src.write_text(r'''
#include <stdio.h>
#include "lightgbm_tpu_torch_c.h"
int main(void) {
  enum { N = 300, F = 3 };
  static double X[N * F]; static float y[N]; static double out[N];
  unsigned s = 1;
  for (int i = 0; i < N * F; ++i) { s = s * 1103515245u + 12345u;
                                    X[i] = ((s >> 8) % 2000) / 1000.0 - 1.0; }
  for (int i = 0; i < N; ++i) y[i] = X[i * F] > 0;
  DatasetHandle ds; BoosterHandle bst; int fin; int64_t n;
  if (LGBM_DatasetCreateFromMat(X, C_API_DTYPE_FLOAT64, N, F, 1, "device_type=cpu", 0, &ds)
      || LGBM_DatasetSetField(ds, "label", y, N, C_API_DTYPE_FLOAT32)
      || LGBM_BoosterCreate(ds, "objective=binary num_leaves=7 device_type=cpu verbosity=-1",
                            &bst)
      || LGBM_BoosterUpdateOneIter(bst, &fin) || LGBM_BoosterUpdateOneIter(bst, &fin)
      || LGBM_BoosterPredictForMat(bst, X, C_API_DTYPE_FLOAT64, N, F, 1, 1, 0, -1, "", &n,
                                   out)) {
    printf("error %s\n", LGBM_GetLastError());
    return 1;
  }
  for (int i = 0; i < 4; ++i) printf("%.17g\n", out[i]);
  return 0;
}
''')
    so = capi.library_path()
    exe = tmp_path / "prog"
    subprocess.run(["gcc", f"-I{capi.HEADER.parent}", str(src), "-o", str(exe), str(so),
                    f"-Wl,-rpath,{so.parent}"], check=True, capture_output=True)
    run = subprocess.run([str(exe)], capture_output=True, text=True, cwd=str(tmp_path),
                         env={**os.environ, "OMP_NUM_THREADS": "1"}, timeout=300)
    assert run.returncode == 0, run.stdout + run.stderr
    got = np.array(run.stdout.split()[-4:], dtype=np.float64)
    s, vals = 1, []
    for _ in range(300 * 3):
        s = (s * 1103515245 + 12345) % 2**32
        vals.append(((s >> 8) % 2000) / 1000.0 - 1.0)
    X = np.array(vals).reshape(300, 3)
    bst = lt.train({"objective": "binary", "num_leaves": 7, "verbosity": -1,
                    "device_type": "cpu"}, lt.Dataset(X, label=(X[:, 0] > 0).astype(float)),
                   num_boost_round=2)
    np.testing.assert_array_equal(got, bst.predict(X[:4], raw_score=True))


def test_nothing_imports_cffi():
    import ast
    from pathlib import Path

    package = Path(lt.__file__).parent
    for path in package.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            assert not [n for n in names if n.split(".")[0] == "cffi"], path
