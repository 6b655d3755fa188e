"""Python implementations behind the exported LGBM_* symbols.

Counterpart of the JAX package's ``capi/impl.py``: each function has the
contract of its namesake in the reference's src/c_api.cpp and is called by
``lgbm_capi.c`` with every pointer as an integer. Buffers are viewed
through ctypes and numpy; out-parameters are written through their
addresses. A function returns 0, or -1 with the exception's message kept
for LGBM_GetLastError (per thread, like c_api.cpp's thread_local).
Handles are integers into a process-wide registry of the package's
Dataset and Booster objects.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import Any, Dict

import numpy as np

from ..basic import Booster, Dataset

_lock = threading.RLock()
_handles: Dict[int, Any] = {}
_next_handle = [1]
_last_error = threading.local()

_DTYPES = {0: np.float32, 1: np.float64, 2: np.int32, 3: np.int64}


def set_last_error(msg: str) -> int:
    _last_error.msg = msg
    return -1


def last_error() -> str:
    return getattr(_last_error, "msg", "ok")


def _entry(fn):
    """A C entry point: 0 on success; on an exception -1, its message kept."""

    @functools.wraps(fn)
    def call(*args):
        try:
            fn(*args)
            return 0
        except Exception as e:  # noqa: BLE001 - the C boundary
            return set_last_error(f"{type(e).__name__}: {e}")

    return call


def _register(obj) -> int:
    with _lock:
        h = _next_handle[0]
        _next_handle[0] += 1
        _handles[h] = obj
    return h


def _get(handle: int):
    obj = _handles.get(int(handle))
    if obj is None:
        raise KeyError(f"invalid handle {handle}")
    return obj


def _string(ptr: int) -> str:
    return ctypes.string_at(ptr).decode() if ptr else ""


def _array(ptr: int, dtype, n: int) -> np.ndarray:
    """A copy of n values of `dtype` at address `ptr`."""
    dtype = np.dtype(dtype)
    buf = (ctypes.c_char * (int(n) * dtype.itemsize)).from_address(ptr)
    return np.frombuffer(buf, dtype=dtype).copy()


def _dtype(data_type: int):
    dt = _DTYPES.get(int(data_type))
    if dt is None:
        raise ValueError(f"unknown C_API_DTYPE {data_type}")
    return dt


def _write(ptr: int, ctype, value) -> None:
    ctype.from_address(ptr).value = value


def _parse_params(parameters: str) -> dict:
    """'key=value key2=val2' (c_api.cpp Config::Str2Map format)."""
    out = {}
    for tok in (parameters or "").replace("\n", " ").split():
        if "=" in tok:
            k, v = tok.split("=", 1)
            out[k] = v
    return out


def _mat(data, data_type, nrow, ncol, is_row_major) -> np.ndarray:
    arr = _array(data, _dtype(data_type), int(nrow) * int(ncol))
    if is_row_major:
        return arr.reshape(int(nrow), int(ncol))
    return arr.reshape(int(ncol), int(nrow)).T


def _csr(indptr, indptr_type, indices, data, data_type, nindptr, nelem, num_col) -> np.ndarray:
    """The CSR rows densified: absent entries are 0.0 (the reference's
    zero convention; zero_as_missing maps them later, in the bin mapper)."""
    ip_dt = _DTYPES.get(int(indptr_type))
    if ip_dt not in (np.int32, np.int64):
        raise ValueError(f"indptr_type must be int32/int64, got {indptr_type}")
    ip = _array(indptr, ip_dt, nindptr)
    idx = _array(indices, np.int32, nelem)
    values = _array(data, _dtype(data_type), nelem)
    nrow = int(nindptr) - 1
    X = np.zeros((nrow, int(num_col)), dtype=np.float64)
    for r in range(nrow):
        lo, hi = int(ip[r]), int(ip[r + 1])
        X[r, idx[lo:hi]] = values[lo:hi]
    return X


# ---- Dataset ----------------------------------------------------------------

@_entry
def dataset_create_from_mat(data, data_type, nrow, ncol, is_row_major, parameters,
                            reference, out):
    X = _mat(data, data_type, nrow, ncol, is_row_major)
    ds = Dataset(X, params=_parse_params(_string(parameters)),
                 reference=_get(reference) if reference else None, free_raw_data=False)
    _write(out, ctypes.c_void_p, _register(ds))


@_entry
def dataset_create_from_file(filename, parameters, reference, out):
    ds = Dataset(_string(filename), params=_parse_params(_string(parameters)),
                 reference=_get(reference) if reference else None, free_raw_data=False)
    _write(out, ctypes.c_void_p, _register(ds))


@_entry
def dataset_set_field(handle, field_name, field_data, num_element, data_type):
    """Field names as c_api.cpp LGBM_DatasetSetField / Metadata::SetField
    route them (label, weight, group or query, init_score, position)."""
    ds = _get(handle)
    name = _string(field_name)
    values = _array(field_data, _dtype(data_type), num_element)
    setters = {"label": ds.set_label, "weight": ds.set_weight, "group": ds.set_group,
               "query": ds.set_group, "init_score": ds.set_init_score,
               "position": ds.set_position}
    if name not in setters:
        raise ValueError(f"unknown field name {name!r}")
    setters[name](values)


@_entry
def dataset_get_num_data(handle, out):
    _write(out, ctypes.c_int32, int(_get(handle).num_data()))


@_entry
def dataset_get_num_feature(handle, out):
    _write(out, ctypes.c_int32, int(_get(handle).num_feature()))


@_entry
def dataset_free(handle):
    _handles.pop(int(handle), None)


# ---- Streaming dataset --------------------------------------------------------
# LGBM_DatasetPushRows / LGBM_DatasetPushRowsByCSR (c_api.cpp): a streaming
# handle is a RowBlockStore (streaming/ingest.py), which has the Dataset
# surface that LGBM_DatasetSetField, LGBM_DatasetGetNumData and
# LGBM_DatasetGetNumFeature call; LGBM_BoosterCreate finalizes the store.

@_entry
def dataset_create_streaming(ncol, parameters, out):
    """Open a push-rows dataset. It stands in for the reference's
    CreateByReference / CreateFromSampledColumn: the bin layout is fitted on
    the pushed sample prefix instead of a donor dataset."""
    from ..streaming.ingest import RowBlockStore

    store = RowBlockStore(params=_parse_params(_string(parameters)),
                          n_features=int(ncol) if int(ncol) > 0 else None)
    _write(out, ctypes.c_void_p, _register(store))


def _as_store(handle):
    from ..streaming.ingest import RowBlockStore

    obj = _get(handle)
    if not isinstance(obj, RowBlockStore):
        raise TypeError("handle is not a streaming dataset (LGBM_DatasetCreateStreaming)")
    return obj


def _check_start_row(store, start_row) -> None:
    # the reference writes blocks at any offset from parallel pushers; the
    # sequential contract is kept explicit here, as in the JAX package
    if int(start_row) != store.total_rows:
        raise ValueError(f"non-sequential push: start_row={int(start_row)} but "
                         f"{store.total_rows} rows are already pushed")


@_entry
def dataset_push_rows(handle, data, data_type, nrow, ncol, start_row):
    store = _as_store(handle)
    _check_start_row(store, start_row)
    store.push_rows(_mat(data, data_type, nrow, ncol, 1))  # row-major ABI


@_entry
def dataset_push_rows_by_csr(handle, indptr, indptr_type, indices, data, data_type, nindptr,
                             nelem, num_col, start_row):
    store = _as_store(handle)
    _check_start_row(store, start_row)
    ip_dt = _DTYPES.get(int(indptr_type))
    if ip_dt not in (np.int32, np.int64):
        raise ValueError(f"indptr_type must be int32/int64, got {indptr_type}")
    store.push_csr(_array(indptr, ip_dt, nindptr), _array(indices, np.int32, nelem),
                   _array(data, _dtype(data_type), nelem), int(num_col))


def _as_train_set(obj, params):
    """A streaming store handed to BoosterCreate finalizes here, the moment
    the reference reaches inside LGBM_BoosterCreate through
    Dataset::FinishLoad."""
    from ..streaming.ingest import RowBlockStore

    if isinstance(obj, RowBlockStore):
        return obj.to_basic_dataset(params=params)
    return obj


# ---- Booster ----------------------------------------------------------------

@_entry
def booster_create(train_data, parameters, out):
    params = _parse_params(_string(parameters))
    bst = Booster(params=params, train_set=_as_train_set(_get(train_data), params))
    _write(out, ctypes.c_void_p, _register(bst))


@_entry
def booster_add_valid_data(handle, valid_data):
    bst = _get(handle)
    bst.add_valid(_get(valid_data), f"valid_{len(bst.name_valid_sets) + 1}")


def _load_booster(out_num_iterations, out, **source):
    bst = Booster(**source)
    _write(out_num_iterations, ctypes.c_int, int(bst.current_iteration()))
    _write(out, ctypes.c_void_p, _register(bst))


@_entry
def booster_create_from_modelfile(filename, out_num_iterations, out):
    _load_booster(out_num_iterations, out, model_file=_string(filename))


@_entry
def booster_load_model_from_string(model_str, out_num_iterations, out):
    _load_booster(out_num_iterations, out, model_str=_string(model_str))


def _importance(importance_type) -> str:
    return "split" if int(importance_type) == 0 else "gain"


@_entry
def booster_save_model(handle, start_iteration, num_iteration, importance_type, filename):
    _get(handle).save_model(_string(filename), num_iteration=int(num_iteration),
                            start_iteration=int(start_iteration),
                            importance_type=_importance(importance_type))


@_entry
def booster_save_model_to_string(handle, start_iteration, num_iteration, importance_type,
                                 buffer_len, out_len, out_str):
    s = _get(handle).model_to_string(
        num_iteration=int(num_iteration), start_iteration=int(start_iteration),
        importance_type=_importance(importance_type)).encode()
    _write(out_len, ctypes.c_int64, len(s) + 1)
    if int(buffer_len) >= len(s) + 1:
        ctypes.memmove(out_str, s + b"\0", len(s) + 1)


@_entry
def booster_update_one_iter(handle, is_finished):
    _write(is_finished, ctypes.c_int, 1 if _get(handle).update() else 0)


@_entry
def booster_get_current_iteration(handle, out_iteration):
    _write(out_iteration, ctypes.c_int, int(_get(handle).current_iteration()))


@_entry
def booster_get_num_classes(handle, out_len):
    _write(out_len, ctypes.c_int, int(_get(handle).num_model_per_iteration()))


@_entry
def booster_number_of_total_model(handle, out_models):
    _write(out_models, ctypes.c_int, int(_get(handle).num_trees()))


def _predict_into(bst, X, predict_type, start_iteration, num_iteration, parameter, out_len,
                  out_result) -> None:
    """Booster.predict of X into the caller's buffer; prediction options
    travel in the parameter string (LGBM_BoosterPredictForMat parses it
    with Config::Str2Map)."""
    pt = int(predict_type)
    pred = bst.predict(X, raw_score=pt == 1, pred_leaf=pt == 2, pred_contrib=pt == 3,
                       start_iteration=int(start_iteration), num_iteration=int(num_iteration),
                       **_parse_params(_string(parameter)))
    flat = np.ascontiguousarray(pred, dtype=np.float64).ravel()
    _write(out_len, ctypes.c_int64, flat.size)
    ctypes.memmove(out_result, flat.ctypes.data, flat.nbytes)


@_entry
def booster_predict_for_mat(handle, data, data_type, nrow, ncol, is_row_major, predict_type,
                            start_iteration, num_iteration, parameter, out_len, out_result):
    X = _mat(data, data_type, nrow, ncol, is_row_major)
    _predict_into(_get(handle), X, predict_type, start_iteration, num_iteration, parameter,
                  out_len, out_result)


@_entry
def booster_predict_for_csr(handle, indptr, indptr_type, indices, data, data_type, nindptr,
                            nelem, num_col, predict_type, start_iteration, num_iteration,
                            parameter, out_len, out_result):
    # densified, then the same Booster.predict as the ForMat entry, so both
    # surfaces answer bit-identically
    X = _csr(indptr, indptr_type, indices, data, data_type, nindptr, nelem, num_col)
    _predict_into(_get(handle), X, predict_type, start_iteration, num_iteration, parameter,
                  out_len, out_result)


@_entry
def booster_free(handle):
    _handles.pop(int(handle), None)
