"""Wrapper of the CUDA forest-traversal kernel (csrc/predict_forest.cu).

The kernel replaces ``lightgbm_tpu/ops/predict_pallas.py:pallas_predict_raw``
(see the note at the top of the source for its design and its bound on the
H100). It is written in CUDA C++ for ``sm_90a`` and built and loaded by
``ops/cuda_build.py``.

Dispatch is by the device of the input alone: a tensor on the CPU takes the
plain PyTorch version in ``ops/predict.py``; a CUDA tensor launches the
kernel, or raises. There is no fallback from one to the other.

Each wrapper counts its launches in `launches`, so a run can show that its
predictions went through the kernel.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .cuda_build import CudaLibrary, require_cuda, stream_of
from .predict import TABLES, PackedEnsemble, _predict_raw_fused, _traverse_leaves


def _declare(lib: ctypes.CDLL) -> None:
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    head = [ptr, i64, i32] + [ptr] * 10 + [i32] * 4
    lib.lgbt_predict_forest_raw.argtypes = head + [i32, ptr, ptr]
    lib.lgbt_predict_forest_leaf.argtypes = head + [ptr, ptr]
    lib.lgbt_predict_forest_raw.restype = i32
    lib.lgbt_predict_forest_leaf.restype = i32


LIB = CudaLibrary("predict_forest.cu", ("predict_forest_raw", "predict_forest_leaf"),
                  _declare)
SOURCE = LIB.source
launches = LIB.launches
reset_launches = LIB.reset_launches
build = LIB.build


def _check(packed: PackedEnsemble, X: torch.Tensor) -> None:
    if X.dim() != 2 or X.dtype != torch.float32 or not X.is_contiguous():
        raise ValueError(f"X must be a contiguous 2-D float32 tensor, got "
                         f"{X.dtype} {tuple(X.shape)}")
    if X.shape[1] < packed.num_features:
        raise ValueError(f"X has {X.shape[1]} columns; the model splits on "
                         f"feature {packed.num_features - 1}")
    want = {"threshold": torch.float32, "leaf_value": torch.float32}
    for name, t in zip(TABLES, packed.tables()):
        if t.device != X.device or t.dtype != want.get(name, torch.int32) \
                or not t.is_contiguous():
            raise ValueError(f"packed table {name} must be a contiguous "
                             f"{want.get(name, torch.int32)} tensor on "
                             f"{X.device}, got {t.dtype} on {t.device}")


def _args(packed: PackedEnsemble, X: torch.Tensor) -> list:
    T, I = packed.split_feature.shape
    L = packed.leaf_value.shape[1]
    return ([X.data_ptr(), X.shape[0], X.shape[1]]
            + [t.data_ptr() for t in packed.tables()]
            + [T, I, L, packed.max_depth])


def forest_raw(packed: PackedEnsemble, X: torch.Tensor, num_tree_per_iteration: int,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Raw scores [N, C] float32 (C = num_tree_per_iteration), each class
    summing its trees in ascending iteration order. A CPU tensor takes the
    plain version; a CUDA tensor launches the kernel."""
    C = num_tree_per_iteration
    if X.device.type == "cpu":
        res = _predict_raw_fused(packed, X, C)
        return res if out is None else out.copy_(res)
    require_cuda(X, "the forest traversal")
    _check(packed, X)
    n = X.shape[0]
    if out is None:
        out = torch.empty((n, C), dtype=torch.float32, device=X.device)
    elif out.shape != (n, C) or out.dtype != torch.float32 \
            or out.device != X.device or not out.is_contiguous():
        raise ValueError(f"out must be a contiguous float32 [{n}, {C}] tensor "
                         f"on {X.device}")
    if n == 0:
        return out
    lib = LIB.load()
    with torch.cuda.device(X.device):
        err = lib.lgbt_predict_forest_raw(*_args(packed, X), C, out.data_ptr(),
                                          stream_of(X))
    LIB.count("predict_forest_raw", err)
    return out


def forest_leaf_indices(packed: PackedEnsemble, X: torch.Tensor) -> torch.Tensor:
    """Leaf indices [N, T] int32. A CPU tensor takes the plain version; a
    CUDA tensor launches the kernel."""
    if X.device.type == "cpu":
        return _traverse_leaves(packed, X)
    require_cuda(X, "the forest traversal")
    _check(packed, X)
    n, T = X.shape[0], packed.split_feature.shape[0]
    out = torch.empty((n, T), dtype=torch.int32, device=X.device)
    if n == 0:
        return out
    lib = LIB.load()
    with torch.cuda.device(X.device):
        err = lib.lgbt_predict_forest_leaf(*_args(packed, X), out.data_ptr(),
                                           stream_of(X))
    LIB.count("predict_forest_leaf", err)
    return out
