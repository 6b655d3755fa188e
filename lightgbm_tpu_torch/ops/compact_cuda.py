"""Wrapper of the CUDA row-compaction kernel (csrc/compact.cu).

The kernel replaces ``lightgbm_tpu/ops/compact_pallas.py:compact_rows``
(its Pallas call ``_pallas_compact_call`` and kernel
``_make_compact_kernel``); the note at the top of the source gives its
design and bound. It is built and loaded by ``ops/cuda_build.py``.

Dispatch is by the device of the bin plane alone: a CPU tensor takes the
plain version (``ops/compact.py:_compact_rows_plain``); a CUDA tensor
launches the kernel, or raises. There is no fallback from one to the other.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .compact import _compact_rows_plain
from .cuda_build import CudaLibrary, require_cuda, stream_of


def _declare(lib: ctypes.CDLL) -> None:
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.lgbt_compact_rows.argtypes = [ptr, ptr, ptr, i64, i32, i32, ptr, ptr, ptr]
    lib.lgbt_compact_rows.restype = i32


LIB = CudaLibrary("compact.cu", ("compact_rows",), _declare)
launches = LIB.launches
reset_launches = LIB.reset_launches


def compact(bins: torch.Tensor, row_p: torch.Tensor, dst: torch.Tensor,
            out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(bins [G, N] uint8, row_p [N, rc] float32) permuted by dst [N] int32
    (ops/compact.py:compact_rows). A CPU tensor takes the plain version; a
    CUDA tensor launches the kernel."""
    if bins.device.type == "cpu":
        return _compact_rows_plain(bins, row_p, dst, out)
    require_cuda(bins, "the row compaction")
    dev = bins.device
    if bins.dtype != torch.uint8 or bins.dim() != 2 or not bins.is_contiguous():
        raise ValueError(f"the compaction kernel takes a contiguous [G, N] uint8 "
                         f"bin plane, got {bins.dtype} {list(bins.shape)}")
    G, N = bins.shape
    if row_p.dtype != torch.float32 or row_p.dim() != 2 or row_p.shape[0] != N \
            or row_p.device != dev or not row_p.is_contiguous():
        raise ValueError(f"row_p must be a contiguous float32 [N, rc] tensor on "
                         f"{dev} with N = {N}, got {row_p.dtype} "
                         f"{list(row_p.shape)} on {row_p.device}")
    if dst.dtype != torch.int32 or tuple(dst.shape) != (N,) or dst.device != dev \
            or not dst.is_contiguous():
        raise ValueError(f"dst must be a contiguous int32 [{N}] tensor on {dev}, "
                         f"got {dst.dtype} {list(dst.shape)} on {dst.device}")
    if out is None:
        out = (torch.empty_like(bins), torch.empty_like(row_p))
    bins_o, row_o = out
    for name, t, ref in (("out bins", bins_o, bins), ("out rows", row_o, row_p)):
        if t.dtype != ref.dtype or t.shape != ref.shape or t.device != dev \
                or not t.is_contiguous():
            raise ValueError(f"{name} must match its input's dtype, shape and device")
        if t.data_ptr() == ref.data_ptr():
            raise ValueError(f"{name} must not alias its input: the kernel moves "
                             "rows out of place")
    if N == 0:
        return bins_o, row_o
    lib = LIB.load()
    with torch.cuda.device(dev):
        err = lib.lgbt_compact_rows(bins.data_ptr(), row_p.data_ptr(), dst.data_ptr(),
                                    N, G, row_p.shape[1], bins_o.data_ptr(),
                                    row_o.data_ptr(), stream_of(bins))
    LIB.count("compact_rows", err)
    return bins_o, row_o
