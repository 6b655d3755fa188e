"""Wrappers of the CUDA row-compaction kernels: `compact` (csrc/compact.cu,
a permutation applied as given) and `partition` / `relabel`
(csrc/wave_partition.cu, the wave learner's partition from its K-entry
tables, and its commit on the leaf-id column).

Both replace ``lightgbm_tpu/ops/compact_pallas.py:compact_rows`` (its
Pallas call ``_pallas_compact_call`` and kernel ``_make_compact_kernel``);
`partition` also the per-row glue around it. The notes at the top of the
sources give their designs and bounds. They are built and loaded by
``ops/cuda_build.py``.

Dispatch is by the device of the bin plane (the payload for `relabel`)
alone: a CPU tensor takes the plain version (``ops/compact.py``); a CUDA
tensor launches the kernels, or raises. There is no fallback from one to
the other.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .compact import (GROUP_BINS, _compact_rows_plain, _partition_wave_plain,
                      _relabel_rows_plain)
from .cuda_build import CudaLibrary, require_cuda, stream_of


def _declare(lib: ctypes.CDLL) -> None:
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.lgbt_compact_rows.argtypes = [ptr, ptr, ptr, i64, i32, i32, ptr, ptr, ptr]
    lib.lgbt_compact_rows.restype = i32


def _declare_wave(lib: ctypes.CDLL) -> None:
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.lgbt_partition_decide.argtypes = [ptr, ptr, i64, i32, i32, ptr, i32, ptr, ptr, i32,
                                          i32, ptr, ptr, ptr]
    lib.lgbt_partition_scan.argtypes = [ptr, i32, ptr, ptr, ptr, ptr, ptr, ptr]
    lib.lgbt_partition_scatter.argtypes = [ptr, ptr, i64, i32, i32, i32, ptr, i32, i32, i32,
                                           ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr]
    lib.lgbt_relabel_rows.argtypes = [ptr, i64, i32, i32, ptr, i32, ptr]
    for fn in (lib.lgbt_partition_decide, lib.lgbt_partition_scan,
               lib.lgbt_partition_scatter, lib.lgbt_relabel_rows):
        fn.restype = i32


LIB = CudaLibrary("compact.cu", ("compact_rows",), _declare)
WAVE_LIB = CudaLibrary("wave_partition.cu", ("partition_decide", "partition_scan",
                                             "partition_scatter", "relabel_rows"),
                       _declare_wave)
MAX_RANGES = 1024  # csrc/wave_partition.cu kMaxRanges
TILE_ROWS = 1024   # ... kTile
launches = LIB.launches
wave_launches = WAVE_LIB.launches


def reset_launches() -> None:
    LIB.reset_launches()
    WAVE_LIB.reset_launches()


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


def _check_vec(name: str, t: torch.Tensor, n: int, dev: torch.device,
               dtype: torch.dtype = torch.int32) -> None:
    if t.dtype != dtype or t.dim() != 1 or t.shape[0] < n or t.device != dev \
            or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {dtype} vector of at least {n} "
                         f"values on {dev}, got {t.dtype} {list(t.shape)} on {t.device}")


def partition(bins: torch.Tensor, row_p: torch.Tensor, leaf_col: int,
              leaf2k: Optional[torch.Tensor], rgroup: Optional[torch.Tensor],
              lut: Optional[torch.Tensor], starts: torch.Tensor, counts: torch.Tensor,
              valid: torch.Tensor, bagged: bool = False,
              out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              slot_out: Optional[torch.Tensor] = None):
    """The wave partition (ops/compact.py:partition_wave). A CPU tensor
    takes the plain version; a CUDA tensor launches the decide, scan and
    scatter passes."""
    if bins.device.type == "cpu":
        return _partition_wave_plain(bins, row_p, leaf_col, leaf2k, rgroup, lut, starts,
                                     counts, valid, bagged, out, slot_out)
    require_cuda(bins, "the wave partition")
    dev = bins.device
    if bins.dtype != torch.uint8 or bins.dim() != 2 or not bins.is_contiguous():
        raise ValueError(f"the partition takes a contiguous [G, N] uint8 bin plane, "
                         f"got {bins.dtype} {list(bins.shape)}")
    G, N = bins.shape
    if row_p.dtype != torch.float32 or row_p.dim() != 2 or row_p.shape[0] != N \
            or row_p.device != dev or not row_p.is_contiguous():
        raise ValueError(f"row_p must be a contiguous float32 [N, rc] tensor on "
                         f"{dev} with N = {N}, got {row_p.dtype} "
                         f"{list(row_p.shape)} on {row_p.device}")
    rc = row_p.shape[1]
    K = starts.shape[0] if starts.dim() == 1 else -1
    if not 1 <= K <= MAX_RANGES:
        raise ValueError(f"the partition takes 1 to {MAX_RANGES} ranges, got "
                         f"{list(starts.shape)}")
    if not 0 <= leaf_col < rc:
        raise ValueError(f"leaf_col {leaf_col} is not a column of row_p [N, {rc}]")
    if not 1 <= N < 1 << 31:
        raise ValueError(f"the partition takes 1 to 2**31 - 1 rows, got {N}")
    for name, t in (("starts", starts), ("counts", counts), ("valid", valid)):
        _check_vec(name, t, K, dev)
    if bagged:
        if K != 1:
            raise ValueError(f"the bagged partition has one range, got {K}")
        leaf2k = rgroup = lut = None
    else:
        _check_vec("leaf2k", leaf2k, 1, dev)
        _check_vec("rgroup", rgroup, K, dev)
        _check_vec("lut", lut.reshape(-1), K * GROUP_BINS, dev)
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
    if slot_out is not None:
        _check_vec("slot_out", slot_out, N, dev)
    tiles = -(-N // TILE_ROWS)
    bits = torch.empty(-(-N // 32), dtype=torch.int32, device=dev)
    tile_cnt = torch.empty(tiles * K, dtype=torch.int32, device=dev)
    ranges = torch.empty((3, K), dtype=torch.int32, device=dev)
    flags = torch.empty((2, K), dtype=torch.bool, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    n_leaf2k = 0 if leaf2k is None else leaf2k.shape[0]
    lib = WAVE_LIB.load()
    stream = stream_of(bins)
    with torch.cuda.device(dev):
        err = lib.lgbt_partition_decide(bins.data_ptr(), row_p.data_ptr(), N, rc, leaf_col,
                                        ptr(leaf2k), n_leaf2k, ptr(rgroup), ptr(lut), K,
                                        int(bagged), bits.data_ptr(), tile_cnt.data_ptr(),
                                        stream)
        WAVE_LIB.count("partition_decide", err)
        err = lib.lgbt_partition_scan(tile_cnt.data_ptr(), K, starts.data_ptr(),
                                      counts.data_ptr(), valid.data_ptr(), ranges.data_ptr(),
                                      flags.data_ptr(), stream)
        WAVE_LIB.count("partition_scan", err)
        err = lib.lgbt_partition_scatter(bins.data_ptr(), row_p.data_ptr(), N, G, rc,
                                         leaf_col, ptr(leaf2k), n_leaf2k, K, int(bagged),
                                         bits.data_ptr(), tile_cnt.data_ptr(),
                                         starts.data_ptr(), counts.data_ptr(),
                                         ranges.data_ptr(), bins_o.data_ptr(),
                                         row_o.data_ptr(), ptr(slot_out), stream)
        WAVE_LIB.count("partition_scatter", err)
    return bins_o, row_o, ranges, flags


def relabel(row_p: torch.Tensor, leaf_col: int, table: torch.Tensor) -> None:
    """The commit relabel (ops/compact.py:relabel_rows), in place. A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel, whose
    grid follows row_p's rows: nothing of the table is read on the host."""
    if row_p.device.type == "cpu":
        _relabel_rows_plain(row_p, leaf_col, table)
        return
    require_cuda(row_p, "the relabel")
    dev = row_p.device
    if row_p.dtype != torch.float32 or row_p.dim() != 2 or not row_p.is_contiguous():
        raise ValueError(f"row_p must be a contiguous float32 [N, rc] tensor, got "
                         f"{row_p.dtype} {list(row_p.shape)}")
    if not 0 <= leaf_col < row_p.shape[1]:
        raise ValueError(f"leaf_col {leaf_col} is not a column of row_p")
    if table.dtype != torch.int64 or table.dim() != 2 or table.shape[0] != 3 \
            or table.device != dev or not table.is_contiguous():
        raise ValueError(f"table must be a contiguous int64 [3, m] tensor on {dev}, got "
                         f"{table.dtype} {list(table.shape)} on {table.device}")
    m = table.shape[1]
    if m == 0:
        return
    if m > MAX_RANGES:
        raise ValueError(f"the relabel takes at most {MAX_RANGES} ranges, got {m}")
    lib = WAVE_LIB.load()
    with torch.cuda.device(dev):
        err = lib.lgbt_relabel_rows(row_p.data_ptr(), row_p.shape[0], row_p.shape[1],
                                    leaf_col, table.data_ptr(), m, stream_of(row_p))
    WAVE_LIB.count("relabel_rows", err)
