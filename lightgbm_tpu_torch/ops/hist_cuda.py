"""Wrappers of the CUDA histogram kernels (csrc/histogram.cu).

`histogram` replaces ``lightgbm_tpu/ops/hist_pallas.py:pallas_histogram``
and the row gather in front of it (``ops/histogram.py:152-153`` of the JAX
package); `histogram_ragged` replaces ``pallas_histogram_slots_ragged`` and
``pallas_histogram_slots``. The note at the top of the source gives their
design and bound. The library is built and loaded by ``ops/cuda_build.py``.

Dispatch is by the device of the bin plane alone: a CPU tensor takes the
plain version (``ops/histogram.py``); a CUDA tensor launches the kernel, or
raises. There is no fallback from one to the other.

The float mode (float32 gh) sums in float32: it computes the TPU kernel's
``f32=True`` path. The TPU's default bf16 operands are a matrix-unit rate
trick, not part of the function. The integer mode (int8 gh) sums exactly
in int32.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .cuda_build import CudaLibrary, require_cuda, stream_of
from .histogram import (_acc_dtype, _build_histogram_plain, _build_histogram_rows_plain,
                        _histogram_slots_ragged_plain)


def _declare(lib: ctypes.CDLL) -> None:
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    args = [ptr, i64, i32, ptr, i32, ptr, i64, i32, i32, i64, i32, ptr, ptr, ptr]
    for fn in (lib.lgbt_histogram_f32, lib.lgbt_histogram_i32):
        fn.argtypes = args
        fn.restype = i32
    ragged = [ptr, i64, i32, ptr, i64, i32, ptr, ptr, ptr, ptr, i32, i32, i32, i64, i32,
              ptr, ptr, ptr, ptr]
    for fn in (lib.lgbt_histogram_ragged_f32, lib.lgbt_histogram_ragged_i32):
        fn.argtypes = ragged
        fn.restype = i32


LIB = CudaLibrary("histogram.cu", ("histogram", "histogram_slots_ragged"), _declare)
launches = LIB.launches
reset_launches = LIB.reset_launches

WARPS = 8                      # csrc/histogram.cu kWarps
MAX_RANGES = 1024              # csrc/histogram.cu kMaxRanges
SMEM_BUDGET = 110 * 1024       # bytes of per-warp histograms a block may hold
TARGET_BLOCKS = 4 * 132        # ~4 blocks per SM of the H100
MIN_CHUNK_ROWS = 4 * WARPS * 32


def launch_shape(n_pos: int, n_groups: int, num_bins: int, ch: int
                 ) -> Tuple[int, int, int]:
    """(group_block, rows_per_chunk, n_chunks): as many groups per block as
    the per-warp histograms fit in SMEM_BUDGET, and row chunks enough for
    TARGET_BLOCKS blocks (each chunk a whole number of warp steps)."""
    per_group = WARPS * num_bins * ch * 4
    group_block = max(1, min(n_groups, (SMEM_BUDGET - WARPS * 32 * ch * 4) // per_group))
    n_gblocks = -(-n_groups // group_block)
    want_chunks = max(1, TARGET_BLOCKS // n_gblocks)
    step = WARPS * 32
    rows = max(MIN_CHUNK_ROWS, -(-n_pos // want_chunks))
    rows = -(-rows // step) * step
    return group_block, rows, max(1, -(-n_pos // rows))


def histogram(bins: torch.Tensor, gh: torch.Tensor, row_idx: Optional[torch.Tensor],
              num_bins: int) -> torch.Tensor:
    """[G, num_bins, CH] histogram of bins [G, N] over the rows of gh (all
    N rows when row_idx is None, else the padded positions row_idx [P], the
    sentinel N hitting gh's zero row N). A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel."""
    if bins.device.type == "cpu":
        if row_idx is None:
            return _build_histogram_plain(bins, gh, num_bins)
        return _build_histogram_rows_plain(bins, gh, row_idx, num_bins)
    require_cuda(bins, "the histogram")
    dev = bins.device
    acc = _acc_dtype(gh)
    if bins.dtype != torch.uint8 or bins.dim() != 2 or not bins.is_contiguous():
        raise ValueError(f"the histogram kernel takes a contiguous [G, N] uint8 "
                         f"bin plane, got {bins.dtype} {list(bins.shape)}")
    if not 1 <= num_bins <= 256:
        raise ValueError(f"num_bins must be in [1, 256] for a uint8 plane, got "
                         f"{num_bins}")
    G, N = bins.shape
    if gh.dim() != 2 or not 1 <= gh.shape[1] <= 4 or gh.device != dev \
            or not gh.is_contiguous() or gh.shape[0] < N:
        raise ValueError(f"gh must be a contiguous [N(+1), 1..4] tensor on {dev} "
                         f"with N = {N}, got {list(gh.shape)} on {gh.device}")
    CH = gh.shape[1]
    if row_idx is None:
        n_pos = N
    else:
        if row_idx.dtype != torch.int32 or row_idx.dim() != 1 \
                or row_idx.device != dev or not row_idx.is_contiguous():
            raise ValueError(f"row_idx must be a contiguous int32 vector on {dev}, "
                             f"got {row_idx.dtype} {list(row_idx.shape)} on "
                             f"{row_idx.device}")
        n_pos = row_idx.shape[0]
    out = torch.empty((G, num_bins, CH), dtype=acc, device=dev)
    if n_pos == 0 or G == 0:
        return out.zero_()
    group_block, rows, n_chunks = launch_shape(n_pos, G, num_bins, CH)
    partial = (torch.empty((n_chunks, G, num_bins, CH), dtype=acc, device=dev)
               if n_chunks > 1 else out)
    lib = LIB.load()
    fn = lib.lgbt_histogram_f32 if acc == torch.float32 else lib.lgbt_histogram_i32
    with torch.cuda.device(dev):
        err = fn(bins.data_ptr(), N, G, gh.data_ptr(), CH,
                 None if row_idx is None else row_idx.data_ptr(), n_pos,
                 num_bins, group_block, rows, n_chunks, partial.data_ptr(),
                 out.data_ptr(), stream_of(bins))
    LIB.count("histogram", err)
    return out


def ragged_launch_shape(n_rows: int, n_groups: int, num_bins: int, ch: int,
                        n_ranges: int, max_rows: int) -> Tuple[int, int, int]:
    """(group_block, tile_rows, max_chunks) of the ragged histogram: the
    group block and row chunk of `launch_shape` for the whole plane (so a
    range over every row fills the card), and a grid that holds the chunks
    of ranges with at most max_rows rows in all (a range touches at most
    len / tile_rows + 2 tiles)."""
    group_block, tile_rows, _ = launch_shape(n_rows, n_groups, num_bins, ch)
    return group_block, tile_rows, -(-max_rows // tile_rows) + 2 * n_ranges


def histogram_ragged(bins: torch.Tensor, gh: torch.Tensor, slot: torch.Tensor,
                     starts: torch.Tensor, ends: torch.Tensor, valid: torch.Tensor,
                     num_bins: int, n_slots: int, quantized: bool = False,
                     max_rows: Optional[int] = None) -> torch.Tensor:
    """[G, num_bins, n_slots*CH] wave histogram (ops/histogram.py:
    histogram_slots_ragged). max_rows bounds the ranges' rows in all (N,
    disjoint ranges, when None); the kernel's grid is sized from it. A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel."""
    if bins.device.type == "cpu":
        return _histogram_slots_ragged_plain(bins, gh, slot, starts, ends, valid,
                                             num_bins, n_slots, quantized)
    require_cuda(bins, "the ragged histogram")
    dev = bins.device
    if bins.dtype != torch.uint8 or bins.dim() != 2 or not bins.is_contiguous():
        raise ValueError(f"the ragged histogram takes a contiguous [G, N] uint8 bin "
                         f"plane, got {bins.dtype} {list(bins.shape)}")
    if not 1 <= num_bins <= 256:
        raise ValueError(f"num_bins must be in [1, 256] for a uint8 plane, got "
                         f"{num_bins}")
    G, N = bins.shape
    if gh.dtype != torch.float32 or gh.dim() != 2 or gh.shape[0] != N \
            or not 1 <= gh.shape[1] <= 4 or gh.device != dev or gh.stride(1) != 1:
        raise ValueError(f"gh must be a float32 [N, 1..4] tensor on {dev} with unit "
                         f"column stride and N = {N}, got {gh.dtype} "
                         f"{list(gh.shape)} strides {gh.stride()} on {gh.device}")
    if not 1 <= n_slots <= MAX_RANGES:
        raise ValueError(f"n_slots must be in [1, {MAX_RANGES}], got {n_slots}")
    for name, t, dtype, shape in (("slot", slot, torch.int32, (N,)),
                                  ("starts", starts, torch.int32, (n_slots,)),
                                  ("ends", ends, torch.int32, (n_slots,)),
                                  ("valid", valid, torch.bool, (n_slots,))):
        if t.dtype != dtype or tuple(t.shape) != shape or t.device != dev \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dtype} {list(shape)} "
                             f"tensor on {dev}, got {t.dtype} {list(t.shape)} on "
                             f"{t.device}")
    CH = gh.shape[1]
    acc = torch.int32 if quantized else torch.float32
    out = torch.empty((G, num_bins, n_slots * CH), dtype=acc, device=dev)
    if N == 0 or G == 0:
        return out.zero_()
    group_block, tile_rows, max_chunks = ragged_launch_shape(
        N, G, num_bins, CH, n_slots, N if max_rows is None else max_rows)
    plan = torch.empty(n_slots + 2, dtype=torch.int64, device=dev)
    partial = torch.empty((max_chunks, G, num_bins, CH), dtype=acc, device=dev)
    lib = LIB.load()
    fn = lib.lgbt_histogram_ragged_i32 if quantized else lib.lgbt_histogram_ragged_f32
    with torch.cuda.device(dev):
        err = fn(bins.data_ptr(), N, G, gh.data_ptr(), gh.stride(0), CH, slot.data_ptr(),
                 starts.data_ptr(), ends.data_ptr(), valid.data_ptr(), n_slots, num_bins,
                 group_block, tile_rows, max_chunks, plan.data_ptr(),
                 partial.data_ptr(), out.data_ptr(), stream_of(bins))
    LIB.count("histogram_slots_ragged", err)
    return out
