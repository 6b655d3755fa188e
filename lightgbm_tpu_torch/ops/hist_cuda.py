"""Wrapper of the CUDA leaf-histogram kernel (csrc/histogram.cu).

The kernel replaces ``lightgbm_tpu/ops/hist_pallas.py:pallas_histogram``
and the row gather in front of it (``ops/histogram.py:152-153`` of the JAX
package); the note at the top of the source gives its design and bound. It
is built and loaded by ``ops/cuda_build.py``.

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
from .histogram import _acc_dtype, _build_histogram_plain, _build_histogram_rows_plain


def _declare(lib: ctypes.CDLL) -> None:
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    args = [ptr, i64, i32, ptr, i32, ptr, i64, i32, i32, i64, i32, ptr, ptr, ptr]
    for fn in (lib.lgbt_histogram_f32, lib.lgbt_histogram_i32):
        fn.argtypes = args
        fn.restype = i32


LIB = CudaLibrary("histogram.cu", ("histogram",), _declare)
launches = LIB.launches
reset_launches = LIB.reset_launches

WARPS = 8                      # csrc/histogram.cu kWarps
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
