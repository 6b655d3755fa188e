"""Wrapper of the serial learner's CUDA row partition (csrc/row_partition.cu).

`split_rows` splits one leaf's padded row-index set into its children's:
the glue around the leaf histogram that the JAX package runs in XLA
(``lightgbm_tpu/ops/partition.py:partition_rows`` and
``RowPartition.split``), as two launches, decide and scatter. The note at
the top of the source gives the design and bound. The library is built and
loaded by ``ops/cuda_build.py``.

Dispatch is by the device of the bin row alone: a CPU tensor takes the plain
version (``ops/partition.py:_split_rows_plain``); a CUDA tensor launches the
kernels, or raises. There is no fallback from one to the other.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from .cuda_build import CudaLibrary, require_cuda, stream_of
from .partition import _split_rows_plain

TILE = 1024  # csrc/row_partition.cu kTile


def _declare(lib: ctypes.CDLL) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.lgbt_row_partition_decide.argtypes = [ptr, i32, ptr, i32, ptr, ptr, ptr, ptr]
    lib.lgbt_row_partition_scatter.argtypes = [ptr, i32, i32, i32, ptr, ptr, ptr, ptr, ptr,
                                               ptr]
    for fn in (lib.lgbt_row_partition_decide, lib.lgbt_row_partition_scatter):
        fn.restype = i32


LIB = CudaLibrary("row_partition.cu", ("row_partition_decide", "row_partition_scatter"),
                  _declare)
launches = LIB.launches
reset_launches = LIB.reset_launches


def split_rows(bins_row: torch.Tensor, row_idx: torch.Tensor, count: int,
               table: np.ndarray, n_data: int
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(left [P], right [P], n_left [] int32): the children's index buffers
    of a leaf's padded row set row_idx [P] (its first `count` positions are
    rows) split by the 256-entry go-left table over the group bins of
    bins_row [N] (ops/partition.py:split_rows). A CPU tensor takes the plain
    version; a CUDA tensor launches the decide and scatter passes."""
    if bins_row.device.type == "cpu":
        return _split_rows_plain(bins_row, row_idx, count, table, n_data)
    require_cuda(bins_row, "the row partition")
    dev = bins_row.device
    if bins_row.dtype != torch.uint8 or bins_row.dim() != 1 \
            or not bins_row.is_contiguous() or bins_row.shape[0] != n_data:
        raise ValueError(f"the row partition takes a contiguous [{n_data}] uint8 bin row, "
                         f"got {bins_row.dtype} {list(bins_row.shape)}")
    if not 1 <= n_data < 1 << 31:
        raise ValueError(f"the row partition takes 1 to 2**31 - 1 rows, got {n_data}")
    if row_idx.dtype != torch.int32 or row_idx.dim() != 1 or row_idx.device != dev \
            or not row_idx.is_contiguous():
        raise ValueError(f"row_idx must be a contiguous int32 vector on {dev}, got "
                         f"{row_idx.dtype} {list(row_idx.shape)} on {row_idx.device}")
    P = row_idx.shape[0]
    if not 0 <= count <= P or P < 1:
        raise ValueError(f"count must be in [0, {P}] positions of row_idx, got {count}")
    words = np.packbits(np.asarray(table, dtype=bool).reshape(256),
                        bitorder="little").view(np.uint32)
    n_words, n_tiles = -(-count // 32), -(-count // TILE)
    # one allocation: the two children, n_left, the ballot words, the tiles'
    # counts (the children's views keep it alive: RowPartition trims them)
    buf = torch.empty(2 * P + 1 + n_words + n_tiles, dtype=torch.int32, device=dev)
    left, right, n_left = buf[:P], buf[P:2 * P], buf[2 * P]
    bits, tile_cnt = buf[2 * P + 1:2 * P + 1 + n_words], buf[2 * P + 1 + n_words:]
    lib = LIB.load()
    stream = stream_of(bins_row)
    with torch.cuda.device(dev):
        if count > 0:
            err = lib.lgbt_row_partition_decide(bins_row.data_ptr(), n_data,
                                                row_idx.data_ptr(), count,
                                                words.ctypes.data, bits.data_ptr(),
                                                tile_cnt.data_ptr(), stream)
            LIB.count("row_partition_decide", err)
        err = lib.lgbt_row_partition_scatter(row_idx.data_ptr(), count, P, n_data,
                                             bits.data_ptr(), tile_cnt.data_ptr(),
                                             left.data_ptr(), right.data_ptr(),
                                             n_left.data_ptr(), stream)
        LIB.count("row_partition_scatter", err)
    return left, right, n_left
