"""Wrapper of the serial learner's CUDA row partition (csrc/row_partition.cu).

`split_rows` splits one leaf's padded row-index set into its children's:
the glue around the leaf histogram that the JAX package runs in XLA
(``lightgbm_tpu/ops/partition.py:partition_rows`` and
``RowPartition.split``), as one single-pass launch (a stable partition with
a decoupled look-back between its tiles). The note at the top of the source
gives the design and bound. The library is built and loaded by
``ops/cuda_build.py``.

The tiles' status words live in a buffer kept per device and stream
(`TileStates`): zeroed once when it is allocated (or grown, or when the
epoch wraps), then tagged by each call's epoch, passed by value, so a call
launches its kernel and nothing else. A call holds the buffer's lock from
taking its epoch and tickets to its launch, so two threads that share a
stream enqueue their calls in the order of their epochs.

Dispatch is by the device of the bin row alone: a CPU tensor takes the plain
version (``ops/partition.py:_split_rows_plain``); a CUDA tensor launches the
kernel, or raises. There is no fallback from one to the other.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Dict, Tuple

import numpy as np
import torch

from .cuda_build import CudaLibrary, require_cuda, stream_of
from .partition import _split_rows_plain

# csrc/row_partition.cu: a tile of SMALL_TILE positions up to SMALL_POSITIONS
# positions, of LARGE_TILE above
SMALL_TILE, LARGE_TILE, SMALL_POSITIONS = 1024, 4096, 1 << 18
EPOCH_LIMIT = 1 << 31  # an epoch is below 2**31 (the status word's top 31 bits)


def _declare(lib: ctypes.CDLL) -> None:
    ptr, i32, u64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_ulonglong
    lib.lgbt_row_partition.argtypes = [ptr, i32, ptr, i32, i32, ptr, ptr, u64, u64, ptr, ptr,
                                       ptr, ptr]
    lib.lgbt_row_partition.restype = i32


LIB = CudaLibrary("row_partition.cu", ("row_partition",), _declare)
launches = LIB.launches
reset_launches = LIB.reset_launches


def tile(positions: int) -> int:
    """The positions of a tile (a block) in a call over `positions`."""
    return SMALL_TILE if positions <= SMALL_POSITIONS else LARGE_TILE


def tiles(positions: int) -> int:
    """Blocks of a call over `positions` positions: one a tile of them."""
    return -(-positions // tile(positions))


def state_words(n_tiles: int) -> int:
    """int64 words of a state buffer for calls of up to n_tiles tiles: the
    ticket word, then a status word a tile, rounded up to a power of two."""
    words = 2
    while words < n_tiles + 1:
        words <<= 1
    return words


class TileStates:
    """One device stream's state buffer and counters: `buf` (int64, word 0
    the ticket counter, word 1 + t tile t's status), `epoch` (the last
    call's; 0 after a zeroing) and `tickets` (taken so far from word 0).

    `take(n_tiles)` returns (buffer, ticket0, epoch) for the next call:
    a new epoch, and the tickets the call starts from. A call of one tile
    takes no ticket and reads no status word. The buffer is zeroed (on the
    stream) when it is allocated, grown, or when the epoch reaches
    EPOCH_LIMIT."""

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self.buf = None
        self.epoch = 0
        self.tickets = 0
        self.lock = threading.Lock()

    def take(self, n_tiles: int) -> Tuple[torch.Tensor, int, int]:
        need = state_words(n_tiles)
        if self.buf is None or self.buf.shape[0] < need:
            self.buf = torch.zeros(need, dtype=torch.int64, device=self.device)
            self.epoch = self.tickets = 0
        if self.epoch + 1 >= EPOCH_LIMIT:
            self.buf.zero_()
            self.epoch = self.tickets = 0
        self.epoch += 1
        ticket0 = self.tickets
        if n_tiles > 1:
            self.tickets += n_tiles
        return self.buf, ticket0, self.epoch

    def drop(self) -> None:
        """Forget the buffer after a refused launch (its tickets unknown)."""
        self.buf = None


_STATES: Dict[Tuple[int, int], TileStates] = {}
_STATES_LOCK = threading.Lock()


def tile_states(device: torch.device, stream: int) -> TileStates:
    """The state buffer of (device, stream), made at first use."""
    key = (device.index, stream)
    with _STATES_LOCK:
        states = _STATES.get(key)
        if states is None:
            states = _STATES[key] = TileStates(device)
        return states


def split_rows(bins_row: torch.Tensor, row_idx: torch.Tensor, count: int,
               table: np.ndarray, n_data: int
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(left [P], right [P], n_left [] int32): the children's index buffers
    of a leaf's padded row set row_idx [P] (its first `count` positions are
    rows) split by the 256-entry go-left table over the group bins of
    bins_row [N] (ops/partition.py:split_rows). A CPU tensor takes the plain
    version; a CUDA tensor launches the single-pass kernel, once a call."""
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
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError("the row partition cannot be captured in a CUDA graph: each "
                           "call passes its own epoch and tickets by value")
    words = np.packbits(np.asarray(table, dtype=bool).reshape(256),
                        bitorder="little").view(np.uint32)
    # one allocation: the two children and n_left (the children's views keep
    # it alive: RowPartition trims them)
    buf = torch.empty(2 * P + 1, dtype=torch.int32, device=dev)
    left, right, n_left = buf[:P], buf[P:2 * P], buf[2 * P]
    lib = LIB.load()
    stream = stream_of(bins_row)
    states = tile_states(dev, stream)
    with torch.cuda.device(dev), states.lock:
        state, ticket0, epoch = states.take(tiles(P))
        err = lib.lgbt_row_partition(bins_row.data_ptr(), n_data, row_idx.data_ptr(), count, P,
                                     words.ctypes.data, state.data_ptr(), ticket0, epoch,
                                     left.data_ptr(), right.data_ptr(), n_left.data_ptr(),
                                     stream)
        if err != 0:
            states.drop()
    LIB.count("row_partition", err)
    return left, right, n_left
