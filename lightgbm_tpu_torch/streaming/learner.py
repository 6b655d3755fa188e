"""Out-of-core tree learner: train with a bounded share of the bin plane on
the card.

Counterpart of the JAX package's ``streaming/learner.py``.
StreamedTreeLearner is the serial learner with the [G, N] bin plane left on
the host: a `_BlockCache` keeps at most ``LGBM_TPU_HBM_BUDGET`` bytes of
fixed [G, block_rows] column blocks on the device (LRU), and uploads the
next block of a leaf while the current block's histogram runs.

Bit-identity with the resident serial learner, whatever the budget:

  * `_leaf_hist` splits the leaf's rows (in their order) into runs of one
    block each and sums them into one histogram with the leaf histogram's
    carried mode (`hist_cuda.HistogramCarry`): each run is one launch over
    the block's columns with block-local indices and the tree's fixed-point
    exponents, the int64 image carried from the first run to the last and
    converted once, so the result is the resident call's bits on any
    gradients. On the CPU the plain version's float32 sums go on cell by
    cell in the leaf's row order, as the resident call makes them. The
    integer mode adds exact int32 either way.
  * `_partition_split` uploads the chosen group's host row, the values
    `bins_dev[gi]` holds in the resident learner (a 4-slot LRU keeps
    them), so the row partition sees identical inputs.
  * `add_tree_to_score_blocked` walks the tree over each block with
    block-local rows and adds each row's leaf value once, as the resident
    traversal does, so the train score is bit-equal.

On the card the plane is copied once into pinned, block-major host memory
(`plane[:, lo:hi]` is strided), and uploads run on a copy stream of their
own with an event a block: `get` makes the compute stream wait for the
event, and each block tensor is `record_stream`-ed on the compute stream, so
the allocator does not hand an evicted block's memory to the next upload
while a histogram still reads it. The learner's loop issues `prefetch` ahead
of `get` from its own thread; there are no helper threads. The cache
never holds more than `capacity` blocks, resident and in flight together.

When the budget covers the whole plane every block stays resident and the
same code runs. Not carried from the JAX package: ``LGBM_TPU_STREAM_RAGGED``
(its choice between XLA, Pallas and interpret mode for the per-block
histogram: on the card the port always launches its kernel, on the CPU it
takes the plain version) and ``LGBM_TPU_BINS_I32`` (the plane stays uint8).
"""
from __future__ import annotations

import os
from collections import OrderedDict
from time import perf_counter
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..io.dataset import Dataset
from ..ops.hist_cuda import HistogramCarry
from ..ops.histogram import build_histogram_rows
from ..ops.score import binned_leaf_index, binned_tree_arrays
from ..treelearner.serial import SerialTreeLearner
from ..utils.timer import global_timer

BUDGET_ENV = "LGBM_TPU_HBM_BUDGET"
BLOCK_ROWS_ENV = "LGBM_TPU_STREAM_BLOCK_ROWS"
DEFAULT_BLOCK_ROWS = 65536
# per-split group-row uploads kept warm for repeated splits on one group
_ROW_CACHE_SLOTS = 4


def parse_budget_bytes(text: Optional[str]) -> Optional[int]:
    """'64m' / '1g' / '512k' / plain bytes -> int bytes; None, empty or 0 ->
    None (streaming off)."""
    if not text:
        return None
    text = text.strip().lower()
    mult = 1
    if text and text[-1] in "kmg":
        mult = {"k": 1 << 10, "m": 1 << 20, "g": 1 << 30}[text[-1]]
        text = text[:-1]
    try:
        val = int(float(text) * mult)
    except ValueError:
        return None
    return val if val > 0 else None


def stream_budget_bytes() -> Optional[int]:
    return parse_budget_bytes(os.environ.get(BUDGET_ENV))


def streaming_requested() -> bool:
    """Whether LGBM_TPU_HBM_BUDGET asks for out-of-core training: the
    factory's test, before the wave learner's (a plane that needs a budget
    must not be uploaded whole)."""
    return stream_budget_bytes() is not None


def block_runs(idx: torch.Tensor, block_rows: int) -> List[Tuple[int, int, int]]:
    """(block, start, stop) of the maximal runs of positions of `idx` (row
    indices, int) that lie in one block, in order: one host read of the run
    table. A leaf's rows are sorted, so a block is one run."""
    if idx.shape[0] == 0:
        return []
    bid = torch.div(idx.to(torch.int64), block_rows, rounding_mode="floor")
    blocks, counts = torch.unique_consecutive(bid, return_counts=True)
    stops = np.cumsum(counts.cpu().numpy())
    starts = np.concatenate([[0], stops[:-1]])
    return [(int(b), int(s), int(e)) for b, s, e in zip(blocks.cpu().numpy(), starts, stops)]


class _BlockCache:
    """LRU device cache over the fixed-width column blocks of the host
    plane. `prefetch(b)` starts the upload; a later `get(b)` takes the
    block into the resident set (waiting for the copy on the card). One
    thread uses it: the learner's."""

    def __init__(self, plane: np.ndarray, block_rows: int, capacity: int,
                 device: torch.device) -> None:
        self.plane = plane
        self.device = torch.device(device)
        self.block_rows = int(block_rows)
        self.num_rows = int(plane.shape[1])
        self.n_groups = int(plane.shape[0])
        self.n_blocks = max(1, -(-self.num_rows // self.block_rows))
        self.capacity = max(1, int(capacity))
        self._resident: "OrderedDict[int, torch.Tensor]" = OrderedDict()
        self._inflight = {}  # block -> (tensor, copy-done event or None)
        self.peak = 0
        self.upload_s = 0.0
        self.pin_s = 0.0
        self._timing: list = []  # (start, end) CUDA events of uploads not yet read
        self._host = None
        self._copy_stream = None
        if self.device.type == "cuda":
            # one pinned block-major copy: block b's [G, w] columns are
            # contiguous at offset b * G * block_rows, so its upload is one
            # asynchronous copy
            t0 = perf_counter()
            self._host = torch.empty(self.n_blocks * self.n_groups * self.block_rows,
                                     dtype=torch.from_numpy(plane).dtype,
                                     pin_memory=True)
            for b in range(self.n_blocks):
                self._host_block(b).copy_(torch.from_numpy(plane[:, slice(*self.block_range(b))]))
            self.pin_s = perf_counter() - t0
            global_timer.add_count("stream_pinned_bytes", int(self._host.numel()
                                                             * self._host.element_size()))
            self._copy_stream = torch.cuda.Stream(self.device)

    def block_range(self, b: int) -> Tuple[int, int]:
        lo = b * self.block_rows
        return lo, min(self.num_rows, lo + self.block_rows)

    def _host_block(self, b: int) -> torch.Tensor:
        lo, hi = self.block_range(b)
        off = b * self.n_groups * self.block_rows
        return self._host[off:off + self.n_groups * (hi - lo)].view(self.n_groups, hi - lo)

    def _upload(self, b: int):
        """Start block b's upload: (tensor, event the compute stream waits
        for, or None on the CPU)."""
        if self._copy_stream is None:
            t0 = perf_counter()
            arr = torch.from_numpy(np.ascontiguousarray(self.plane[:, slice(*self.block_range(b))]))
            self.upload_s += perf_counter() - t0
            global_timer.set_count("stream_h2d_us", int(self.upload_s * 1e6))
            done = None
        else:
            src = self._host_block(b)
            start, done = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            with torch.cuda.stream(self._copy_stream):
                arr = torch.empty(src.shape, dtype=src.dtype, device=self.device)
                start.record()
                arr.copy_(src, non_blocking=True)
                done.record()
            self._timing.append((start, done))
            self._read_timing(block=False)
        global_timer.add_count("stream_h2d_blocks", 1)
        global_timer.add_count("stream_h2d_bytes", int(arr.numel() * arr.element_size()))
        return arr, done

    def _read_timing(self, block: bool) -> None:
        """Add the finished uploads' device time to `upload_s` (all of them,
        waiting, when `block`)."""
        kept = []
        for start, done in self._timing:
            if block:
                done.synchronize()
            if block or done.query():
                self.upload_s += start.elapsed_time(done) / 1e3
            else:
                kept.append((start, done))
        self._timing = kept
        global_timer.set_count("stream_h2d_us", int(self.upload_s * 1e6))

    def h2d_seconds(self) -> float:
        """The uploads' time so far: device time on the card (CUDA events on
        the copy stream, waited for), host time on the CPU."""
        self._read_timing(block=True)
        return self.upload_s

    def _held(self) -> int:
        return len(self._resident) + len(self._inflight)

    def _note_peak(self) -> None:
        self.peak = max(self.peak, self._held())
        global_timer.set_count("stream_cache_peak_blocks", self.peak)

    def prefetch(self, b: int) -> None:
        if b in self._resident or b in self._inflight:
            return
        if self.capacity < 2:
            return  # one slot: a prefetch would evict the working block
        if self._held() >= self.capacity:
            if not self._resident:
                return
            self._resident.popitem(last=False)
        self._inflight[b] = self._upload(b)
        self._note_peak()

    def get(self, b: int) -> torch.Tensor:
        arr = self._resident.pop(b, None)
        if arr is not None:
            self._resident[b] = arr  # LRU refresh
            global_timer.add_count("stream_cache_hits", 1)
            return arr
        pending = self._inflight.pop(b, None)
        if pending is not None:
            global_timer.add_count("stream_h2d_prefetched", 1)
        else:
            global_timer.add_count("stream_h2d_cold", 1)
            while self._held() >= self.capacity and self._resident:
                self._resident.popitem(last=False)
            pending = self._upload(b)
        arr, done = pending
        if done is not None:
            compute = torch.cuda.current_stream(self.device)
            compute.wait_event(done)
            # the compute stream reads it: its memory goes back to the
            # allocator only after the reads enqueued there
            arr.record_stream(compute)
        self._resident[b] = arr
        while self._held() > self.capacity and len(self._resident) > 1:
            self._resident.popitem(last=False)
        self._note_peak()
        return arr


class StreamedTreeLearner(SerialTreeLearner):
    """The serial learner with the bin plane on the host and block-cached
    on the device.

    `bins_dev` is None: models/gbdt.py reads that as the signal to route
    the train score's tree traversal through add_tree_to_score_blocked.
    Everything else (split search, column sampler, CEGB, quantized
    gradients, checkpoint state) is the serial learner's; the checkpoint
    state never held the plane, so kill and resume work as they are."""

    def __init__(self, config: Config, dataset: Dataset, device: torch.device,
                 budget_bytes: Optional[int] = None,
                 block_rows: Optional[int] = None) -> None:
        self._budget_bytes = (int(budget_bytes) if budget_bytes is not None
                              else (stream_budget_bytes() or 0))
        env_rows = os.environ.get(BLOCK_ROWS_ENV, "")
        self._block_rows_req = (int(block_rows) if block_rows is not None
                                else int(env_rows) if env_rows else DEFAULT_BLOCK_ROWS)
        self._cache: Optional[_BlockCache] = None
        self._row_cache: "OrderedDict[int, torch.Tensor]" = OrderedDict()
        super().__init__(config, dataset, device)

    # ------------------------------------------------------------ plane

    def _device_bins(self, dataset: Dataset) -> None:
        plane = np.ascontiguousarray(dataset.bins)
        n = max(1, int(plane.shape[1]))
        block_rows = max(256, min(self._block_rows_req, n))
        block_bytes = max(1, plane.shape[0] * block_rows * plane.dtype.itemsize)
        if self._budget_bytes > 0:
            capacity = max(1, self._budget_bytes // block_bytes)
        else:
            capacity = -(-n // block_rows)  # no budget: pin everything
        self._cache = _BlockCache(plane, block_rows, capacity, self.device)
        global_timer.set_count("stream_blocks_total", self._cache.n_blocks)
        global_timer.set_count("stream_resident_blocks",
                               min(self._cache.capacity, self._cache.n_blocks))
        return None

    # ------------------------------------------------------- histograms

    def _leaf_hist(self, leaf: int) -> torch.Tensor:
        cnt = self.partition.count(leaf)
        return self._hist_over_rows(self.partition.indices(leaf)[:cnt])

    def _hist_over_rows(self, rows: torch.Tensor) -> torch.Tensor:
        """The leaf histogram of row indices `rows` (in the order the
        resident call reads them), block by block in the carried mode; the
        next run's block is prefetched before the current run's launch."""
        G, CH = len(self.dataset.groups), int(self._gh.shape[1])
        runs = block_runs(rows, self._cache.block_rows)
        if not runs:
            return torch.zeros((G, self.group_bin_padded, CH),
                               dtype=torch.int32 if self.quantized else torch.float32,
                               device=self.device)
        cache = self._cache
        carry = HistogramCarry()
        out = None
        for i, (b, s, e) in enumerate(runs):
            bins_b = cache.get(b)
            if i + 1 < len(runs):
                cache.prefetch(runs[i + 1][0])
            lo, hi = cache.block_range(b)
            local = (rows[s:e] - lo).to(torch.int32)
            out = build_histogram_rows(bins_b, self._gh[lo:hi], local, self.group_bin_padded,
                                       count=e - s, exponents=self._exps, carry=carry,
                                       last=i + 1 == len(runs))
        global_timer.add_count("stream_leaf_histograms", 1)
        return out

    # ------------------------------------------------------- partition

    def _partition_split(self, leaf: int, new_leaf: int, gi: int, decision, cat_mask=None):
        return self.partition.split(leaf, new_leaf, self._group_row(gi), decision, cat_mask)

    def _group_row(self, gi: int) -> torch.Tensor:
        """One group's full bin row [N] for the partition: the one
        whole-dataset upload a split makes (N bytes), kept in a small LRU
        since consecutive splits often reuse a group."""
        row = self._row_cache.pop(gi, None)
        if row is None:
            row = torch.from_numpy(self._cache.plane[gi]).to(self.device)
            global_timer.add_count("stream_h2d_rows", 1)
            global_timer.add_count("stream_h2d_bytes", int(row.numel() * row.element_size()))
        self._row_cache[gi] = row
        while len(self._row_cache) > _ROW_CACHE_SLOTS:
            self._row_cache.popitem(last=False)
        return row

    # ------------------------------------------------------ score update

    def add_tree_to_score_blocked(self, tree, score: torch.Tensor, row_idx: torch.Tensor,
                                  max_depth: int = 0) -> torch.Tensor:
        """ops/score.py:add_tree_to_score over the cached blocks: each run
        of `row_idx` (padded with the sentinel num_data) in one block is
        walked with block-local rows, and each row's leaf value added to
        its score once, as the resident traversal adds it: the result is
        bit-equal."""
        rows = row_idx[row_idx < self.num_data].to(torch.int64)
        out = score.clone()
        if tree.num_leaves <= 1:
            vals = torch.full((rows.shape[0],), float(tree.leaf_value[0]), dtype=score.dtype,
                              device=score.device)
            return out.index_add_(0, rows, vals)
        ta = binned_tree_arrays(tree, self.dataset, self.device)
        bound = max_depth if max_depth > 0 else int(tree.max_depth)
        cache = self._cache
        runs = block_runs(rows, cache.block_rows)
        for i, (b, s, e) in enumerate(runs):
            bins_b = cache.get(b)
            if i + 1 < len(runs):
                cache.prefetch(runs[i + 1][0])
            lo, hi = cache.block_range(b)
            leaf = binned_leaf_index(ta, bins_b, rows[s:e] - lo, hi - lo, bound)
            out.index_add_(0, rows[s:e], ta.leaf_value[leaf])
        return out

    def h2d_seconds(self) -> float:
        return self._cache.h2d_seconds()
