"""Wave learner: a leaf-wise tree grown in speculative waves over a
leaf-contiguous permutation of the rows.

Counterpart of the JAX package's ``treelearner/device.py`` (its
single-device path, ``grow_tree_on_device`` and ``DeviceTreeLearner``), with
the same carry:

    bins_p     [G, N]       bin plane, rows permuted leaf-contiguously
    row_p      [N, CH+2]    float32 payload: gh channels + position + leaf id
    start/cnt  [L+1]        per-leaf (start, count) row ranges
    pool       [L+1,G,B,CH] per-leaf histograms (subtraction trick)
    leaf_best  [L+1, REC]   per-leaf best-split records
    depth      [L+1]        per-leaf depth
    rec_store  [L, REC+4]   the split log replayed into a Tree
    scalars    [5]          n_cur, t, rows histogrammed, live waves, done

Per wave (`_wave`): the top-K frontier leaves by gain and the partition's
K-entry tables (ops/wave.py:select_wave, the selection kernel) -> a stable
2-way partition of every selected leaf's range (ops/compact.py:
partition_wave, the partition kernel's three passes) -> a ragged histogram
of only the smaller children (ops/histogram.py, the ragged histogram
kernel, K*CH channels) -> the larger children by subtraction from the pool
and, on an image, converted (ops/histogram.py:wave_children, on the card one
launch of the children kernel) -> 2K split searches
in one launch (ops/split.py:find_best_split) -> the guard and the exact
best-first replay, which commits splits until the argmax needs a leaf
whose children were not precomputed, and the commit's
tables (ops/wave.py:replay_wave, the replay kernel) -> the committed
children's histograms into the pool and their right rows relabeled
(ops/compact.py:relabel_rows). Split decisions are those of the
reference's leaf-wise growth (serial_tree_learner.cpp:182); only histogram
and partition work is speculative. Histogrammed rows per tree: N at the
root plus, each wave, the selected leaves' smaller children, at most N/2
(a few N in all: within 4N at 31 leaves, 4-6N at 255 on HIGGS-shaped
data).

Where the card differs from the TPU, with the same results:

* The JAX package runs the whole tree in one XLA while_loop. Here the
  whole carry stays on the card too, and so does the loop: on a CUDA
  device a tree is one CUDA graph launch (`_tree_graph`). The root's work
  (`_root`: the carry's rows from the staged gh and leaf ids, the
  fixed-point exponents, the bagged initial partition, the root's
  histogram, record and state) is a captured child graph; then a
  conditional WHILE node runs a body of two waves, each a fixed sequence
  of launches over static shapes captured once for each (K, buffer parity,
  feature mask present), while the carry's `done` word is 0
  (ops/wave_cuda.py:TreeGraph, csrc/wave_step.cu; the second wave's
  replay kernel sets the condition of the next pass, so a pass launches
  nothing but its waves). Two waves a pass keep the buffer parity fixed:
  a wave launched after the tree is done selects nothing and changes no
  output (at most one such wave a tree). The host
  reads no word while the tree grows: `train_async` returns once the tree
  is enqueued, and the tree's split log, leaf count, rows histogrammed,
  wave count and passes reach the host in one copy into a pinned slot of
  their own (two slots: one tree being finalized while the next is in
  flight), which `finalize` waits for. Each capture's kernels are counted
  as many times as the tree ran them, from the passes in that copy.
* Per-row ownership and split fields come from K-entry tables read by
  each row's range (its leaf-id column names it) inside the partition
  kernel, and the commit relabel writes the committed ranges' right rows;
  the TPU phrased all three as [N, K] match matrices and masked matmuls
  because its gathers serialize. The split decision becomes a [K, 256]
  table of `decide_go_left` over every possible group bin.
* The unpermute is one scatter by the position column (the TPU sorted).
* No row or group padding: the TPU padded rows to its tiles and groups to
  its (32, 128) layout. Padded rows were invisible in every output.
* The original bin plane is kept; the carry, the partition's second
  buffers, the pool and the per-tree inputs the graphs read (the
  fixed-point exponents of the tree's gh, the feature mask) are allocated
  once per learner and reused.

On the CPU the same root and waves run eagerly on the plain versions, the
loop driven from the host in the same passes of two waves.

A bag reaches `train_async` as host indices (bagging: a host mask a tree,
uploaded) or as a DeviceBag (GOSS, models/sample_strategy.py): its mask,
already on the card, seeds the leaf ids (-1 out of the bag) and zeroes the
bagged-out rows' gh with the same ops, and never reaches the host (the JAX
package's device.py:1186-1192). `reset_config` takes changed parameters
between trees: the regularizers in place in the params buffer the graphs
read, and new buffers for a changed num_leaves or max_depth.

Quantized training (use_quantized_grad) runs the same waves in the integer
modes, as the JAX grower's `quantized` does: the tree's int8 (g, h, 1) rows
(the learner's `_prepare_gh`, quantized over all rows before the bag masks
them) ride in the payload's float columns, exact; the histograms are the
ragged kernel's exact int32, the pool is int32 and the subtraction integer;
a leaf's totals are its int32 bin sum times the tree's scale, and the split
search scales each int32 bin as it loads it. The scale is staged into a
buffer the graphs read (`WaveBuffers.scale`), as the exponents are. With
quant_train_renew_leaf, `finalize` renews the leaf outputs from the float
gradients, summed by leaf exactly in fixed point (ops/histogram.py:
leaf_sums_fixed, an order-free int64 scatter-add where the JAX package
scatter-adds in float32) and read back with the tree's results.

On the card the pool holds each leaf's fixed-point image (the int64 sums
and flag words of ops/histogram.py:HistImage) rather than float32: the
larger child's subtraction is exact, and a wave takes its 2K children's
images and their float32 for the split search in one launch
(ops/histogram.py:wave_children, the children kernel); the sharded
learners (parallel/wave_learners.py, the JAX package's
``make_sharded_grow_fn`` and its data, voting and feature modes) add these
images across ranks. Not carried: the bf16 gh payload (ROADMAP item 6). With telemetry on, ``_record_carry_bytes``
publishes the perfmodel gauges of the learner's buffers each tree, and `finalize` emits
the ``tree_wave`` and ``wave_ctl`` telemetry events on the host, after the
tree's results came back. ``snapshot_state`` adds the bin plane's dtype to the serial
learner's checkpoint state. The JAX package's
environment switches (LGBM_TPU_WAVE, LGBM_TPU_ADAPTIVE_WAVE,
LGBM_TPU_GH_BF16, LGBM_TPU_HIST_SLOTS, LGBM_TPU_PALLAS_INTERPRET,
LGBM_TPU_COMPACT_ALIAS) are not read: the wave width ceiling is a
constructor argument, the adaptive controller is always on
(`_adaptive_wave`), and the rest are TPU dispatch and layout choices.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import perfmodel, telemetry, tracing
from ..models.sample_strategy import DeviceBag
from ..models.tree import Tree
from ..ops.compact import partition_wave, relabel_rows
from ..ops.histogram import (HistImage, fixed_point_exponents, image_to_float,
                             leaf_sums_fixed, wave_children, wave_hist_image)
from ..ops.partition import bucket_size
from ..ops.split import FeatureMeta, SplitInfo, find_best_split
from ..ops.wave import (DONE, HIST_ROWS, N_CUR, N_WAVES, REC, SCALARS, STORE,
                        FeatureTables, init_tree_state, replay_wave, select_wave,
                        split_select)
from ..utils.log import Log
from ..utils.timer import global_timer
from .serial import SerialTreeLearner, _leaf_output_host

# gain-adaptive wave-width thresholds: commit rate (committed splits /
# speculated splits) below which K steps one rung down, above which it
# steps back up toward the ceiling
_WAVE_SHRINK_RATE = 0.5
_WAVE_GROW_RATE = 0.9
# pinned slots a tree's results are copied into: one tree being finalized
# on the host while the next one grows
_RESULT_SLOTS = 2


def _feature_tables(dataset, used_features, device) -> FeatureTables:
    F = len(used_features)
    group = np.zeros(F, dtype=np.int32)
    lo = np.zeros(F, dtype=np.int32)
    hi = np.zeros(F, dtype=np.int32)
    db = np.zeros(F, dtype=np.int32)
    nb = np.zeros(F, dtype=np.int32)
    mt = np.zeros(F, dtype=np.int32)
    ie = np.zeros(F, dtype=bool)
    for k, f in enumerate(used_features):
        m = dataset.mappers[f]
        gi, mi = dataset.feature_to_group[f]
        fg = dataset.groups[gi]
        lo_k, hi_k, _ = fg.feature_bin_range(mi)
        group[k], lo[k], hi[k] = gi, lo_k, hi_k
        db[k], nb[k], mt[k] = m.default_bin, m.num_bin, m.missing_type
        ie[k] = fg.is_multi
    return FeatureTables(*(torch.from_numpy(a).to(device)
                           for a in (group, lo, hi, db, nb, mt, ie)))


class WaveBuffers:
    """The wave carry's device arrays, allocated once per learner and reused
    by every tree: the permuted bin plane and row payload, the partition's
    second copy of each, the histogram's slot vector, the histogram pool,
    the tree's [L+1]-sized state (ops/wave.py), the tree's staged inputs
    (gh, leaf ids, feature mask, and when quantized the scale) and the
    per-tree values the waves read (the fixed-point exponents), on a CUDA
    device the captured graphs, and
    the pinned slots a tree's results are copied into. The split log, the
    scalars and the loop's pass count share one buffer, so a tree's results
    leave the card in one copy.

    A graph keeps the addresses of the bin plane, feature metadata, tables
    and params it was captured with, and num_bins and max_depth as launch
    arguments, so buffers serve the inputs of their first tree only
    (`inputs`): a tree grown into them with others raises, on every
    device."""

    def __init__(self, n_groups: int, n_rows: int, payload: int, num_leaves: int,
                 num_bins: int, channels: int, n_features: int,
                 device: torch.device, quantized: bool = False, renew: bool = False,
                 image: Optional[bool] = None) -> None:
        dev = torch.device(device)
        L = num_leaves
        # quantized training: an int32 pool, the integer histograms, scaled
        # totals and split search
        self.quantized = bool(quantized)
        # zeroed once: the warm-up wave reads them before the first tree
        self.bins = [torch.zeros((n_groups, n_rows), dtype=torch.uint8, device=dev)
                     for _ in range(2)]
        self.rows = [torch.zeros((n_rows, payload), dtype=torch.float32, device=dev)
                     for _ in range(2)]
        self.slot = torch.zeros(n_rows, dtype=torch.int32, device=dev)
        # the pool holds what the ranks add exactly (ops/histogram.py:HistImage):
        # the card's float mode keeps the fixed-point image and its flag words,
        # so the larger child's subtraction is exact and it is converted once;
        # the integer mode its int32, the CPU its float32 plain version
        self.image = (dev.type == "cuda" if image is None else bool(image)) and not quantized
        pool_dtype = torch.int32 if quantized else torch.int64 if self.image else torch.float32
        self.pool = torch.zeros((L + 1, n_groups, num_bins, channels), dtype=pool_dtype,
                                device=dev)
        self.pool_flags = (torch.zeros((L + 1, n_groups, num_bins, channels),
                                       dtype=torch.int32, device=dev) if self.image else None)
        self.leaf_best = torch.full((L + 1, REC), float("-inf"), dtype=torch.float32,
                                    device=dev)
        self.depth = torch.zeros(L + 1, dtype=torch.int32, device=dev)
        self.start = torch.zeros(L + 1, dtype=torch.int32, device=dev)
        self.count = torch.zeros(L + 1, dtype=torch.int32, device=dev)
        # one extra dump row at the end, as the JAX replay's store has; after
        # the scalars, the tree loop's pass count
        # and with quantized leaf renewal, the [L, 2] float32 leaf sums of the
        # float gradients
        store_bytes = (max(L - 1, 1) + 1) * STORE * 4
        words_end = store_bytes + (SCALARS + 1) * 8
        self.results = torch.zeros(words_end + (L * 2 * 4 if renew else 0),
                                   dtype=torch.uint8, device=dev)
        self.rec_store = self.results[:store_bytes].view(torch.float32).view(-1, STORE)
        self.scalars = self.results[store_bytes:store_bytes + SCALARS * 8].view(torch.int64)
        self.passes = self.results[store_bytes + SCALARS * 8:words_end].view(torch.int64)
        self.leaf_sums = (self.results[words_end:].view(torch.float32).view(L, 2)
                          if renew else None)
        # the tree's inputs, staged where the captured root reads them
        self.gh = torch.zeros((n_rows, channels), dtype=torch.float32, device=dev)
        self.leaf0 = torch.zeros(n_rows, dtype=torch.int32, device=dev)
        self.exponents = torch.zeros(channels, dtype=torch.int32, device=dev)
        self.scale = torch.ones(channels, dtype=torch.float32, device=dev)
        self.feature_mask = torch.ones(n_features, dtype=torch.bool, device=dev)
        # the root's range [0, n) over every row; the bagged partition's range
        self.whole = torch.tensor([0, n_rows, 1], dtype=torch.int32, device=dev)
        self.root_valid = torch.ones(1, dtype=torch.bool, device=dev)
        # captures (CUDA only): waves by (K, parity, masked), roots by
        # (masked, bagged), trees by (K, masked, bagged)
        self.graphs: Dict[Tuple[int, int, bool], object] = {}
        self.roots: Dict[Tuple[bool, bool], object] = {}
        self.trees: Dict[Tuple[int, bool, bool], object] = {}
        # (bins, meta, tables, params, num_bins, max_depth)
        self.inputs: Optional[tuple] = None
        self.warm = False
        cuda = dev.type == "cuda"
        self.result_slots = [torch.zeros(self.results.numel(), dtype=torch.uint8,
                                         pin_memory=cuda) for _ in range(_RESULT_SLOTS)]
        self.result_events = [torch.cuda.Event() if cuda else None
                              for _ in range(_RESULT_SLOTS)]
        self.result_busy = [False] * _RESULT_SLOTS

    def take_result_slot(self) -> int:
        """A free results slot, marked busy until its tree is finalized."""
        for i, busy in enumerate(self.result_busy):
            if not busy:
                self.result_busy[i] = True
                return i
        raise RuntimeError(f"{len(self.result_busy)} trees grown into these buffers are not "
                           "finalized yet: finalize one before growing another")


def _root(buf: WaveBuffers, bins: torch.Tensor, meta: FeatureMeta, params: torch.Tensor,
          masked: bool, bagged: bool, num_bins: int, max_depth: int) -> None:
    """The tree's start from its staged inputs (buf.gh, buf.leaf0, the
    feature mask, the scale): the carry's rows, the fixed-point exponents
    (none when quantized), the bagged
    initial partition (in-bag rows, leaf id 0, to the front of buffer 1;
    the root is then [0, n_in)), the root's ragged histogram and record and
    the tree's state. Reads nothing on the host, so a CUDA graph replays
    it."""
    G, N = bins.shape
    CH = buf.gh.shape[1]
    POS, LEAF = CH, CH + 1
    bins_p, row_p = buf.bins[0], buf.rows[0]
    bins_p.copy_(bins)
    row_p[:, :CH] = buf.gh
    row_p[:, POS] = torch.arange(N, dtype=torch.float32, device=bins.device)
    row_p[:, LEAF] = buf.leaf0.to(torch.float32)
    # gh is fixed for the tree, so the histograms' fixed-point exponents are
    # computed once, here, from the whole of gh: every call reads a
    # permutation of its rows (row_p's gh columns), as the kernel, which
    # trusts them, requires
    if not buf.quantized:
        buf.exponents.copy_(fixed_point_exponents(buf.gh, N))
    buf.passes.zero_()
    fmask = buf.feature_mask if masked else None
    cur = 0
    if bagged:
        _, _, ranges, _ = partition_wave(bins_p, row_p, LEAF, None, None, None,
                                         buf.whole[:1], buf.whole[1:2], buf.whole[2:],
                                         bagged=True, out=(buf.bins[1], buf.rows[1]))
        cur = 1
        n_in = ranges[0, :1]
    else:
        n_in = buf.whole[1:2]
    buf.slot.zero_()
    q = buf.quantized
    root_img = wave_hist_image(buf.bins[cur], buf.rows[cur][:, :CH], buf.slot,
                               buf.whole[:1], n_in, buf.root_valid, num_bins, 1, q,
                               None if q else buf.exponents, buf.image)
    root_hist = image_to_float(root_img, buf.exponents)
    root_tot = _totals(buf, root_hist[0].sum(dim=0))
    root_rec = find_best_split(root_hist, root_tot, meta, params, fmask,
                               scale=buf.scale if q else None)
    buf.pool[0] = root_img.sums
    if buf.pool_flags is not None:
        buf.pool_flags[0] = root_img.flags
    init_tree_state(buf.leaf_best, buf.depth, buf.rec_store, buf.start, buf.count,
                    buf.scalars, root_rec, root_tot, n_in, params, max_depth)


def _totals(buf: WaveBuffers, sums: torch.Tensor) -> torch.Tensor:
    """Leaf totals [..., CH] float32 from bin sums: when quantized, the
    int32 sums converted and scaled (the JAX grower's hist_totals: summed
    in int32, then scaled; the serial learner scales, then sums)."""
    if not buf.quantized:
        return sums
    return sums.to(torch.float32) * buf.scale


def _wave(buf: WaveBuffers, cur: int, K: int, meta: FeatureMeta, tables: FeatureTables,
          params: torch.Tensor, masked: bool, num_bins: int, max_depth: int) -> None:
    """One wave, from the carry in buffers[cur] into buffers[1 - cur]: a
    fixed sequence of launches over static shapes that reads nothing on the
    host, so a CUDA graph replays it."""
    L = buf.leaf_best.shape[0] - 1
    CH = buf.pool.shape[-1]
    LEAF = CH + 1
    rows_out = buf.rows[1 - cur]
    # the top K leaves and each range's tables: leaf2k, rgroup, start, count,
    # valid, the leaf ids and the [K, 256] decision table
    table = select_wave(buf.leaf_best, buf.start, buf.count, buf.scalars, tables, K)
    leaf2k, rgroup, s_k, c_k, ok_k, sel_k, lut = split_select(table, L, K)
    # each row's range and side, the stable move, the smaller children
    _, _, ranges, flags = partition_wave(
        buf.bins[cur], buf.rows[cur], LEAF, leaf2k, rgroup, lut, s_k, c_k, ok_k,
        out=(buf.bins[1 - cur], rows_out), slot_out=buf.slot)
    # the smaller child of each selected leaf (tie -> left), whose rows the
    # partition made contiguous and labeled with their slot
    q = buf.quantized
    hist_s = wave_hist_image(buf.bins[1 - cur], rows_out[:, :CH], buf.slot, ranges[1],
                             ranges[2], flags[0], num_bins, K, q,
                             None if q else buf.exponents, buf.image)
    # one launch on the card, the pool and the smaller children read in place
    hist_l, hist_r, hists = wave_children(HistImage(buf.pool, buf.pool_flags), sel_k, hist_s,
                                          flags[1], buf.exponents)
    # a contiguous [2K, B, CH]: the sharded learners sum the same layout
    totals2 = _totals(buf, hists[:, 0].contiguous().sum(dim=1))  # [2K, CH]
    recs2 = find_best_split(hists, totals2, meta, params,
                            buf.feature_mask if masked else None,
                            scale=buf.scale if q else None)
    commit = replay_wave(buf.leaf_best, buf.depth, buf.rec_store, buf.start, buf.count,
                         buf.scalars, table, ranges[0], recs2, totals2, params, max_depth)
    # the committed children's histograms into the pool (an uncommitted
    # range writes the dump row L) and each committed range's right rows,
    # [start + n_left, end), relabeled
    pool_write(buf, commit, hist_l, hist_r)
    relabel_rows(rows_out, LEAF, commit[2:])


def pool_rows(buf: WaveBuffers, leaves: torch.Tensor) -> HistImage:
    """The pool's histograms of the given leaves."""
    idx = leaves.to(torch.int64)
    return HistImage(buf.pool[idx], None if buf.pool_flags is None else buf.pool_flags[idx])


def pool_write(buf: WaveBuffers, commit: torch.Tensor, left: HistImage,
               right: HistImage) -> None:
    """The committed children's histograms into the pool (an uncommitted
    range writes the dump row L)."""
    buf.pool.index_copy_(0, commit[0], left.sums)
    buf.pool.index_copy_(0, commit[1], right.sums)
    if buf.pool_flags is not None:
        buf.pool_flags.index_copy_(0, commit[0], left.flags)
        buf.pool_flags.index_copy_(0, commit[1], right.flags)


def _waves_eager(buf: WaveBuffers, cur: int, wave, num_leaves: int) -> int:
    """The tree loop driven from the host, in the tree graph's passes: while
    the done word is 0, wave(cur) then wave(1 - cur). Returns the passes,
    also written to buf.passes. Each pass reads the done word, so on a CUDA
    device it waits for the card; the CPU runs this loop."""
    passes = 0
    while int(buf.scalars[DONE]) == 0:
        if passes >= num_leaves:
            raise RuntimeError(f"the wave loop ran {passes} passes for {num_leaves} leaves "
                               "without its done word")
        wave(cur)
        wave(1 - cur)
        passes += 1
    buf.passes.fill_(passes)
    return passes


def _tree_graph(buf: WaveBuffers, K: int, masked: bool, bagged: bool, num_leaves: int,
                root, wave):
    """The tree graph for (K, masked, bagged), captured at first use (a
    capture costs host time only): the root's graph and both parities'
    wave graphs, each kept once and shared by the tree graphs that use
    them. A new root or the buffers' first wave first runs once eagerly:
    it loads the kernels' libraries and sets their attributes, so a
    captured launch makes no other call. The eager root sets the state the
    graph's root sets again; the warm-up wave starts done and changes
    nothing a tree reads."""
    from ..ops.cuda_build import CountedGraph
    from ..ops.wave_cuda import TreeGraph

    key = (K, masked, bagged)
    tree = buf.trees.get(key)
    if tree is not None:
        return tree
    with global_timer.scope("tree_capture"):
        if (masked, bagged) not in buf.roots:
            root()
            buf.roots[(masked, bagged)] = CountedGraph(root)
        if not buf.warm:
            buf.scalars[DONE:DONE + 1].fill_(1)
            wave(0)
            buf.warm = True
        for cur in (0, 1):
            if (K, cur, masked) not in buf.graphs:
                buf.graphs[(K, cur, masked)] = CountedGraph(lambda c=cur: wave(c))
        cur0 = 1 if bagged else 0
        tree = TreeGraph(buf.roots[(masked, bagged)].graph,
                         buf.graphs[(K, cur0, masked)].graph,
                         buf.graphs[(K, 1 - cur0, masked)].graph,
                         buf.scalars, buf.passes, max_passes=num_leaves)
    buf.trees[key] = tree
    return tree


class _Grown:
    """A tree whose growth is enqueued: its results on their way to a pinned
    slot of their own, its leaf ids in a tensor of their own."""

    def __init__(self, buffers: WaveBuffers, leaf_id: torch.Tensor, slot: int,
                 key: Tuple[int, bool, bool], graphed: bool, num_leaves: int) -> None:
        self.buffers = buffers
        self.leaf_id = leaf_id
        # the split log on the device: this tree's until the next tree grown
        # into the same buffers is enqueued, so read it (in stream order)
        # before then, as the async pipeline's score update does
        self.rec_store_dev = buffers.rec_store
        self.slot = slot
        self.key = key  # (K, masked, bagged)
        self.graphed = graphed
        self.num_leaves = num_leaves
        self._result: Optional[Tuple[np.ndarray, int, int, int, int]] = None
        # quantized leaf renewal: [L, 2] (sum g, sum h) by leaf, with the results
        self.leaf_sums: Optional[np.ndarray] = None

    def result(self) -> Tuple[np.ndarray, int, int, int]:
        """(rec_store [max(L-1, 1), STORE] float32, the final leaf count,
        rows histogrammed, live waves), from the tree's slot; waits for that
        tree's copy and nothing else, then frees the slot. On a CUDA device
        the first call also counts the kernels the tree graph ran."""
        if self._result is None:
            buf = self.buffers
            if self.graphed:
                buf.result_events[self.slot].synchronize()
            blob = buf.result_slots[self.slot]
            store_bytes = buf.rec_store.numel() * 4
            rec = blob[:store_bytes].view(torch.float32).view(-1, STORE).numpy()[:-1].copy()
            words_end = store_bytes + (SCALARS + 1) * 8
            words = blob[store_bytes:words_end].view(torch.int64).numpy().copy()
            if buf.leaf_sums is not None:
                self.leaf_sums = blob[words_end:].view(torch.float32).view(-1, 2).numpy().copy()
            buf.result_busy[self.slot] = False
            passes = int(words[SCALARS])
            if passes > self.num_leaves:
                raise RuntimeError(f"the tree loop ran {passes} passes for "
                                   f"{self.num_leaves} leaves without its done word")
            if self.graphed:
                self._count(passes)
            self._result = (rec, int(words[N_CUR]), int(words[HIST_ROWS]),
                            int(words[N_WAVES]), passes)
        return self._result[:4]

    def _count(self, passes: int) -> None:
        from ..ops.wave_cuda import TreeGraph

        K, masked, bagged = self.key
        self.buffers.roots[(masked, bagged)].count(1)
        for cur in (0, 1):
            self.buffers.graphs[(K, cur, masked)].count(passes)
        TreeGraph.count_condition()

    @property
    def waves_launched(self) -> int:
        """Waves run, live and after the end (two a pass); known once the
        results are read."""
        self.result()
        return 2 * self._result[4]


def _grow(bins: torch.Tensor, gh: torch.Tensor, leaf_id0: torch.Tensor,
          meta: FeatureMeta, tables: FeatureTables, params: torch.Tensor,
          feature_mask: Optional[torch.Tensor], num_leaves: int, num_bins: int,
          max_depth: int, batch: int, bagged: bool,
          buffers: Optional[WaveBuffers], scale: Optional[torch.Tensor] = None,
          renew_gh: Optional[torch.Tensor] = None) -> _Grown:
    """Enqueue one tree's growth; see `grow_tree_on_device`. On a CUDA
    device it returns as soon as the tree is enqueued, without waiting for
    the card. With `renew_gh` [>= N, >= 2] (the float gradients; buffers
    made with renew=True), the tree's (sum g, sum h) by leaf go to the host
    with its results (`_Grown.leaf_sums`)."""
    L = num_leaves
    G, N = bins.shape
    CH = gh.shape[1]
    K = max(1, min(batch, L))
    dev = bins.device
    POS, LEAF = CH, CH + 1
    if N >= 1 << 24:
        raise ValueError("the wave learner carries row positions as float32: at "
                         f"most 2**24 rows, got {N}")
    buf = buffers
    if buf is None:
        buf = WaveBuffers(G, N, CH + 2, L, num_bins, CH, meta.gather_index.shape[0], dev,
                          quantized=scale is not None, renew=renew_gh is not None)
    if (scale is not None) != buf.quantized \
            or (renew_gh is not None) != (buf.leaf_sums is not None):
        raise ValueError("quantized gradients take a scale, leaf renewal the float "
                         "gradients, and buffers made for them")
    inputs = (bins, meta, tables, params, int(num_bins), int(max_depth))
    if buf.inputs is None:
        buf.inputs = inputs
    elif any(a is not b for a, b in zip(buf.inputs[:4], inputs[:4])) \
            or buf.inputs[4:] != inputs[4:]:
        raise ValueError("these WaveBuffers serve the bin plane, feature metadata, tables, "
                         "params, num_bins and max_depth of their first tree, which the "
                         "captured graphs read; grow a tree with other inputs into new "
                         "buffers")
    masked = feature_mask is not None
    graphed = dev.type == "cuda" and L > 1
    slot = buf.take_result_slot()
    # --- the tree's inputs, staged where the root reads them
    with global_timer.scope("tree_stage"):
        buf.gh.copy_(gh)
        buf.leaf0.copy_(leaf_id0)
        if scale is not None:
            buf.scale.copy_(scale)
        if masked:
            buf.feature_mask.copy_(feature_mask)

    def root() -> None:
        _root(buf, bins, meta, params, masked, bagged, num_bins, max_depth)

    def wave(cur: int) -> None:
        _wave(buf, cur, K, meta, tables, params, masked, num_bins, max_depth)

    cur0 = 1 if bagged else 0  # a pass is two waves: the tree ends on this parity
    if graphed:
        tree = _tree_graph(buf, K, masked, bagged, L, root, wave)
        with global_timer.scope("tree_launch"):
            tree.launch()
    else:
        root()
        if L > 1:
            _waves_eager(buf, cur0, wave, L)
        else:
            buf.passes.zero_()
    # undo the permutation: one scatter by the position column, into a
    # tensor of this tree's own (the next tree reuses the buffers)
    row_p = buf.rows[cur0]
    leaf_id = torch.empty(N, dtype=torch.int32, device=dev)
    leaf_id[row_p[:, POS].to(torch.int64)] = row_p[:, LEAF].to(torch.int32)
    if renew_gh is not None:  # bagged-out rows (leaf id -1) add nowhere
        buf.leaf_sums.copy_(leaf_sums_fixed(renew_gh[:N], None,
                                            torch.where(leaf_id >= 0, leaf_id, L), L))
    buf.result_slots[slot].copy_(buf.results, non_blocking=dev.type == "cuda")
    if dev.type == "cuda":
        buf.result_events[slot].record()
    return _Grown(buf, leaf_id, slot, (K, masked, bagged), graphed, L)


def grow_tree_on_device(bins: torch.Tensor, gh: torch.Tensor, leaf_id0: torch.Tensor,
                        meta: FeatureMeta, tables: FeatureTables, params: torch.Tensor,
                        feature_mask: Optional[torch.Tensor], num_leaves: int,
                        num_bins: int, max_depth: int, batch: int = 16,
                        bagged: bool = False, buffers: Optional[WaveBuffers] = None,
                        scale: Optional[torch.Tensor] = None
                        ) -> Tuple[np.ndarray, torch.Tensor, int, int, int]:
    """Grow one leaf-wise tree, K = min(batch, num_leaves) splits per wave.

    bins [G, N] uint8 (not modified), gh [N, CH] float32 (bagged-out rows
    must have zero gh), or, with `scale` [CH] float32 (quantized gradients,
    the JAX grower's quantized=True and scale_vec), int8 or float32 small
    integers; leaf_id0 [N] int32 (0 for in-bag rows, -1 otherwise;
    pass bagged=True when any row is bagged out, so the initial partition
    runs), params the learner's [6] float32 regularizers, feature_mask [F]
    bool or None for all. `buffers` holds the device carry for these shapes
    (allocated here when None); buffers reused from an earlier tree must
    be given the same bins, meta, tables and params objects, num_bins and
    max_depth (`WaveBuffers`), or this raises ValueError.

    Returns (rec_store [max(L-1, 1), STORE] float32 numpy, leaf_id [N] int32
    in the original row order, the final leaf count, hist_rows — rows
    histogrammed — and n_waves), the JAX grower's five outputs. The host
    values arrive in one copy after the tree's last wave."""
    grown = _grow(bins, gh, leaf_id0, meta, tables, params, feature_mask, num_leaves,
                  num_bins, max_depth, batch, bagged, buffers, scale)
    rec_store, n_cur, hist_rows, n_waves = grown.result()
    return rec_store, grown.leaf_id, n_cur, hist_rows, n_waves


class DevicePartition:
    """Partition view over the final leaf-id vector: the indices()/count()
    surface of ops.partition.RowPartition, plus the leaf_ids_dev vector the
    score update gathers through."""

    def __init__(self, leaf_ids_dev: torch.Tensor, counts: Dict[int, int]) -> None:
        self._ids_dev = leaf_ids_dev
        self._ids: Optional[np.ndarray] = None
        self._order: Optional[np.ndarray] = None
        self._sorted: Optional[np.ndarray] = None
        self.counts = counts

    def leaf_ids_dev(self) -> torch.Tensor:
        return self._ids_dev

    @property
    def ids_host(self) -> np.ndarray:
        if self._ids is None:
            self._ids = self._ids_dev.cpu().numpy()
        return self._ids

    def count(self, leaf: int) -> int:
        return self.counts.get(leaf, 0)

    def indices(self, leaf: int) -> torch.Tensor:
        """The leaf's row indices in ascending order, int32 on the ids'
        device (what RowPartition.indices holds before its padding). One
        stable argsort serves every leaf."""
        if self._order is None:
            ids = self.ids_host
            self._order = np.argsort(ids, kind="stable").astype(np.int32)
            self._sorted = ids[self._order]
        lo = np.searchsorted(self._sorted, leaf, side="left")
        hi = np.searchsorted(self._sorted, leaf, side="right")
        return torch.from_numpy(self._order[lo:hi]).to(self._ids_dev.device)


class _PendingTree(NamedTuple):
    """A tree whose growth is enqueued: its split log on its way to its
    results slot, to be replayed into `tree`."""

    tree: Tree
    grown: _Grown
    n_bag: int
    wave_k: int = 0  # wave width this tree was grown with


class DeviceTreeLearner(SerialTreeLearner):
    """The wave learner: the serial learner's setup, each tree grown by
    `grow_tree_on_device`.

    train() is train_async() (enqueue the tree: on a CUDA device one graph
    launch, and it returns without waiting for the card) then finalize()
    (wait for that tree's results copy, replay the log into the Tree,
    install the partition). Two trees may be pending at once, each with
    its own results slot and leaf-id vector: the GBDT's async pipeline
    enqueues tree t before it finalizes tree t-1. `wave` is the ceiling of
    the wave width; the gain-adaptive controller (`_next_wave_k`) moves the
    width used, `wave_k`, one rung per finalized tree, and is switched off
    by setting `_adaptive_wave` to False."""

    # the GBDT's async pipeline reads a tree's split log on the card while
    # the next grows (`_Grown.rec_store_dev`); a sharded tree is read on the
    # host as its loop ends
    async_capable = True

    def __init__(self, config, dataset, device: torch.device, wave: int = 21) -> None:
        super().__init__(config, dataset, device)
        self.tables = _feature_tables(dataset, dataset.used_features, self.device)
        # speculative-wave width: 2*K*3 histogram channels per pass
        self.wave = int(wave)
        self._wave_cap = max(1, min(self.wave, int(config.num_leaves)))
        self._adaptive_wave = True
        self.wave_k = self._wave_cap
        self.last_hist_rows = 0
        self.last_waves_launched = 0
        self._renew = self.quantized and bool(config.quant_train_renew_leaf)
        self._buffers = self._new_buffers()

    def _new_buffers(self) -> WaveBuffers:
        """The wave carry for the configuration's num_leaves; the payload is
        (grad, hess, count): 3 channels + position + leaf id."""
        self._shape = (int(self.config.num_leaves), int(self.config.max_depth))
        with global_timer.scope("wave_buffers"):
            return WaveBuffers(self.bins_dev.shape[0], self.num_data, 5, self._shape[0],
                               self.group_bin_padded, 3, len(self.meta.real_feature),
                               self.device, quantized=self.quantized, renew=self._renew)

    def reset_config(self, config) -> None:
        """As the serial learner's; a changed num_leaves or max_depth, which
        the captured graphs bake in, takes new buffers, so the next tree
        captures its graphs anew (a pending tree keeps its own buffers)."""
        super().reset_config(config)
        if (int(config.num_leaves), int(config.max_depth)) != self._shape:
            self._wave_cap = max(1, min(self.wave, int(config.num_leaves)))
            self.wave_k = min(self.wave_k, self._wave_cap)
            self._buffers = self._new_buffers()

    def snapshot_state(self) -> dict:
        """As the serial learner's, with the bin plane's dtype. The wave
        width `wave_k` is not saved: it moves how much speculative work a
        wave does, never a split (ROADMAP Queue 3), so a resumed run that
        starts at the ceiling grows the same trees."""
        st = super().snapshot_state()
        st["bins_dtype"] = self._plane_dtype()
        return st

    def _plane_dtype(self) -> str:
        return str(self.bins_dev.dtype)

    def restore_snapshot_state(self, st: dict) -> None:
        want = st.get("bins_dtype")
        if want is not None and want != self._plane_dtype():
            Log.fatal("Checkpoint was captured with a %s bin plane but the "
                      "resume run built %s — refusing to resume", want,
                      self._plane_dtype())
        super().restore_snapshot_state(st)

    def train(self, gh_ext: torch.Tensor, bag_indices: Optional[np.ndarray] = None) -> Tree:
        return self.finalize(self.train_async(gh_ext, bag_indices))

    def train_async(self, gh_ext: torch.Tensor,
                    bag_indices: Optional[np.ndarray] = None) -> _PendingTree:
        cfg = self.config
        num_leaves = cfg.num_leaves
        gh_float = gh_ext
        # quantized over every row, then masked by the bag (device.py:1184-1199)
        gh = self._prepare_gh(gh_ext)[:-1]
        if isinstance(bag_indices, DeviceBag):
            # a bag on the card (GOSS): the same where() ops as the host
            # bag below, on the bag's own mask, which never reaches the host
            mask = bag_indices.mask
            leaf_id0 = torch.where(mask, 0, -1).to(torch.int32)
            gh = torch.where(mask[:, None], gh, torch.zeros((), dtype=gh.dtype,
                                                            device=gh.device))
            n_bag = bag_indices.n_bag
        elif bag_indices is not None:
            in_bag = np.zeros(self.num_data, dtype=bool)
            in_bag[np.asarray(bag_indices, dtype=np.int64)] = True
            mask = torch.from_numpy(in_bag).to(self.device)
            leaf_id0 = torch.where(mask, 0, -1).to(torch.int32)
            gh = torch.where(mask[:, None], gh, torch.zeros((), dtype=gh.dtype,
                                                            device=gh.device))
            n_bag = len(bag_indices)
        else:
            leaf_id0 = torch.zeros(self.num_data, dtype=torch.int32, device=self.device)
            n_bag = self.num_data
        fmask = None
        if self.col_sampler.active:
            fmask = torch.from_numpy(self.col_sampler.reset_by_tree()).to(self.device)
        if telemetry.enabled():
            self._record_carry_bytes()
            perfmodel.note_dispatch("grow_fused", _grow, self.bins_dev, gh, leaf_id0,
                                    num_leaves=num_leaves, batch=self.wave_k,
                                    bagged=bag_indices is not None)
        with global_timer.scope("tree_device"):
            grown = _grow(self.bins_dev, gh, leaf_id0, self.meta, self.tables,
                          self.params_dev, fmask, num_leaves, self.group_bin_padded,
                          cfg.max_depth, self.wave_k, bag_indices is not None,
                          self._buffers, self._scale if self.quantized else None,
                          gh_float if self._renew else None)
        return _PendingTree(Tree(num_leaves), grown, n_bag, wave_k=self.wave_k)

    def _record_carry_bytes(self) -> None:
        """Publish the perfmodel gauges of this learner's buffers: the wave
        carry's bytes, the ragged histogram's bytes a row and the split
        kernel's bytes a wave at the width the next tree uses."""
        G, N = self.bins_dev.shape
        plane = self.bins_dev.element_size()
        F, B = self.meta.gather_index.shape
        global_timer.set_count("device_carry_bytes_per_wave",
                               perfmodel.carry_bytes_per_wave(N, G, plane))
        global_timer.set_count("device_hist_bytes_per_row",
                               perfmodel.hist_bytes_per_row(G, plane))
        global_timer.set_count("device_scan_bytes_per_wave",
                               perfmodel.scan_bytes_per_wave(self.wave_k, F, B,
                                                             self.quantized))

    def finalize(self, pending: _PendingTree) -> Tree:
        tree = pending.tree
        with global_timer.scope("tree_results"):
            rec_np, _, hist_rows, n_waves = pending.grown.result()
        self.last_hist_rows = int(hist_rows)
        global_timer.add_count("device_hist_rows", self.last_hist_rows)

        counts: Dict[int, int] = {0: int(pending.n_bag)}
        with global_timer.scope("tree_replay"):
            for t in range(rec_np.shape[0]):
                row = rec_np[t]
                if row[3] < 0.5:  # valid flag: growth stopped here
                    break
                leaf = int(row[0])
                split = SplitInfo.from_packed(row[4:])
                dense_f = split.feature
                real_f = self.meta.real_feature[dense_f]
                mapper = self.dataset.mappers[real_f]
                tree.split(
                    leaf=leaf, feature_inner=dense_f, real_feature=real_f,
                    threshold_bin=split.threshold_bin,
                    threshold_double=mapper.bin_to_value(split.threshold_bin),
                    default_left=split.default_left,
                    missing_type=mapper.missing_type, gain=split.gain,
                    left_value=split.left_output, right_value=split.right_output,
                    left_count=split.left_count, right_count=split.right_count,
                    left_weight=split.left_sum_h, right_weight=split.right_sum_h,
                    parent_value=float(row[1]))
                counts[leaf] = split.left_count
                counts[tree.num_leaves - 1] = split.right_count

        self._record_wave_efficiency(pending, n_waves, tree)
        self.partition = DevicePartition(pending.grown.leaf_id, counts)
        if tree.num_leaves == 1:
            tree.as_constant_tree(0.0)
        elif self._renew:
            self._renew_leaves(tree, pending.grown.leaf_sums)
        return tree

    def _renew_leaves(self, tree: Tree, sums: np.ndarray) -> None:
        """Quantized leaf renewal from the float gradients' leaf sums, which
        came with the tree's results (the JAX package's
        _renew_quantized_leaves_device)."""
        cfg = self.config
        for leaf in range(tree.num_leaves):
            tree.set_leaf_output(leaf, _leaf_output_host(
                float(sums[leaf, 0]), float(sums[leaf, 1]), cfg.lambda_l1, cfg.lambda_l2,
                cfg.max_delta_step))

    def _record_wave_efficiency(self, pending: _PendingTree, n_waves: int,
                                tree: Tree) -> None:
        """Committed-vs-speculated wave accounting and the gain-adaptive
        wave-width controller: each wave partitions and histograms K
        candidate splits, but the replay commits only as many as stay
        globally best-first; the measured ratio drives the next tree's K
        (split decisions do not depend on K, so only the amount of
        speculative work changes, never the model). Waves run after the
        tree was done (no-ops) are counted apart, and, where the tree ran
        as a CUDA graph, its launch and the waves it ran."""
        wave_k = pending.wave_k or self.wave_k
        committed = tree.num_leaves - 1
        speculated = n_waves * wave_k
        commit_rate = committed / speculated if speculated else 1.0
        launched = pending.grown.waves_launched
        self.last_waves_launched = launched
        global_timer.add_count("device_waves", n_waves)
        global_timer.add_count("wave_noops", launched - n_waves)
        if pending.grown.graphed:
            global_timer.add_count("tree_graph_launches", 1)
            global_timer.add_count("wave_graph_runs", launched)
        global_timer.add_count("wave_splits_committed", committed)
        global_timer.add_count("wave_splits_speculated", speculated)
        tracing.note("tree_wave", waves=n_waves, committed=committed,
                     speculated=speculated)
        if telemetry.enabled():
            # on the host, after the tree's results came back: nothing
            # emits from inside the tree graph
            telemetry.emit(
                "tree_wave", waves=n_waves, wave_width=wave_k, committed=committed,
                speculated=speculated,
                efficiency=round(commit_rate, 4) if speculated else 1.0,
                hist_rows=self.last_hist_rows, waves_launched=launched,
                graphed=bool(pending.grown.graphed),
                carry_bytes_per_wave=int(global_timer.counters.get(
                    "device_carry_bytes_per_wave", 0)))
        new_k = self._next_wave_k(commit_rate, wave_k)
        if telemetry.enabled() and new_k != self.wave_k:
            telemetry.emit("wave_ctl", wave_k=new_k, prev_k=self.wave_k,
                           wave_commit_rate=round(commit_rate, 4))
        self.wave_k = new_k
        global_timer.set_count("wave_k", self.wave_k)

    def _next_wave_k(self, commit_rate: float, wave_k: int) -> int:
        """One power-of-two rung from the width the measured tree was grown
        with: a commit rate under 50% means the replay declined half the
        partition and histogram work a wave paid for, so K halves; above 90%
        speculation is nearly free, so K grows back toward the ceiling. A
        tree grown while the one before it was pending (the async pipeline)
        took its width before that tree's rate was known; stepping from its
        own width, not from the width the pending tree's rate already moved,
        keeps two rates from stepping the width twice."""
        if not self._adaptive_wave:
            return self.wave_k
        k = wave_k
        if commit_rate < _WAVE_SHRINK_RATE and k > 1:
            return min(bucket_size(max(1, k // 2), minimum=1), self._wave_cap)
        if commit_rate > _WAVE_GROW_RATE and k < self._wave_cap:
            return min(bucket_size(k + 1, minimum=1), self._wave_cap)
        return k
