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

Per wave: the top-K frontier leaves by gain -> a stable 2-way partition of
every selected leaf's range (ops/compact.py:partition_wave, the partition
kernel's three passes: each row's range and side from K-entry tables, the
move, the smaller children's slot vector and ranges) -> a ragged histogram
of only the smaller children (ops/histogram.py, the ragged histogram
kernel, K*CH channels) -> the larger children by subtraction from the pool
-> 2K split searches in one launch (ops/split.py:find_best_split, the split
kernel's find form, from the group histograms to each child's record) ->
the exact best-first replay, which commits splits until the argmax needs a
leaf whose children were not precomputed -> the committed ranges' right
rows relabeled (ops/compact.py:relabel_rows, one launch). Split
decisions are those of the reference's leaf-wise growth
(serial_tree_learner.cpp:182); only histogram and partition work is
speculative. Histogrammed rows per tree: N at the root plus, each wave, the
selected leaves' smaller children, at most N/2 (a few N in all: within 4N
at 31 leaves, 4-6N at 255 on HIGGS-shaped data).

Where the card differs from the TPU, with the same results:

* The JAX package runs the whole tree in one XLA while_loop. Here the row
  arrays, the pool and every kernel stay on the card, and the host keeps
  the [L+1]-sized state (leaf_best, depth, start/count, rec_store). Once a
  wave the host reads the 2K child records, their totals and the K left
  counts (a few KB), replays in float32 with the device replay's op order,
  and sends back which splits it committed: one copy each way. The replay
  is K dependent steps of tiny work, which a kernel would run on one
  thread.
* Per-row ownership and split fields come from K-entry tables read by
  each row's range (its leaf-id column names it) inside the partition
  kernel, and the commit relabel writes the committed ranges' right rows;
  the TPU phrased all three as [N, K] match matrices and masked matmuls
  because its gathers serialize. The split decision becomes a [K, 256]
  table of `_decide_go_left` over every possible group bin.
* The frontier choice is a stable descending sort, which breaks ties toward
  the lower leaf index as ``jax.lax.top_k`` does.
* The unpermute is one scatter by the position column (the TPU sorted).
* No row or group padding: the TPU padded rows to its tiles and groups to
  its (32, 128) layout. Padded rows were invisible in every output.
* The original bin plane is kept; the permuted copy, the partition's
  second buffer and the pool are allocated once per learner and reused.

Not carried, each still to port (ROADMAP): the sharded grower and its
data, voting and feature modes (``make_sharded_grow_fn``, Queue 1 item 8);
quantized training, its leaf renewal and the bf16 gh payload (item 6);
``snapshot_state`` (item 6, checkpoint writers); ``_record_carry_bytes``
(item 11, perfmodel); the GBDT async pipeline (item 5's remainder). The
JAX package's environment switches (LGBM_TPU_WAVE, LGBM_TPU_ADAPTIVE_WAVE,
LGBM_TPU_GH_BF16, LGBM_TPU_HIST_SLOTS, LGBM_TPU_PALLAS_INTERPRET,
LGBM_TPU_COMPACT_ALIAS) are not read: the wave width ceiling is a
constructor argument, the adaptive controller is always on
(`_adaptive_wave`), and the rest are TPU dispatch and layout choices.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..common import MISSING_NAN, MISSING_ZERO
from ..models.tree import Tree
from ..ops.compact import partition_wave, relabel_rows
from ..ops.histogram import fixed_point_exponents, histogram_slots_ragged
from ..ops.partition import bucket_size
from ..ops.split import SPLIT_FIELDS, FeatureMeta, SplitInfo, find_best_split
from ..utils.timer import global_timer
from .serial import SerialTreeLearner

REC = len(SPLIT_FIELDS)
# rec_store row: [leaf, parent_output, depth, valid] + SPLIT_FIELDS
STORE = REC + 4
GROUP_BINS = 256  # every value a uint8 group bin can take

# gain-adaptive wave-width thresholds: commit rate (committed splits /
# speculated splits) below which K steps one rung down, above which it
# steps back up toward the ceiling
_WAVE_SHRINK_RATE = 0.5
_WAVE_GROW_RATE = 0.9


class FeatureTables(NamedTuple):
    """Per-dense-feature decision fields for the row partition (host)."""

    group: np.ndarray  # [F] int32 group row in the bin matrix
    lo: np.ndarray  # [F] int32 EFB group-bin range
    hi: np.ndarray  # [F] int32
    default_bin: np.ndarray  # [F] int32
    nbins: np.ndarray  # [F] int32
    missing_type: np.ndarray  # [F] int32
    is_efb: np.ndarray  # [F] bool


def _feature_tables(dataset, used_features) -> FeatureTables:
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
    return FeatureTables(group, lo, hi, db, nb, mt, ie)


def _decide_go_left(gb, thresh, default_left, missing_type, default_bin, nbins,
                    efb_lo, efb_hi, is_efb) -> torch.Tensor:
    """NumericalDecisionInner on raw group bins (the per-node twin of
    ops.partition.split_decision_bins); all arguments broadcast."""
    gb = gb.to(torch.int32)
    in_range = (gb >= efb_lo) & (gb < efb_hi)
    shifted = gb - efb_lo
    natural = shifted + (shifted >= default_bin).to(torch.int32)
    fbin = torch.where(is_efb, torch.where(in_range, natural, default_bin), gb)
    is_missing = torch.where(missing_type == MISSING_NAN, fbin == nbins - 1,
                             (missing_type == MISSING_ZERO) & (fbin == default_bin))
    return torch.where(is_missing, default_left, fbin <= thresh)


def _decision_table(tables: FeatureTables, feature: np.ndarray, thresh: np.ndarray,
                    default_left: np.ndarray) -> np.ndarray:
    """[K, 256] go_left of each range's split for every group bin value."""
    def col(a):
        return torch.as_tensor(np.asarray(a))[:, None]

    gb = torch.arange(GROUP_BINS, dtype=torch.int32)[None, :]
    return _decide_go_left(
        gb, col(thresh), col(default_left), col(tables.missing_type[feature]),
        col(tables.default_bin[feature]), col(tables.nbins[feature]),
        col(tables.lo[feature]), col(tables.hi[feature]),
        col(tables.is_efb[feature])).numpy()


class WaveBuffers:
    """The wave carry's device arrays, allocated once per learner and reused
    by every tree: the permuted bin plane and row payload, the partition's
    second copy of each, the histogram's slot vector and the histogram
    pool."""

    def __init__(self, n_groups: int, n_rows: int, payload: int, num_leaves: int,
                 num_bins: int, channels: int, device: torch.device) -> None:
        self.bins = [torch.empty((n_groups, n_rows), dtype=torch.uint8, device=device)
                     for _ in range(2)]
        self.rows = [torch.empty((n_rows, payload), dtype=torch.float32, device=device)
                     for _ in range(2)]
        self.slot = torch.empty(n_rows, dtype=torch.int32, device=device)
        self.pool = torch.zeros((num_leaves + 1, n_groups, num_bins, channels),
                                dtype=torch.float32, device=device)


def _guard_gain(gain: np.ndarray, cnt: np.ndarray, sum_h: np.ndarray,
                depth: np.ndarray, min_data: np.float32, min_hess: np.float32,
                max_depth: int) -> np.ndarray:
    """BeforeFindBestSplit gates (serial_tree_learner.cpp:343) on float32
    totals: the gain of a leaf that may not split becomes -inf."""
    ok = (cnt >= 2 * min_data) & (sum_h >= 2 * min_hess)
    if max_depth > 0:
        ok &= depth < max_depth
    return np.where(ok, gain, np.float32(-np.inf)).astype(np.float32)


def _replay(leaf_best: np.ndarray, depth: np.ndarray, rec_store: np.ndarray,
            sel: np.ndarray, sel_ok: np.ndarray, recs2: np.ndarray,
            totals2: np.ndarray, n_cur: int, t: int, num_leaves: int,
            l1: np.float32, l2: np.float32, max_delta: np.float32
            ) -> Tuple[np.ndarray, np.ndarray, int, int]:
    """The exact best-first replay of one wave (device.py:750-799), in
    float32 with the device replay's op order: commit the global argmax
    while it is a selected leaf not yet split this wave and the leaf budget
    allows. Updates leaf_best, depth and rec_store in place; returns
    (committed [K], new leaf ids [K], n_cur, t)."""
    L = num_leaves
    K = sel.shape[0]
    committed = np.zeros(K, dtype=bool)
    newids = np.zeros(K, dtype=np.int32)
    zero, eps = np.float32(0.0), np.float32(1e-15)
    while True:
        b = int(np.argmax(leaf_best[:L, 0]))
        brec = leaf_best[b].copy()
        eq = (sel == b) & sel_ok
        pos = int(np.argmax(eq))
        # ~committed[pos]: a left child keeps its parent's leaf id, and its
        # slot holds the PARENT's children, so it is never committed twice
        if not (brec[0] > 0 and eq.any() and not committed[pos] and t < L - 1):
            break
        lrec, rrec = recs2[2 * pos], recs2[2 * pos + 1]
        ptot = totals2[2 * pos] + totals2[2 * pos + 1]
        pnum = -np.sign(ptot[0]) * np.maximum(np.abs(ptot[0]) - l1, zero)
        pout = pnum / np.maximum(ptot[1] + l2, eps)
        if max_delta > 0:
            pout = np.clip(pout, -max_delta, max_delta)
        nd = depth[b] + 1
        depth[b] = depth[n_cur] = nd
        leaf_best[b] = lrec
        leaf_best[n_cur] = rrec
        rec_store[t, :4] = (b, pout, nd, 1.0)
        rec_store[t, 4:] = brec
        committed[pos] = True
        newids[pos] = n_cur
        n_cur += 1
        t += 1
    return committed, newids, n_cur, t


def grow_tree_on_device(bins: torch.Tensor, gh: torch.Tensor, leaf_id0: torch.Tensor,
                        meta: FeatureMeta, tables: FeatureTables, params: torch.Tensor,
                        feature_mask: Optional[torch.Tensor], num_leaves: int,
                        num_bins: int, max_depth: int, batch: int = 16,
                        bagged: bool = False, buffers: Optional[WaveBuffers] = None
                        ) -> Tuple[np.ndarray, torch.Tensor, int, int, int]:
    """Grow one leaf-wise tree, K = min(batch, num_leaves) splits per wave.

    bins [G, N] uint8 (not modified), gh [N, CH] float32 (bagged-out rows
    must have zero gh), leaf_id0 [N] int32 (0 for in-bag rows, -1 otherwise;
    pass bagged=True when any row is bagged out, so the initial partition
    runs), params the learner's [6] float32 regularizers, feature_mask [F]
    bool or None for all. `buffers` holds the device carry for these shapes
    (allocated here when None).

    Returns (rec_store [max(L-1, 1), STORE] float32 numpy, leaf_id [N] int32
    in the original row order, the final leaf count, hist_rows — rows
    histogrammed — and n_waves), the JAX grower's five outputs."""
    L = num_leaves
    G, N = bins.shape
    CH = gh.shape[1]
    K = max(1, min(batch, L))
    dev = bins.device
    POS, LEAF = CH, CH + 1
    if N >= 1 << 24:
        raise ValueError("the wave learner carries row positions as float32: at "
                         f"most 2**24 rows, got {N}")
    if buffers is None:
        buffers = WaveBuffers(G, N, CH + 2, L, num_bins, CH, dev)
    p = params.detach().cpu().numpy().astype(np.float32)
    l1, l2, min_data, min_hess, max_delta = p[0], p[1], p[2], p[3], p[5]
    cur = 0
    bins_p, row_p, pool = buffers.bins[0], buffers.rows[0], buffers.pool
    bins_p.copy_(bins)
    pos = torch.arange(N, dtype=torch.int32, device=dev)
    row_p[:, :CH] = gh
    row_p[:, POS] = pos.to(torch.float32)
    row_p[:, LEAF] = leaf_id0.to(torch.float32)

    def partition(*args, **kwargs):
        """One partition out of the current buffers into the other pair."""
        nonlocal cur
        out = 1 - cur
        _, _, ranges, flags = partition_wave(
            buffers.bins[cur], buffers.rows[cur], LEAF, *args,
            out=(buffers.bins[out], buffers.rows[out]), **kwargs)
        cur = out
        return buffers.bins[cur], buffers.rows[cur], ranges, flags

    def on_dev(values, dtype) -> torch.Tensor:
        return torch.as_tensor(np.asarray(values), dtype=dtype).to(dev)

    # --- initial partition: in-bag rows (leaf id 0) to the front, root = [0, n_in)
    if bagged:
        whole = on_dev([0, N, 1], torch.int32)
        bins_p, row_p, ranges, _ = partition(None, None, None, whole[:1], whole[1:2],
                                             whole[2:], bagged=True)
        n_in = int(ranges[0, 0])
    else:
        n_in = N
    start = np.zeros(L + 1, dtype=np.int64)
    count = np.zeros(L + 1, dtype=np.int64)
    count[0] = n_in

    # --- root: the ragged histogram over [0, n_in); gh is fixed for the
    # tree, so the kernel's fixed-point exponents are computed once, here,
    # from the whole of gh: every call below reads a permutation of its rows
    # (row_p's gh columns), as the kernel, which trusts them, requires
    with global_timer.scope("wave_histogram"):
        exps = fixed_point_exponents(gh, N)
        root_hist = histogram_slots_ragged(
            bins_p, row_p[:, :CH], torch.where(pos < n_in, 0, 1).to(torch.int32),
            on_dev([0], torch.int32), on_dev([n_in], torch.int32),
            on_dev([True], torch.bool), num_bins, 1, exponents=exps)
    hist_rows = n_in
    # what the host reads of the root: its record and totals, one copy
    root_pull = torch.empty(REC + CH, dtype=torch.float32, device=dev)
    root_tot = torch.sum(root_hist[0], dim=0, out=root_pull[REC:])
    with global_timer.scope("wave_scan"):
        find_best_split(root_hist, root_tot, meta, params, feature_mask,
                        out=root_pull[:REC])
        pulled = root_pull.cpu().numpy()
    pool[0] = root_hist
    depth = np.zeros(L + 1, dtype=np.int32)
    leaf_best = np.full((L + 1, REC), -np.inf, dtype=np.float32)
    leaf_best[0] = pulled[:REC]
    tot0 = pulled[REC:]
    leaf_best[0, 0] = _guard_gain(leaf_best[0, :1], tot0[2:3], tot0[1:2], depth[:1],
                                  min_data, min_hess, max_depth)[0]
    # one extra dump row at the end, as the device replay's store has
    rec_store = np.zeros((max(L - 1, 1) + 1, STORE), dtype=np.float32)
    # what the host reads of a wave, one copy: the 2K children's records and
    # totals, and the K left counts
    pull = torch.empty(2 * K * (REC + CH) + K, dtype=torch.float32, device=dev)
    pull_recs = pull[:2 * K * REC].view(2 * K, REC)
    pull_totals = pull[2 * K * REC:2 * K * (REC + CH)].view(2 * K, CH)
    pull_nl = pull[2 * K * (REC + CH):]

    n_cur, t, n_waves = 1, 0, 0
    while L > 1 and t < L - 1 and leaf_best[:L, 0].max() > 0:
        n_waves += 1
        with global_timer.scope("wave_select"):
            gains = leaf_best[:L, 0]
            sel = np.argsort(-gains, kind="stable")[:K]  # ties: lower leaf first
            sel_ok = gains[sel] > 0
            recs_sel = leaf_best[sel]
            feat = np.where(sel_ok, recs_sel[:, 1], 0.0).astype(np.int64)
            thresh = np.where(sel_ok, recs_sel[:, 2], 0.0).astype(np.int32)
            lut = _decision_table(tables, feat, thresh, recs_sel[:, 3] > 0.5)
            lut[~sel_ok] = 0
            leaf2k = np.full(L + 2, K, dtype=np.int32)  # by leaf id + 1 (-1 -> none)
            leaf2k[sel[sel_ok] + 1] = np.nonzero(sel_ok)[0]
            rgroup = np.where(sel_ok, tables.group[feat], 0)
            s_k, c_k = start[sel], count[sel]
            table = on_dev(np.concatenate([
                leaf2k, rgroup, s_k, c_k, sel_ok, sel, lut.reshape(-1)]).astype(np.int32),
                torch.int32)
            leaf2k_d, rgroup_d, s_d, c_d, ok_d, sel_d, lut_d = torch.split(
                table, [L + 2, K, K, K, K, K, K * GROUP_BINS])

        with global_timer.scope("wave_partition"):
            # each row's range (K: none) from its leaf id, its side from its
            # range's decision table, the stable move, the smaller children
            bins_p, row_p, ranges, flags = partition(
                leaf2k_d, rgroup_d, lut_d, s_d, c_d, ok_d, slot_out=buffers.slot,
                n_left_out=pull_nl)
            ss, se = ranges[1], ranges[2]
            h_ok, left_small = flags[0], flags[1]

        with global_timer.scope("wave_histogram"):
            # the smaller child of each selected leaf (tie -> left), whose rows
            # the partition made contiguous and labeled with their slot
            hist_s = histogram_slots_ragged(bins_p, row_p[:, :CH], buffers.slot, ss, se,
                                            h_ok, num_bins, K, exponents=exps)
            hist_s = hist_s.reshape(G, num_bins, K, CH).permute(2, 0, 1, 3)
            pool_sel = pool[sel_d.to(torch.int64)]
            hist_l = torch.where(left_small[:, None, None, None], hist_s,
                                 pool_sel - hist_s)
            hist_r = pool_sel - hist_l  # subtract_histogram, batched
            hists = torch.stack([hist_l, hist_r], dim=1).reshape(2 * K, G, num_bins, CH)
            torch.sum(hists[:, 0], dim=1, out=pull_totals)  # [2K, CH]

        with global_timer.scope("wave_scan"):
            find_best_split(hists, pull_totals, meta, params, feature_mask, out=pull_recs)
            pulled = pull.cpu().numpy()

        with global_timer.scope("wave_replay"):
            recs2 = pulled[:2 * K * REC].reshape(2 * K, REC).copy()
            totals2 = pulled[2 * K * REC:2 * K * (REC + CH)].reshape(2 * K, CH)
            nl_k = pulled[2 * K * (REC + CH):].astype(np.int64)
            recs2[:, 0] = _guard_gain(recs2[:, 0], totals2[:, 2], totals2[:, 1],
                                      np.repeat(depth[sel] + 1, 2), min_data,
                                      min_hess, max_depth)
            committed, newids, n_cur, t = _replay(
                leaf_best, depth, rec_store, sel, sel_ok, recs2, totals2, n_cur, t,
                L, l1, l2, max_delta)
            nr_k = c_k - nl_k
            hist_rows += int(np.minimum(nl_k, nr_k)[sel_ok].sum())
            ck = np.nonzero(committed)[0]
            start[newids[ck]] = s_k[ck] + nl_k[ck]
            count[newids[ck]] = nr_k[ck]
            count[sel[ck]] = nl_k[ck]

        with global_timer.scope("wave_commit"):
            # the committed children's histograms into the pool, and each
            # committed range's right rows, [start + n_left, end), relabeled
            n = len(ck)
            if n:
                mids = s_k[ck] + nl_k[ck]
                upd = on_dev(np.concatenate([ck, sel[ck], newids[ck], mids,
                                             s_k[ck] + c_k[ck], newids[ck]]), torch.int64)
                ck_d, wb_d, wn_d = upd[:n], upd[n:2 * n], upd[2 * n:3 * n]
                pool.index_copy_(0, wb_d, hist_l[ck_d])
                pool.index_copy_(0, wn_d, hist_r[ck_d])
                relabel_rows(row_p, LEAF, upd[3 * n:].view(3, n), int(nr_k[ck].max()))

    # undo the permutation: one scatter by the position column
    leaf_id = torch.empty(N, dtype=torch.int32, device=dev)
    leaf_id[row_p[:, POS].to(torch.int64)] = row_p[:, LEAF].to(torch.int32)
    return rec_store[:-1], leaf_id, n_cur, hist_rows, n_waves


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
    """A grown tree whose split log is not yet replayed into `tree`."""

    tree: Tree
    rec_store: np.ndarray
    leaf_id: torch.Tensor
    hist_rows: int
    n_waves: int
    n_bag: int
    wave_k: int = 0  # wave width this tree was grown with


class DeviceTreeLearner(SerialTreeLearner):
    """The wave learner: the serial learner's setup, each tree grown by
    `grow_tree_on_device`.

    train() is train_async() (grow the tree, the split log on the host)
    then finalize() (replay the log into the Tree, install the partition).
    `wave` is the ceiling of the wave width; the gain-adaptive controller
    (`_next_wave_k`) moves the width used, `wave_k`, one rung per tree, and
    is switched off by setting `_adaptive_wave` to False."""

    def __init__(self, config, dataset, device: torch.device, wave: int = 21) -> None:
        super().__init__(config, dataset, device)
        self.tables = _feature_tables(dataset, dataset.used_features)
        # speculative-wave width: 2*K*3 histogram channels per pass
        self.wave = int(wave)
        self._wave_cap = max(1, min(self.wave, int(config.num_leaves)))
        self._adaptive_wave = True
        self.wave_k = self._wave_cap
        self.last_hist_rows = 0
        # the gh payload is (grad, hess, count): 3 channels + position + leaf id
        self._buffers = WaveBuffers(self.bins_dev.shape[0], self.num_data, 5,
                                    int(config.num_leaves), self.group_bin_padded, 3,
                                    self.device)

    def train(self, gh_ext: torch.Tensor, bag_indices: Optional[np.ndarray] = None) -> Tree:
        return self.finalize(self.train_async(gh_ext, bag_indices))

    def train_async(self, gh_ext: torch.Tensor,
                    bag_indices: Optional[np.ndarray] = None) -> _PendingTree:
        cfg = self.config
        num_leaves = cfg.num_leaves
        gh = gh_ext[:-1]
        if bag_indices is not None:
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
            fmask = torch.as_tensor(self.col_sampler.reset_by_tree(), dtype=torch.bool,
                                    device=self.device)
        with global_timer.scope("tree_device"):
            rec_store, leaf_id, _, hist_rows, n_waves = grow_tree_on_device(
                self.bins_dev, gh, leaf_id0, self.meta, self.tables, self.params_dev,
                fmask, num_leaves, self.group_bin_padded, cfg.max_depth,
                batch=self.wave_k, bagged=bag_indices is not None,
                buffers=self._buffers)
        return _PendingTree(Tree(num_leaves), rec_store, leaf_id, hist_rows, n_waves,
                            n_bag, wave_k=self.wave_k)

    def finalize(self, pending: _PendingTree) -> Tree:
        tree = pending.tree
        rec_np = pending.rec_store
        self.last_hist_rows = int(pending.hist_rows)
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

        self._record_wave_efficiency(pending, tree)
        self.partition = DevicePartition(pending.leaf_id, counts)
        if tree.num_leaves == 1:
            tree.as_constant_tree(0.0)
        return tree

    def _record_wave_efficiency(self, pending: _PendingTree, tree: Tree) -> None:
        """Committed-vs-speculated wave accounting and the gain-adaptive
        wave-width controller: each wave partitions and histograms K
        candidate splits, but the replay commits only as many as stay
        globally best-first; the measured ratio drives the next tree's K
        (split decisions do not depend on K, so only the amount of
        speculative work changes, never the model)."""
        from .. import tracing

        n_waves = int(pending.n_waves)
        wave_k = pending.wave_k or self.wave_k
        committed = tree.num_leaves - 1
        speculated = n_waves * wave_k
        commit_rate = committed / speculated if speculated else 1.0
        global_timer.add_count("device_waves", n_waves)
        global_timer.add_count("wave_splits_committed", committed)
        global_timer.add_count("wave_splits_speculated", speculated)
        tracing.note("tree_wave", waves=n_waves, committed=committed,
                     speculated=speculated)
        self.wave_k = self._next_wave_k(commit_rate)
        global_timer.set_count("wave_k", self.wave_k)

    def _next_wave_k(self, commit_rate: float) -> int:
        """One power-of-two rung per tree: a commit rate under 50% means the
        replay declined half the partition and histogram work a wave paid
        for, so K halves; above 90% speculation is nearly free, so K grows
        back toward the ceiling."""
        if not self._adaptive_wave:
            return self.wave_k
        k = self.wave_k
        if commit_rate < _WAVE_SHRINK_RATE and k > 1:
            return min(bucket_size(max(1, k // 2), minimum=1), self._wave_cap)
        if commit_rate > _WAVE_GROW_RATE and k < self._wave_cap:
            return min(bucket_size(k + 1, minimum=1), self._wave_cap)
        return k
