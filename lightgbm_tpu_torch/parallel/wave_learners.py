"""The wave learner sharded over a gang: data-, voting- and
feature-parallel (the JAX package's ``treelearner/device.py:_grow_impl``
sharded branches and ``make_sharded_grow_fn``, and its
``parallel/learners.py:478-787``).

Each rank runs the single-card wave (treelearner/device.py) on its part of
the work, and the ranks meet in collectives (parallel/dist.py) once or a
few times a wave. The wave loop is driven from the host, as `_waves_eager`
drives it: a wave is the rank's launches, then the collective, then
launches again; every rank replays the same replicated records, so every
rank reads the same done word. A tree is not one CUDA graph here: NCCL
calls inside a conditional graph body are not something to rely on
(capturing a wave's collectives into graphs is ROADMAP Queue 1 "Tuning").

Exactness. The float histograms are the card's fixed-point images
(ops/histogram.py:HistImage): each rank's image holds its rows' sums
exactly, in int64, with the tree's exponents taken from the global maximum
of |gh| (an all-reduce MAX of the shards' maxima) and the global row
count, so the ranks add images, not floats, and convert once. The pool
holds images too, so the larger child's subtraction is exact on every
rank as on one card; a sharded model is byte-equal to the single-card
model on any gradients. The integer modes add int32 as it is (or packed
int16 pairs: dist.pack_int16_pairs, where `int16_reduction_safe` holds on
the global in-bag count). On the CPU the plain versions sum float32 in row
order, and the ranks add floats: the JAX package's contract, exact on
grid-snapped gradients.

* DeviceDataParallelTreeLearner (tree_learner=data): rows sharded. The
  global left counts (a SUM) pick each selected leaf's smaller child;
  every rank histograms its rows of that child; the [K, F_pad, Bmax, CH]
  feature image (the group -> feature gather is a pure selection, so it
  commutes with the sum) is reduce-scattered over feature blocks, with the
  group-0 slice (the leaves' totals) riding in every block. Subtraction runs on the
  reduced blocks and the pool holds only the rank's block. The split
  kernel's per-feature form scans the block; an all-gather of the [2K,
  F_pad/n, REC] records and an argmax pick the splits.
* VotingDataParallelTreeLearner (tree_learner=voting, PV-Tree): rows
  sharded, the pool the rank's local images. Each rank scans its local
  histograms and nominates its top_k features a child; the nominations
  are all-gathered, the 2 top_k most voted elected (ties to the lower
  feature, in ascending order), and only the elected slices' images are
  all-reduced, with the group-0 slices, before a replicated rescan of
  them. With top_k >= F every feature is elected and the trees are the
  data-parallel ones. ``LGBM_TPU_VOTING_EXACT_CHECK=1`` also all-reduces
  every feature's image, as the data learner does, rescans them and counts
  the committed splits whose exact best feature the vote missed
  (``voting_miss_total``); the ``vote_skew@R:K`` fault replaces rank R's
  nominations at wave K (0 the root) with the JAX package's garbage ids,
  and the finalize hook (utils/faults.py:check_vote_skew_surfaced) turns
  it into a typed error.
* DeviceFeatureParallelTreeLearner (tree_learner=feature): rows
  replicated, so every rank's histograms are the whole's; the rank scans
  its block of the features and the [2K, REC] best records are
  all-gathered.

The wire's bytes a wave go to the ``device_ici_bytes_per_wave`` gauge (and
``voting_``/``feature_ici_bytes_per_wave``) from perfmodel.py, and every
collective counts its payload (``collective_bytes``).
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from .. import perfmodel
from ..models.sample_strategy import DeviceBag
from ..models.tree import Tree
from ..ops.compact import partition_wave, relabel_rows
from ..ops.histogram import (HistImage, children, fixed_point_exponents_of_max,
                             image_to_float, leaf_sums_fixed, stack_children, wave_hist_image)
from ..ops.quantize import int16_reduction_safe
from ..ops.split import (feature_meta_block, fix_feature_hist, gather_feature_hist,
                         gather_feature_hist_raw, pad_feature_meta, per_feature_best,
                         reduce_best_record)
from ..ops.wave import (DONE, HIST_ROWS, N_CUR, N_WAVES, REC, guard_gain, init_tree_state,
                        replay_wave, select_wave, split_select)
from ..treelearner.device import (DeviceTreeLearner, WaveBuffers, _PendingTree, _totals,
                                  _waves_eager, pool_rows, pool_write)
from ..utils import faults
from ..utils.log import Log
from ..utils.timer import global_timer
from . import dist
from .mesh import World

def encode_flags(flags: torch.Tensor) -> torch.Tensor:
    """Flag codes as int32 words whose SUM over ranks keeps their OR: bit 0
    of the code at bit 0, bit 1 at bit 16 (up to 65,535 ranks)."""
    return (flags & 1) | ((flags & 2) << 15)


def decode_flags(words: torch.Tensor) -> torch.Tensor:
    return ((words & 0xFFFF) != 0).to(torch.int32) | (((words >> 16) != 0).to(torch.int32) << 1)


def _left_small_ranges(s_k: torch.Tensor, c_k: torch.Tensor, n_left: torch.Tensor,
                       ok: torch.Tensor, left_small: torch.Tensor, n_rows: int):
    """This rank's rows of each selected leaf's globally smaller child: its
    (start, end), whether it is to be histogrammed, and the slot vector
    (k inside range k's child, else K)."""
    K = s_k.shape[0]
    nl = n_left.to(torch.int64)
    s, c = s_k.to(torch.int64), c_k.to(torch.int64)
    small = torch.where(left_small, nl, c - nl)
    ss = torch.where(left_small, s, s + nl)
    se = ss + small
    valid = ok & (small > 0)
    marks = torch.zeros(n_rows + 1, dtype=torch.int64, device=s.device)
    k1 = torch.arange(1, K + 1, dtype=torch.int64, device=s.device)
    marks.index_add_(0, torch.where(valid, ss, n_rows), torch.where(valid, k1, 0))
    marks.index_add_(0, torch.where(valid, se, n_rows), torch.where(valid, -k1, 0))
    run = torch.cumsum(marks[:n_rows], 0)
    slot = torch.where(run > 0, run - 1, K).to(torch.int32)
    return ss.to(torch.int32), se.to(torch.int32), valid, slot


class _ShardGrown:
    """A sharded tree's results, shaped as treelearner/device.py:_Grown's:
    read on the host when the loop ended (the host drove it)."""

    graphed = False

    def __init__(self, rec: np.ndarray, leaf_id: torch.Tensor, n_cur: int, hist_rows: int,
                 n_waves: int, passes: int, leaf_sums: Optional[np.ndarray]) -> None:
        self.leaf_id = leaf_id
        self.leaf_sums = leaf_sums
        self._result = (rec, n_cur, hist_rows, n_waves)
        self.waves_launched = 2 * passes

    def result(self):
        return self._result


class _ShardBuffers(WaveBuffers):
    """The rank's wave carry (its rows), with what the mode adds: the
    global left counts of the leaves, and for data the pool re-cut to the
    rank's feature block with the group-0 histogram image of every leaf
    (its totals) beside it, replicated."""

    def __init__(self, n_groups: int, n_rows: int, num_leaves: int, num_bins: int,
                 n_features: int, device, quantized: bool, renew: bool,
                 pool_shape: Optional[Tuple[int, ...]]) -> None:
        super().__init__(n_groups, n_rows, 5, num_leaves, num_bins, 3, n_features, device,
                         quantized=quantized, renew=renew)
        dev = self.pool.device
        L = num_leaves
        self.pool0 = self.pool0_flags = None
        if pool_shape is not None:
            self.pool = torch.zeros((L + 1, *pool_shape), dtype=self.pool.dtype, device=dev)
            self.pool0 = torch.zeros((L + 1, num_bins, 3), dtype=self.pool.dtype, device=dev)
            if self.pool_flags is not None:
                self.pool_flags = torch.zeros(self.pool.shape, dtype=torch.int32, device=dev)
                self.pool0_flags = torch.zeros(self.pool0.shape, dtype=torch.int32,
                                               device=dev)
        self.count_g = torch.zeros(L + 1, dtype=torch.int64, device=dev)


class DeviceDataParallelTreeLearner(DeviceTreeLearner):
    """tree_learner=data on the wave learner: rows sharded over the gang
    (see the module's notes)."""

    mode = "data"
    row_sharded = True
    async_capable = False

    def __init__(self, config, dataset, device, world: World, wave: int = 21) -> None:
        self.world = world
        n = dataset.num_data
        self._lo, self._hi = world.row_range(n) if self.row_sharded else (0, n)
        self.f_pad, self.f_local, self.f0 = world.feature_block(len(dataset.used_features))
        super().__init__(config, dataset, device, wave)
        self.meta_pad = pad_feature_meta(self.meta, self.f_pad)
        self.meta_blk = feature_meta_block(self.meta_pad, self.f0, self.f0 + self.f_local)
        self._nonfinite = False
        self._narrow = False
        self.last_wire_bytes = 0

    # ------------------------------------------------------------- layout

    def _device_bins(self, dataset) -> Optional[torch.Tensor]:
        """The rank's rows of the bin plane (all of them when rows are
        replicated). A row-sharded learner keeps no whole plane: `bins_dev`
        is None, and the GBDT scores out-of-bag rows through
        `add_tree_to_score_blocked`."""
        bins = dist.shard_rows(dataset.bins, self.world, dataset.num_data) \
            if self.row_sharded else dataset.bins
        self.bins_shard = torch.from_numpy(np.ascontiguousarray(bins)).to(self.device)
        return None if self.row_sharded else self.bins_shard

    def _pool_shape(self) -> Optional[Tuple[int, ...]]:
        return (self.f_local, self.meta.max_bins, 3)

    def _new_buffers(self) -> WaveBuffers:
        self._shape = (int(self.config.num_leaves), int(self.config.max_depth))
        with global_timer.scope("wave_buffers"):
            return _ShardBuffers(self.bins_shard.shape[0], self._hi - self._lo, self._shape[0],
                                 self.group_bin_padded, len(self.meta.real_feature),
                                 self.device, self.quantized, self._renew, self._pool_shape())

    def _plane_dtype(self) -> str:
        return str(self.bins_shard.dtype)  # a row-sharded learner keeps no whole plane

    def snapshot_state(self) -> dict:
        st = super().snapshot_state()
        st["n_devices"] = int(self.world.size)
        return st

    def restore_snapshot_state(self, st: dict) -> None:
        n = int(st.get("n_devices", self.world.size))
        if n != self.world.size:
            Log.warning("Checkpoint was captured on a %d-rank gang; resuming on %d ranks. "
                        "Committed trees are replicated so training stays bit-identical, "
                        "but the wire's bytes a wave differ", n, self.world.size)
        super().restore_snapshot_state(st)

    def add_tree_to_score_blocked(self, tree: Tree, score: torch.Tensor,
                                  row_idx: torch.Tensor, max_depth: int = 0) -> torch.Tensor:
        """ops/score.py:add_tree_to_score over the rank's rows: each rank
        walks its rows of `row_idx`, the per-row values are summed over the
        ranks (each row's from one rank, the others' zeros), and each row's
        value is added to its score once, as the resident traversal adds
        it: the result is bit-equal."""
        from ..ops.score import binned_leaf_index, binned_tree_arrays

        n = self.num_data
        rows = row_idx[row_idx < n].to(torch.int64)
        vals = torch.zeros(n, dtype=score.dtype, device=score.device)
        mine = rows[(rows >= self._lo) & (rows < self._hi)]
        if tree.num_leaves <= 1:
            vals[mine] = float(tree.leaf_value[0])
        else:
            ta = binned_tree_arrays(tree, self.dataset, self.device)
            bound = max_depth if max_depth > 0 else int(tree.max_depth)
            leaf = binned_leaf_index(ta, self.bins_shard, mine - self._lo,
                                     self._hi - self._lo, bound)
            vals[mine] = ta.leaf_value[leaf]
        vals = dist.all_reduce(self.world, vals)
        return score.clone().index_add_(0, rows, vals[rows])

    # --------------------------------------------------------------- tree

    def train_async(self, gh_ext: torch.Tensor,
                    bag_indices: Optional[np.ndarray] = None) -> _PendingTree:
        cfg = self.config
        L = int(cfg.num_leaves)
        N = self.num_data
        gh_float = gh_ext
        gh = self._prepare_gh(gh_ext)[:-1]
        if isinstance(bag_indices, DeviceBag):
            mask = bag_indices.mask
            n_bag = bag_indices.n_bag
        elif bag_indices is not None:
            in_bag = np.zeros(N, dtype=bool)
            in_bag[np.asarray(bag_indices, dtype=np.int64)] = True
            mask = torch.from_numpy(in_bag).to(self.device)
            n_bag = len(bag_indices)
        else:
            mask, n_bag = None, N
        lo, hi = self._lo, self._hi
        if mask is not None:
            mask = mask[lo:hi]
            leaf0 = torch.where(mask, 0, -1).to(torch.int32)
            gh = torch.where(mask[:, None], gh[lo:hi],
                             torch.zeros((), dtype=gh.dtype, device=gh.device))
        else:
            leaf0 = torch.zeros(hi - lo, dtype=torch.int32, device=self.device)
            gh = gh[lo:hi]
        fmask = None
        if self.col_sampler.active:
            fmask = torch.from_numpy(self.col_sampler.reset_by_tree()).to(self.device)
        buf = self._buffers
        K = max(1, min(self.wave_k, L))
        # not the single-card learner's "tree_device": the sanitizer holds
        # that scope sync-free, and the host drives this loop
        with global_timer.scope("tree_sharded"):
            self._begin(buf, gh, leaf0, fmask, n_bag)
            self._root(buf, bagged=bag_indices is not None)
            passes = 0
            if L > 1:
                cur0 = 1 if bag_indices is not None else 0
                sent = global_timer.counters.get("collective_bytes", 0)
                passes = _waves_eager(buf, cur0, lambda c: self._wave(buf, c, K), L)
                # the wire's bytes of the waves alone, live and after the
                # end, beside the model's for this tree's width
                global_timer.add_count("wave_wire_bytes",
                                       global_timer.counters.get("collective_bytes", 0) - sent)
                global_timer.add_count("wave_wire_waves", 2 * passes)
                global_timer.add_count("wave_wire_model_bytes",
                                       2 * passes * self._wire_model(K))
            else:
                buf.passes.zero_()
            cur0 = 1 if bag_indices is not None else 0
            row_p = buf.rows[cur0]
            local = torch.empty(hi - lo, dtype=torch.int32, device=self.device)
            local[row_p[:, 3].to(torch.int64)] = row_p[:, 4].to(torch.int32)
            leaf_id = (dist.all_gather_rows(self.world, local, N) if self.row_sharded
                       else local)
            sums = None
            if self._renew:
                sums = leaf_sums_fixed(gh_float[:N], None,
                                       torch.where(leaf_id >= 0, leaf_id, L), L).cpu().numpy()
            # the rows histogrammed are the ranks' sum; the rest is replicated
            hist_rows = buf.scalars[HIST_ROWS:HIST_ROWS + 1].clone()
            if self.row_sharded:
                hist_rows = dist.all_reduce(self.world, hist_rows)
            words = buf.scalars.cpu().numpy()
            rec = buf.rec_store.cpu().numpy()[:-1].copy()
        self._record_ici_bytes(K)
        grown = _ShardGrown(rec, leaf_id, int(words[N_CUR]), int(hist_rows.item()),
                            int(words[N_WAVES]), passes, sums)
        return _PendingTree(Tree(L), grown, n_bag, wave_k=K)

    def _begin(self, buf: _ShardBuffers, gh: torch.Tensor, leaf0: torch.Tensor,
               fmask: Optional[torch.Tensor], n_bag: int) -> None:
        """Stage the tree's inputs; the fixed-point exponents from the MAX
        over the ranks of each channel's largest finite |gh| and the global
        row count (with a word that says whether any rank holds a
        non-finite value: only then do the flag words cross the wire); the
        int16 wire from the global in-bag count."""
        buf.gh.copy_(gh)
        buf.leaf0.copy_(leaf0)
        if self.quantized:
            buf.scale.copy_(self._scale)
        if fmask is not None:
            buf.feature_mask.copy_(fmask)
        self._fmask = fmask
        if not self.quantized:
            m = torch.cat([gh.abs().nan_to_num(nan=0.0, posinf=0.0).amax(dim=0),
                           (~torch.isfinite(gh)).any()[None].to(gh.dtype)])
            if self.row_sharded:
                m = dist.all_reduce(self.world, m, op="max")
            buf.exponents.copy_(fixed_point_exponents_of_max(m[:3], self.num_data))
            self._nonfinite = bool(m[3].item() > 0)
        self._narrow = (self.quantized and self.row_sharded
                        and int16_reduction_safe(n_bag, self.config.num_grad_quant_bins))

    # -------------------------------------------------------- collectives

    def _reduce(self, img: HistImage, scatter: bool) -> HistImage:
        """The SUM over the ranks of an image whose cells run along dim 0
        (reduce-scattered to the rank's block of dim 0, or all-reduced):
        the int64 sums, int32 as it is or on the packed int16 wire, the
        flag words only when a rank holds a non-finite gh."""
        w = self.world
        op = dist.reduce_scatter if scatter else dist.all_reduce
        sums = img.sums
        if self._narrow:
            flat = sums.reshape(sums.shape[0], -1)
            out = op(w, dist.pack_int16_pairs(flat))
            sums = dist.unpack_int16_pairs(out, flat.shape[1]).reshape(
                out.shape[0], *sums.shape[1:])
        else:
            sums = op(w, sums)
        flags = img.flags
        if flags is not None:
            if self._nonfinite:
                flags = decode_flags(op(w, encode_flags(flags)))
            elif scatter:
                blk = flags.shape[0] // w.size
                flags = flags[w.rank * blk:(w.rank + 1) * blk]
        return HistImage(sums, flags)

    def _gather_records(self, recs: torch.Tensor) -> torch.Tensor:
        """[2K, f_local, REC] block records (feature index in the block) ->
        [2K, REC] the best over every rank's block: the all-gather and the
        argmax (ties to the lower feature: SyncUpGlobalBestSplit)."""
        feat = recs[..., 1]
        recs = recs.clone()
        recs[..., 1] = torch.where(feat >= 0, feat + self.f0, -1.0)
        allr = dist.all_gather(self.world, recs)  # [n, 2K, f_local, REC]
        allr = allr.permute(1, 0, 2, 3).reshape(recs.shape[0], -1, REC)
        return reduce_best_record(allr)

    # ------------------------------------------------------- root and wave

    def _feature_image(self, img: HistImage, K: int) -> HistImage:
        """[K, G, B, CH] group images -> [F_pad, K, Bmax, CH] feature images
        (a pure selection, with the padded features' zero rows)."""
        gi, vs = self.meta_pad.gather_index, self.meta_pad.valid_slot
        return img.map(lambda t: gather_feature_hist_raw(t, gi, vs).permute(1, 0, 2, 3)
                       .contiguous())

    def _reduce_blocks(self, img: HistImage, K: int) -> Tuple[HistImage, HistImage]:
        """[K, G, B, CH] local images -> (this rank's reduced feature block
        [K, f_local, Bmax, CH], the reduced group-0 rows [K, B, CH]) in one
        reduce-scatter: each rank's chunk of the send buffer is its feature
        block's cells followed by a copy of the group-0 rows, so every
        reduced chunk carries their sum over the ranks."""
        n = self.world.size
        Bm = self.meta.max_bins
        fimg = self._feature_image(img, K)  # [F_pad, K, Bmax, CH]
        g0 = img.map(lambda t: t[:, 0].reshape(1, -1))

        def pack(f, g):
            return torch.cat([f.reshape(n, -1), g.expand(n, -1)], dim=1)

        send = HistImage(pack(fimg.sums, g0.sums),
                         None if fimg.flags is None else pack(fimg.flags, g0.flags))
        red = self._reduce(send, scatter=True)  # [1, chunk]
        cut = self.f_local * K * Bm * 3
        blk = red.map(lambda t: t[0, :cut].reshape(self.f_local, K, Bm, 3).permute(1, 0, 2, 3))
        return blk, red.map(lambda t: t[0, cut:].reshape(K, -1, 3))

    def _scan_block(self, blk: torch.Tensor, totals: torch.Tensor, one: bool) -> torch.Tensor:
        """The split kernel's per-feature form on the rank's block: [L,
        f_local, Bmax, CH] (int32 scaled first, as the find form scales each
        bin), the EFB fix with the leaves' global totals."""
        buf = self._buffers
        if self.quantized:
            blk = blk.to(torch.float32) * buf.scale
        m = self.meta_blk
        fmask = None if self._fmask is None else self._block_mask()
        fh = fix_feature_hist(blk, totals, m.efb_omitted, m.default_bin)
        if one:
            return per_feature_best(fh[0], totals[0], m, self.params_dev, fmask)[None]
        return per_feature_best(fh, totals, m, self.params_dev, fmask)

    def _block_mask(self) -> torch.Tensor:
        full = torch.zeros(self.f_pad, dtype=torch.bool, device=self.device)
        full[:self._fmask.shape[0]] = self._fmask
        return full[self.f0:self.f0 + self.f_local].contiguous()

    def _root_hist(self, buf: _ShardBuffers, bagged: bool) -> Tuple[HistImage, torch.Tensor]:
        """The carry's rows, the bagged initial partition, the root's local
        image and its row count."""
        G, N = buf.bins[0].shape
        buf.bins[0].copy_(self.bins_shard)
        row_p = buf.rows[0]
        row_p[:, :3] = buf.gh
        row_p[:, 3] = torch.arange(N, dtype=torch.float32, device=self.device)
        row_p[:, 4] = buf.leaf0.to(torch.float32)
        buf.passes.zero_()
        cur = 0
        if bagged:
            _, _, ranges, _ = partition_wave(buf.bins[0], row_p, 4, None, None, None,
                                             buf.whole[:1], buf.whole[1:2], buf.whole[2:],
                                             bagged=True, out=(buf.bins[1], buf.rows[1]))
            cur, n_in = 1, ranges[0, :1]
        else:
            n_in = buf.whole[1:2]
        buf.slot.zero_()
        q = self.quantized
        img = wave_hist_image(buf.bins[cur], buf.rows[cur][:, :3], buf.slot, buf.whole[:1],
                              n_in, buf.root_valid, self.group_bin_padded, 1, q,
                              None if q else buf.exponents, buf.image)
        return img.map(lambda t: t[None]), n_in

    def _root(self, buf: _ShardBuffers, bagged: bool) -> None:
        img, n_in = self._root_hist(buf, bagged)  # [1, G, B, CH]
        blk, g0 = self._reduce_blocks(img, 1)
        g0f = image_to_float(g0, buf.exponents)
        root_tot = _totals(buf, g0f[0].sum(dim=0))
        rec = self._gather_records(self._scan_block(image_to_float(blk, buf.exponents),
                                                    root_tot[None], one=True))[0]
        buf.pool[0] = blk.sums[0]
        buf.pool0[0] = g0.sums[0]
        if buf.pool_flags is not None:
            buf.pool_flags[0] = blk.flags[0]
            buf.pool0_flags[0] = g0.flags[0]
        self._start_tree(buf, rec, root_tot, n_in)

    def _start_tree(self, buf: _ShardBuffers, rec, root_tot, n_in) -> None:
        init_tree_state(buf.leaf_best, buf.depth, buf.rec_store, buf.start, buf.count,
                        buf.scalars, rec, root_tot, n_in, self.params_dev,
                        int(self.config.max_depth))
        n_g = n_in.to(torch.int64)
        if self.row_sharded:
            n_g = dist.all_reduce(self.world, n_g)
        buf.count_g.zero_()
        buf.count_g[:1].copy_(n_g)

    def _partition(self, buf: _ShardBuffers, cur: int, K: int):
        """Select, partition the rank's rows and find each selected leaf's
        globally smaller child: (table, sel, n_left, left_small, nl_g, nr_g,
        this rank's image of the smaller children [K, G, B, CH])."""
        L = buf.leaf_best.shape[0] - 1
        G = buf.bins[0].shape[0]
        B = self.group_bin_padded
        table = select_wave(buf.leaf_best, buf.start, buf.count, buf.scalars, self.tables, K)
        leaf2k, rgroup, s_k, c_k, ok_k, sel_k, lut = split_select(table, L, K)
        rows_out = buf.rows[1 - cur]
        _, _, ranges, _ = partition_wave(buf.bins[cur], buf.rows[cur], 4, leaf2k, rgroup,
                                         lut, s_k, c_k, ok_k,
                                         out=(buf.bins[1 - cur], rows_out))
        n_left = ranges[0]
        nl_g = n_left.to(torch.int64)
        if self.row_sharded:
            nl_g = dist.all_reduce(self.world, nl_g)
        c_g = buf.count_g[sel_k.to(torch.int64)]
        nr_g = c_g - nl_g
        left_small = nl_g <= nr_g  # tie -> left, by the global counts
        ss, se, valid, slot = _left_small_ranges(s_k, c_k, n_left, ok_k != 0, left_small,
                                                 rows_out.shape[0])
        buf.slot.copy_(slot)
        q = self.quantized
        img = wave_hist_image(buf.bins[1 - cur], rows_out[:, :3], buf.slot, ss, se, valid,
                              B, K, q, None if q else buf.exponents, buf.image)
        img = img.map(lambda t: t.reshape(G, B, K, 3).permute(2, 0, 1, 3))
        return table, sel_k, n_left, left_small, nl_g, nr_g, img

    def _commit(self, buf: _ShardBuffers, cur: int, table, n_left, recs2, totals2,
                sel_k, nl_g, nr_g, hl: HistImage, hr: HistImage,
                g0l: Optional[HistImage], g0r: Optional[HistImage]) -> None:
        """The replay, the pool's (and, data-parallel, the group-0 pool's)
        committed children, the global counts and the relabel."""
        commit = replay_wave(buf.leaf_best, buf.depth, buf.rec_store, buf.start, buf.count,
                             buf.scalars, table, n_left, recs2, totals2, self.params_dev,
                             int(self.config.max_depth))
        pool_write(buf, commit, hl, hr)
        if buf.pool0 is not None:
            buf.pool0.index_copy_(0, commit[0], g0l.sums)
            buf.pool0.index_copy_(0, commit[1], g0r.sums)
        if buf.pool0_flags is not None:
            buf.pool0_flags.index_copy_(0, commit[0], g0l.flags)
            buf.pool0_flags.index_copy_(0, commit[1], g0r.flags)
        buf.count_g.index_copy_(0, commit[0], nl_g)
        buf.count_g.index_copy_(0, commit[1], nr_g)
        relabel_rows(buf.rows[1 - cur], 4, commit[2:])

    def _pool0_rows(self, buf: _ShardBuffers, sel_k) -> HistImage:
        idx = sel_k.to(torch.int64)
        return HistImage(buf.pool0[idx], None if buf.pool0_flags is None
                         else buf.pool0_flags[idx])

    def _children_totals(self, buf, g0l: HistImage, g0r: HistImage) -> torch.Tensor:
        g0 = image_to_float(stack_children(g0l, g0r), buf.exponents)  # [2K, B, CH]
        return _totals(buf, g0.sum(dim=1))

    def _wave(self, buf: _ShardBuffers, cur: int, K: int) -> None:
        table, sel_k, n_left, left_small, nl_g, nr_g, img = self._partition(buf, cur, K)
        blk, g0s = self._reduce_blocks(img, K)  # [K, f_local, Bmax, CH], [K, B, CH]
        hl, hr = children(pool_rows(buf, sel_k), blk, left_small)
        g0l, g0r = children(self._pool0_rows(buf, sel_k), g0s, left_small)
        totals2 = self._children_totals(buf, g0l, g0r)
        fh = image_to_float(stack_children(hl, hr), buf.exponents)
        recs2 = self._gather_records(self._scan_block(fh, totals2, one=False))
        self._commit(buf, cur, table, n_left, recs2, totals2, sel_k, nl_g, nr_g, hl, hr,
                     g0l, g0r)

    # ------------------------------------------------------------ gauges

    def _value_bytes(self) -> int:
        if self.quantized:
            return 2 if self._narrow else 4
        return 8 if self._buffers.image else 4

    def _wire_model(self, K: int) -> int:
        """The wire's bytes a wave at width K (perfmodel.ici_bytes_per_wave):
        with the row count nowhere in it."""
        return perfmodel.ici_bytes_per_wave(K, self.f_pad, self.meta.max_bins,
                                            self.group_bin_padded, self.world.size,
                                            value_bytes=self._value_bytes())

    def _record_ici_bytes(self, K: int) -> None:
        self.last_wire_bytes = self._wire_model(K)
        global_timer.set_count("device_ici_bytes_per_wave", self.last_wire_bytes)


class VotingDataParallelTreeLearner(DeviceDataParallelTreeLearner):
    """tree_learner=voting on the wave learner (PV-Tree; see the module's
    notes): rows sharded, the pool the rank's local images."""

    mode = "voting"

    def __init__(self, config, dataset, device, world: World, wave: int = 21) -> None:
        super().__init__(config, dataset, device, world, wave)
        self.k_local = max(1, min(int(config.top_k), self.f_pad))
        self.k_global = max(1, min(2 * int(config.top_k), self.f_pad))
        self._exact_check = os.environ.get("LGBM_TPU_VOTING_EXACT_CHECK", "").lower() in (
            "1", "true", "on")
        self._miss = torch.zeros((), dtype=torch.int64, device=self.device)

    def _pool_shape(self) -> Optional[Tuple[int, ...]]:
        return None  # the local group layout

    def _vote(self, local: HistImage, local_tot_img: HistImage,
              wave_no) -> Tuple[torch.Tensor, torch.Tensor]:
        """[M, G, B, CH] local images of M leaves and their group-0 rows ->
        (the elected features [M, k_g] ascending, their mask [M, F_pad]):
        each rank's local scan nominates, the nominations are all-gathered
        and counted. `wave_no` (0 the root, a device scalar in the loop) is
        what an armed vote_skew compares with its wave."""
        buf = self._buffers
        q = self.quantized
        M = local.sums.shape[0]
        lf = image_to_float(local, buf.exponents)
        ltot = _totals(buf, image_to_float(local_tot_img, buf.exponents).sum(dim=1))
        if q:
            lf = lf.to(torch.float32) * buf.scale
        fh = gather_feature_hist(lf, self.meta_pad, ltot)
        recs = per_feature_best(fh, ltot, self.meta_pad, self.params_dev,
                                self._pad_mask())
        # phase 1: each rank nominates its local top k (ties to the lower feature)
        nom = torch.sort(recs[..., 0], dim=1, descending=True, stable=True).indices
        nom = nom[:, :self.k_local]
        skew = faults.vote_skew_params()
        if skew is not None and self.world.rank == skew[0]:
            # vote_skew@R:K: this rank's nominations are garbage at wave K,
            # the highest feature ids (the padded, inert tail)
            garbage = (self.f_pad - 1 - torch.arange(self.k_local, device=self.device)) \
                % self.f_pad
            nom = torch.where(torch.as_tensor(wave_no, device=self.device) == skew[1],
                              garbage.expand_as(nom), nom)
        votes = dist.all_gather(self.world, nom)  # [n, M, k_l]
        counts = torch.zeros((M, self.f_pad), dtype=torch.int64, device=self.device)
        counts.scatter_add_(1, votes.permute(1, 0, 2).reshape(M, -1),
                            torch.ones_like(votes.permute(1, 0, 2).reshape(M, -1)))
        # phase 2: the 2k most voted, replicated and deterministic, ascending
        elected = torch.sort(counts, dim=1, descending=True, stable=True).indices
        elected = torch.sort(elected[:, :self.k_global], dim=1).values
        emask = torch.zeros((M, self.f_pad), dtype=torch.bool, device=self.device)
        emask.scatter_(1, elected, True)
        return elected, emask

    def _pad_mask(self) -> Optional[torch.Tensor]:
        if self._fmask is None:
            return None
        full = torch.zeros(self.f_pad, dtype=torch.bool, device=self.device)
        full[:self._fmask.shape[0]] = self._fmask
        return full

    def _elected_scan(self, local: HistImage, g0_local: HistImage, wave_no,
                      depths: torch.Tensor,
                      live=True) -> Tuple[torch.Tensor, torch.Tensor]:
        """Vote, reduce the elected slices with the group-0 rows, rescan:
        (records [M, REC], global totals [M, CH]). With the exact check,
        also count the leaves (at `depths`, while the wave is `live`) whose
        exact best feature the vote missed."""
        buf = self._buffers
        M = local.sums.shape[0]
        elected, emask = self._vote(local, g0_local, wave_no)
        gi, vs = self.meta_pad.gather_index, self.meta_pad.valid_slot
        Bm = self.meta.max_bins
        fimg = local.map(lambda t: gather_feature_hist_raw(t, gi, vs))  # [M, F_pad, Bm, CH]
        sel = elected[:, :, None, None].expand(M, self.k_global, Bm, 3)
        parts = fimg.map(lambda t: torch.gather(t, 1, sel).reshape(M, -1))
        both = HistImage(torch.cat([parts.sums, g0_local.sums.reshape(M, -1)], dim=1),
                         None if parts.flags is None else
                         torch.cat([parts.flags, g0_local.flags.reshape(M, -1)], dim=1))
        red = self._reduce(both.map(lambda t: t.reshape(-1)[None]), scatter=False)
        red = red.map(lambda t: t.reshape(M, -1))
        cut = self.k_global * Bm * 3
        g0 = red.map(lambda t: t[:, cut:].reshape(M, -1, 3))
        slices = red.map(lambda t: t[:, :cut].reshape(M, self.k_global, Bm, 3))
        totals = _totals(buf, image_to_float(g0, buf.exponents).sum(dim=1))
        sf = image_to_float(slices, buf.exponents)
        if self.quantized:
            sf = sf.to(torch.float32) * buf.scale
        full = torch.zeros((M, self.f_pad, Bm, 3), dtype=torch.float32, device=self.device)
        full.scatter_(1, sel, sf)
        m = self.meta_pad
        fh = fix_feature_hist(full, totals, m.efb_omitted, m.default_bin)
        recs = per_feature_best(fh, totals, m, self.params_dev, self._pad_mask())
        recs[..., 0] = torch.where(emask, recs[..., 0], float("-inf"))
        best = reduce_best_record(recs)
        if self._exact_check:
            self._count_misses(fimg, totals, best, depths, live)
        return best, totals

    def _count_misses(self, fimg: HistImage, totals: torch.Tensor, best: torch.Tensor,
                      depths: torch.Tensor, live) -> None:
        """The reduction the vote avoided: every feature's image summed over
        the ranks and rescanned; a leaf whose guarded exact best splits
        (gain > 0) on another feature than the vote's is a miss."""
        buf = self._buffers
        red = self._reduce(fimg.map(lambda t: t.reshape(1, -1)), scatter=False)
        full = image_to_float(red.map(lambda t: t.reshape(fimg.sums.shape)), buf.exponents)
        if self.quantized:
            full = full.to(torch.float32) * buf.scale
        m = self.meta_pad
        fh = fix_feature_hist(full, totals, m.efb_omitted, m.default_bin)
        fbest = reduce_best_record(per_feature_best(fh, totals, m, self.params_dev,
                                                    self._pad_mask()))
        p = self.params_dev
        gain = guard_gain(fbest[:, 0], totals[:, 2], totals[:, 1], depths, p[2], p[3],
                          int(self.config.max_depth))
        miss = ((gain > 0) & (fbest[:, 1] != best[:, 1])).sum()
        self._miss += torch.where(torch.as_tensor(live, device=self.device), miss, 0)

    def _root(self, buf: _ShardBuffers, bagged: bool) -> None:
        img, n_in = self._root_hist(buf, bagged)
        g0_local = img.map(lambda t: t[:, 0].contiguous())
        self._miss.zero_()
        recs, totals = self._elected_scan(img, g0_local, 0,
                                          torch.zeros(1, dtype=buf.depth.dtype,
                                                      device=self.device))
        buf.pool[0] = img.sums[0]
        if buf.pool_flags is not None:
            buf.pool_flags[0] = img.flags[0]
        self._start_tree(buf, recs[0], totals[0], n_in)

    def _wave(self, buf: _ShardBuffers, cur: int, K: int) -> None:
        table, sel_k, n_left, left_small, nl_g, nr_g, img = self._partition(buf, cur, K)
        hl, hr = children(pool_rows(buf, sel_k), img, left_small)  # local images
        both = stack_children(hl, hr)
        # the JAX grower's wave count: this wave's number, 1 the first
        wave_no = buf.scalars[N_WAVES] + 1
        depths = torch.repeat_interleave(buf.depth[sel_k.to(torch.int64)] + 1, 2)
        recs2, totals2 = self._elected_scan(both, both.map(lambda t: t[:, 0].contiguous()),
                                            wave_no, depths, buf.scalars[DONE] == 0)
        self._commit(buf, cur, table, n_left, recs2, totals2, sel_k, nl_g, nr_g, hl, hr,
                     None, None)

    def finalize(self, pending: _PendingTree) -> Tree:
        tree = super().finalize(pending)
        miss = int(self._miss.item()) if self._exact_check else 0
        global_timer.add_count("voting_miss_total", miss)
        faults.check_vote_skew_surfaced(miss, self._exact_check)
        return tree

    def _wire_model(self, K: int) -> int:
        return perfmodel.voting_ici_bytes_per_wave(K, self.k_local, self.k_global,
                                                   self.meta.max_bins, self.group_bin_padded,
                                                   value_bytes=self._value_bytes())

    def _record_ici_bytes(self, K: int) -> None:
        self.last_wire_bytes = self._wire_model(K)
        global_timer.set_count("device_ici_bytes_per_wave", self.last_wire_bytes)
        global_timer.set_count("voting_ici_bytes_per_wave", self.last_wire_bytes)


class DeviceFeatureParallelTreeLearner(DeviceDataParallelTreeLearner):
    """tree_learner=feature on the wave learner: rows replicated, the scan
    sharded over feature blocks (see the module's notes)."""

    mode = "feature"
    row_sharded = False

    def _pool_shape(self) -> Optional[Tuple[int, ...]]:
        return None

    def _find(self, hists: torch.Tensor, totals: torch.Tensor) -> torch.Tensor:
        """[M, G, B, CH] histograms (every rank's the same) -> [M, REC]: the
        rank's feature block gathered and scanned, its best records
        all-gathered, the argmax (ties to the lower rank: the lower
        features)."""
        buf = self._buffers
        if self.quantized:
            hists = hists.to(torch.float32) * buf.scale
        m = self.meta_blk
        fmask = None if self._fmask is None else self._block_mask()
        fh = gather_feature_hist(hists, m, totals)
        recs = per_feature_best(fh, totals, m, self.params_dev, fmask)
        feat = recs[..., 1]
        recs[..., 1] = torch.where(feat >= 0, feat + self.f0, -1.0)
        best = reduce_best_record(recs)  # [M, REC]
        allr = dist.all_gather(self.world, best)  # [n, M, REC]
        return reduce_best_record(allr.permute(1, 0, 2))

    def _root(self, buf: _ShardBuffers, bagged: bool) -> None:
        img, n_in = self._root_hist(buf, bagged)
        hist = image_to_float(img, buf.exponents)
        root_tot = _totals(buf, hist[0, 0].sum(dim=0))
        rec = self._find(hist, root_tot[None])[0]
        buf.pool[0] = img.sums[0]
        if buf.pool_flags is not None:
            buf.pool_flags[0] = img.flags[0]
        self._start_tree(buf, rec, root_tot, n_in)

    def _wave(self, buf: _ShardBuffers, cur: int, K: int) -> None:
        table, sel_k, n_left, left_small, nl_g, nr_g, img = self._partition(buf, cur, K)
        hl, hr = children(pool_rows(buf, sel_k), img, left_small)
        hists = image_to_float(stack_children(hl, hr), buf.exponents)
        totals2 = _totals(buf, hists[:, 0].contiguous().sum(dim=1))
        recs2 = self._find(hists, totals2)
        commit = replay_wave(buf.leaf_best, buf.depth, buf.rec_store, buf.start, buf.count,
                             buf.scalars, table, n_left, recs2, totals2, self.params_dev,
                             int(self.config.max_depth))
        pool_write(buf, commit, hl, hr)
        buf.count_g.index_copy_(0, commit[0], nl_g)
        buf.count_g.index_copy_(0, commit[1], nr_g)
        relabel_rows(buf.rows[1 - cur], 4, commit[2:])

    def _wire_model(self, K: int) -> int:
        return perfmodel.feature_ici_bytes_per_wave(K)

    def _record_ici_bytes(self, K: int) -> None:
        self.last_wire_bytes = self._wire_model(K)
        global_timer.set_count("device_ici_bytes_per_wave", self.last_wire_bytes)
        global_timer.set_count("feature_ici_bytes_per_wave", self.last_wire_bytes)
