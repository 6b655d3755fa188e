"""The host-driven distributed learners and the factory (the JAX package's
``parallel/learners.py:112-475`` and ``:789-849``).

Each rank is one process with the whole host dataset and the GBDT's
replicated state (scores, gradients, the column sampler's stream); a
learner shards the tree's work over the gang (parallel/mesh.py:World) and
meets the other ranks in collectives (parallel/dist.py). These learners
run the serial learner's leaf-wise loop (treelearner/serial.py), so they
carry every lane the wave learners refuse (`device_growth_applies`):
categorical features, per-node feature sampling, monotone and interaction
constraints, forced splits.

* DataParallelTreeLearner (tree_learner=data): rows sharded. A leaf's
  histogram is the rows kernel's image of the rank's rows of the leaf,
  summed over the ranks (all-reduce) and converted once (on the card:
  exact, whatever the gradients; on the CPU the plain float32 sums, the
  JAX package's contract), so every rank holds the leaf's whole histogram
  and runs the serial learner's search on it. The partition is local; the
  left counts are summed. At the end of a tree the leaf ids are
  all-gathered into a DevicePartition over every row.
* FeatureParallelTreeLearner (tree_learner=feature): rows replicated; each
  rank scans its block of the features (numeric and categorical lanes, the
  better per feature) and the best records are all-gathered.
* VotingParallelTreeLearner (tree_learner=voting, PV-Tree): rows sharded,
  each leaf's histogram the rank's own (on the card an image, subtracted
  exactly); the search nominates each rank's top_k features from its local
  scan, elects the 2 top_k most voted, all-reduces only the elected
  features' slices and rescans them with the leaf's global totals.

CEGB is refused with a parallel learner, as in the JAX package
(learners.py:819-821), and so is the streaming budget (LGBM_TPU_HBM_BUDGET),
whose gang-sharded learner is ROADMAP Queue 1 item 9.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..models.sample_strategy import host_bag_indices
from ..ops.histogram import (HistImage, build_histogram_rows, fixed_point_exponents_of_max,
                             image_sub, image_to_float)
from ..ops.partition import RowPartition
from ..ops.quantize import int16_reduction_safe
from ..ops.split import (SplitInfo, constraint_bounds, feature_meta_block,
                         fix_feature_hist, gather_feature_hist, gather_feature_hist_raw,
                         pad_feature_meta, per_feature_best, per_feature_best_categorical,
                         reduce_best_record)
from ..treelearner.device import DevicePartition
from ..treelearner.serial import SerialTreeLearner, _LeafState
from ..utils.log import Log
from ..utils.timer import global_timer
from . import dist
from .mesh import World, data_world
from .wave_learners import decode_flags, encode_flags


def _better_record(num: torch.Tensor, cat: torch.Tensor) -> torch.Tensor:
    """Per feature the categorical record where its gain is strictly the
    larger (a feature is one or the other, so one of the two is -inf)."""
    return torch.where((cat[..., :1] > num[..., :1]), cat, num)


class _RowSharded:
    """What the row-sharded host learners share: the rank's rows of the
    plane, the tree's exponents from the global maximum, the exact
    all-reduce of an image, the global counts and the whole partition."""

    world: World

    def _init_rows(self, world: World, dataset) -> None:
        self.world = world
        self._lo, self._hi = world.row_range(dataset.num_data)

    def _device_bins(self, dataset):
        self.bins_shard = torch.from_numpy(np.ascontiguousarray(
            dist.shard_rows(dataset.bins, self.world, dataset.num_data))).to(self.device)
        return None

    def _begin_rows(self, gh_ext: torch.Tensor, bag_indices) -> None:
        gh = self._prepare_gh(gh_ext)
        self._gh = gh
        lo, hi = self._lo, self._hi
        self._gh_local = torch.cat([gh[lo:hi], gh[-1:]])  # the zero sentinel row
        self._nonfinite = False
        self._exps = None
        if not self.quantized:
            g = gh_ext[lo:hi]
            m = torch.cat([g.abs().nan_to_num(nan=0.0, posinf=0.0).amax(dim=0),
                           (~torch.isfinite(g)).any()[None].to(g.dtype)])
            m = dist.all_reduce(self.world, m, op="max")
            self._exps = fixed_point_exponents_of_max(m[:3], self.num_data)
            self._nonfinite = bool(m[3].item() > 0)
        self._hist_lru.clear()
        part = RowPartition(hi - lo, self.device)
        if bag_indices is not None:
            idx = np.asarray(host_bag_indices(bag_indices), dtype=np.int64)
            idx = idx[(idx >= lo) & (idx < hi)] - lo
            part.set_used_indices(idx.astype(np.int32))
        self.partition = part
        n_in = torch.tensor([part.count(0)], dtype=torch.int64, device=self.device)
        self._gcounts = {0: int(dist.all_reduce(self.world, n_in).item())}
        if self.col_sampler.active:
            self._tree_feature_mask = torch.as_tensor(self.col_sampler.reset_by_tree(),
                                                      device=self.device)
        else:
            self._tree_feature_mask = None

    def _local_image(self, leaf: int) -> HistImage:
        """The rank's rows of the leaf: the rows kernel's image on the
        card's float mode, else the histogram as it is."""
        part = self.partition
        args = (self.bins_shard, self._gh_local, part.indices(leaf), self.group_bin_padded)
        if self.quantized or self.device.type == "cpu":
            return HistImage(build_histogram_rows(*args, count=part.count(leaf),
                                                  exponents=self._exps))
        from ..ops.hist_cuda import histogram

        return histogram(*args, count=part.count(leaf), exponents=self._exps, image=True)

    def _reduce(self, img: HistImage, leaf_count: int) -> HistImage:
        """The SUM over the ranks (int32 on the packed int16 wire where the
        leaf's global count keeps it within int16)."""
        w = self.world
        if self.quantized and int16_reduction_safe(leaf_count,
                                                   self.config.num_grad_quant_bins):
            flat = img.sums.reshape(1, -1)
            out = dist.all_reduce(w, dist.pack_int16_pairs(flat))
            return HistImage(dist.unpack_int16_pairs(out, flat.shape[1]).reshape(
                img.sums.shape))
        sums = dist.all_reduce(w, img.sums)
        flags = img.flags
        if flags is not None and self._nonfinite:
            flags = decode_flags(dist.all_reduce(w, encode_flags(flags)))
        return HistImage(sums, flags)

    def _partition_split(self, leaf: int, new_leaf: int, gi: int, decision,
                         cat_mask=None):
        """The rank's rows split locally; the global (left, right) counts."""
        left, right = self.partition.split(leaf, new_leaf, self.bins_shard[gi], decision,
                                           cat_mask)
        both = torch.tensor([left, right], dtype=torch.int64, device=self.device)
        left, right = (int(v) for v in dist.all_reduce(self.world, both).cpu())
        self._gcounts[leaf], self._gcounts[new_leaf] = left, right
        return left, right

    def _full_partition(self) -> None:
        """The tree's leaf ids over every row (out of the bag -1),
        all-gathered from the ranks' partitions, as a DevicePartition."""
        if isinstance(self.partition, DevicePartition):
            return
        part = self.partition
        ids = torch.full((self._hi - self._lo,), -1, dtype=torch.int32, device=self.device)
        for leaf in sorted(self._gcounts):
            cnt = part.count(leaf)
            if cnt:
                ids[part.indices(leaf)[:cnt].to(torch.int64)] = leaf
        full = dist.all_gather_rows(self.world, ids, self.num_data)
        self.partition = DevicePartition(full, dict(self._gcounts))

    def train(self, gh_ext: torch.Tensor, bag_indices=None):
        tree = super().train(gh_ext, bag_indices)
        self._full_partition()
        return tree

    def _renew_quantized_leaves(self, tree, frontier) -> None:
        self._full_partition()
        super()._renew_quantized_leaves(tree, frontier)

    def add_tree_to_score_blocked(self, tree, score: torch.Tensor, row_idx: torch.Tensor,
                                  max_depth: int = 0) -> torch.Tensor:
        """Out-of-bag rows scored over the ranks' rows (see
        wave_learners.DeviceDataParallelTreeLearner.add_tree_to_score_blocked)."""
        from .wave_learners import DeviceDataParallelTreeLearner

        return DeviceDataParallelTreeLearner.add_tree_to_score_blocked(
            self, tree, score, row_idx, max_depth)

    def snapshot_state(self) -> dict:
        st = super().snapshot_state()
        st["n_devices"] = int(self.world.size)
        return st

    def restore_snapshot_state(self, st: dict) -> None:
        st = dict(st)
        st.pop("n_devices", None)
        super().restore_snapshot_state(st)


class DataParallelTreeLearner(_RowSharded, SerialTreeLearner):
    """tree_learner=data through the serial learner's loop (see the
    module's notes)."""

    def __init__(self, config, dataset, device, world: World) -> None:
        self._init_rows(world, dataset)
        super().__init__(config, dataset, device)

    def _begin_tree(self, gh_ext: torch.Tensor, bag_indices) -> None:
        self._begin_rows(gh_ext, bag_indices)

    def _leaf_hist(self, leaf: int) -> torch.Tensor:
        img = self._reduce(self._local_image(leaf), self._gcounts.get(leaf, self.num_data))
        return image_to_float(img, self._exps)


class FeatureParallelTreeLearner(SerialTreeLearner):
    """tree_learner=feature through the serial learner's loop: rows
    replicated, the search sharded over feature blocks."""

    def __init__(self, config, dataset, device, world: World) -> None:
        self.world = world
        super().__init__(config, dataset, device)
        F = len(self.meta.real_feature)
        self.f_pad, self.f_local, self.f0 = world.feature_block(F)
        self.meta_pad = pad_feature_meta(self.meta, self.f_pad)
        self.meta_blk = feature_meta_block(self.meta_pad, self.f0, self.f0 + self.f_local)

    def _block(self, mask: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        if mask is None:
            return None
        full = torch.zeros(self.f_pad, dtype=torch.bool, device=self.device)
        full[:mask.shape[0]] = mask
        return full[self.f0:self.f0 + self.f_local].contiguous()

    def _search_split(self, state: _LeafState, leaf: int) -> SplitInfo:
        hist = state.hist
        if self.quantized:
            hist = hist.to(torch.float32) * self._scale
        totals = torch.tensor(state.totals, dtype=torch.float32, device=self.device)
        m = self.meta_blk
        mask = self._block(self._node_feature_mask(state))
        bounds = self._constraint_of(state)
        fh = gather_feature_hist(hist, m, totals)
        recs = per_feature_best(fh, totals, m, self.params_dev, mask, None, bounds)
        if self.meta.has_categorical:
            c = None if bounds is None else torch.stack(constraint_bounds(bounds, self.device))
            recs = _better_record(recs, per_feature_best_categorical(
                fh, totals, m, self.params_dev, mask, None, c))
        feat = recs[:, 1]
        recs[:, 1] = torch.where(feat >= 0, feat + self.f0, -1.0)
        allr = dist.all_gather(self.world, reduce_best_record(recs))  # [n, REC]
        return SplitInfo.from_packed(dist.host_value(reduce_best_record(allr)))


class VotingParallelTreeLearner(_RowSharded, SerialTreeLearner):
    """tree_learner=voting through the serial learner's loop (PV-Tree, see
    the module's notes)."""

    def __init__(self, config, dataset, device, world: World) -> None:
        self._init_rows(world, dataset)
        super().__init__(config, dataset, device)
        F = len(self.meta.real_feature)
        self.f_pad = max(F, 1)
        self.meta_pad = pad_feature_meta(self.meta, self.f_pad)
        self.k_local = max(1, min(int(config.top_k), F))
        self.k_global = max(1, min(2 * int(config.top_k), F))

    def _begin_tree(self, gh_ext: torch.Tensor, bag_indices) -> None:
        self._begin_rows(gh_ext, bag_indices)

    def _leaf_hist(self, leaf: int) -> HistImage:
        return self._local_image(leaf)

    def _subtract(self, parent: HistImage, small: HistImage) -> HistImage:
        return image_sub(parent, small)

    def _global_rows(self, state: _LeafState, gi: int) -> torch.Tensor:
        """Group gi's rows of the leaf's histogram, summed over the ranks."""
        img = self._reduce(state.hist.map(lambda t: t[gi:gi + 1].contiguous()), 1 << 30)
        return image_to_float(img, self._exps)[0]

    def _root_totals(self, root_hist: HistImage):
        g0 = self._global_rows(_LeafState(root_hist, (0.0, 0.0, 0.0), None, 0), 0)
        return tuple(float(x) for x in g0.sum(dim=0).cpu().numpy())

    def _cat_bin_stats(self, state: _LeafState, gi: int) -> np.ndarray:
        return self._global_rows(state, gi).cpu().numpy()

    def _feature_hist_row(self, state: _LeafState, dense_f: int) -> np.ndarray:
        img = self._reduce(state.hist, 1 << 30)
        hist = image_to_float(img, self._exps)
        totals = torch.tensor(state.totals, dtype=torch.float32, device=self.device)
        return gather_feature_hist(hist, self.meta, totals)[dense_f].cpu().numpy()

    def _scan(self, fh, totals, mask, bounds):
        m = self.meta_pad
        recs = per_feature_best(fh, totals, m, self.params_dev, mask, None, bounds)
        if self.meta.has_categorical:
            c = None if bounds is None else torch.stack(constraint_bounds(bounds, self.device))
            recs = _better_record(recs, per_feature_best_categorical(
                fh, totals, m, self.params_dev, mask, None, c))
        return recs

    def _search_split(self, state: _LeafState, leaf: int) -> SplitInfo:
        hist = state.hist  # this rank's image of the leaf
        mask = self._node_feature_mask(state)
        bounds = self._constraint_of(state)
        local = image_to_float(hist, self._exps)
        ltot = local[0].sum(dim=0)
        fh = gather_feature_hist(local, self.meta_pad, ltot)
        recs = self._scan(fh, ltot, mask, bounds)
        # phase 1: the rank's local top k; phase 2: the 2k most voted
        nom = torch.sort(recs[:, 0], descending=True, stable=True).indices[:self.k_local]
        votes = dist.all_gather(self.world, nom).reshape(-1)
        counts = torch.zeros(self.f_pad, dtype=torch.int64, device=self.device)
        counts.scatter_add_(0, votes, torch.ones_like(votes))
        elected = torch.sort(torch.sort(counts, descending=True, stable=True)
                             .indices[:self.k_global]).values
        gi, vs = self.meta_pad.gather_index, self.meta_pad.valid_slot
        fimg = hist.map(lambda t: gather_feature_hist_raw(t, gi, vs)[elected].contiguous())
        red = self._reduce(fimg, 1 << 30)
        sf = image_to_float(red, self._exps)
        full = torch.zeros((self.f_pad, *sf.shape[1:]), dtype=torch.float32,
                           device=self.device)
        full[elected] = sf
        totals = torch.tensor(state.totals, dtype=torch.float32, device=self.device)
        m = self.meta_pad
        fh = fix_feature_hist(full, totals, m.efb_omitted, m.default_bin)
        recs = self._scan(fh, totals, mask, bounds)
        emask = torch.zeros(self.f_pad, dtype=torch.bool, device=self.device)
        emask[elected] = True
        recs[:, 0] = torch.where(emask, recs[:, 0], float("-inf"))
        return SplitInfo.from_packed(dist.host_value(reduce_best_record(recs)))


def _refuse(config) -> None:
    from ..streaming.learner import streaming_requested
    from ..treelearner.cegb import CEGB

    if CEGB.enabled(config):
        Log.fatal("cegb_* parameters are not supported with distributed tree learners "
                  "(use tree_learner=serial)")
    if streaming_requested():
        Log.fatal("LGBM_TPU_HBM_BUDGET streaming with tree_learner=%s needs the "
                  "gang-sharded streamed learner, not yet ported to the PyTorch package "
                  "(ROADMAP Queue 1 item 9)", config.tree_learner)


def create_parallel_learner(learner_type: str, config, dataset, device):
    """tree_learner=data / feature / voting: the gang's world (joined first
    when the conf or the environment names one), then the sharded wave
    learner where `device_growth_applies`, else the host-driven learner."""
    from ..treelearner.serial import device_growth_applies
    from . import wave_learners as wl

    dist.init_distributed(config)
    if config.pre_partition:
        Log.warning("pre_partition=true is not yet honored: every process loads the full "
                    "dataset (the device holds the rank's rows only)")
    _refuse(config)
    world = data_world(config.num_machines, device)
    on_device = device_growth_applies(device, config, dataset)
    if config.use_quantized_grad and learner_type == "voting" and not on_device:
        Log.fatal("use_quantized_grad is not supported with the host tree_learner=voting "
                  "learner (use data or feature)")
    with global_timer.scope("learner_init"):
        if learner_type == "data":
            cls = wl.DeviceDataParallelTreeLearner if on_device else DataParallelTreeLearner
        elif learner_type == "feature":
            cls = (wl.DeviceFeatureParallelTreeLearner if on_device
                   else FeatureParallelTreeLearner)
        elif learner_type == "voting":
            cls = (wl.VotingDataParallelTreeLearner if on_device
                   else VotingParallelTreeLearner)
        else:
            Log.fatal("Unknown parallel tree learner type: %s", learner_type)
        return cls(config, dataset, device, world)
