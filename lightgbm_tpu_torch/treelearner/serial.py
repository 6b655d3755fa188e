"""Leaf-wise (best-first) tree learner, driven from the host.

Counterpart of the JAX package's ``treelearner/serial.py``
(SerialTreeLearner, src/treelearner/serial_tree_learner.cpp:182+): the
leaf-wise loop runs on the host, each step dispatching three device
computations —

  1. leaf histogram      (ops/histogram.py — the histogram kernel on the card,
                          over the leaf's count of rows, with the fixed-point
                          exponents computed once a tree)
  2. best-split search   (ops/split.py — one split-kernel launch on the card)
  3. partition update    (ops/partition.py — the decide and scatter kernels
                          on the card)

with the histogram-subtraction trick (larger child = parent − smaller,
feature_histogram.hpp:99) and one device→host sync per split search (the
packed best-split record) plus one per partition (the left count).

Histograms are cached per leaf (the HistogramPool analog), with an LRU cap
when histogram_pool_size is set.

The learner is unconstrained; it carries quantized gradients (use_quantized_grad: `_prepare_gh`, the JAX package's
serial.py:197-295): each tree's gradients become int8 (g, h, 1) rows
(ops/quantize.py, the discretizer kernel on the card) from the learner's
threefry key, split once a tree; the leaf histograms are exact int32 (the
histogram kernel's integer mode), subtracted in int32, and the split search
scales them by the tree's per-channel scale (ops/split.py:find_best_split's
`scale`); quant_train_renew_leaf renews the leaf outputs from the float
gradients.

Categorical features (the JAX package's serial.py:496-513) split on a bin
set: the split search's categorical lanes (ops/split.py:
per_feature_best_categorical) record the one-hot bin or the sorted subset's
length and direction; `_apply_split` derives the set on the host from the
same float32 histogram row the search saw, stores the bin and the value
bitsets in the tree, and partitions the rows through a go-left table of
the set. The dummy bin 0 (NaN, unseen and cut categories) joins no left
set, so its rows go right in training as at predict (LightGBM's scan; the
JAX package's takes it, ROADMAP Queue 3). A GOSS bag (a DeviceBag) reaches
the partition as host indices,
one pull a bag.

The learner's per-leaf lanes (the JAX package's serial.py:168-179, 297-441,
556-599): interaction constraints and per-node sampling mask each search by
the leaf's path (`features_in_path`); basic-mode monotone constraints carry
each leaf's output bounds (`bounds`, pinned at the output midpoint of a
split on a monotone feature) into the split kernel's constrained mode and
into the quantized leaf renewal; forced splits (`forcedsplits_filename`)
are applied at the top of every tree from the leaf histograms; CEGB
subtracts a per-leaf penalty vector (`treelearner/cegb.py`) and searches the
frontier again when a coupled penalty is lifted. With linear_tree the tree
tracks its leaves' branch features for the GBDT's linear fit
(`treelearner/linear.py`). Monotone methods other than `basic` are refused
(`refuse_unported`), as the JAX package refuses them.
"""
from __future__ import annotations

import json
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .. import perfmodel, telemetry
from ..common import MISSING_NAN
from ..config import Config
from ..io.dataset import Dataset
from ..models.tree import Tree
from ..ops.histogram import (build_histogram_rows, fixed_point_exponents, leaf_sums_fixed,
                             subtract_histogram)
from ..ops.partition import RowPartition
from ..ops.quantize import prng_key, quantize_gh, split_key
from ..models.sample_strategy import host_bag_indices
from ..ops.split import (FeatureMeta, SplitInfo, bins_to_bitset, derive_cat_left_bins,
                         find_best_split, gather_feature_hist, make_feature_meta)
from ..utils.log import Log
from ..utils.timer import global_timer
from .cegb import CEGB
from .col_sampler import ColSampler


@dataclass
class _LeafState:
    hist: Optional[torch.Tensor]  # [G, B, 3] leaf histogram (int32 when quantized)
    totals: Tuple[float, float, float]  # (sum_g, sum_h, count)
    split: Optional[SplitInfo]
    depth: int
    features_in_path: frozenset = frozenset()  # real indices (interaction constraints)
    # basic-mode monotone output bounds inherited from the ancestors
    # (monotone_constraints.hpp BasicLeafConstraints)
    bounds: Tuple[float, float] = (-np.inf, np.inf)


def has_monotone(dataset: Dataset) -> bool:
    return bool(dataset.monotone_constraints and any(dataset.monotone_constraints))


def refuse_unported(config: Config, dataset: Dataset) -> None:
    """Raise for a monotone method other than `basic`, which the JAX
    package refuses too (its serial.py:91-94)."""
    if has_monotone(dataset) and config.monotone_constraints_method not in ("basic",):
        Log.fatal("monotone_constraints_method=%s is not supported (only 'basic')",
                  config.monotone_constraints_method)


def learner_params(config: Config, device: torch.device) -> torch.Tensor:
    """The split search's [11] float32 regularizers: the six the numeric
    lanes read, then the five of the categorical lanes (the JAX serial
    learner's params_dev, serial.py:69-75)."""
    return torch.tensor([
        config.lambda_l1, config.lambda_l2,
        float(config.min_data_in_leaf), config.min_sum_hessian_in_leaf,
        config.min_gain_to_split, config.max_delta_step,
        float(config.max_cat_to_onehot), float(config.max_cat_threshold),
        config.cat_l2, config.cat_smooth, float(config.min_data_per_group),
    ], dtype=torch.float32, device=device)


class SerialTreeLearner:
    def __init__(self, config: Config, dataset: Dataset,
                 device: torch.device) -> None:
        refuse_unported(config, dataset)
        self.config = config
        self.dataset = dataset
        self.device = torch.device(device)
        self.num_data = dataset.num_data
        with global_timer.scope("learner_init"):
            self.bins_dev = self._device_bins(dataset)
        self.group_bin_padded = int(max(dataset.group_bin_counts().max(), 2))
        self.meta: FeatureMeta = make_feature_meta(dataset, self.group_bin_padded,
                                                   self.device)
        self.params_dev = learner_params(config, self.device)
        self.partition: Optional[RowPartition] = None
        self.col_sampler = ColSampler(config, self.meta.real_feature)
        self._tree_feature_mask: Optional[torch.Tensor] = None
        # HistogramPool byte cap (feature_histogram.hpp:1367-1597): when
        # histogram_pool_size (MB) is set, at most `_pool_cap` leaf
        # histograms stay materialized; LRU-evicted ones recompute on demand
        self._pool_cap = 0
        if config.histogram_pool_size > 0:
            hist_bytes = (len(dataset.groups) * self.group_bin_padded * 3 * 4)
            self._pool_cap = max(
                2, int(config.histogram_pool_size * 1024 * 1024 / hist_bytes))
        self._hist_lru: "OrderedDict[int, bool]" = OrderedDict()
        # quantized-gradient training (the GradientDiscretizer): the key
        # stream is jax.random's from PRNGKey(data_random_seed), split once a
        # tree on the host (ops/quantize.py)
        self.quantized = bool(config.use_quantized_grad)
        self._scale: Optional[torch.Tensor] = None  # [3] the tree's scales
        self._gh_float: Optional[torch.Tensor] = None  # kept for leaf renewal
        if self.quantized:
            self._quant_key = prng_key(config.data_random_seed)
        self._has_mc = has_monotone(dataset)
        self.cegb: Optional[CEGB] = (CEGB(config, dataset, self.device)
                                     if CEGB.enabled(config) else None)
        # forcedsplits_filename (SerialTreeLearner::ForceSplits,
        # serial_tree_learner.cpp:627+): nested {"feature", "threshold",
        # "left", "right"} JSON applied at the top of every tree
        self._forced_json = None
        if config.forcedsplits_filename:
            try:
                with open(config.forcedsplits_filename) as fh:
                    self._forced_json = json.load(fh)
            except OSError:
                Log.warning("Could not open forced splits file %s",
                            config.forcedsplits_filename)

    def _device_bins(self, dataset: Dataset) -> Optional[torch.Tensor]:
        """The bin plane on the device at its native width (uint8 when every
        group has <= 256 bins): the histogram kernel reads it unwidened. The
        streamed learner keeps it on the host and returns None."""
        return torch.from_numpy(np.ascontiguousarray(dataset.bins)).to(self.device)

    # ------------------------------------------------------------ checkpoint

    def snapshot_state(self) -> dict:
        """The learner's state that a bit-identical resume needs, as arrays
        (the checkpoint sidecar's npz) and scalars (its JSON manifest): the
        column sampler's MT19937 stream, the quantized gradients' key, and
        the dataset's shape (num_data, group_bin_padded), which restore
        refuses to cross."""
        kind, keys, pos, has_gauss, cached = self.col_sampler.rng.get_state()
        st = {
            "rng_kind": kind,
            "colsampler_keys": np.asarray(keys, dtype=np.uint32),
            "colsampler_pos": int(pos),
            "colsampler_has_gauss": int(has_gauss),
            "colsampler_cached_gaussian": float(cached),
            "num_data": int(self.num_data),
            "group_bin_padded": int(self.group_bin_padded),
        }
        if self.quantized:
            st["quant_key"] = np.asarray(self._quant_key, dtype=np.uint32)
        return st

    def restore_snapshot_state(self, st: dict) -> None:
        if int(st.get("num_data", self.num_data)) != int(self.num_data) \
                or int(st.get("group_bin_padded", self.group_bin_padded)) \
                != int(self.group_bin_padded):
            Log.fatal("Checkpoint learner state was captured on a different "
                      "dataset shape (num_data=%s, group_bin_padded=%s vs "
                      "%d, %d) — refusing to resume",
                      st.get("num_data"), st.get("group_bin_padded"),
                      self.num_data, self.group_bin_padded)
        self.col_sampler.rng.set_state((
            str(st["rng_kind"]),
            np.asarray(st["colsampler_keys"], dtype=np.uint32),
            int(st["colsampler_pos"]),
            int(st["colsampler_has_gauss"]),
            float(st["colsampler_cached_gaussian"])))
        if self.quantized and "quant_key" in st:
            self._quant_key = np.asarray(st["quant_key"], dtype=np.uint32).copy()

    def reset_config(self, config: Config) -> None:
        """Take a changed configuration (Booster.reset_parameter): the
        regularizers are written into params_dev in place, since the wave
        learner's captured graphs read that buffer."""
        self.config = config
        self.params_dev.copy_(learner_params(config, self.device))

    # ------------------------------------------------------------------ train

    def train(self, gh_ext: torch.Tensor,
              bag_indices: Optional[np.ndarray] = None) -> Tree:
        """Grow one tree from extended gradients gh_ext [N+1, 3] (zero
        sentinel row at N)."""
        cfg = self.config
        num_leaves = cfg.num_leaves
        tree = Tree(num_leaves, track_branch_features=cfg.linear_tree,
                    is_linear=cfg.linear_tree)
        self._begin_tree(gh_ext, bag_indices)

        frontier: Dict[int, _LeafState] = {}
        with global_timer.scope("hist_root"):
            root_hist = self._leaf_hist(0)
        root_totals = self._root_totals(root_hist)
        frontier[0] = _LeafState(root_hist, root_totals, None, depth=0)
        if not self._force_splits(tree, frontier):
            self._find_split(frontier, 0)

        for _ in range(num_leaves - 1):
            best_leaf, best = None, None
            for leaf, state in frontier.items():
                if state.split is not None and state.split.valid:
                    if best is None or state.split.gain > best.gain:
                        best_leaf, best = leaf, state.split
            if best_leaf is None:
                Log.debug("No further splits with positive gain, best gain: -inf")
                break
            self._apply_split(tree, frontier, best_leaf, best)
            if tree.num_leaves >= num_leaves:
                break

        if tree.num_leaves == 1:
            tree.as_constant_tree(0.0)
        elif self.quantized and cfg.quant_train_renew_leaf:
            self._renew_quantized_leaves(tree, frontier)
        return tree

    def _renew_quantized_leaves(self, tree: Tree, frontier: Dict[int, _LeafState]) -> None:
        """Recompute the leaf outputs from the float gradients, removing the
        quantization error (GradientDiscretizer::RenewIntGradTreeOutput,
        gradient_discretizer.cpp:166-233). Each leaf's (sum g, sum h) is
        summed exactly in fixed point (ops/histogram.py:leaf_sums_fixed), so
        the sums do not depend on the order of the rows or the device; they
        reach the host in one copy. Under monotone constraints a renewed
        output is clamped into its leaf's bounds, as the JAX package does
        (the reference renews unclamped), so the model stays monotone."""
        cfg = self.config
        part = self.partition
        L = tree.num_leaves
        counts = [part.count(leaf) for leaf in range(L)]
        rows = torch.cat([part.indices(leaf)[:cnt] for leaf, cnt in enumerate(counts)])
        leaf = torch.repeat_interleave(torch.arange(L, device=self.device),
                                       torch.as_tensor(counts, device=self.device))
        sums = leaf_sums_fixed(self._gh_float, rows.to(torch.int64), leaf, L).cpu().numpy()
        for i in range(L):
            out = _leaf_output_host(float(sums[i, 0]), float(sums[i, 1]), cfg.lambda_l1,
                                    cfg.lambda_l2, cfg.max_delta_step)
            if self._has_mc and i in frontier:
                lo, hi = frontier[i].bounds
                out = float(np.clip(out, lo, hi))
            tree.set_leaf_output(i, out)

    def _prepare_gh(self, gh_ext: torch.Tensor) -> torch.Tensor:
        """With use_quantized_grad, the tree's int8 (g, h, 1) rows and zero
        sentinel (ops/quantize.py:quantize_gh) from the next key of the
        learner's stream; the scales are kept for the split search and the
        float gradients for leaf renewal. Otherwise gh_ext as it is."""
        if not self.quantized:
            return gh_ext
        self._gh_float = gh_ext
        self._quant_key, sub = split_key(self._quant_key)
        gh, self._scale = quantize_gh(gh_ext[:-1, 0], gh_ext[:-1, 1], sub,
                                      self.config.num_grad_quant_bins,
                                      self.config.stochastic_rounding)
        return gh

    def _begin_tree(self, gh_ext: torch.Tensor,
                    bag_indices: Optional[np.ndarray]) -> None:
        self._gh = self._prepare_gh(gh_ext)
        # every leaf's rows are rows of gh_ext: the card's histograms of the
        # tree share its fixed-point exponents (the integer mode has none)
        self._exps = None if self.quantized else fixed_point_exponents(gh_ext, self.num_data)
        self._hist_lru.clear()
        partition = RowPartition(self.num_data, self.device)
        if bag_indices is not None:
            partition.set_used_indices(host_bag_indices(bag_indices))
        self.partition = partition
        if self.col_sampler.active:
            self._tree_feature_mask = torch.as_tensor(
                self.col_sampler.reset_by_tree(), device=self.device)
        else:
            self._tree_feature_mask = None

    def _leaf_hist(self, leaf: int) -> torch.Tensor:
        return build_histogram_rows(self.bins_dev, self._gh,
                                    self.partition.indices(leaf),
                                    self.group_bin_padded,
                                    count=self.partition.count(leaf),
                                    exponents=self._exps)

    def _subtract(self, parent, small):
        """The larger child's histogram from its parent's and the smaller
        child's (the voting learner subtracts exact images)."""
        return subtract_histogram(parent, small)

    def _partition_split(self, leaf: int, new_leaf: int, gi: int, decision,
                         cat_mask=None) -> Tuple[int, int]:
        """Split the leaf's rows on group gi's plane row (the streamed
        learner uploads that row from the host)."""
        return self.partition.split(leaf, new_leaf, self.bins_dev[gi], decision, cat_mask)

    def _root_totals(self, root_hist: torch.Tensor) -> Tuple[float, float, float]:
        # any group's bins partition all rows, so group 0's bin-sum = totals
        if not self.quantized:
            return tuple(float(x) for x in root_hist[0].sum(dim=0).cpu().numpy())
        # the JAX serial learner sums the scaled bins (serial.py:292-295).
        # Each nonzero scaled bin is a float32 multiple of the last bit of
        # the scale (its int32 count is at least 1), so while the bins hold
        # fewer than 2**29 of the scale in all, their float64 sum is exact in
        # any order; rounded to float32 once, the card and the CPU agree
        scaled = root_hist[0].to(torch.float32) * self._scale
        return tuple(float(x) for x in scaled.to(torch.float64).sum(dim=0)
                     .to(torch.float32).cpu().numpy())

    def _node_feature_mask(self, state: _LeafState) -> Optional[torch.Tensor]:
        cs = self.col_sampler
        if not cs.active:
            return None
        if cs.fraction_bynode < 1.0 or cs.constraints:
            return torch.as_tensor(cs.get_by_node(set(state.features_in_path)),
                                   device=self.device)
        return self._tree_feature_mask

    def _search_split(self, state: _LeafState, leaf: int) -> SplitInfo:
        # the totals and the bounds go by value: no upload for either
        args = (state.hist, state.totals, self.meta, self.params_dev,
                self._node_feature_mask(state), self._penalty_of(state, leaf))
        if telemetry.enabled():
            perfmodel.note_dispatch("scan", find_best_split, *args)
        rec = find_best_split(*args, scale=self._scale, constraint=self._constraint_of(state))
        return SplitInfo.from_packed(rec.cpu().numpy())

    def _constraint_of(self, state: _LeafState) -> Optional[Tuple[float, float]]:
        return state.bounds if self._has_mc else None

    def _penalty_of(self, state: _LeafState, leaf: int) -> Optional[torch.Tensor]:
        if self.cegb is None:
            return None
        with global_timer.scope("cegb_penalty"):
            rows = self._leaf_rows(leaf) if self.cegb.needs_rows else None
            return torch.from_numpy(self.cegb.penalty_vector(state.totals[2], rows)).to(
                self.device)

    def _leaf_rows(self, leaf: int) -> torch.Tensor:
        """A leaf's row indices on the device, to its count."""
        return self.partition.indices(leaf)[:self.partition.count(leaf)]

    def _cat_bin_stats(self, state: _LeafState, gi: int) -> np.ndarray:
        """The winning categorical feature's histogram row, [Bg, 3] float32
        on the host, scaled as the search scaled it (categorical features
        are never bundled, so the feature's row is its group's): the host's
        bin-set derivation replays the search's float32 values."""
        hist = state.hist[gi]
        if self.quantized:
            hist = hist.to(torch.float32) * self._scale
        return hist.cpu().numpy()

    def _feature_hist_row(self, state: _LeafState, dense_f: int) -> np.ndarray:
        """One feature's [Bmax, 3] float32 histogram (forced splits), with
        the EFB default bin rebuilt and scaled as the search sees it."""
        hist = state.hist
        if self.quantized:
            hist = hist.to(torch.float32) * self._scale
        totals = torch.tensor(state.totals, dtype=torch.float32, device=self.device)
        return gather_feature_hist(hist, self.meta, totals)[dense_f].cpu().numpy()

    # --------------------------------------------------------------- internal

    def _max_depth_ok(self, depth: int) -> bool:
        return self.config.max_depth <= 0 or depth < self.config.max_depth

    def _force_splits(self, tree: Tree, frontier: Dict[int, _LeafState]) -> int:
        """Apply the forced-splits JSON at the top of the tree
        (SerialTreeLearner::ForceSplits, serial_tree_learner.cpp:627+), breadth
        first. Returns the number of splits applied."""
        if self._forced_json is None:
            return 0
        count = 0
        queue = [(self._forced_json, 0)]
        with global_timer.scope("forced_splits"):
            while queue and tree.num_leaves < self.config.num_leaves:
                jnode, leaf = queue.pop(0)
                split = self._forced_split_info(frontier[leaf], jnode)
                if split is None:
                    continue
                new_leaf = tree.num_leaves
                self._apply_split(tree, frontier, leaf, split)
                count += 1
                if isinstance(jnode.get("left"), dict):
                    queue.append((jnode["left"], leaf))
                if isinstance(jnode.get("right"), dict):
                    queue.append((jnode["right"], new_leaf))
        return count

    def _forced_split_info(self, state: _LeafState, jnode) -> Optional[SplitInfo]:
        """The split record of a forced (feature, threshold) pair, from the
        leaf histogram at the forced bin in place of the search (the JAX
        package's serial.py:391-441, step by step)."""
        try:
            real_f = int(jnode["feature"])
            thr = float(jnode["threshold"])
        except (KeyError, TypeError, ValueError):
            return None
        if real_f not in self.meta.real_feature:
            return None
        dense_f = self.meta.real_feature.index(real_f)
        mapper = self.dataset.mappers[real_f]
        if mapper.bin_type == 1:  # categorical forced splits are not supported
            Log.warning("Forced split on categorical feature %d ignored", real_f)
            return None
        fh = self._feature_hist_row(state, dense_f)
        tbin = int(mapper.value_to_bin(thr))
        nb = mapper.num_bin
        has_nan = mapper.missing_type == MISSING_NAN
        # keep at least one real bin right of the threshold; with NaN missing
        # the last bin is the NaN bin, which clamping also keeps on the right
        # (default_left=False)
        if tbin >= nb - (2 if has_nan else 1):
            tbin = nb - (3 if has_nan else 2)
        if tbin < 0:
            return None
        left = fh[: tbin + 1].sum(axis=0)
        tg, th_, tc = state.totals
        lg, lh, lc = float(left[0]), float(left[1]), float(left[2])
        rg, rh, rc = tg - lg, th_ - lh, tc - lc
        cfg = self.config
        if (lc < cfg.min_data_in_leaf or rc < cfg.min_data_in_leaf
                or lh < cfg.min_sum_hessian_in_leaf
                or rh < cfg.min_sum_hessian_in_leaf):
            return None
        lout = _leaf_output_host(lg, lh, cfg.lambda_l1, cfg.lambda_l2, cfg.max_delta_step)
        rout = _leaf_output_host(rg, rh, cfg.lambda_l1, cfg.lambda_l2, cfg.max_delta_step)

        def g(sg, sh, out):
            sgl = np.sign(sg) * max(abs(sg) - cfg.lambda_l1, 0.0)
            return -(2.0 * sgl * out + (sh + cfg.lambda_l2) * out * out)

        parent_out = _leaf_output_host(tg, th_, cfg.lambda_l1, cfg.lambda_l2,
                                       cfg.max_delta_step)
        gain = g(lg, lh, lout) + g(rg, rh, rout) - g(tg, th_, parent_out)
        return SplitInfo(gain=float(gain), feature=dense_f, threshold_bin=tbin,
                         default_left=False, left_sum_g=lg, left_sum_h=lh,
                         left_count=int(round(lc)), right_sum_g=rg,
                         right_sum_h=rh, right_count=int(round(rc)),
                         left_output=lout, right_output=rout)

    def _pool_touch(self, frontier: Dict[int, _LeafState], leaf: int) -> None:
        """Materialize an evicted leaf histogram and refresh its LRU slot,
        evicting the coldest leaves past the pool cap."""
        state = frontier[leaf]
        if state.hist is None:
            with global_timer.scope("hist_recompute"):
                state.hist = self._leaf_hist(leaf)
        if not self._pool_cap:
            return
        lru = self._hist_lru
        lru.pop(leaf, None)
        lru[leaf] = True
        while len(lru) > self._pool_cap:
            old, _ = lru.popitem(last=False)
            old_state = frontier.get(old)
            if old_state is not None and old_state.hist is not None:
                old_state.hist = None

    def _find_split(self, frontier: Dict[int, _LeafState], leaf: int) -> None:
        state = frontier[leaf]
        cnt = state.totals[2]
        if (not self._max_depth_ok(state.depth)
                or cnt < 2 * self.config.min_data_in_leaf
                or state.totals[1] < 2 * self.config.min_sum_hessian_in_leaf):
            state.split = SplitInfo()
            return
        self._pool_touch(frontier, leaf)
        with global_timer.scope("find_best_split"):
            state.split = self._search_split(state, leaf)

    def _apply_split(self, tree: Tree, frontier: Dict[int, _LeafState],
                     leaf: int, split: SplitInfo) -> None:
        ds = self.dataset
        dense_f = split.feature
        real_f = self.meta.real_feature[dense_f]
        mapper = ds.mappers[real_f]
        gi, mi = ds.feature_to_group[real_f]
        fg = ds.groups[gi]
        lo, hi, _ = fg.feature_bin_range(mi)

        state = frontier[leaf]
        new_leaf = tree.num_leaves
        self._pool_touch(frontier, leaf)  # parent hist needed for subtraction

        # 1. record the split in the tree (real-value threshold, or the bin
        # and value bitsets of a categorical split)
        parent_output = _leaf_output_host(
            state.totals[0], state.totals[1],
            self.config.lambda_l1, self.config.lambda_l2,
            self.config.max_delta_step)
        cat_mask = None
        if split.is_categorical:
            left_bins = derive_cat_left_bins(self._cat_bin_stats(state, gi), mapper.num_bin,
                                             split, self.config.cat_smooth)
            split.cat_bitset_bins = left_bins
            cat_values = [mapper.bin_2_categorical[b] for b in left_bins
                          if 0 <= b < len(mapper.bin_2_categorical)]
            tree.split_categorical(
                leaf=leaf, feature_inner=dense_f, real_feature=real_f,
                bin_bitset=bins_to_bitset(left_bins),
                value_bitset=bins_to_bitset(cat_values),
                missing_type=mapper.missing_type, gain=split.gain,
                left_value=split.left_output, right_value=split.right_output,
                left_count=split.left_count, right_count=split.right_count,
                left_weight=split.left_sum_h, right_weight=split.right_sum_h,
                parent_value=parent_output)
            cat_mask = np.zeros(self.group_bin_padded, dtype=bool)
            cat_mask[np.asarray(left_bins, dtype=np.int64)] = True
        else:
            tree.split(leaf=leaf, feature_inner=dense_f, real_feature=real_f,
                       threshold_bin=split.threshold_bin,
                       threshold_double=mapper.bin_to_value(split.threshold_bin),
                       default_left=split.default_left,
                       missing_type=mapper.missing_type,
                       gain=split.gain,
                       left_value=split.left_output,
                       right_value=split.right_output,
                       left_count=split.left_count,
                       right_count=split.right_count,
                       left_weight=split.left_sum_h,
                       right_weight=split.right_sum_h,
                       parent_value=parent_output)

        # 2. partition rows (one host sync for the left count)
        decision = (float(split.threshold_bin), 1.0 if split.default_left else 0.0,
                    float(mapper.missing_type), float(mapper.default_bin),
                    float(mapper.num_bin), float(lo), float(hi),
                    1.0 if fg.is_multi else 0.0)
        with global_timer.scope("partition"):
            left_cnt, right_cnt = self._partition_split(leaf, new_leaf, gi, decision,
                                                        cat_mask)
        if left_cnt != split.left_count or right_cnt != split.right_count:
            Log.debug("Partition count mismatch at leaf %d: %d/%d vs %d/%d",
                      leaf, left_cnt, right_cnt, split.left_count, split.right_count)

        # 3. child histograms: construct the smaller, subtract for the larger
        parent_hist = state.hist
        left_totals = (split.left_sum_g, split.left_sum_h, float(left_cnt))
        right_totals = (split.right_sum_g, split.right_sum_h, float(right_cnt))
        with global_timer.scope("hist_children"):
            if left_cnt <= right_cnt:
                small, big = leaf, new_leaf
            else:
                small, big = new_leaf, leaf
            small_hist = self._leaf_hist(small)
            big_hist = self._subtract(parent_hist, small_hist)
        depth = state.depth + 1
        child_path = state.features_in_path | {int(real_f)}
        # monotone bound propagation (BasicLeafConstraints::Update,
        # monotone_constraints.hpp:487-503): a numerical split on a monotone
        # feature pins the children's shared boundary at the output midpoint
        lbounds = rbounds = state.bounds
        if self._has_mc and not split.is_categorical:
            mono = (ds.monotone_constraints[real_f]
                    if real_f < len(ds.monotone_constraints) else 0)
            if mono != 0:
                b_lo, b_hi = state.bounds
                mid = (split.left_output + split.right_output) / 2.0
                if mono > 0:
                    lbounds, rbounds = (b_lo, min(b_hi, mid)), (max(b_lo, mid), b_hi)
                else:
                    lbounds, rbounds = (max(b_lo, mid), b_hi), (b_lo, min(b_hi, mid))
        frontier[leaf] = _LeafState(
            small_hist if small == leaf else big_hist, left_totals, None, depth,
            child_path, lbounds)
        frontier[new_leaf] = _LeafState(
            small_hist if small == new_leaf else big_hist, right_totals, None,
            depth, child_path, rbounds)
        state.hist = None  # release parent histogram
        self._hist_lru.pop(leaf, None)
        self._pool_touch(frontier, leaf)
        self._pool_touch(frontier, new_leaf)
        refresh_frontier = False
        if self.cegb is not None:
            with global_timer.scope("cegb_penalty"):
                rows = None
                if self.cegb.needs_rows:
                    rows = torch.cat([self._leaf_rows(leaf), self._leaf_rows(new_leaf)])
                refresh_frontier = self.cegb.on_split_applied(dense_f, rows)
        self._find_split(frontier, leaf)
        self._find_split(frontier, new_leaf)
        if refresh_frontier:
            # a coupled feature penalty was just lifted: search the other
            # pending leaves again so their gains drop it
            # (UpdateLeafBestSplits, cost_effective_gradient_boosting.hpp:100)
            for lf in frontier:
                if lf not in (leaf, new_leaf):
                    self._find_split(frontier, lf)


def _leaf_output_host(sum_g: float, sum_h: float, l1: float, l2: float,
                      max_delta: float) -> float:
    num = -np.sign(sum_g) * max(abs(sum_g) - l1, 0.0)
    out = num / max(sum_h + l2, 1e-15)
    if max_delta > 0:
        out = float(np.clip(out, -max_delta, max_delta))
    return float(out)


def device_growth_applies(device: torch.device, config: Config,
                          dataset: Dataset) -> bool:
    """Whether the JAX package would grow this configuration's trees with
    its whole-tree wave learner (DeviceTreeLearner).

    The wave learner is selected on accelerators only; device_type=cpu
    forces the host-driven learner. Per-node feature masks, per-leaf
    bounds and penalties, linear trees and forced splits need the
    host-driven loop, as do categorical features.
    """
    on_accelerator = torch.device(device).type == "cuda"
    has_cat = any(dataset.mappers[f].bin_type == 1
                  for f in dataset.used_features)
    needs_host = (config.feature_fraction_bynode < 1.0
                  or bool(config.interaction_constraints)
                  or has_monotone(dataset)
                  or CEGB.enabled(config)
                  or config.linear_tree
                  or bool(config.forcedsplits_filename))
    return on_accelerator and not has_cat and not needs_host


def create_tree_learner(learner_type: str, device: torch.device, config: Config,
                        dataset: Dataset) -> SerialTreeLearner:
    """Factory (tree_learner.cpp:17-57): the out-of-core streamed learner
    when LGBM_TPU_HBM_BUDGET asks for it (before the wave learner: a plane
    that needs a budget must not be uploaded whole), the wave learner
    (DeviceTreeLearner) where `device_growth_applies`, else the serial
    learner; data, feature and voting go to the distributed learners
    (parallel/learners.py:create_parallel_learner)."""
    if learner_type in ("serial",):
        if streamed.streaming_requested():
            return streamed.StreamedTreeLearner(config, dataset, device)
        if device_growth_applies(device, config, dataset):
            from .device import DeviceTreeLearner

            return DeviceTreeLearner(config, dataset, device)
        return SerialTreeLearner(config, dataset, device)
    if learner_type in ("feature", "data", "voting"):
        from ..parallel.learners import create_parallel_learner

        return create_parallel_learner(learner_type, config, dataset, device)
    Log.fatal("Unknown tree learner type: %s", learner_type)


# the streamed learner subclasses SerialTreeLearner, so its module comes
# once the class exists (and takes the class itself, not whatever a caller
# has since put in its place)
from ..streaming import learner as streamed  # noqa: E402
