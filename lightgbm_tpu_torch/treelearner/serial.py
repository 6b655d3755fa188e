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
one pull a bag. Monotone and interaction constraints, CEGB, linear trees
and forced splits are refused when the learner is built
(`refuse_unported`).
"""
from __future__ import annotations

import os
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..io.dataset import Dataset
from ..models.tree import Tree
from ..ops.histogram import (build_histogram_rows, fixed_point_exponents, leaf_sums_fixed,
                             subtract_histogram)
from ..ops.partition import RowPartition
from ..ops.quantize import prng_key, quantize_gh, split_key
from ..models.sample_strategy import host_bag_indices
from ..ops.split import (FeatureMeta, SplitInfo, bins_to_bitset, derive_cat_left_bins,
                         find_best_split, make_feature_meta)
from ..utils.log import Log
from ..utils.timer import global_timer
from .col_sampler import ColSampler


@dataclass
class _LeafState:
    hist: Optional[torch.Tensor]  # [G, B, 3] leaf histogram (int32 when quantized)
    totals: Tuple[float, float, float]  # (sum_g, sum_h, count)
    split: Optional[SplitInfo]
    depth: int


def refuse_unported(config: Config, dataset: Dataset) -> None:
    """Raise for a configuration whose learner features are not ported yet,
    rather than training a different model than the JAX package would."""
    checks = (
        (bool(dataset.monotone_constraints and any(dataset.monotone_constraints)),
         "monotone constraints"),
        (bool(config.interaction_constraints), "interaction constraints"),
        (config.cegb_penalty_split > 0.0 or bool(config.cegb_penalty_feature_coupled)
         or bool(config.cegb_penalty_feature_lazy),
         "cost-effective gradient boosting (CEGB)"),
        (config.linear_tree, "linear trees"),
        (bool(config.forcedsplits_filename), "forced splits"),
    )
    for refused, what in checks:
        if refused:
            Log.fatal("%s: not yet ported to the PyTorch package "
                      "(ROADMAP Queue 1 item 6.3, 6.4)", what)


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
        # device-resident bin plane at its native width (uint8 when every
        # group has <= 256 bins): the histogram kernel reads it unwidened
        with global_timer.scope("learner_init"):
            self.bins_dev = torch.from_numpy(np.ascontiguousarray(dataset.bins)).to(
                self.device)
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
        tree = Tree(num_leaves)
        self._begin_tree(gh_ext, bag_indices)

        frontier: Dict[int, _LeafState] = {}
        with global_timer.scope("hist_root"):
            root_hist = self._leaf_hist(0)
        root_totals = self._root_totals(root_hist)
        frontier[0] = _LeafState(root_hist, root_totals, None, depth=0)
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
            self._renew_quantized_leaves(tree)
        return tree

    def _renew_quantized_leaves(self, tree: Tree) -> None:
        """Recompute the leaf outputs from the float gradients, removing the
        quantization error (GradientDiscretizer::RenewIntGradTreeOutput,
        gradient_discretizer.cpp:166-233). Each leaf's (sum g, sum h) is
        summed exactly in fixed point (ops/histogram.py:leaf_sums_fixed), so
        the sums do not depend on the order of the rows or the device; they
        reach the host in one copy."""
        cfg = self.config
        part = self.partition
        L = tree.num_leaves
        counts = [part.count(leaf) for leaf in range(L)]
        rows = torch.cat([part.indices(leaf)[:cnt] for leaf, cnt in enumerate(counts)])
        leaf = torch.repeat_interleave(torch.arange(L, device=self.device),
                                       torch.as_tensor(counts, device=self.device))
        sums = leaf_sums_fixed(self._gh_float, rows.to(torch.int64), leaf, L).cpu().numpy()
        for i in range(L):
            tree.set_leaf_output(i, _leaf_output_host(
                float(sums[i, 0]), float(sums[i, 1]), cfg.lambda_l1, cfg.lambda_l2,
                cfg.max_delta_step))

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

    def _node_feature_mask(self) -> Optional[torch.Tensor]:
        cs = self.col_sampler
        if not cs.active:
            return None
        if cs.fraction_bynode < 1.0 or cs.constraints:
            return torch.as_tensor(cs.get_by_node(set()), device=self.device)
        return self._tree_feature_mask

    def _search_split(self, state: _LeafState) -> SplitInfo:
        # the totals go by value: no upload a call
        rec = find_best_split(state.hist, state.totals, self.meta, self.params_dev,
                              self._node_feature_mask(), scale=self._scale)
        return SplitInfo.from_packed(rec.cpu().numpy())

    def _cat_bin_stats(self, state: _LeafState, gi: int) -> np.ndarray:
        """The winning categorical feature's histogram row, [Bg, 3] float32
        on the host, scaled as the search scaled it (categorical features
        are never bundled, so the feature's row is its group's): the host's
        bin-set derivation replays the search's float32 values."""
        hist = state.hist[gi]
        if self.quantized:
            hist = hist.to(torch.float32) * self._scale
        return hist.cpu().numpy()

    # --------------------------------------------------------------- internal

    def _max_depth_ok(self, depth: int) -> bool:
        return self.config.max_depth <= 0 or depth < self.config.max_depth

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
            state.split = self._search_split(state)

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
            left_cnt, right_cnt = self.partition.split(
                leaf, new_leaf, self.bins_dev[gi], decision, cat_mask)
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
            big_hist = subtract_histogram(parent_hist, small_hist)
        depth = state.depth + 1
        frontier[leaf] = _LeafState(
            small_hist if small == leaf else big_hist, left_totals, None, depth)
        frontier[new_leaf] = _LeafState(
            small_hist if small == new_leaf else big_hist, right_totals, None,
            depth)
        state.hist = None  # release parent histogram
        self._hist_lru.pop(leaf, None)
        self._pool_touch(frontier, leaf)
        self._pool_touch(frontier, new_leaf)
        self._find_split(frontier, leaf)
        self._find_split(frontier, new_leaf)


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
    cegb = (config.cegb_penalty_split > 0.0
            or bool(config.cegb_penalty_feature_coupled)
            or bool(config.cegb_penalty_feature_lazy))
    needs_host = (config.feature_fraction_bynode < 1.0
                  or bool(config.interaction_constraints)
                  or bool(dataset.monotone_constraints
                          and any(dataset.monotone_constraints))
                  or cegb
                  or config.linear_tree
                  or bool(config.forcedsplits_filename))
    return on_accelerator and not has_cat and not needs_host


def create_tree_learner(learner_type: str, device: torch.device, config: Config,
                        dataset: Dataset) -> SerialTreeLearner:
    """Factory (tree_learner.cpp:17-57): the wave learner (DeviceTreeLearner)
    where `device_growth_applies`, else the serial learner. A configuration
    the JAX package gives to its streamed or distributed learners is
    refused: the port trains it with neither yet, and does not silently
    swap in the serial learner."""
    if learner_type in ("serial",):
        if os.environ.get("LGBM_TPU_HBM_BUDGET"):
            Log.fatal("LGBM_TPU_HBM_BUDGET asks for the out-of-core streamed "
                      "learner, which is not yet ported to the PyTorch package "
                      "(ROADMAP Queue 1 item 9)")
        if device_growth_applies(device, config, dataset):
            from .device import DeviceTreeLearner

            return DeviceTreeLearner(config, dataset, device)
        return SerialTreeLearner(config, dataset, device)
    if learner_type in ("feature", "data", "voting"):
        Log.fatal("tree_learner=%s: the distributed learners are not yet "
                  "ported to the PyTorch package (ROADMAP Queue 1 item 8)",
                  learner_type)
    Log.fatal("Unknown tree learner type: %s", learner_type)
