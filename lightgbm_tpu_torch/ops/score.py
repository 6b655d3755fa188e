"""Train-time score updates via bin-space tree traversal.

Counterpart of the JAX package's ``ops/score.py`` (Tree::
AddPredictionToScore over the training dataset, include/LightGBM/
tree.h:104-132). Bagged training needs it for out-of-bag rows: those rows
never enter the leaf partition, so their new-tree contribution is computed
by traversing the tree directly over the bin plane (exactly the decisions
the partition made for in-bag rows — threshold_in_bin comparisons, EFB
group-bin translation, missing direction).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..common import MISSING_NAN, MISSING_ZERO


class BinnedTreeArrays(NamedTuple):
    """Per-internal-node decision fields in bin space + leaf values."""

    group: torch.Tensor  # [I] int64 feature-group row in the bin plane
    threshold: torch.Tensor  # [I] int32 bin threshold
    default_left: torch.Tensor  # [I] bool
    missing_type: torch.Tensor  # [I] int32
    default_bin: torch.Tensor  # [I] int32 (feature-bin space)
    nbins: torch.Tensor  # [I] int32
    efb_lo: torch.Tensor  # [I] int32 group-bin range for EFB members
    efb_hi: torch.Tensor  # [I] int32
    is_efb: torch.Tensor  # [I] bool
    left_child: torch.Tensor  # [I] int64
    right_child: torch.Tensor  # [I] int64
    leaf_value: torch.Tensor  # [L] float32


def binned_tree_arrays(tree, dataset, device: torch.device) -> BinnedTreeArrays:
    """Host-side packing of a trained tree's decisions into bin space."""
    ni = max(tree.num_leaves - 1, 1)
    gi = np.zeros(ni, dtype=np.int64)
    th = np.zeros(ni, dtype=np.int32)
    dl = np.zeros(ni, dtype=bool)
    mt = np.zeros(ni, dtype=np.int32)
    db = np.zeros(ni, dtype=np.int32)
    nb = np.full(ni, 2, dtype=np.int32)
    lo = np.zeros(ni, dtype=np.int32)
    hi = np.zeros(ni, dtype=np.int32)
    ie = np.zeros(ni, dtype=bool)
    for n in range(tree.num_leaves - 1):
        f = int(tree.split_feature[n])
        mapper = dataset.mappers[f]
        g, mi = dataset.feature_to_group[f]
        fg = dataset.groups[g]
        lo_n, hi_n, _ = fg.feature_bin_range(mi)
        gi[n] = g
        th[n] = tree.threshold_in_bin[n]
        dt = int(tree.decision_type[n])
        dl[n] = bool(dt & 2)
        mt[n] = (dt >> 2) & 3
        db[n] = mapper.default_bin
        nb[n] = mapper.num_bin
        lo[n], hi[n], ie[n] = lo_n, hi_n, fg.is_multi

    def dev(a, dtype=None):
        return torch.as_tensor(a, dtype=dtype, device=device)

    return BinnedTreeArrays(
        group=dev(gi), threshold=dev(th), default_left=dev(dl),
        missing_type=dev(mt), default_bin=dev(db), nbins=dev(nb),
        efb_lo=dev(lo), efb_hi=dev(hi), is_efb=dev(ie),
        left_child=dev(tree.left_child[:ni], torch.int64),
        right_child=dev(tree.right_child[:ni], torch.int64),
        leaf_value=dev(tree.leaf_value[: tree.num_leaves], torch.float32))


def binned_leaf_index(ta: BinnedTreeArrays, bins: torch.Tensor,
                      row_idx: torch.Tensor, num_data: int,
                      max_depth: int) -> torch.Tensor:
    """Leaf index [P] for padded row indices (the sentinel num_data reads a
    clamped row; the caller drops its update)."""
    rows = torch.clamp(row_idx.to(torch.int64), max=num_data - 1)
    node = torch.zeros(row_idx.shape[0], dtype=torch.int64, device=bins.device)
    for _ in range(max_depth):
        active = node >= 0
        nd = torch.clamp(node, min=0)
        gb = bins[ta.group[nd], rows].to(torch.int32)
        # EFB translation: group bin -> natural feature bin (split_decision_bins)
        in_range = (gb >= ta.efb_lo[nd]) & (gb < ta.efb_hi[nd])
        shifted = gb - ta.efb_lo[nd]
        natural = shifted + (shifted >= ta.default_bin[nd]).to(torch.int32)
        fbin = torch.where(ta.is_efb[nd],
                           torch.where(in_range, natural, ta.default_bin[nd]), gb)
        mt = ta.missing_type[nd]
        is_missing = torch.where(
            mt == MISSING_NAN, fbin == ta.nbins[nd] - 1,
            (mt == MISSING_ZERO) & (fbin == ta.default_bin[nd]))
        go_left = torch.where(is_missing, ta.default_left[nd],
                              fbin <= ta.threshold[nd])
        nxt = torch.where(go_left, ta.left_child[nd], ta.right_child[nd])
        node = torch.where(active, nxt, node)
    return ~node


def add_tree_to_score(tree, dataset, bins_dev: torch.Tensor, score: torch.Tensor,
                      row_idx: torch.Tensor, num_data: int,
                      max_depth: int = 0) -> torch.Tensor:
    """score[row] += tree.leaf_value[leaf(row)] for the given padded rows
    (sentinel rows dropped). max_depth is a config-derived bound; walks
    freeze at their leaf, so over-bounding is free."""
    keep = row_idx < num_data
    rows = row_idx[keep].to(torch.int64)
    if tree.num_leaves <= 1:
        return score.index_add(0, rows, torch.full(
            (rows.shape[0],), float(tree.leaf_value[0]), dtype=score.dtype,
            device=score.device))
    ta = binned_tree_arrays(tree, dataset, bins_dev.device)
    bound = max_depth if max_depth > 0 else int(tree.max_depth)
    leaf = binned_leaf_index(ta, bins_dev, row_idx, num_data, bound)[keep]
    return score.index_add(0, rows, ta.leaf_value[leaf])
