"""Train-time score updates: by bin-space tree traversal, and from a wave
tree's device split log.

Counterpart of the JAX package's ``ops/score.py`` (Tree::
AddPredictionToScore over the training dataset, include/LightGBM/
tree.h:104-132). Bagged training needs it for out-of-bag rows: those rows
never enter the leaf partition, so their new-tree contribution is computed
by traversing the tree directly over the bin plane (exactly the decisions
the partition made for in-bag rows — threshold_in_bin comparisons, EFB
group-bin translation, missing direction, and for a categorical node the
bin's membership in the node's bin bitset, LightGBM's
CategoricalDecisionInner, include/LightGBM/tree.h).

Here the port departs from the JAX package on purpose: its traversal
compares the bin with threshold_in_bin at every node, which at a
categorical node is the node's index into cat_boundaries, not a bin, so its
out-of-bag train scores go wrong from the first categorical split on under
bagging or GOSS (ROADMAP Queue 3). Numeric nodes decide as there.

`apply_split_log_to_score` is the counterpart of the JAX package's
``models/gbdt.py:_apply_split_log_to_score``: the async pipeline's train
score update, read from the wave learner's split log on the device before
the log reaches the host.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..common import MISSING_NAN, MISSING_ZERO

# split-log columns (ops/wave.py STORE rows: [leaf, parent_output, depth,
# valid] + SPLIT_FIELDS, whose left_output and right_output are fields 10
# and 11)
_LOG_LEAF, _LOG_VALID, _LOG_LEFT_OUT, _LOG_RIGHT_OUT = 0, 3, 14, 15


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
    is_cat: torch.Tensor  # [I] bool: a categorical node
    cat_words: torch.Tensor  # [I] int32 words in the node's bin bitset
    cat_bits: torch.Tensor  # [I, W] int64 the bin bitset's 32-bit words, zero-padded


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
    ic = np.zeros(ni, dtype=bool)
    words = []
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
        if dt & 1:  # categorical: threshold_in_bin indexes cat_boundaries_inner
            k = int(tree.threshold_in_bin[n])
            b0, b1 = tree.cat_boundaries_inner[k], tree.cat_boundaries_inner[k + 1]
            ic[n] = True
            words.append(tree.cat_threshold_inner[b0:b1])
        else:
            words.append([])
    W = max([1] + [len(w) for w in words])
    cw = np.array([len(w) for w in words] + [0] * (ni - len(words)), dtype=np.int32)
    cb = np.zeros((ni, W), dtype=np.int64)
    for n, w in enumerate(words):
        cb[n, :len(w)] = w

    def dev(a, dtype=None):
        return torch.as_tensor(a, dtype=dtype, device=device)

    return BinnedTreeArrays(
        group=dev(gi), threshold=dev(th), default_left=dev(dl),
        missing_type=dev(mt), default_bin=dev(db), nbins=dev(nb),
        efb_lo=dev(lo), efb_hi=dev(hi), is_efb=dev(ie),
        left_child=dev(tree.left_child[:ni], torch.int64),
        right_child=dev(tree.right_child[:ni], torch.int64),
        leaf_value=dev(tree.leaf_value[: tree.num_leaves], torch.float32),
        is_cat=dev(ic), cat_words=dev(cw), cat_bits=dev(cb))


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
        # a categorical node: the bin's bit in the node's bin bitset (a bin
        # past its words goes right)
        word = torch.div(fbin, 32, rounding_mode="floor")
        bits = ta.cat_bits[nd, torch.clamp(word, 0, ta.cat_bits.shape[1] - 1).to(torch.int64)]
        in_set = ((word < ta.cat_words[nd])
                  & (((bits >> (fbin % 32).to(torch.int64)) & 1) == 1))
        go_left = torch.where(ta.is_cat[nd], in_set, go_left)
        nxt = torch.where(go_left, ta.left_child[nd], ta.right_child[nd])
        node = torch.where(active, nxt, node)
    return ~node


def add_tree_to_score(tree, dataset, bins_dev: torch.Tensor, score: torch.Tensor,
                      row_idx: torch.Tensor, num_data: int,
                      max_depth: int = 0) -> torch.Tensor:
    """score[row] += tree.leaf_value[leaf(row)] for the given padded rows
    (distinct rows; the sentinel rows add into a dump slot past the end, so
    nothing waits for the host to count them). max_depth is a
    config-derived bound; walks freeze at their leaf, so over-bounding is
    free."""
    ext = torch.cat([score, torch.zeros(1, dtype=score.dtype, device=score.device)])
    rows = torch.clamp(row_idx.to(torch.int64), max=num_data)
    if tree.num_leaves <= 1:
        vals = torch.full((rows.shape[0],), float(tree.leaf_value[0]), dtype=score.dtype,
                          device=score.device)
    else:
        ta = binned_tree_arrays(tree, dataset, bins_dev.device)
        bound = max_depth if max_depth > 0 else int(tree.max_depth)
        vals = ta.leaf_value[binned_leaf_index(ta, bins_dev, row_idx, num_data, bound)]
    return ext.index_add_(0, rows, vals)[:num_data]


def apply_split_log_to_score(score: torch.Tensor, rec_store: torch.Tensor,
                             leaf_ids: torch.Tensor, rate: float,
                             num_leaves: int) -> None:
    """score [N] float32 += rate * the leaf value of each row's leaf, in
    place, with the leaf values read from a wave tree's split log on the
    device and no copy to the host.

    rec_store [T, STORE] float32: valid row t re-splits leaf rec[t, 0]; the
    left child keeps the leaf id and takes left_output, the right child
    becomes leaf t + 1 and takes right_output, and a later row's write to a
    leaf wins (the JAX package's fori_loop of `.at[].set`). Rows from the
    first invalid one on write to a dump slot. The last write to each leaf
    is found without an order-dependent scatter: the write index (2t left,
    2t + 1 right) reduced by max per leaf, then a gather. leaf_ids [N] int32
    (-1 for a row in no leaf: no update). The float32 multiply by `rate`
    equals the host's float64 shrink cast to float32 bit for bit when rate
    is exact in float32, as the pipeline requires. A tree with no valid row
    adds zero to every row."""
    L = num_leaves
    dev = score.device
    T = rec_store.shape[0]
    valid = rec_store[:, _LOG_VALID] > 0.5
    t = torch.arange(T, dtype=torch.int64, device=dev)
    dump = torch.full((), L, dtype=torch.int64, device=dev)
    left = torch.where(valid, rec_store[:, _LOG_LEAF].to(torch.int64), dump)
    right = torch.where(valid, t + 1, dump)
    leaf_w = torch.stack([left, right], dim=1).reshape(-1)  # write 2t, then 2t + 1
    # a slice, not a list index: a list becomes a host tensor copied to the
    # device, which synchronizes
    value_w = rec_store[:, _LOG_LEFT_OUT:_LOG_RIGHT_OUT + 1].reshape(-1)
    last = torch.full((L + 1,), -1, dtype=torch.int64, device=dev).scatter_reduce(
        0, leaf_w, torch.arange(2 * T, dtype=torch.int64, device=dev), "amax")
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    lv = torch.where(last >= 0, value_w[last.clamp(min=0)], zero)[:L]
    lv = lv * float(rate)  # a float32 multiply, the scalar passed with the launch
    ids = leaf_ids.to(torch.int64)
    score += torch.where(ids >= 0, lv[ids.clamp(0, L - 1)], zero)
