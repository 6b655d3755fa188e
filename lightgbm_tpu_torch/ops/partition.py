"""Leaf row partition: per-leaf padded index sets on the device.

Counterpart of the JAX package's ``ops/partition.py`` (DataPartition,
src/treelearner/data_partition.hpp; CUDADataPartition): each leaf owns a
padded device index array. Padding uses the sentinel index N, which

  * gathers the zero row of the extended gradient array (histograms), and
  * is dropped by the score update.

A split evaluates the bin-level decision (NumericalDecisionInner semantics,
include/LightGBM/tree.h:357-371; for a categorical split, membership of the
bin in the split's bin set, CategoricalDecisionInner, tree.h:375-388) as a
256-entry go-left table over the split group's bin values
(`go_left_table`), then partitions the parent's
rows stably into the children's index sets (`split_rows`): left rows in
order, then right rows, each padded with N. Children take power-of-two
padded buffers (`bucket_size`), which the predict streamer and the serving
micro-batcher also use for their row counts.

The JAX package partitions in XLA (a stable argsort on a 3-way key). A CPU
tensor takes the plain version below (`_split_rows_plain`); a CUDA tensor
launches the hand-written kernel (``ops/partition_cuda.py``,
``csrc/row_partition.cu``: one single-pass launch a split) or raises. Both give the
same integers as the JAX ``RowPartition.split``.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..common import MISSING_NAN, MISSING_ZERO
from .compact import GROUP_BINS


def bucket_size(n: int, minimum: int = 256) -> int:
    """Smallest power-of-two multiple of `minimum` that holds n rows."""
    p = minimum
    while p < n:
        p <<= 1
    return p


def pad_indices(idx: np.ndarray, n_data: int, minimum: int = 256) -> np.ndarray:
    """Pad a host index array with the sentinel N to its bucket size."""
    p = bucket_size(len(idx), minimum)
    out = np.full(p, n_data, dtype=np.int32)
    out[: len(idx)] = idx
    return out


def _feature_bins(gb: torch.Tensor, decision: Sequence[float]) -> torch.Tensor:
    """Group bins -> the split feature's natural bins: for an EFB bundle,
    a group bin in [lo, hi) undoes the default-bin removal shift, anything
    else is the default bin."""
    default_bin = int(decision[3])
    lo, hi = int(decision[5]), int(decision[6])
    if decision[7] <= 0.5:
        return gb
    shifted = gb - lo
    natural = shifted + (shifted >= default_bin).to(torch.int32)
    return torch.where((gb >= lo) & (gb < hi), natural, torch.full_like(gb, default_bin))


def split_decision_bins(group_bins: torch.Tensor,
                        decision: Sequence[float]) -> torch.Tensor:
    """go_left for raw GROUP bins of the split group.

    decision: host sequence
      [0]=threshold (feature-bin space), [1]=default_left, [2]=missing_type,
      [3]=feature default_bin, [4]=feature nbins, [5]=efb_lo, [6]=efb_hi,
      [7]=is_efb (group bins need translation to feature bins)
    Implements NumericalDecisionInner: missing bin -> default side, otherwise
    bin <= threshold.
    """
    thresh = int(decision[0])
    default_left = decision[1] > 0.5
    missing_type = int(decision[2])
    default_bin = int(decision[3])
    nbins = int(decision[4])
    fbin = _feature_bins(group_bins.to(torch.int32), decision)
    if missing_type == MISSING_NAN:
        is_missing = fbin == nbins - 1
    elif missing_type == MISSING_ZERO:
        is_missing = fbin == default_bin
    else:
        return fbin <= thresh
    return torch.where(is_missing, torch.full_like(is_missing, default_left),
                       fbin <= thresh)


def split_decision_bins_cat(group_bins: torch.Tensor, decision: Sequence[float],
                            cat_mask: np.ndarray) -> torch.Tensor:
    """go_left for a categorical split: membership of the (EFB-translated)
    feature bin in the split's bin set `cat_mask` ([B] bool over feature
    bins; a bin past it goes right), the JAX package's
    split_decision_bins_cat."""
    fbin = _feature_bins(group_bins.to(torch.int32), decision)
    mask = torch.as_tensor(np.asarray(cat_mask, dtype=bool), device=fbin.device)
    B = mask.shape[0]
    return mask[torch.clamp(fbin, 0, B - 1).to(torch.int64)] & (fbin < B)


def go_left_table(decision: Sequence[float],
                  cat_mask: Optional[np.ndarray] = None) -> np.ndarray:
    """[256] bool: `split_decision_bins` (or, with a categorical split's bin
    set `cat_mask`, `split_decision_bins_cat`) of every value a uint8 group
    bin takes, the table the row partition looks each row's bin up in."""
    bins = torch.arange(GROUP_BINS, dtype=torch.int32)
    if cat_mask is not None:
        return split_decision_bins_cat(bins, decision, cat_mask).numpy()
    return split_decision_bins(bins, decision).numpy()


def _split_rows_plain(bins_row: torch.Tensor, row_idx: torch.Tensor, count: int,
                      table: np.ndarray, n_data: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version of `split_rows`: the rows of the first `count`
    positions whose bin's table entry is set, in order, then N up to P; the
    other rows likewise; and the left count (a boolean mask keeps order, as
    the stable argsort of the JAX package's partition_rows does)."""
    P = row_idx.shape[0]
    rows = row_idx[:count]
    gb = bins_row[torch.clamp(rows, max=n_data - 1).to(torch.int64)]
    go_left = torch.as_tensor(np.asarray(table, dtype=bool), device=rows.device)[
        gb.to(torch.int64)]
    left = torch.full((P,), n_data, dtype=torch.int32, device=rows.device)
    right = torch.full((P,), n_data, dtype=torch.int32, device=rows.device)
    lrows, rrows = rows[go_left], rows[~go_left]
    left[:lrows.shape[0]] = lrows
    right[:rrows.shape[0]] = rrows
    return left, right, torch.tensor(lrows.shape[0], dtype=torch.int32)


def split_rows(bins_row: torch.Tensor, row_idx: torch.Tensor, count: int,
               table: np.ndarray, n_data: int
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stable-partition a leaf's padded indices by a split's go-left table.

    bins_row: [N] uint8 group-bin row of the split group
    row_idx:  [P] padded leaf indices (sentinel = n_data)
    count:    actual row count (the first count positions)
    table:    [256] bool, `go_left_table(decision)`
    Returns (left [P], right [P], n_left []): the left rows in order then
    the sentinel, the right rows likewise, and the left count as a 0-d int32
    tensor on the card (the caller's one host sync reads it).
    """
    from .partition_cuda import split_rows as split

    return split(bins_row, row_idx, count, table, n_data)


class RowPartition:
    """Host orchestrator of per-leaf device index arrays.

    leaf -> (device int32 index array padded to a power-of-two bucket, host
    count). The root leaf starts with all rows. One device->host sync per
    split (the left count), as the JAX package and LightGBM's CUDA learner
    (cuda_single_gpu_tree_learner.cpp:291-330).

    A split's children are the first bucket_size(n) positions of the two
    [P]-sized buffers `split_rows` returns (P the parent's bucket; on the
    card, halves of one allocation): views, so nothing runs on the card
    after the sync. A child whose bucket is at most P / TRIM is copied out
    instead, so an allocation (2P and a little) stays alive only for
    children whose buckets exceed P / TRIM: the allocations alive hold at
    most 2 * TRIM times the leaves' buckets, whose sum is at most
    2N + min_bucket * leaves. With TRIM = 4 and int32 indices that is
    32 * (2N + 256 * leaves) bytes at most, ~69 MB for a 255-leaf tree over
    N = 2**20 rows.
    """

    TRIM = 4

    def __init__(self, num_data: int, device: torch.device,
                 min_bucket: int = 256) -> None:
        self.num_data = num_data
        self.device = torch.device(device)
        self.min_bucket = min_bucket
        self.set_used_indices(np.arange(num_data, dtype=np.int32))

    def indices(self, leaf: int) -> torch.Tensor:
        return self.leaf_idx[leaf]

    def count(self, leaf: int) -> int:
        return self.leaf_count[leaf]

    def split(self, leaf: int, new_leaf: int, bins_row: torch.Tensor,
              decision: Sequence[float],
              cat_mask: Optional[np.ndarray] = None) -> Tuple[int, int]:
        """Split `leaf` in place; left stays as `leaf`, right becomes
        `new_leaf`. A categorical split passes its bin set `cat_mask`.
        Returns (left_count, right_count)."""
        idx = self.leaf_idx[leaf]
        cnt = self.leaf_count[leaf]
        left, right, n_left = split_rows(bins_row, idx, cnt,
                                         go_left_table(decision, cat_mask), self.num_data)
        left_cnt = int(n_left)  # the one host sync per split
        right_cnt = cnt - left_cnt
        self.leaf_idx[leaf] = self._child(left, left_cnt)
        self.leaf_count[leaf] = left_cnt
        self.leaf_idx[new_leaf] = self._child(right, right_cnt)
        self.leaf_count[new_leaf] = right_cnt
        return left_cnt, right_cnt

    def _child(self, buf: torch.Tensor, count: int) -> torch.Tensor:
        p = bucket_size(count, self.min_bucket)
        view = buf[:p]
        return view.clone() if self.TRIM * p <= buf.shape[0] else view

    def set_used_indices(self, indices: np.ndarray) -> None:
        """Restrict the root to a bagging subset (SetUsedDataIndices)."""
        padded = pad_indices(indices.astype(np.int32), self.num_data, self.min_bucket)
        self.leaf_idx = {0: torch.from_numpy(padded).to(self.device)}
        self.leaf_count = {0: len(indices)}
