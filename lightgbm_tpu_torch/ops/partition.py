"""Leaf row partition: per-leaf padded index sets on the device.

Counterpart of the JAX package's ``ops/partition.py`` (DataPartition,
src/treelearner/data_partition.hpp; CUDADataPartition): each leaf owns a
padded device index array. Padding uses the sentinel index N, which

  * gathers the zero row of the extended gradient array (histograms), and
  * is dropped by the score update.

A split evaluates the bin-level decision (NumericalDecisionInner semantics,
include/LightGBM/tree.h:357-371) over the parent's indices, then performs a
stable partition via a stable argsort on a 3-way key (left < right <
padding). Children take power-of-two padded buffers (`bucket_size`), which
the predict streamer and the serving micro-batcher also use for their row
counts. The partition is plain PyTorch on either device: it is XLA in the
JAX package, not a Pallas kernel.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from ..common import MISSING_NAN, MISSING_ZERO


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
    lo, hi = int(decision[5]), int(decision[6])
    gb = group_bins.to(torch.int32)
    if decision[7] > 0.5:
        # EFB translation: group bin in [lo, hi) -> natural feature bin (undo
        # the default-bin removal shift); anything else -> default bin
        shifted = gb - lo
        natural = shifted + (shifted >= default_bin).to(torch.int32)
        fbin = torch.where((gb >= lo) & (gb < hi), natural,
                           torch.full_like(gb, default_bin))
    else:
        fbin = gb
    if missing_type == MISSING_NAN:
        is_missing = fbin == nbins - 1
    elif missing_type == MISSING_ZERO:
        is_missing = fbin == default_bin
    else:
        return fbin <= thresh
    return torch.where(is_missing, torch.full_like(is_missing, default_left),
                       fbin <= thresh)


def partition_rows(bins_row: torch.Tensor, row_idx: torch.Tensor, count: int,
                   decision: Sequence[float], n_data: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable-partition a leaf's padded indices by the split decision.

    bins_row: [N] group-bin column of the split group
    row_idx:  [P] padded leaf indices (sentinel = n_data)
    count:    actual row count
    Returns (sorted_idx [P] — left rows first, then right, then sentinel
    padding — and left_count as a 0-d device tensor).
    """
    P = row_idx.shape[0]
    pos = torch.arange(P, dtype=torch.int32, device=row_idx.device)
    valid = pos < count
    gb = bins_row[torch.clamp(row_idx, max=n_data - 1).to(torch.int64)]
    go_left = split_decision_bins(gb, decision) & valid
    key = torch.where(go_left, 0, torch.where(valid, 1, 2)).to(torch.int32)
    order = torch.argsort(key, stable=True)
    sorted_idx = torch.where(valid, row_idx[order], n_data)
    return sorted_idx, go_left.sum()


class RowPartition:
    """Host orchestrator of per-leaf device index arrays.

    leaf -> (device int32 index array padded to a power-of-two bucket, host
    count). The root leaf starts with all rows. One device->host sync per
    split (the left count).
    """

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
              decision: Sequence[float]) -> Tuple[int, int]:
        """Split `leaf` in place; left stays as `leaf`, right becomes
        `new_leaf`. Returns (left_count, right_count)."""
        idx = self.leaf_idx[leaf]
        cnt = self.leaf_count[leaf]
        sorted_idx, left_cnt_dev = partition_rows(bins_row, idx, cnt, decision,
                                                  self.num_data)
        left_cnt = int(left_cnt_dev)  # the one host sync per split
        right_cnt = cnt - left_cnt
        lp = bucket_size(left_cnt, self.min_bucket)
        rp = bucket_size(right_cnt, self.min_bucket)
        dev = sorted_idx.device
        left_idx = torch.where(torch.arange(lp, device=dev) < left_cnt,
                               sorted_idx[:lp], self.num_data)
        # pad before slicing, so the right child's window never runs past
        # the parent's buffer
        padded = torch.cat([sorted_idx, torch.full((rp,), self.num_data,
                                                   dtype=sorted_idx.dtype, device=dev)])
        right_idx = torch.where(torch.arange(rp, device=dev) < right_cnt,
                                padded[left_cnt:left_cnt + rp], self.num_data)
        self.leaf_idx[leaf] = left_idx.to(torch.int32)
        self.leaf_count[leaf] = left_cnt
        self.leaf_idx[new_leaf] = right_idx.to(torch.int32)
        self.leaf_count[new_leaf] = right_cnt
        return left_cnt, right_cnt

    def set_used_indices(self, indices: np.ndarray) -> None:
        """Restrict the root to a bagging subset (SetUsedDataIndices)."""
        padded = pad_indices(indices.astype(np.int32), self.num_data, self.min_bucket)
        self.leaf_idx = {0: torch.from_numpy(padded).to(self.device)}
        self.leaf_count = {0: len(indices)}
