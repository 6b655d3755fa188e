"""Cost-Effective Gradient Boosting gain penalties.

Counterpart of the JAX package's ``treelearner/cegb.py``
(CostEfficientGradientBoosting, src/treelearner/
cost_effective_gradient_boosting.hpp:23-174): for every candidate split the
gain is reduced by

    cegb_tradeoff * cegb_penalty_split * num_data_in_leaf
  + cegb_tradeoff * cegb_penalty_feature_coupled[f]   (first use of f only)
  + cegb_tradeoff * sum_{rows in leaf not yet seen by f} penalty_lazy[f]

The penalty is a per-leaf [F] vector that the split search subtracts per
feature. When a coupled feature is first used, the serial learner searches
the live frontier again (the reference patches its stored SplitInfos).

The lazy penalty's "feature f has been computed for row r" marks are a
bitset [F, ceil(N / 8)] uint8 on the training device (Common::EmptyBitset's
layout), where the partition keeps the leaves' rows: a search counts the
leaf's unseen rows per feature there and copies the [F] integer counts to
the host once. The vector itself is the JAX package's float64 arithmetic in
its order, rounded to float32 once, so on the same counts it is the same
bits.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..config import Config
from ..utils.log import Log


class CEGB:
    @staticmethod
    def enabled(config: Config) -> bool:
        # the reference's IsEnable also triggers on cegb_tradeoff != 1 alone,
        # but with every penalty zero that is a no-op
        return (config.cegb_penalty_split > 0.0
                or bool(config.cegb_penalty_feature_coupled)
                or bool(config.cegb_penalty_feature_lazy))

    def __init__(self, config: Config, dataset, device: torch.device) -> None:
        self.tradeoff = float(config.cegb_tradeoff)
        self.penalty_split = float(config.cegb_penalty_split)
        used: List[int] = dataset.used_features
        self.F = len(used)
        self.num_data = dataset.num_data
        self.device = torch.device(device)

        def per_used(values: List[float], name: str) -> Optional[np.ndarray]:
            if not values:
                return None
            if len(values) != dataset.num_total_features:
                Log.fatal("%s should be the same size as feature number.", name)
            return np.asarray([values[f] for f in used], dtype=np.float64)

        self.coupled = per_used(config.cegb_penalty_feature_coupled,
                                "cegb_penalty_feature_coupled")
        self.lazy = per_used(config.cegb_penalty_feature_lazy,
                             "cegb_penalty_feature_lazy")
        self.used_in_split = np.zeros(self.F, dtype=bool)
        self.seen_bits: Optional[torch.Tensor] = (
            torch.zeros((self.F, (self.num_data + 7) // 8), dtype=torch.uint8,
                        device=self.device)
            if self.lazy is not None else None)

    @property
    def needs_rows(self) -> bool:
        return self.lazy is not None

    def unseen_counts(self, leaf_rows: torch.Tensor) -> np.ndarray:
        """[F] int64 on the host: the leaf's rows (int32 or int64 on the
        bitset's device) that each feature has not yet seen."""
        rows = leaf_rows.to(torch.int64)
        bit = (rows & 7).to(torch.uint8)
        seen = (self.seen_bits[:, rows >> 3] >> bit) & 1  # [F, R]
        return (rows.numel() - seen.sum(dim=1, dtype=torch.int64)).cpu().numpy()

    def penalty_vector(self, leaf_count: float,
                       leaf_rows: Optional[torch.Tensor]) -> np.ndarray:
        """[F] float32 gain penalty for one leaf's split search (DeltaGain)."""
        vec = np.full(self.F, self.tradeoff * self.penalty_split * leaf_count,
                      dtype=np.float64)
        if self.coupled is not None:
            vec += np.where(self.used_in_split, 0.0,
                            self.tradeoff * self.coupled)
        if self.lazy is not None and leaf_rows is not None and leaf_rows.numel():
            vec += self.tradeoff * self.lazy * self.unseen_counts(leaf_rows)
        return vec.astype(np.float32)

    def on_split_applied(self, dense_f: int,
                         leaf_rows: Optional[torch.Tensor]) -> bool:
        """Record a committed split on dense feature dense_f over leaf_rows
        (distinct rows on the bitset's device). Returns True when a coupled
        penalty was just lifted: the caller searches the pending frontier
        again (UpdateLeafBestSplits)."""
        newly = (self.coupled is not None
                 and not self.used_in_split[dense_f]
                 and self.coupled[dense_f] > 0)
        self.used_in_split[dense_f] = True
        if self.seen_bits is not None and leaf_rows is not None and leaf_rows.numel():
            rows = leaf_rows.to(torch.int64)
            # the rows are distinct, so each byte's bits arrive once each and
            # their integer sum is their union
            add = torch.zeros(self.seen_bits.shape[1], dtype=torch.int32,
                              device=self.device)
            add.index_add_(0, rows >> 3, (1 << (rows & 7)).to(torch.int32))
            self.seen_bits[dense_f] |= add.to(torch.uint8)
        return bool(newly)
