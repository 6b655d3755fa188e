"""Row sampling strategies: bagging.

Counterpart of the JAX package's ``models/sample_strategy.py``
(src/boosting/sample_strategy.{h,cpp}, bagging.hpp): the bag is drawn on the
host once per `bagging_freq` iterations from ``np.random.RandomState
(bagging_seed + iteration)``, in the same draw order as the JAX package, so
both packages train on the same rows. GOSS is refused as not yet ported.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..config import Config
from ..utils.log import Log


class SampleStrategy:
    """Base: no sampling (full data every iteration)."""

    def __init__(self, config: Config, num_data: int, metadata,
                 num_tree_per_iteration: int) -> None:
        self.config = config
        self.num_data = num_data
        self.metadata = metadata
        self.num_tree_per_iteration = num_tree_per_iteration

    def bagging(self, iteration: int, grad, hess
                ) -> Tuple[Optional[np.ndarray], object, object]:
        """Returns (bag indices, or None for full data, grad, hess)."""
        return None, grad, hess


class BaggingSampleStrategy(SampleStrategy):
    """bagging_fraction / bagging_freq (+ pos/neg fractions for binary)
    — bagging.hpp:30-296. The bag is resampled every `bagging_freq`
    iterations and reused in between."""

    def __init__(self, config: Config, num_data: int, metadata,
                 num_tree_per_iteration: int) -> None:
        super().__init__(config, num_data, metadata, num_tree_per_iteration)
        self.balanced = (config.pos_bagging_fraction < 1.0
                         or config.neg_bagging_fraction < 1.0)
        self.need = config.bagging_freq > 0 and (
            config.bagging_fraction < 1.0 or self.balanced)
        if self.balanced and config.objective not in ("binary",):
            Log.warning("Only can use pos/neg bagging with binary objective")
            self.balanced = False
            self.need = config.bagging_freq > 0 and config.bagging_fraction < 1.0
        self._bag: Optional[np.ndarray] = None

    def bagging(self, iteration: int, grad, hess):
        if not self.need:
            return None, grad, hess
        freq = self.config.bagging_freq
        if self._bag is None or iteration % freq == 0:
            rng = np.random.RandomState(self.config.bagging_seed + iteration)
            if self.balanced:
                label = np.asarray(self.metadata.label)
                pos = label > 0
                keep = np.where(
                    pos, rng.rand(self.num_data) < self.config.pos_bagging_fraction,
                    rng.rand(self.num_data) < self.config.neg_bagging_fraction)
                self._bag = np.nonzero(keep)[0].astype(np.int32)
            else:
                cnt = int(round(self.config.bagging_fraction * self.num_data))
                cnt = max(min(cnt, self.num_data), 1)
                self._bag = np.sort(rng.choice(
                    self.num_data, cnt, replace=False)).astype(np.int32)
        return self._bag, grad, hess


def create_sample_strategy(config: Config, num_data: int, metadata,
                           num_tree_per_iteration: int) -> SampleStrategy:
    """sample_strategy.cpp:27: data_sample_strategy in {bagging, goss}."""
    strategy = config.data_sample_strategy
    if strategy == "goss" or config.boosting == "goss":
        Log.fatal("GOSS (data_sample_strategy=goss) is not yet ported to the "
                  "PyTorch package (ROADMAP Queue 1 item 6)")
    if strategy == "bagging":
        return BaggingSampleStrategy(config, num_data, metadata,
                                     num_tree_per_iteration)
    Log.fatal("Unknown data sample strategy: %s", strategy)
