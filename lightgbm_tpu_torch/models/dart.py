"""DART boosting: Dropouts meet Multiple Additive Regression Trees.

Counterpart of the JAX package's ``models/dart.py`` (src/boosting/
dart.hpp:23-211). Each iteration drops a random subset of the earlier
iterations' trees (uniformly or weighted by tree weight, at most max_drop,
none at all with probability skip_drop), fits the new tree to the gradients
of the score without them, then renormalizes the dropped and the new trees
(standard mode: the new tree's weight lr/(k+1), the dropped ones shrunk by
k/(k+1); xgboost_dart_mode: lr/(lr+k) and k/(lr+k)).

The drop draws come from ``np.random.RandomState(drop_seed)`` in the JAX
package's order: one ``rand()`` for skip_drop, then one per earlier
iteration. Dropping a tree adds it, negated, to the train score of every
row (the bin-space traversal); renormalizing adds it to the valid scores
and the train score again, with the float32 adds and the float64 shrinks
in the JAX package's order, so the train score keeps its bits.

DART never takes the GBDT's async pipeline (`GBDT._async_enabled` admits
the plain GBDT only): its score updates reorder around the tree's growth.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from .gbdt import GBDT


class DART(GBDT):
    def __init__(self, config, train_set, objective, device, train_raw=None) -> None:
        super().__init__(config, train_set, objective, device, train_raw)
        self._drop_rng = np.random.RandomState(config.drop_seed)
        self.tree_weight: List[float] = []  # an iteration's weight (weighted drop)
        self.sum_weight = 0.0
        self.drop_index: List[int] = []
        self._dropped_this_iter = False

    def prepare_training_score(self) -> None:
        """Drop once an iteration, before any gradient reads the score: a
        custom objective reaches this through Booster.update (dart.hpp:
        78-88)."""
        if not self._dropped_this_iter:
            self._dropping_trees()
            self._dropped_this_iter = True

    def train_one_iter(self, gradients: Optional[np.ndarray] = None,
                       hessians: Optional[np.ndarray] = None) -> bool:
        self.prepare_training_score()
        self._dropped_this_iter = False  # armed again for the next iteration
        stop = super().train_one_iter(gradients, hessians)
        if stop:
            return True
        self._normalize()
        if not self.config.uniform_drop:
            self.tree_weight.append(self.shrinkage_rate)
            self.sum_weight += self.shrinkage_rate
        return False

    # ------------------------------------------------------------- internals

    def _dropping_trees(self) -> None:
        cfg = self.config
        C = self.num_tree_per_iteration
        self.drop_index = []
        is_skip = self._drop_rng.rand() < cfg.skip_drop
        if not is_skip and self.iter_ > 0:
            drop_rate = cfg.drop_rate
            if not cfg.uniform_drop:
                if self.sum_weight > 0:
                    inv_avg = len(self.tree_weight) / self.sum_weight
                    if cfg.max_drop > 0:
                        drop_rate = min(drop_rate, cfg.max_drop * inv_avg / self.sum_weight)
                    for i in range(self.iter_):
                        if self._drop_rng.rand() < drop_rate * self.tree_weight[i] * inv_avg:
                            self.drop_index.append(i)
                            if 0 < cfg.max_drop <= len(self.drop_index):
                                break
            else:
                if cfg.max_drop > 0:
                    drop_rate = min(drop_rate, cfg.max_drop / float(self.iter_))
                for i in range(self.iter_):
                    if self._drop_rng.rand() < drop_rate:
                        self.drop_index.append(i)
                        if 0 < cfg.max_drop <= len(self.drop_index):
                            break
        # out of the TRAIN score only: the valid scores are fixed up in
        # _normalize (dart.hpp:131-137)
        for i in self.drop_index:
            for c in range(C):
                tree = self.models[i * C + c]
                tree.shrink(-1.0)
                self._add_tree_to_train_score(tree, c)
        if self.drop_index:
            self._predictor.invalidate()
        k = float(len(self.drop_index))
        if not cfg.xgboost_dart_mode:
            self.shrinkage_rate = cfg.learning_rate / (1.0 + k)
        else:
            self.shrinkage_rate = (cfg.learning_rate if not self.drop_index
                                   else cfg.learning_rate / (cfg.learning_rate + k))

    def _normalize(self) -> None:
        cfg = self.config
        C = self.num_tree_per_iteration
        k = float(len(self.drop_index))
        for i in self.drop_index:
            for c in range(C):
                tree = self.models[i * C + c]
                if not cfg.xgboost_dart_mode:
                    # the tree's weight ends at old_weight * k/(k+1) (dart.hpp:149-158)
                    tree.shrink(1.0 / (k + 1.0))
                    self._update_valid_scores(tree, c)
                    tree.shrink(-k)
                    self._add_tree_to_train_score(tree, c)
                else:
                    tree.shrink(self.shrinkage_rate)
                    self._update_valid_scores(tree, c)
                    tree.shrink(-k / cfg.learning_rate)
                    self._add_tree_to_train_score(tree, c)
            if not cfg.uniform_drop:
                if not cfg.xgboost_dart_mode:
                    self.sum_weight -= self.tree_weight[i] * (1.0 / (k + 1.0))
                    self.tree_weight[i] *= k / (k + 1.0)
                else:
                    self.sum_weight -= self.tree_weight[i] * (1.0 / (k + cfg.learning_rate))
                    self.tree_weight[i] *= k / (k + cfg.learning_rate)
        if self.drop_index:
            self._predictor.invalidate()
