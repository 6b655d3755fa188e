"""Random-forest boosting.

Counterpart of the JAX package's ``models/rf.py`` (src/boosting/
rf.hpp:25-236): no shrinkage, bagging or feature subsampling required,
the gradients computed ONCE from the constant boost-from-average score and
kept on the device (every tree fits the same residuals on its own bag),
and the train and valid scores kept as the running AVERAGE of the trees'
outputs by multiply, update, multiply; predictions average over the
iterations (average_output, which the model text records).

RF never takes the GBDT's async pipeline (`GBDT._async_enabled` admits the
plain GBDT only).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..utils.log import Log
from .gbdt import GBDT, K_EPSILON, _pack_gh
from .tree import Tree


class RF(GBDT):
    def __init__(self, config, train_set, objective, device, train_raw=None) -> None:
        if config.data_sample_strategy == "bagging":
            ok = ((config.bagging_freq > 0 and 0.0 < config.bagging_fraction < 1.0)
                  or (0.0 < config.feature_fraction < 1.0))
            if not ok:
                Log.fatal("Random forest needs bagging (bagging_freq > 0 and "
                          "bagging_fraction < 1.0) or feature_fraction < 1.0")
        if objective is None:
            Log.fatal("RF mode do not support custom objective function, "
                      "please use built-in objectives.")
        if train_set is not None and train_set.metadata.init_score is not None:
            # the running average cannot absorb an additive init score
            # (rf.hpp:49 CHECK_EQ(init_score, nullptr))
            Log.fatal("Cannot use init_score in RF mode")
        super().__init__(config, train_set, objective, device, train_raw)
        self.average_output = True
        self.shrinkage_rate = 1.0
        # the one gradient pass, from the constant init score (rf.hpp Boosting)
        C = self.num_tree_per_iteration
        self.init_scores = [0.0] * C
        if config.boost_from_average:
            self.init_scores = [self.objective.boost_from_score(c) for c in range(C)]
        base = torch.as_tensor(np.asarray(self.init_scores, dtype=np.float32),
                               device=self.device)[:, None].expand(C, self.num_data)
        if C > 1:
            grads, hesses = self.objective.get_gradients(base.contiguous())
        else:
            grads, hesses = self.objective.get_gradients(base[0].contiguous())
            grads, hesses = grads[None], hesses[None]
        self._fixed_grads, self._fixed_hesses = grads, hesses

    def train_one_iter(self, gradients: Optional[np.ndarray] = None,
                       hessians: Optional[np.ndarray] = None) -> bool:
        if gradients is not None or hessians is not None:
            Log.fatal("RF mode do not support custom objective function, "
                      "please use built-in objectives.")
        C = self.num_tree_per_iteration
        bag, grads, hesses = self.sample_strategy.bagging(
            self.iter_, self._fixed_grads, self._fixed_hesses)
        self._refresh_bag_cache(bag)
        for c in range(C):
            gh_ext = _pack_gh(grads[c], hesses[c])
            new_tree = Tree(2)
            if self.class_need_train[c] and self.train_set.num_features > 0:
                new_tree = self.tree_learner.train(gh_ext, bag)
            if new_tree.num_leaves > 1:
                # the leaves' refit residuals are label - init (rf.hpp:150-152)
                self.objective.renew_tree_output(
                    new_tree, torch.full((self.num_data,), self.init_scores[c],
                                         dtype=torch.float32, device=self.device),
                    self.tree_learner.partition)
                if abs(self.init_scores[c]) > K_EPSILON:
                    new_tree.add_bias(self.init_scores[c])
                # the running average: score = (score * iter + tree) / (iter + 1)
                self._multiply_score(c, float(self.iter_))
                self._update_train_score(new_tree, c)
                self._update_valid_scores(new_tree, c)
                self._multiply_score(c, 1.0 / (self.iter_ + 1.0))
            elif len(self.models) < C:
                output = 0.0
                if not self.class_need_train[c]:
                    output = self.objective.boost_from_score(c)
                new_tree.as_constant_tree(output)
                self._multiply_score(c, float(self.iter_))
                self._add_tree_to_train_score(new_tree, c)
                self._update_valid_scores(new_tree, c)
                self._multiply_score(c, 1.0 / (self.iter_ + 1.0))
            self.models.append(new_tree)
        self.iter_ += 1
        self._predictor.invalidate()
        return False

    def rollback_one_iter(self) -> None:
        if self.iter_ <= 0:
            return
        C = self.num_tree_per_iteration
        for c in range(C):
            tree = self.models[-C + c]
            tree.shrink(-1.0)
            self._multiply_score(c, float(self.iter_))
            self._add_tree_to_train_score(tree, c)
            self._update_valid_scores(tree, c)
            self._multiply_score(c, 1.0 / (self.iter_ - 1.0) if self.iter_ > 1 else 0.0)
            tree.shrink(-1.0)
        del self.models[-C:]
        self.iter_ -= 1
        self._predictor.invalidate()
