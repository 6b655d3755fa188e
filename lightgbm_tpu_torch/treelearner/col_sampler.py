"""Column sampling + interaction constraints.

Counterpart of src/treelearner/col_sampler.hpp (and of the JAX package's
``treelearner/col_sampler.py``, whose MT19937 draw order it keeps):
feature_fraction picks a random feature subset per tree,
feature_fraction_bynode re-samples per node, and interaction_constraints
restrict a node's candidate features to constraint groups containing every
feature already used on its path. Produces dense-feature boolean masks
(host numpy) consumed by the vectorized split scan.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Set

import numpy as np

from ..config import Config


def parse_interaction_constraints(text: str) -> List[Set[int]]:
    """Parse "[0,1,2],[2,3]" (real feature indices) into sets."""
    text = text.strip()
    if not text:
        return []
    groups: List[Set[int]] = []
    for chunk in text.replace(" ", "").strip("[]").split("],["):
        if chunk:
            groups.append({int(x) for x in chunk.split(",") if x != ""})
    return groups


class ColSampler:
    def __init__(self, config: Config, real_features: Sequence[int]) -> None:
        self.fraction = config.feature_fraction
        self.fraction_bynode = config.feature_fraction_bynode
        self.rng = np.random.RandomState(config.feature_fraction_seed)
        self.real_features = list(real_features)  # dense idx -> real idx
        self.num_features = len(real_features)
        self.constraints = parse_interaction_constraints(
            config.interaction_constraints)
        self._tree_mask = np.ones(self.num_features, dtype=bool)

    @property
    def active(self) -> bool:
        return (self.fraction < 1.0 or self.fraction_bynode < 1.0
                or bool(self.constraints))

    def _sample(self, base: np.ndarray, fraction: float) -> np.ndarray:
        candidates = np.nonzero(base)[0]
        k = max(1, int(round(len(candidates) * fraction)))
        chosen = self.rng.choice(candidates, k, replace=False)
        mask = np.zeros(self.num_features, dtype=bool)
        mask[chosen] = True
        return mask

    def reset_by_tree(self) -> np.ndarray:
        """Per-tree feature subset (ResetByTree)."""
        if self.fraction < 1.0:
            self._tree_mask = self._sample(
                np.ones(self.num_features, dtype=bool), self.fraction)
        else:
            self._tree_mask = np.ones(self.num_features, dtype=bool)
        return self._tree_mask

    def get_by_node(self, features_in_path: Optional[Set[int]]) -> np.ndarray:
        """Per-node mask (GetByNode): bynode re-sampling on top of the tree
        subset, intersected with the interaction-constraint closure of the
        path's features (real indices)."""
        mask = self._tree_mask
        if self.constraints:
            allowed: Set[int] = set()
            path = features_in_path or set()
            for group in self.constraints:
                if path <= group:
                    allowed |= group
            cmask = np.array([rf in allowed for rf in self.real_features])
            mask = mask & cmask
        if self.fraction_bynode < 1.0 and mask.any():
            mask = self._sample(mask, self.fraction_bynode)
        return mask
