"""Per-leaf linear models for linear trees.

Counterpart of the JAX package's ``treelearner/linear.py``
(LinearTreeLearner::CalculateLinear, src/treelearner/
linear_tree_learner.cpp:180-392): after a tree is grown, each leaf gets a
linear model over the numerical features on its branch path, the
hessian-weighted ridge solution of Eq 3 in de Vito (arXiv:1802.05640):

    coeffs = -(X^T H X + lambda I)^{-1} X^T g

where X is [rows in the leaf, k + 1] raw feature values with a ones column,
H = diag(hess), g = grad. Rows with a NaN in any leaf feature are left out
of the solve; a leaf with fewer usable rows than k + 1 keeps its constant
output; a singular system falls back to the pseudo-inverse; coefficients
within kZeroThreshold of zero are pruned.

The solves stay on the host in float64 numpy, the JAX package's arithmetic
op for op, so on the same inputs the coefficients are its bits. What the
card holds reaches the host in one copy each a tree: the leaves' row
indices (`leaf_rows_host`) and the tree's gradients and hessians.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from ..common import K_ZERO_THRESHOLD
from ..models.tree import Tree
from ..utils.timer import global_timer


def leaf_rows_host(partition, num_leaves: int) -> List[np.ndarray]:
    """Every leaf's row indices on the host, in the partition's order,
    from one copy of the concatenated device index sets."""
    counts = [partition.count(leaf) for leaf in range(num_leaves)]
    rows = torch.cat([partition.indices(leaf)[:cnt]
                      for leaf, cnt in enumerate(counts)]).cpu().numpy()
    return np.split(rows, np.cumsum(counts)[:-1])


def fit_leaf_linear_models(tree: Tree, dataset, raw: np.ndarray,
                           leaf_rows: Sequence[np.ndarray], grad: np.ndarray,
                           hess: np.ndarray, linear_lambda: float,
                           is_first_tree: bool) -> None:
    """Fit the per-leaf linear models in place on `tree`.

    raw: [N, F_total] raw feature matrix of the training data (float32)
    leaf_rows: each leaf's row indices (`leaf_rows_host`)
    grad, hess: [N] gradients and hessians of the tree
    """
    global_timer.add_count("linear_leaf_fits", tree.num_leaves)
    tree.is_linear = True
    if tree.leaf_const is None:
        tree.leaf_const = np.zeros(tree.max_leaves, dtype=np.float64)
        tree.leaf_coeff = [[] for _ in range(tree.max_leaves)]
        tree.leaf_features = [[] for _ in range(tree.max_leaves)]
        tree.leaf_features_inner = [[] for _ in range(tree.max_leaves)]

    n_leaves = tree.num_leaves
    if is_first_tree:
        for leaf in range(n_leaves):
            tree.leaf_const[leaf] = tree.leaf_value[leaf]
            tree.leaf_coeff[leaf] = []
            tree.leaf_features[leaf] = []
            tree.leaf_features_inner[leaf] = []
        return

    num_data = raw.shape[0]
    grad = np.asarray(grad, dtype=np.float64)
    hess = np.asarray(hess, dtype=np.float64)

    for leaf in range(n_leaves):
        # numerical features on the branch path, sorted and deduplicated
        # (linear_tree_learner.cpp:208-232)
        feats: List[int] = sorted({
            f for f in (tree.branch_features[leaf]
                        if tree.track_branch_features else [])
            if dataset.mappers[f].bin_type == 0})
        rows = np.asarray(leaf_rows[leaf])
        rows = rows[rows < num_data]
        tree.leaf_features[leaf] = []
        tree.leaf_features_inner[leaf] = []
        tree.leaf_coeff[leaf] = []
        tree.leaf_const[leaf] = tree.leaf_value[leaf]
        k = len(feats)
        if k == 0 or len(rows) == 0:
            continue
        Xl = np.asarray(raw[np.ix_(rows, feats)], dtype=np.float64)
        good = ~np.isnan(Xl).any(axis=1)
        if int(good.sum()) < k + 1:  # too few usable rows: a constant leaf
            continue
        Xl = Xl[good]
        g = grad[rows][good]
        h = hess[rows][good]
        A = np.concatenate([Xl, np.ones((Xl.shape[0], 1))], axis=1)
        XTHX = A.T @ (A * h[:, None])
        XTHX[np.arange(k), np.arange(k)] += linear_lambda
        XTg = A.T @ g
        try:
            coeffs = -np.linalg.solve(XTHX, XTg)
            if not np.isfinite(coeffs).all():
                raise np.linalg.LinAlgError
        except np.linalg.LinAlgError:
            coeffs = -np.linalg.pinv(XTHX) @ XTg
        if not np.isfinite(coeffs).all():
            continue  # keep the constant leaf
        kept_feats = []
        kept_coeffs = []
        for i, f in enumerate(feats):
            if abs(coeffs[i]) > K_ZERO_THRESHOLD:
                kept_feats.append(int(f))
                kept_coeffs.append(float(coeffs[i]))
        tree.leaf_features[leaf] = kept_feats
        tree.leaf_features_inner[leaf] = list(kept_feats)
        tree.leaf_coeff[leaf] = kept_coeffs
        tree.leaf_const[leaf] = float(coeffs[k])
