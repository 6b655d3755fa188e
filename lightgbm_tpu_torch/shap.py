"""SHAP feature contributions (TreeSHAP) on the host.

Counterpart of the JAX package's ``shap.py`` (the reference's PredictContrib
path, gbdt_prediction.cpp:99, and its Tree SHAP recursion in
src/io/tree.cpp): exact polynomial-time TreeSHAP (Lundberg et al. 2018,
"Consistent Individualized Feature Attribution for Tree Ensembles") over the
host tree arrays, in float64, with the JAX package's arithmetic in the same
order. The output is the reference's layout: [N, C * (F + 1)], a block of
F contributions and the expected value a class.
"""
from __future__ import annotations

from typing import List

import numpy as np

from .models.tree import Tree


def _tree_shap(tree: Tree, row: np.ndarray, phi: np.ndarray) -> None:
    """Add one row's TreeSHAP values over `tree` into phi [F]. A path is four
    parallel lists: feature, zero fraction, one fraction, permutation
    weight."""
    if tree.num_leaves <= 1:
        return

    def extend(d, zero, one, pw, zero_f, one_f, feat):
        d.append(feat)
        zero.append(zero_f)
        one.append(one_f)
        pw.append(1.0 if len(pw) == 0 else 0.0)
        n = len(pw)
        for i in range(n - 2, -1, -1):
            pw[i + 1] += one_f * pw[i] * (i + 1) / n
            pw[i] = zero_f * pw[i] * (n - 1 - i) / n

    def unwind(d, zero, one, pw, i):
        n = len(pw)
        one_i, zero_i = one[i], zero[i]
        nxt = pw[n - 1]
        for j in range(n - 2, -1, -1):
            if one_i != 0:
                tmp = pw[j]
                pw[j] = nxt * n / ((j + 1) * one_i)
                nxt = tmp - pw[j] * zero_i * (n - 1 - j) / n
            else:
                pw[j] = pw[j] * n / (zero_i * (n - 1 - j))
        del d[i], zero[i], one[i]
        pw.pop()

    def unwound_sum(zero, one, pw, i) -> float:
        n = len(pw)
        one_i, zero_i = one[i], zero[i]
        total = 0.0
        nxt = pw[n - 1]
        for j in range(n - 2, -1, -1):
            if one_i != 0:
                tmp = nxt * n / ((j + 1) * one_i)
                total += tmp
                nxt = pw[j] - tmp * zero_i * ((n - 1 - j) / n)
            else:
                total += pw[j] / (zero_i * ((n - 1 - j) / n))
        return total

    def node_weight(node: int) -> float:
        if node < 0:
            return float(tree.leaf_count[~node])
        return float(tree.internal_count[node])

    def recurse(node, path, zero_f, one_f, pfeat):
        d, zero, one, pw = (list(p) for p in path)
        extend(d, zero, one, pw, zero_f, one_f, pfeat)
        if node < 0:
            value = tree.leaf_value[~node]
            for i in range(1, len(pw)):
                w = unwound_sum(zero, one, pw, i)
                phi[d[i]] += w * (one[i] - zero[i]) * value
            return
        feat = int(tree.split_feature[node])
        hot = tree.decide(float(row[feat]), node)
        cold = (int(tree.right_child[node]) if hot == int(tree.left_child[node])
                else int(tree.left_child[node]))
        w = node_weight(node)
        hot_frac = node_weight(hot) / w if w > 0 else 0.0
        cold_frac = node_weight(cold) / w if w > 0 else 0.0
        incoming_zero, incoming_one = 1.0, 1.0
        if feat in d:
            k = d.index(feat)
            incoming_zero, incoming_one = zero[k], one[k]
            unwind(d, zero, one, pw, k)
        path = (d, zero, one, pw)
        recurse(hot, path, incoming_zero * hot_frac, incoming_one, feat)
        recurse(cold, path, incoming_zero * cold_frac, 0.0, feat)

    recurse(0, ([], [], [], []), 1.0, 1.0, -1)


def predict_contrib(trees: List[Tree], X: np.ndarray, num_tree_per_iteration: int = 1,
                    num_iteration: int = 0) -> np.ndarray:
    """[N, C * (F + 1)] contributions of the first `num_iteration`
    iterations' trees (all when 0). Linear trees are refused, as in the
    reference (gbdt.cpp's PredictContrib CHECKs !linear_tree_)."""
    if any(t.is_linear for t in trees):
        raise ValueError("pred_contrib (SHAP) is not supported for linear-tree models")
    n, f = X.shape
    C = num_tree_per_iteration
    n_trees = len(trees)
    if num_iteration > 0:
        n_trees = min(n_trees, num_iteration * C)
    out = np.zeros((n, C * (f + 1)), dtype=np.float64)
    for t_idx in range(n_trees):
        tree = trees[t_idx]
        base = (t_idx % C) * (f + 1)
        expected = tree.expected_value()
        for i in range(n):
            phi = np.zeros(f)
            _tree_shap(tree, X[i], phi)
            out[i, base: base + f] += phi
            out[i, base + f] += expected
    return out
