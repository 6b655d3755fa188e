"""Decision tree model: flat arrays, reference-compatible text format.

Counterpart of the reference Tree (include/LightGBM/tree.h:26,
src/io/tree.cpp). A tree with `num_leaves` leaves is stored as parallel arrays
of length num_leaves-1 (internal nodes) / num_leaves (leaves). Child indices
use the reference's encoding: internal node j >= 0, leaf i encoded as ~i
(negative). decision_type packs [bit0: categorical, bit1: default_left,
bits2-3: missing_type] (tree.h:20-21,274-281).

Construction happens on host (numpy); inference packs tree arrays into padded
device tensors that the forest-traversal kernel walks (ops/predict.py,
ops/predict_cuda.py). One row's walk on the host (`predict_leaf_index`, the
decisions it takes and `expected_value`) serves host TreeSHAP (shap.py).

Text format matches the reference Tree::ToString (src/io/tree.cpp:349-410)
field-for-field so models interchange with the reference's model files.
"""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np

from ..common import K_ZERO_THRESHOLD
from ..common import MISSING_NONE, MISSING_ZERO, MISSING_NAN  # noqa: F401 - re-exported

_CATEGORICAL_MASK = 1  # tree.h:20
_DEFAULT_LEFT_MASK = 2  # tree.h:21


def _fmt(x: float) -> str:
    """%.17g-style shortest-roundtrip double formatting (Common::DoubleToStr)."""
    if math.isnan(x):
        return "nan"
    if math.isinf(x):
        return "inf" if x > 0 else "-inf"
    return np.format_float_scientific(x, trim="-") if (x != 0 and (abs(x) < 1e-4 or abs(x) >= 1e17)) else repr(float(x))


class Tree:
    """A single decision tree under construction or loaded from a model file."""

    def __init__(self, max_leaves: int, track_branch_features: bool = False,
                 is_linear: bool = False) -> None:
        self.max_leaves = max_leaves
        self.num_leaves = 1
        self.num_cat = 0
        n_int = max(max_leaves - 1, 1)
        self.left_child = np.zeros(n_int, dtype=np.int32)
        self.right_child = np.zeros(n_int, dtype=np.int32)
        self.split_feature_inner = np.zeros(n_int, dtype=np.int32)
        self.split_feature = np.zeros(n_int, dtype=np.int32)
        self.split_gain = np.zeros(n_int, dtype=np.float32)
        self.threshold_in_bin = np.zeros(n_int, dtype=np.int32)
        self.threshold = np.zeros(n_int, dtype=np.float64)
        self.decision_type = np.zeros(n_int, dtype=np.int8)
        self.internal_value = np.zeros(n_int, dtype=np.float64)
        self.internal_weight = np.zeros(n_int, dtype=np.float64)
        self.internal_count = np.zeros(n_int, dtype=np.int64)
        self.leaf_value = np.zeros(max_leaves, dtype=np.float64)
        self.leaf_weight = np.zeros(max_leaves, dtype=np.float64)
        self.leaf_count = np.zeros(max_leaves, dtype=np.int64)
        self.leaf_parent = np.full(max_leaves, -1, dtype=np.int32)
        self.leaf_depth = np.zeros(max_leaves, dtype=np.int32)
        # categorical split storage (tree.h cat_boundaries_/cat_threshold_)
        self.cat_boundaries: List[int] = [0]
        self.cat_threshold: List[int] = []  # uint32 bitset words over real values
        self.cat_boundaries_inner: List[int] = [0]
        self.cat_threshold_inner: List[int] = []  # bitset words over bins
        self.shrinkage = 1.0
        self.is_linear = is_linear
        self.track_branch_features = track_branch_features
        self.branch_features: List[List[int]] = [[] for _ in range(max_leaves)] if track_branch_features else []
        # linear-tree per-leaf models
        self.leaf_const = np.zeros(max_leaves, dtype=np.float64) if is_linear else None
        self.leaf_coeff: List[List[float]] = [[] for _ in range(max_leaves)] if is_linear else []
        self.leaf_features: List[List[int]] = [[] for _ in range(max_leaves)] if is_linear else []
        self.leaf_features_inner: List[List[int]] = [[] for _ in range(max_leaves)] if is_linear else []

    # ------------------------------------------------------------------ build

    def split(self, leaf: int, feature_inner: int, real_feature: int,
              threshold_bin: int, threshold_double: float, default_left: bool,
              missing_type: int, gain: float,
              left_value: float, right_value: float,
              left_count: int, right_count: int,
              left_weight: float, right_weight: float,
              parent_value: float) -> int:
        """Numerical split of `leaf`; returns the index of the new right leaf.

        Mirrors Tree::Split (tree.h:79-88 + tree.cpp): the split leaf keeps its
        id as the left child; the new leaf id is the current num_leaves.
        """
        new_node = self.num_leaves - 1
        new_leaf = self.num_leaves
        parent = self.leaf_parent[leaf]
        if parent >= 0:
            if self.left_child[parent] == ~leaf:
                self.left_child[parent] = new_node
            else:
                self.right_child[parent] = new_node
        self.split_feature_inner[new_node] = feature_inner
        self.split_feature[new_node] = real_feature
        self.split_gain[new_node] = gain
        self.threshold_in_bin[new_node] = threshold_bin
        self.threshold[new_node] = threshold_double
        dt = np.int8(0)
        if default_left:
            dt |= _DEFAULT_LEFT_MASK
        dt |= np.int8((missing_type & 3) << 2)
        self.decision_type[new_node] = dt
        self._finish_split(new_node, leaf, new_leaf, left_value, right_value,
                           left_count, right_count, left_weight, right_weight,
                           parent_value, real_feature)
        return new_leaf

    def split_categorical(self, leaf: int, feature_inner: int, real_feature: int,
                          bin_bitset: List[int], value_bitset: List[int],
                          missing_type: int, gain: float,
                          left_value: float, right_value: float,
                          left_count: int, right_count: int,
                          left_weight: float, right_weight: float,
                          parent_value: float) -> int:
        """Categorical split: membership in bitset -> left (tree.h:89-95)."""
        new_node = self.num_leaves - 1
        new_leaf = self.num_leaves
        parent = self.leaf_parent[leaf]
        if parent >= 0:
            if self.left_child[parent] == ~leaf:
                self.left_child[parent] = new_node
            else:
                self.right_child[parent] = new_node
        self.split_feature_inner[new_node] = feature_inner
        self.split_feature[new_node] = real_feature
        self.split_gain[new_node] = gain
        self.threshold_in_bin[new_node] = self.num_cat
        self.threshold[new_node] = float(self.num_cat)
        dt = np.int8(_CATEGORICAL_MASK)
        dt |= np.int8((missing_type & 3) << 2)
        self.decision_type[new_node] = dt
        self.cat_boundaries_inner.append(self.cat_boundaries_inner[-1] + len(bin_bitset))
        self.cat_threshold_inner.extend(int(w) for w in bin_bitset)
        self.cat_boundaries.append(self.cat_boundaries[-1] + len(value_bitset))
        self.cat_threshold.extend(int(w) for w in value_bitset)
        self.num_cat += 1
        self._finish_split(new_node, leaf, new_leaf, left_value, right_value,
                           left_count, right_count, left_weight, right_weight,
                           parent_value, real_feature)
        return new_leaf

    def _finish_split(self, new_node: int, leaf: int, new_leaf: int,
                      left_value: float, right_value: float,
                      left_count: int, right_count: int,
                      left_weight: float, right_weight: float,
                      parent_value: float, real_feature: int) -> None:
        self.left_child[new_node] = ~leaf
        self.right_child[new_node] = ~new_leaf
        self.internal_value[new_node] = parent_value
        self.internal_weight[new_node] = left_weight + right_weight
        self.internal_count[new_node] = left_count + right_count
        self.leaf_parent[new_leaf] = new_node
        self.leaf_parent[leaf] = new_node
        self.leaf_value[leaf] = 0.0 if math.isnan(left_value) else left_value
        self.leaf_value[new_leaf] = 0.0 if math.isnan(right_value) else right_value
        self.leaf_weight[leaf] = left_weight
        self.leaf_weight[new_leaf] = right_weight
        self.leaf_count[leaf] = left_count
        self.leaf_count[new_leaf] = right_count
        self.leaf_depth[new_leaf] = self.leaf_depth[leaf] + 1
        self.leaf_depth[leaf] += 1
        if self.track_branch_features:
            self.branch_features[new_leaf] = self.branch_features[leaf] + [real_feature]
            self.branch_features[leaf] = self.branch_features[leaf] + [real_feature]
        self.num_leaves += 1

    def set_leaf_output(self, leaf: int, value: float) -> None:
        self.leaf_value[leaf] = 0.0 if math.isnan(value) else value

    def shrink(self, rate: float) -> None:
        """Tree::Shrinkage (tree.h:188): scale all outputs by `rate`."""
        self.leaf_value[: self.num_leaves] *= rate
        self.internal_value[: max(self.num_leaves - 1, 0)] *= rate
        if self.is_linear and self.leaf_const is not None:
            self.leaf_const[: self.num_leaves] *= rate
            for i in range(self.num_leaves):
                self.leaf_coeff[i] = [c * rate for c in self.leaf_coeff[i]]
        self.shrinkage *= rate

    def add_bias(self, val: float) -> None:
        self.leaf_value[: self.num_leaves] += val
        self.internal_value[: max(self.num_leaves - 1, 0)] += val
        if self.is_linear and self.leaf_const is not None:
            self.leaf_const[: self.num_leaves] += val
        self.shrinkage = 1.0

    def as_constant_tree(self, val: float) -> None:
        self.num_leaves = 1
        self.leaf_value[0] = val

    @property
    def max_depth(self) -> int:
        if self.num_leaves <= 1:
            return 0
        return int(self.leaf_depth[: self.num_leaves].max())

    def expected_value(self) -> float:
        """The mean output over the training rows, weighted by leaf counts
        (TreeSHAP's base value)."""
        if self.num_leaves == 1:
            return float(self.leaf_value[0])
        total = float(self.internal_count[0])
        if total <= 0:
            return float(self.leaf_value[0])
        return float(np.dot(self.leaf_value[: self.num_leaves],
                            self.leaf_count[: self.num_leaves]) / total)

    # --------------------------------------------------------- one row's walk

    def _decide_numerical(self, fval: float, node: int) -> int:
        missing_type = (int(self.decision_type[node]) >> 2) & 3
        if math.isnan(fval) and missing_type != MISSING_NAN:
            fval = 0.0
        if ((missing_type == MISSING_ZERO and abs(fval) <= K_ZERO_THRESHOLD)
                or (missing_type == MISSING_NAN and math.isnan(fval))):
            if int(self.decision_type[node]) & _DEFAULT_LEFT_MASK:
                return int(self.left_child[node])
            return int(self.right_child[node])
        if fval <= self.threshold[node]:
            return int(self.left_child[node])
        return int(self.right_child[node])

    def _decide_categorical(self, fval: float, node: int) -> int:
        if math.isnan(fval):
            return int(self.right_child[node])
        int_fval = int(fval)
        if int_fval < 0:
            return int(self.right_child[node])
        cat_idx = int(self.threshold[node])
        lo, hi = self.cat_boundaries[cat_idx], self.cat_boundaries[cat_idx + 1]
        word, bit = int_fval // 32, int_fval % 32
        if word < hi - lo and (self.cat_threshold[lo + word] >> bit) & 1:
            return int(self.left_child[node])
        return int(self.right_child[node])

    def decide(self, fval: float, node: int) -> int:
        """The child `node` sends a row whose split feature is `fval` to."""
        if int(self.decision_type[node]) & _CATEGORICAL_MASK:
            return self._decide_categorical(fval, node)
        return self._decide_numerical(fval, node)

    def predict_leaf_index(self, row: np.ndarray) -> int:
        if self.num_leaves <= 1:
            return 0
        node = 0
        while node >= 0:
            node = self.decide(float(row[self.split_feature[node]]), node)
        return ~node

    def predict(self, row: np.ndarray) -> float:
        """One row's output on the host: its leaf's value or, in a linear
        tree, leaf_const plus the coefficients times the leaf's features,
        the leaf's value where one of them is NaN or infinite."""
        leaf = self.predict_leaf_index(row)
        if self.is_linear:
            out = float(self.leaf_const[leaf])
            for feat, coef in zip(self.leaf_features[leaf], self.leaf_coeff[leaf]):
                v = float(row[feat])
                if math.isnan(v) or math.isinf(v):
                    return float(self.leaf_value[leaf])
                out += coef * v
            return out
        return float(self.leaf_value[leaf])

    # ---------------------------------------------------------- serialization

    def to_string(self) -> str:
        """Reference text format (tree.cpp:349-410)."""
        n = self.num_leaves
        ni = max(n - 1, 0)

        def ints(a, k):
            return " ".join(str(int(x)) for x in a[:k])

        def floats(a, k):
            return " ".join(_fmt(float(x)) for x in a[:k])

        lines = [f"num_leaves={n}", f"num_cat={self.num_cat}"]
        lines.append("split_feature=" + ints(self.split_feature, ni))
        lines.append("split_gain=" + " ".join(_fmt(float(x)) for x in self.split_gain[:ni]))
        lines.append("threshold=" + floats(self.threshold, ni))
        lines.append("decision_type=" + ints(self.decision_type, ni))
        lines.append("left_child=" + ints(self.left_child, ni))
        lines.append("right_child=" + ints(self.right_child, ni))
        lines.append("leaf_value=" + floats(self.leaf_value, n))
        lines.append("leaf_weight=" + floats(self.leaf_weight, n))
        lines.append("leaf_count=" + ints(self.leaf_count, n))
        lines.append("internal_value=" + floats(self.internal_value, ni))
        lines.append("internal_weight=" + floats(self.internal_weight, ni))
        lines.append("internal_count=" + ints(self.internal_count, ni))
        if self.num_cat > 0:
            lines.append("cat_boundaries=" + " ".join(str(x) for x in self.cat_boundaries))
            lines.append("cat_threshold=" + " ".join(str(x) for x in self.cat_threshold))
        lines.append(f"is_linear={1 if self.is_linear else 0}")
        if self.is_linear:
            lines.append("leaf_const=" + floats(self.leaf_const, n))
            lines.append("num_features=" + " ".join(str(len(self.leaf_features[i])) for i in range(n)))
            lines.append("leaf_features=" + " ".join(
                (" ".join(str(f) for f in self.leaf_features[i]) + " ") if self.leaf_features[i] else " "
                for i in range(n)).rstrip() )
            lines.append("leaf_coeff=" + " ".join(
                (" ".join(_fmt(c) for c in self.leaf_coeff[i]) + " ") if self.leaf_coeff[i] else " "
                for i in range(n)).rstrip())
        shr = self.shrinkage
        lines.append("shrinkage=" + (_fmt(shr) if shr != int(shr) else str(int(shr))))
        lines.append("")
        return "\n".join(lines) + "\n"

    @classmethod
    def from_key_values(cls, kv: Dict[str, str]) -> "Tree":
        """Build from a parsed `Tree=i` section (Tree::Tree(const char*, ...))."""
        num_leaves = int(kv["num_leaves"])
        tree = cls(max(num_leaves, 2))
        tree.num_leaves = num_leaves
        tree.num_cat = int(kv.get("num_cat", "0"))
        ni = max(num_leaves - 1, 0)

        def geti(key, k, dtype=np.int64):
            if k == 0 or key not in kv or kv[key] == "":
                return np.zeros(k, dtype=dtype)
            return np.array([int(x) for x in kv[key].split()], dtype=dtype)[:k]

        def getf(key, k):
            if k == 0 or key not in kv or kv[key] == "":
                return np.zeros(k, dtype=np.float64)
            return np.array([float(x) for x in kv[key].split()], dtype=np.float64)[:k]

        if ni > 0:
            tree.split_feature[:ni] = geti("split_feature", ni)
            tree.split_feature_inner[:ni] = tree.split_feature[:ni]
            tree.split_gain[:ni] = getf("split_gain", ni) if "split_gain" in kv else 0
            tree.threshold[:ni] = getf("threshold", ni)
            tree.decision_type[:ni] = geti("decision_type", ni, np.int8)
            tree.left_child[:ni] = geti("left_child", ni)
            tree.right_child[:ni] = geti("right_child", ni)
            tree.internal_value[:ni] = getf("internal_value", ni)
            tree.internal_weight[:ni] = getf("internal_weight", ni)
            tree.internal_count[:ni] = geti("internal_count", ni)
        tree.leaf_value[:num_leaves] = getf("leaf_value", num_leaves)
        tree.leaf_weight[:num_leaves] = getf("leaf_weight", num_leaves)
        tree.leaf_count[:num_leaves] = geti("leaf_count", num_leaves)
        if tree.num_cat > 0:
            tree.cat_boundaries = [int(x) for x in kv["cat_boundaries"].split()]
            tree.cat_threshold = [int(x) for x in kv["cat_threshold"].split()]
            tree.cat_boundaries_inner = list(tree.cat_boundaries)
            tree.cat_threshold_inner = list(tree.cat_threshold)
        tree.is_linear = kv.get("is_linear", "0").strip() == "1"
        if tree.is_linear:
            tree.leaf_const = np.zeros(tree.max_leaves, dtype=np.float64)
            tree.leaf_const[:num_leaves] = getf("leaf_const", num_leaves)
            nf = geti("num_features", num_leaves)
            feats = [int(x) for x in kv.get("leaf_features", "").split()]
            coefs = [float(x) for x in kv.get("leaf_coeff", "").split()]
            tree.leaf_features = []
            tree.leaf_coeff = []
            pos = 0
            for i in range(num_leaves):
                k = int(nf[i])
                tree.leaf_features.append(feats[pos: pos + k])
                tree.leaf_coeff.append(coefs[pos: pos + k])
                pos += k
            tree.leaf_features_inner = [list(f) for f in tree.leaf_features]
        tree.shrinkage = float(kv.get("shrinkage", "1"))
        # recompute leaf depth/parents from children arrays
        if num_leaves > 1:
            stack = [(0, 0)]
            while stack:
                node, depth = stack.pop()
                for child in (int(tree.left_child[node]), int(tree.right_child[node])):
                    if child < 0:
                        tree.leaf_parent[~child] = node
                        tree.leaf_depth[~child] = depth + 1
                    else:
                        stack.append((child, depth + 1))
        return tree

    # ------------------------------------------------------------------ JSON

    def to_json(self) -> str:
        """The tree as DumpModel's JSON object (tree.cpp ToJSON): nested
        split and leaf nodes; a categorical node's threshold is its
        categories joined by "||" with decision "=="."""
        import json

        def node_json(node: int):
            if node < 0:
                leaf = ~node
                return {"leaf_index": leaf, "leaf_value": self.leaf_value[leaf],
                        "leaf_weight": self.leaf_weight[leaf],
                        "leaf_count": int(self.leaf_count[leaf])}
            dt = int(self.decision_type[node])
            missing = ["None", "Zero", "NaN"][(dt >> 2) & 3]
            if dt & _CATEGORICAL_MASK:
                cat_idx = int(self.threshold[node])
                lo, hi = self.cat_boundaries[cat_idx], self.cat_boundaries[cat_idx + 1]
                cats = [(w - lo) * 32 + b for w in range(lo, hi) for b in range(32)
                        if (self.cat_threshold[w] >> b) & 1]
                threshold, decision = "||".join(str(c) for c in cats), "=="
            else:
                threshold, decision = self.threshold[node], "<="
            return {
                "split_index": node,
                "split_feature": int(self.split_feature[node]),
                "split_gain": float(self.split_gain[node]),
                "threshold": threshold,
                "decision_type": decision,
                "default_left": bool(dt & _DEFAULT_LEFT_MASK),
                "missing_type": missing,
                "internal_value": self.internal_value[node],
                "internal_weight": self.internal_weight[node],
                "internal_count": int(self.internal_count[node]),
                "left_child": node_json(int(self.left_child[node])),
                "right_child": node_json(int(self.right_child[node])),
            }

        body = {"num_leaves": self.num_leaves, "num_cat": self.num_cat,
                "shrinkage": self.shrinkage}
        if self.num_leaves == 1:
            body["tree_structure"] = {"leaf_value": self.leaf_value[0],
                                      "leaf_count": int(self.leaf_count[0])}
        else:
            body["tree_structure"] = node_json(0)
        return json.dumps(body)
