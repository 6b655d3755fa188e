"""Standalone C++ code generation for trained models (``convert_model``).

Counterpart of the JAX package's ``models/codegen.py`` (GBDT::
SaveModelToIfElse / Tree::ToIfElse, src/boosting/gbdt_model_text.cpp:
127-312, src/io/tree.cpp:566-700): emits a self-contained C++ translation
unit where every tree is a nested if-else function over a `const double*`
feature row, plus `PredictRaw` / `Predict` aggregates with the objective's
output transform. The emitted file compiles with plain g++ (no
dependencies) and exports C symbols so it can be loaded through
ctypes/dlopen. For the same model text the text is byte-equal to the JAX
package's.

Decision semantics mirror models/tree.py: missing-type None coerces NaN to
0.0, Zero routes |fval| <= kZeroThreshold to the default side, NaN routes
NaN; categorical membership tests a uint32 bitset. Linear-tree leaf models
emit `const + dot(coeffs, features)` with the NaN fallback.
"""
from __future__ import annotations

from typing import List

from .serialize import GBDTModel
from .tree import Tree, _CATEGORICAL_MASK, _DEFAULT_LEFT_MASK

_PRELUDE = """// Generated by lightgbm_tpu convert_model (if-else codegen).
#include <cmath>
#include <cstdint>

static const double kZeroThreshold = 1e-35;

static inline bool InBitset(const uint32_t* bits, int n_words, int val) {
  if (val < 0) return false;
  int w = val / 32;
  if (w >= n_words) return false;
  return (bits[w] >> (val % 32)) & 1;
}
"""


def _fmt(x: float) -> str:
    return repr(float(x))


def _node_code(tree: Tree, node: int, indent: str) -> str:
    """Nested if-else for one internal node (Tree::NodeToIfElse)."""
    if node < 0:
        leaf = ~node
        if tree.is_linear and tree.leaf_const is not None:
            feats = tree.leaf_features[leaf]
            coefs = tree.leaf_coeff[leaf]
            if feats:
                terms = " + ".join(
                    f"{_fmt(c)} * arr[{f}]" for f, c in zip(feats, coefs))
                guards = " || ".join(f"!std::isfinite(arr[{f}])"
                                     for f in feats)
                return (f"{indent}if ({guards}) return "
                        f"{_fmt(float(tree.leaf_value[leaf]))};\n"
                        f"{indent}return "
                        f"{_fmt(float(tree.leaf_const[leaf]))} + {terms};\n")
            return f"{indent}return {_fmt(float(tree.leaf_const[leaf]))};\n"
        return f"{indent}return {_fmt(float(tree.leaf_value[leaf]))};\n"

    dt = int(tree.decision_type[node])
    f = int(tree.split_feature[node])
    left = int(tree.left_child[node])
    right = int(tree.right_child[node])
    out = []
    if dt & _CATEGORICAL_MASK:
        cat_idx = int(tree.threshold[node])
        lo, hi = tree.cat_boundaries[cat_idx], tree.cat_boundaries[cat_idx + 1]
        out.append(f"{indent}if (std::isnan(arr[{f}]) || arr[{f}] < 0 || "
                   f"!InBitset(cat_threshold + {lo}, {hi - lo}, "
                   f"(int)arr[{f}])) {{\n")
        out.append(_node_code(tree, right, indent + "  "))
        out.append(f"{indent}}} else {{\n")
        out.append(_node_code(tree, left, indent + "  "))
        out.append(f"{indent}}}\n")
        return "".join(out)

    missing = (dt >> 2) & 3
    default_left = bool(dt & _DEFAULT_LEFT_MASK)
    thr = _fmt(float(tree.threshold[node]))
    out.append(f"{indent}fval = arr[{f}];\n")
    if missing == 0:  # MissingType::None: NaN coerces to 0.0 (tree.py:218)
        out.append(f"{indent}if (std::isnan(fval)) fval = 0.0;\n")
        cond = f"fval <= {thr}"
    elif missing == 1:  # Zero
        out.append(f"{indent}if (std::isnan(fval)) fval = 0.0;\n")
        miss = f"std::fabs(fval) <= kZeroThreshold"
        cond = (f"({miss}) ? {str(default_left).lower()} : (fval <= {thr})")
    else:  # NaN
        cond = (f"std::isnan(fval) ? {str(default_left).lower()} "
                f": (fval <= {thr})")
    out.append(f"{indent}if ({cond}) {{\n")
    out.append(_node_code(tree, left, indent + "  "))
    out.append(f"{indent}}} else {{\n")
    out.append(_node_code(tree, right, indent + "  "))
    out.append(f"{indent}}}\n")
    return "".join(out)


def _tree_function(tree: Tree, index: int) -> str:
    body: List[str] = [f"static double PredictTree{index}"
                       "(const double* arr) {\n"]
    if tree.num_leaves <= 1:
        body.append(f"  return {_fmt(float(tree.leaf_value[0]))};\n")
    else:
        if tree.num_cat > 0:
            words = ", ".join(str(int(w)) for w in tree.cat_threshold)
            body.append(f"  static const uint32_t cat_threshold[] = "
                        f"{{{words}}};\n")
        body.append("  double fval = 0.0;\n")
        body.append("  (void)fval;\n")
        body.append(_node_code(tree, 0, "  "))
    body.append("}\n")
    return "".join(body)


def _objective_transform(objective_str: str, C: int) -> str:
    obj = (objective_str or "").split(" ")[0]
    if obj == "binary":
        sigmoid = 1.0
        for tok in (objective_str or "").split(" ")[1:]:
            if tok.startswith("sigmoid:"):
                sigmoid = float(tok.split(":")[1])
        return (f"  out[0] = 1.0 / (1.0 + std::exp(-{_fmt(sigmoid)} * "
                "out[0]));\n")
    if obj in ("multiclass", "softmax"):
        return ("  double wmax = out[0], wsum = 0.0;\n"
                f"  for (int c = 1; c < {C}; ++c) "
                "if (out[c] > wmax) wmax = out[c];\n"
                f"  for (int c = 0; c < {C}; ++c) "
                "{ out[c] = std::exp(out[c] - wmax); wsum += out[c]; }\n"
                f"  for (int c = 0; c < {C}; ++c) out[c] /= wsum;\n")
    if obj in ("multiclassova", "multiclass_ova", "ova", "ovr"):
        sigmoid = 1.0
        for tok in (objective_str or "").split(" ")[1:]:
            if tok.startswith("sigmoid:"):
                sigmoid = float(tok.split(":")[1])
        return (f"  for (int c = 0; c < {C}; ++c) out[c] = "
                f"1.0 / (1.0 + std::exp(-{_fmt(sigmoid)} * out[c]));\n")
    if obj in ("poisson", "gamma", "tweedie"):
        return f"  for (int c = 0; c < {C}; ++c) out[c] = std::exp(out[c]);\n"
    if obj in ("cross_entropy", "xentropy"):
        return "  out[0] = 1.0 / (1.0 + std::exp(-out[0]));\n"
    return ""


def model_to_cpp(model: GBDTModel) -> str:
    """Full if-else translation unit (GBDT::ModelToIfElse)."""
    C = max(model.num_tree_per_iteration, 1)
    T = len(model.trees)
    parts = [_PRELUDE]
    for i, tree in enumerate(model.trees):
        parts.append(_tree_function(tree, i))
    calls = "\n".join(
        f"  out[{i % C}] += PredictTree{i}(arr);" for i in range(T))
    avg = ""
    if model.average_output and T:
        n_iter = T // C
        avg = (f"  for (int c = 0; c < {C}; ++c) out[c] /= {n_iter};\n")
    parts.append(f"""
extern "C" void PredictRaw(const double* arr, double* out) {{
  for (int c = 0; c < {C}; ++c) out[c] = 0.0;
{calls}
{avg}}}

extern "C" void Predict(const double* arr, double* out) {{
  PredictRaw(arr, out);
{_objective_transform(model.objective_str, C)}}}

extern "C" int NumPredictionOutputs(void) {{ return {C}; }}
""")
    return "".join(parts)
