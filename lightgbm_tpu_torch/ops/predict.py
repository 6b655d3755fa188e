"""Tree-ensemble inference: packed forest tables, traversal, serving cache.

Counterpart of the JAX package's ``ops/predict.py``. All trees are packed
into padded [T, nodes] struct-of-arrays tensors (`PackedEnsemble`) that
live on one device. On the CUDA card the traversal is the hand-written
kernel in ``csrc/predict_forest.cu`` (wrapper: ``ops/predict_cuda.py``),
the port of ``ops/predict_pallas.py:pallas_predict_raw``. Beside it, in
this module, is its plain PyTorch version: the level-synchronous gather
loop of the JAX package (`forest_level_step` / `_traverse_leaves` /
`_leaf_scores` / `_predict_raw_fused`), on tensors. The wrapper runs the
plain version only for tensors that lie on the CPU; the tests hold it
against the JAX functions and the kernel against it.

Linear-tree ensembles (`PackedEnsemble.linear`) score a leaf as its
constant plus its coefficients times the row's raw values, falling back to
the constant leaf value where one of them is NaN or infinite
(`_linear_leaf_scores`, the JAX package's predict.py:274-296). Their
traversal is the kernel's leaf mode on the card (`forest_leaf_indices`),
then that epilogue in PyTorch ops.

Serving-path machinery on top of the traversal:

  * `PredictorCache` — packs the ensemble once per (model version, tree
    slice) and keeps it on the device across Booster.predict calls.
  * `predict_raw_streamed` — row chunks for large N, so only one chunk of
    the input is on the device at a time.
  * `predict_raw_early_stop` — prediction early stopping: blocks of trees
    (`PackedEnsemble.tree_slice`, views of the pack), each traversed by the
    still-active rows only, the kernel adding onto their running sums.

Not ported yet: row-sharded predict.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Mapping, Optional, Sequence, Union

import numpy as np
import torch

from .. import telemetry
from ..common import K_ZERO_THRESHOLD, MISSING_NAN, MISSING_ZERO
from ..models.tree import Tree
from ..utils.log import Log
from ..utils.timer import global_timer

# the ten tables of the struct-of-arrays pack (the JAX package's field order)
TABLES = ("split_feature", "threshold", "decision_type", "left_child",
          "right_child", "leaf_value", "cat_words", "cat_offset",
          "cat_n_words", "num_leaves")
RECORD_WORDS = 4            # int32 words of one packed node record (16 bytes)
MAX_CHILD = 1 << 29         # a child id (or ~leaf) fits the record's 30 bits


@dataclass
class PackedEnsemble:
    """Padded forest tables on one device.

    Shapes: T = number of trees, I = max internal nodes, L = max leaves,
    W = total categorical bitset words (>= 1). `cat_words` holds the
    uint32 bitset words as int32 bit patterns (bit b of a word is the same
    bit either way). `records` and `cat_table` are the same forest in the
    CUDA kernel's packed node records (`forest_records`); the ten tables
    serve the plain version.
    """

    split_feature: torch.Tensor  # [T, I] int32
    threshold: torch.Tensor  # [T, I] float32, rounded toward -inf
    decision_type: torch.Tensor  # [T, I] int32
    left_child: torch.Tensor  # [T, I] int32
    right_child: torch.Tensor  # [T, I] int32
    leaf_value: torch.Tensor  # [T, L] float32
    cat_words: torch.Tensor  # [W] int32 bitset words (real-value space)
    cat_offset: torch.Tensor  # [T, I] int32 word offset for categorical nodes
    cat_n_words: torch.Tensor  # [T, I] int32
    num_leaves: torch.Tensor  # [T] int32
    records: torch.Tensor  # [T, R] int32: the CUDA kernel's tree blobs (forest_records)
    cat_table: torch.Tensor  # [W2] int32: bitsets behind the records' categorical nodes
    max_depth: int
    num_trees: int
    num_features: int  # columns an input needs: one past the largest feature read
    # linear trees: each leaf's constant, features and coefficients (K the
    # most features of a leaf; an unused slot has feature -1, coefficient 0)
    linear: bool = False
    lin_const: Optional[torch.Tensor] = None  # [T, L] float32
    lin_feat: Optional[torch.Tensor] = None  # [T, L, K] int32
    lin_coeff: Optional[torch.Tensor] = None  # [T, L, K] float32

    @property
    def device(self) -> torch.device:
        return self.leaf_value.device

    def tables(self) -> tuple:
        return tuple(getattr(self, name) for name in TABLES)

    def tree_slice(self, start: int, end: int) -> "PackedEnsemble":
        """Trees [start, end) as views of this pack's tables (no repack, no
        copy): the kernel's records are rows of `records`, and the
        categorical bitsets stay whole, which their absolute offsets
        index."""
        def rows(t):
            return None if t is None else t[start:end]

        return PackedEnsemble(
            split_feature=rows(self.split_feature), threshold=rows(self.threshold),
            decision_type=rows(self.decision_type), left_child=rows(self.left_child),
            right_child=rows(self.right_child), leaf_value=rows(self.leaf_value),
            cat_words=self.cat_words, cat_offset=rows(self.cat_offset),
            cat_n_words=rows(self.cat_n_words), num_leaves=rows(self.num_leaves),
            records=rows(self.records), cat_table=self.cat_table,
            max_depth=self.max_depth, num_trees=end - start,
            num_features=self.num_features, linear=self.linear,
            lin_const=rows(self.lin_const), lin_feat=rows(self.lin_feat),
            lin_coeff=rows(self.lin_coeff))


def forest_records(arrays: Mapping[str, np.ndarray]):
    """The CUDA kernel's form of the ten tables: (records [T, R] int32,
    cat_table [W2] int32), built once with the pack.

    Each tree is one 16-byte aligned blob of R = 4 * I + L4 words: I node
    records of four words, then its L leaf values (float32 bits) padded to
    L4, a multiple of four. A node record holds, in one aligned 16-byte
    load, what the SoA tables spread over five:

      word 0  the float32 threshold's bits; for a categorical node the
              index in cat_table of [n_words, word 0, word 1, ...]
      word 1  the split feature
      word 2  left child  << 2 | decision_type bits 0-1 (categorical, default left)
      word 3  right child << 2 | decision_type bits 2-3 (missing type)

    A child is a node id, or ~leaf for a leaf, in 30 signed bits (an
    arithmetic shift by 2 recovers it). A single-leaf tree's root sends
    both ways to leaf 0."""
    sf = np.asarray(arrays["split_feature"]).astype(np.int32)
    T, I = sf.shape
    dt = np.asarray(arrays["decision_type"]).astype(np.int32)
    lc = np.asarray(arrays["left_child"]).astype(np.int32)
    rc = np.asarray(arrays["right_child"]).astype(np.int32)
    nl = np.asarray(arrays["num_leaves"]).astype(np.int32)
    for child in (lc, rc):
        if child.size and (child.min() < -MAX_CHILD or child.max() >= MAX_CHILD):
            Log.fatal("A tree has more than %d nodes: too many for the packed "
                      "node record", MAX_CHILD)
    nodes = np.empty((T, I, RECORD_WORDS), dtype=np.int32)
    nodes[..., 0] = np.ascontiguousarray(arrays["threshold"], dtype=np.float32).view(np.int32)
    nodes[..., 1] = sf
    nodes[..., 2] = (lc << 2) | (dt & 3)
    nodes[..., 3] = (rc << 2) | ((dt >> 2) & 3)
    words = np.ascontiguousarray(arrays["cat_words"], dtype=np.uint32).view(np.int32)
    co = np.asarray(arrays["cat_offset"]).astype(np.int64)
    cn = np.asarray(arrays["cat_n_words"]).astype(np.int64)
    cat_t, cat_j = np.nonzero((dt & 1) != 0)
    table = [np.zeros(1, dtype=np.int32)]  # entry 0: no words (never referenced)
    at = 1
    for t, j in zip(cat_t, cat_j):
        n = int(cn[t, j])
        table.append(np.concatenate([[n], words[co[t, j]:co[t, j] + n]]).astype(np.int32))
        nodes[t, j, 0] = at
        at += 1 + n
    nodes[nl <= 1, 0] = (0, 0, ~0 << 2, ~0 << 2)
    lv = np.ascontiguousarray(arrays["leaf_value"], dtype=np.float32)
    L4 = -(-lv.shape[1] // 4) * 4
    leaves = np.zeros((T, L4), dtype=np.float32)
    leaves[:, :lv.shape[1]] = lv
    records = np.concatenate([nodes.reshape(T, RECORD_WORDS * I), leaves.view(np.int32)],
                             axis=1)
    return records, np.concatenate(table)


def pack_ensemble(trees: Sequence[Tree], device: Union[str, torch.device] = "cpu",
                  fixed_leaves: int = 0, fixed_depth: int = 0) -> PackedEnsemble:
    """Pack host Tree objects into padded tensors on `device`.

    fixed_leaves / fixed_depth force the padded node count and traversal
    depth. Thresholds are stored in float32, rounded toward -inf: for any
    float32 x, (x <= t64) == (x <= rounddown32(t64)), so decisions over
    float32 inputs match the float64 thresholds of the model text exactly.
    """
    with global_timer.scope("predict_pack"):
        T = max(len(trees), 1)
        I = max(max((t.num_leaves - 1 for t in trees), default=1), 1,
                fixed_leaves - 1)
        L = max(max((t.num_leaves for t in trees), default=1), 1, fixed_leaves)
        sf = np.zeros((T, I), dtype=np.int32)
        th = np.zeros((T, I), dtype=np.float64)
        dt = np.zeros((T, I), dtype=np.int32)
        lc = np.full((T, I), -1, dtype=np.int32)
        rc = np.full((T, I), -1, dtype=np.int32)
        lv = np.zeros((T, L), dtype=np.float64)
        nl = np.ones(T, dtype=np.int32)
        co = np.zeros((T, I), dtype=np.int32)
        cw_n = np.zeros((T, I), dtype=np.int32)
        cat_words = []
        max_depth = 1
        for k, tree in enumerate(trees):
            ni = tree.num_leaves - 1
            nl[k] = tree.num_leaves
            if ni > 0:
                sf[k, :ni] = tree.split_feature[:ni]
                th[k, :ni] = tree.threshold[:ni]
                dt[k, :ni] = tree.decision_type[:ni].astype(np.int32) & 0xFF
                lc[k, :ni] = tree.left_child[:ni]
                rc[k, :ni] = tree.right_child[:ni]
                max_depth = max(max_depth, tree.max_depth)
                for node in range(ni):
                    if dt[k, node] & 1:  # categorical
                        cat_idx = int(tree.threshold[node])
                        lo, hi = tree.cat_boundaries[cat_idx], tree.cat_boundaries[cat_idx + 1]
                        co[k, node] = len(cat_words)
                        cw_n[k, node] = hi - lo
                        cat_words.extend(tree.cat_threshold[lo:hi])
            lv[k, : tree.num_leaves] = tree.leaf_value[: tree.num_leaves]
        if not cat_words:
            cat_words = [0]
        th32 = th.astype(np.float32)
        over = th32.astype(np.float64) > th
        th32[over] = np.nextafter(th32[over], -np.inf)
        arrays = {
            "split_feature": sf, "threshold": th32, "decision_type": dt,
            "left_child": lc, "right_child": rc,
            "leaf_value": lv.astype(np.float32),
            "cat_words": np.array(cat_words, dtype=np.uint32),
            "cat_offset": co, "cat_n_words": cw_n, "num_leaves": nl,
        }
        packed = packed_from_numpy(arrays, max_depth=max(int(max_depth), fixed_depth),
                                   num_trees=len(trees), device=device)
        if any(t.is_linear for t in trees):
            _pack_linear(packed, trees, lv, device)
        return packed


def _pack_linear(packed: PackedEnsemble, trees: Sequence[Tree], lv: np.ndarray,
                 device) -> None:
    """The linear leaves' tables (the JAX package's predict.py:148-163):
    a tree that is not linear keeps its leaf values as constants."""
    T, L = lv.shape
    K = max((len(t.leaf_features[i]) for t in trees if t.is_linear
             for i in range(t.num_leaves)), default=0)
    lin_const = lv.copy()
    lin_feat = np.full((T, L, K), -1, dtype=np.int32)
    lin_coeff = np.zeros((T, L, K), dtype=np.float64)
    for k, tree in enumerate(trees):
        if not tree.is_linear or tree.leaf_const is None:
            continue
        lin_const[k, : tree.num_leaves] = tree.leaf_const[: tree.num_leaves]
        for i in range(tree.num_leaves):
            nf = len(tree.leaf_features[i])
            if nf:
                lin_feat[k, i, :nf] = tree.leaf_features[i]
                lin_coeff[k, i, :nf] = tree.leaf_coeff[i]
    packed.linear = True
    packed.lin_const = torch.from_numpy(lin_const.astype(np.float32)).to(device)
    packed.lin_feat = torch.from_numpy(lin_feat).to(device)
    packed.lin_coeff = torch.from_numpy(lin_coeff.astype(np.float32)).to(device)
    if K and lin_feat.max() >= packed.num_features:
        packed.num_features = int(lin_feat.max()) + 1


def packed_from_numpy(arrays: Union[Mapping[str, np.ndarray], Sequence[np.ndarray]],
                      *, max_depth: int, num_trees: int,
                      device: Union[str, torch.device] = "cpu") -> PackedEnsemble:
    """A PackedEnsemble from its ten tables as numpy arrays — a mapping by
    table name, or a sequence in `TABLES` order (the field order of the
    JAX package's PackedEnsemble, so `[np.asarray(a) for a in jax_pack
    fields]` carries a JAX pack across). Integer tables become int32,
    float tables float32, and the uint32 bitset words keep their bits."""
    if not isinstance(arrays, Mapping):
        arrays = dict(zip(TABLES, arrays))
    for name in ("threshold", "leaf_value"):
        if np.asarray(arrays[name]).dtype != np.float32:
            Log.fatal("table %s must be float32 (got %s); pack_ensemble "
                      "rounds float64 thresholds toward -inf", name,
                      np.asarray(arrays[name]).dtype)
    out = {}
    for name in TABLES:
        a = np.asarray(arrays[name])
        if name == "cat_words":
            a = np.ascontiguousarray(a, dtype=np.uint32).view(np.int32)
        elif name not in ("threshold", "leaf_value"):
            a = a.astype(np.int32)
        out[name] = torch.from_numpy(np.array(a, order="C")).to(device)  # a copy
    records, cat_table = forest_records(arrays)
    out["records"] = torch.from_numpy(records).to(device)
    out["cat_table"] = torch.from_numpy(cat_table).to(device)
    sf = np.asarray(arrays["split_feature"])
    return PackedEnsemble(**out, max_depth=int(max_depth), num_trees=int(num_trees),
                          num_features=int(sf.max()) + 1 if num_trees else 0)


def predict_dtype(X) -> torch.dtype:
    """Device dtype for a predict input: always float32. The JAX package
    runs float64 only with jax x64 on, which is off by default; the
    round-toward--inf threshold downcast keeps float32 decisions identical
    to the float64 reference."""
    return torch.float32


def to_device_rows(X: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host matrix as a float32 C-contiguous tensor on `device`."""
    X = np.ascontiguousarray(X, dtype=np.float32)
    if not X.flags.writeable:  # e.g. a view of a request frame
        X = X.copy()
    return torch.from_numpy(X).to(device)


# ------------------------------------------------- traversal (plain version)

_ZERO_THRESHOLD = torch.tensor(K_ZERO_THRESHOLD, dtype=torch.float32)
_INT32_MAX_F32 = 2147483520.0  # largest float32 below 2**31


def forest_level_step(X: torch.Tensor, node: torch.Tensor, sf: torch.Tensor,
                      th: torch.Tensor, dt: torch.Tensor, lc: torch.Tensor,
                      rc: torch.Tensor, co: torch.Tensor, cn: torch.Tensor,
                      cat_words: torch.Tensor) -> torch.Tensor:
    """Advance every (row, tree) pair one level: node [N, T] -> [N, T].

    Node attributes for all T trees' current nodes gather from the
    flattened [T*I] tables in one shot, and the feature values come from
    one gather over X. The decision rules are those of Tree::Decision
    (tree.h:338-388): NaN/zero missing with default-left, `<=` on the
    float32 threshold, categorical bitset membership with negative, NaN
    and out-of-range values going right."""
    T, I = sf.shape
    tree_base = torch.arange(T, dtype=torch.int64, device=X.device)[None, :] * I
    active = node >= 0
    nd = tree_base + node.clamp(min=0).to(torch.int64)  # flat [N, T] into [T*I]
    feat = sf.reshape(-1)[nd]
    d = dt.reshape(-1)[nd]
    fval = torch.gather(X, 1, feat.to(torch.int64))
    is_cat = (d & 1) > 0
    default_left = (d & 2) > 0
    missing_type = (d >> 2) & 3
    # --- numerical decision (tree.h:338-355)
    is_nan = torch.isnan(fval)
    fval_num = torch.where(is_nan & (missing_type != MISSING_NAN),
                           torch.zeros_like(fval), fval)
    is_missing = ((missing_type == MISSING_ZERO)
                  & (fval_num.abs() <= _ZERO_THRESHOLD.to(X.device))) | (
        (missing_type == MISSING_NAN) & torch.isnan(fval_num))
    go_left_num = torch.where(is_missing, default_left,
                              fval_num <= th.reshape(-1)[nd])
    # --- categorical decision (tree.h:375-388); the float -> int32 cast
    # truncates toward zero and saturates, as the kernel's __float2int_rz
    int_fval = torch.where(
        is_nan, torch.full_like(feat, -1),
        fval.clamp(-2147483648.0, _INT32_MAX_F32).to(torch.int32)).to(torch.int64)
    word_idx = int_fval.clamp(min=0) // 32
    bit_idx = int_fval.clamp(min=0) % 32
    in_range = (int_fval >= 0) & (word_idx < cn.reshape(-1)[nd])
    word = cat_words[(co.reshape(-1)[nd] + word_idx).clamp(0, cat_words.shape[0] - 1)]
    go_left_cat = in_range & (((word >> bit_idx.to(torch.int32)) & 1) > 0)
    go_left = torch.where(is_cat, go_left_cat, go_left_num)
    nxt = torch.where(go_left, lc.reshape(-1)[nd], rc.reshape(-1)[nd])
    return torch.where(active, nxt, node)


def _traverse_leaves(packed: PackedEnsemble, X: torch.Tensor) -> torch.Tensor:
    """[N, T] int32 leaf index per row per tree, level-synchronous over the
    whole forest."""
    n = X.shape[0]
    T = packed.split_feature.shape[0]
    node = torch.zeros((n, T), dtype=torch.int32, device=X.device)
    for _ in range(packed.max_depth):
        node = forest_level_step(
            X, node, packed.split_feature, packed.threshold,
            packed.decision_type, packed.left_child, packed.right_child,
            packed.cat_offset, packed.cat_n_words, packed.cat_words)
    # a leaf id is the bitwise complement of the (negative) frozen node;
    # single-leaf (constant) trees sit at leaf 0
    return torch.where(packed.num_leaves[None, :] <= 1,
                       torch.zeros_like(node), ~node)


def _traverse_records(packed: PackedEnsemble, X: torch.Tensor) -> torch.Tensor:
    """[N, T] int32 leaf indices from the packed node records, the walk of
    the CUDA kernel written level-synchronously: one record gather a level
    in place of five table gathers. The tests hold it equal to
    `_traverse_leaves`."""
    n = X.shape[0]
    T, I = packed.split_feature.shape
    nodes = packed.records[:, :RECORD_WORDS * I].reshape(T * I, RECORD_WORDS)
    table = packed.cat_table
    tree_base = torch.arange(T, dtype=torch.int64, device=X.device)[None, :] * I
    node = torch.zeros((n, T), dtype=torch.int32, device=X.device)
    zero = _ZERO_THRESHOLD.to(X.device)
    for _ in range(packed.max_depth):
        rec = nodes[tree_base + node.clamp(min=0).to(torch.int64)]  # [N, T, 4]
        word0, feat, left, right = rec.unbind(-1)
        dt = (left & 3) | ((right & 3) << 2)
        fval = torch.gather(X, 1, feat.to(torch.int64))
        is_nan = torch.isnan(fval)
        missing_type = (dt >> 2) & 3
        fnum = torch.where(is_nan & (missing_type != MISSING_NAN), torch.zeros_like(fval),
                           fval)
        missing = ((missing_type == MISSING_ZERO) & (fnum.abs() <= zero)) | (
            (missing_type == MISSING_NAN) & torch.isnan(fnum))
        go_num = torch.where(missing, (dt & 2) > 0, fnum <= word0.view(torch.float32))
        iv = torch.where(is_nan, torch.full_like(feat, -1),
                         fval.clamp(-2147483648.0, _INT32_MAX_F32).to(torch.int32))
        is_cat = (dt & 1) > 0
        base = torch.where(is_cat, word0, 0).to(torch.int64)
        widx = iv.clamp(min=0).to(torch.int64) >> 5
        in_range = is_cat & (iv >= 0) & (widx < table[base])
        word = table[torch.where(in_range, base + 1 + widx, 0)]
        go_cat = in_range & (((word >> (iv.clamp(min=0) & 31)) & 1) > 0)
        go_left = torch.where(is_cat, go_cat, go_num)
        nxt = torch.where(go_left, left >> 2, right >> 2)
        node = torch.where(node >= 0, nxt, node)
    return ~node


def _leaf_scores(packed: PackedEnsemble, leaf: torch.Tensor) -> torch.Tensor:
    """Per-(row, tree) leaf values [N, T] from leaf assignments."""
    T, L = packed.leaf_value.shape
    flat = torch.arange(T, dtype=torch.int64, device=leaf.device)[None, :] * L \
        + leaf.to(torch.int64)
    return packed.leaf_value.reshape(-1)[flat]


def _linear_leaf_scores(packed: PackedEnsemble, X: torch.Tensor,
                        leaf: torch.Tensor) -> torch.Tensor:
    """Per-(row, tree) scores [N, T] of a linear-tree ensemble from leaf
    assignments: the leaf's constant plus the sum over its K slots of
    coefficient x raw value, or the constant leaf value where one of its
    features is NaN or infinite (Tree::PredictByMap's linear path). The K
    terms are summed in one fixed order, a float32 add at a time from
    zero, each op on its own, so a CPU tensor and a CUDA tensor give the
    same bits (the JAX package keeps this math eager, unfused, for the
    same reason: predict.py:358-364)."""
    T, L = packed.leaf_value.shape
    flat = torch.arange(T, dtype=torch.int64, device=leaf.device)[None, :] * L \
        + leaf.to(torch.int64)
    base = packed.leaf_value.reshape(-1)[flat]
    K = packed.lin_feat.shape[2]
    n_cols = X.shape[1]
    total = torch.zeros_like(base)
    bad = torch.zeros(base.shape, dtype=torch.bool, device=base.device)
    for k in range(K):
        feat = packed.lin_feat[:, :, k].reshape(-1)[flat]  # [N, T]
        used = feat >= 0
        fv = torch.gather(X, 1, feat.clamp(0, n_cols - 1).to(torch.int64))
        bad |= used & ~torch.isfinite(fv)
        fv = torch.where(used, fv, torch.zeros_like(fv))
        term = packed.lin_coeff[:, :, k].reshape(-1)[flat] * fv
        total = total + torch.where(used, term, torch.zeros_like(term))
    lin = packed.lin_const.reshape(-1)[flat] + total
    return torch.where(bad, base, lin)


def _class_sums(vals: torch.Tensor, num_tree_per_iteration: int,
                init: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[N, T] per-tree scores -> [N, C]: each class sums its trees in
    ascending iteration order, one float32 add at a time, from 0 or from
    `init` [N, C]."""
    C = num_tree_per_iteration
    out = (torch.zeros((vals.shape[0], C), dtype=torch.float32, device=vals.device)
           if init is None else init.clone())
    for it in range(vals.shape[1] // C):
        out += vals[:, it * C:(it + 1) * C]
    return out


def _predict_raw_fused(packed: PackedEnsemble, X: torch.Tensor,
                       num_tree_per_iteration: int,
                       init: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Traverse + score + per-class accumulate: [N, C] float32. Each class
    sums its trees in ascending iteration order, one float32 add at a
    time, starting from 0 (or from `init`) — the kernel's order, so the
    two agree bit for bit; the JAX package's XLA reduction may sum in
    another order."""
    leaf = _traverse_leaves(packed, X)
    vals = (_linear_leaf_scores(packed, X, leaf) if packed.linear
            else _leaf_scores(packed, leaf))
    return _class_sums(vals, num_tree_per_iteration, init)


# ------------------------------------------------------------ entry points


def predict_leaf_indices(packed: PackedEnsemble, X: torch.Tensor) -> torch.Tensor:
    """[N, T] int32 leaf index per row per tree."""
    from .predict_cuda import forest_leaf_indices

    if packed.num_trees == 0:
        return torch.zeros((X.shape[0], 0), dtype=torch.int32, device=X.device)
    with global_timer.scope("predict_traverse"):
        return forest_leaf_indices(packed, X)


def validate_tree_count(packed: PackedEnsemble,
                        num_tree_per_iteration: int) -> None:
    """The packed tree count must cover whole iterations: a ragged slice
    would mis-assign trees to classes in the per-class accumulate."""
    if num_tree_per_iteration > 0 \
            and packed.num_trees % num_tree_per_iteration != 0:
        Log.fatal(
            "Cannot predict with %d trees grouped %d per iteration: the "
            "slice does not cover whole iterations (check num_iteration / "
            "start_iteration against the model's tree count)",
            packed.num_trees, num_tree_per_iteration)


def predict_raw(packed: PackedEnsemble, X: torch.Tensor,
                num_tree_per_iteration: int = 1,
                out: Optional[torch.Tensor] = None,
                accumulate: bool = False) -> torch.Tensor:
    """Raw scores [N, num_tree_per_iteration] summed over iterations,
    written into `out` when one is given, or added onto it with
    `accumulate` (each class's chain of adds continuing from out's value).
    A linear-tree ensemble takes the traversal's leaf indices (the kernel's
    leaf mode on the card) and the linear epilogue."""
    from .predict_cuda import forest_leaf_indices, forest_raw

    if packed.num_trees == 0:
        if accumulate:
            return out
        zeros = torch.zeros((X.shape[0], num_tree_per_iteration),
                            dtype=torch.float32, device=X.device)
        return zeros if out is None else out.copy_(zeros)
    validate_tree_count(packed, num_tree_per_iteration)
    if packed.linear:
        with global_timer.scope("predict_traverse"):
            leaf = forest_leaf_indices(packed, X)
        with global_timer.scope("predict_linear"):
            res = _class_sums(_linear_leaf_scores(packed, X, leaf), num_tree_per_iteration,
                              out if accumulate else None)
        return res if out is None else out.copy_(res)
    with global_timer.scope("predict_traverse"):
        return forest_raw(packed, X, num_tree_per_iteration, out=out, accumulate=accumulate)


def predict_raw_early_stop(packed: PackedEnsemble, X: torch.Tensor,
                           num_tree_per_iteration: int, round_period: int,
                           margin_threshold: float) -> torch.Tensor:
    """Raw scores [N, C] with prediction early stopping (the JAX package's
    predict.py:716-756, src/boosting/prediction_early_stop.cpp): after each
    block of `round_period` iterations, a row whose margin exceeds
    `margin_threshold` (2 |score| for one class, the gap between the top
    two classes otherwise) takes no further trees.

    The scores and the active mask stay on X's device. A block gathers the
    still-active rows in ascending order (the mask's nonzero positions) and
    their running sums, adds the block's trees onto those sums (the
    traversal kernel's accumulate mode on a `tree_slice` of the pack), and
    writes them back. The one host sync a block is the active count, which
    sizes the nonzero positions. A
    row's sum is the same chain of float32 adds as the whole traversal's,
    so with an infinite margin the result is the plain predict's bit for
    bit; the JAX package adds each block's XLA sum onto the running score
    instead."""
    C = num_tree_per_iteration
    T = packed.num_trees
    validate_tree_count(packed, C)
    n = X.shape[0]
    dev = X.device
    scores = torch.zeros((n, C), dtype=torch.float32, device=dev)
    active = torch.ones(n, dtype=torch.bool, device=dev)
    margin = torch.tensor(margin_threshold, dtype=torch.float32, device=dev)
    block = max(round_period, 1) * C
    with global_timer.scope("predict_early_stop"):
        for start in range(0, T, block):
            idx = torch.nonzero(active).reshape(-1)
            cnt = idx.shape[0]
            if cnt == 0:
                break
            sums = scores[idx]
            predict_raw(packed.tree_slice(start, min(start + block, T)), X[idx], C,
                        out=sums, accumulate=True)
            scores[idx] = sums
            if C == 1:
                margin_val = 2.0 * torch.abs(sums[:, 0])
            else:
                top2 = torch.topk(sums, 2, dim=1).values
                margin_val = top2[:, 0] - top2[:, 1]
            active[idx] = ~(margin_val > margin)
            global_timer.add_count("predict_early_stop_row_trees",
                                   cnt * (min(start + block, T) - start))
    return scores


# ------------------------------------------------------------------- cache


class PredictorCache:
    """Device-resident PackedEnsemble cache for the serving path.

    Repeated Booster.predict calls reuse the packed tables already on the
    device instead of re-packing and re-uploading the ensemble per call.
    Keys are (model version, tree slice); any mutation of the model list
    must call invalidate(), which bumps the version and drops every entry.
    A small LRU bound keeps sliced predicts from pinning unbounded device
    memory.

    Thread safety: batcher threads call `get` while a model swap may call
    `invalidate`, so every access holds one lock, and packing on a miss
    happens under it too — concurrent misses for one key must not upload
    the ensemble twice."""

    def __init__(self, device: Union[str, torch.device] = "cpu",
                 capacity: int = 4) -> None:
        self.device = torch.device(device)
        self.capacity = capacity
        self._version = 0
        self._entries: "OrderedDict[tuple, PackedEnsemble]" = OrderedDict()
        self._lock = threading.Lock()

    def invalidate(self) -> None:
        with self._lock:
            self._version += 1
            self._entries.clear()

    def get(self, trees: Sequence[Tree], start: int, end: int) -> PackedEnsemble:
        with self._lock:
            key = (self._version, start, end)
            hit = self._entries.get(key)
            if hit is not None:
                self._entries.move_to_end(key)
                global_timer.add_count("predict_pack_hits", 1)
                return hit
            packed = pack_ensemble(trees[start:end], device=self.device)
            self._entries[key] = packed
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
            return packed


# --------------------------------------------------------------- streaming

_AUTO_CHUNK_ROWS = 1 << 18       # 256k-row device chunks
_AUTO_STREAM_MIN_ROWS = 1 << 19  # stream once the batch is >= two chunks


def stream_chunk_rows(n_rows: int, requested: Optional[int] = None) -> int:
    """Row-chunk size for streamed predict; 0 means run single-shot.

    `requested` (the pred_chunk_rows param) wins; otherwise auto: 256k
    chunks once the batch is at least two of them. Chunks round up to a
    power of two (ops/partition.bucket_size)."""
    from .partition import bucket_size

    chunk = requested
    if chunk is None:
        chunk = _AUTO_CHUNK_ROWS if n_rows >= _AUTO_STREAM_MIN_ROWS else 0
    if chunk <= 0 or n_rows <= chunk:
        return 0
    return bucket_size(chunk, 256)


def predict_raw_streamed(packed: PackedEnsemble, X: np.ndarray,
                         num_tree_per_iteration: int, chunk: int) -> torch.Tensor:
    """Chunked raw predict for large N, from a host matrix: each chunk is
    uploaded and traversed into its rows of one [N, C] output on the
    pack's device, so only one chunk of the input is on the device at a
    time. Rows are independent, so the result is bit-equal to a
    single-shot predict."""
    validate_tree_count(packed, num_tree_per_iteration)
    n = X.shape[0]
    out = torch.empty((n, num_tree_per_iteration), dtype=torch.float32,
                      device=packed.device)
    n_chunks = -(-n // chunk)
    with global_timer.scope("predict_stream"):
        for i, start in enumerate(range(0, n, chunk)):
            stop = min(start + chunk, n)
            predict_raw(packed, to_device_rows(X[start:stop], packed.device),
                        num_tree_per_iteration, out=out[start:stop])
            if telemetry.enabled():
                telemetry.emit("predict_chunk", index=i, rows=stop - start, pad=0)
        global_timer.add_count("predict_stream_chunks", n_chunks)
    return out
