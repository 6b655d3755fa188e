"""Wrapper of the CUDA forest-traversal kernel (csrc/predict_forest.cu).

The kernel replaces ``lightgbm_tpu/ops/predict_pallas.py:pallas_predict_raw``
(see the note at the top of the source for its design and its bound on the
H100). It is written in CUDA C++ for ``sm_90a`` and built and loaded by
``ops/cuda_build.py``.

Dispatch is by the device of the input alone: a tensor on the CPU takes the
plain PyTorch version in ``ops/predict.py``; a CUDA tensor launches the
kernel, or raises. There is no fallback from one to the other.

`forest_plan` picks a launch from N and T: every block walking all trees
for large batches, or the trees split across blocks (and a second, summing
kernel for raw scores) for serving batches. `early_stop_block` is
prediction early stopping's block, one launch of its own kernel
(`lgbt_predict_early_stop`) that reads its list of active rows and their
count from the card and writes the next list and count there, so the loop
(``ops/predict.py:predict_raw_early_stop``) reads nothing between blocks.
Each wrapper counts its launches in `launches`, so a run can show that its
predictions went through the kernel.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional

import torch

from .cuda_build import CudaLibrary, require_cuda, stream_of
from .predict import (PackedEnsemble, _early_stop_block_plain, _predict_raw_fused,
                      _traverse_leaves)


def _declare(lib: ctypes.CDLL) -> None:
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.lgbt_predict_forest.argtypes = ([ptr, i64, i32, ptr, i32, i32, ptr]
                                        + [i32] * 10 + [ptr, ptr, ptr])
    lib.lgbt_predict_forest.restype = i32
    lib.lgbt_predict_early_stop.argtypes = ([ptr, i64, i32, ptr, i32, i32, ptr, i32, i32, i32]
                                            + [ptr] * 3 + [i32] * 2 + [ptr] * 5
                                            + [ctypes.c_float] + [i32] * 4 + [ptr])
    lib.lgbt_predict_early_stop.restype = i32


LIB = CudaLibrary("predict_forest.cu", ("predict_forest_raw", "predict_forest_leaf",
                                        "predict_forest_raw_acc", "predict_early_stop"),
                  _declare)
SOURCE = LIB.source
launches = LIB.launches
reset_launches = LIB.reset_launches
build = LIB.build

MAX_THREADS = 512              # csrc/predict_forest.cu kMaxThreads
TARGET_BLOCKS = 4 * 132        # ~4 blocks per SM of the H100
SPLIT_MAX_ROWS = 32_768        # below: the small-batch plan (trees split across blocks)
SPLIT_MAX_PAIRS = 1 << 24      # ... while its [T, N] float32 scratch stays <= 64 MB
TREE_BUDGET = 48 * 1024        # shared bytes for the two tree-tile buffers
X_BUDGET = 64 * 1024           # shared bytes for the row tile of X
MAX_TILE_TREES = 16
ES_TREE_BUDGET = 96 * 1024     # shared bytes for an early-stopping block's trees
MODES = {"raw": 0, "raw_split": 1, "leaf": 2}


@dataclass(frozen=True)
class ForestPlan:
    """One launch's shape (csrc/predict_forest.cu lgbt_predict_forest)."""

    split: bool            # trees split across blocks (grid.y > 1 possible)
    rows_per_block: int    # threads a block, one row each
    trees_per_block: int
    tile_trees: int        # trees a shared-memory tile
    stage_x: bool          # X's row tile in shared memory
    stage_trees: bool      # tree tiles in shared memory (else read from global)


def forest_plan(n: int, T: int, n_features: int, record_words: int) -> ForestPlan:
    """The launch of a traversal of n rows through T trees. Which plan (trees
    split across blocks for small n, or every block walking all trees)
    depends on n and T alone; F and the tree size decide only what is
    staged in shared memory."""
    split = n < SPLIT_MAX_ROWS and n * T <= SPLIT_MAX_PAIRS
    if split:
        rows = min(256, -(-n // 32) * 32)
        row_blocks = -(-n // rows)
        splits = max(1, min(T, -(-TARGET_BLOCKS // row_blocks)))
        trees_per_block = -(-T // splits)
    else:
        rows = next((r for r in (MAX_THREADS, 256) if -(-n // r) >= TARGET_BLOCKS // 2), 128)
        trees_per_block = T
    tree_bytes = record_words * 4
    stage_trees = 2 * tree_bytes <= TREE_BUDGET
    tile = max(1, min(MAX_TILE_TREES, trees_per_block, TREE_BUDGET // (2 * tree_bytes)))
    stage_x = rows * n_features * 4 <= X_BUDGET
    return ForestPlan(split, rows, trees_per_block, tile, stage_x, stage_trees)


def _check(packed: PackedEnsemble, X: torch.Tensor) -> None:
    if X.dim() != 2 or X.dtype != torch.float32 or not X.is_contiguous():
        raise ValueError(f"X must be a contiguous 2-D float32 tensor, got "
                         f"{X.dtype} {tuple(X.shape)}")
    if X.shape[1] < packed.num_features:
        raise ValueError(f"X has {X.shape[1]} columns; the model splits on "
                         f"feature {packed.num_features - 1}")
    if X.shape[1] == 0:
        raise ValueError("X has no columns: a packed node record reads a feature "
                         "even where the tree is a single leaf")
    for name in ("records", "cat_table", "leaf_value"):
        t = getattr(packed, name)
        want = torch.float32 if name == "leaf_value" else torch.int32
        if t.device != X.device or t.dtype != want or not t.is_contiguous():
            raise ValueError(f"packed table {name} must be a contiguous {want} tensor "
                             f"on {X.device}, got {t.dtype} on {t.device}")
    T, I = packed.split_feature.shape
    if packed.records.dim() != 2 or packed.records.shape[0] != T \
            or packed.records.shape[1] % 4 or packed.records.shape[1] <= 4 * I:
        raise ValueError(f"packed records must be [T={T}, R] with R a multiple of 4 "
                         f"past the {4 * I} node words, got "
                         f"{list(packed.records.shape)}")


def _launch(packed: PackedEnsemble, X: torch.Tensor, C: int, mode: str,
            out: torch.Tensor, accumulate: bool = False) -> int:
    n, F = X.shape
    T, I = packed.split_feature.shape
    R = packed.records.shape[1]
    plan = forest_plan(n, T, F, R)
    if mode == "raw" and plan.split:
        mode = "raw_split"
    vals = (torch.empty((T, n), dtype=torch.float32, device=X.device)
            if mode == "raw_split" else None)
    lib = LIB.load()
    with torch.cuda.device(X.device):
        return lib.lgbt_predict_forest(
            X.data_ptr(), n, F, packed.records.data_ptr(), R, I, packed.cat_table.data_ptr(),
            T, packed.max_depth, C, MODES[mode], plan.rows_per_block, plan.trees_per_block,
            plan.tile_trees, int(plan.stage_x), int(plan.stage_trees), int(accumulate),
            out.data_ptr(), None if vals is None else vals.data_ptr(), stream_of(X))


def forest_raw(packed: PackedEnsemble, X: torch.Tensor, num_tree_per_iteration: int,
               out: Optional[torch.Tensor] = None, accumulate: bool = False) -> torch.Tensor:
    """Raw scores [N, C] float32 (C = num_tree_per_iteration), each class
    summing its trees in ascending iteration order, from 0 or, with
    `accumulate`, from the value `out` holds (the kernel's accumulate mode,
    counted as predict_forest_raw_acc: prediction early stopping adds a
    block of trees onto running sums this way). A CPU tensor takes the
    plain version; a CUDA tensor launches the kernel."""
    C = num_tree_per_iteration
    if packed.linear and X.device.type != "cpu":
        raise ValueError("a linear-tree ensemble is scored from the leaf mode "
                         "(ops/predict.py:predict_raw), not the raw mode")
    if accumulate and out is None:
        raise ValueError("accumulate adds onto out: pass the running sums")
    if X.device.type == "cpu":
        res = _predict_raw_fused(packed, X, C, out if accumulate else None)
        return res if out is None else out.copy_(res)
    require_cuda(X, "the forest traversal")
    _check(packed, X)
    n, T = X.shape[0], packed.split_feature.shape[0]
    if C < 1 or T % C:
        raise ValueError(f"{T} packed trees do not group into {C} classes")
    if out is None:
        out = torch.empty((n, C), dtype=torch.float32, device=X.device)
    elif out.shape != (n, C) or out.dtype != torch.float32 \
            or out.device != X.device or not out.is_contiguous():
        raise ValueError(f"out must be a contiguous float32 [{n}, {C}] tensor "
                         f"on {X.device}")
    if n == 0:
        return out
    err = _launch(packed, X, C, "raw", out, accumulate)
    LIB.count("predict_forest_raw_acc" if accumulate else "predict_forest_raw", err)
    return out


def forest_leaf_indices(packed: PackedEnsemble, X: torch.Tensor) -> torch.Tensor:
    """Leaf indices [N, T] int32. A CPU tensor takes the plain version; a
    CUDA tensor launches the kernel."""
    if X.device.type == "cpu":
        return _traverse_leaves(packed, X)
    require_cuda(X, "the forest traversal")
    _check(packed, X)
    n, T = X.shape[0], packed.split_feature.shape[0]
    out = torch.empty((n, T), dtype=torch.int32, device=X.device)
    if n == 0:
        return out
    err = _launch(packed, X, 1, "leaf", out)
    LIB.count("predict_forest_leaf", err)
    return out


@dataclass(frozen=True)
class EarlyStopPlan:
    """One early-stopping block's launch (lgbt_predict_early_stop)."""

    threads: int           # a block's threads: 32 listed rows a warp at a time
    stage_trees: bool      # the block's trees in shared memory (else global)
    stage_x: bool          # each warp's 32 rows of X in shared memory
    vec4: bool             # ... loaded as 16-byte vectors


def early_stop_plan(n_trees: int, n_features: int, record_words: int,
                    x_aligned: bool) -> EarlyStopPlan:
    """The launch of an early-stopping block of n_trees trees over rows of
    n_features features: the most threads whose rows of X fit X_BUDGET
    (staged), the trees staged whole while they fit ES_TREE_BUDGET."""
    threads = next((t for t in (MAX_THREADS, 256, 128) if t * n_features * 4 <= X_BUDGET), 0)
    stage_x = threads > 0
    stage_trees = n_trees * record_words * 4 <= ES_TREE_BUDGET
    vec4 = stage_x and n_features % 4 == 0 and x_aligned
    return EarlyStopPlan(threads or 256, stage_trees, stage_x, vec4)


def early_stop_block(packed: PackedEnsemble, X: torch.Tensor, scores: torch.Tensor,
                     num_tree_per_iteration: int, margin: float,
                     rows_in: Optional[torch.Tensor], count_in: torch.Tensor,
                     rows_out: torch.Tensor, count_out: torch.Tensor) -> None:
    """One block of prediction early stopping over the block's trees
    `packed` (a tree_slice): the rows rows_in[:count_in] (rows_in None: rows
    0 .. count_in - 1) add the block onto their running sums in scores
    [N, C], and those whose margin does not exceed `margin` (a float32
    value) go to rows_out, count_out their number (ops/predict.py:
    _early_stop_block_plain). count_in and count_out are one-element int32
    tensors beside X; count_out must hold 0. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel (counted as
    predict_early_stop), which reads the count and writes the next on the
    card: nothing is read to the host."""
    C = num_tree_per_iteration
    if X.device.type == "cpu":
        _early_stop_block_plain(packed, X, scores, C, margin, rows_in, count_in, rows_out,
                                count_out)
        return
    require_cuda(X, "prediction early stopping")
    _check(packed, X)
    n, F = X.shape
    T, I = packed.split_feature.shape
    if C < 1 or T % C:
        raise ValueError(f"{T} packed trees do not group into {C} classes")
    if not 1 <= n < 1 << 31:
        raise ValueError(f"prediction early stopping takes 1 to 2**31 - 1 rows, got {n}")
    if scores.shape != (n, C) or scores.dtype != torch.float32 or scores.device != X.device \
            or not scores.is_contiguous():
        raise ValueError(f"scores must be a contiguous float32 [{n}, {C}] tensor on {X.device}")
    for name, t, size in (("rows_in", rows_in, n), ("rows_out", rows_out, n),
                          ("count_in", count_in, 1), ("count_out", count_out, 1)):
        if t is None and name == "rows_in":
            continue
        if t.dtype != torch.int32 or t.device != X.device or not t.is_contiguous() \
                or t.dim() != 1 or t.shape[0] < size:
            raise ValueError(f"{name} must be a contiguous int32 vector of at least {size} "
                             f"on {X.device}, got {t.dtype} {list(t.shape)} on {t.device}")
    R = packed.records.shape[1]
    plan = early_stop_plan(T, F, R, X.data_ptr() % 16 == 0)
    lin = (packed.lin_const, packed.lin_feat, packed.lin_coeff) if packed.linear else None
    if lin is not None:
        for name, t, want in zip(("lin_const", "lin_feat", "lin_coeff"), lin,
                                 (torch.float32, torch.int32, torch.float32)):
            if t.device != X.device or t.dtype != want or not t.is_contiguous():
                raise ValueError(f"packed table {name} must be a contiguous {want} tensor "
                                 f"on {X.device}")
    L, K = (lin[1].shape[1], lin[1].shape[2]) if lin is not None else (0, 0)
    lin_ptrs = (None,) * 3 if lin is None else tuple(t.data_ptr() for t in lin)
    lib = LIB.load()
    with torch.cuda.device(X.device):
        err = lib.lgbt_predict_early_stop(
            X.data_ptr(), n, F, packed.records.data_ptr(), R, I, packed.cat_table.data_ptr(),
            T, packed.max_depth, C, *lin_ptrs, L, K, scores.data_ptr(),
            None if rows_in is None else rows_in.data_ptr(), count_in.data_ptr(), rows_out.data_ptr(), count_out.data_ptr(), float(margin),
            plan.threads, int(plan.stage_trees), int(plan.stage_x), int(plan.vec4),
            stream_of(X))
    LIB.count("predict_early_stop", err)
