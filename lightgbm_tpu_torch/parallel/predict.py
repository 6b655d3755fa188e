"""Row-sharded prediction over the gang (the JAX package's
``parallel/predict.py``).

Prediction is independent across rows: each rank traverses its block of
the rows with the traversal kernel (``ops/predict.py:predict_raw``, the
forest kernel ``csrc/predict_forest.cu`` on the card) over the packed
ensemble its own process holds, and the [N/n, C] scores are all-gathered:
the only traffic is O(C) a row out and none in. Every rank must call it
with the same rows (as every rank of a gang trains on the same data).

A batch shards when a world of more than one rank is joined and it holds
at least `min_rows` rows (the ``pred_shard_rows`` parameter, or 65,536);
a threshold above the batch's rows keeps every row on the calling rank.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops.predict import PackedEnsemble, predict_raw, to_device_rows, validate_tree_count
from ..utils.timer import global_timer
from . import dist

_AUTO_MIN_ROWS = 1 << 16


def sharded_predict_enabled(n_rows: int, min_rows: Optional[int] = None) -> bool:
    """The row-sharding policy: a gang of more than one rank and a batch of
    at least `min_rows` rows."""
    world = dist.current_world()
    if world is None or world.size <= 1:
        return False
    return n_rows >= (_AUTO_MIN_ROWS if min_rows is None else max(1, int(min_rows)))


def predict_raw_sharded(packed: PackedEnsemble, X: np.ndarray,
                        num_tree_per_iteration: int) -> torch.Tensor:
    """Raw scores [N, C] on the packed ensemble's device: this rank's rows
    traversed, every rank's all-gathered in rank order."""
    validate_tree_count(packed, num_tree_per_iteration)
    world = dist.current_world()
    n = X.shape[0]
    with global_timer.scope("predict_shard"):
        if world is None or world.size == 1:
            return predict_raw(packed, to_device_rows(X, packed.device), num_tree_per_iteration)
        lo, hi = world.row_range(n)
        local = predict_raw(packed, to_device_rows(np.ascontiguousarray(X[lo:hi]),
                                                   packed.device),
                            num_tree_per_iteration)
        out = dist.all_gather_rows(world, local, n)
        global_timer.add_count("predict_sharded_rows", hi - lo)
        return out
