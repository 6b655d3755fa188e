"""Training metadata: labels, weights, init scores, query groups, positions.

Counterpart of the reference Metadata (include/LightGBM/dataset.h:48-397,
src/io/metadata.cpp): owns the per-row side information used by objectives,
metrics and the ranking machinery. Host numpy arrays; device copies are made
by the trainer once per run.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..utils.log import Log


class Metadata:
    def __init__(self, num_data: int = 0) -> None:
        self.num_data = num_data
        self.label: Optional[np.ndarray] = None  # float32 [N]
        self.weights: Optional[np.ndarray] = None  # float32 [N]
        self.init_score: Optional[np.ndarray] = None  # float64 [N * num_class]
        self.query_boundaries: Optional[np.ndarray] = None  # int32 [num_queries + 1]
        self.query_weights: Optional[np.ndarray] = None  # float32 [num_queries]
        self.positions: Optional[np.ndarray] = None  # int32 [N] (position-debiased ranking)
        self.position_ids: Optional[np.ndarray] = None

    # ------------------------------------------------------------------- sets

    def set_label(self, label) -> None:
        label = np.asarray(label, dtype=np.float32).ravel()
        if self.num_data and len(label) != self.num_data:
            Log.fatal("Length of label is not same with #data")
        self.num_data = len(label)
        self.label = label

    def set_weights(self, weights) -> None:
        if weights is None:
            self.weights = None
            return
        weights = np.asarray(weights, dtype=np.float32).ravel()
        if self.num_data and len(weights) != self.num_data:
            Log.fatal("Length of weights is not same with #data")
        if np.any(weights < 0):
            Log.fatal("Weights should be non-negative")
        self.weights = weights
        self._update_query_weights()

    def set_init_score(self, init_score) -> None:
        if init_score is None:
            self.init_score = None
            return
        self.init_score = np.asarray(init_score, dtype=np.float64).ravel(order="F")

    def set_query(self, group) -> None:
        """`group` is per-query sizes (like the reference .query files)."""
        if group is None:
            self.query_boundaries = None
            return
        group = np.asarray(group, dtype=np.int64).ravel()
        bounds = np.zeros(len(group) + 1, dtype=np.int32)
        np.cumsum(group, out=bounds[1:])
        if self.num_data and bounds[-1] != self.num_data:
            Log.fatal("Sum of query counts is not same with #data")
        self.query_boundaries = bounds
        self._update_query_weights()

    def set_positions(self, positions) -> None:
        if positions is None:
            self.positions = None
            return
        positions = np.asarray(positions)
        uniq, inv = np.unique(positions, return_inverse=True)
        self.position_ids = uniq
        self.positions = inv.astype(np.int32)

    def _update_query_weights(self) -> None:
        """metadata.cpp: query weight = mean of member weights."""
        if self.weights is None or self.query_boundaries is None:
            self.query_weights = None
            return
        nq = len(self.query_boundaries) - 1
        qw = np.zeros(nq, dtype=np.float32)
        for q in range(nq):
            lo, hi = self.query_boundaries[q], self.query_boundaries[q + 1]
            qw[q] = self.weights[lo:hi].mean() if hi > lo else 0.0
        self.query_weights = qw

    # ------------------------------------------------------------------ query

    @property
    def num_queries(self) -> int:
        return 0 if self.query_boundaries is None else len(self.query_boundaries) - 1

    def subset(self, indices: np.ndarray) -> "Metadata":
        out = Metadata(len(indices))
        if self.label is not None:
            out.label = self.label[indices]
        if self.weights is not None:
            out.weights = self.weights[indices]
        if self.init_score is not None:
            ns = len(self.init_score) // max(self.num_data, 1)
            mat = self.init_score.reshape(ns, self.num_data)
            out.init_score = mat[:, indices].ravel()
        if self.positions is not None:
            out.positions = self.positions[indices]
            out.position_ids = self.position_ids
        # query structure is not preserved under arbitrary row subsets
        out._update_query_weights()
        return out
