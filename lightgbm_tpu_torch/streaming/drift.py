"""Drift detection and bin-mapper refresh for the streaming flywheel.

Counterpart of the JAX package's ``streaming/drift.py``, host numpy as
there. Bin cut points are fitted once on the sampled prefix; a drifting
feature piles its out-of-support values into an edge bin. Three pieces,
all optional (``LGBM_TPU_DRIFT``):

* **QuantileSketch**: a mergeable multi-level compacting sketch (the
  Manku/KLL shape). Values buffer at level 0; a full level sorts and keeps
  every other element at doubled weight, cascading upward. Compaction
  parity alternates instead of drawing random bits, so two runs over the
  same pushes hold byte-identical sketches, and the port's equal the JAX
  package's. Zeros and NaNs are counted, not stored, as ``BinMapper.
  find_bin``'s sample convention expects.
* **DriftMonitor**: per-feature sketches and bin-occupancy counters against
  the binning-time reference. Every ``check_rows`` ingested rows it scores
  each feature's PSI and edge-bin overflow; the scores land in the gauges
  (``drift_psi_milli_max`` and the others, so ``/metrics``), in
  ``latest()`` (the service's ``stats()["drift"]``, so ``/statz``) and,
  above ``LGBM_TPU_DRIFT_THRESHOLD``, in a latched alarm with a
  ``flight-drift_alarm`` dump.
* **Mapper refresh**: ``refit_mapper_from_sketch`` rebuilds a
  sampled-prefix-shaped value array from the sketch (a rank-uniform
  quantile sample and the scaled zero and NaN counts) and runs the same
  ``find_bin`` over it. ``RowBlockStore.maybe_refresh_bins`` applies it;
  published models do not change, since their thresholds are real values.

With ``LGBM_TPU_DRIFT`` unset or 0 nothing here is constructed: a push pays
one ``is None`` check.
"""
from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from .. import telemetry, tracing
from ..common import MISSING_NAN
from ..io.binning import BIN_TYPE_NUMERICAL, BinMapper
from ..utils import faults
from ..utils.log import Log
from ..utils.timer import global_timer

DRIFT_ENV = "LGBM_TPU_DRIFT"
THRESHOLD_ENV = "LGBM_TPU_DRIFT_THRESHOLD"      # PSI alarm level (0.25)
CHECK_ROWS_ENV = "LGBM_TPU_DRIFT_CHECK_ROWS"    # score cadence in rows (1024)
REFRESH_EVERY_ENV = "LGBM_TPU_BIN_REFRESH_EVERY"  # scheduled refresh (gens)

DEFAULT_THRESHOLD = 0.25
DEFAULT_CHECK_ROWS = 1024
_PSI_EPS = 1e-6


def enabled() -> bool:
    """Drift detection opt-in. Off means ZERO overhead: RowBlockStore
    constructs no monitor and push_rows pays one None check."""
    return os.environ.get(DRIFT_ENV, "0").lower() not in (
        "0", "", "false", "off")


# --------------------------------------------------------------- sketch

class QuantileSketch:
    """Deterministic mergeable streaming quantile sketch.

    Level i holds values of weight 2**i. update() appends to the level-0
    buffer; a level reaching ``k`` items is sorted and every other item
    survives at double weight (alternating parity — no RNG), cascading
    into the next level. Total retained values stay O(k * levels).
    """

    __slots__ = ("k", "levels", "nonzero_n", "zero_n", "nan_n", "_parity")

    def __init__(self, k: int = 256) -> None:
        self.k = max(8, int(k))
        self.levels: List[np.ndarray] = [np.empty(0, dtype=np.float64)]
        self.nonzero_n = 0
        self.zero_n = 0
        self.nan_n = 0
        self._parity = 0

    def update(self, col: np.ndarray) -> None:
        """Fold one column block in. Zeros/NaNs are counted, not stored
        (the find_bin sparse-sample convention)."""
        col = np.asarray(col, dtype=np.float64).ravel()
        nan_mask = np.isnan(col)
        nz = col[(col != 0.0) & ~nan_mask]
        self.nan_n += int(nan_mask.sum())
        self.zero_n += int(len(col) - len(nz) - nan_mask.sum())
        if len(nz) == 0:
            return
        self.nonzero_n += len(nz)
        self.levels[0] = np.concatenate([self.levels[0], nz])
        self._compact()

    def _compact(self) -> None:
        lvl = 0
        while lvl < len(self.levels) and len(self.levels[lvl]) >= self.k:
            survivors = np.sort(self.levels[lvl],
                                kind="stable")[self._parity::2]
            self._parity ^= 1
            self.levels[lvl] = np.empty(0, dtype=np.float64)
            if lvl + 1 == len(self.levels):
                self.levels.append(np.empty(0, dtype=np.float64))
            self.levels[lvl + 1] = np.concatenate(
                [self.levels[lvl + 1], survivors])
            lvl += 1

    def merge(self, other: "QuantileSketch") -> "QuantileSketch":
        """Mergeable-sketch contract: fold `other` in level-by-level
        (weights align), then re-compact. Counts are additive."""
        while len(self.levels) < len(other.levels):
            self.levels.append(np.empty(0, dtype=np.float64))
        for i, lv in enumerate(other.levels):
            if len(lv):
                self.levels[i] = np.concatenate([self.levels[i], lv])
        self.nonzero_n += other.nonzero_n
        self.zero_n += other.zero_n
        self.nan_n += other.nan_n
        self._compact()
        return self

    def copy(self) -> "QuantileSketch":
        dup = QuantileSketch(self.k)
        dup.levels = [lv.copy() for lv in self.levels]
        dup.nonzero_n = self.nonzero_n
        dup.zero_n = self.zero_n
        dup.nan_n = self.nan_n
        dup._parity = self._parity
        return dup

    def healthy(self) -> bool:
        """update() strips NaN before storing, so a NaN inside a level is
        impossible organically — it is the ``sketch_corrupt`` signature
        (torn memory, a buggy merge). Detect it instead of refitting cut
        points from garbage."""
        return not any(np.isnan(lv).any() for lv in self.levels if len(lv))

    def weighted(self):
        """(values, weights) over every retained item, sorted by value."""
        vals = np.concatenate([lv for lv in self.levels])
        wts = np.concatenate([
            np.full(len(lv), 1 << i, dtype=np.int64)
            for i, lv in enumerate(self.levels)])
        order = np.argsort(vals, kind="stable")
        return vals[order], wts[order]

    def quantile_sample(self, m: int) -> np.ndarray:
        """A deterministic m-value sample at rank-uniform quantiles of the
        sketched (non-zero) distribution — the stand-in for the raw
        sampled prefix that find_bin refits cut points from."""
        if self.nonzero_n == 0 or m <= 0:
            return np.empty(0, dtype=np.float64)
        vals, wts = self.weighted()
        if len(vals) == 0:
            return np.empty(0, dtype=np.float64)
        cum = np.cumsum(wts, dtype=np.float64)
        ranks = (np.arange(m, dtype=np.float64) + 0.5) / m * cum[-1]
        idx = np.searchsorted(cum, ranks, side="left")
        return vals[np.minimum(idx, len(vals) - 1)]


def merge_ranked(pairs) -> QuantileSketch:
    """Order-canonicalized gang merge: fold ``(rank, sketch)`` pairs in
    ascending RANK order into a fresh sketch, leaving the inputs intact.

    ``QuantileSketch.merge`` is order-dependent (concatenation order and
    the alternating compaction parity both depend on the fold sequence),
    so merging shard sketches in arrival order would make the merged
    sketch — and therefore refreshed cut points — differ across reruns
    and across ranks. Canonicalizing on the rank key makes the result a
    pure function of the shard sketches, byte-stable no matter which
    order the gang's payloads landed in.
    """
    items = sorted(pairs, key=lambda rs: int(rs[0]))
    ranks = [int(r) for r, _ in items]
    if len(set(ranks)) != len(ranks):
        raise ValueError("merge_ranked needs distinct ranks, got %r" % ranks)
    if not items:
        return QuantileSketch()
    out = items[0][1].copy()
    for _, sk in items[1:]:
        out.merge(sk)
    return out


# ------------------------------------------------------------ refitting

def refit_mapper_from_sketch(mapper: BinMapper, sketch: QuantileSketch,
                             config, max_bin: int) -> Optional[BinMapper]:
    """Refit one feature's cut points from its sketch, through the same
    ``find_bin`` the original layout used. Returns None (keep the old
    mapper) for categorical/trivial features, starved or unhealthy
    sketches, or a refit that degenerates to a trivial mapper."""
    if mapper.bin_type != BIN_TYPE_NUMERICAL or mapper.is_trivial:
        return None
    if sketch is None or sketch.nonzero_n == 0:
        return None
    if not sketch.healthy():
        return None
    m = int(min(config.bin_construct_sample_cnt, sketch.nonzero_n))
    sample = sketch.quantile_sample(m)
    scale = m / max(sketch.nonzero_n, 1)
    nan_scaled = int(round(sketch.nan_n * scale))
    zero_scaled = int(round(sketch.zero_n * scale))
    values = (np.concatenate([sample, np.full(nan_scaled, np.nan)])
              if nan_scaled else sample)
    new = BinMapper()
    new.find_bin(values, m + nan_scaled + zero_scaled, max_bin,
                 min_data_in_bin=config.min_data_in_bin,
                 min_split_data=config.min_data_in_leaf,
                 pre_filter=False,  # never let a refresh drop a live feature
                 bin_type=BIN_TYPE_NUMERICAL,
                 use_missing=config.use_missing,
                 zero_as_missing=config.zero_as_missing)
    if new.is_trivial or new.num_bin < 2:
        return None
    return new


def feature_bin_lut(old: BinMapper, new: BinMapper) -> np.ndarray:
    """old-bin → new-bin lookup table, via each old bin's representative
    (upper-bound) value re-binned through the new mapper. NaN bins map to
    NaN bins (or bin 0 when the refreshed mapper dropped missing)."""
    nb = old.num_bin
    n_search = nb - 1 if old.missing_type == MISSING_NAN else nb
    reps = np.empty(nb, dtype=np.float64)
    reps[:n_search] = old.bin_upper_bound[:n_search]
    if n_search < nb:
        reps[n_search:] = np.nan
    return new.values_to_bins(reps).astype(np.int64)


def group_bin_lut(old_fg, new_fg) -> np.ndarray:
    """Group-plane old-bin → new-bin LUT for one FeatureGroup, composed
    from the per-member feature LUTs. Group structure (member list and
    order) is preserved across a refresh, only offsets move."""
    if not old_fg.is_multi:
        return feature_bin_lut(old_fg.mappers[0], new_fg.mappers[0])
    lut = np.zeros(old_fg.num_total_bin, dtype=np.int64)
    for mi, m_old in enumerate(old_fg.mappers):
        m_new = new_fg.mappers[mi]
        flut = feature_bin_lut(m_old, m_new)
        off_old = old_fg.bin_offsets[mi]
        off_new = new_fg.bin_offsets[mi]
        for b in range(m_old.num_bin):
            if b == m_old.default_bin:
                continue
            g_old = off_old + b - (1 if b > m_old.default_bin else 0)
            nb = int(flut[b])
            g_new = (0 if nb == m_new.default_bin
                     else off_new + nb - (1 if nb > m_new.default_bin else 0))
            lut[g_old] = g_new
    return lut


# -------------------------------------------------------------- monitor

# last computed scores, for /statz and the serving stats surface;
# written under the owning store's lock, read lock-free (atomic rebind)
_latest: Dict[str, Any] = {}


def latest() -> Dict[str, Any]:
    """Most recent drift summary across monitors ({} when disabled)."""
    return dict(_latest)


class DriftMonitor:
    """Per-feature drift state for one RowBlockStore (constructed only
    when ``LGBM_TPU_DRIFT`` is on — see ``from_env``)."""

    @classmethod
    def from_env(cls, config,
                 categorical_feature: Sequence[int] = ()
                 ) -> Optional["DriftMonitor"]:
        if not enabled():
            return None
        thr = float(os.environ.get(THRESHOLD_ENV, "") or DEFAULT_THRESHOLD)
        rows = int(os.environ.get(CHECK_ROWS_ENV, "") or DEFAULT_CHECK_ROWS)
        return cls(config, categorical_feature, threshold=thr,
                   check_rows=rows)

    def __init__(self, config, categorical_feature: Sequence[int] = (),
                 threshold: float = DEFAULT_THRESHOLD,
                 check_rows: int = DEFAULT_CHECK_ROWS,
                 sketch_k: int = 256) -> None:
        self.config = config
        self.categorical = set(int(c) for c in categorical_feature)
        self.threshold = float(threshold)
        self.check_rows = max(1, int(check_rows))
        self.sketch_k = int(sketch_k)
        self.sketches: List[Optional[QuantileSketch]] = []
        self.alarmed = False
        self.alarm_feature: Optional[int] = None
        self._ref: Dict[int, np.ndarray] = {}    # reference occupancy
        self._cur: Dict[int, np.ndarray] = {}    # current-window occupancy
        self._layout = None
        self._rows_since_check = 0
        self.scores: Dict[int, Dict[str, float]] = {}
        # flight-dump tag recorded under the caller's lock, written by
        # flush_pending() once the lock is released
        self._pending_dump: Optional[str] = None

    def flush_pending(self) -> None:
        """Write the flight dump a locked _check() recorded. Callers MUST
        hold no lock here: dump_flight does file I/O."""
        tag, self._pending_dump = self._pending_dump, None
        if tag is not None:
            tracing.dump_flight(tag)

    # ---------------------------------------------------------- observe

    def observe(self, block: np.ndarray, layout) -> None:
        """Fold one pushed block into the sketches (always) and the
        bin-occupancy window (once a layout exists). Called under the
        store lock from push_rows."""
        n_feat = block.shape[1]
        while len(self.sketches) < n_feat:
            j = len(self.sketches)
            self.sketches.append(None if j in self.categorical
                                 else QuantileSketch(self.sketch_k))
        for j in range(n_feat):
            sk = self.sketches[j]
            if sk is not None:
                sk.update(block[:, j])
        if layout is not None:
            self._layout = layout
            for j in self._ref:
                mapper = layout.mappers[j]
                bins = mapper.values_to_bins(
                    np.asarray(block[:, j], dtype=np.float64))
                self._cur[j] += np.bincount(
                    bins, minlength=mapper.num_bin)[:mapper.num_bin]
            self._rows_since_check += block.shape[0]
            if self._rows_since_check >= self.check_rows:
                self._check()

    def set_reference(self, layout, prefix: np.ndarray) -> None:
        """Capture the binning-time occupancy baseline from the fitted
        prefix — the distribution every later window scores against."""
        self._layout = layout
        self._ref.clear()
        self._cur.clear()
        for j in layout.used_features:
            mapper = layout.mappers[j]
            if mapper.bin_type != BIN_TYPE_NUMERICAL or mapper.is_trivial:
                continue
            bins = mapper.values_to_bins(
                np.asarray(prefix[:, j], dtype=np.float64))
            self._ref[j] = np.bincount(
                bins, minlength=mapper.num_bin)[:mapper.num_bin].astype(
                    np.float64)
            self._cur[j] = np.zeros(mapper.num_bin, dtype=np.float64)

    # ------------------------------------------------------------ score

    @staticmethod
    def psi(ref: np.ndarray, cur: np.ndarray) -> float:
        """Population-stability index between two occupancy vectors,
        epsilon-smoothed so empty bins stay finite."""
        p = (ref + _PSI_EPS) / (ref.sum() + _PSI_EPS * len(ref))
        q = (cur + _PSI_EPS) / (cur.sum() + _PSI_EPS * len(cur))
        return float(np.sum((q - p) * np.log(q / p)))

    @staticmethod
    def edge_overflow(mapper: BinMapper, ref: np.ndarray,
                      cur: np.ndarray) -> float:
        """Excess share of the current window landing in the extreme
        finite bins vs the reference — the out-of-support signature."""
        top = (mapper.num_bin - 2 if mapper.missing_type == MISSING_NAN
               else mapper.num_bin - 1)
        if top < 0 or cur.sum() <= 0:
            return 0.0
        rs, cs = max(ref.sum(), 1.0), cur.sum()
        hi = max(0.0, cur[top] / cs - ref[top] / rs)
        lo = max(0.0, cur[0] / cs - ref[0] / rs)
        return float(max(hi, lo))

    def _check(self) -> None:
        self._rows_since_check = 0
        k = faults.sketch_corrupt_feature()
        if k is not None and 0 <= k < len(self.sketches) \
                and self.sketches[k] is not None:
            # planted corruption: NaN garbage lands inside a level, which
            # healthy() flags and the next refresh discards
            self.sketches[k].levels[0] = np.concatenate(
                [self.sketches[k].levels[0], np.full(4, np.nan)])
        worst_psi, worst_edge, worst_feat = 0.0, 0.0, None
        for j, ref in self._ref.items():
            cur = self._cur[j]
            if cur.sum() <= 0:
                continue
            mapper = self._layout.mappers[j]
            s_psi = self.psi(ref, cur)
            s_edge = self.edge_overflow(mapper, ref, cur)
            self.scores[j] = {"psi": round(s_psi, 6),
                              "edge_overflow": round(s_edge, 6)}
            if s_psi > worst_psi:
                worst_psi, worst_feat = s_psi, j
            worst_edge = max(worst_edge, s_edge)
        global_timer.add_count("drift_checks", 1)
        global_timer.set_count("drift_psi_milli_max", int(worst_psi * 1000))
        global_timer.set_count("drift_edge_milli_max", int(worst_edge * 1000))
        global_timer.set_count("drift_features_tracked", len(self._ref))
        global _latest
        _latest = {
            "enabled": True,
            "max_psi": round(worst_psi, 6),
            "max_edge_overflow": round(worst_edge, 6),
            "worst_feature": worst_feat,
            "threshold": self.threshold,
            "alarmed": self.alarmed,
            "features": {int(j): dict(s) for j, s in
                         sorted(self.scores.items(),
                                key=lambda kv: -kv[1]["psi"])[:8]},
        }
        if worst_psi >= self.threshold and not self.alarmed:
            self.alarmed = True
            self.alarm_feature = worst_feat
            global_timer.add_count("drift_alarms", 1)
            Log.warning("drift: PSI %.4f on feature %s crossed the %.2f "
                        "alarm threshold (edge overflow %.4f); bin refresh "
                        "pending", worst_psi, worst_feat, self.threshold,
                        worst_edge)
            tracing.note("drift_alarm", feature=worst_feat,
                         psi=round(worst_psi, 6),
                         edge_overflow=round(worst_edge, 6))
            if telemetry.enabled():
                telemetry.emit("drift_alarm", feature=worst_feat,
                               psi=round(worst_psi, 6),
                               edge_overflow=round(worst_edge, 6),
                               threshold=self.threshold)
            # observe() runs under the ingest store's push lock; the
            # postmortem dump does file I/O, so record it here and let the
            # store write it after release (as the breaker's _maybe_dump)
            self._pending_dump = "drift_alarm"

    # ---------------------------------------------------------- refresh

    def refit_mapper(self, j: int, mapper: BinMapper) -> Optional[BinMapper]:
        """Refreshed mapper for feature j, or None to keep the old one.
        A corrupt sketch is discarded (and replaced fresh) rather than
        trusted — the ``sketch_corrupt`` containment path."""
        if j >= len(self.sketches):
            return None
        sk = self.sketches[j]
        if sk is None:
            return None
        if not sk.healthy():
            global_timer.add_count("drift_sketch_discarded", 1)
            Log.warning("drift: sketch for feature %d holds non-finite "
                        "garbage; discarding it and keeping the current "
                        "cut points", j)
            tracing.note("drift_sketch_discarded", feature=j)
            if telemetry.enabled():
                telemetry.emit("drift_sketch_discarded", feature=j)
            self.sketches[j] = QuantileSketch(self.sketch_k)
            return None
        mb = self.config.max_bin
        if self.config.max_bin_by_feature \
                and j < len(self.config.max_bin_by_feature):
            mb = self.config.max_bin_by_feature[j]
        return refit_mapper_from_sketch(mapper, sk, self.config, mb)

    def after_refresh(self, layout) -> None:
        """Re-anchor the occupancy baseline on the refreshed mappers: the
        reference becomes the sketch's own distribution binned through
        the new cut points, and the window + alarm reset."""
        self._layout = layout
        self._ref.clear()
        self._cur.clear()
        for j in layout.used_features:
            mapper = layout.mappers[j]
            if mapper.bin_type != BIN_TYPE_NUMERICAL or mapper.is_trivial:
                continue
            sk = self.sketches[j] if j < len(self.sketches) else None
            if sk is None or sk.nonzero_n == 0:
                continue
            m = int(min(self.config.bin_construct_sample_cnt, sk.nonzero_n))
            bins = mapper.values_to_bins(sk.quantile_sample(m))
            ref = np.bincount(bins, minlength=mapper.num_bin)[
                :mapper.num_bin].astype(np.float64)
            scale = m / max(sk.nonzero_n, 1)
            zero_bin = int(mapper.values_to_bins(np.zeros(1))[0])
            ref[zero_bin] += sk.zero_n * scale
            self._ref[j] = ref
            self._cur[j] = np.zeros(mapper.num_bin, dtype=np.float64)
        self.alarmed = False
        self.alarm_feature = None

    def summary(self) -> Dict[str, Any]:
        return dict(_latest) if _latest else {"enabled": True,
                                              "max_psi": 0.0,
                                              "alarmed": False}
