"""Streaming ingest: the row-block store behind LGBM_DatasetPushRows*.

Counterpart of the JAX package's ``streaming/ingest.py`` (the reference's
streaming dataset construction, ``LGBM_DatasetCreateByReference`` +
``LGBM_DatasetPushRows`` / ``LGBM_DatasetPushRowsByCSR``, c_api.cpp).
Callers push row blocks (numpy matrices, CSR chunks, chunked CSV files,
iterators) and the store produces an io/dataset.py core Dataset without
ever holding the raw matrix. All of it is host numpy.

  * Raw blocks buffer on the host until `bin_sample_rows` rows have arrived
    (by default Config.bin_construct_sample_cnt). The bin layout (mappers,
    used features, EFB groups) is then fitted once on exactly the first
    `bin_sample_rows` rows through Dataset._fit_layout, so the cut points
    depend on the pushed rows and never on how they were chunked. Every
    block (the buffered ones first, then each new push) is then binned
    through Dataset._bin_rows into a C-contiguous [num_groups, block_rows]
    slab and its raw rows dropped.
  * Binning is per row, so the slabs side by side are byte-identical to a
    one-shot Dataset.from_matrix under the same layout. While the pushed
    rows stay within the sample budget, the layout is the one-shot one.
  * finalize() snapshots the store into a core Dataset, optionally of the
    first `num_rows` rows only (the continuous trainer's row watermark),
    and the store stays open for more pushes.
"""
from __future__ import annotations

import threading
from typing import Iterable, List, Optional, Sequence

import numpy as np

from ..config import Config
from ..io.dataset import Dataset as CoreDataset
from ..utils import faults
from ..utils.log import Log
from ..utils.timer import global_timer
from .. import telemetry, tracing
from . import drift


def _as_block(data) -> np.ndarray:
    """Normalize one pushed block to a 2-D float matrix, mirroring
    from_matrix's dtype rule (f32/f64 kept, everything else -> f64)."""
    block = np.asarray(data)
    if block.ndim == 1:
        block = block.reshape(1, -1)
    if block.ndim != 2:
        raise ValueError(f"pushed block must be 2-D, got shape {block.shape}")
    if block.dtype not in (np.float32, np.float64):
        block = block.astype(np.float64)
    return block


def _csr_to_dense(indptr: np.ndarray, indices: np.ndarray, values: np.ndarray,
                  num_col: int) -> np.ndarray:
    """Densify one CSR chunk (reference PushRowsByCSR semantics: absent
    entries are 0.0, duplicate column entries keep the last write)."""
    indptr = np.asarray(indptr, dtype=np.int64)
    indices = np.asarray(indices, dtype=np.int64)
    values = np.asarray(values, dtype=np.float64)
    nrow = len(indptr) - 1
    block = np.zeros((nrow, int(num_col)), dtype=np.float64)
    for r in range(nrow):
        lo, hi = indptr[r], indptr[r + 1]
        block[r, indices[lo:hi]] = values[lo:hi]
    return block


class RowBlockStore:
    """Incremental row-block dataset store (the streaming ingest front).

    Thread-safe for one pusher at a time interleaved with finalize() from
    another thread (the continuous-training flywheel's pattern).
    """

    def __init__(self, params: Optional[dict] = None,
                 config: Optional[Config] = None,
                 n_features: Optional[int] = None,
                 categorical_feature: Sequence[int] = (),
                 feature_names: Optional[Sequence[str]] = None,
                 bin_sample_rows: Optional[int] = None,
                 holdout_rows: int = 0) -> None:
        self.config = config or Config(dict(params) if params else {})
        self.n_features = int(n_features) if n_features else None
        self.categorical_feature = tuple(categorical_feature)
        self.feature_names = list(feature_names) if feature_names else None
        self.bin_sample_rows = int(bin_sample_rows
                                   if bin_sample_rows is not None
                                   else self.config.bin_construct_sample_cnt)
        self._lock = threading.RLock()
        self._raw_blocks: List[np.ndarray] = []      # pre-layout buffer
        self._raw_labels: List[Optional[np.ndarray]] = []
        self._bin_blocks: List[np.ndarray] = []      # [G, rows] slabs
        self._labels: List[Optional[np.ndarray]] = []  # aligned with pushes
        self._weights: List[Optional[np.ndarray]] = []
        self._layout: Optional[CoreDataset] = None
        self.total_rows = 0
        # full-array metadata overrides (C-API LGBM_DatasetSetField routing)
        self._field_overrides: dict = {}
        # drift detection (None unless LGBM_TPU_DRIFT is on: the hot push
        # path then pays exactly one is-None check)
        self._drift = drift.DriftMonitor.from_env(
            self.config, self.categorical_feature)
        # group composition pinned at the prefix fit; a bin refresh refits
        # cut points but keeps the EFB bundles (history can't re-conflict)
        self._group_lists: Optional[List[List[int]]] = None
        # bin layout generation: bumped by every maybe_refresh_bins swap,
        # recorded in checkpoint sidecars for resume verification
        self.layout_generation = 0
        # raw tail ring for the publish quality gate's pinned holdout
        self.holdout_rows = int(holdout_rows)
        self._tail: List[tuple] = []   # (raw block, label) most-recent-last
        self._tail_n = 0

    # ------------------------------------------------------------------ push

    def push_rows(self, data, label=None, weight=None) -> "RowBlockStore":
        """Push one row block. Feature count is pinned by the first push
        (or the n_features constructor arg — the C-API contract)."""
        block = _as_block(data)
        if label is not None:
            label = np.asarray(label, dtype=np.float64).ravel()
            if len(label) != block.shape[0]:
                raise ValueError("label length does not match pushed rows")
        if weight is not None:
            weight = np.asarray(weight, dtype=np.float64).ravel()
            if len(weight) != block.shape[0]:
                raise ValueError("weight length does not match pushed rows")
        with self._lock:
            if self.n_features is None:
                self.n_features = block.shape[1]
            elif block.shape[1] != self.n_features:
                raise ValueError(
                    f"pushed block has {block.shape[1]} features, "
                    f"store expects {self.n_features}")
            block = faults.maybe_shift_block(block, self.total_rows)
            if self._drift is not None:
                self._drift.observe(block, self._layout)
            if self.holdout_rows > 0:
                self._tail.append((block, label))
                self._tail_n += block.shape[0]
                while self._tail and \
                        self._tail_n - self._tail[0][0].shape[0] \
                        >= self.holdout_rows:
                    self._tail_n -= self._tail.pop(0)[0].shape[0]
            self._labels.append(label)
            self._weights.append(weight)
            if self._layout is None:
                self._raw_blocks.append(block)
                self._buffered = getattr(self, "_buffered", 0) + block.shape[0]
                if self._buffered >= self.bin_sample_rows:
                    self._fit_and_drain()
            else:
                self._bin_blocks.append(
                    np.ascontiguousarray(self._layout._bin_rows(block)))
            self.total_rows += block.shape[0]
            global_timer.add_count("stream_ingest_rows", block.shape[0])
            global_timer.add_count("stream_ingest_bytes", block.nbytes)
        if self._drift is not None:
            self._drift.flush_pending()  # drift-alarm dump, outside _lock
        return self

    def push_csr(self, indptr, indices, values, num_col: int,
                 label=None, weight=None) -> "RowBlockStore":
        """Push one CSR chunk (LGBM_DatasetPushRowsByCSR parity)."""
        return self.push_rows(_csr_to_dense(indptr, indices, values, num_col),
                              label=label, weight=weight)

    def push_csv(self, path: str, chunk_rows: int = 65536,
                 header: Optional[bool] = None,
                 label_column: Optional[str] = None) -> "RowBlockStore":
        """Parse a CSV/TSV file (io/parser.py dialect) and push it in
        chunk_rows-sized blocks — the file is parsed once, streamed in."""
        from ..io.parser import parse_file

        X, y, names = parse_file(
            path,
            header=self.config.header if header is None else header,
            label_column=(label_column if label_column is not None
                          else (self.config.label_column or "0")))
        if self.feature_names is None and names:
            self.feature_names = list(names)
        for lo in range(0, X.shape[0], int(chunk_rows)):
            hi = min(X.shape[0], lo + int(chunk_rows))
            self.push_rows(X[lo:hi], label=y[lo:hi] if y is not None else None)
        return self

    def push_from_iterator(self, blocks: Iterable) -> "RowBlockStore":
        """Drain an iterator of blocks: each item is either a matrix or an
        (X, y) tuple."""
        for item in blocks:
            if isinstance(item, tuple):
                X, y = item
                self.push_rows(X, label=y)
            else:
                self.push_rows(item)
        return self

    # ------------------------------------------------- C-API duck surface
    # (capi/impl.py routes LGBM_Dataset* calls through these so a streaming
    # handle drops into every shim that expects a basic.Dataset)

    def num_data(self) -> int:
        return self.total_rows

    def num_feature(self) -> int:
        return self.n_features or 0

    def set_label(self, label) -> "RowBlockStore":
        self._field_overrides["label"] = np.asarray(label, dtype=np.float64).ravel()
        return self

    def set_weight(self, weight) -> "RowBlockStore":
        self._field_overrides["weight"] = (
            None if weight is None else np.asarray(weight, dtype=np.float64).ravel())
        return self

    def set_group(self, group) -> "RowBlockStore":
        self._field_overrides["group"] = np.asarray(group).ravel()
        return self

    def set_init_score(self, init_score) -> "RowBlockStore":
        self._field_overrides["init_score"] = (
            None if init_score is None else np.asarray(init_score, dtype=np.float64))
        return self

    def set_position(self, position) -> "RowBlockStore":
        self._field_overrides["position"] = np.asarray(position).ravel()
        return self

    # -------------------------------------------------------------- layout

    def _fit_and_drain(self) -> None:
        """Fit the bin layout on the buffered prefix, then bin and drop
        every buffered raw block. Called under self._lock."""
        prefix = (self._raw_blocks[0] if len(self._raw_blocks) == 1
                  else np.concatenate(self._raw_blocks, axis=0))
        # the last block can overshoot the sample budget; fit on EXACTLY
        # bin_sample_rows rows so the cut points depend only on the pushed
        # row sequence, never on how callers chunked it (the overshoot rows
        # still get binned below — only the fit sample is clipped)
        prefix = prefix[:self.bin_sample_rows]
        layout = CoreDataset(self.config)
        with global_timer.scope("stream_fit_layout"):
            group_lists = layout._fit_layout(prefix, self.categorical_feature)
            layout._make_groups(group_lists)
        self._layout = layout
        self._group_lists = group_lists
        if self._drift is not None:
            self._drift.set_reference(layout, prefix)
        for blk in self._raw_blocks:
            self._bin_blocks.append(np.ascontiguousarray(layout._bin_rows(blk)))
        self._raw_blocks = []
        self._buffered = 0
        if telemetry.enabled():
            telemetry.emit("stream_layout_fitted",
                           sample_rows=int(prefix.shape[0]),
                           num_groups=len(layout.groups))

    def _require_layout(self) -> CoreDataset:
        if self._layout is None:
            if not self._raw_blocks:
                raise ValueError("RowBlockStore is empty: push rows first")
            self._fit_and_drain()
        return self._layout

    def _concat_field(self, name: str, blocks: List[Optional[np.ndarray]],
                      num_rows: int) -> Optional[np.ndarray]:
        override = self._field_overrides.get(name)
        if override is not None:
            return override[:num_rows] if override.ndim == 1 else override
        provided = [b for b in blocks if b is not None]
        if not provided:
            return None
        if len(provided) != len(blocks):
            raise ValueError(
                f"{name} was provided on some pushes but not others")
        return np.concatenate(provided)[:num_rows]

    # ------------------------------------------------------------- finalize

    def finalize(self, num_rows: Optional[int] = None) -> CoreDataset:
        """Snapshot the store into a core io/dataset.py Dataset.

        num_rows pins the snapshot to the first N rows (the continuous
        trainer's crash-consistent refit watermark); default is every row
        pushed so far. The store remains open for further pushes."""
        with self._lock:
            layout = self._require_layout()
            n = self.total_rows if num_rows is None else int(num_rows)
            if n > self.total_rows:
                raise ValueError(
                    f"finalize({n}) exceeds pushed rows ({self.total_rows})")
            plane = (self._bin_blocks[0] if len(self._bin_blocks) == 1
                     else np.concatenate(self._bin_blocks, axis=1))
            plane = np.ascontiguousarray(plane[:, :n])
            label = self._concat_field("label", self._labels, n)
            weight = self._concat_field("weight", self._weights, n)
            ds = CoreDataset.from_layout(
                layout, plane, n, label=label, weight=weight,
                group=self._field_overrides.get("group"),
                init_score=self._field_overrides.get("init_score"),
                position=self._field_overrides.get("position"),
                feature_names=self.feature_names)
            global_timer.set_count("stream_finalized_rows", n)
            return ds

    def to_basic_dataset(self, num_rows: Optional[int] = None,
                         params: Optional[dict] = None):
        """finalize() wrapped for Booster/engine consumption."""
        return wrap_dataset(self.finalize(num_rows), params=params)

    # ----------------------------------------------- drift / bin refresh

    def holdout_snapshot(self):
        """(X, y) of the most recent `holdout_rows` pushed rows (raw
        values, not bins) for the publish quality gate, or None when the
        tail ring is empty or any tail push lacked labels."""
        with self._lock:
            if not self._tail:
                return None
            if any(lbl is None for _, lbl in self._tail):
                return None
            X = np.concatenate([b for b, _ in self._tail], axis=0)
            y = np.concatenate([lbl for _, lbl in self._tail])
            if X.shape[0] > self.holdout_rows:
                X = X[-self.holdout_rows:]
                y = y[-self.holdout_rows:]
            return X, y

    def maybe_refresh_bins(self, force: bool = False) -> bool:
        """Refit the bin-mapper cut points from the drift sketches and
        remap every binned slab through old-bin -> new-bin LUTs, as one
        measured event. Runs when the drift monitor has latched an alarm
        (or unconditionally under `force`); returns True when a refresh
        happened.

        The EFB group composition is pinned (binned history cannot be
        re-checked for conflicts), so only cut points move: every group
        plane is rewritten via its LUT, the monitor re-anchors its
        occupancy baseline on the new mappers, and `layout_generation`
        bumps — the value checkpoint sidecars carry so a resumed refit can
        verify it replays against the mapper generation it trained under.
        Published models never notice: tree thresholds are real-valued at
        the model surface (BinMapper.bin_to_value), not bin indices.
        """
        with self._lock:
            mon = self._drift
            if mon is None or self._layout is None \
                    or self._group_lists is None:
                return False
            if not force and not mon.alarmed:
                return False
            with global_timer.scope("stream_bin_refresh"):
                old = self._layout
                new = CoreDataset(self.config)
                new.num_total_features = old.num_total_features
                new.monotone_constraints = list(old.monotone_constraints)
                new.used_features = list(old.used_features)
                refreshed = 0
                new.mappers = []
                for j, mapper in enumerate(old.mappers):
                    nm = mon.refit_mapper(j, mapper)
                    if nm is None:
                        new.mappers.append(mapper)
                    else:
                        new.mappers.append(nm)
                        refreshed += 1
                if refreshed == 0:
                    return False
                new._make_groups(self._group_lists)
                dtype = new.bins_dtype()
                luts = [drift.group_bin_lut(og, ng).astype(dtype)
                        for og, ng in zip(old.groups, new.groups)]
                remapped = []
                for blk in self._bin_blocks:
                    out = np.empty(blk.shape, dtype=dtype)
                    for gi, lut in enumerate(luts):
                        out[gi] = lut[blk[gi]]
                    remapped.append(out)
                self._bin_blocks = remapped
                self._layout = new
                self.layout_generation += 1
                mon.after_refresh(new)
            global_timer.add_count("bin_refresh_total", 1)
            global_timer.set_count("stream_bin_generation",
                                   self.layout_generation)
            Log.info("streaming: bin refresh %d refitted %d/%d mappers "
                     "from drift sketches", self.layout_generation,
                     refreshed, len(new.mappers))
            tracing.note("bin_refresh", generation=self.layout_generation,
                         refreshed=refreshed)
            if telemetry.enabled():
                telemetry.emit("bin_refresh",
                               generation=self.layout_generation,
                               refreshed=refreshed)
            return True


def wrap_dataset(core: CoreDataset, params: Optional[dict] = None):
    """Wrap a core Dataset in the lazy basic.Dataset façade (its _handle set
    by hand, so construct() returns at once). _raw stays None: a streamed
    dataset keeps no raw matrix, so refit() and linear_tree, which need the
    raw values, are out of scope for streaming, as in the JAX package."""
    from .. import basic

    wrapper = basic.Dataset(None, params=dict(params) if params else None,
                            free_raw_data=True)
    wrapper._handle = core
    wrapper._raw = None
    return wrapper
