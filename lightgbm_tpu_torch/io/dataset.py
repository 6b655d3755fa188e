"""Binned training dataset: host construction of the bin plane.

Counterpart of the reference Dataset/FeatureGroup/DatasetLoader
(include/LightGBM/dataset.h:487-1070, src/io/dataset.cpp,
src/io/dataset_loader.cpp), with the JAX package's layout
(``lightgbm_tpu/io/dataset.py``):

  * ONE dense packed matrix ``bins[num_groups, N]`` (uint8/uint16), which
    the tree learner uploads to the device once at its native width; the
    histogram kernel reads it there.
  * Feature bundling (EFB, dataset.cpp:111-366) packs mutually-exclusive
    sparse features into one column; bundled features omit their default
    bin (reconstructed from leaf totals at split time, as the reference's
    FixHistogram does, dataset.h:770). A dense dataset makes one group per
    feature.
  * Bin mapping runs on host over a sample (DatasetLoader::
    ConstructFromSampleData, dataset_loader.cpp:600), then the whole matrix
    is binned column by column.

Construction is from a numpy matrix or a scipy sparse matrix (kept CSC and
densified one column at a time), or from a ``save_binary`` cache
(``load_binary``).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .binning import BIN_TYPE_CATEGORICAL, BIN_TYPE_NUMERICAL, BinMapper
from .metadata import Metadata
from ..config import Config
from ..utils.log import Log


class FeatureGroup:
    """One packed bin column — a single feature or an EFB bundle.

    Mirrors include/LightGBM/feature_group.h:26: per-member bin offsets within
    the group's bin range. For bundles (is_multi), each member's default bin is
    omitted; group bin 0 means "all members at default".
    """

    def __init__(self, feature_indices: List[int], mappers: List[BinMapper],
                 is_multi: bool) -> None:
        self.feature_indices = feature_indices
        self.mappers = mappers
        self.is_multi = is_multi
        if not is_multi:
            self.num_total_bin = mappers[0].num_bin
            self.bin_offsets = [0]
        else:
            # bundle: slot 0 = all-default; member j owns
            # [offset_j, offset_j + num_bin_j - 1) (its default bin removed)
            self.num_total_bin = 1
            self.bin_offsets = []
            for m in mappers:
                self.bin_offsets.append(self.num_total_bin)
                self.num_total_bin += m.num_bin - 1

    def bin_for_feature(self, member_idx: int, raw_bins: np.ndarray) -> np.ndarray:
        """Group-space bins for one member's per-feature bins."""
        if not self.is_multi:
            return raw_bins
        m = self.mappers[member_idx]
        off = self.bin_offsets[member_idx]
        out = np.zeros_like(raw_bins)
        nondef = raw_bins != m.default_bin
        # bins above the default shift down one slot (default removed)
        shifted = raw_bins - (raw_bins > m.default_bin).astype(raw_bins.dtype)
        out[nondef] = off + shifted[nondef]
        return out

    def feature_bin_range(self, member_idx: int) -> Tuple[int, int, int]:
        """(group_bin_lo, group_bin_hi, default_bin) for split translation."""
        if not self.is_multi:
            return 0, self.num_total_bin, -1
        m = self.mappers[member_idx]
        off = self.bin_offsets[member_idx]
        return off, off + m.num_bin - 1, m.default_bin


def _is_sparse(data) -> bool:
    """scipy.sparse duck-check (no hard scipy dependency)."""
    return hasattr(data, "tocsc") and hasattr(data, "nnz")


def _column(data, j: int) -> np.ndarray:
    """Dense f64 view of column j for ndarray or CSC input (slice syntax,
    which both spmatrix and the sparse-array classes take)."""
    if _is_sparse(data):
        return data[:, [j]].toarray().ravel().astype(np.float64)
    return data[:, j]


def find_feature_groups(mappers: List[BinMapper], sample_nonzero: List[np.ndarray],
                        sample_total: int, used_features: List[int],
                        max_conflict_rate: float, enable_bundle: bool,
                        max_bin_per_group: int = 256) -> List[List[int]]:
    """Exclusive Feature Bundling — greedy conflict-bounded grouping.

    Behavioral counterpart of GetConflictCount/FindGroups (dataset.cpp:64-249):
    features are visited in descending non-zero count; each joins the first
    existing bundle whose accumulated conflicts stay under
    max_conflict_rate * sample_total, else starts a new bundle. Conflicts are
    computed on boolean non-default masks over the binning sample.
    """
    if not enable_bundle or len(used_features) <= 1:
        return [[f] for f in used_features]
    dense: List[int] = []
    sparse_feats: List[int] = []
    for f in used_features:
        # bundling only pays for sparse features; dense ones keep own groups
        if mappers[f].sparse_rate >= 0.8 and mappers[f].bin_type == BIN_TYPE_NUMERICAL:
            sparse_feats.append(f)
        else:
            dense.append(f)
    if len(sparse_feats) <= 1:
        return [[f] for f in used_features]
    order = sorted(sparse_feats, key=lambda f: -len(sample_nonzero[f]))
    max_conflicts = int(max_conflict_rate * sample_total)
    groups: List[List[int]] = []
    group_masks: List[np.ndarray] = []
    group_conflicts: List[int] = []
    group_bins: List[int] = []
    for f in order:
        mask = sample_nonzero[f]
        placed = False
        for gi in range(len(groups)):
            if group_bins[gi] + mappers[f].num_bin - 1 > max_bin_per_group:
                continue
            conflict = int(np.count_nonzero(group_masks[gi] & mask))
            if group_conflicts[gi] + conflict <= max_conflicts:
                groups[gi].append(f)
                group_masks[gi] |= mask
                group_conflicts[gi] += conflict
                group_bins[gi] += mappers[f].num_bin - 1
                placed = True
                break
        if not placed:
            groups.append([f])
            group_masks.append(mask.copy())
            group_conflicts.append(0)
            group_bins.append(1 + mappers[f].num_bin - 1)
    out = [[f] for f in dense]
    out.extend(g for g in groups)
    # keep original feature order inside each bundle for determinism
    for g in out:
        g.sort()
    return out


class Dataset:
    """Binned dataset (internal core — the Python-facing wrapper with lazy
    construction lives in basic.py).

    Public state after construction:
      bins          : np.ndarray [num_groups, num_data] uint8/uint16
      groups        : List[FeatureGroup]
      feature_to_group : feature idx -> (group idx, member idx)
      mappers       : per-original-feature BinMapper
      metadata      : Metadata
    """

    def __init__(self, config: Optional[Config] = None) -> None:
        self.config = config or Config()
        self.num_data = 0
        self.num_total_features = 0
        self.mappers: List[BinMapper] = []
        self.groups: List[FeatureGroup] = []
        self.feature_to_group: Dict[int, Tuple[int, int]] = {}
        self.used_features: List[int] = []
        self.bins: Optional[np.ndarray] = None
        self.metadata = Metadata()
        self.feature_names: List[str] = []
        self.monotone_constraints: List[int] = []
        self._reference: Optional["Dataset"] = None
        self.loaded_raw: Optional[np.ndarray] = None  # a binary cache's raw rows

    # ------------------------------------------------------------ construction

    @classmethod
    def from_matrix(cls, data: np.ndarray, label=None, weight=None, group=None,
                    init_score=None, position=None,
                    config: Optional[Config] = None,
                    categorical_feature: Sequence[int] = (),
                    feature_names: Optional[Sequence[str]] = None,
                    reference: Optional["Dataset"] = None) -> "Dataset":
        config = config or Config()
        self = cls(config)
        if _is_sparse(data):
            # keep the matrix CSC and densify ONE COLUMN at a time
            data = data.tocsc()
            if data.dtype not in (np.float32, np.float64):
                data = data.astype(np.float64)
        else:
            data = np.asarray(data)
            if data.dtype not in (np.float32, np.float64):
                data = data.astype(np.float64)
        n, f = data.shape
        self.num_data = n
        self.num_total_features = f
        self.metadata = Metadata(n)
        if label is not None:
            self.metadata.set_label(label)
        if weight is not None:
            self.metadata.set_weights(weight)
        if group is not None:
            self.metadata.set_query(group)
        if init_score is not None:
            self.metadata.set_init_score(init_score)
        if position is not None:
            self.metadata.set_positions(position)
        self.feature_names = (list(feature_names) if feature_names
                              else [f"Column_{i}" for i in range(f)])

        if reference is not None:
            # validation set: share the training BinMappers and group layout
            # (DatasetLoader::LoadFromFileAlignWithOtherDataset semantics)
            self._align_with(reference, data)
            return self

        group_lists = self._fit_layout(data, categorical_feature)
        self._build_groups_and_bins(group_lists, data)
        return self

    def _fit_layout(self, data, categorical_feature: Sequence[int] = ()
                    ) -> List[List[int]]:
        """Fit the bin layout (per-feature BinMappers, used features, EFB
        group lists) from `data` without binning any rows."""
        config = self.config
        n, f = data.shape
        self.num_total_features = f
        rng = np.random.RandomState(config.data_random_seed)
        sample_cnt = min(config.bin_construct_sample_cnt, n)
        cat_set = set(int(c) for c in categorical_feature)

        if config.max_bin_by_feature:
            # reference hard-checks these (dataset.cpp:416-420)
            if len(config.max_bin_by_feature) != f:
                Log.fatal("Size of max_bin_by_feature should be equal to max_feature_idx + 1")
            if min(config.max_bin_by_feature) <= 1:
                Log.fatal("max_bin_by_feature should be greater than 1")

        self.mappers = []
        sample_nonzero_masks: List[np.ndarray] = []
        sample_idx = (rng.choice(n, sample_cnt, replace=False)
                      if n > sample_cnt else np.arange(n))
        # forcedbins_filename (DatasetLoader::GetForcedBins,
        # src/io/dataset_loader.cpp): JSON [{"feature", "bin_upper_bound"}]
        forced_by_feature: Dict[int, List[float]] = {}
        if config.forcedbins_filename:
            import json as _json

            try:
                with open(config.forcedbins_filename) as fh:
                    for entry in _json.load(fh):
                        forced_by_feature[int(entry["feature"])] = [
                            float(v) for v in entry["bin_upper_bound"]]
            except OSError:
                Log.warning("Could not open %s", config.forcedbins_filename)
        for j in range(f):
            col = _column(data, j)[sample_idx]
            nonzero = col[(col != 0) | np.isnan(col)]
            mapper = BinMapper()
            bt = BIN_TYPE_CATEGORICAL if j in cat_set else BIN_TYPE_NUMERICAL
            mb = config.max_bin
            if config.max_bin_by_feature and j < len(config.max_bin_by_feature):
                mb = config.max_bin_by_feature[j]
            mapper.find_bin(nonzero, len(col), mb,
                            min_data_in_bin=config.min_data_in_bin,
                            min_split_data=config.min_data_in_leaf,
                            pre_filter=config.feature_pre_filter,
                            bin_type=bt,
                            use_missing=config.use_missing,
                            zero_as_missing=config.zero_as_missing,
                            forced_upper_bounds=forced_by_feature.get(j, ()))
            self.mappers.append(mapper)
            sample_nonzero_masks.append((col != 0) & ~np.isnan(col))

        self.used_features = [j for j in range(f) if not self.mappers[j].is_trivial]
        if not self.used_features:
            Log.warning("There are no meaningful features which satisfy "
                        "the provided configuration. Decreasing Dataset parameters "
                        "min_data_in_bin or min_data_in_leaf and re-constructing "
                        "Dataset might resolve this warning.")

        # the parameter universe has no max_conflict_rate: bundles must be
        # conflict-free, as in the JAX package
        return find_feature_groups(
            self.mappers, sample_nonzero_masks, len(sample_idx),
            self.used_features, 0.0,
            enable_bundle=self.config.enable_bundle)

    def _build_groups_and_bins(self, group_lists: List[List[int]], data) -> None:
        self._make_groups(group_lists)
        self.bins = self._bin_rows(data)

    def _make_groups(self, group_lists: List[List[int]]) -> None:
        """Materialize FeatureGroups + the feature->(group, member) map from
        fitted mappers; row-count independent (no bins touched)."""
        self.groups = []
        self.feature_to_group = {}
        for gi, feats in enumerate(group_lists):
            fg = FeatureGroup(feats, [self.mappers[j] for j in feats],
                              is_multi=len(feats) > 1)
            self.groups.append(fg)
            for mi, j in enumerate(feats):
                self.feature_to_group[j] = (gi, mi)

    def bins_dtype(self) -> np.dtype:
        max_bins = max((g.num_total_bin for g in self.groups), default=1)
        return np.dtype(np.uint8 if max_bins <= 256 else np.uint16)

    def _bin_rows(self, data) -> np.ndarray:
        """Bin a row matrix against the fitted layout into a
        [num_groups, n_rows] plane."""
        n_rows = data.shape[0]
        dtype = self.bins_dtype()
        bins = np.zeros((len(self.groups), n_rows), dtype=dtype)
        for gi, fg in enumerate(self.groups):
            if not fg.is_multi:
                j = fg.feature_indices[0]
                bins[gi] = self.mappers[j].values_to_bins(
                    _column(data, j)).astype(dtype)
            else:
                acc = np.zeros(n_rows, dtype=np.int32)
                for mi, j in enumerate(fg.feature_indices):
                    raw = self.mappers[j].values_to_bins(_column(data, j))
                    gb = fg.bin_for_feature(mi, raw)
                    # exclusivity: at most one member non-default per row;
                    # on conflict the later feature wins (matches bundle
                    # push order semantics)
                    acc = np.where(gb != 0, gb, acc)
                bins[gi] = acc.astype(dtype)
        return bins

    @classmethod
    def from_layout(cls, layout: "Dataset", bins: np.ndarray, num_data: int,
                    label=None, weight=None, group=None, init_score=None,
                    position=None,
                    feature_names: Optional[Sequence[str]] = None) -> "Dataset":
        """A Dataset from a fitted layout and a plane binned against it
        (streaming ingest: `streaming/ingest.py:RowBlockStore.finalize`; the
        JAX package's io/dataset.py:365-397). The layout's mappers and
        groups are shared, not copied."""
        self = cls(layout.config)
        self.num_data = int(num_data)
        self.num_total_features = layout.num_total_features
        self.mappers = layout.mappers
        self.groups = layout.groups
        self.feature_to_group = layout.feature_to_group
        self.used_features = layout.used_features
        self.monotone_constraints = list(layout.monotone_constraints)
        self.bins = bins
        self.metadata = Metadata(self.num_data)
        if label is not None:
            self.metadata.set_label(label)
        if weight is not None:
            self.metadata.set_weights(weight)
        if group is not None:
            self.metadata.set_query(group)
        if init_score is not None:
            self.metadata.set_init_score(init_score)
        if position is not None:
            self.metadata.set_positions(position)
        self.feature_names = (list(feature_names) if feature_names
                              else [f"Column_{i}" for i in range(self.num_total_features)])
        return self

    @classmethod
    def load_binary(cls, path: str, config: Optional[Config] = None) -> "Dataset":
        """Rebuild a constructed Dataset from a save_binary npz cache (the
        JAX package's io/dataset.py:398, DatasetLoader::LoadFromBinFile):
        bins, mappers, groups and metadata restore directly, with no parse
        and no bin finding. The cached raw rows, if any, are `loaded_raw`.
        The query weights are derived from the weights and boundaries, as
        Metadata.set_query derives them."""
        import json

        z = np.load(path, allow_pickle=False)
        self = cls(config)
        self.bins = z["bins"]
        self.num_data = int(self.bins.shape[1])
        self.num_total_features = int(z["num_total_features"])
        self.mappers = [BinMapper.from_dict(d) for d in json.loads(str(z["mappers"]))]
        self.feature_names = json.loads(str(z["feature_names"]))
        self.used_features = json.loads(str(z["used_features"]))
        self.monotone_constraints = json.loads(str(z["monotone"]))
        group_lists = json.loads(str(z["group_lists"]))
        group_multi = json.loads(str(z["group_is_multi"]))
        for gi, (feats, multi) in enumerate(zip(group_lists, group_multi)):
            self.groups.append(FeatureGroup(feats, [self.mappers[f] for f in feats], multi))
            for mi, f in enumerate(feats):
                self.feature_to_group[f] = (gi, mi)
        md = self.metadata = Metadata(self.num_data)
        if z["label"].size:
            md.set_label(z["label"])
        if z["weight"].size:
            md.set_weights(z["weight"])
        if z["init_score"].size:
            md.set_init_score(z["init_score"])
        if z["query_boundaries"].size:
            md.query_boundaries = np.asarray(z["query_boundaries"], dtype=np.int32)
            md._update_query_weights()
        if z["positions"].size:
            md.positions = np.asarray(z["positions"], np.int32)
            md.position_ids = z["position_ids"]
        raw = z["raw"]
        self.loaded_raw = raw if raw.size else None
        return self

    def _align_with(self, reference: "Dataset", data) -> None:
        self._reference = reference
        self.mappers = reference.mappers
        self.used_features = reference.used_features
        self.monotone_constraints = reference.monotone_constraints
        group_lists = [g.feature_indices for g in reference.groups]
        self._build_groups_and_bins(group_lists, data)

    # ---------------------------------------------------------------- queries

    @property
    def num_features(self) -> int:
        return len(self.used_features)

    @property
    def num_groups(self) -> int:
        return len(self.groups)

    def group_bin_counts(self) -> np.ndarray:
        return np.array([g.num_total_bin for g in self.groups], dtype=np.int32)

    def feature_num_bin(self, feature: int) -> int:
        """The bins of used feature `feature`'s mapper."""
        return self.mappers[feature].num_bin

    def feature_infos(self) -> List[str]:
        return [m.bin_info_string() for m in self.mappers]

    def real_threshold(self, feature: int, bin_threshold: int) -> float:
        """Bin-space threshold -> raw-value threshold for the model tree."""
        return self.mappers[feature].bin_to_value(bin_threshold)

    def subset(self, indices: np.ndarray) -> "Dataset":
        """The rows `indices` (cv's folds): the same bin mappers and feature
        groups, the binned rows and the metadata of those rows."""
        out = Dataset(self.config)
        out.num_data = len(indices)
        out.num_total_features = self.num_total_features
        out.mappers = self.mappers
        out.groups = self.groups
        out.feature_to_group = self.feature_to_group
        out.used_features = self.used_features
        out.bins = np.ascontiguousarray(self.bins[:, indices])
        out.metadata = self.metadata.subset(indices)
        out.feature_names = self.feature_names
        out.monotone_constraints = self.monotone_constraints
        return out

    def construct_histogram_np(self, group: int, grad: np.ndarray, hess: np.ndarray,
                               row_indices: Optional[np.ndarray] = None) -> np.ndarray:
        """Numpy histogram [num_total_bin, 3] float64 (grad, hess, count) of
        one group over every row or the rows `row_indices`: a host oracle
        for the histogram kernels."""
        fg = self.groups[group]
        bins = self.bins[group]
        if row_indices is not None:
            bins = bins[row_indices]
            grad = grad[row_indices]
            hess = hess[row_indices]
        hist = np.zeros((fg.num_total_bin, 3), dtype=np.float64)
        np.add.at(hist[:, 0], bins, grad)
        np.add.at(hist[:, 1], bins, hess)
        np.add.at(hist[:, 2], bins, 1.0)
        return hist
