"""lightgbm-compatible Dataset and Booster.

Counterpart of the JAX package's ``basic.py`` (python-package/lightgbm/
basic.py Dataset :1773, Booster :3581): lazy Dataset construction with
reference alignment for validation data, and the Booster that trains
(``Booster(params, train_set)``, ``update``, ``add_valid``, ``eval_*``) or
loads a model from a file or string, predicts and saves, dumps the model as
JSON, reports feature importances and the score bounds, takes new
parameters between iterations (``reset_parameter``), fits its leaf values
again on new data (``refit``) and takes its last iteration back
(``rollback_one_iter``). A Dataset gives row subsets (``subset``, as
``cv``'s folds take them). A pandas DataFrame's
``category`` columns train as categorical features and map through the
training categories at predict time (``pandas_categorical``).

A ranking Dataset carries its query groups (``group``, ``set_group``) and,
for position-debiased lambdarank, each row's position (``position``,
``set_position``). ``predict`` takes prediction early stopping
(``pred_early_stop``, ``pred_early_stop_freq``, ``pred_early_stop_margin``).

A Dataset reads a text file (CSV, TSV or LibSVM, with its ``.weight``,
``.query`` and ``.position`` side files) or a ``save_binary`` cache from a
path. ``predict(pred_contrib=True)`` gives SHAP contributions (host
TreeSHAP, ``shap.py``). A feval is evaluated on the training set and on
every validation set (``eval_train``, ``eval_valid``).

The Booster runs on the CUDA card unless ``params={"device_type": "cpu"}``
asks for the CPU; with no card and no such request it raises. Not ported
yet, and refused loudly: row-sharded predict.
"""
from __future__ import annotations

import copy
import json
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np

from .config import Config, param_bool, parse_objective_alias, resolve_device
from .checkpoint import atomic_open
from .io.dataset import Dataset as _CoreDataset
from .io.parser import load_positions, load_query_boundaries, load_weights, parse_file
from .models.gbdt import GBDT, create_boosting
from .models.serialize import GBDTModel
from .objectives import create_objective
from .utils.log import LightGBMError, Log

_NUMERIC_TYPES = (int, float, bool)


def _is_dataframe(data) -> bool:
    return hasattr(data, "dtypes") and hasattr(data, "columns")


def _is_sparse(data) -> bool:
    return hasattr(data, "tocsc") and hasattr(data, "nnz")


def _pandas_to_matrix(df, pandas_categorical=None):
    """DataFrame -> (float64 matrix, categorical column indices, per-column
    category lists), the JAX package's and the python-package's
    _data_from_pandas: `category` columns become their integer codes (NaN
    for a missing or unseen category); with `pandas_categorical` (predict
    time, or a validation set) the values map through the training
    categories."""
    import pandas as pd

    cat_cols = [i for i, dt in enumerate(df.dtypes) if str(dt) == "category"]
    bad = [str(df.columns[i]) for i, dt in enumerate(df.dtypes)
           if i not in cat_cols and not (pd.api.types.is_numeric_dtype(dt)
                                         or pd.api.types.is_bool_dtype(dt))]
    if bad:
        raise ValueError("DataFrame.dtypes for data must be int, float or bool. Did not "
                         "expect the data types in the following fields: " + ", ".join(bad))
    if pandas_categorical is not None and len(cat_cols) != len(pandas_categorical):
        raise ValueError("train and valid dataset categorical_feature do not match")
    if not cat_cols:
        return df.to_numpy(dtype=np.float64, na_value=np.nan), [], None
    df = df.copy(deep=False)
    cats_out = []
    for k, i in enumerate(cat_cols):
        col = df.iloc[:, i]
        if pandas_categorical is not None:
            cats = list(pandas_categorical[k])
            col = col.cat.set_categories(cats)
        else:
            cats = list(col.cat.categories)
        cats_out.append(cats)
        codes = col.cat.codes.to_numpy(dtype=np.float64, copy=True)
        codes[codes < 0] = np.nan  # missing or unseen categories
        df.isetitem(i, codes)
    return df.to_numpy(dtype=np.float64, na_value=np.nan), cat_cols, cats_out


def _to_2d_float(data) -> np.ndarray:
    if hasattr(data, "toarray"):  # scipy sparse
        data = data.toarray()
    elif _is_dataframe(data):
        data = _pandas_to_matrix(data)[0]
    elif hasattr(data, "values") and not isinstance(data, np.ndarray):
        data = data.values
    arr = np.asarray(data, dtype=np.float64)
    if arr.ndim == 1:
        arr = arr.reshape(1, -1)
    return arr


class Dataset:
    """Lazy-constructed training dataset (basic.py:1773)."""

    def __init__(self, data, label=None, reference: Optional["Dataset"] = None,
                 weight=None, group=None, init_score=None,
                 feature_name: Union[str, List[str]] = "auto",
                 categorical_feature: Union[str, List] = "auto",
                 params: Optional[Dict[str, Any]] = None,
                 free_raw_data: bool = True, position=None) -> None:
        self.data = data
        self.label = label
        self.reference = reference
        self.weight = weight
        self.group = group
        self.init_score = init_score
        self.position = position
        self.feature_name = feature_name
        self.categorical_feature = categorical_feature
        self.params = copy.deepcopy(params) if params else {}
        self.free_raw_data = free_raw_data
        self._handle: Optional[_CoreDataset] = None
        self._raw: Optional[np.ndarray] = None
        self._sparse_raw = None
        self.pandas_categorical = None

    # ------------------------------------------------------------ construction

    def construct(self) -> "Dataset":
        if self._handle is not None:
            return self
        params = dict(self.params)
        config = Config(params)
        data = self.data
        label = self.label
        feature_names: Optional[List[str]] = None
        if isinstance(data, (str, Path)) and _is_binary_cache(str(data)):
            self._handle = _CoreDataset.load_binary(str(data), config)
            self._raw = self._handle.loaded_raw
            # constructor arguments override the cached metadata, as the
            # python package's set_* after a binary load
            md = self._handle.metadata
            if self.label is not None:
                md.set_label(np.asarray(self.label))
            if self.weight is not None:
                md.set_weights(self.weight)
            if self.group is not None:
                md.set_query(self.group)
            if self.init_score is not None:
                md.set_init_score(self.init_score)
            if self.position is not None:
                md.set_positions(self.position)
            return self
        if isinstance(data, (str, Path)):
            X, y, feature_names = parse_file(str(data), header=config.header,
                                             label_column=config.label_column or "0")
            if label is None:
                label = y
            # the side files fill what the caller did not give
            for attr, load in (("weight", load_weights), ("group", load_query_boundaries),
                               ("position", load_positions)):
                side = load(str(data))
                if side is not None and getattr(self, attr) is None:
                    setattr(self, attr, side)
        elif _is_dataframe(data):
            # a validation frame encodes through the training set's
            # category lists, not its own
            ref_pc = None
            if self.reference is not None:
                self.reference.construct()
                ref_pc = self.reference.pandas_categorical
            X, pd_cat_cols, pd_cats = _pandas_to_matrix(data, ref_pc)
            self.pandas_categorical = ref_pc if ref_pc is not None else pd_cats
            if self.feature_name == "auto":
                feature_names = [str(c) for c in data.columns]
            if pd_cat_cols and self.categorical_feature == "auto":
                self.categorical_feature = pd_cat_cols
        elif _is_sparse(data):
            # scipy sparse: binned column by column, never densified whole
            X = data
            if config.linear_tree:
                Log.fatal("linear_tree requires dense input "
                          "(raw feature values per leaf)")
        else:
            X = _to_2d_float(data)
        if isinstance(self.feature_name, (list, tuple)):
            feature_names = list(self.feature_name)

        cats: List[int] = []
        if isinstance(self.categorical_feature, (list, tuple)):
            for c in self.categorical_feature:
                if isinstance(c, str) and feature_names and c in feature_names:
                    cats.append(feature_names.index(c))
                elif isinstance(c, _NUMERIC_TYPES):
                    cats.append(int(c))
        raw = params.get("categorical_feature", params.get("categorical_column"))
        if isinstance(raw, str):
            for tok in raw.split(","):
                tok = tok.strip()
                if tok.startswith("name:") and feature_names:
                    cats += [feature_names.index(nm) for nm in tok[5:].split(",")
                             if nm in feature_names]
                elif tok:
                    cats.append(int(tok))

        ref_handle = None
        if self.reference is not None:
            self.reference.construct()
            ref_handle = self.reference._handle
        self._handle = _CoreDataset.from_matrix(
            X, label=label, weight=self.weight, group=self.group,
            init_score=self.init_score, position=self.position, config=config,
            categorical_feature=cats, feature_names=feature_names,
            reference=ref_handle)
        if config.monotone_constraints:
            self._handle.monotone_constraints = list(config.monotone_constraints)
        self._raw = None if _is_sparse(X) else np.asarray(X, dtype=np.float32)
        self._sparse_raw = X if _is_sparse(X) else None
        if self.free_raw_data:
            self.data = None
        return self

    # ---------------------------------------------------------------- helpers

    def create_valid(self, data, label=None, weight=None, group=None,
                     init_score=None, params=None, position=None) -> "Dataset":
        return Dataset(data, label=label, reference=self, weight=weight,
                       group=group, init_score=init_score,
                       params=params or self.params, position=position)

    def subset(self, used_indices: Sequence[int], params=None) -> "Dataset":
        """The rows `used_indices` as a constructed Dataset that shares this
        one's bin mappers and feature groups (the JAX package's basic.py:
        257-268): the binned rows, the metadata and the raw rows, dense or
        CSR."""
        self.construct()
        idx = np.asarray(used_indices)
        sub = Dataset(None, params=params or self.params, free_raw_data=self.free_raw_data)
        sub._handle = self._handle.subset(idx)
        sub._raw = self._raw[idx] if self._raw is not None else None
        if self._raw is None and self._sparse_raw is not None:
            sub._sparse_raw = self._sparse_raw.tocsr()[idx]
        sub.pandas_categorical = self.pandas_categorical
        sub.reference = self
        return sub

    def set_label(self, label) -> "Dataset":
        self.label = label
        if self._handle is not None and label is not None:
            self._handle.metadata.set_label(label)
        return self

    def set_weight(self, weight) -> "Dataset":
        self.weight = weight
        if self._handle is not None:
            self._handle.metadata.set_weights(weight)
        return self

    def set_group(self, group) -> "Dataset":
        """Query sizes, in row order (the sum is the row count)."""
        self.group = group
        if self._handle is not None and group is not None:
            self._handle.metadata.set_query(group)
        return self

    def set_init_score(self, init_score) -> "Dataset":
        self.init_score = init_score
        if self._handle is not None:
            self._handle.metadata.set_init_score(init_score)
        return self

    def set_position(self, position) -> "Dataset":
        """Each row's position id, for position-debiased lambdarank."""
        self.position = position
        if self._handle is not None:
            self._handle.metadata.set_positions(position)
        return self

    def get_label(self):
        if self._handle is not None and self._handle.metadata.label is not None:
            return self._handle.metadata.label
        return self.label

    def get_weight(self):
        return self.weight

    def get_group(self):
        return self.group

    def get_position(self):
        return self.position

    def get_init_score(self):
        return self.init_score

    def get_data(self):
        return self.data if self.data is not None else self._raw

    def get_feature_name(self) -> List[str]:
        self.construct()
        return list(self._handle.feature_names)

    def num_data(self) -> int:
        self.construct()
        return self._handle.num_data

    def num_feature(self) -> int:
        self.construct()
        return self._handle.num_total_features

    def save_binary(self, filename: str) -> "Dataset":
        """The binary dataset cache (the JAX package's basic.py:328-365,
        Dataset::SaveBinaryFile): an npz of the bins, the bin mappers, the
        feature groups, the metadata and the raw rows; `Dataset(filename)`
        loads it back with no parse and no bin finding. Either package
        reads the other's."""
        self.construct()
        h = self._handle
        md = h.metadata

        def kept(a):
            return a if a is not None else []

        with atomic_open(filename, "wb") as fh:  # a file object: numpy must
            np.savez_compressed(  # not append .npz to the name
                fh, bins=h.bins, label=kept(md.label), weight=kept(md.weights),
                init_score=kept(md.init_score), query_boundaries=kept(md.query_boundaries),
                positions=kept(md.positions), position_ids=kept(md.position_ids),
                mappers=json.dumps([m.to_dict() for m in h.mappers]),
                feature_names=json.dumps(h.feature_names),
                group_lists=json.dumps([g.feature_indices for g in h.groups]),
                group_is_multi=json.dumps([g.is_multi for g in h.groups]),
                used_features=json.dumps(h.used_features),
                num_total_features=h.num_total_features,
                monotone=json.dumps(h.monotone_constraints), raw=kept(self._raw))
        if self._raw is None and self._sparse_raw is not None:
            Log.warning("save_binary: raw feature values of a sparse-built "
                        "Dataset are not cached; the reloaded Dataset can "
                        "train but cannot serve as a validation set")
        return self


def _is_binary_cache(path: str) -> bool:
    """A save_binary cache is an npz (zip) file: check the PK magic."""
    try:
        with open(path, "rb") as fh:
            return fh.read(2) == b"PK"
    except OSError:
        return False


def _fevals(feval) -> list:
    if feval is None:
        return []
    return list(feval) if isinstance(feval, (list, tuple)) else [feval]


def _feval_results(fe, preds, data, data_name: str) -> list:
    """A feval's answer, `(name, value, is_higher_better)` or a list of
    them, as (data_name, name, value, is_higher_better) tuples."""
    res = fe(preds, data)
    items = res if isinstance(res, list) else [res]
    return [(data_name, name, val, bigger) for name, val, bigger in items]


def _score_for_callables(score) -> np.ndarray:
    """A [C, N] score as a feval or fobj sees it: [N], or [N, C]."""
    score = score.cpu().numpy()
    return score.ravel() if score.shape[0] == 1 else score.T


class Booster:
    """Training and prediction handle (basic.py:3581)."""

    def __init__(self, params: Optional[Dict[str, Any]] = None,
                 train_set: Optional[Dataset] = None,
                 model_file: Optional[str] = None,
                 model_str: Optional[str] = None) -> None:
        self.params = dict(params) if params else {}
        self.best_iteration = -1
        self.best_score: Dict[str, Dict[str, float]] = {}
        self._train_data_name = "training"
        self.name_valid_sets: List[str] = []
        self.valid_sets: List[Dataset] = []
        self._model: Optional[GBDTModel] = None
        self.train_set: Optional[Dataset] = None
        self.pandas_categorical = None
        if train_set is not None:
            if not isinstance(train_set, Dataset):
                raise TypeError(f"Training data should be Dataset instance, "
                                f"met {type(train_set).__name__}")
            self.config = Config(self.params)
            self.device = resolve_device(self.config.device_type)
            train_set.params = {**train_set.params, **self.params}
            train_set.construct()
            objective = create_objective(self.config.objective, self.config)
            self._gbdt = create_boosting(self.config, train_set._handle, objective,
                                         self.device, train_raw=train_set._raw)
            self.train_set = train_set
            self.pandas_categorical = train_set.pandas_categorical
            return
        if model_file is None and model_str is None:
            raise TypeError("Need at least one training dataset or model file "
                            "or model string to create Booster instance")
        model = (GBDTModel.from_file(model_file) if model_file
                 else GBDTModel.from_string(model_str))
        self._model = model
        self.config = Config(self.params)
        self.device = resolve_device(self.config.device_type)
        self._gbdt = GBDT(self.config, None, None, self.device)
        self._gbdt.models = model.trees
        self._gbdt.num_class = model.num_class
        self._gbdt.num_tree_per_iteration = model.num_tree_per_iteration
        # GBDT::LoadModelFromString sets iter_ from the loaded tree count
        self._gbdt.iter_ = len(model.trees) // max(model.num_tree_per_iteration, 1)
        self._gbdt.objective = _objective_from_string(model.objective_str,
                                                      self.config)
        self._gbdt.average_output = model.average_output
        self.pandas_categorical = model.pandas_categorical

    # ------------------------------------------------------------------ train

    def add_valid(self, data: Dataset, name: str) -> "Booster":
        if not isinstance(data, Dataset):
            raise TypeError(f"Validation data should be Dataset instance, "
                            f"met {type(data).__name__}")
        data.construct()
        raw = data._raw
        if raw is None:  # a sparse valid set densifies (valid << train)
            raw = data._sparse_raw.astype(np.float32).toarray()
        self._gbdt.add_valid(data._handle, raw, name)
        self.name_valid_sets.append(name)
        self.valid_sets.append(data)
        return self

    def update(self, train_set: Optional[Dataset] = None, fobj=None) -> bool:
        """One boosting iteration; returns True if training finished
        (basic.py:4091 / LGBM_BoosterUpdateOneIter)."""
        if fobj is not None:
            if self._gbdt.objective is not None:
                raise LightGBMError("Cannot use fobj with a built-in objective; "
                                    "set objective='none'")
            # DART drops its trees before custom gradients read the score
            # (GetTrainingScore triggers DroppingTrees, dart.hpp:78-88)
            self._gbdt.prepare_training_score()
            grad, hess = fobj(self._score_for_callables(), self.train_set)
            return self._gbdt.train_one_iter(np.asarray(grad, dtype=np.float32),
                                             np.asarray(hess, dtype=np.float32))
        return self._gbdt.train_one_iter()

    def refit(self, data, label, decay_rate: float = 0.9, **kwargs: Any) -> "Booster":
        """A new Booster with this one's trees, their leaf values fitted
        again on `data` (python-package Booster.refit / LGBM_BoosterRefit):
        each row's leaf in every tree from the traversal's leaf mode, then
        GBDT.refit."""
        if hasattr(data, "toarray"):  # scipy sparse: refit needs raw values
            data = data.toarray()
        data = np.asarray(data, dtype=np.float64)
        pred_leaf = self.predict(data, pred_leaf=True)
        new_params = {**self.params, "refit_decay_rate": decay_rate}
        new_booster = Booster(new_params, Dataset(data, label=label, **kwargs))
        gbdt = new_booster._gbdt
        gbdt.models = GBDTModel.from_string(self.model_to_string()).trees
        gbdt._predictor.invalidate()
        gbdt.iter_ = len(gbdt.models) // gbdt.num_tree_per_iteration
        gbdt.refit(np.asarray(pred_leaf, dtype=np.int32).reshape(data.shape[0], -1))
        return new_booster

    def rollback_one_iter(self) -> "Booster":
        """Take the last iteration's trees back out of the model and the
        scores (LGBM_BoosterRollbackOneIter)."""
        self._gbdt.rollback_one_iter()
        return self

    def _score_for_callables(self) -> np.ndarray:
        return _score_for_callables(self._gbdt.score)

    def current_iteration(self) -> int:
        return self._gbdt.iter_

    def num_trees(self) -> int:
        return len(self._gbdt.models)

    def num_model_per_iteration(self) -> int:
        return self._gbdt.num_tree_per_iteration

    def num_feature(self) -> int:
        if self.train_set is not None:
            return self.train_set.num_feature()
        return self._model.max_feature_idx + 1

    def feature_name(self) -> List[str]:
        if self.train_set is not None:
            return self.train_set.get_feature_name()
        return list(self._model.feature_names)

    # ------------------------------------------------------------------- eval

    def eval_train(self, feval=None) -> List:
        """The training metrics, then each feval on the training scores."""
        out = list(self._gbdt.eval_train())
        for fe in _fevals(feval):
            out += _feval_results(fe, self._score_for_callables(), self.train_set,
                                  self._train_data_name)
        return out

    def eval_valid(self, feval=None) -> List:
        """Each validation set's metrics followed by each feval on its
        scores (python-package Booster.eval_valid). A feval sees the raw
        scores, [N] or [N, C], as in eval_train, and the set's Dataset."""
        builtin = self._gbdt.eval_valid()
        fevals = _fevals(feval)
        if not fevals:
            return list(builtin)
        out = []
        for name, data, vd in zip(self.name_valid_sets, self.valid_sets,
                                  self._gbdt.valid_sets):
            out += [r for r in builtin if r[0] == name]
            preds = _score_for_callables(vd.score)
            for fe in fevals:
                out += _feval_results(fe, preds, data, name)
        return out

    # ---------------------------------------------------------------- predict

    def predict(self, data, start_iteration: int = 0,
                num_iteration: Optional[int] = None, raw_score: bool = False,
                pred_leaf: bool = False, pred_contrib: bool = False,
                validate_features: bool = False, **kwargs) -> np.ndarray:
        shard_kw = kwargs.get("pred_shard_rows", self.params.get("pred_shard_rows"))
        shard_rows = int(shard_kw) if shard_kw is not None else None
        if _is_dataframe(data) and self.pandas_categorical:
            data = _pandas_to_matrix(data, self.pandas_categorical)[0]
        if isinstance(data, np.ndarray) and data.dtype == np.float32 \
                and data.ndim == 2:
            X = data
        else:
            X = _to_2d_float(data)
        if validate_features:
            expected = self.num_feature()
            if expected > 0 and X.shape[1] != expected:
                raise LightGBMError(
                    f"The number of features in data ({X.shape[1]}) is not "
                    f"the same as it was in training data ({expected})")
        if num_iteration is None:
            # best-iteration truncation applies to whole-model predicts only;
            # an explicit start_iteration means "this slice onward"
            num_iteration = (self.best_iteration
                             if self.best_iteration > 0
                             and start_iteration <= 0 else 0)
        if pred_leaf:
            return self._gbdt.predict_leaf_index(X, num_iteration,
                                                 start_iteration)
        if pred_contrib:
            from .shap import predict_contrib

            self._gbdt._flush_pending()
            C = self._gbdt.num_tree_per_iteration
            trees = self._gbdt.models[max(start_iteration, 0) * C:]
            return predict_contrib(trees, X, C, num_iteration)
        if param_bool(kwargs.get("pred_early_stop", self.params.get("pred_early_stop"))):
            freq = kwargs.get("pred_early_stop_freq", self.params.get("pred_early_stop_freq", 10))
            margin = kwargs.get("pred_early_stop_margin",
                                self.params.get("pred_early_stop_margin", 10.0))
            return self._gbdt.predict(X, raw_score=raw_score, num_iteration=num_iteration,
                                      start_iteration=start_iteration,
                                      early_stop=(int(freq), float(margin)))
        chunk_kw = kwargs.get("pred_chunk_rows",
                              self.params.get("pred_chunk_rows"))
        chunk_rows = int(chunk_kw) if chunk_kw is not None else None
        return self._gbdt.predict(X, raw_score=raw_score,
                                  num_iteration=num_iteration,
                                  start_iteration=start_iteration,
                                  chunk_rows=chunk_rows, shard_rows=shard_rows)

    # --------------------------------------------------------------- model

    def _get_model(self) -> GBDTModel:
        if self.train_set is not None:
            model = self._gbdt.to_model()
            model.best_iteration = self.best_iteration
            model.pandas_categorical = self.pandas_categorical
            return model
        return self._model

    def save_model(self, filename: str, num_iteration: Optional[int] = None,
                   start_iteration: int = 0,
                   importance_type: str = "split") -> "Booster":
        if num_iteration is None:
            num_iteration = self.best_iteration if self.best_iteration > 0 else -1
        self._get_model().save_to_file(str(filename), start_iteration,
                                       num_iteration or -1, importance_type)
        return self

    def model_to_string(self, num_iteration: Optional[int] = None,
                        start_iteration: int = 0,
                        importance_type: str = "split") -> str:
        if num_iteration is None:
            num_iteration = self.best_iteration if self.best_iteration > 0 else -1
        return self._get_model().to_string(start_iteration, num_iteration or -1,
                                           importance_type)

    def dump_model(self, num_iteration: Optional[int] = None,
                   start_iteration: int = 0,
                   importance_type: str = "split") -> Dict:
        """The model as a JSON-ready dict (basic.py dump_model)."""
        if num_iteration is None:
            num_iteration = self.best_iteration if self.best_iteration > 0 else -1
        return json.loads(self._get_model().dump_json(start_iteration, num_iteration or -1,
                                                      importance_type))

    def feature_importance(self, importance_type: str = "split",
                           iteration: Optional[int] = None) -> np.ndarray:
        """Per feature: the count of splits (int64) or their total gain
        (float64), over positive-gain splits."""
        imp = self._get_model().feature_importance(importance_type, iteration or 0)
        return imp if importance_type == "gain" else imp.astype(np.int64)

    def lower_bound(self) -> float:
        """The sum over trees of each tree's least leaf value."""
        self._gbdt._flush_pending()
        vals = [t.leaf_value[: t.num_leaves].min() for t in self._gbdt.models]
        return float(np.sum(vals)) if vals else 0.0

    def upper_bound(self) -> float:
        """The sum over trees of each tree's largest leaf value."""
        self._gbdt._flush_pending()
        vals = [t.leaf_value[: t.num_leaves].max() for t in self._gbdt.models]
        return float(np.sum(vals)) if vals else 0.0

    def reset_parameter(self, params: Dict[str, Any]) -> "Booster":
        """Take new parameters for the iterations to come (basic.py
        reset_parameter): the shrinkage rate, and the learner's regularizers
        and tree size (GBDT.reset_config)."""
        self.params.update(params)
        self.config.set(params)
        if self.train_set is not None:
            self._gbdt.reset_config(self.config)
        return self


def _objective_from_string(objective_str: Optional[str], config: Config):
    """Rebuild an objective from a model file's `objective=` line
    (e.g. 'binary sigmoid:1', 'multiclass num_class:3')."""
    if not objective_str:
        return None
    parts = objective_str.split()
    name = parse_objective_alias(parts[0])
    for tok in parts[1:]:
        if ":" in tok:
            k, v = tok.split(":", 1)
            try:
                config.set({k: v})
            except (LightGBMError, ValueError):
                pass
    try:
        return create_objective(name, config)
    except LightGBMError:
        return None
