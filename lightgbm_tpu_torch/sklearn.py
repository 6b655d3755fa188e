"""scikit-learn estimator API.

Counterpart of the JAX package's ``sklearn.py`` (python-package/lightgbm/
sklearn.py): LGBMModel base + LGBMClassifier / LGBMRegressor / LGBMRanker
wrapping engine.train with the standard sklearn fit/predict surface
(the estimator's parameters mapped to LightGBM's by `_lgb_params`), eval
sets (with their groups for a ranker), early stopping via callbacks, label
encoding for classifiers, and fitted attributes (best_iteration_,
best_score_, feature_importances_, classes_). scikit-learn is optional:
without it the estimators keep the same surface on plain base classes.
Like every entry point of the package they train on the CUDA card unless
``device_type="cpu"`` is passed.
"""
from __future__ import annotations

import copy
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np

from . import callback as callback_mod
from .basic import Booster, Dataset, _is_dataframe
from .engine import train as train_fn
from .utils.log import LightGBMError

try:  # sklearn is optional at runtime, mirrored from the reference's guard
    from sklearn.base import BaseEstimator, ClassifierMixin, RegressorMixin

    _SKLEARN_INSTALLED = True
except ImportError:  # pragma: no cover
    _SKLEARN_INSTALLED = False

    class BaseEstimator:  # type: ignore
        pass

    class ClassifierMixin:  # type: ignore
        pass

    class RegressorMixin:  # type: ignore
        pass


class _EvalFunctionWrapper:
    """A scikit-learn style metric, `func(y_true, y_pred)` (with `weight`
    and `group` after them if it takes them), as a feval `(preds, dataset)`
    (python-package sklearn.py _EvalFunctionWrapper). It sees the scores
    the Booster's fevals see."""

    def __init__(self, func: Callable) -> None:
        self.func = func

    def __call__(self, preds, dataset):
        import inspect

        labels = dataset.get_label()
        argc = len(inspect.signature(self.func).parameters)
        if argc == 2:
            return self.func(labels, preds)
        if argc == 3:
            return self.func(labels, preds, dataset.get_weight())
        if argc == 4:
            return self.func(labels, preds, dataset.get_weight(), dataset.get_group())
        raise TypeError(f"Self-defined eval function should have 2, 3 or 4 arguments, "
                        f"got {argc}")


class LGBMModel(BaseEstimator):
    """Base estimator (sklearn.py LGBMModel)."""

    def __init__(self, boosting_type: str = "gbdt", num_leaves: int = 31,
                 max_depth: int = -1, learning_rate: float = 0.1,
                 n_estimators: int = 100, subsample_for_bin: int = 200000,
                 objective: Optional[str] = None,
                 class_weight: Optional[Union[Dict, str]] = None,
                 min_split_gain: float = 0.0, min_child_weight: float = 1e-3,
                 min_child_samples: int = 20, subsample: float = 1.0,
                 subsample_freq: int = 0, colsample_bytree: float = 1.0,
                 reg_alpha: float = 0.0, reg_lambda: float = 0.0,
                 random_state: Optional[int] = None, n_jobs: int = -1,
                 importance_type: str = "split", **kwargs: Any) -> None:
        self.boosting_type = boosting_type
        self.num_leaves = num_leaves
        self.max_depth = max_depth
        self.learning_rate = learning_rate
        self.n_estimators = n_estimators
        self.subsample_for_bin = subsample_for_bin
        self.objective = objective
        self.class_weight = class_weight
        self.min_split_gain = min_split_gain
        self.min_child_weight = min_child_weight
        self.min_child_samples = min_child_samples
        self.subsample = subsample
        self.subsample_freq = subsample_freq
        self.colsample_bytree = colsample_bytree
        self.reg_alpha = reg_alpha
        self.reg_lambda = reg_lambda
        self.random_state = random_state
        self.n_jobs = n_jobs
        self.importance_type = importance_type
        self._other_params: Dict[str, Any] = kwargs
        self._Booster: Optional[Booster] = None
        self._evals_result: Dict = {}
        self._best_iteration = 0
        self._best_score: Dict = {}
        self._n_features = 0
        self._objective = objective
        self.set_params(**kwargs)

    # --------------------------------------------------------------- params

    def get_params(self, deep: bool = True) -> Dict[str, Any]:
        params = super().get_params(deep=deep) if _SKLEARN_INSTALLED else {
            k: getattr(self, k) for k in (
                "boosting_type", "num_leaves", "max_depth", "learning_rate",
                "n_estimators", "subsample_for_bin", "objective",
                "class_weight", "min_split_gain", "min_child_weight",
                "min_child_samples", "subsample", "subsample_freq",
                "colsample_bytree", "reg_alpha", "reg_lambda", "random_state",
                "n_jobs", "importance_type")}
        params.update(self._other_params)
        return params

    def set_params(self, **params: Any) -> "LGBMModel":
        for key, value in params.items():
            setattr(self, key, value)
            if not hasattr(type(self), key):
                self._other_params[key] = value
        return self

    def _lgb_params(self) -> Dict[str, Any]:
        params = {
            "boosting": self.boosting_type,
            "num_leaves": self.num_leaves,
            "max_depth": self.max_depth,
            "learning_rate": self.learning_rate,
            "bin_construct_sample_cnt": self.subsample_for_bin,
            "min_gain_to_split": self.min_split_gain,
            "min_sum_hessian_in_leaf": self.min_child_weight,
            "min_data_in_leaf": self.min_child_samples,
            "bagging_fraction": self.subsample,
            "bagging_freq": self.subsample_freq,
            "feature_fraction": self.colsample_bytree,
            "lambda_l1": self.reg_alpha,
            "lambda_l2": self.reg_lambda,
            "verbosity": -1,
        }
        if self.random_state is not None:
            params["seed"] = (self.random_state
                              if isinstance(self.random_state, int)
                              else self.random_state.randint(2**31 - 1))
        if self._objective is not None:
            params["objective"] = self._objective
        params.update(self._other_params)
        return params

    # ------------------------------------------------------------------ fit

    def _fit(self, X, y, sample_weight=None, init_score=None, group=None,
             eval_set=None, eval_names=None, eval_sample_weight=None,
             eval_group=None, eval_metric=None, callbacks=None) -> "LGBMModel":
        if not _is_dataframe(X):  # DataFrames pass through to Dataset's
            X = np.asarray(X, dtype=np.float64)  # pandas-categorical handling
        y = np.asarray(y, dtype=np.float64).ravel()
        self._n_features = X.shape[1]
        params = self._lgb_params()
        feval = None
        if eval_metric is not None:
            # a callable becomes a feval, and only the metric names go to
            # params["metric"] (python-package sklearn.py's contract)
            metrics = list(eval_metric) if isinstance(eval_metric, (list, tuple)) \
                else [eval_metric]
            names = [m for m in metrics if not callable(m)]
            feval = [_EvalFunctionWrapper(m) for m in metrics if callable(m)] or None
            if feval is None:
                params["metric"] = eval_metric
            elif names:
                params["metric"] = names
        train_set = Dataset(X, label=y, weight=sample_weight,
                            group=group, init_score=init_score)
        valid_sets: List[Dataset] = []
        valid_names: List[str] = []
        if eval_set is not None:
            if isinstance(eval_set, tuple):
                eval_set = [eval_set]
            for i, (vx, vy) in enumerate(eval_set):
                vw = eval_sample_weight[i] if eval_sample_weight else None
                vg = eval_group[i] if eval_group else None
                if not _is_dataframe(vx):
                    vx = np.asarray(vx, dtype=np.float64)
                vy = np.asarray(vy, dtype=np.float64).ravel()

                def _opt_equal(a, b):
                    if a is None or b is None:
                        return a is b
                    return np.array_equal(np.asarray(a), np.asarray(b))

                if (np.array_equal(vy, y) and np.array_equal(vx, X)
                        and _opt_equal(vw, sample_weight)
                        and _opt_equal(vg, group)):
                    valid_sets.append(train_set)
                else:
                    valid_sets.append(Dataset(
                        vx, label=self._encode_eval_label(vy), weight=vw,
                        group=vg, reference=train_set))
                valid_names.append(eval_names[i] if eval_names
                                   else f"valid_{i}")
        self._evals_result = {}
        callbacks = list(callbacks) if callbacks else []
        callbacks.append(callback_mod.record_evaluation(self._evals_result))
        self._Booster = train_fn(
            params, train_set, num_boost_round=self.n_estimators,
            valid_sets=valid_sets or None,
            valid_names=valid_names or None, feval=feval, callbacks=callbacks)
        self._best_iteration = self._Booster.best_iteration
        self._best_score = copy.deepcopy(self._evals_result)
        return self

    def _encode_eval_label(self, y: np.ndarray) -> np.ndarray:
        return y

    fit = _fit

    # -------------------------------------------------------------- predict

    def predict(self, X, raw_score: bool = False, num_iteration: Optional[int] = None,
                **kwargs: Any) -> np.ndarray:
        if self._Booster is None:
            raise _not_fitted_error(self)
        if not _is_dataframe(X):  # frames map through pandas_categorical
            # keep f32/f64 inputs as-is: Booster.predict routes the device
            # dtype, and an f32 matrix forced through f64 would pay a 2x
            # host copy just to be downcast again at upload
            X = np.asarray(X)
            if X.dtype not in (np.float32, np.float64):
                X = X.astype(np.float64)
        if X.shape[1] != self._n_features:
            raise ValueError(
                "Number of features of the model must match the input. "
                f"Model n_features_ is {self._n_features} and input "
                f"n_features is {X.shape[1]}")
        return self._Booster.predict(
            X, raw_score=raw_score,
            num_iteration=num_iteration if num_iteration is not None else 0,
            **kwargs)

    # ---------------------------------------------------------- attributes

    @property
    def n_features_(self) -> int:
        if self._Booster is None:
            raise _not_fitted_error(self)
        return self._n_features

    @property
    def n_features_in_(self) -> int:
        return self.n_features_

    @property
    def booster_(self) -> Booster:
        if self._Booster is None:
            raise _not_fitted_error(self)
        return self._Booster

    @property
    def best_iteration_(self) -> int:
        if self._Booster is None:
            raise _not_fitted_error(self)
        return self._best_iteration

    @property
    def best_score_(self) -> Dict:
        if self._Booster is None:
            raise _not_fitted_error(self)
        return self._best_score

    @property
    def evals_result_(self) -> Dict:
        if self._Booster is None:
            raise _not_fitted_error(self)
        return self._evals_result

    @property
    def feature_importances_(self) -> np.ndarray:
        if self._Booster is None:
            raise _not_fitted_error(self)
        return self._Booster.feature_importance(
            importance_type=self.importance_type)

    @property
    def feature_name_(self) -> List[str]:
        if self._Booster is None:
            raise _not_fitted_error(self)
        return self._Booster.feature_name()


def _not_fitted_error(est) -> Exception:
    if _SKLEARN_INSTALLED:
        from sklearn.exceptions import NotFittedError

        return NotFittedError(
            f"This {type(est).__name__} instance is not fitted yet.")
    return LightGBMError(
        f"This {type(est).__name__} instance is not fitted yet.")


class LGBMRegressor(RegressorMixin, LGBMModel):
    def fit(self, X, y, sample_weight=None, init_score=None, eval_set=None,
            eval_names=None, eval_sample_weight=None, eval_metric=None,
            callbacks=None) -> "LGBMRegressor":
        if self._objective is None:
            self._objective = "regression"
        return self._fit(X, y, sample_weight=sample_weight,
                         init_score=init_score, eval_set=eval_set,
                         eval_names=eval_names,
                         eval_sample_weight=eval_sample_weight,
                         eval_metric=eval_metric, callbacks=callbacks)


class LGBMClassifier(ClassifierMixin, LGBMModel):
    def fit(self, X, y, sample_weight=None, init_score=None, eval_set=None,
            eval_names=None, eval_sample_weight=None, eval_metric=None,
            callbacks=None) -> "LGBMClassifier":
        y = np.asarray(y).ravel()
        self._classes, y_enc = np.unique(y, return_inverse=True)
        self._n_classes = len(self._classes)
        if self._n_classes > 2:
            if self._objective is None or self._objective in (
                    "binary", "multiclass"):
                self._objective = "multiclass"
            self._other_params["num_class"] = self._n_classes
        else:
            if self._objective is None:
                self._objective = "binary"
        if eval_set is not None:
            if isinstance(eval_set, tuple):
                eval_set = [eval_set]
            eval_set = [(vx, np.searchsorted(self._classes, np.asarray(vy).ravel()))
                        for vx, vy in eval_set]
        return self._fit(X, y_enc.astype(np.float64),
                         sample_weight=sample_weight, init_score=init_score,
                         eval_set=eval_set, eval_names=eval_names,
                         eval_sample_weight=eval_sample_weight,
                         eval_metric=eval_metric, callbacks=callbacks)

    def predict(self, X, raw_score: bool = False,
                num_iteration: Optional[int] = None, **kwargs: Any) -> np.ndarray:
        proba = self.predict_proba(X, raw_score=raw_score,
                                   num_iteration=num_iteration, **kwargs)
        if raw_score:
            return proba
        if proba.ndim == 1:
            idx = (proba > 0.5).astype(int)
        else:
            idx = np.argmax(proba, axis=1)
        return self._classes[idx]

    def predict_proba(self, X, raw_score: bool = False,
                      num_iteration: Optional[int] = None,
                      **kwargs: Any) -> np.ndarray:
        out = super().predict(X, raw_score=raw_score,
                              num_iteration=num_iteration, **kwargs)
        if raw_score:
            return out
        if out.ndim == 1 and self._n_classes <= 2:
            return np.vstack([1.0 - out, out]).T
        return out

    @property
    def classes_(self) -> np.ndarray:
        if self._Booster is None:
            raise _not_fitted_error(self)
        return self._classes

    @property
    def n_classes_(self) -> int:
        if self._Booster is None:
            raise _not_fitted_error(self)
        return self._n_classes


class LGBMRanker(LGBMModel):
    def fit(self, X, y, sample_weight=None, init_score=None, group=None,
            eval_set=None, eval_names=None, eval_sample_weight=None,
            eval_group=None, eval_metric=None, eval_at=(1, 2, 3, 4, 5),
            callbacks=None) -> "LGBMRanker":
        if group is None:
            raise ValueError("Should set group for ranking task")
        if eval_set is not None and eval_group is None:
            raise ValueError("Eval_group cannot be None when eval_set is not None")
        if self._objective is None:
            self._objective = "lambdarank"
        self._other_params.setdefault("eval_at", list(eval_at))
        return self._fit(X, y, sample_weight=sample_weight,
                         init_score=init_score, group=group,
                         eval_set=eval_set, eval_names=eval_names,
                         eval_sample_weight=eval_sample_weight,
                         eval_group=eval_group, eval_metric=eval_metric,
                         callbacks=callbacks)
