"""Training entry points: train() and cv().

Counterpart of the JAX package's ``engine.py`` (python-package/lightgbm/
engine.py train :109, cv :627): parameter normalization, validation wiring,
the before/after-iteration callback loop, early stopping, continued
training and checkpoint resume from ``init_model``, and k-fold
cross-validation with stratified or shuffled folds.

``init_model`` is a Booster, a model file, or a checkpoint (a model file
with its ``.ckpt`` sidecar, `checkpoint.py`). A checkpoint resumes the run
it was taken from bit for bit, and ``num_boost_round`` counts the whole
run; otherwise the loaded model's raw scores seed ``init_score`` and
``num_boost_round`` more iterations are trained, and the booster returned
holds those new trees only, as the JAX package's does (LightGBM merges the
init model's trees in): predict with both models and add the raw scores.
"""
from __future__ import annotations

import collections
import time
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np

from . import callback as callback_mod
from . import checkpoint as checkpoint_mod
from . import telemetry, tracing
from .utils import sanitize  # noqa: F401 - arms LGBM_TPU_SANITIZE at import
from .basic import Booster, Dataset
from .callback import CallbackEnv, EarlyStopException
from .config import key_alias_transform
from .utils.log import Log
from .utils.timer import global_timer

_INIT_SCORE_CHUNK = 262_144  # rows densified at a time for sparse inputs


def _init_score_predict(model: Booster, raw) -> np.ndarray:
    """Raw-score predict for continued training's init scores. Sparse input
    above the chunk size densifies one chunk of rows at a time."""
    if hasattr(raw, "toarray") and raw.shape[0] > _INIT_SCORE_CHUNK:
        parts = []
        for s in range(0, raw.shape[0], _INIT_SCORE_CHUNK):
            dense = raw[s:s + _INIT_SCORE_CHUNK].toarray()
            parts.append(np.atleast_1d(model.predict(dense, raw_score=True)))
        return np.concatenate(parts, axis=0)
    return model.predict(raw, raw_score=True)


def _raw_rows(dataset: Dataset):
    """A constructed Dataset's raw rows: dense, or the sparse matrix."""
    dataset.construct()
    return dataset._raw if dataset._raw is not None else dataset._sparse_raw


def train(params: Dict[str, Any], train_set: Dataset,
          num_boost_round: int = 100,
          valid_sets: Optional[List[Dataset]] = None,
          valid_names: Optional[List[str]] = None,
          feval: Optional[Union[Callable, List[Callable]]] = None,
          init_model: Optional[Union[str, Booster]] = None,
          keep_training_booster: bool = False,
          callbacks: Optional[List[Callable]] = None) -> Booster:
    """Train a booster on the CUDA card, or on the CPU with
    ``params={"device_type": "cpu"}``.

    With ``init_model`` a Booster or a model file without a checkpoint
    sidecar, the booster returned holds only the ``num_boost_round`` new
    trees: its raw scores add to the init model's.

    ``telemetry_dir`` (or $LGBM_TPU_TELEMETRY) records the run in a
    telemetry session (``events.jsonl``, ``trace.json``, ``metrics.prom``;
    a session already active is reused), and $LGBM_TPU_PROFILE=<dir> wraps
    the boosting loop in a torch.profiler trace (utils/profile.py)."""
    params = key_alias_transform(params or {})
    # a fresh wall-clock window per run (work counters survive)
    global_timer.new_epoch()
    own_tel = None
    tel_dir = telemetry.resolve_dir(params)
    if tel_dir and telemetry.session() is None:
        own_tel = telemetry.start(tel_dir, label="train")
    try:
        return _train_impl(params, train_set, num_boost_round, valid_sets, valid_names,
                           feval, init_model, callbacks)
    except Exception as exc:
        # the black box for the postmortem: what the ring saw up to the
        # unhandled failure (the recorder works with telemetry off too)
        tracing.note("train_exception", error=repr(exc)[:400])
        tracing.dump_flight("train_exception")
        raise
    finally:
        # the beats end legitimately: the collective watchdog must not turn
        # the silence after training into a worker loss
        from .parallel import elastic

        elastic.notify_train_end()
        if own_tel is not None:
            telemetry.stop()


def _train_impl(params, train_set, num_boost_round, valid_sets, valid_names, feval,
                init_model, callbacks) -> Booster:
    # num_boost_round param aliases override the argument (engine.py:158-170)
    if "num_iterations" in params:
        num_boost_round = int(params.pop("num_iterations"))
    params["num_iterations"] = num_boost_round
    fobj = None
    if callable(params.get("objective")):
        fobj = params["objective"]
        params["objective"] = "none"
    first_metric_only = bool(params.get("first_metric_only", False))
    if num_boost_round <= 0:
        raise ValueError("num_boost_round should be greater than zero.")

    predictor_model = None
    ckpt_state = None
    if isinstance(init_model, str):
        # a valid sidecar beside the model file: bit-identical resume, the
        # trainer state put onto the fresh booster below
        ckpt_state = checkpoint_mod.load_checkpoint(init_model)
        if ckpt_state is None:
            device = {"device_type": params["device_type"]} if "device_type" in params else {}
            predictor_model = Booster(model_file=init_model, params=device)
    elif isinstance(init_model, Booster):
        predictor_model = init_model
    if ckpt_state is not None:
        # the resume finishes the ORIGINAL run: the same command after a
        # crash reproduces the uninterrupted run, so num_boost_round is the
        # total
        init_iteration = ckpt_state.iteration
        num_boost_round = max(num_boost_round - init_iteration, 0)
    else:
        init_iteration = predictor_model.current_iteration() if predictor_model else 0

    train_set.params = {**train_set.params, **params}
    if predictor_model is not None:
        # continued training: the loaded model's raw scores seed init_score
        init_score = _init_score_predict(predictor_model, _raw_rows(train_set))
        train_set.set_init_score(np.asarray(init_score, dtype=np.float64).ravel(order="F"))
    booster = Booster(params=params, train_set=train_set)
    if valid_sets is not None:
        if isinstance(valid_sets, Dataset):
            valid_sets = [valid_sets]
        for i, valid_data in enumerate(valid_sets):
            if valid_data is train_set:
                booster._train_data_name = "training"
                continue
            name = (valid_names[i] if valid_names and i < len(valid_names)
                    else f"valid_{i}")
            if valid_data.reference is None:
                valid_data.reference = train_set
            valid_data.params = {**valid_data.params, **params}
            if predictor_model is not None:
                vi = _init_score_predict(predictor_model, _raw_rows(valid_data))
                valid_data.set_init_score(np.asarray(vi, dtype=np.float64).ravel(order="F"))
            booster.add_valid(valid_data, name)

    cbs = set(callbacks or [])
    verbosity = int(params.get("verbosity", 1))
    if params.get("early_stopping_round") and int(params["early_stopping_round"]) > 0:
        cbs.add(callback_mod.early_stopping(int(params["early_stopping_round"]),
                                            first_metric_only,
                                            verbose=verbosity >= 1))
    callbacks_before = sorted((cb for cb in cbs if getattr(cb, "before_iteration", False)),
                              key=lambda cb: getattr(cb, "order", 0))
    callbacks_after = sorted((cb for cb in cbs if not getattr(cb, "before_iteration", False)),
                             key=lambda cb: getattr(cb, "order", 0))
    if ckpt_state is not None:
        checkpoint_mod.restore_trainer_state(booster, ckpt_state, callbacks_after)

    booster.best_iteration = -1
    try:
        _train_loop(booster, params, feval, fobj, init_iteration, num_boost_round,
                    callbacks_before, callbacks_after)
    finally:
        if global_timer.enabled:
            Log.info("%s", global_timer.report())
    if booster.best_iteration <= 0:
        booster.best_iteration = booster.current_iteration()
    return booster


def _train_loop(booster, params, feval, fobj, init_iteration, num_boost_round,
                callbacks_before, callbacks_after) -> bool:
    from .utils.profile import maybe_trace

    with maybe_trace():  # a torch.profiler trace when LGBM_TPU_PROFILE=<dir>
        return _train_loop_inner(booster, params, feval, fobj, init_iteration,
                                 num_boost_round, callbacks_before, callbacks_after)


def _train_loop_inner(booster, params, feval, fobj, init_iteration, num_boost_round,
                      callbacks_before, callbacks_after) -> bool:
    is_finished = False
    evaluation_result_list = None
    end = init_iteration + num_boost_round
    if telemetry.enabled():
        telemetry.emit("train_begin", begin_iteration=init_iteration, end_iteration=end,
                       objective=str(params.get("objective", "")))
    for i in range(init_iteration, end):
        if is_finished:
            break
        it_t0 = time.perf_counter()
        # the iteration's span: the serving requests' API, so the Chrome
        # trace and the flight recorder speak one format
        it_span = tracing.start_span("train_iteration")
        it_span.attrs["iteration"] = int(i)
        counters_before = dict(global_timer.counters) if telemetry.enabled() else None
        env = dict(model=booster, params=params, iteration=i,
                   begin_iteration=init_iteration, end_iteration=end)
        for cb in callbacks_before:
            cb(CallbackEnv(evaluation_result_list=None, **env))
        is_finished = booster.update(fobj=fobj)
        t_boost_end = time.perf_counter()
        it_span.add_stage("boost", t_boost_end - it_t0)

        evaluation_result_list = []
        if booster._gbdt.valid_sets or booster._gbdt.train_metrics:
            if booster._train_data_name == "training" and _wants_train_metric(params):
                evaluation_result_list.extend(booster.eval_train(feval))
            evaluation_result_list.extend(booster.eval_valid(feval))
        try:
            for cb in callbacks_after:
                cb(CallbackEnv(evaluation_result_list=evaluation_result_list, **env))
        except EarlyStopException as early_stop:
            booster.best_iteration = early_stop.best_iteration + 1
            evaluation_result_list = early_stop.best_score
            is_finished = True
        it_span.add_stage("eval", time.perf_counter() - t_boost_end)
        it_span.finish()
        if counters_before is not None:
            _emit_iteration_record(booster, i, evaluation_result_list,
                                   time.perf_counter() - it_t0, counters_before)
    booster.best_score = collections.defaultdict(collections.OrderedDict)
    for item in evaluation_result_list or []:
        booster.best_score[item[0]][item[1]] = item[2]
    return is_finished


def _emit_iteration_record(booster, iteration, evals, wall_s, counters_before) -> None:
    """One structured record a boosting iteration: eval results, the last
    finalized tree's leaves, work-counter deltas, wall time; then a sample
    of the card's memory high-water. A tree the async pipeline still has
    pending is not read (reading it would finalize it early)."""
    gbdt = booster._gbdt
    models = gbdt.models
    done = len(models) - (gbdt._pending is not None)
    last = models[done - 1] if done > 0 else None
    deltas = {}
    for k, v in global_timer.counters.items():
        d = int(v) - int(counters_before.get(k, 0))
        if d:
            deltas[k] = d
    telemetry.emit(
        "iteration", iteration=int(iteration), wall_s=round(wall_s, 6),
        num_trees=len(models), tree_leaves=int(getattr(last, "num_leaves", 0) or 0),
        evals=[[e[0], e[1], float(e[2])] for e in (evals or [])], counters=deltas)
    telemetry.sample_hbm()


def _wants_train_metric(params) -> bool:
    return any(params.get(key) for key in (
        "is_provide_training_metric", "training_metric", "is_training_metric",
        "train_metric"))


class CVBooster:
    """The folds' boosters (engine.py CVBooster): a method call goes to
    every fold and returns the list of their answers."""

    def __init__(self) -> None:
        self.boosters: List[Booster] = []
        self.best_iteration = -1

    def append(self, booster: Booster) -> None:
        self.boosters.append(booster)

    def __getattr__(self, name):
        def handler_function(*args, **kwargs):
            return [getattr(b, name)(*args, **kwargs) for b in self.boosters]

        return handler_function


def _make_n_folds(full_data: Dataset, folds, nfold: int, params, seed: int,
                  stratified: bool, shuffle: bool):
    """(train indices, test indices) of each fold: the caller's `folds` (an
    iterable, or a splitter with `split`), else stratified by label class
    or cut from a permutation, drawn from np.random.RandomState(seed) as
    the JAX package's engine.py:295 draws them."""
    full_data.construct()
    num_data = full_data.num_data()
    label = np.asarray(full_data.get_label())
    rng = np.random.RandomState(seed)
    if folds is not None:
        if hasattr(folds, "split"):
            group = full_data.get_group()
            group_info = np.asarray(group, dtype=np.int64) if group is not None else None
            folds = folds.split(X=np.empty(num_data), y=label, groups=group_info)
        yield from folds
        return
    if stratified:
        classes = np.unique(label)
        idx_by_class = [np.where(label == c)[0] for c in classes]
        if shuffle:
            for a in idx_by_class:
                rng.shuffle(a)
        fold_members: List[List[int]] = [[] for _ in range(nfold)]
        for a in idx_by_class:
            for i, ix in enumerate(a):
                fold_members[i % nfold].append(ix)
        for k in range(nfold):
            test_idx = np.array(sorted(fold_members[k]), dtype=np.int64)
            yield np.setdiff1d(np.arange(num_data), test_idx), test_idx
    else:
        perm = rng.permutation(num_data) if shuffle else np.arange(num_data)
        kstep = int(num_data / nfold)
        for k in range(nfold):
            test_idx = perm[k * kstep: (k + 1) * kstep if k < nfold - 1 else num_data]
            yield np.setdiff1d(np.arange(num_data), test_idx), test_idx


def cv(params: Dict[str, Any], train_set: Dataset, num_boost_round: int = 100,
       folds=None, nfold: int = 5, stratified: bool = True, shuffle: bool = True,
       metrics=None, feval=None, init_model=None, fpreproc=None, seed: int = 0,
       callbacks=None, eval_train_metric: bool = False,
       return_cvbooster: bool = False) -> Dict[str, List[float]]:
    """K-fold cross-validation (engine.py:627): a booster a fold on
    `Dataset.subset`s of train_set, trained in lockstep; each round's valid
    metrics as their mean and standard deviation over the folds.

    ``init_model`` and ``eval_train_metric`` are refused: the JAX package
    takes them and ignores them."""
    if init_model is not None:
        Log.fatal("cv(init_model=...) is not supported by the PyTorch package: "
                  "every fold trains from scratch")
    if eval_train_metric:
        Log.fatal("cv(eval_train_metric=True) is not supported by the PyTorch "
                  "package: only the folds' valid metrics are reported")
    params = key_alias_transform(params or {})
    if "num_iterations" in params:
        num_boost_round = int(params.pop("num_iterations"))
    if metrics is not None:
        params["metric"] = metrics
    if stratified and params.get("objective") not in (
            None, "binary", "multiclass", "multiclassova", "softmax"):
        stratified = False

    results = collections.defaultdict(list)
    cvbooster = CVBooster()
    fold_data = []
    for train_idx, test_idx in _make_n_folds(train_set, folds, nfold, params, seed,
                                             stratified, shuffle):
        tr = train_set.subset(train_idx)
        te = train_set.subset(test_idx)
        if fpreproc is not None:
            tr, te, params = fpreproc(tr, te, params.copy())
        fold_data.append((tr, te))

    boosters = []
    for tr, te in fold_data:
        te.reference = tr
        bst = Booster(params=params, train_set=tr)
        bst.add_valid(te, "valid")
        boosters.append(bst)
        cvbooster.append(bst)

    cbs = set(callbacks or [])
    if params.get("early_stopping_round") and int(params["early_stopping_round"]) > 0:
        cbs.add(callback_mod.early_stopping(int(params["early_stopping_round"])))
    callbacks_after = sorted((cb for cb in cbs if not getattr(cb, "before_iteration", False)),
                             key=lambda cb: getattr(cb, "order", 0))

    is_finished = False
    for i in range(num_boost_round):
        if is_finished:
            break
        merged: Dict = collections.defaultdict(list)
        for bst in boosters:
            bst.update()
            for dname, mname, val, bigger in bst.eval_valid(feval):
                merged[(dname, mname, bigger)].append(val)
        agg = []
        for (dname, mname, bigger), vals in merged.items():
            mean, std = float(np.mean(vals)), float(np.std(vals))
            results[f"{dname} {mname}-mean"].append(mean)
            results[f"{dname} {mname}-stdv"].append(std)
            agg.append((dname, mname, mean, bigger, std))
        try:
            for cb in callbacks_after:
                cb(CallbackEnv(model=cvbooster, params=params, iteration=i,
                               begin_iteration=0, end_iteration=num_boost_round,
                               evaluation_result_list=agg))
        except EarlyStopException as e:
            cvbooster.best_iteration = e.best_iteration + 1
            for key in list(results.keys()):
                results[key] = results[key][: cvbooster.best_iteration]
            is_finished = True
    out = dict(results)
    if return_cvbooster:
        out["cvbooster"] = cvbooster
    return out
