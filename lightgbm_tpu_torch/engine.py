"""Training entry point: train().

Counterpart of the JAX package's ``engine.py`` (python-package/lightgbm/
engine.py train :109): parameter normalization, validation wiring, the
before/after-iteration callback loop and early stopping. ``cv`` and
continued training from ``init_model`` are later work (ROADMAP Queue 1
item 6.7).
"""
from __future__ import annotations

import collections
from typing import Any, Callable, Dict, List, Optional, Union

from . import callback as callback_mod
from .basic import Booster, Dataset
from .callback import CallbackEnv, EarlyStopException
from .config import key_alias_transform
from .utils.log import Log
from .utils.timer import global_timer


def train(params: Dict[str, Any], train_set: Dataset,
          num_boost_round: int = 100,
          valid_sets: Optional[List[Dataset]] = None,
          valid_names: Optional[List[str]] = None,
          feval: Optional[Union[Callable, List[Callable]]] = None,
          init_model=None,
          keep_training_booster: bool = False,
          callbacks: Optional[List[Callable]] = None) -> Booster:
    """Train a booster on the CUDA card, or on the CPU with
    ``params={"device_type": "cpu"}``."""
    params = key_alias_transform(params or {})
    if init_model is not None:
        Log.fatal("continued training (init_model) is not yet ported to the "
                  "PyTorch package (ROADMAP Queue 1 item 6.7)")
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

    train_set.params = {**train_set.params, **params}
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

    booster.best_iteration = -1
    try:
        _train_loop(booster, params, feval, fobj, num_boost_round,
                    callbacks_before, callbacks_after)
    finally:
        if global_timer.enabled:
            Log.info("%s", global_timer.report())
    if booster.best_iteration <= 0:
        booster.best_iteration = booster.current_iteration()
    return booster


def _train_loop(booster, params, feval, fobj, num_boost_round,
                callbacks_before, callbacks_after) -> bool:
    is_finished = False
    evaluation_result_list = None
    for i in range(num_boost_round):
        if is_finished:
            break
        env = dict(model=booster, params=params, iteration=i, begin_iteration=0,
                   end_iteration=num_boost_round)
        for cb in callbacks_before:
            cb(CallbackEnv(evaluation_result_list=None, **env))
        is_finished = booster.update(fobj=fobj)

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
    booster.best_score = collections.defaultdict(collections.OrderedDict)
    for item in evaluation_result_list or []:
        booster.best_score[item[0]][item[1]] = item[2]
    return is_finished


def _wants_train_metric(params) -> bool:
    return any(params.get(key) for key in (
        "is_provide_training_metric", "training_metric", "is_training_metric",
        "train_metric"))
