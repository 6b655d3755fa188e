"""Training callbacks.

Counterpart of the JAX package's ``callback.py`` (python-package/lightgbm/
callback.py): early_stopping (:278,456), log_evaluation (:109),
record_evaluation (:183) and reset_parameter (:241), with the same
CallbackEnv protocol and before/after-iteration ordering. Early stopping
publishes its state on the booster each iteration (`_early_stop_state`,
which a checkpoint saves) and takes a resumed run's state back
(`_pending_restore`, handed over by checkpoint.restore_trainer_state).
"""
from __future__ import annotations

from collections import namedtuple
from typing import Callable, Dict, List, Union

from .utils.log import Log

CallbackEnv = namedtuple(
    "CallbackEnv",
    ["model", "params", "iteration", "begin_iteration", "end_iteration",
     "evaluation_result_list"])


class EarlyStopException(Exception):
    def __init__(self, best_iteration: int, best_score) -> None:
        super().__init__()
        self.best_iteration = best_iteration
        self.best_score = best_score


def _format_eval_result(value, show_stdv: bool = True) -> str:
    if len(value) == 4:
        return f"{value[0]}'s {value[1]}: {value[2]:g}"
    if len(value) == 5:
        if show_stdv:
            return f"{value[0]}'s {value[1]}: {value[2]:g} + {value[4]:g}"
        return f"{value[0]}'s {value[1]}: {value[2]:g}"
    raise ValueError("Wrong metric value")


def reset_parameter(**kwargs) -> Callable:
    """Before each iteration, set parameters from a per-round list (as long
    as the number of rounds) or a function of the round; only values that
    differ from the current ones reach Booster.reset_parameter."""
    def _callback(env: CallbackEnv) -> None:
        new_parameters = {}
        for key, value in kwargs.items():
            if isinstance(value, list):
                if len(value) != env.end_iteration - env.begin_iteration:
                    raise ValueError(f"Length of list {key!r} has to equal to "
                                     f"'num_boost_round'.")
                new_param = value[env.iteration - env.begin_iteration]
            elif callable(value):
                new_param = value(env.iteration - env.begin_iteration)
            else:
                raise ValueError("Only list and callable values are supported as a mapping "
                                 "from boosting round index to new parameter value.")
            if new_param != env.params.get(key, None):
                new_parameters[key] = new_param
        if new_parameters:
            if env.model is not None:
                env.model.reset_parameter(new_parameters)
            env.params.update(new_parameters)

    _callback.before_iteration = True
    _callback.order = 10
    return _callback


def log_evaluation(period: int = 1, show_stdv: bool = True) -> Callable:
    def _callback(env: CallbackEnv) -> None:
        if period > 0 and env.evaluation_result_list \
                and (env.iteration + 1) % period == 0:
            result = "\t".join(_format_eval_result(x, show_stdv)
                               for x in env.evaluation_result_list)
            Log.info("[%d]\t%s", env.iteration + 1, result)

    _callback.order = 10
    return _callback


def record_evaluation(eval_result: Dict) -> Callable:
    if not isinstance(eval_result, dict):
        raise TypeError("eval_result should be a dictionary")

    def _init(env: CallbackEnv) -> None:
        eval_result.clear()
        for item in env.evaluation_result_list or []:
            data_name, eval_name = item[0], item[1]
            eval_result.setdefault(data_name, {}).setdefault(eval_name, [])

    def _callback(env: CallbackEnv) -> None:
        if not eval_result:
            _init(env)
        for item in env.evaluation_result_list or []:
            data_name, eval_name, result = item[0], item[1], item[2]
            eval_result.setdefault(data_name, {}).setdefault(eval_name, []).append(result)

    _callback.order = 20
    return _callback


class _EarlyStoppingCallback:
    """callback.py:278-455."""

    # checkpoint.restore_trainer_state hands a resumed run's early-stop
    # state to a callback that sets this flag (applied after _init)
    _accepts_state_restore = True

    def __init__(self, stopping_rounds: int, first_metric_only: bool = False,
                 verbose: bool = True, min_delta: Union[float, List[float]] = 0.0) -> None:
        if not isinstance(stopping_rounds, int) or stopping_rounds <= 0:
            raise ValueError(f"stopping_rounds should be an integer and greater"
                             f" than 0. got: {stopping_rounds}")
        self.order = 30
        self.before_iteration = False
        self.stopping_rounds = stopping_rounds
        self.first_metric_only = first_metric_only
        self.verbose = verbose
        self.min_delta = min_delta
        self.enabled = True
        self._pending_restore = None
        self._reset_storages()

    def _reset_storages(self) -> None:
        self.best_score: List[float] = []
        self.best_iter: List[int] = []
        self.best_score_list: List = []
        self.cmp_op: List[Callable] = []
        self.first_metric = ""

    def _init(self, env: CallbackEnv) -> None:
        self._reset_storages()
        if not env.evaluation_result_list:
            self.enabled = False
            Log.warning("For early stopping, at least one dataset and eval "
                        "metric is required for evaluation")
            return
        n_metrics = len({m[1] for m in env.evaluation_result_list})
        n_datasets = len(env.evaluation_result_list) // max(n_metrics, 1)
        if isinstance(self.min_delta, list):
            deltas = self.min_delta * n_datasets
        else:
            deltas = [self.min_delta] * n_datasets * n_metrics
        self.first_metric = env.evaluation_result_list[0][1]
        for eval_ret, delta in zip(env.evaluation_result_list, deltas):
            self.best_iter.append(0)
            if eval_ret[3]:  # greater is better
                self.best_score.append(float("-inf"))
                self.cmp_op.append(lambda cur, best, d=delta: cur > best + d)
            else:
                self.best_score.append(float("inf"))
                self.cmp_op.append(lambda cur, best, d=delta: cur < best - d)
            self.best_score_list.append(None)

    def snapshot(self) -> Dict:
        """The early-stop state as JSON for a checkpoint. cmp_op is not
        kept: _init builds the comparators again from min_delta and the
        eval list, which a resume reproduces."""
        return {
            "enabled": self.enabled,
            "best_score": list(self.best_score),
            "best_iter": list(self.best_iter),
            "best_score_list": [None if bsl is None else [list(item) for item in bsl]
                                for bsl in self.best_score_list],
            "first_metric": self.first_metric,
        }

    def _apply_restore(self, state: Dict) -> None:
        if len(state.get("best_score", [])) != len(self.best_score):
            Log.warning("Checkpointed early-stop state tracks %d metrics but "
                        "the resume run evaluates %d; starting early-stop "
                        "bookkeeping fresh",
                        len(state.get("best_score", [])), len(self.best_score))
            return
        self.enabled = bool(state["enabled"])
        self.best_score = [float(v) for v in state["best_score"]]
        self.best_iter = [int(it) for it in state["best_iter"]]
        self.best_score_list = [None if bsl is None else [tuple(item) for item in bsl]
                                for bsl in state["best_score_list"]]
        self.first_metric = state["first_metric"]

    def _final_iteration_check(self, env: CallbackEnv, i: int) -> None:
        if env.iteration == env.end_iteration - 1:
            if self.verbose:
                Log.info("Did not meet early stopping. Best iteration is: [%d]\t%s",
                         self.best_iter[i] + 1,
                         "\t".join(_format_eval_result(x) for x in self.best_score_list[i]))
            raise EarlyStopException(self.best_iter[i], self.best_score_list[i])

    def __call__(self, env: CallbackEnv) -> None:
        if env.iteration == env.begin_iteration:
            self._init(env)
            if self._pending_restore is not None:
                self._apply_restore(self._pending_restore)
                self._pending_restore = None
        if not self.enabled:
            return
        for i, eval_ret in enumerate(env.evaluation_result_list):
            data_name, metric_name, score = eval_ret[0], eval_ret[1], eval_ret[2]
            if self.best_score_list[i] is None or self.cmp_op[i](score, self.best_score[i]):
                self.best_score[i] = score
                self.best_iter[i] = env.iteration
                self.best_score_list[i] = env.evaluation_result_list
            if self.first_metric_only and self.first_metric != metric_name:
                continue
            if data_name == "training":
                continue  # train metric never triggers early stop
            if env.iteration - self.best_iter[i] >= self.stopping_rounds:
                if self.verbose:
                    Log.info("Early stopping, best iteration is: [%d]\t%s",
                             self.best_iter[i] + 1,
                             "\t".join(_format_eval_result(x) for x in self.best_score_list[i]))
                raise EarlyStopException(self.best_iter[i], self.best_score_list[i])
            self._final_iteration_check(env, i)
        if env.model is not None:
            # for the checkpoint callback (order 40, which runs next)
            env.model._early_stop_state = self.snapshot()


def early_stopping(stopping_rounds: int, first_metric_only: bool = False,
                   verbose: bool = True, min_delta: Union[float, List[float]] = 0.0
                   ) -> _EarlyStoppingCallback:
    return _EarlyStoppingCallback(stopping_rounds, first_metric_only, verbose, min_delta)
