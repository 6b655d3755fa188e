"""GBDT boosting driver.

Counterpart of the JAX package's ``models/gbdt.py`` (GBDT,
src/boosting/gbdt.cpp): the gradient boosting loop with boost-from-average,
per-class tree training, leaf-value renewal, shrinkage, train and valid
score maintenance, eval, model export, and prediction. The TrainOneIter
control flow mirrors gbdt.cpp:352-460 (init-score handling, constant trees,
should_continue semantics).

Scores live on the training device as float32 [C, N], one row a class (C
trees an iteration for the multiclass objectives). The train score is
updated from the learner's partition (each row once, in float32, as the JAX
package's gather or scatter-add does); valid scores by traversing the new
tree over the valid rows (the traversal kernel on the card). With
linear_tree each tree's leaves get their linear models on the host after
the tree is grown (`treelearner/linear.py`), and the train and valid scores
take the tree through the linear predictor (the traversal's leaf mode, then
the linear epilogue) over the raw rows, kept on the device.

Both learners train synchronously: each tree is grown, replayed into a Tree
on the host and applied to the scores before the next. With the wave
learner, one tree an iteration and a learning rate exact in float32, the
async per-tree pipeline runs instead (`_async_enabled`,
`_train_one_iter_async`): tree t is enqueued on the card, the train score
takes its update straight from the device split log
(ops/score.py:apply_split_log_to_score), and tree t-1 is replayed into its
Tree on the host while the card grows tree t. Every reader of the model or
the scores flushes the pending tree first (`_flush_pending`).

`create_boosting` picks the boosting class: this GBDT, or its DART (`dart.py`) and
random-forest (`rf.py`) subclasses, which score earlier trees again over
every training row (`_add_tree_to_train_score`, the bin-space traversal)
and scale the scores in place (`_multiply_score`). `refit` fits the leaf
values of the trees again on new data, `rollback_one_iter` takes the last
iteration back, and with ``health_check_policy`` set every iteration passes
the numerical-health monitor (`health.py`).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import telemetry
from ..config import Config
from ..health import create_monitor
from ..io.dataset import Dataset
from ..metrics import create_metric
from ..objectives.registry import ObjectiveFunction
from ..ops.histogram import leaf_sums_fixed
from ..ops.partition import bucket_size, pad_indices
from ..ops.predict import (PredictorCache, pack_ensemble, predict_leaf_indices,
                           predict_raw, predict_raw_early_stop, predict_raw_streamed,
                           stream_chunk_rows, to_device_rows)
from ..ops.score import add_tree_to_score, apply_split_log_to_score
from ..treelearner.serial import _leaf_output_host, create_tree_learner
from ..utils import faults
from ..utils.log import Log
from ..utils.timer import global_timer
from .sample_strategy import DeviceBag, create_sample_strategy
from .serialize import GBDTModel
from .tree import Tree

K_EPSILON = 1e-15


def _pack_gh(grad: torch.Tensor, hess: torch.Tensor) -> torch.Tensor:
    """[N] grad/hess -> [N+1, 3] with a count channel and a zero sentinel
    row at N."""
    gh = torch.stack([grad, hess, torch.ones_like(grad)], dim=1)
    return torch.cat([gh, torch.zeros((1, 3), dtype=gh.dtype, device=gh.device)])


class _ValidData:
    """One validation set: its raw rows on the device, metrics and score."""

    def __init__(self, raw: torch.Tensor, metrics) -> None:
        self.raw = raw
        self.metrics = metrics
        self.score: Optional[torch.Tensor] = None


class GBDT:
    """The training driver and predictor. One instance per Booster; with no
    training set it only holds a loaded model."""

    def __init__(self, config: Config, train_set: Optional[Dataset],
                 objective: Optional[ObjectiveFunction],
                 device: torch.device, train_raw: Optional[np.ndarray] = None) -> None:
        self.config = config
        self.device = torch.device(device)
        self.train_set = train_set
        self.objective = objective
        self.iter_ = 0
        self.models: List[Tree] = []
        self.best_iteration = 0
        self.average_output = False
        self.shrinkage_rate = config.learning_rate
        self.num_class = max(config.num_class, 1)
        if objective is not None:
            self.num_tree_per_iteration = objective.num_model_per_iteration
        else:
            self.num_tree_per_iteration = self.num_class if self.num_class > 1 else 1
        self.class_need_train = [True] * self.num_tree_per_iteration
        self._predictor = PredictorCache(self.device)
        self.valid_sets: List[_ValidData] = []
        self.valid_names: List[str] = []
        self.train_metrics = []
        # the async per-tree pipeline (wave learner only): the pending tree,
        # finalized one iteration later; _async_pipeline = False keeps every
        # iteration synchronous (the pipeline's tests compare the two)
        self._pending = None
        self._async_stub_stop = False
        self._async_pipeline = True
        # the numerical-health guardrails (None unless health_check_policy)
        self._health = create_monitor(config)
        if train_set is None:
            return

        n = train_set.num_data
        self.num_data = n
        # the raw rows, for linear trees' fits and scores (the JAX
        # package's train_raw); on the device once, at the first score
        self.train_raw = train_raw
        self._train_raw_dev: Optional[torch.Tensor] = None
        if config.linear_tree and train_raw is None:
            Log.fatal("linear_tree requires dense input (raw feature values per leaf)")
        if objective is not None:
            objective.init(train_set.metadata, n, self.device)
            if hasattr(objective, "class_need_train"):
                self.class_need_train = [objective.class_need_train(c)
                                         for c in range(self.num_tree_per_iteration)]
        self.tree_learner = create_tree_learner(config.tree_learner, self.device,
                                                config, train_set)
        self.sample_strategy = create_sample_strategy(
            config, n, train_set.metadata, self.num_tree_per_iteration)
        self._cur_bag = None  # host indices or a DeviceBag
        self._oob_padded: Optional[torch.Tensor] = None
        self.train_metrics = self._create_metrics(train_set)
        self._all_rows: Optional[torch.Tensor] = None
        # scores [C, N]
        C = self.num_tree_per_iteration
        init = train_set.metadata.init_score
        self._has_init_score = init is not None
        if self._has_init_score:
            self.score = torch.as_tensor(
                np.asarray(init, dtype=np.float32).reshape(C, n), device=self.device)
        else:
            self.score = torch.zeros((C, n), dtype=torch.float32, device=self.device)

    def _create_metrics(self, dataset: Dataset) -> list:
        metrics = [m for m in (create_metric(name, self.config)
                               for name in self.config.metric) if m is not None]
        for m in metrics:
            m.init(dataset.metadata, dataset.num_data, self.device)
        return metrics

    # ------------------------------------------------------------------ valid

    def add_valid(self, valid: Dataset, raw: np.ndarray, name: str) -> None:
        vd = _ValidData(to_device_rows(raw, self.device), self._create_metrics(valid))
        C = self.num_tree_per_iteration
        if valid.metadata.init_score is not None:
            vd.score = torch.as_tensor(
                np.asarray(valid.metadata.init_score, dtype=np.float32)
                .reshape(C, valid.num_data), device=self.device)
        else:
            vd.score = torch.zeros((C, valid.num_data), dtype=torch.float32,
                                   device=self.device)
        self.valid_sets.append(vd)
        self.valid_names.append(name)

    # --------------------------------------------------------------- boosting

    def prepare_training_score(self) -> None:
        """Hook run before custom gradients read the training score
        (GetTrainingScore, boosting.h); DART drops its trees here."""

    def _compute_gh(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The objective's gradients and hessians [C, N] at the train
        score."""
        if self.num_tree_per_iteration > 1:
            return self.objective.get_gradients(self.score)
        grads, hesses = self.objective.get_gradients(self.score[0])
        return grads[None], hesses[None]

    def boost_from_average(self, class_id: int) -> float:
        """gbdt.cpp:327-350."""
        if (not self.models and not self._has_init_score
                and self.objective is not None and self.config.boost_from_average):
            init = self.objective.boost_from_score(class_id)
            if abs(init) > K_EPSILON:
                self._add_to_scores(class_id, init)
                Log.info("Start training from score %f", init)
                return init
        return 0.0

    def _add_to_scores(self, class_id: int, value: float) -> None:
        """A constant added to the train and valid scores of one class, in
        float32 as the JAX package's weakly typed add does."""
        self.score[class_id] += torch.tensor(value, dtype=torch.float32,
                                             device=self.device)
        for vd in self.valid_sets:
            vd.score[class_id] += torch.tensor(value, dtype=torch.float32,
                                               device=self.device)

    def reset_config(self, config: Config) -> None:
        """Take changed parameters between iterations
        (Booster.reset_parameter): the pending tree is finalized first with
        the rate it was grown under, then the shrinkage rate and the
        learner follow the new configuration (`_async_enabled` reads the
        rate each iteration)."""
        self._flush_pending()
        self.config = config
        self.shrinkage_rate = config.learning_rate
        self.tree_learner.reset_config(config)

    # --------------------------------------------------- async tree pipeline

    def _async_enabled(self) -> bool:
        """Whether the async per-tree pipeline runs (the JAX package's
        `_async_enabled`, without its environment switch): the wave learner
        enqueues tree t and the host replays tree t-1 while the card grows
        it. Every condition protects bit-identical results with the
        synchronous path:

        * plain GBDT, one tree an iteration that trains;
        * the wave learner (DeviceTreeLearner), unquantized;
        * an objective with the base renew_tree_output (L1-style objectives
          refit leaf values on the host before the score update);
        * a learning rate exact in float32, so the device's float32 leaf x
          rate equals the host's float64 shrink cast to float32 bit for bit.

        The caller also requires built-in gradients, no bag and a model
        that already holds the first iteration's trees."""
        from ..treelearner.device import DeviceTreeLearner

        if not self._async_pipeline or type(self) is not GBDT:
            return False
        learner = getattr(self, "tree_learner", None)
        if not isinstance(learner, DeviceTreeLearner) or self.config.use_quantized_grad \
                or not learner.async_capable:
            return False
        if self.num_tree_per_iteration != 1 or self.config.linear_tree:
            return False
        if not self.class_need_train[0] or self.train_set.num_features <= 0:
            return False
        obj = self.objective
        if obj is None or (type(obj).renew_tree_output
                           is not ObjectiveFunction.renew_tree_output):
            return False
        rate = float(self.shrinkage_rate)
        return float(np.float32(rate)) == rate

    def _flush_pending(self) -> None:
        """Finalize the pending tree, if any: replay its split log into the
        placeholder Tree already in self.models, shrink it, and apply the
        deferred valid-score update. A stub (no split found) unwinds its
        iteration, removing the placeholder and taking back iter_, and sets
        _async_stub_stop so the next train_one_iter reports the stop one
        iteration late. Called by every reader of the model or the scores
        (eval, predict, export) and by the synchronous training path."""
        pending = self._pending
        if pending is None:
            return
        self._pending = None
        with global_timer.scope("tree_train"):
            tree = self.tree_learner.finalize(pending)
        if tree.num_leaves <= 1:
            for i in range(len(self.models) - 1, -1, -1):
                if self.models[i] is tree:
                    del self.models[i]
                    break
            self.iter_ -= 1
            self._predictor.invalidate()
            self._async_stub_stop = True
            return
        tree.shrink(self.shrinkage_rate)
        with global_timer.scope("update_score"):
            self._update_valid_scores(tree, 0)

    def _stop_for_no_split(self) -> bool:
        self._async_stub_stop = False
        Log.warning("Stopped training because there are no more leaves that "
                    "meet the split requirements")
        return True

    def train_one_iter(self, gradients: Optional[np.ndarray] = None,
                       hessians: Optional[np.ndarray] = None) -> bool:
        """Returns True when training should STOP (no more valid splits) —
        matching LGBM_BoosterUpdateOneIter's is_finished flag."""
        faults.check_kill(self.iter_)
        if self._async_stub_stop:
            return self._stop_for_no_split()
        C = self.num_tree_per_iteration
        init_scores = [0.0] * C
        custom = gradients is not None
        if not custom:
            if self.objective is None:
                Log.fatal("No object function provided")
            for c in range(C):
                init_scores[c] = self.boost_from_average(c)
        should_continue = False
        with global_timer.scope("boosting"):
            if custom:
                grads = torch.as_tensor(np.asarray(gradients, dtype=np.float32)
                                        .reshape(C, self.num_data), device=self.device)
                hesses = torch.as_tensor(np.asarray(hessians, dtype=np.float32)
                                         .reshape(C, self.num_data), device=self.device)
            else:
                grads, hesses = self._compute_gh()
        grads, hesses = faults.maybe_poison_gh(grads, hesses, self.iter_)
        if self._health is not None:
            grads, hesses = self._health.admit(self, grads, hesses)
        with global_timer.scope("bagging"):
            bag, grads, hesses = self.sample_strategy.bagging(
                self.iter_, grads, hesses)
            self._refresh_bag_cache(bag)
        # the async pipeline: not on the first iteration (its stub path
        # seeds the init scores) and not under bagging (the out-of-bag
        # update needs the host tree before the next gradients)
        if (not custom and bag is None and len(self.models) >= C
                and self._async_enabled()):
            return self._train_one_iter_async(grads[0], hesses[0])
        self._flush_pending()
        if self._async_stub_stop:
            return self._stop_for_no_split()
        for c in range(C):
            with global_timer.scope("boosting"):
                gh_ext = _pack_gh(grads[c], hesses[c])
            new_tree = Tree(2)
            if self.class_need_train[c] and self.train_set.num_features > 0:
                with global_timer.scope("tree_train"):
                    new_tree = self.tree_learner.train(gh_ext, bag)
            if new_tree.num_leaves > 1:
                should_continue = True
                if self._health is not None:
                    self._health.observe_tree(new_tree)
                if self.config.linear_tree:
                    self._fit_linear(new_tree, grads[c], hesses[c], len(self.models) < C)
                if self.objective is not None:
                    self.objective.renew_tree_output(
                        new_tree, self.score[c], self.tree_learner.partition)
                new_tree.shrink(self.shrinkage_rate)
                with global_timer.scope("update_score"):
                    self._update_train_score(new_tree, c)
                    self._update_valid_scores(new_tree, c)
                if abs(init_scores[c]) > K_EPSILON:
                    new_tree.add_bias(init_scores[c])
            else:
                if len(self.models) < C:
                    if (self.objective is not None and not self.config.boost_from_average
                            and not self._has_init_score):
                        init_scores[c] = self.objective.boost_from_score(c)
                        self._add_to_scores(c, init_scores[c])
                    new_tree.as_constant_tree(init_scores[c])
                else:
                    new_tree.as_constant_tree(0.0)
            self.models.append(new_tree)
        self._predictor.invalidate()
        if not should_continue:
            Log.warning("Stopped training because there are no more leaves that "
                        "meet the split requirements")
            if len(self.models) > C:
                del self.models[-C:]
            return True
        self.iter_ += 1
        if telemetry.enabled():
            telemetry.sample_hbm()  # the card's memory high-water, a tree
        return False

    def _train_one_iter_async(self, grad: torch.Tensor, hess: torch.Tensor) -> bool:
        """One pipelined iteration (eligibility checked by the caller):
        enqueue tree t, update the train score from its device split log,
        then, while the card grows tree t, replay tree t-1 on the host. The
        host waits only for t-1's results copy, which left the card when
        t-1 ended. Results are bit-identical to the synchronous path; only
        the stop on a tree with no split lands one iteration late (the
        extra tree is the same stub, with a zero score update, and is
        dropped)."""
        with global_timer.scope("boosting"):
            gh_ext = _pack_gh(grad, hess)
        with global_timer.scope("tree_train"):
            pending = self.tree_learner.train_async(gh_ext, None)
        with global_timer.scope("update_score"):
            apply_split_log_to_score(self.score[0], pending.grown.rec_store_dev,
                                     pending.grown.leaf_id, self.shrinkage_rate,
                                     self.config.num_leaves)
        self.models.append(pending.tree)
        self._predictor.invalidate()
        self._flush_pending()  # tree t-1's replay, beside tree t on the card
        if self._async_stub_stop:
            self.models.pop()  # tree t: the same gradients, so the same stub
            return self._stop_for_no_split()
        self._pending = pending
        self.iter_ += 1
        if telemetry.enabled():
            telemetry.sample_hbm()
        return False

    # ------------------------------------------------------------------ score

    def _refresh_bag_cache(self, bag) -> None:
        """The bag is reused across bagging_freq iterations, so the padded
        out-of-bag index array is computed once per bag change (GOSS gives
        a new bag, a new object, every sampling iteration). A DeviceBag's
        set is built on its device from the mask, with no host copy (the
        JAX package's gbdt.py:459-470): in-bag rows take the sentinel N,
        which sorts past every row index, as pad_indices pads."""
        if bag is self._cur_bag:
            return
        self._cur_bag = bag
        n = self.num_data
        if bag is None or len(bag) >= n:
            self._oob_padded = None
        elif isinstance(bag, DeviceBag):
            p = bucket_size(n - bag.n_bag)
            base = torch.where(bag.mask, n, torch.arange(n, dtype=torch.int32,
                                                         device=bag.mask.device))
            if p > n:
                base = torch.cat([base, torch.full((p - n,), n, dtype=torch.int32,
                                                   device=base.device)])
            self._oob_padded = torch.sort(base).values[:p]
        else:
            out = np.ones(n, dtype=bool)
            out[bag] = False
            oob = np.flatnonzero(out).astype(np.int32)  # setdiff1d of the distinct bag
            self._oob_padded = torch.from_numpy(pad_indices(oob, n)).to(self.device)

    def _all_rows_padded(self) -> torch.Tensor:
        """Every training row as a padded index set, on the device once."""
        if self._all_rows is None:
            self._all_rows = torch.from_numpy(pad_indices(
                np.arange(self.num_data, dtype=np.int32), self.num_data)).to(self.device)
        return self._all_rows

    def _add_tree_to_train_score(self, tree: Tree, class_id: int) -> None:
        """Add any tree's outputs (an earlier one, as DART and RF need) to
        the train score of every row: the bin-space traversal, each row once
        (ScoreUpdater::AddScore(tree)), or the linear predictor for a linear
        tree."""
        if tree.is_linear:
            self._add_linear_tree_score(tree, class_id)
            return
        score = self.score[class_id]
        score.copy_(self._tree_score_of_rows(tree, score, self._all_rows_padded()))

    def _tree_score_of_rows(self, tree: Tree, score: torch.Tensor,
                            row_idx: torch.Tensor) -> torch.Tensor:
        """`score` with the tree's outputs added to the padded rows `row_idx`
        by bin-space traversal. The streamed learner keeps no plane on the
        device (bins_dev is None): its cached blocks are walked instead
        (`add_tree_to_score_blocked`), with the same bits."""
        learner = self.tree_learner
        if learner.bins_dev is None:
            return learner.add_tree_to_score_blocked(tree, score, row_idx)
        return add_tree_to_score(tree, self.train_set, learner.bins_dev, score, row_idx,
                                 self.num_data)

    def _multiply_score(self, class_id: int, val: float) -> None:
        """ScoreUpdater::MultiplyScore on the train and valid scores of one
        class, in place, by val rounded to float32 (the JAX package's weakly
        typed multiply)."""
        factor = torch.tensor(val, dtype=torch.float32, device=self.device)
        self.score[class_id] *= factor
        for vd in self.valid_sets:
            vd.score[class_id] *= factor

    def _fit_linear(self, tree: Tree, grad: torch.Tensor, hess: torch.Tensor,
                    is_first_tree: bool) -> None:
        """The leaves' linear models of a grown tree, on the host (the JAX
        package's gbdt.py:367-378): the leaves' rows and the tree's
        gradients and hessians reach the host in one copy each."""
        from ..treelearner.linear import fit_leaf_linear_models, leaf_rows_host

        with global_timer.scope("linear_fit"):
            if is_first_tree:  # constant leaves: nothing to copy
                fit_leaf_linear_models(tree, self.train_set, self.train_raw, None, None, None,
                                       self.config.linear_lambda, True)
                return
            rows = leaf_rows_host(self.tree_learner.partition, tree.num_leaves)
            gh = torch.stack([grad, hess]).cpu().numpy()
            fit_leaf_linear_models(tree, self.train_set, self.train_raw, rows, gh[0], gh[1],
                                   self.config.linear_lambda, False)

    def _add_linear_tree_score(self, tree: Tree, class_id: int) -> None:
        """A linear tree's outputs over every training row: its leaves need
        the raw values, not only the leaf constants (AddPredictionToScore
        with is_linear, gbdt.cpp; the JAX package's gbdt.py:523-530)."""
        if self._train_raw_dev is None:
            self._train_raw_dev = to_device_rows(self.train_raw, self.device)
        packed = pack_ensemble([tree], device=self.device)
        self.score[class_id] += predict_raw(packed, self._train_raw_dev)[:, 0]

    def _update_train_score(self, tree: Tree, class_id: int) -> None:
        """score[row] += leaf value for every in-bag row, then the out-of-bag
        rows by bin-space traversal. The wave learner's partition carries a
        leaf-id vector (bagged-out rows at -1): one gather over it. The
        serial learner's carries per-leaf row sets: one scatter-add. A
        linear tree scores every row through the linear predictor."""
        if tree.is_linear:
            self._add_linear_tree_score(tree, class_id)
            return
        part = self.tree_learner.partition
        L = tree.num_leaves
        lv = torch.as_tensor(tree.leaf_value[:L], dtype=torch.float32,
                             device=self.device)
        score = self.score[class_id]
        ids_fn = getattr(part, "leaf_ids_dev", None)
        if ids_fn is not None:
            ids = ids_fn().to(torch.int64)
            score += torch.where(ids >= 0, lv[torch.clamp(ids, 0, L - 1)],
                                 torch.zeros((), dtype=torch.float32, device=self.device))
        else:
            counts = [part.count(leaf) for leaf in range(L)]
            rows = torch.cat([part.indices(leaf)[:cnt]
                              for leaf, cnt in enumerate(counts)]).to(torch.int64)
            vals = torch.repeat_interleave(lv, torch.as_tensor(counts, device=self.device))
            score.index_add_(0, rows, vals)  # each row once: no order to fix
        if self._cur_bag is not None and self._oob_padded is not None:
            score.copy_(self._tree_score_of_rows(tree, score, self._oob_padded))

    def _update_valid_scores(self, tree: Tree, class_id: int) -> None:
        if not self.valid_sets:
            return
        packed = pack_ensemble([tree], device=self.device)
        for vd in self.valid_sets:
            vd.score[class_id] += predict_raw(packed, vd.raw)[:, 0]

    # ------------------------------------------------------------------- eval

    def eval_train(self) -> List[Tuple[str, str, float, bool]]:
        self._flush_pending()
        out = []
        score = self.score[0] if self.num_tree_per_iteration == 1 else self.score
        for m in self.train_metrics:
            for name, val in zip(m.name, m.eval(score, self.objective)):
                out.append(("training", name, val, m.greater_is_better))
        return out

    def eval_valid(self) -> List[Tuple[str, str, float, bool]]:
        self._flush_pending()
        out = []
        for vname, vd in zip(self.valid_names, self.valid_sets):
            score = vd.score[0] if self.num_tree_per_iteration == 1 else vd.score
            for m in vd.metrics:
                for name, val in zip(m.name, m.eval(score, self.objective)):
                    out.append((vname, name, val, m.greater_is_better))
        return out

    # ---------------------------------------------------------------- predict

    def _packed(self, num_iteration: int = 0, start_iteration: int = 0):
        self._flush_pending()
        C = self.num_tree_per_iteration
        start = max(start_iteration, 0) * C
        n_trees = len(self.models)
        if num_iteration > 0:
            n_trees = min(n_trees, start + num_iteration * C)
        return self._predictor.get(self.models, start, n_trees)

    def predict(self, X: np.ndarray, raw_score: bool = False,
                num_iteration: int = 0, start_iteration: int = 0,
                chunk_rows: Optional[int] = None,
                early_stop: Optional[Tuple[int, float]] = None,
                shard_rows: Optional[int] = None) -> np.ndarray:
        """Predictions [N] or [N, C]; `early_stop` = (round period, margin)
        runs prediction early stopping (ops/predict.py:
        predict_raw_early_stop) in place of the whole traversal. In a gang,
        a batch of at least `shard_rows` rows (parallel/predict.py) is
        split over the ranks, each traversing its rows (the JAX package's
        gbdt.py:595, 633); an explicit chunk size wins over sharding, and a
        linear ensemble is not sharded."""
        from ..parallel.predict import predict_raw_sharded, sharded_predict_enabled

        packed = self._packed(num_iteration, start_iteration)
        C = self.num_tree_per_iteration
        n = X.shape[0]
        chunk = stream_chunk_rows(n, chunk_rows)
        if early_stop is not None and packed.num_trees > 0:
            out = predict_raw_early_stop(packed, to_device_rows(X, self.device), C,
                                         early_stop[0], early_stop[1])
        elif packed.num_trees > 0 and chunk_rows is not None and chunk > 0:
            out = predict_raw_streamed(packed, X, C, chunk)
        elif packed.num_trees > 0 and not packed.linear \
                and sharded_predict_enabled(n, shard_rows):
            out = predict_raw_sharded(packed, X, C)
        elif chunk > 0 and packed.num_trees > 0:
            out = predict_raw_streamed(packed, X, C, chunk)
        else:
            out = predict_raw(packed, to_device_rows(X, self.device), C)
        if self.average_output and packed.num_trees > 0:
            out = out / (packed.num_trees // C)
        if not raw_score and self.objective is not None:
            out = self.objective.convert_output(out)
        res = out.cpu().numpy()
        return res[:, 0] if res.shape[1] == 1 else res

    def predict_leaf_index(self, X: np.ndarray, num_iteration: int = 0,
                           start_iteration: int = 0) -> np.ndarray:
        packed = self._packed(num_iteration, start_iteration)
        return predict_leaf_indices(
            packed, to_device_rows(X, self.device)).cpu().numpy()

    # ------------------------------------------------------------------ model

    def refit(self, pred_leaf: np.ndarray) -> None:
        """GBDT::RefitTree (gbdt.cpp:266-305): keep every tree's structure
        and fit its leaf values again on the training data. pred_leaf [N, T]
        holds each row's leaf in each tree of the old model; the gradients
        are recomputed an iteration at a time from the growing refit score,
        and each leaf's value becomes

            refit_decay_rate * old + (1 - refit_decay_rate) * fit * shrinkage

        (SerialTreeLearner::FitByExistingTree). A leaf's (sum g, sum h) is
        summed exactly in fixed point (ops/histogram.py:leaf_sums_fixed): the
        same bits in any order and on any device, where a float scatter-add
        on the card would depend on the order of its atomics. The JAX
        package sums in float32, which gives the same sums where every sum
        is exact."""
        self._flush_pending()
        C = self.num_tree_per_iteration
        T = len(self.models)
        if pred_leaf.shape != (self.num_data, T):
            Log.fatal("Refit leaf predictions shape %s != (%d, %d)",
                      pred_leaf.shape, self.num_data, T)
        if self.objective is None:
            Log.fatal("Refit needs a built-in objective to compute gradients")
        cfg = self.config
        decay = cfg.refit_decay_rate
        leaf_dev = torch.from_numpy(np.asarray(pred_leaf, dtype=np.int64)).to(self.device)
        for it in range(T // C):
            grads, hesses = self._compute_gh()
            for c in range(C):
                m = it * C + c
                tree = self.models[m]
                L = tree.num_leaves
                leaf = leaf_dev[:, m]
                sums = leaf_sums_fixed(torch.stack([grads[c], hesses[c]], dim=1), None,
                                       leaf, L).cpu().numpy()
                for i in range(L):
                    out = _leaf_output_host(float(sums[i, 0]), float(sums[i, 1]) + K_EPSILON,
                                            cfg.lambda_l1, cfg.lambda_l2, cfg.max_delta_step)
                    tree.set_leaf_output(i, decay * float(tree.leaf_value[i])
                                         + (1.0 - decay) * out * tree.shrinkage)
                lv = torch.as_tensor(tree.leaf_value[:L], dtype=torch.float32,
                                     device=self.device)
                self.score[c] += lv[leaf]
        self._predictor.invalidate()

    def rollback_one_iter(self) -> None:
        """RollbackOneIter (gbdt.cpp:462): drop the last iteration's trees
        and take their outputs back out of the scores. The train score takes
        each negated tree through the bin-space traversal of every row, which
        holds for any class and after a refit or a resume; the JAX package
        reads the learner's last partition, which is the last tree's only
        (ROADMAP Queue 3)."""
        self._flush_pending()
        if self.iter_ <= 0:
            return
        C = self.num_tree_per_iteration
        for c in range(C):
            tree = self.models[-C + c]
            tree.shrink(-1.0)
            self._add_tree_to_train_score(tree, c)
            self._update_valid_scores(tree, c)
            tree.shrink(-1.0)
        del self.models[-C:]
        self.iter_ -= 1
        self._predictor.invalidate()

    def to_model(self) -> GBDTModel:
        self._flush_pending()
        ds = self.train_set
        model = GBDTModel()
        model.num_class = self.num_class
        model.num_tree_per_iteration = self.num_tree_per_iteration
        model.max_feature_idx = ds.num_total_features - 1
        model.objective_str = self.objective.to_string() if self.objective else None
        model.feature_names = ds.feature_names
        model.feature_infos = ds.feature_infos()
        model.monotone_constraints = list(ds.monotone_constraints)
        model.trees = self.models
        model.best_iteration = self.best_iteration
        model.average_output = self.average_output
        model.parameters_str = self.config.to_string()
        return model


def create_boosting(config: Config, train_set: Optional[Dataset],
                    objective: Optional[ObjectiveFunction], device: torch.device,
                    train_raw: Optional[np.ndarray] = None) -> GBDT:
    """Boosting factory (boosting.cpp:41-101): gbdt, dart or rf; the legacy
    boosting=goss spelling trains a GBDT with the GOSS sample strategy."""
    b = config.boosting
    if b == "dart":
        from .dart import DART

        return DART(config, train_set, objective, device, train_raw)
    if b in ("rf", "random_forest"):
        from .rf import RF

        return RF(config, train_set, objective, device, train_raw)
    if b in ("gbdt", "gbrt", "gbm", "goss"):
        return GBDT(config, train_set, objective, device, train_raw)
    Log.fatal("Unknown boosting type %s", b)
