"""Continuous-training flywheel: push -> refit -> checkpoint -> hot-swap.

Counterpart of the JAX package's ``streaming/continuous.py``.
ContinuousTrainer closes the train-to-serve loop over a live RowBlockStore:

  * `step()` refits when at least `min_new_rows` rows have landed since the
    last published model (always on the first call).
  * Each refit pins a row watermark before it snapshots the store, and the
    watermark survives a crash mid-refit: a retried `refit()` of the same
    generation finalizes the same rows even while pushes go on, so the
    resumed run trains on the dataset the crashed one saw, the condition of
    a bit-identical resume.
  * Training runs through engine.train with a checkpoint_callback a
    generation. If the generation's checkpoint exists when a refit starts,
    it is handed to engine.train as init_model, which subtracts the
    finished iterations and replays the rest bit-identically.
  * A holdout gate (`health.prediction_loss`) may refuse a candidate; the
    generation then rolls back as after a lost worker.
  * On success the booster is published into the serving ModelRegistry,
    or a PredictionService (which also warms it up and re-baselines its
    breaker, or stages it as a canary): an atomic swap, so a concurrent
    predict never sees a half-loaded model.
  * A bin refresh (drift-driven, or every `refresh_every` generations) runs
    at a fresh generation boundary only.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional

from .. import engine, health, tracing
from ..checkpoint import CheckpointError, checkpoint_callback, \
    read_sidecar_manifest
from ..parallel.elastic import WorkerLostError
from ..utils import faults
from ..utils.timer import global_timer
from .. import telemetry
from ..utils.log import Log
from . import drift
from .ingest import RowBlockStore, wrap_dataset


class GenerationRejected(Exception):
    """Typed marker for a candidate generation the publish quality gate
    refused (never raised across the refit() boundary — refit() converts
    it into the same rolled-back None return as a lost worker — but
    carried in telemetry/tracing so dashboards can key on it)."""


class ContinuousTrainer:
    def __init__(self, params: Dict[str, Any], store: RowBlockStore, *,
                 num_boost_round: int = 20,
                 min_new_rows: int = 1,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_period: int = 1,
                 registry=None, service=None,
                 model_name: str = "live",
                 holdout_rows: int = 0,
                 gate_tolerance: float = 0.1,
                 canary_fraction: float = 0.0,
                 canary_promote_after: int = 32,
                 refresh_every: Optional[int] = None) -> None:
        self.params = dict(params)
        self.store = store
        self.num_boost_round = int(num_boost_round)
        self.min_new_rows = int(min_new_rows)
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_period = int(checkpoint_period)
        self.registry = registry
        self.service = service
        self.model_name = model_name
        self.generation = 0
        self.booster = None
        self._trained_rows = 0
        # crash-consistency watermark: rows pinned by an unfinished refit
        self._inflight_rows: Optional[int] = None
        # publish quality gate: holdout_rows > 0 arms it (the store must be
        # built with a matching holdout ring); the candidate must score
        # within (1 + gate_tolerance) of the serving model's holdout loss
        self.holdout_rows = int(holdout_rows)
        self.gate_tolerance = float(gate_tolerance)
        self._inflight_holdout = None  # pinned with the row watermark
        # optional canary: route a traffic fraction at the candidate first
        self.canary_fraction = float(canary_fraction)
        self.canary_promote_after = int(canary_promote_after)
        # scheduled bin refresh cadence in generations (0/None = drift-only)
        if refresh_every is None:
            refresh_every = int(os.environ.get(
                drift.REFRESH_EVERY_ENV, "0") or 0)
        self.refresh_every = int(refresh_every)
        if self.holdout_rows > 0 and self.store.holdout_rows <= 0:
            # arm the store's raw tail ring so holdout_snapshot() works
            self.store.holdout_rows = self.holdout_rows

    # ------------------------------------------------------------- refit

    def checkpoint_path(self, generation: Optional[int] = None) -> Optional[str]:
        if not self.checkpoint_dir:
            return None
        gen = self.generation if generation is None else generation
        return os.path.join(self.checkpoint_dir, f"refit_gen{gen:04d}.txt")

    def step(self):
        """Refit if enough fresh rows landed; returns the new Booster or
        None when below the threshold."""
        fresh = self.store.total_rows - self._trained_rows
        if self.booster is not None and fresh < self.min_new_rows \
                and self._inflight_rows is None:
            return None
        return self.refit()

    def refit(self):
        """One generation: snapshot -> train (checkpointed) -> gate ->
        publish."""
        follow = getattr(self.store, "follow_gang", None)
        if follow is not None:
            # a gang-sharded store whose gang shrank (a refit resumed after a
            # lost worker) is resharded over the survivors first
            follow()
        if self._inflight_rows is None:
            # fresh generation boundary: the ONLY place a bin refresh may
            # run. A crash-resumed refit skips this branch (the watermark
            # is still pinned), so the resume replays against the exact
            # mapper generation the crashed attempt trained under — the
            # sidecar's bin_mapper_generation verifies it below.
            due = (self.refresh_every > 0 and self.generation > 0
                   and self.generation % self.refresh_every == 0)
            self.store.maybe_refresh_bins(force=due)
            self._inflight_rows = self.store.total_rows
            if self.holdout_rows > 0 and self.booster is not None:
                # pin the holdout with the watermark: the gate must score
                # candidate and serving model on the same frozen window
                self._inflight_holdout = self.store.holdout_snapshot()
        rows = self._inflight_rows
        holdout = self._inflight_holdout
        train_rows = rows
        if holdout is not None:
            # recent rows are held out of training so the gate is honest
            train_rows = max(1, rows - len(holdout[1]))
        core = self.store.finalize(train_rows)
        train_set = wrap_dataset(core, params=self.params)
        callbacks = []
        init_model = None
        ckpt = self.checkpoint_path()
        if ckpt:
            os.makedirs(self.checkpoint_dir, exist_ok=True)
            callbacks.append(checkpoint_callback(
                ckpt, period=self.checkpoint_period,
                extra_manifest={
                    "stream_generation": self.generation,
                    "bin_mapper_generation": self.store.layout_generation,
                }))
            if os.path.exists(ckpt):
                # a crashed refit of THIS generation left a snapshot:
                # resume it (engine.train subtracts finished iterations
                # and replays the remainder bit-identically)
                init_model = ckpt
                Log.info("continuous: resuming generation %d from %s",
                         self.generation, ckpt)
                self._check_resume_mapper_generation(ckpt)
        try:
            with global_timer.scope("stream_refit"):
                booster = engine.train(
                    self.params, train_set,
                    num_boost_round=self.num_boost_round,
                    init_model=init_model, callbacks=callbacks)
        except WorkerLostError as exc:
            # a gang peer died mid-refit: roll this generation back to its
            # pinned checkpoint. The watermark stays pinned and the
            # generation counter does NOT advance, so the next refit()
            # resumes the SAME row range from the same-generation snapshot;
            # serving keeps answering from the last published model the
            # whole time (nothing was swapped).
            Log.warning("continuous: worker lost mid-refit of generation "
                        "%d (rank %d, last good iteration %d); generation "
                        "rolled back to its pinned checkpoint, serving "
                        "keeps the last published model", self.generation,
                        exc.rank, exc.last_good_iteration)
            tracing.note("stream_refit_worker_lost",
                         generation=self.generation, rank=exc.rank,
                         last_good_iteration=exc.last_good_iteration)
            if telemetry.enabled():
                telemetry.emit("stream_refit_worker_lost",
                               generation=self.generation, rank=exc.rank,
                               last_good_iteration=exc.last_good_iteration)
            global_timer.add_count("stream_refit_worker_lost", 1)
            return None
        booster = faults.maybe_poison_generation(booster, self.generation)
        if holdout is not None and not self._gate_accepts(booster, holdout):
            # quality gate rejected the candidate: roll the generation back
            # exactly like the lost-worker path. The watermark AND holdout
            # stay pinned (the retry scores the same frozen window), the
            # generation counter does not advance, and serving keeps the
            # last published model — the rejected candidate never answers
            # a single predict. The generation checkpoint on disk holds the
            # trained state, so the retry resumes instead of retraining.
            return None
        self._publish(booster)
        self.booster = booster
        # full watermark: held-out rows roll into the NEXT generation's
        # training window (they were only excluded from this one)
        self._trained_rows = rows
        self._inflight_rows = None
        self._inflight_holdout = None
        # emit first, bump after: the event and gauge must name the
        # generation this model was checkpointed and published as
        global_timer.set_count("stream_generation", self.generation)
        if telemetry.enabled():
            telemetry.emit("stream_refit", generation=self.generation,
                           rows=rows)
        self.generation += 1
        return booster

    def _check_resume_mapper_generation(self, ckpt: str) -> None:
        """Resume-path invariant: the sidecar's recorded bin-mapper
        generation must match the store's live one (refreshes are fenced
        to fresh generation boundaries, so in-process this always holds;
        a mismatch means the checkpoint came from another store lineage)."""
        try:
            manifest = read_sidecar_manifest(ckpt)
        except CheckpointError:
            return  # damaged sidecar: load_checkpoint degrades, not us
        if manifest is None:
            return
        want = manifest.get("bin_mapper_generation")
        if want is None or int(want) == self.store.layout_generation:
            return
        Log.warning("continuous: checkpoint %s was trained under bin-mapper "
                    "generation %s but the store is at %d; resume would "
                    "replay against different cut points", ckpt, want,
                    self.store.layout_generation)
        global_timer.add_count("stream_mapper_generation_mismatch", 1)
        tracing.note("stream_mapper_generation_mismatch",
                     checkpoint=int(want),
                     store=self.store.layout_generation)
        if telemetry.enabled():
            telemetry.emit("stream_mapper_generation_mismatch",
                           checkpoint=int(want),
                           store=self.store.layout_generation)

    def _gate_accepts(self, candidate, holdout) -> bool:
        """Score the candidate against the serving model on the pinned
        holdout window; False (with the full rejection paper trail) when
        it lands outside tolerance."""
        X, y = holdout
        objective = str(self.params.get("objective", ""))
        with global_timer.scope("stream_gate_eval"):
            cand_loss = health.prediction_loss(
                candidate.predict(X), y, objective)
            base_loss = health.prediction_loss(
                self.booster.predict(X), y, objective)
        if cand_loss <= base_loss * (1.0 + self.gate_tolerance) + 1e-12:
            return True
        reject = GenerationRejected(
            f"generation {self.generation}: holdout loss {cand_loss:.6g} "
            f"vs serving {base_loss:.6g} exceeds tolerance "
            f"{self.gate_tolerance:.3g}")
        Log.warning("continuous: %s; generation rolled back, serving keeps "
                    "the last published model", reject)
        tracing.note("stream_generation_rejected",
                     generation=self.generation,
                     candidate_loss=float(cand_loss),
                     serving_loss=float(base_loss),
                     tolerance=self.gate_tolerance)
        if telemetry.enabled():
            telemetry.emit("generation_rejected",
                           generation=self.generation,
                           candidate_loss=float(cand_loss),
                           serving_loss=float(base_loss),
                           tolerance=self.gate_tolerance,
                           holdout_rows=int(len(y)))
        global_timer.add_count("stream_generation_rejected", 1)
        tracing.dump_flight("generation_rejected")
        return False

    def _publish(self, booster) -> None:
        """Atomic hot swap into the serving front (nothing without one).
        With canary_fraction > 0 and a model already serving, the swap is
        staged: PredictionService routes a traffic fraction to the
        candidate and promotes (or auto-rolls-back) on its own evidence."""
        if self.service is not None:
            if self.canary_fraction > 0.0 and self.booster is not None:
                self.service.start_canary(
                    self.model_name, booster=booster,
                    fraction=self.canary_fraction,
                    promote_after=self.canary_promote_after)
            else:
                self.service.load_model(self.model_name, booster=booster)
        elif self.registry is not None:
            self.registry.load(self.model_name, booster=booster)
