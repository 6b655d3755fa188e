"""Numerical-health guardrails for the boosting loop, and the serving check.

Counterpart of the JAX package's ``health.py``. A diverging run looks like
this: one bad gradient wave (overflow in a custom objective, a NaN that
slipped past ingest) turns the root histogram's totals NaN, every split
gain goes NaN, the learner grows stub trees, and the run "converges" to
garbage. With ``health_check_policy`` set the GBDT gates every iteration
through a `HealthMonitor`:

* **observe** — on-device finiteness reductions over the iteration's
  gradients, hessians and score, AND-ed into one device bool with no
  synchronization.
* **admit** — every ``health_check_every`` iterations the bool reaches the
  host once, with the host-side check of the committed trees' leaf values
  and split gains (`observe_tree`). On failure the policy runs:

  - ``fatal``    — raise, naming the iteration;
  - ``warn``     — log and carry on;
  - ``rollback`` — restore the last healthy backup (copies of the score
                   arrays and the model list's length, taken at each
                   healthy check), recompute the gradients from the
                   restored scores and go on with NaN-scrubbed gradients
                   clipped to ``GRAD_CLIP`` from then on.

Each check is a ``health_check`` telemetry event and a rollback a
``health_rollback`` event, a flight-recorder note and a flight dump. The
elastic heartbeat (parallel/elastic.py) rides the check: its one-element
all-reduce runs after the check's one scalar read, so it adds no host
read of its own.

`first_nonfinite_column` is the serving boundary's use of the same check.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from . import telemetry, tracing
from .utils.log import Log

_POLICIES = ("fatal", "warn", "rollback")
GRAD_CLIP = 1e6  # the clip bound of gradients and hessians after a rollback


def first_nonfinite_column(X) -> Optional[int]:
    """Column index of the first non-finite value in a host batch, or None.

    A prediction service with ``reject_nonfinite`` enabled runs this on
    every request payload BEFORE admission, so a NaN/inf row gets a typed
    400 naming the offending column instead of a device dispatch. One
    vectorized isfinite pass on host — NaN stays a legitimate missing value
    for models that opted out."""
    finite = np.isfinite(X)
    if finite.all():
        return None
    return int(np.argmax(~finite.all(axis=0)))


def prediction_loss(preds, y, objective: str = "") -> float:
    """Scalar holdout loss of the streaming publish gate
    (streaming/continuous.py): clipped logloss for the binary and
    cross-entropy objectives, mean squared error otherwise, in float64 on
    the host. A non-finite prediction scores +inf, so a candidate that emits
    NaN never passes the gate."""
    preds = np.asarray(preds, dtype=np.float64).ravel()
    y = np.asarray(y, dtype=np.float64).ravel()
    if preds.shape != y.shape or len(y) == 0 or not np.isfinite(preds).all():
        return float("inf")
    if objective in ("binary", "cross_entropy", "xentropy"):
        p = np.clip(preds, 1e-7, 1.0 - 1e-7)
        return float(-np.mean(y * np.log(p) + (1.0 - y) * np.log(1.0 - p)))
    return float(np.mean((preds - y) ** 2))


def create_monitor(config) -> Optional["HealthMonitor"]:
    """The configuration's monitor, or None when no policy is set."""
    policy = str(getattr(config, "health_check_policy", "") or "").strip()
    if not policy:
        return None
    if policy not in _POLICIES:
        Log.fatal("Unknown health_check_policy %r (choose one of %s)",
                  policy, "/".join(_POLICIES))
    return HealthMonitor(policy, int(getattr(config, "health_check_every", 10)))


class HealthMonitor:
    def __init__(self, policy: str, check_every: int = 10) -> None:
        self.policy = policy
        self.check_every = max(1, int(check_every))
        self.clip_on = False  # set for good after a rollback
        self._acc: Optional[torch.Tensor] = None  # device bool: AND of the observations
        self._host_ok = True  # the committed trees' outputs
        self._since_check = 0
        self._backup = None   # (iter_, n_models, score, [valid scores])

    # ------------------------------------------------------------ observers

    def observe(self, *tensors) -> None:
        """Fold the finiteness of device tensors into the accumulator, with
        no synchronization."""
        for a in tensors:
            if a is None:
                continue
            ok = torch.isfinite(a).all()
            self._acc = ok if self._acc is None else self._acc & ok

    def observe_tree(self, tree) -> None:
        """Host-side finiteness of a committed tree's leaf values and split
        gains: the tree is on the host already, so this costs no sync."""
        n = int(tree.num_leaves)
        if n <= 0:
            return
        finite = np.isfinite(tree.leaf_value[:n]).all()
        if finite and n > 1:
            finite = np.isfinite(tree.split_gain[:n - 1]).all()
        if not finite:
            self._host_ok = False

    # ---------------------------------------------------------------- admit

    def admit(self, gbdt, grads: torch.Tensor, hesses: torch.Tensor):
        """Gate iteration `gbdt.iter_`'s gradients [C, N]: called after the
        gradient pass and before bagging and growth, so an unhealthy
        iteration is caught before it grows a tree. Returns the gradients
        to train on."""
        self.observe(grads, hesses, gbdt.score)
        self._since_check += 1
        if self._since_check >= self.check_every:
            # the one synchronization a window
            healthy = (self._acc is None or bool(self._acc)) and self._host_ok
            self._acc = None
            self._host_ok = True
            self._since_check = 0
            telemetry.emit("health_check", healthy=healthy, policy=self.policy,
                           iteration=int(gbdt.iter_))
            from .parallel import elastic

            rt = elastic.active()
            if rt is not None:
                rt.heartbeat_sync(int(gbdt.iter_))
            if not healthy:
                grads, hesses = self._handle(gbdt, grads, hesses)
            elif self.policy == "rollback":
                self._take_backup(gbdt)
        if self.clip_on:
            grads, hesses = self._sanitize(grads, hesses)
        return grads, hesses

    # ------------------------------------------------------------- handlers

    def _handle(self, gbdt, grads, hesses):
        it = int(gbdt.iter_)
        if self.policy == "fatal":
            Log.fatal("Numerical health check failed at iteration %d: "
                      "non-finite values in gradients/hessians/scores or "
                      "committed tree outputs", it)
        if self.policy == "warn":
            Log.warning("Numerical health check failed at iteration %d "
                        "(policy=warn: continuing)", it)
            return grads, hesses
        # rollback: the last healthy backup, then gradients from its scores
        gbdt._flush_pending()
        rolled = self._restore_backup(gbdt)
        Log.warning("Numerical health check failed at iteration %d; rolled "
                    "back %d iteration(s) to %d and re-boosting with "
                    "clipped gradients", it, rolled, int(gbdt.iter_))
        telemetry.emit("health_rollback", iteration=it, rolled_back=int(rolled),
                       resumed_at=int(gbdt.iter_))
        tracing.note("health_rollback", iteration=it, rolled_back=int(rolled),
                     resumed_at=int(gbdt.iter_))
        tracing.dump_flight("health_rollback")
        self.clip_on = True
        if gbdt.objective is not None:
            grads, hesses = gbdt._compute_gh()
        return self._sanitize(grads, hesses)

    @staticmethod
    def _sanitize(grads: torch.Tensor, hesses: torch.Tensor):
        g = torch.clamp(torch.nan_to_num(grads, nan=0.0, posinf=GRAD_CLIP, neginf=-GRAD_CLIP),
                        -GRAD_CLIP, GRAD_CLIP)
        h = torch.clamp(torch.nan_to_num(hesses, nan=0.0, posinf=GRAD_CLIP, neginf=0.0),
                        0.0, GRAD_CLIP)
        return g, h

    # -------------------------------------------------------------- backups

    def _take_backup(self, gbdt) -> None:
        """Copies of the scores at a healthy check. A pending tree is
        finalized first: its valid-score update is deferred to the flush,
        and a backup without it would restore valid scores that lack a tree
        the model keeps (the JAX package's backup has that gap, ROADMAP
        Queue 3)."""
        gbdt._flush_pending()
        self._backup = (int(gbdt.iter_), len(gbdt.models), gbdt.score.clone(),
                        [vd.score.clone() for vd in gbdt.valid_sets])

    def _restore_backup(self, gbdt) -> int:
        if self._backup is None:
            # no healthy check yet: nothing to go back to, so scrub the live
            # scores in place and re-boost from them
            torch.nan_to_num(gbdt.score, nan=0.0, posinf=GRAD_CLIP, neginf=-GRAD_CLIP,
                             out=gbdt.score)
            for vd in gbdt.valid_sets:
                torch.nan_to_num(vd.score, nan=0.0, posinf=GRAD_CLIP, neginf=-GRAD_CLIP,
                                 out=vd.score)
            return 0
        it, n_models, score, valid_scores = self._backup
        rolled = int(gbdt.iter_) - it
        del gbdt.models[n_models:]
        gbdt.iter_ = it
        gbdt.score.copy_(score)
        for vd, s in zip(gbdt.valid_sets, valid_scores):
            vd.score.copy_(s)
        gbdt._predictor.invalidate()
        self._backup = None  # consumed; the next healthy check takes another
        return rolled

    # -------------------------------------------------------- checkpointing

    def snapshot(self) -> Dict[str, Any]:
        return {"clip_on": bool(self.clip_on)}

    def restore(self, state: Dict[str, Any]) -> None:
        self.clip_on = bool(state.get("clip_on", False))
