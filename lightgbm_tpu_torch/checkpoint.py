"""Crash-consistent checkpoints: the whole trainer state, written atomically.

Counterpart of the JAX package's ``checkpoint.py``. A checkpoint is two
files:

* ``<path>``      — the model text (every tree), loadable by any LightGBM;
* ``<path>.ckpt`` — a sidecar: 8-byte magic ``LGBMCKPT`` + sha256(payload)
                    + an npz payload holding a JSON manifest (the iteration,
                    the early-stop and health state, the learner's scalars,
                    the world it was written in, the sha256 of the model
                    text) and the state arrays (train and valid scores, the
                    bag, the column sampler's MT19937 keys, the quantized
                    gradients' key, the objective's state: the xendcg
                    draw's iteration count, lambdarank's position biases).

Both are written atomically (temp file in the target directory, flush +
fsync, ``os.replace``, directory fsync, inside a bounded retry-with-backoff
loop), so a crash at any instant leaves the old file or the new one. The
fault-injection points (utils/faults.py: a transient write failure before
the temp file exists, a corrupted sidecar or truncated model text after the
write lands) sit inside that loop. A write, a resume and a resume on
another world are telemetry events. The
sidecar names the model text by its content hash: if either half is
missing, damaged or from another write, ``load_checkpoint`` drops the pair
with a warning and training falls back to continued training from the
model text alone. ``engine.train(init_model=<path>)`` with a valid sidecar
resumes bit-identically to the uninterrupted run; ``num_boost_round`` is
then the run's total. A checkpoint written on the card resumes on the card:
a different world (device kind, process count) is named in a warning, and
nothing moves the run to the CPU.

The serving registry checks an upload's content hash against the sidecar
manifest (`read_sidecar_manifest`).
"""
from __future__ import annotations

import hashlib
import io
import json
import os
import tempfile
import time
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np

from . import telemetry
from .fingerprint import world_fingerprint
from .utils import faults
from .utils.log import Log
from .utils.timer import global_timer

CKPT_MAGIC = b"LGBMCKPT"
CKPT_VERSION = 1
SIDECAR_SUFFIX = ".ckpt"
_BACKOFF_S = 0.05  # doubled per retry attempt


class CheckpointError(Exception):
    """Sidecar validation failure."""


# ------------------------------------------------------------ atomic writes

def _fsync_dir(dirname: str) -> None:
    """Durability of the os.replace itself: fsync the directory entry
    (best effort — some filesystems refuse O_RDONLY dir fsync)."""
    try:
        fd = os.open(dirname or ".", os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


@contextmanager
def atomic_open(path: str, mode: str = "w"):
    """Yield a temp-file handle in `path`'s directory; on clean exit flush +
    fsync + os.replace onto `path`, on failure unlink the temp file."""
    d = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=d, prefix=os.path.basename(path) + ".tmp.")
    try:
        with os.fdopen(fd, mode) as fh:
            yield fh
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    _fsync_dir(d)


def _atomic_write(path: str, data, mode: str, retries: int) -> None:
    """Whole-content atomic write with bounded retry-with-backoff."""
    last: Optional[OSError] = None
    for attempt in range(max(1, retries)):
        if attempt:
            time.sleep(_BACKOFF_S * (2 ** (attempt - 1)))
        try:
            faults.maybe_fail_write(path)
            with atomic_open(path, mode) as fh:
                fh.write(data)
            faults.maybe_corrupt_artifact(path)
            return
        except OSError as exc:
            last = exc
            Log.warning("Atomic write of %s failed (attempt %d/%d): %s",
                        path, attempt + 1, max(1, retries), exc)
    raise last


def atomic_write_text(path: str, text: str, retries: int = 3) -> None:
    _atomic_write(path, text, "w", retries)


def atomic_write_bytes(path: str, data: bytes, retries: int = 3) -> None:
    _atomic_write(path, data, "wb", retries)


# ------------------------------------------------------------- state model

@dataclass
class TrainerState:
    """Everything load_checkpoint recovered from a valid checkpoint."""

    iteration: int
    model_text: str
    score: np.ndarray
    valid_scores: List[np.ndarray]
    bag: Optional[np.ndarray]
    learner: Dict[str, Any]
    objective: Dict[str, Any]
    es: Optional[Dict[str, Any]]
    health: Optional[Dict[str, Any]]
    manifest: Dict[str, Any]


_model_only_warned = False


def save_checkpoint(booster, path: str) -> None:
    """Write a crash-consistent checkpoint of `booster` (a Booster, or a
    GBDT) to `path` and `path`.ckpt. A pending tree of the async pipeline
    is finalized first; the manifest records the pipeline's stop flag.
    DART and RF keep per-iteration state (drop weights, the running
    average) with no resume contract: their checkpoint is the model text
    alone, and resuming from it is continued training."""
    global _model_only_warned
    gbdt = getattr(booster, "_gbdt", booster)
    gbdt._flush_pending()
    model_text = gbdt.to_model().to_string(num_iteration=-1)
    with global_timer.scope("checkpoint_write"):
        atomic_write_text(path, model_text)
        if type(gbdt).__name__ != "GBDT":
            if not _model_only_warned:
                _model_only_warned = True
                Log.warning("Checkpoint for boosting type %s saves model "
                            "text only; resume will not be bit-identical",
                            type(gbdt).__name__)
            telemetry.emit("checkpoint", path=path, model_only=True,
                           iteration=int(gbdt.iter_))
            return
        arrays: Dict[str, np.ndarray] = {"score": gbdt.score.cpu().numpy()}
        for i, vd in enumerate(gbdt.valid_sets):
            arrays[f"valid_score_{i}"] = vd.score.cpu().numpy()
        # a plain bag (host indices) is reused inside its bagging_freq
        # window; GOSS draws from bagging_seed + iteration and keeps none
        bag = getattr(gbdt.sample_strategy, "_bag", None)
        if bag is not None:
            arrays["bag"] = np.asarray(bag, dtype=np.int32)
        learner_scalars: Dict[str, Any] = {}
        learner = getattr(gbdt, "tree_learner", None)
        if learner is not None and hasattr(learner, "snapshot_state"):
            for k, v in learner.snapshot_state().items():
                if isinstance(v, np.ndarray):
                    arrays[f"learner_{k}"] = v
                else:
                    learner_scalars[k] = v
        objective_scalars: Dict[str, Any] = {}
        if gbdt.objective is not None:
            for k, v in gbdt.objective.snapshot_state().items():
                if isinstance(v, np.ndarray):
                    arrays[f"objective_{k}"] = v
                else:
                    objective_scalars[k] = v
        health = getattr(gbdt, "_health", None)
        manifest = {
            "version": CKPT_VERSION,
            "iteration": int(gbdt.iter_),
            "num_class": int(gbdt.num_class),
            "num_tree_per_iteration": int(gbdt.num_tree_per_iteration),
            "num_data": int(getattr(gbdt, "num_data", -1)),
            "boosting": type(gbdt).__name__,
            "model_sha256": hashlib.sha256(model_text.encode()).hexdigest(),
            "valid_names": list(gbdt.valid_names),
            "async_stub_stop": bool(gbdt._async_stub_stop),
            "learner": learner_scalars,
            "objective": objective_scalars,
            "es": getattr(booster, "_early_stop_state", None),
            "health": health.snapshot() if health is not None else None,
            "world": world_fingerprint(gbdt.device),
        }
        buf = io.BytesIO()
        np.savez_compressed(
            buf, manifest=np.frombuffer(json.dumps(manifest).encode("utf-8"),
                                        dtype=np.uint8),
            **arrays)
        payload = buf.getvalue()
        blob = CKPT_MAGIC + hashlib.sha256(payload).digest() + payload
        atomic_write_bytes(path + SIDECAR_SUFFIX, blob)
    telemetry.emit("checkpoint", path=path, model_only=False,
                   iteration=int(gbdt.iter_), sidecar_bytes=len(blob))


# ------------------------------------------------------------ sidecar read

def _load_sidecar_payload(sidecar: str):
    """Validate a sidecar blob (magic + payload sha256) and return its
    manifest and npz."""
    with open(sidecar, "rb") as fh:
        blob = fh.read()
    if blob[:len(CKPT_MAGIC)] != CKPT_MAGIC:
        raise CheckpointError("bad magic")
    digest = blob[len(CKPT_MAGIC):len(CKPT_MAGIC) + 32]
    payload = blob[len(CKPT_MAGIC) + 32:]
    if hashlib.sha256(payload).digest() != digest:
        raise CheckpointError("payload checksum mismatch")
    z = np.load(io.BytesIO(payload), allow_pickle=False)
    manifest = json.loads(bytes(z["manifest"].tobytes()).decode("utf-8"))
    if int(manifest.get("version", -1)) != CKPT_VERSION:
        raise CheckpointError(
            "unsupported checkpoint version %r" % manifest.get("version"))
    return manifest, z


def read_sidecar_manifest(path: str) -> Optional[Dict[str, Any]]:
    """Serving-upload verifier: the validated sidecar manifest for the
    model text at `path`, or None when no ``.ckpt`` sidecar exists.

    A sidecar that exists but is damaged raises CheckpointError: for a
    serving upload that means REJECT, because a model swap must never
    promote bytes the writer did not produce."""
    sidecar = path + SIDECAR_SUFFIX
    if not os.path.exists(sidecar):
        return None
    manifest, _ = _load_sidecar_payload(sidecar)
    return manifest


def load_checkpoint(path: str) -> Optional[TrainerState]:
    """Validate and load the checkpoint at `path`. Returns None when the
    sidecar is absent, and None with a warning naming the failed invariant
    when it is unusable, so the caller falls back to continued training."""
    sidecar = path + SIDECAR_SUFFIX
    if not os.path.exists(sidecar):
        return None
    try:
        manifest, z = _load_sidecar_payload(sidecar)
        with open(path) as fh:
            model_text = fh.read()
        if hashlib.sha256(model_text.encode()).hexdigest() != manifest["model_sha256"]:
            raise CheckpointError("model text does not match the sidecar's content hash "
                                  "(the two files are from different writes)")
        valid_scores = [np.asarray(z[f"valid_score_{i}"])
                        for i in range(len(manifest.get("valid_names", [])))]
        learner: Dict[str, Any] = dict(manifest.get("learner", {}))
        objective: Dict[str, Any] = dict(manifest.get("objective", {}))
        for k in z.files:
            if k.startswith("learner_"):
                learner[k[len("learner_"):]] = np.asarray(z[k])
            elif k.startswith("objective_"):
                objective[k[len("objective_"):]] = np.asarray(z[k])
        return TrainerState(
            iteration=int(manifest["iteration"]), model_text=model_text,
            score=np.asarray(z["score"]), valid_scores=valid_scores,
            bag=np.asarray(z["bag"]) if "bag" in z.files else None,
            learner=learner, objective=objective, es=manifest.get("es"),
            health=manifest.get("health"),
            manifest=manifest)
    except Exception as exc:  # noqa: BLE001 - any damage means "no sidecar"
        Log.warning("Checkpoint sidecar %s is unusable (%s); falling back "
                    "to plain continued training from the model file", sidecar, exc)
        return None


def restore_trainer_state(booster, state: TrainerState, callbacks=()) -> int:
    """Put `state` onto a freshly built booster: the trees and the
    iteration, the float32 train and valid scores (on the booster's
    device), the bag, the learner's random streams, the objective's state,
    the async pipeline's stop flag, the health monitor's clip and the
    early-stop state. Returns
    the iteration to resume from. A checkpoint of another boosting type,
    row count, trees an iteration or valid-set list is refused with the
    invariant named: a resume that silently diverges is worse than none."""
    import torch

    from .models.serialize import GBDTModel

    gbdt = getattr(booster, "_gbdt", booster)
    man = state.manifest
    if man.get("boosting") != type(gbdt).__name__:
        Log.fatal("Checkpoint was written by boosting type %s but the "
                  "resume run built %s — refusing to resume",
                  man.get("boosting"), type(gbdt).__name__)
    if int(man["num_data"]) != int(gbdt.num_data):
        Log.fatal("Checkpoint was written for %d training rows but the "
                  "resume dataset has %d — refusing to resume",
                  int(man["num_data"]), int(gbdt.num_data))
    if int(man["num_tree_per_iteration"]) != int(gbdt.num_tree_per_iteration):
        Log.fatal("Checkpoint has %d trees/iteration but the resume run "
                  "has %d — refusing to resume",
                  int(man["num_tree_per_iteration"]), int(gbdt.num_tree_per_iteration))
    if list(man.get("valid_names", [])) != list(gbdt.valid_names):
        Log.fatal("Checkpoint valid sets %s do not match the resume call's "
                  "%s (same valid_sets, same order, same names required)",
                  man.get("valid_names"), gbdt.valid_names)
    saved_world = man.get("world")
    if saved_world is not None:
        here = world_fingerprint(gbdt.device)
        keys = ("process_count", "mesh_shape", "device_kinds")
        if any(saved_world.get(k) != here.get(k) for k in keys):
            Log.warning("Checkpoint was written under world %s but is being "
                        "restored under %s; the float32 sums of another "
                        "device may not resume bit-identically",
                        {k: saved_world.get(k) for k in keys},
                        {k: here.get(k) for k in keys})
            telemetry.emit("checkpoint_world_mismatch", saved=saved_world,
                           current=here, iteration=int(state.iteration))
    gbdt.models = GBDTModel.from_string(state.model_text).trees
    gbdt.iter_ = int(state.iteration)
    gbdt._async_stub_stop = bool(man.get("async_stub_stop", False))
    gbdt.score.copy_(torch.from_numpy(np.asarray(state.score, dtype=np.float32)))
    for vd, s in zip(gbdt.valid_sets, state.valid_scores):
        vd.score.copy_(torch.from_numpy(np.asarray(s, dtype=np.float32)))
    if state.bag is not None and hasattr(gbdt.sample_strategy, "_bag"):
        gbdt.sample_strategy._bag = np.asarray(state.bag, dtype=np.int32)
    learner = getattr(gbdt, "tree_learner", None)
    if learner is not None and hasattr(learner, "restore_snapshot_state"):
        learner.restore_snapshot_state(state.learner)
    if gbdt.objective is not None:
        gbdt.objective.restore_snapshot_state(state.objective)
    health = getattr(gbdt, "_health", None)
    if health is not None and state.health is not None:
        health.restore(state.health)
    for cb in callbacks or ():
        if getattr(cb, "_accepts_state_restore", False):
            cb._pending_restore = state.es
    gbdt._predictor.invalidate()
    Log.info("Resumed trainer state from checkpoint: iteration %d, %d trees",
             gbdt.iter_, len(gbdt.models))
    telemetry.emit("checkpoint_resume", iteration=int(state.iteration),
                   num_trees=len(gbdt.models))
    return int(state.iteration)


# ---------------------------------------------------------------- callback

def checkpoint_callback(path: Union[str, Callable[[int], str]], period: int = 1) -> Callable:
    """After-iteration callback writing a checkpoint every `period`
    iterations. `path` is a file name, or a function of the 1-based count
    of finished iterations giving one. It runs at order 40, after early
    stopping (30), so the checkpoint carries the newest early-stop state
    and an iteration that stops is never saved."""
    if period <= 0:
        raise ValueError("checkpoint period must be positive")

    def _callback(env) -> None:
        it = env.iteration + 1
        if it % period != 0:
            return
        if not hasattr(env.model, "_gbdt"):
            return  # a CVBooster: its folds have no single state
        target = path(it) if callable(path) else path
        save_checkpoint(env.model, target)

    _callback.order = 40
    _callback.before_iteration = False
    return _callback
