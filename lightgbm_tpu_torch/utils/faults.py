"""Deterministic fault injection for the fault-tolerance tests and smoke.

Counterpart of the JAX package's ``utils/faults.py``. A FaultPlan is parsed
from a comma-separated spec, installed programmatically (``install`` /
``clear``) or read once from ``LGBM_TPU_FAULT`` with ``LGBM_TPU_FAULT_SEED``
seeding the poisoning draw. Tokens:

    kill@K              raise InjectedFault at the START of iteration K
                        (the mid-train process-kill stand-in)
    nan_gh@K[:frac]     poison `frac` of the gradient/hessian rows with NaN
                        after iteration K's gradient pass (default 1%)
    ckpt_write_fail:N   the next N atomic writes raise OSError before the
                        temp file is created (a transient disk failure the
                        retry-with-backoff writer must absorb)
    ckpt_corrupt        flip bytes in the middle of the next checkpoint
                        sidecar AFTER it is durably written
    ckpt_truncate       truncate the next model-text artifact to half its
                        size AFTER it is durably written

Serving faults; the dispatch counter counts device dispatches through the
serving batcher, 1-based:

    slow_predict@N[:secs]    every device dispatch from the Nth onward
                             sleeps `secs` (default 0.05) first
    predict_fail@N[:count]   dispatches N..N+count-1 raise InjectedFault
                             (default count 3): trips the circuit breaker,
                             then lets it recover once the window passes
    model_corrupt_upload     garble the NEXT staged model upload before the
                             registry verifies it (one-shot)

Streaming faults (``streaming/``):

    drift_shift@K:F     every pushed row with absolute index >= K gets
                        feature F shifted (x*3 + 10) out of the fitted bin
                        support: the drift monitor must alarm and a bin
                        refresh re-resolve it (fires on every push; emits
                        once)
    bad_generation@G    the refit that would publish generation G has its
                        trained model poisoned in memory (leaf values
                        sign-flipped and scaled 1e6) after training and
                        checkpointing: only the holdout gate stands between
                        it and serving (one-shot)
    sketch_corrupt@K    plant non-finite values inside feature K's quantile
                        sketch: the next bin refresh must detect it and keep
                        the feature's cut points (one-shot)

Distributed faults (parallel/elastic.py); ranks come from ``RANK`` (the
launcher's), and the kill/hang pair fires only on gang attempt 0
(``LGBM_TPU_GANG_ATTEMPT``), so an elastic restart that resumes at the
fault iteration does not die again:

    worker_kill@R:K     rank R dies at the START of iteration K: os._exit(43)
                        under gang supervision (no unwind, no atexit, as a
                        SIGKILL), a raised InjectedFault otherwise
    worker_hang@R:K     rank R stops taking part at iteration K but stays
                        alive: an interruptible spin that polls the elastic
                        watchdog (the WorkerLostError conversion path)
    coord_loss@K        the coordinator (rank 0) dies at iteration K:
                        worker_kill@0:K
    slow_worker@R:ms    rank R sleeps `ms` milliseconds at the start of
                        every iteration (a straggler; fires on every attempt)
    vote_skew@R:K       the voting learner's rank R nominates garbage
                        features at wave K (0 the root). With
                        LGBM_TPU_VOTING_EXACT_CHECK=1 it surfaces as
                        VotingDivergenceError with the counted divergence;
                        under an elastic gang without the check the
                        detecting rank parks in the watchdog's spin (the
                        worker_hang path), never a silent hang

Every injection is one-shot (``kill@K`` fires once even if iteration K is
re-entered after a rollback) and seeded, so a failing test replays
exactly. With no plan armed every hook is a few attribute reads.
"""
from __future__ import annotations

import os
from typing import Optional

from .log import Log


class InjectedFault(RuntimeError):
    """Raised by the kill and predict_fail injection points; stands in for
    SIGKILL or a device error (what a real kill leaves is the checkpoint
    files on disk)."""


class VotingDivergenceError(RuntimeError):
    """Raised by the voting learner's exact check when an armed vote_skew
    plan corrupted a PV-Tree ballot. The message carries the counted
    committed-split disagreements, which may be 0 (one corrupted ballot is
    often outvoted): a tampered election never trains on silently."""


# the exit code of an injected worker_kill under gang supervision, distinct
# from crash codes so the supervisor's log names the injection
EXIT_INJECTED_KILL = 43


def _int_env(name: str) -> int:
    try:
        return int(os.environ.get(name, "0") or 0)
    except ValueError:
        return 0


def _rank() -> int:
    return _int_env("RANK")


def _gang_attempt() -> int:
    return _int_env("LGBM_TPU_GANG_ATTEMPT")


def _rank_iter(token: str, prefix: str, value=int):
    """Parse a ``prefix<rank>:<n>`` token; malformed specs are fatal (a
    typo'd token silently arming nothing would fake a green run)."""
    body = token[len(prefix):]
    try:
        r, v = body.split(":", 1)
        return int(r), value(v)
    except ValueError:
        Log.fatal("Malformed fault token %r: expected %s<rank>:<n>", token, prefix)


class FaultPlan:
    def __init__(self, spec: str = "", seed: int = 0) -> None:
        self.spec = spec or ""
        self.seed = int(seed)
        self.kill_at: Optional[int] = None
        self.nan_at: Optional[int] = None
        self.nan_frac = 0.01
        self.write_fails = 0
        self.corrupt_sidecar = False
        self.truncate_model = False
        self.worker_kill = None  # (rank, iteration)
        self.worker_hang = None  # (rank, iteration)
        self.slow_worker = None  # (rank, seconds)
        self.vote_skew = None  # (rank, wave)
        self.slow_predict_at: Optional[int] = None
        self.slow_predict_s = 0.05
        self.fail_predict_at: Optional[int] = None
        self.fail_predict_count = 3
        self.corrupt_upload = False
        self.drift_shift = None  # (start_row, feature)
        self.bad_generation: Optional[int] = None
        self.sketch_corrupt: Optional[int] = None
        self._dispatch_no = 0  # serving device-dispatch counter (1-based)
        self._fired = set()
        for token in (t.strip() for t in self.spec.split(",")):
            if not token:
                continue
            if token.startswith("kill@"):
                self.kill_at = int(token[len("kill@"):])
            elif token.startswith("nan_gh@"):
                body = token[len("nan_gh@"):]
                if ":" in body:
                    it, frac = body.split(":", 1)
                    self.nan_at, self.nan_frac = int(it), float(frac)
                else:
                    self.nan_at = int(body)
            elif token.startswith("ckpt_write_fail:"):
                self.write_fails = int(token.split(":", 1)[1])
            elif token == "ckpt_corrupt":
                self.corrupt_sidecar = True
            elif token == "ckpt_truncate":
                self.truncate_model = True
            elif token.startswith("slow_predict@"):
                body = token[len("slow_predict@"):]
                if ":" in body:
                    at, secs = body.split(":", 1)
                    self.slow_predict_at, self.slow_predict_s = int(at), float(secs)
                else:
                    self.slow_predict_at = int(body)
            elif token.startswith("predict_fail@"):
                body = token[len("predict_fail@"):]
                if ":" in body:
                    at, cnt = body.split(":", 1)
                    self.fail_predict_at, self.fail_predict_count = int(at), int(cnt)
                else:
                    self.fail_predict_at = int(body)
            elif token == "model_corrupt_upload":
                self.corrupt_upload = True
            elif token.startswith("worker_kill@"):
                self.worker_kill = _rank_iter(token, "worker_kill@")
            elif token.startswith("worker_hang@"):
                self.worker_hang = _rank_iter(token, "worker_hang@")
            elif token.startswith("coord_loss@"):
                try:
                    self.worker_kill = (0, int(token[len("coord_loss@"):]))
                except ValueError:
                    Log.fatal("Malformed fault token %r: expected coord_loss@<n>", token)
            elif token.startswith("slow_worker@"):
                r, ms = _rank_iter(token, "slow_worker@", value=float)
                self.slow_worker = (r, ms / 1e3)
            elif token.startswith("vote_skew@"):
                self.vote_skew = _rank_iter(token, "vote_skew@")
            elif token.startswith("drift_shift@"):
                self.drift_shift = _rank_iter(token, "drift_shift@")
            elif token.startswith("bad_generation@"):
                self.bad_generation = int(token[len("bad_generation@"):])
            elif token.startswith("sketch_corrupt@"):
                self.sketch_corrupt = int(token[len("sketch_corrupt@"):])
            else:
                Log.fatal("Unknown fault token %r in fault spec %r", token, self.spec)

    def once(self, key: str) -> bool:
        if key in self._fired:
            return False
        self._fired.add(key)
        return True


_plan: Optional[FaultPlan] = None


def _get() -> FaultPlan:
    global _plan
    if _plan is None:
        _plan = FaultPlan(os.environ.get("LGBM_TPU_FAULT", ""),
                          int(os.environ.get("LGBM_TPU_FAULT_SEED", "0")))
    return _plan


def install(spec: str, seed: int = 0) -> FaultPlan:
    """Arm a fault plan programmatically."""
    global _plan
    _plan = FaultPlan(spec, seed)
    return _plan


def clear() -> None:
    """Disarm; the next hook re-reads the environment."""
    global _plan
    _plan = None


# ------------------------------------------------------------------- hooks

def check_kill(iteration: int) -> None:
    """Injection point at the start of GBDT.train_one_iter."""
    p = _get()
    if p.kill_at is not None and iteration == p.kill_at and p.once("kill"):
        _emit_fault("kill", iteration=iteration)
        raise InjectedFault(f"injected fault: kill at iteration {iteration}")


def _watchdog_spin() -> None:
    """Block on purpose, interruptibly: poll the elastic watchdog, which
    raises its WorkerLostError here once the deadline passes."""
    import time

    from ..parallel import elastic

    while True:
        time.sleep(0.01)
        rt = elastic.active()
        if rt is not None:
            rt.poll_raise()


def check_distributed(iteration: int) -> None:
    """Injection point at the start of GBDT.train_one_iter, after
    check_kill: the distributed tokens. Kill and hang fire on gang attempt
    0 only (a relaunched gang resumes at the fault iteration and must not
    die again); the straggler fires on every attempt."""
    p = _get()
    if p.worker_kill is None and p.worker_hang is None and p.slow_worker is None:
        return
    rank = _rank()
    attempt0 = _gang_attempt() == 0
    if p.slow_worker is not None and rank == p.slow_worker[0]:
        import time

        _emit_fault("slow_worker", rank=rank, iteration=iteration, seconds=p.slow_worker[1])
        time.sleep(p.slow_worker[1])
    if attempt0 and p.worker_kill is not None and (rank, iteration) == p.worker_kill \
            and p.once("worker_kill"):
        _emit_fault("worker_kill", rank=rank, iteration=iteration)
        Log.warning("Fault injection: killing rank %d at iteration %d", rank, iteration)
        if os.environ.get("LGBM_TPU_GANG"):
            os._exit(EXIT_INJECTED_KILL)  # a SIGKILL's semantics: no unwind, no flush
        raise InjectedFault(f"injected fault: worker {rank} killed at iteration {iteration}")
    if attempt0 and p.worker_hang is not None and (rank, iteration) == p.worker_hang \
            and p.once("worker_hang"):
        _emit_fault("worker_hang", rank=rank, iteration=iteration)
        Log.warning("Fault injection: rank %d hanging at iteration %d (interruptible spin)",
                    rank, iteration)
        _watchdog_spin()


def vote_skew_params():
    """(rank, wave) of an armed vote_skew plan, else None: the voting
    learner replaces rank `rank`'s nominations with garbage at wave `wave`
    (0 the root)."""
    return _get().vote_skew


def check_vote_skew_surfaced(miss_total: int, exact_check: bool) -> None:
    """The voting learner's finalize hook: an armed vote_skew plan surfaces
    as a typed error, never a hang or a silent loss of quality. With the
    exact check it raises VotingDivergenceError carrying the counted
    divergence; without it, under an elastic gang, the detecting rank parks
    in the watchdog's spin until the supervisor declares it lost (the
    worker_hang path). With neither, the corruption only shifts split
    quality, which the exact check's counter exists to measure. One-shot."""
    p = _get()
    if p.vote_skew is None or not p.once("vote_skew"):
        return
    rank, wave = p.vote_skew
    _emit_fault("vote_skew", rank=rank, wave=wave, miss=int(miss_total),
                exact_check=exact_check)
    if exact_check:
        raise VotingDivergenceError(
            f"injected fault: vote_skew@{rank}:{wave} corrupted a PV-Tree ballot "
            f"({int(miss_total)} committed-split disagreement(s) counted by the exact check)")
    from ..parallel import elastic

    if elastic.active() is None:
        Log.warning("vote_skew@%d:%d armed without the exact check or an elastic gang: the "
                    "corruption is measured nowhere (arm LGBM_TPU_VOTING_EXACT_CHECK=1 to "
                    "count it)", rank, wave)
        return
    Log.warning("Fault injection: vote_skew@%d:%d under an elastic gang: parking in the "
                "watchdog's spin", rank, wave)
    _watchdog_spin()


def maybe_poison_gh(grads, hesses, iteration: int):
    """Injection point after the gradient pass: NaN a seeded subset of the
    rows (the last axis) of a copy of the gradients and hessians. One-shot,
    so a rollback's recomputed gradients are clean. The rows are the JAX
    package's for the same seed and iteration."""
    p = _get()
    if p.nan_at is None or iteration != p.nan_at or not p.once("nan_gh"):
        return grads, hesses
    import numpy as np
    import torch

    n = int(grads.shape[-1])
    k = max(1, int(round(p.nan_frac * n)))
    rng = np.random.RandomState(p.seed + iteration)
    idx = np.sort(rng.choice(n, k, replace=False)).astype(np.int64)
    Log.warning("Fault injection: poisoning %d/%d gradient rows with NaN "
                "at iteration %d", k, n, iteration)
    _emit_fault("nan_gh", iteration=iteration, rows=k)
    rows = torch.from_numpy(idx).to(grads.device)
    grads, hesses = grads.clone(), hesses.clone()
    grads[..., rows] = float("nan")
    hesses[..., rows] = float("nan")
    return grads, hesses


def maybe_fail_write(path: str) -> None:
    """Injection point inside the atomic writer's retry loop, before the
    temp file exists: a transient host-side write failure."""
    p = _get()
    if p.write_fails > 0:
        p.write_fails -= 1
        _emit_fault("write_fail", path=path)
        raise OSError(f"injected fault: transient write failure for {path}")


def maybe_corrupt_artifact(path: str) -> None:
    """Injection point after an atomic write lands: corrupt the sidecar or
    truncate the model text, on-disk damage the loader must detect
    (checksum, fail-fast parse) rather than crash on."""
    p = _get()
    is_sidecar = path.endswith(".ckpt")
    if p.corrupt_sidecar and is_sidecar and p.once("corrupt"):
        with open(path, "rb") as fh:
            data = bytearray(fh.read())
        mid = len(data) // 2
        for i in range(mid, min(mid + 16, len(data))):
            data[i] ^= 0xFF
        with open(path, "wb") as fh:  # damages the artifact in place, on purpose
            fh.write(bytes(data))
        Log.warning("Fault injection: corrupted checkpoint sidecar %s", path)
        _emit_fault("corrupt", path=path)
    elif p.truncate_model and not is_sidecar and p.once("truncate"):
        size = os.path.getsize(path)
        with open(path, "rb+") as fh:
            fh.truncate(size // 2)
        Log.warning("Fault injection: truncated %s to %d bytes", path, size // 2)
        _emit_fault("truncate", path=path)


def on_serve_dispatch() -> None:
    """Injection point just before a serving device dispatch (one call per
    chunk the micro-batcher sends to the device). Counts dispatches and
    applies the armed slow and fail faults in that order."""
    p = _get()
    if p.slow_predict_at is None and p.fail_predict_at is None:
        return
    p._dispatch_no += 1
    no = p._dispatch_no
    if p.slow_predict_at is not None and no >= p.slow_predict_at:
        import time

        _emit_fault("slow_predict", dispatch=no, seconds=p.slow_predict_s)
        time.sleep(p.slow_predict_s)
    if p.fail_predict_at is not None and \
            p.fail_predict_at <= no < p.fail_predict_at + p.fail_predict_count:
        _emit_fault("predict_fail", dispatch=no)
        raise InjectedFault(f"injected fault: device dispatch {no} failed")


def maybe_corrupt_upload(text: str) -> str:
    """Injection point in the registry's staged-load path: garble the
    upload BEFORE verification (one-shot)."""
    p = _get()
    if not p.corrupt_upload or not p.once("corrupt_upload"):
        return text
    mid = len(text) // 2
    _emit_fault("corrupt_upload", bytes=64)
    Log.warning("Fault injection: corrupted staged model upload "
                "(%d chars garbled)", min(64, len(text) - mid))
    return text[:mid] + "#" * min(64, len(text) - mid) + text[mid + 64:]


def maybe_shift_block(block, start_row: int):
    """Injection point at the top of RowBlockStore.push_rows: shift feature
    F of every row whose absolute index is K or more (a copy; the caller's
    array stays as it was). It fires on every push, so the drift persists
    across checks; the record is one-shot."""
    p = _get()
    if p.drift_shift is None:
        return block
    at, feat = p.drift_shift
    end_row = start_row + block.shape[0]
    if end_row <= at or feat >= block.shape[1]:
        return block
    import numpy as np

    block = np.array(block, copy=True)
    lo = max(0, at - start_row)
    block[lo:, feat] = block[lo:, feat] * 3.0 + 10.0
    if p.once("drift_shift"):
        Log.warning("Fault injection: shifting feature %d out of bin "
                    "support from row %d onward", feat, at)
        _emit_fault("drift_shift", feature=feat, start_row=at)
    return block


def maybe_poison_generation(booster, generation: int):
    """Injection point after a refit trains (and checkpoints) generation G:
    the booster rebuilt from its model text with every leaf value
    sign-flipped and scaled 1e6, on the booster's device. In memory only:
    the checkpoint on disk keeps the good model, so the retry after a
    rejection publishes it."""
    p = _get()
    if p.bad_generation is None or generation != p.bad_generation \
            or not p.once("bad_generation"):
        return booster
    import re

    from .. import basic

    Log.warning("Fault injection: poisoning the trained model for "
                "generation %d (leaf values sign-flipped and scaled 1e6)", generation)
    _emit_fault("bad_generation", generation=generation)
    txt = booster.model_to_string()
    poisoned = re.sub(
        r"^leaf_value=(.*)$",
        lambda m: "leaf_value=" + " ".join(
            repr(float(v) * -1e6) for v in m.group(1).split()),
        txt, flags=re.M)
    return basic.Booster(model_str=poisoned,
                         params={"device_type": str(booster.device)})


def sketch_corrupt_feature() -> Optional[int]:
    """Injection point in the drift monitor's scoring pass: the feature
    whose sketch gets non-finite values (one-shot), or None."""
    p = _get()
    if p.sketch_corrupt is None or not p.once("sketch_corrupt"):
        return None
    Log.warning("Fault injection: corrupting the quantile sketch for "
                "feature %d", p.sketch_corrupt)
    _emit_fault("sketch_corrupt", feature=p.sketch_corrupt)
    return p.sketch_corrupt


def _emit_fault(kind: str, **fields) -> None:
    """Record the injection in the telemetry stream and the flight
    recorder, then dump a postmortem (rate-limited per kind)."""
    from .. import telemetry, tracing

    telemetry.emit("fault", kind=kind, **fields)
    tracing.note("fault", fault=kind, **fields)
    tracing.dump_flight(f"fault_{kind}")
