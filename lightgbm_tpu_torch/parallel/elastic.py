"""The gang's supervision and loss signal (the JAX package's
``parallel/elastic.py:64-77, 414-602``).

* `WorkerLostError`: a collective peer stopped taking part
  (`streaming/continuous.py` rolls a refit back to its generation's
  checkpoint on it).
* `GangSupervisor`: the launcher's policy. It watches the worker gang and
  reaps every sibling the moment one exits nonzero (no orphaned hangs: a
  dead rank must not leave the others blocked in a collective); with
  ``elastic`` it relaunches the gang up to ``max_restarts`` times, at the
  same world size (the lost rank respawned) or, with ``allow_shrink``, at
  one rank fewer. Given a liveness deadline and a directory it also reaps
  a gang whose rank's liveness file goes stale; no worker writes one yet.
* `worker_env`: one worker's environment, the ``torch.distributed``
  rendezvous (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK,
  LOCAL_WORLD_SIZE).
* `latest_snapshot`: the newest ``<output_model>.snapshot_iter_<k>`` whose
  checkpoint sidecar reads back, what a relaunched gang resumes from.

The worker side (the collective watchdog that turns a blocked collective
into a WorkerLostError, the heartbeat that writes the liveness files, the
elastic runtime) is ROADMAP Queue 1 item 8's remainder. The module imports
no torch.
"""
from __future__ import annotations

import glob
import os
import subprocess
import time
from typing import Callable, List, Optional, Tuple

from .. import telemetry, tracing
from ..utils.log import Log
from ..utils.timer import global_timer

# the exit code of a worker whose watchdog leaves a dead collective
# (distinct from crash codes, so the supervisor's log names it)
EXIT_WORKER_LOST = 117


class WorkerLostError(RuntimeError):
    """A collective peer stopped participating. Carries the observing rank
    and its last good iteration count (finished iterations: the checkpoint a
    restart resumes from)."""

    def __init__(self, message: str = "a gang peer stopped participating",
                 rank: int = -1, last_good_iteration: int = -1) -> None:
        super().__init__(message)
        self.rank = int(rank)
        self.last_good_iteration = int(last_good_iteration)


def latest_snapshot(output_model: str) -> Optional[str]:
    """The newest ``<output_model>.snapshot_iter_<k>`` with a valid sidecar
    (checkpoint.read_sidecar_manifest checks its checksum): a snapshot whose
    write the dying worker tore is skipped, not resumed."""
    from ..checkpoint import read_sidecar_manifest

    best: Optional[Tuple[int, str]] = None
    for path in glob.glob(output_model + ".snapshot_iter_*"):
        if path.endswith(".ckpt"):
            continue
        try:
            it = int(path.rsplit("_", 1)[1])
        except ValueError:
            continue
        if best is not None and it <= best[0]:
            continue
        try:
            if read_sidecar_manifest(path) is None:
                continue
        except Exception:  # noqa: BLE001 - a damaged snapshot is skipped
            continue
        best = (it, path)
    return best[1] if best else None


class GangSupervisor:
    """Watch a gang of worker processes; reap on first loss; optionally
    relaunch. ``spawn(world_size, rank, attempt)`` -> subprocess.Popen is
    the caller's (launch.py starts CLI workers; tests start stubs).

    A loss is any nonzero exit, or, with ``liveness_timeout_s``, a running
    rank whose liveness file ``<gang_dir>/hb_<rank>`` is older than that (the
    hung-not-dead case; a rank that never wrote one is still starting).
    Either way every sibling is torn down (terminate, a bounded wait, kill)
    before the supervisor returns or relaunches. `run` returns 0 when the
    gang finished cleanly, else the lost worker's exit code (1 for a
    liveness loss)."""

    def __init__(self, spawn: Callable[[int, int, int], subprocess.Popen],
                 nproc: int, *, elastic: bool = False, max_restarts: int = 2,
                 allow_shrink: bool = False, liveness_timeout_s: float = 0.0,
                 gang_dir: Optional[str] = None, poll_s: float = 0.1,
                 reap_grace_s: float = 5.0) -> None:
        self.spawn = spawn
        self.nproc = int(nproc)
        self.elastic = bool(elastic)
        self.max_restarts = int(max_restarts)
        self.allow_shrink = bool(allow_shrink)
        self.liveness_timeout_s = float(liveness_timeout_s)
        self.gang_dir = gang_dir
        self.poll_s = float(poll_s)
        self.reap_grace_s = float(reap_grace_s)
        self.attempts_used = 0
        self.worlds: List[int] = []
        self.last_recovery_ms: Optional[float] = None
        self._loss_t: Optional[float] = None

    def run(self) -> int:
        world, attempt = self.nproc, 0
        while True:
            self._clear_liveness()
            self.worlds.append(world)
            procs = [self.spawn(world, rank, attempt) for rank in range(world)]
            if self._loss_t is not None:
                # detect -> reap -> respawn latency of this recovery
                self.last_recovery_ms = (time.monotonic() - self._loss_t) * 1e3
                global_timer.set_count("gang_recovery_ms", int(self.last_recovery_ms))
            lost = self._watch(procs)
            if lost is None:
                return 0
            rank, rc, why = lost
            reaped = self._reap(procs)
            Log.warning("gang: worker %d lost (%s, rc=%s) at attempt %d; reaped %d "
                        "sibling(s)", rank, why, rc, attempt, reaped)
            tracing.note("gang_worker_lost", rank=rank, exit_code=rc, attempt=attempt,
                         why=why, world_size=world)
            if telemetry.enabled():
                telemetry.emit("gang_worker_lost", rank=rank, exit_code=rc,
                               attempt=attempt, why=why, world_size=world)
            global_timer.add_count("gang_workers_lost", 1)
            tracing.dump_flight("gang_worker_lost", extra={
                "rank": rank, "exit_code": rc, "attempt": attempt, "why": why,
                "world_size": world}, force=True)
            if not self.elastic or attempt >= self.max_restarts:
                return rc if rc else 1
            attempt += 1
            self.attempts_used = attempt
            if self.allow_shrink and world > 1:
                world -= 1
            Log.warning("gang: elastic restart %d/%d at world size %d", attempt,
                        self.max_restarts, world)

    def _watch(self, procs: List[subprocess.Popen]
               ) -> Optional[Tuple[int, Optional[int], str]]:
        """Block until the gang finishes cleanly (None) or a worker is lost:
        (rank, exit code or None, "exit" | "liveness")."""
        while True:
            running = 0
            for rank, p in enumerate(procs):
                rc = p.poll()
                if rc is None:
                    running += 1
                elif rc != 0:
                    self._loss_t = time.monotonic()
                    return (rank, rc, "exit")
            if running == 0:
                return None
            stale = self._stale_liveness(procs)
            if stale is not None:
                self._loss_t = time.monotonic()
                return (stale, None, "liveness")
            time.sleep(self.poll_s)

    def _stale_liveness(self, procs: List[subprocess.Popen]) -> Optional[int]:
        if not self.liveness_timeout_s or not self.gang_dir:
            return None
        now = time.time()
        for rank, p in enumerate(procs):
            if p.poll() is not None:
                continue
            try:
                age = now - os.stat(os.path.join(self.gang_dir, f"hb_{rank}")).st_mtime
            except OSError:
                continue  # no beat yet: starting, not stale
            if age > self.liveness_timeout_s:
                return rank
        return None

    def _clear_liveness(self) -> None:
        if not self.gang_dir:
            return
        for rank in range(self.nproc):
            try:
                os.unlink(os.path.join(self.gang_dir, f"hb_{rank}"))
            except OSError:
                pass

    def _reap(self, procs: List[subprocess.Popen]) -> int:
        """terminate -> a bounded wait -> kill every survivor; the number of
        processes that had to be reaped."""
        alive = [p for p in procs if p.poll() is None]
        for p in alive:
            try:
                p.terminate()
            except OSError:
                pass
        deadline = time.monotonic() + self.reap_grace_s
        for p in alive:
            try:
                p.wait(timeout=max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                try:
                    p.kill()
                except OSError:
                    pass
                p.wait()
        return len(alive)


def worker_env(base: Optional[dict] = None, *, port: int, world: int, rank: int) -> dict:
    """One gang worker's environment: the torch.distributed rendezvous on
    this host."""
    env = dict(os.environ if base is None else base)
    env["MASTER_ADDR"] = "127.0.0.1"
    env["MASTER_PORT"] = str(port)
    env["WORLD_SIZE"] = str(world)
    env["RANK"] = str(rank)
    env["LOCAL_RANK"] = str(rank)
    env["LOCAL_WORLD_SIZE"] = str(world)
    return env
