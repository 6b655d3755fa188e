"""Elastic multi-process training: gang supervision, the collective
heartbeat, and the watchdog that turns an endless collective block into a
typed error (the JAX package's ``parallel/elastic.py``).

* `CollectiveWatchdog`: a daemon thread fed one cheap ``beat()`` an
  iteration. When no beat lands for ``LGBM_TPU_COLLECTIVE_TIMEOUT_S`` the
  block becomes a `WorkerLostError` naming this rank and its last good
  iteration, noted in the flight recorder. The escalation is staged: a
  cooperative raise at the next injection point, then an asynchronous
  raise into the blocked thread (``PyThreadState_SetAsyncExc``, which
  reaches Python frames only: a rank blocked inside gloo's or NCCL's C++
  leaves by the next stage), then, under a gang only, ``os._exit(117)`` so
  the launcher reaps the gang instead of hanging with it.
* `ElasticRuntime`: the worker's state: the watchdog, the heartbeat (a
  one-element int32 all-reduce over the gang, riding the health monitor's
  ``check_every`` window, or its own ``LGBM_TPU_HEARTBEAT_EVERY`` window
  without a monitor, never every iteration), and the liveness file
  ``<gang dir>/hb_<rank>`` the supervisor reads. A token that comes back
  short raises WorkerLostError; with the sanitizer on, a whole token runs
  the collective-order check (utils/sanitize.py).
* `GangSupervisor`: the launcher's policy. It watches the worker gang and
  reaps every sibling the moment one exits nonzero or its liveness file
  goes stale (no orphaned hangs); with ``elastic`` it relaunches the gang
  up to ``max_restarts`` times, at the same world size (the lost rank
  respawned) or, with ``allow_shrink``, at one rank fewer.
* `worker_env`: one worker's environment, the ``torch.distributed``
  rendezvous (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK,
  LOCAL_WORLD_SIZE) and the gang markers (LGBM_TPU_GANG,
  LGBM_TPU_GANG_ATTEMPT, LGBM_TPU_GANG_DIR, LGBM_TPU_ELASTIC).
* `latest_snapshot`: the newest ``<output_model>.snapshot_iter_<k>`` whose
  checkpoint sidecar reads back, what a relaunched gang resumes from.

The module imports no torch: the launcher drives GangSupervisor without
it, and the heartbeat loads it at its first collective.
"""
from __future__ import annotations

import glob
import os
import subprocess
import threading
import time
from typing import Callable, List, Optional, Tuple

from .. import telemetry, tracing
from ..utils import sanitize
from ..utils.log import Log
from ..utils.timer import global_timer

# the exit code of a worker whose watchdog leaves a dead collective
# (distinct from crash codes, so the supervisor's log names it)
EXIT_WORKER_LOST = 117

ENV_TIMEOUT = "LGBM_TPU_COLLECTIVE_TIMEOUT_S"
ENV_HEARTBEAT_EVERY = "LGBM_TPU_HEARTBEAT_EVERY"
ENV_ELASTIC = "LGBM_TPU_ELASTIC"
ENV_GANG = "LGBM_TPU_GANG"  # set by the launcher: under supervision
ENV_GANG_DIR = "LGBM_TPU_GANG_DIR"  # the ranks' liveness files live here
ENV_GANG_ATTEMPT = "LGBM_TPU_GANG_ATTEMPT"

_DEF_HEARTBEAT_EVERY = 10
_LIVENESS_MIN_INTERVAL_S = 0.5


class WorkerLostError(RuntimeError):
    """A collective peer stopped participating. Carries the observing rank
    and its last good iteration count (finished iterations: the checkpoint a
    restart resumes from)."""

    def __init__(self, message: str = "a gang peer stopped participating",
                 rank: int = -1, last_good_iteration: int = -1) -> None:
        # the message has a default: the asynchronous raise can only
        # deliver the bare class, which Python makes with no arguments
        super().__init__(message)
        self.rank = int(rank)
        self.last_good_iteration = int(last_good_iteration)


def _rank() -> int:
    try:
        return int(os.environ.get("RANK", "0") or 0)
    except ValueError:
        return 0


class CollectiveWatchdog:
    """A deadline over the training thread's iteration beats.

    ``beat()`` is a few attribute stores (no lock, no system call), so the
    loop pays nothing. The daemon thread fires when the gap since the last
    beat exceeds ``timeout_s``: it records a WorkerLostError, dumps a flight
    postmortem, and escalates (asynchronous raise, then the gang's hard
    exit) until a cooperative checkpoint consumes the error."""

    def __init__(self, timeout_s: float, rank: Optional[int] = None) -> None:
        self.timeout_s = float(timeout_s)
        self.rank = _rank() if rank is None else int(rank)
        self.error: Optional[WorkerLostError] = None
        self._last: Optional[Tuple[float, int, int]] = None  # (t, iterations, thread)
        self._armed = False
        self._fired_at: Optional[float] = None
        self._async_raised = False
        self._stop = False
        self._thread: Optional[threading.Thread] = None
        self._poll_s = max(0.02, min(self.timeout_s / 4.0, 0.25))

    def beat(self, finished_iterations: int) -> None:
        """One call an iteration from the training thread: alive at N
        finished iterations, and the thread to interrupt on expiry."""
        self._last = (time.monotonic(), int(finished_iterations), threading.get_ident())
        self._armed = True
        if self._thread is None:
            self._thread = threading.Thread(target=self._run,
                                            name="lgbm-collective-watchdog", daemon=True)
            self._thread.start()

    def raise_if_expired(self) -> None:
        """The cooperative checkpoint: raise the watchdog's typed error in
        the training thread (the asynchronous raise can only deliver the
        bare class)."""
        err = self.error
        if err is not None:
            self.error = None
            self._armed = False
            self._fired_at = None
            raise err

    def disarm(self) -> None:
        """Training ended (or was aborted): the beats stop legitimately."""
        self._armed = False
        self.error = None
        self._fired_at = None
        self._async_raised = False

    def stop(self) -> None:
        self.disarm()
        self._stop = True

    def _run(self) -> None:
        while not self._stop:
            time.sleep(self._poll_s)
            last = self._last
            if not self._armed or last is None:
                continue
            now = time.monotonic()
            if self._fired_at is None:
                if now - last[0] > self.timeout_s:
                    self._fire(last)
                continue
            self._escalate(now, last)

    def _fire(self, last: Tuple[float, int, int]) -> None:
        iters = last[1]
        err = WorkerLostError(
            f"collective blocked for more than {self.timeout_s:.1f}s on rank {self.rank} "
            f"(last good iteration: {iters}): a gang peer stopped participating",
            rank=self.rank, last_good_iteration=iters)
        self.error = err
        self._fired_at = time.monotonic()
        self._async_raised = False
        Log.warning("%s", err)
        fields = {"rank": self.rank, "last_good_iteration": iters, "timeout_s": self.timeout_s}
        tracing.note("worker_lost", **fields)
        if telemetry.enabled():
            telemetry.emit("worker_lost", **fields)
        global_timer.add_count("elastic_worker_lost", 1)
        tracing.dump_flight("worker_lost", extra=fields, force=True)

    def _escalate(self, now: float, last: Tuple[float, int, int]) -> None:
        """After firing, when no cooperative checkpoint consumed the error:
        an asynchronous raise into the training thread (it lands at its next
        bytecode: enough for a Python-level block); if the block is in C++
        and the rank runs under a gang, the hard exit, so the supervisor
        reaps the gang instead of inheriting the hang."""
        if not self._async_raised and now - self._fired_at > 2 * self._poll_s:
            self._async_raised = True
            import ctypes

            ctypes.pythonapi.PyThreadState_SetAsyncExc(ctypes.c_ulong(last[2]),
                                                       ctypes.py_object(WorkerLostError))
        if os.environ.get(ENV_GANG) and now - self._fired_at > max(1.0, self.timeout_s):
            Log.warning("watchdog: rank %d still blocked %.1fs after the deadline; exiting "
                        "%d for the gang supervisor", self.rank, now - self._fired_at,
                        EXIT_WORKER_LOST)
            os._exit(EXIT_WORKER_LOST)


class ElasticRuntime:
    """A worker's elastic state: the watchdog, the heartbeat collective and
    the liveness file the supervisor reads. Obtained through `active`
    (from the environment) or `install`."""

    def __init__(self, timeout_s: Optional[float] = None,
                 heartbeat_every: int = _DEF_HEARTBEAT_EVERY, rank: Optional[int] = None,
                 gang_dir: Optional[str] = None) -> None:
        self.rank = _rank() if rank is None else int(rank)
        self.heartbeat_every = max(1, int(heartbeat_every))
        self.watchdog = CollectiveWatchdog(timeout_s, rank=self.rank) if timeout_s else None
        self.gang_dir = gang_dir
        self._since_hb = 0
        self._liveness_t = 0.0

    def on_iteration_start(self, finished_iterations: int, piggyback: bool = False) -> None:
        """The top of every training iteration: beat the watchdog, surface
        a pending expiry, touch the liveness file, and (only when no health
        monitor's window carries it, ``piggyback=False``) run the
        self-windowed heartbeat."""
        if self.watchdog is not None:
            self.watchdog.raise_if_expired()
            self.watchdog.beat(finished_iterations)
        if self.gang_dir:
            self._touch_liveness(finished_iterations)
        if not piggyback:
            self._since_hb += 1
            if self._since_hb >= self.heartbeat_every:
                self._since_hb = 0
                self.heartbeat_sync(finished_iterations)

    def poll_raise(self) -> None:
        """The cooperative poll of code that blocks on purpose (the injected
        worker_hang spin): raises the watchdog's typed error once set."""
        if self.watchdog is not None:
            self.watchdog.raise_if_expired()

    def heartbeat_sync(self, iteration: int) -> bool:
        """All-reduce a one-element int32 token over the gang and check its
        cardinality (health.py calls this inside its check_every window,
        after its one scalar read). A world of one has nobody to hear from.
        Returns True when the whole world answered; a short token raises."""
        from . import dist

        world = dist.current_world()
        if world is None or world.size <= 1:
            return True
        import torch

        token = dist.all_reduce(world, torch.ones(1, dtype=torch.int32, device=world.device))
        got = int(token.item())  # the window's read: every rank is here in lockstep
        global_timer.add_count("elastic_heartbeats", 1)
        if telemetry.enabled():
            telemetry.emit("heartbeat", iteration=int(iteration), token=got, world=world.size,
                           rank=self.rank)
        if got == world.size:
            if sanitize.enabled():
                sanitize.check_collective_order()
            return True
        fields = {"token": got, "world": world.size, "iteration": int(iteration),
                  "rank": self.rank}
        tracing.note("heartbeat_mismatch", **fields)
        tracing.dump_flight("heartbeat_mismatch", extra=fields, force=True)
        raise WorkerLostError(f"heartbeat token came back {got}/{world.size} at iteration "
                              f"{iteration}: the gang lost a rank mid-run", rank=self.rank,
                              last_good_iteration=max(0, int(iteration)))

    def _touch_liveness(self, finished_iterations: int) -> None:
        now = time.monotonic()
        if now - self._liveness_t < _LIVENESS_MIN_INTERVAL_S:
            return
        self._liveness_t = now
        try:
            os.makedirs(self.gang_dir, exist_ok=True)
            with open(os.path.join(self.gang_dir, f"hb_{self.rank}"), "w") as fh:
                fh.write(f"{int(finished_iterations)}\n")
        except OSError:
            pass  # liveness is advisory: the heartbeat and the watchdog still cover

    def notify_train_end(self) -> None:
        if self.watchdog is not None:
            self.watchdog.disarm()


_runtime: Optional[ElasticRuntime] = None
_runtime_key: Optional[tuple] = None
_installed = False


def active() -> Optional[ElasticRuntime]:
    """The process's elastic runtime, or None when elastic mode is off:
    from LGBM_TPU_ELASTIC / LGBM_TPU_COLLECTIVE_TIMEOUT_S /
    LGBM_TPU_HEARTBEAT_EVERY / LGBM_TPU_GANG_DIR unless one was installed.
    Off, it costs two environment lookups."""
    global _runtime, _runtime_key
    if _installed:
        return _runtime
    timeout = os.environ.get(ENV_TIMEOUT, "")
    elastic_on = os.environ.get(ENV_ELASTIC, "") not in ("", "0", "false")
    if not timeout and not elastic_on:
        return None
    every = os.environ.get(ENV_HEARTBEAT_EVERY, "")
    key = (timeout, elastic_on, every, os.environ.get(ENV_GANG_DIR, ""))
    if _runtime is None or _runtime_key != key:
        try:
            timeout_s = float(timeout) if timeout else None
        except ValueError:
            Log.warning("Ignoring unparseable %s=%r", ENV_TIMEOUT, timeout)
            timeout_s = None
        if _runtime is not None and _runtime.watchdog is not None:
            _runtime.watchdog.stop()
        _runtime = ElasticRuntime(timeout_s=timeout_s,
                                  heartbeat_every=int(every) if every else _DEF_HEARTBEAT_EVERY,
                                  gang_dir=os.environ.get(ENV_GANG_DIR) or None)
        _runtime_key = key
    return _runtime


def install(timeout_s: Optional[float] = None, heartbeat_every: int = _DEF_HEARTBEAT_EVERY,
            rank: Optional[int] = None, gang_dir: Optional[str] = None) -> ElasticRuntime:
    """Arm an elastic runtime programmatically."""
    global _runtime, _runtime_key, _installed
    clear()
    _runtime = ElasticRuntime(timeout_s=timeout_s, heartbeat_every=heartbeat_every,
                              rank=rank, gang_dir=gang_dir)
    _installed = True
    return _runtime


def clear() -> None:
    """Disarm; the next `active` reads the environment again."""
    global _runtime, _runtime_key, _installed
    if _runtime is not None and _runtime.watchdog is not None:
        _runtime.watchdog.stop()
    _runtime = None
    _runtime_key = None
    _installed = False


def notify_train_end() -> None:
    """engine.train's finally: the beats end legitimately, so the watchdog
    must not turn the silence after training into a worker loss."""
    if _runtime is not None:
        _runtime.notify_train_end()


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
    hung-not-dead case; a rank that never wrote one is still starting;
    ElasticRuntime writes them).
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


def worker_env(base: Optional[dict] = None, *, port: int, world: int, rank: int,
               attempt: int = 0, gang_dir: Optional[str] = None,
               elastic: bool = False) -> dict:
    """One gang worker's environment: the torch.distributed rendezvous on
    this host and the gang markers faults.py and the watchdog read."""
    env = dict(os.environ if base is None else base)
    env["MASTER_ADDR"] = "127.0.0.1"
    env["MASTER_PORT"] = str(port)
    env["WORLD_SIZE"] = str(world)
    env["RANK"] = str(rank)
    env["LOCAL_RANK"] = str(rank)
    env["LOCAL_WORLD_SIZE"] = str(world)
    env[ENV_GANG] = "1"
    env[ENV_GANG_ATTEMPT] = str(attempt)
    if gang_dir:
        env[ENV_GANG_DIR] = gang_dir
    if elastic:
        env[ENV_ELASTIC] = "1"
    return env
