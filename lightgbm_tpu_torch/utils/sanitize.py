"""Runtime sync sanitizer (LGBM_TPU_SANITIZE=1).

Counterpart of the JAX package's ``utils/sanitize.py``, for PyTorch on the
card:

* **Sync accounting.** The host reads of a device tensor — ``item``,
  ``tolist``, ``__bool__``, ``__float__``, ``__int__``, and ``cpu`` /
  ``numpy`` of a tensor not on the CPU — are counted by the innermost open
  `global_timer.scope` label of the reading thread. Only tensors on the
  tracked device type count: ``cuda`` by default (``enable("cpu")`` tracks
  CPU tensors, for tests of the accounting itself).

* **Sync-free scopes.** Scopes in `SYNC_FREE` assert zero syncs: a counted
  read while one is open raises `SyncInScopeError` naming the scope and
  the read. On the card the scope also arms
  ``torch.cuda.set_sync_debug_mode("error")``, which catches the implicit
  syncs no patched method sees (``nonzero``, boolean-mask indexing, a
  tensor made from a host scalar on the card): PyTorch raises on them.
  The mode is only armed when the caller asks for it explicitly,
  ``enable("cuda", sync_debug=True)``; ``LGBM_TPU_SANITIZE=1`` never arms
  it. The mode is PROCESS-WIDE state: though it is armed by the thread
  that entered the outermost sync-free scope and restored to what it was
  when that scope exits (an exception included), while it is armed ANY
  thread's sync raises, a serving worker's copy of its answer to the host
  included. So ask for it only in a process that serves nothing while it
  trains, as a test or a smoke run does.

  `SYNC_FREE` holds the port's counterparts of the JAX package's
  ``tree_device`` and ``goss_device_select``: ``tree_device``
  (treelearner/device.py, the wave learner's tree staged and enqueued as
  one graph launch; ``tree_results``, the wait for its results, is
  outside it) and ``goss_select`` (models/sample_strategy.py, GOSS's
  selection where the gradients are).

* **The collective-order check.** While the sanitizer is on, each
  collective parallel/dist.py issues over a gang (``all_reduce``,
  ``reduce_scatter``, ``all_gather``, ``all_gather_rows``) is recorded as
  (op, group size), with a rolling CRC after each step. The JAX package
  records collectives when it traces them; here they are host calls, so
  every call is recorded, into a window that a passing check closes.
  `check_collective_order()` (from the elastic heartbeat's window, when its
  token came back whole, and from tests) all-gathers every rank's
  fingerprints of the window ([count, CRC of its first 1, 2, ... 32 ops,
  CRC of the whole window], int64 on the wire: NCCL reduces no uint32) and
  raises `CollectiveOrderError(rank, first_divergent_op)` naming the first
  op where this rank's sequence left another's: a rank that issues a
  collective the others never issue deadlocks the gang. When every rank
  agrees, the window's ops are dropped and the next window starts, so a
  long run keeps no growing list, and a divergence after the window's
  32nd op still shows in the whole window's CRC.

With the sanitizer off nothing is patched, the timer has no scope hooks
and no collective is recorded.
"""
from __future__ import annotations

import os
import threading
import zlib
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

from .timer import global_timer


class SyncInScopeError(RuntimeError):
    """A device sync happened inside a scope declared sync-free."""


class CollectiveOrderError(RuntimeError):
    """This rank's collective sequence left the gang's. `rank` is the rank
    that detected it (the raiser); `first_divergent_op` names this rank's
    op at the first step where the prefix fingerprints disagree ("<none:
    ...>" when this rank issued fewer collectives than the other)."""

    def __init__(self, message: str, rank: int = -1, first_divergent_op: str = "") -> None:
        super().__init__(message)
        self.rank = int(rank)
        self.first_divergent_op = first_divergent_op


# scopes asserted to perform ZERO device syncs while open
SYNC_FREE = {"tree_device", "goss_select"}

_READS = ("item", "tolist", "__bool__", "__float__", "__int__")
_COPIES = ("cpu", "numpy")

_forced: Optional[bool] = None
_track = "cuda"
_sync_debug = False
_orig: Dict[str, Callable] = {}
_sync_counts: Dict[str, Dict[str, int]] = defaultdict(lambda: defaultdict(int))
_local = threading.local()
# the collectives issued since the last check that passed, (op, group
# size) in order, the rolling CRC after each step (zlib.crc32: the same on
# every process), and the count of the ops checked before them
_collective_seq: List[Tuple[str, str]] = []
_collective_crcs: List[int] = []
_collective_base = 0
# prefix slots the check exchanges: a divergence shows at its first op
_FP_SLOTS = 32


def enabled() -> bool:
    if _forced is not None:
        return _forced
    return os.environ.get("LGBM_TPU_SANITIZE", "") not in ("", "0")


def enable(device_type: str = "cuda", sync_debug: bool = False) -> None:
    """Force-on regardless of the env var; patches torch.Tensor's read
    methods and hooks the timer's scopes. `device_type` is the device type
    whose tensors' reads count. `sync_debug` arms the process-wide sync
    debug mode inside the sync-free scopes on the card (see the module
    docstring for what that costs other threads)."""
    global _forced, _track, _sync_debug
    _forced = True
    _track = str(device_type)
    _sync_debug = bool(sync_debug)
    _install()


def disable() -> None:
    """Force-off: the patches and scope hooks are removed."""
    global _forced, _sync_debug
    _forced = False
    _sync_debug = False
    _uninstall()


def clear_override() -> None:
    """Back to env-var-driven (undoes enable()/disable())."""
    global _forced, _sync_debug
    _forced = None
    _sync_debug = False
    if enabled():
        _install()
    else:
        _uninstall()


def reset() -> None:
    """Drop the sync counters and the collective sequence (between runs)."""
    global _collective_base
    _sync_counts.clear()
    _collective_seq.clear()
    _collective_crcs.clear()
    _collective_base = 0


def note_collective(op: str, group_size: int) -> None:
    """Record one collective (parallel/dist.py calls this while the
    sanitizer is on): append (op, size) and roll the CRC."""
    if getattr(_local, "quiet", False):
        return
    size = str(int(group_size))
    _collective_seq.append((op, size))
    prev = _collective_crcs[-1] if _collective_crcs else 0
    _collective_crcs.append(zlib.crc32(f"{op}@{size}".encode("utf-8"), prev) & 0xFFFFFFFF)


def collective_sequence() -> List[Tuple[str, str]]:
    """The (op, group size) pairs this process issued since the last check
    that passed, in order."""
    return list(_collective_seq)


def collective_fingerprint() -> Tuple[int, int]:
    """(count of every op issued, rolling CRC of the window since the last
    check that passed): a cheap equality probe."""
    return (_collective_base + len(_collective_seq),
            _collective_crcs[-1] if _collective_crcs else 0)


def _fingerprint_vector():
    """[count, crc_1 .. crc_32, crc_window] int64: the row each rank sends.
    Slot i holds the CRC of the window's first i ops (0 when fewer were
    issued), so the first differing slot is the first divergent op's
    index; the last slot is the whole window's CRC."""
    import numpy as np

    vec = np.zeros(_FP_SLOTS + 2, dtype=np.int64)
    vec[0], vec[-1] = collective_fingerprint()
    vec[1:1 + min(_FP_SLOTS, len(_collective_crcs))] = _collective_crcs[:_FP_SLOTS]
    return vec


def _gang_gather(vec):
    """(rank, [world, len(vec)]) over the joined gang, or None alone. The
    check's own all-gather is not recorded."""
    import numpy as np
    import torch

    from ..parallel import dist

    world = dist.current_world()
    if world is None or world.size <= 1:
        return None
    _local.quiet = True
    try:
        rows = dist.all_gather(world, torch.from_numpy(vec).to(world.device))
    finally:
        _local.quiet = False
    return world.rank, np.asarray(dist.host_value(rows))


def check_collective_order(gather_fn: Optional[Callable] = None) -> None:
    """Cross-check this rank's collective sequence against every rank's.

    `gather_fn(vec) -> [world, len(vec)]` stands in for the gang's
    all-gather (tests); by default the joined gang's, and alone nothing is
    checked. No-op when the sanitizer is off. Raises CollectiveOrderError
    on the first rank whose fingerprints disagree with another's; when
    every rank agrees, the window's ops are dropped."""
    if not enabled():
        return
    import numpy as np

    mine = _fingerprint_vector()
    if gather_fn is None:
        got = _gang_gather(mine)
        if got is None:
            return
        rank, rows = got
    else:
        from ..parallel import dist

        world = dist.current_world()
        rank, rows = (0 if world is None else world.rank), np.asarray(gather_fn(mine))
    if rows.ndim != 2 or rows.shape[0] <= 1:
        return
    global_timer.add_count("collective_order_checks", 1)
    for other in range(rows.shape[0]):
        if np.array_equal(rows[other], mine):
            continue
        diff = np.flatnonzero(rows[other][1:1 + _FP_SLOTS] != mine[1:1 + _FP_SLOTS])
        # the prefixes agree through every slot: the shorter window's end,
        # or, past the slots, somewhere after the last one
        shorter = min(int(mine[0]), int(rows[other][0])) - _collective_base
        div = int(diff[0]) if diff.size else min(shorter, _FP_SLOTS)
        if div == _FP_SLOTS:
            op = (f"<after op #{_collective_base + _FP_SLOTS - 1}: the sequences agree "
                  "through it and differ after it>")
        elif div < len(_collective_seq):
            op = "%s@%s" % _collective_seq[div]
        else:
            op = (f"<none: this rank issued {int(mine[0])} collective(s), rank {other} "
                  f"issued {int(rows[other][0])}>")
        raise CollectiveOrderError(
            f"collective order divergence: rank {rank} and rank {other} issued different "
            f"collective sequences, first divergent op #{_collective_base + div} is {op} "
            "on this rank; every rank must issue the same collectives in the same order "
            "or the gang deadlocks", rank=rank, first_divergent_op=op)
    _close_window()


def _close_window() -> None:
    """Every rank agreed through the window: drop its ops."""
    global _collective_base
    _collective_base += len(_collective_seq)
    _collective_seq.clear()
    _collective_crcs.clear()


def sync_counts() -> Dict[str, Dict[str, int]]:
    """Per-scope-label sync counts: {label: {kind: n}}."""
    return {label: dict(kinds) for label, kinds in _sync_counts.items()}


def _stack():
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


def _note_sync(kind: str) -> None:
    stack = _stack()
    label = stack[-1] if stack else "<no-scope>"
    _sync_counts[label][kind] += 1
    bad = SYNC_FREE.intersection(stack)
    if bad:
        raise SyncInScopeError(
            f"device sync ({kind}) inside the sync-free scope {sorted(bad)[0]!r}: this "
            "region is asserted to stay on the device end to end; a sync here "
            "serializes the host with the card")


def _counted(name: str, copy: bool):
    orig = _orig[name]

    def wrapper(self, *args, **kwargs):
        if enabled() and self.device.type == _track and not (copy and _track == "cpu"):
            _note_sync(name)
        return orig(self, *args, **kwargs)

    wrapper.__name__ = name
    return wrapper


def _on_enter(label: str) -> None:
    stack = _stack()
    stack.append(label)
    if (_sync_debug and label in SYNC_FREE and getattr(_local, "armed", None) is None
            and _track == "cuda"):
        import torch

        if torch.cuda.is_available() and torch.cuda.is_initialized():
            _local.armed = (label, len(stack), torch.cuda.get_sync_debug_mode())
            torch.cuda.set_sync_debug_mode("error")


def _on_exit(label: str) -> None:
    stack = _stack()
    armed = getattr(_local, "armed", None)
    if armed is not None and armed[0] == label and armed[1] == len(stack):
        import torch

        torch.cuda.set_sync_debug_mode(armed[2])
        _local.armed = None
    if stack:
        stack.pop()


_HOOKS = (_on_enter, _on_exit)


def _install() -> None:
    import torch

    if not _orig:
        for name in _READS + _COPIES:
            _orig[name] = getattr(torch.Tensor, name)
            setattr(torch.Tensor, name, _counted(name, name in _COPIES))
    if _HOOKS not in global_timer.scope_hooks:
        global_timer.scope_hooks.append(_HOOKS)


def _uninstall() -> None:
    import torch

    for name, fn in _orig.items():
        setattr(torch.Tensor, name, fn)
    _orig.clear()
    if _HOOKS in global_timer.scope_hooks:
        global_timer.scope_hooks.remove(_HOOKS)


if enabled():
    _install()
