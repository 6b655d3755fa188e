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

The collective-order check of the JAX sanitizer waits for the distributed
learners (ROADMAP Queue 1 item 8). With the sanitizer off nothing is
patched and the timer has no scope hooks.
"""
from __future__ import annotations

import os
import threading
from collections import defaultdict
from typing import Callable, Dict, Optional

from .timer import global_timer


class SyncInScopeError(RuntimeError):
    """A device sync happened inside a scope declared sync-free."""


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
    """Drop the sync counters (between runs)."""
    _sync_counts.clear()


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
