"""Device-level profiling: a torch.profiler trace around training.

Counterpart of the JAX package's ``utils/profile.py``. Two layers:

  * `global_timer` (utils/timer.py): host-side scoped wall-clock sums,
    printed like the reference's timer table.
  * THIS module: `maybe_trace()` wraps a training run in
    ``torch.profiler.profile`` (the CPU and, where a card is in use, CUDA
    activities) when LGBM_TPU_PROFILE=<dir> (or LGBM_TPU_PROFILE_DIR) is set
    or a dir is passed, and exports a Chrome trace
    (``<dir>/torch_trace_<pid>_<n>.json``, loadable in Perfetto or
    chrome://tracing) naming every kernel the run launched. engine.train
    uses it, so

        LGBM_TPU_PROFILE=/tmp/prof python train.py

    traces the whole run with no code change. `annotate(name)` marks a
    phase inside a capture.
"""
from __future__ import annotations

import contextlib
import itertools
import os
from typing import Optional

from .log import Log

ENV_VAR = "LGBM_TPU_PROFILE"
ENV_VAR_LEGACY = "LGBM_TPU_PROFILE_DIR"  # same job, older spelling

_traces = itertools.count()


@contextlib.contextmanager
def maybe_trace(trace_dir: Optional[str] = None):
    """Trace into `trace_dir` (or $LGBM_TPU_PROFILE / $LGBM_TPU_PROFILE_DIR);
    a no-op when none is set."""
    target = trace_dir or os.environ.get(ENV_VAR) or os.environ.get(ENV_VAR_LEGACY)
    if not target:
        yield
        return
    _check_writable(target)
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(target, exist_ok=True)
    path = os.path.join(target, f"torch_trace_{os.getpid()}_{next(_traces)}.json")
    Log.info("Profiling to %s", path)
    prof = profile(activities=activities)
    try:
        with prof:
            yield
    finally:
        # the partial trace of a crashed run is often the most useful
        # artifact it leaves behind: always export it and say where
        prof.export_chrome_trace(path)
        Log.info("Profile written to %s", path)


def _check_writable(target: str) -> None:
    """Fail fast with a named invariant instead of a deep profiler error on
    an unwritable target."""
    probe = target
    while probe and not os.path.exists(probe):
        parent = os.path.dirname(probe)
        if parent == probe:
            break
        probe = parent
    if os.path.isfile(target):
        Log.fatal("Profile target %s is a file, not a directory", target)
    if not probe or not os.access(probe, os.W_OK):
        Log.fatal("Profile target %s is not writable (nearest existing "
                  "ancestor: %s): fix LGBM_TPU_PROFILE or the trace_dir "
                  "argument", target, probe or "<none>")


def annotate(name: str):
    """Named sub-span inside a capture (torch.profiler.record_function),
    for marking phases (binning, tree N, eval) in the timeline."""
    import torch

    return torch.profiler.record_function(name)
