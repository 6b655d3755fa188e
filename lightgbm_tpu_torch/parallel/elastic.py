"""The gang's loss signal (the JAX package's ``parallel/elastic.py:64-77``).

Only the exception class is ported: `streaming/continuous.py` catches it to
roll a refit back to its generation's checkpoint. The watchdog, the
heartbeat and the launcher that raise it come with the distributed learners
(ROADMAP Queue 1 item 8).
"""
from __future__ import annotations


class WorkerLostError(RuntimeError):
    """A collective peer stopped taking part. Carries the observing rank
    and its last good iteration count (finished iterations: the checkpoint a
    restart resumes from)."""

    def __init__(self, message: str = "a gang peer stopped participating",
                 rank: int = -1, last_good_iteration: int = -1) -> None:
        super().__init__(message)
        self.rank = int(rank)
        self.last_good_iteration = int(last_good_iteration)
