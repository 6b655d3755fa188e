"""The distributed layer (the JAX package's ``parallel/``). Only
``elastic.WorkerLostError`` is here yet: the continuous trainer rolls a
generation back on it. The learners, the mesh and the gang's heartbeat come
with the distributed learners (ROADMAP Queue 1 item 8)."""
from .elastic import WorkerLostError

__all__ = ["WorkerLostError"]
