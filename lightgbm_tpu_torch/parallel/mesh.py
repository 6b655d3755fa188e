"""The gang a learner shards over (the JAX package's ``parallel/mesh.py``).

The JAX package's world is a device mesh inside one process (every local
TPU core, or every process's devices under ``jax.distributed``). Here it is
PyTorch's: one process a rank, joined through ``torch.distributed``
(`parallel/dist.py:init_distributed`), each rank's device
``cuda:{local_rank % device_count}`` or the CPU. A `World` names this
process's place in it; its size is the launcher's ``-n``
(``python -m lightgbm_tpu_torch.launch``). One process never spans several
cards, so ``num_machines`` above 1 in a process that joined no world is
refused where the JAX package warns and uses every local device (ROADMAP
Queue 3), and its ``LGBM_TPU_FORCE_MESH_DEVICES`` has no counterpart.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from ..utils.log import Log


def padded_row_count(num_rows: int, n_devices: int, unit: int = 1) -> int:
    """Global row count padded so every device's shard is a multiple of
    `unit`: rows are first rounded up to a per-device multiple of unit,
    then multiplied back out."""
    per = -(-num_rows // (n_devices * unit)) * unit
    return per * n_devices


@dataclass(frozen=True)
class World:
    """This process's place in the gang: its rank, the gang's size, the
    process group (None for a world of one), the rank's device and the
    backend's name ("nccl", "gloo" or "none")."""

    rank: int
    size: int
    group: object
    device: torch.device
    backend: str

    def row_range(self, num_rows: int, rank: Optional[int] = None) -> Tuple[int, int]:
        """[lo, hi) of the rows a rank holds: contiguous blocks in rank
        order, sizes differing by at most one (the pre-partitioned load of
        DatasetLoader::LoadFromFile(rank, num_machines))."""
        r = self.rank if rank is None else rank
        return num_rows * r // self.size, num_rows * (r + 1) // self.size

    def feature_block(self, n_features: int) -> Tuple[int, int, int]:
        """(f_pad, f_local, first feature) of this rank's block of the
        feature axis padded to a multiple of the world size."""
        f_local = -(-max(n_features, self.size) // self.size)
        return f_local * self.size, f_local, f_local * self.rank


def data_world(num_machines: int = 0, device=None) -> World:
    """The world a distributed learner shards over: the joined gang, or
    this process alone. `num_machines` above 1 with no gang joined is
    refused: the gang is started by the launcher, one process a rank."""
    from . import dist

    world = dist.current_world()
    if world is not None:
        if num_machines and num_machines > 1 and num_machines != world.size:
            Log.warning("num_machines=%d does not match the distributed world "
                        "(%d processes); the gang's size is used",
                        num_machines, world.size)
        return world
    if num_machines and num_machines > 1:
        Log.fatal("num_machines=%d, but this process joined no distributed world: start "
                  "one process a rank with python -m lightgbm_tpu_torch.launch -n %d -- "
                  "<cli args>, or set MASTER_ADDR, MASTER_PORT, RANK and WORLD_SIZE",
                  num_machines, num_machines)
    dev = torch.device("cpu") if device is None else torch.device(device)
    return World(0, 1, None, dev, "none")
