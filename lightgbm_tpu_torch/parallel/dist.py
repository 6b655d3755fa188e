"""Multi-process runtime over ``torch.distributed`` (the JAX package's
``parallel/dist.py``).

One process a rank. `init_distributed` maps the reference's conf surface
(``num_machines``, ``machine_list_filename`` / ``machines``,
``local_listen_port``, docs/Features.rst:119-141) onto
``torch.distributed.init_process_group``: the first machine of the list is
the rendezvous and this process's rank is its host's line. Explicit
arguments come first, then the ``MASTER_ADDR`` / ``MASTER_PORT`` /
``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` environment (the launcher's),
then the conf file, as in the JAX package's ``dist.py:47-106``.

The backend is named, never guessed from a failure: ``gloo`` for
``device_type=cpu``; for CUDA ranks ``nccl`` when every rank of a host has
a card of its own, else ``gloo`` (two ranks on one card: NCCL takes one
rank a card). Each rank picks from what it sees (its host's rank count:
``LOCAL_WORLD_SIZE``, or the machine list's lines that name its host, and
its host's cards), and the ranks agree through the rendezvous store before
the group is made: one gloo pick makes the gang gloo, so hosts with
different card counts never ask for different backends. A rank's device
is ``cuda:{local_rank % device_count}``, made the current device here.

The collectives (`all_reduce`, `reduce_scatter`, `all_gather`,
`all_gather_rows`) take the rank's tensors on its device. Where the group
is gloo and the tensor on a card, they stage through pinned host memory.
gloo has no reduce-scatter here (torch's gloo binding has none before
2.13), so on gloo it is an all-reduce and the rank's block, by backend.
Each call adds its payload's bytes (what this rank hands the collective)
to the ``collective_bytes`` counter and its host microseconds to
``collective_us``; in a measured run (the global timer enabled) a
collective on a card waits for the card before and after, so those are its
own.
"""
from __future__ import annotations

import datetime
import os
import socket
import time
from typing import Optional

import numpy as np
import torch

from ..utils.log import Log
from ..utils.timer import global_timer
from .mesh import World

_world: Optional[World] = None


def current_world() -> Optional[World]:
    """The world this process joined (`init_distributed`), else None."""
    global _world
    if _world is None and torch.distributed.is_available() \
            and torch.distributed.is_initialized():
        # joined by the caller: adopt the default group
        _world = _make_world(torch.distributed.get_backend(), None)
    return _world


def _local_addresses() -> set:
    names = {"localhost", "127.0.0.1", socket.gethostname()}
    try:
        names.add(socket.gethostbyname(socket.gethostname()))
    except OSError:
        pass
    return names


def _machines(config) -> list:
    mlist = getattr(config, "machine_list_filename", "") or ""
    if mlist and os.path.isfile(mlist):
        with open(mlist) as f:
            return [ln.strip() for ln in f if ln.strip()]
    if getattr(config, "machines", ""):
        return [m.strip() for m in config.machines.split(",") if m.strip()]
    return []


def pick_backend(device_type: str, local_world_size: int) -> str:
    """This rank's backend, `local_world_size` ranks on its host: gloo on
    the CPU or when the host's ranks outnumber its cards, else nccl."""
    if str(device_type).strip().lower() == "cpu" or not torch.cuda.is_available():
        return "gloo"
    return "nccl" if local_world_size <= torch.cuda.device_count() else "gloo"


def agree_backend(store, rank: int, world_size: int, mine: str) -> str:
    """The gang's backend from every rank's pick, through the rendezvous
    store: nccl only when every rank picked it."""
    store.set(f"lgbm_backend/{rank}", mine)
    picks = [store.get(f"lgbm_backend/{r}").decode() for r in range(world_size)]
    return "nccl" if all(p == "nccl" for p in picks) else "gloo"


def _host_of(line: str) -> str:
    return line.split(":")[0].split(" ")[0]


def rendezvous(config=None, master_addr: Optional[str] = None,
               master_port: Optional[int] = None, world_size: Optional[int] = None,
               rank: Optional[int] = None, local_rank: Optional[int] = None):
    """(address, port, world size, rank, local rank, local world size) of
    the gang to join, or None when nothing names one. Resolution order:
    explicit arguments > the MASTER_ADDR / MASTER_PORT / RANK / WORLD_SIZE
    / LOCAL_RANK / LOCAL_WORLD_SIZE environment > the conf's machine list
    (the first machine the rendezvous at local_listen_port, the rank this
    host's line, the first such line when several name this host; the
    local rank and size count the lines that name the rank's host). Where
    nothing gives the local size, it is the local rank plus one, the
    fewest ranks the host can hold."""
    env = os.environ
    local_size = None
    if master_addr is None and env.get("MASTER_ADDR"):
        master_addr = env["MASTER_ADDR"]
        master_port = master_port or int(env.get("MASTER_PORT", "29500"))
        world_size = world_size or (int(env["WORLD_SIZE"]) if env.get("WORLD_SIZE") else None)
        rank = rank if rank is not None else (int(env["RANK"]) if env.get("RANK") else None)
        if local_rank is None and env.get("LOCAL_RANK"):
            local_rank = int(env["LOCAL_RANK"])
        if env.get("LOCAL_WORLD_SIZE"):
            local_size = int(env["LOCAL_WORLD_SIZE"])
    if master_addr is None and config is not None:
        machines = _machines(config)
        if len(machines) > 1:
            hosts = [_host_of(m) for m in machines]
            master_addr = hosts[0]
            master_port = master_port or int(getattr(config, "local_listen_port", 12400))
            world_size = world_size or len(machines)
            if rank is None:
                local = _local_addresses()
                rank = next((i for i, h in enumerate(hosts) if h in local), None)
            if rank is not None and 0 <= int(rank) < len(hosts):
                mine = hosts[int(rank)]
                if local_rank is None:
                    local_rank = hosts[:int(rank)].count(mine)
                local_size = hosts.count(mine)
    if master_addr is None:
        return None
    if world_size is None or rank is None:
        Log.fatal("Joining a distributed world needs its size and this process's rank "
                  "(set WORLD_SIZE / RANK, or a machine list that holds this host)")
    rank = int(rank)
    local_rank = rank if local_rank is None else int(local_rank)
    return (master_addr, int(master_port or 29500), int(world_size), rank, local_rank,
            local_rank + 1 if local_size is None else int(local_size))


def init_distributed(config=None, master_addr: Optional[str] = None,
                     master_port: Optional[int] = None, world_size: Optional[int] = None,
                     rank: Optional[int] = None, local_rank: Optional[int] = None,
                     backend: Optional[str] = None) -> bool:
    """Join the gang `rendezvous` names, or stay alone when it names none.
    Idempotent. Returns True when a world of more than one process is
    joined after the call."""
    global _world
    if current_world() is not None:
        return _world.size > 1
    found = rendezvous(config, master_addr, master_port, world_size, rank, local_rank)
    if found is None:
        return False
    master_addr, master_port, world_size, rank, local_rank, local_size = found
    device_type = getattr(config, "device_type", "") if config is not None else ""
    on_card = str(device_type).strip().lower() != "cpu" and torch.cuda.is_available()
    if on_card:
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    timeout = datetime.timedelta(minutes=int(getattr(config, "time_out", 120) or 120))
    with global_timer.scope("dist_init"):
        store = torch.distributed.TCPStore(master_addr, master_port, world_size, rank == 0,
                                           timeout=timeout)
        backend = agree_backend(store, rank, world_size,
                                backend or pick_backend(device_type, local_size))
        Log.info("Joining distributed world: %s:%d rank %d/%d over %s", master_addr,
                 master_port, rank, world_size, backend)
        torch.distributed.init_process_group(backend, store=store, world_size=world_size,
                                             rank=rank, timeout=timeout)
    _world = _make_world(backend, torch.device("cuda", torch.cuda.current_device())
                         if on_card else torch.device("cpu"))
    return world_size > 1


def _make_world(backend: str, device: Optional[torch.device]) -> World:
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if backend == "nccl" else torch.device("cpu"))
    return World(torch.distributed.get_rank(), torch.distributed.get_world_size(),
                 torch.distributed.group.WORLD, device, backend)


def shutdown() -> None:
    """Leave the world (the process group is destroyed)."""
    global _world
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    _world = None


# ------------------------------------------------------------ collectives

def _staged(world: World, t: torch.Tensor) -> bool:
    return world.backend == "gloo" and t.device.type == "cuda"


def _to_wire(world: World, t: torch.Tensor) -> torch.Tensor:
    """A copy of `t` the collective may write: in pinned host memory where
    the group is gloo and `t` on a card, else on t's device."""
    if _staged(world, t):
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        return host
    return t.clone(memory_format=torch.contiguous_format)


def _sync(t: torch.Tensor) -> None:
    """In a measured run (the global timer enabled) a collective on a card
    waits for the card before and after, so its host seconds are its own."""
    if global_timer.enabled and t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


def _note(nbytes: int, t0: float) -> None:
    global_timer.add_count("collective_bytes", nbytes)
    global_timer.add_count("collective_calls", 1)
    global_timer.add_count("collective_us", int((time.perf_counter() - t0) * 1e6))


_OPS = {"sum": "SUM", "max": "MAX"}


def all_reduce(world: World, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """The elementwise SUM or MAX of every rank's `t`, as a new tensor (`t`
    is left as it is). A world of one returns `t`."""
    if world.size == 1:
        return t
    _sync(t)
    t0 = time.perf_counter()
    with global_timer.scope("collective"):
        wire = _to_wire(world, t)
        torch.distributed.all_reduce(wire, op=getattr(torch.distributed.ReduceOp, _OPS[op]),
                                     group=world.group)
        out = wire.to(t.device) if wire.device != t.device else wire
        _sync(out)
    _note(t.numel() * t.element_size(), t0)
    return out


def reduce_scatter(world: World, t: torch.Tensor) -> torch.Tensor:
    """Rank r's block of the SUM of every rank's `t` along dim 0 (whose
    length the world size divides): nccl's reduce-scatter, or on gloo an
    all-reduce and the block."""
    if world.size == 1:
        return t
    if t.shape[0] % world.size:
        raise ValueError(f"reduce_scatter splits dim 0 ({t.shape[0]}) over "
                         f"{world.size} ranks")
    blk = t.shape[0] // world.size
    if world.backend != "nccl":
        full = all_reduce(world, t)
        return full[world.rank * blk:(world.rank + 1) * blk]
    _sync(t)
    t0 = time.perf_counter()
    with global_timer.scope("collective"):
        src = t.contiguous()
        out = torch.empty((blk, *t.shape[1:]), dtype=t.dtype, device=t.device)
        fn = getattr(torch.distributed, "reduce_scatter_single", None) \
            or torch.distributed.reduce_scatter_tensor
        fn(out, src, group=world.group)
        _sync(out)
    _note(t.numel() * t.element_size(), t0)
    return out


def all_gather(world: World, t: torch.Tensor) -> torch.Tensor:
    """[size, *t.shape]: every rank's `t` (of one shape on every rank), in
    rank order."""
    if world.size == 1:
        return t[None]
    _sync(t)
    t0 = time.perf_counter()
    with global_timer.scope("collective"):
        wire = _to_wire(world, t) if _staged(world, t) else t.contiguous()
        out = torch.empty((world.size, *t.shape), dtype=t.dtype, device=wire.device)
        fn = getattr(torch.distributed, "all_gather_single", None) \
            or torch.distributed.all_gather_into_tensor
        if world.backend == "gloo":
            parts = list(out.unbind(0))
            torch.distributed.all_gather(parts, wire, group=world.group)
        else:
            fn(out, wire, group=world.group)
        if out.device != t.device:
            out = out.to(t.device)
        _sync(out)
    _note(t.numel() * t.element_size(), t0)
    return out


def all_gather_rows(world: World, t: torch.Tensor, num_rows: int) -> torch.Tensor:
    """The [num_rows, ...] concatenation of every rank's row block (rank r
    holds `world.row_range(num_rows, r)`), in rank order: blocks padded to
    the largest, gathered, trimmed."""
    if world.size == 1:
        return t
    lo, hi = world.row_range(num_rows)
    if t.shape[0] != hi - lo:
        raise ValueError(f"rank {world.rank} holds rows [{lo}, {hi}), got {t.shape[0]}")
    most = max(b - a for a, b in (world.row_range(num_rows, r) for r in range(world.size)))
    pad = torch.zeros((most, *t.shape[1:]), dtype=t.dtype, device=t.device)
    pad[:hi - lo] = t
    parts = all_gather(world, pad)
    return torch.cat([parts[r, :b - a] for r, (a, b) in
                      enumerate(world.row_range(num_rows, r) for r in range(world.size))])


# --------------------------------------------------- the narrow int16 wire

def pack_int16_pairs(x: torch.Tensor) -> torch.Tensor:
    """int32 values within int16, [..., M] -> [..., ceil(M/2)] int32 words
    holding two of them (low half first). A SUM of such words over ranks
    carries each half's sum exactly while every partial sum of each half
    stays within int16 (`unpack_int16_pairs`): the reference's int16
    histogram reduction on backends with no int16 type."""
    if x.shape[-1] % 2:
        x = torch.cat([x, torch.zeros((*x.shape[:-1], 1), dtype=x.dtype, device=x.device)],
                      dim=-1)
    lo = x[..., 0::2].to(torch.int64)
    hi = x[..., 1::2].to(torch.int64)
    w = lo + hi * 65536
    return (((w + (1 << 31)) % (1 << 32)) - (1 << 31)).to(torch.int32)


def unpack_int16_pairs(w: torch.Tensor, m: int) -> torch.Tensor:
    """The inverse of `pack_int16_pairs` (on the words' SUM): [..., m] int32."""
    s = w.to(torch.int64)
    lo = ((s & 0xFFFF) ^ 0x8000) - 0x8000
    hi = (((s - lo) >> 16) & 0xFFFF ^ 0x8000) - 0x8000
    out = torch.stack([lo, hi], dim=-1).reshape(*w.shape[:-1], 2 * w.shape[-1])
    return out[..., :m].to(torch.int32)


# ------------------------------------------------------- host-side helpers

def shard_rows(arr, world: World, num_rows: Optional[int] = None):
    """This rank's block of a host array's rows (axis 0), or of the columns
    of a [G, N] bin plane when `num_rows` names axis 1's length (the
    counterpart of ``put_global`` with a row-sharded spec)."""
    if num_rows is not None and np.ndim(arr) == 2 and np.shape(arr)[1] == num_rows:
        lo, hi = world.row_range(num_rows)
        return arr[:, lo:hi]
    lo, hi = world.row_range(len(arr))
    return arr[lo:hi]


def host_value(t: torch.Tensor) -> np.ndarray:
    """A replicated result read on the host (every rank holds the same
    bits, so its own copy is the value)."""
    return t.detach().cpu().numpy()
