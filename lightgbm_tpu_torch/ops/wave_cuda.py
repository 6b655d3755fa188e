"""Wrappers of the wave's selection and replay kernels (csrc/wave_step.cu).

`select` is ``ops/wave.py:select_wave`` and `replay` is `replay_wave`: the
wave learner's per-wave work around its partition, histogram and split
search, which the JAX grower computes in XLA inside its while_loop
(``lightgbm_tpu/treelearner/device.py`` :586-596, :310-315, :750-840). The
note at the top of the source gives their design and bound. The library is
built and loaded by ``ops/cuda_build.py``, with ``--fmad=false`` so the
parent's output rounds as the plain version's separate float32 ops do.

Dispatch is by the device of leaf_best alone: a CPU tensor takes the plain
version (``ops/wave.py``); a CUDA tensor launches the kernel, or raises.
There is no fallback from one to the other. Neither wrapper reads the card:
both are safe inside a CUDA graph capture.
"""
from __future__ import annotations

import ctypes

import torch

from .. import telemetry
from .cuda_build import CudaLibrary, require_cuda, stream_of
from .wave import (REC, SCALARS, STORE, FeatureTables, _replay_wave_plain,
                   _select_wave_plain, select_size)


def _declare(lib: ctypes.CDLL) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.lgbt_wave_select.argtypes = [ptr, i32, ptr, ptr, ptr] + [ptr] * 7 + [i32, ptr, ptr]
    lib.lgbt_wave_replay.argtypes = ([ptr] * 10 + [i32, ptr, i32, i32, i32, ptr, ptr])
    lib.lgbt_tree_graph.argtypes = [ptr] * 5 + [ctypes.c_longlong, ctypes.POINTER(ptr)]
    lib.lgbt_tree_graph_launch.argtypes = [ptr, ptr]
    lib.lgbt_tree_graph_destroy.argtypes = [ptr]
    for fn in (lib.lgbt_wave_select, lib.lgbt_wave_replay, lib.lgbt_tree_graph,
               lib.lgbt_tree_graph_launch, lib.lgbt_tree_graph_destroy):
        fn.restype = i32


LIB = CudaLibrary("wave_step.cu", ("wave_select", "wave_replay", "tree_loop_cond"), _declare,
                  extra_flags=("--fmad=false",))
launches = LIB.launches
reset_launches = LIB.reset_launches
MAX_K = 1024  # csrc/wave_step.cu kMaxK


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple,
           device: torch.device) -> None:
    if t.dtype != dtype or tuple(t.shape) != shape or t.device != device \
            or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {dtype} {list(shape)} tensor on "
                         f"{device}, got {t.dtype} {list(t.shape)} on {t.device}")


def _check_state(leaf_best: torch.Tensor, start: torch.Tensor, count: torch.Tensor,
                 scalars: torch.Tensor, k: int) -> int:
    """Raise ValueError on state the kernels do not take; returns L."""
    dev = leaf_best.device
    if leaf_best.dim() != 2 or leaf_best.shape[0] < 2:
        raise ValueError(f"leaf_best must be [L+1, {REC}] with L >= 1, got "
                         f"{list(leaf_best.shape)}")
    L = leaf_best.shape[0] - 1
    _check("leaf_best", leaf_best, torch.float32, (L + 1, REC), dev)
    _check("start", start, torch.int32, (L + 1,), dev)
    _check("count", count, torch.int32, (L + 1,), dev)
    _check("scalars", scalars, torch.int64, (SCALARS,), dev)
    if not 1 <= k <= min(L, MAX_K):
        raise ValueError(f"a wave selects 1 to min(L, {MAX_K}) leaves, got {k} of {L}")
    return L


def select(leaf_best: torch.Tensor, start: torch.Tensor, count: torch.Tensor,
           scalars: torch.Tensor, tables: FeatureTables, k: int) -> torch.Tensor:
    """The wave's selection (ops/wave.py:select_wave). A CPU tensor takes the
    plain version; a CUDA tensor launches the selection kernel."""
    dev = leaf_best.device
    if dev.type == "cpu":
        return _select_wave_plain(leaf_best, start, count, scalars, tables, k)
    require_cuda(leaf_best, "the wave selection")
    L = _check_state(leaf_best, start, count, scalars, k)
    F = tables.group.shape[0]
    for name in ("group", "lo", "hi", "default_bin", "nbins", "missing_type"):
        _check(f"tables.{name}", getattr(tables, name), torch.int32, (F,), dev)
    _check("tables.is_efb", tables.is_efb, torch.bool, (F,), dev)
    out = torch.empty(select_size(L, k), dtype=torch.int32, device=dev)
    lib = LIB.load()
    with torch.cuda.device(dev):
        err = lib.lgbt_wave_select(
            leaf_best.data_ptr(), L, start.data_ptr(), count.data_ptr(), scalars.data_ptr(),
            *(t.data_ptr() for t in tables), k, out.data_ptr(), stream_of(leaf_best))
    LIB.count("wave_select", err)
    return out


def replay(leaf_best: torch.Tensor, depth: torch.Tensor, rec_store: torch.Tensor,
           start: torch.Tensor, count: torch.Tensor, scalars: torch.Tensor,
           table: torch.Tensor, n_left: torch.Tensor, recs2: torch.Tensor,
           totals2: torch.Tensor, params: torch.Tensor, max_depth: int) -> torch.Tensor:
    """The wave's guard, replay and commit tables (ops/wave.py:replay_wave).
    A CPU tensor takes the plain version; a CUDA tensor launches the replay
    kernel."""
    dev = leaf_best.device
    K = n_left.shape[0]
    if dev.type == "cpu":
        return _replay_wave_plain(leaf_best, depth, rec_store, start, count, scalars, table,
                                  n_left, recs2, totals2, params, max_depth)
    require_cuda(leaf_best, "the wave replay")
    L = _check_state(leaf_best, start, count, scalars, K)
    _check("depth", depth, torch.int32, (L + 1,), dev)
    if rec_store.dim() != 2 or rec_store.shape[0] < L - 1 or rec_store.shape[1] != STORE:
        raise ValueError(f"rec_store must be [>= L-1, {STORE}], got {list(rec_store.shape)}")
    _check("rec_store", rec_store, torch.float32, tuple(rec_store.shape), dev)
    _check("table", table, torch.int32, (select_size(L, K),), dev)
    _check("n_left", n_left, torch.int32, (K,), dev)
    _check("recs2", recs2, torch.float32, (2 * K, REC), dev)
    if totals2.dim() != 2 or totals2.shape[0] != 2 * K or totals2.shape[1] < 3:
        raise ValueError(f"totals2 must be [2K, >= 3], got {list(totals2.shape)}")
    _check("totals2", totals2, torch.float32, tuple(totals2.shape), dev)
    if params.dtype != torch.float32 or params.dim() != 1 or params.shape[0] < 6 \
            or params.device != dev or not params.is_contiguous():
        raise ValueError(f"params must be a contiguous float32 vector of at least 6 "
                         f"values on {dev}")
    out = torch.empty((5, K), dtype=torch.int64, device=dev)
    lib = LIB.load()
    with torch.cuda.device(dev):
        err = lib.lgbt_wave_replay(
            leaf_best.data_ptr(), depth.data_ptr(), rec_store.data_ptr(), start.data_ptr(),
            count.data_ptr(), scalars.data_ptr(), table.data_ptr(), n_left.data_ptr(),
            recs2.data_ptr(), totals2.data_ptr(), totals2.shape[1], params.data_ptr(),
            int(max_depth), L, K, out.data_ptr(), stream_of(leaf_best))
    LIB.count("wave_replay", err)
    return out


class TreeGraph:
    """One tree's launches as one executable CUDA graph (csrc/wave_step.cu
    lgbt_tree_graph): `root`, then a WHILE node that runs `wave0` then
    `wave1` while the done word scalars[DONE] is 0, for at most
    `max_passes` passes. root, wave0 and wave1 are captures kept with
    ``torch.cuda.CUDAGraph(keep_graph=True)``; the executable graph holds
    clones of them, so they may be dropped once it is built, but the memory
    their captures allocated (their pools) must stay while it lives: the
    caller keeps the three CUDAGraphs. The condition kernel adds one to
    passes [1] int64 after each pass (root must zero it); it is the loop's
    only reader of the card, and the host reads no word while the tree
    runs. A pass past max_passes ends the loop with passes above the bound.

    The condition kernel launches once before the loop and once a pass: the
    caller counts them (`count_condition`) once it knows the passes."""

    def __init__(self, root, wave0, wave1, scalars: torch.Tensor, passes: torch.Tensor,
                 max_passes: int) -> None:
        require_cuda(scalars, "the tree graph")
        _check("scalars", scalars, torch.int64, (SCALARS,), scalars.device)
        _check("passes", passes, torch.int64, (1,), scalars.device)
        lib = LIB.load()
        handle = ctypes.c_void_p()
        with torch.cuda.device(scalars.device):
            err = lib.lgbt_tree_graph(root.raw_cuda_graph(), wave0.raw_cuda_graph(),
                                      wave1.raw_cuda_graph(), scalars.data_ptr(),
                                      passes.data_ptr(), int(max_passes), ctypes.byref(handle))
        if err != 0:
            raise RuntimeError(f"building the tree graph failed with CUDA error {err}")
        telemetry.note_compile("tree_graph", kernel=False)
        self._lib, self._exec = lib, handle
        self.device = scalars.device
        self.max_passes = int(max_passes)

    def launch(self) -> None:
        """Enqueue the tree on the current stream; reads nothing back."""
        with torch.cuda.device(self.device):
            err = self._lib.lgbt_tree_graph_launch(
                self._exec, torch.cuda.current_stream(self.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"the tree graph's launch failed with CUDA error {err}")

    @staticmethod
    def count_condition(passes: int) -> None:
        """Count the condition kernel's launches of a tree that ran `passes`."""
        LIB.add("tree_loop_cond", 1 + int(passes))

    def __del__(self) -> None:
        if getattr(self, "_exec", None) is not None:
            self._lib.lgbt_tree_graph_destroy(self._exec)
            self._exec = None
