"""Build, load and count the launches of the port's CUDA kernels.

Each source under ``csrc/`` is compiled with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, at first use, into the
repository's ``build/`` directory (which .gitignore lists). The library is
named by the hash of its source and flags, so an edited source never loads
a stale build. Wrappers call the library through ``ctypes`` with pointers
from ``data_ptr()`` on PyTorch's current stream, and each counts its
kernel's launches, so a run can show that its work went through the kernel.

`build_all` starts one ``nvcc`` per source, all together, and waits for
them: the sources compile in parallel. Each build keeps ptxas's report
(`CudaLibrary.ptxas`, read by perfmodel.static_costs) and, like each graph
capture, is counted by the telemetry compile watcher.

`CountedGraph` records a function's launches as one CUDA graph and
replays it. The counters tick in the wrappers, on the host, so a capture
(which launches nothing) takes back what its wrappers counted, and each
replay adds the kernels the capture recorded: the counts stay counts of
kernels run on the card. A capture kept as a graph for a larger one (a
tree graph's root and waves, ops/wave_cuda.py:TreeGraph) is counted by
whoever knows how many times it ran (`count`).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional, Sequence

from .. import telemetry

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "lightgbm_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, else nvcc on PATH."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the port's CUDA "
                           "kernels are built from source at first use")
    return found


class CudaLibrary:
    """One CUDA source, its shared library and its kernels' launch counts.

    `declare(lib)` sets the ctypes argtypes/restype of the library's C
    functions once it is loaded."""

    def __init__(self, source: str, kernels: Sequence[str],
                 declare: Callable[[ctypes.CDLL], None],
                 extra_flags: Sequence[str] = ()) -> None:
        self.source = CSRC / source
        self.flags = tuple(NVCC_FLAGS) + tuple(extra_flags)
        self.launches: Dict[str, int] = {k: 0 for k in kernels}
        self._declare = declare
        self._lib: Optional[ctypes.CDLL] = None
        self.ptxas = ""  # ptxas -v's report of this process's last build
        self._lock = threading.Lock()
        _LIBRARIES.append(self)

    @property
    def path(self) -> Path:
        tag = hashlib.sha256(self.source.read_bytes()
                             + " ".join(self.flags).encode()).hexdigest()[:16]
        return BUILD_DIR / f"{self.source.stem}_{tag}.so"

    def _start(self, force: bool):
        """Start nvcc when the library is missing (or `force`); returns the
        running build or None."""
        lib = self.path
        if not force and lib.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        proc = subprocess.Popen([nvcc(), *self.flags, "-o", str(tmp), str(self.source)],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
        return proc, tmp, time.perf_counter()

    def _finish(self, started) -> Dict[str, object]:
        info: Dict[str, object] = {"source": str(self.source), "path": str(self.path),
                                   "seconds": 0.0, "ptxas": ""}
        if started is None:
            return info
        proc, tmp, t0 = started
        out, _ = proc.communicate()
        info["seconds"] = time.perf_counter() - t0
        info["ptxas"] = out
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {self.source.name}:\n{out}")
        os.replace(tmp, self.path)  # atomic: a racing process loads either file
        self.ptxas = out
        telemetry.note_compile(self.source.name, kernel=True)
        return info

    def build(self, force: bool = False) -> Dict[str, object]:
        """Compile the source unless its library exists (`force` compiles
        anyway). Returns the source, library path, build seconds (0 when
        already built) and ptxas's register / shared-memory / spill report."""
        return self._finish(self._start(force))

    def load(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(self.build()["path"])
                self._declare(lib)
                self._lib = lib
            return self._lib

    def count(self, name: str, err: int) -> None:
        """Count one launch of `name`; raise if the launch returned a CUDA
        error (a refused launch never runs)."""
        with self._lock:
            self.launches[name] += 1
        if err != 0:
            raise RuntimeError(f"{name} launch failed with CUDA error {err}")

    def add(self, name: str, n: int) -> None:
        """Add n launches of `name` (a graph's replays, or a capture's
        launches taken back)."""
        with self._lock:
            self.launches[name] += n

    def reset_launches(self) -> None:
        with self._lock:
            for name in self.launches:
                self.launches[name] = 0


_LIBRARIES: List[CudaLibrary] = []  # every library, for CountedGraph


def _launch_counts() -> Dict[tuple, int]:
    return {(i, name): n for i, lib in enumerate(_LIBRARIES)
            for name, n in list(lib.launches.items())}


class CountedGraph:
    """`fn`'s launches on the current CUDA device, captured once as a CUDA
    graph (on a capture stream of its own, with the graph's private memory
    pool) and run on the current stream by `replay`. The capture neither
    runs nor waits for anything on the card. fn must not read the card or
    synchronize, and whatever it reads or writes beyond its own temporaries
    must stay allocated as long as the graph: a replay runs on the same
    addresses. Kernels that set up lazily (loading a library, opting into
    shared memory) must have run once before the capture. A capture that
    fails raises; nothing falls back to launching eagerly."""

    def __init__(self, fn: Callable[[], None]) -> None:
        import torch

        # the captured cudaGraph_t stays (`graph.raw_cuda_graph()`) for a
        # larger graph to embed; it is instantiated only if replayed
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        before = _launch_counts()
        with torch.cuda.stream(torch.cuda.Stream()):
            self.graph.capture_begin()
            try:
                fn()
            finally:
                self.graph.capture_end()
        telemetry.note_compile(getattr(fn, "__qualname__", "graph"), kernel=False)
        after = _launch_counts()
        self.kernels = [(_LIBRARIES[i], name, n - before.get((i, name), 0))
                        for (i, name), n in after.items()
                        if n != before.get((i, name), 0)]
        self.count(-1)  # the capture ran nothing on the card

    def count(self, runs: int) -> None:
        """Add the captured kernels' launches of `runs` runs of the graph."""
        for lib, name, n in self.kernels:
            lib.add(name, runs * n)

    def replay(self) -> None:
        self.graph.replay()
        self.count(1)


def build_all(libraries: Iterable[CudaLibrary],
              force: bool = False) -> List[Dict[str, object]]:
    """Build several libraries with one nvcc each, all started together."""
    libraries = list(libraries)
    started = [lib._start(force) for lib in libraries]
    return [lib._finish(s) for lib, s in zip(libraries, started)]


def stream_of(tensor) -> int:
    """PyTorch's current CUDA stream on the tensor's device, as an int."""
    import torch

    return torch.cuda.current_stream(tensor.device).cuda_stream


def require_cuda(tensor, what: str) -> None:
    if tensor.device.type != "cuda":
        raise ValueError(f"{what} runs on cpu or cuda tensors, got one on "
                         f"{tensor.device}")
