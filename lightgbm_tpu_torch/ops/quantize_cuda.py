"""Wrapper of the CUDA gradient discretizer (csrc/quantize.cu).

`quantize` computes ``ops/quantize.py:quantize_gh``: the JAX package's
``discretize_gradients`` (``lightgbm_tpu/ops/quantize.py:45-75``, XLA glue
on the TPU, no Pallas kernel) and the packing of its output into the
learners' int8 (g, h, 1) rows, as two launches: a max/min reduction and the
quantize pass. The note at the top of the source gives the design and
bound. The library is built and loaded by ``ops/cuda_build.py``.

Dispatch is by the device of the gradients alone: a CPU tensor takes the
plain version (``ops/quantize.py:_quantize_gh_plain``); a CUDA tensor
launches the kernels, or raises. There is no fallback from one to the other.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from .cuda_build import CudaLibrary, require_cuda, stream_of
from .quantize import _quantize_gh_plain, split_key


def _declare(lib: ctypes.CDLL) -> None:
    ptr, i32, i64, u32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_uint
    lib.lgbt_quantize.argtypes = [ptr, i64, ptr, i64, i64, u32, u32, u32, u32, i32, i32, ptr,
                                  i32, i32, ptr, ptr, ptr]
    lib.lgbt_quantize.restype = i32


# --fmad=false: no multiply-add contracted but the two explicit __fmaf_rn
LIB = CudaLibrary("quantize.cu", ("quantize_reduce", "quantize"), _declare,
                  extra_flags=("--fmad=false",))
launches = LIB.launches
reset_launches = LIB.reset_launches

THREADS = 512            # csrc/quantize.cu kThreads
MAX_REDUCE_BLOCKS = 256  # ... kMaxReduceBlocks
MAX_QUANTIZE_BLOCKS = 1024


def launch_shape(n: int) -> Tuple[int, int]:
    """(reduce blocks, quantize blocks) for n rows: a block a THREADS rows,
    capped; both passes stride over the rest."""
    blocks = -(-n // THREADS)
    return min(blocks, MAX_REDUCE_BLOCKS), min(blocks, MAX_QUANTIZE_BLOCKS)


def quantize(grad: torch.Tensor, hess: torch.Tensor, key: np.ndarray, num_bins: int,
             stochastic: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """(gh [N+1, 3] int8, scale [3] float32) of ops/quantize.py:quantize_gh.
    A CPU tensor takes the plain version; a CUDA tensor launches the
    reduction and the quantize pass."""
    if num_bins < 2:
        raise ValueError(f"num_grad_quant_bins must be at least 2, got {num_bins}")
    if grad.device.type == "cpu":
        return _quantize_gh_plain(grad, hess, key, num_bins, stochastic)
    require_cuda(grad, "the gradient discretizer")
    dev = grad.device
    for name, t in (("grad", grad), ("hess", hess)):
        if t.dtype != torch.float32 or t.dim() != 1 or t.device != dev:
            raise ValueError(f"{name} must be a float32 vector on {dev}, got {t.dtype} "
                             f"{list(t.shape)} on {t.device}")
    n = grad.shape[0]
    if hess.shape[0] != n or not 1 <= n < 1 << 32:
        raise ValueError(f"grad and hess must hold the same 1 to 2**32 - 1 rows, got {n} "
                         f"and {hess.shape[0]}")
    kg, kh = split_key(key) if stochastic else (np.zeros(2, np.uint32),) * 2
    reduce_blocks, quantize_blocks = launch_shape(n)
    partials = torch.empty(reduce_blocks * 3, dtype=torch.float32, device=dev)
    out = torch.empty((n + 1, 3), dtype=torch.int8, device=dev)
    scale = torch.empty(3, dtype=torch.float32, device=dev)
    lib = LIB.load()
    with torch.cuda.device(dev):
        err = lib.lgbt_quantize(grad.data_ptr(), grad.stride(0), hess.data_ptr(),
                                hess.stride(0), n, int(kg[0]), int(kg[1]), int(kh[0]),
                                int(kh[1]), int(num_bins), int(bool(stochastic)),
                                partials.data_ptr(), reduce_blocks, quantize_blocks,
                                out.data_ptr(), scale.data_ptr(), stream_of(grad))
    LIB.count("quantize_reduce", err)
    LIB.count("quantize", err)
    return out, scale
