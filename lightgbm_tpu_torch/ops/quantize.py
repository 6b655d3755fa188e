"""Gradient discretization for quantized-gradient training.

Counterpart of the JAX package's ``ops/quantize.py`` (GradientDiscretizer,
src/treelearner/gradient_discretizer.{hpp,cpp}): gradients and hessians are
quantized to small signed integers,

    g_scale = max|g| / (num_grad_quant_bins / 2)
    h_scale = max|h| / num_grad_quant_bins      (max|h| if constant hessian)
    g_int = trunc(g / g_scale +- r)   (r ~ U[0, 1) stochastic rounding,
                                       0.5 for nearest rounding)

and the histograms sum the integers exactly in int32; the split search
scales the integer bins back to float (ops/split.py:find_best_split's
`scale`).

The random draws are JAX's, bit for bit: the threefry2x32 counter-based
generator of ``jax.random`` in its partitionable layout
(``jax_threefry_partitionable``, jax 0.9's default), which is the layout the
JAX package trains with. A key is two uint32 words; ``PRNGKey(seed)`` is
[0, seed]; ``split(key)`` is the generator at counters (0, 0) and (0, 1);
the float32 uniform draw of row i takes the generator's two words at
counter (0, i), xors them, and keeps the top 23 bits as the mantissa of a
float in [1, 2), minus one. The key stream (a few words a tree) runs on the
host in numpy; the per-row draws run where the gradients are.

The JAX function is jitted, and XLA on the CPU contracts ``g * inv_g + r``
into one fused multiply-add. The plain version below computes that rounding
exactly (`_fma_f32`), and the CUDA kernel calls ``__fmaf_rn``.

A CPU tensor takes the plain version; a CUDA tensor launches the
hand-written kernel (``ops/quantize_cuda.py``, ``csrc/quantize.cu``) or
raises.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA  # threefry's key-schedule constant
EPS = 1e-35  # the floor under max|g| and max|h|


def int16_reduction_safe(row_count: int, num_grad_quant_bins: int) -> bool:
    """True when a quantized histogram bin over `row_count` rows provably
    fits int16, so a cross-device reduction can ship int16 instead of
    int32 (the reference's int16 histogram reduction,
    data_parallel_tree_learner.cpp:285-297). Conservative: assumes every
    row lands in one bin at the max quantized magnitude, with headroom
    under 2**15."""
    return row_count * num_grad_quant_bins < 32000


def threefry2x32(k0: int, k1: int, x0, x1):
    """Threefry-2x32, 20 rounds (Random123; ``jax.random``'s generator),
    of the key (k0, k1) at counters (x0, x1). The counters are uint64 numpy
    arrays or int64 tensors holding uint32 values; so are the two words
    returned."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = ((x1 << r) | (x1 >> (32 - r))) & MASK32
            x1 = x1 ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK32
    return x0, x1


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed: [0, seed mod 2**32]."""
    return np.array([0, int(seed) & MASK32], dtype=np.uint32)


def split_key(key: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """``jax.random.split(key)`` (two keys), on the host."""
    w0, w1 = threefry2x32(int(key[0]), int(key[1]), np.zeros(2, np.uint64),
                          np.arange(2, dtype=np.uint64))
    keys = np.stack([w0, w1], axis=1).astype(np.uint32)
    return keys[0], keys[1]


def uniform_bits(key: np.ndarray, n: int, device) -> torch.Tensor:
    """``jax.random.bits(key, (n,))``, uint32 values in an int64 [n]
    tensor: the two words at counter (0, i), xored."""
    i = torch.arange(n, dtype=torch.int64, device=device)
    w0, w1 = threefry2x32(int(key[0]), int(key[1]), i >> 32, i & MASK32)
    return w0 ^ w1


def uniform(key: np.ndarray, n: int, device) -> torch.Tensor:
    """``jax.random.uniform(key, (n,), dtype=float32)``: [n] float32 in [0, 1)."""
    bits = (uniform_bits(key, n, device) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


def _fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 a * b + c rounded once (a fused multiply-add). The product is
    exact in float64; the float64 sum is rounded to odd (TwoSum's error
    term says which way the exact sum lies), and rounding that to float32
    gives the singly rounded sum: float64 keeps more than 24 + 1 bits."""
    p = a.to(torch.float64) * b.to(torch.float64)
    q = c.to(torch.float64)
    s = p + q
    bq = s - p
    err = (p - (s - bq)) + (q - bq)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.full_like(s, float("inf")),
                         torch.full_like(s, float("-inf")))
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.to(torch.float32)


def _quantize_gh_plain(grad: torch.Tensor, hess: torch.Tensor, key: np.ndarray,
                       num_bins: int, stochastic: bool
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of `quantize_gh`, every expression in the JAX
    package's order (quantize.py:45-75)."""
    dev = grad.device
    n = grad.shape[0]
    eps = torch.tensor(EPS, dtype=torch.float32, device=dev)
    max_g = torch.maximum(grad.abs().amax(), eps)
    max_h = torch.maximum(hess.abs().amax(), eps)
    min_h = hess.amin()
    const_hess = (max_h - min_h) <= 1e-12 * max_h
    g_scale = max_g / (num_bins // 2)
    h_scale = torch.where(const_hess, max_h, max_h / num_bins)
    inv_g = 1.0 / g_scale
    inv_h = 1.0 / h_scale
    if stochastic:
        kg, kh = split_key(key)
        rg, rh = uniform(kg, n, dev), uniform(kh, n, dev)
    else:
        rg = rh = torch.full((n,), 0.5, dtype=torch.float32, device=dev)
    g_int = torch.trunc(torch.where(grad >= 0, _fma_f32(grad, inv_g, rg),
                                    _fma_f32(grad, inv_g, -rg))).to(torch.int8)
    h_int = torch.where(const_hess, torch.ones((), dtype=torch.int8, device=dev),
                        torch.trunc(_fma_f32(hess, inv_h, rh)).to(torch.int8))
    gh = torch.zeros((n + 1, 3), dtype=torch.int8, device=dev)
    gh[:n, 0] = g_int
    gh[:n, 1] = h_int
    gh[:n, 2] = 1
    one = torch.ones((), dtype=torch.float32, device=dev)
    return gh, torch.stack([g_scale, h_scale, one])


def quantize_gh(grad: torch.Tensor, hess: torch.Tensor, key: np.ndarray,
                num_bins: int = 4, stochastic: bool = True
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[N] float32 grad and hess (any stride) -> (gh [N+1, 3] int8: the
    (g_int, h_int, 1) rows and a zero sentinel row at N, the learners'
    extended gradient layout; scale [3] float32: (g_scale, h_scale, 1), the
    per-channel scale of the integer histograms). `key` is the tree's key
    (uint32 [2], host): its split gives the gradient's and the hessian's
    keys. A CPU tensor takes the plain version; a CUDA tensor is two
    launches of the kernel."""
    from .quantize_cuda import quantize

    return quantize(grad, hess, key, num_bins, stochastic)


def discretize_gradients(grad: torch.Tensor, hess: torch.Tensor, key: np.ndarray,
                         num_bins: int = 4, stochastic: bool = True):
    """[N] float grad/hess -> ([N] int8 g_int, [N] int8 h_int, g_scale,
    h_scale), the JAX package's function (GradientDiscretizer::
    DiscretizeGradients, gradient_discretizer.cpp:70-160). The hessian is
    quantized over [0, num_bins]; a constant hessian (max - min <= 1e-12
    max) gives h_int == 1 and h_scale = max|h|, the reference's
    is_constant_hessian branch."""
    gh, scale = quantize_gh(grad, hess, key, num_bins, stochastic)
    return gh[:-1, 0], gh[:-1, 1], scale[0], scale[1]
