"""Leaf-contiguous row compaction: a stable 2-way partition of K leaf ranges.

Counterpart of the JAX package's ``ops/compact_pallas.py``. The wave
learner (``treelearner/device.py``) keeps every per-row array in a
leaf-contiguous permutation, so a wave's histogram reads only the rows of
the leaves it splits. This module moves the rows: `range_partition_dst`
gives the forward map of a stable left|right partition of each selected
range (two exclusive scans and K-sized gathers, all exact int32), and
`compact_rows` applies it to the bin plane and the row payload.

A CPU tensor takes the plain version below (the permutation scatter of the
JAX package's XLA path, ``compact_pallas.py:330-334``); a CUDA tensor
launches the hand-written kernel (``ops/compact_cuda.py``,
``csrc/compact.cu``) or raises.

Not carried over: ``build_pair_tables``, ``max_pairs_bound``, ``_limbs`` and
the ``LGBM_TPU_COMPACT_ALIAS`` switch. They phrase the scatter as one-hot
bf16 matmuls over (input tile, output tile) pairs, for a TPU that has no
fast scatter; the card scatters each row directly. The per-row range base
is a gather from a K-entry table here, where the TPU used an [N, K]
membership matmul.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def exclusive_cumsum(x: torch.Tensor) -> torch.Tensor:
    """[N] -> [N] exclusive prefix sum (int32)."""
    x = x.to(torch.int32)
    return torch.cumsum(x, 0, dtype=torch.int32) - x


def range_partition_dst_by_range(go_left: torch.Tensor, rng: torch.Tensor,
                                 starts: torch.Tensor, counts: torch.Tensor,
                                 valid: torch.Tensor
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`range_partition_dst` with each row's range given as an index.

    go_left [N] bool; rng [N] int32: the range k < K that holds the row, K
    for a row in no valid range; starts/counts [K] int32 (disjoint ranges
    inside [0, N)); valid [K] bool. Returns (dst [N] int32, n_left [K]
    int32): rows outside every valid range keep their position; rows of
    range k land stably in [starts[k], starts[k] + n_left[k]) (left) or
    [starts[k] + n_left[k], ends[k]) (right)."""
    N = go_left.shape[0]
    K = starts.shape[0]
    pos = torch.arange(N, dtype=torch.int32, device=go_left.device)
    in_any = rng < K
    lmask = in_any & go_left
    rmask = in_any & ~go_left
    lcum = exclusive_cumsum(lmask)
    rcum = exclusive_cumsum(rmask)
    # length-(N+1) inclusive tails so ends[k] == N indexes safely
    lext = torch.cat([lcum, (lcum[-1:] + lmask[-1:].to(torch.int32))])
    rext = torch.cat([rcum, (rcum[-1:] + rmask[-1:].to(torch.int32))])
    s = torch.clamp(starts.to(torch.int64), 0, N)
    e = torch.clamp((starts + counts).to(torch.int64), 0, N)
    n_left = lext[e] - lext[s]
    base_l = starts - lext[s]
    base_r = starts + n_left - rext[s]
    r = torch.clamp(rng, max=max(K - 1, 0)).to(torch.int64)
    dst = torch.where(lmask, base_l[r] + lcum,
                      torch.where(rmask, base_r[r] + rcum, pos))
    return dst.to(torch.int32), torch.where(valid, n_left, 0).to(torch.int32)


def range_partition_dst(go_left: torch.Tensor, match: torch.Tensor,
                        starts: torch.Tensor, counts: torch.Tensor,
                        valid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward destination map of a stable 2-way partition of K disjoint
    position ranges, in the JAX package's argument layout.

    go_left [N] bool, match [N, K] bool (row-in-range membership, already
    masked by `valid`), starts/counts [K] int32, valid [K] bool. Returns
    (dst [N] int32, n_left [K] int32)."""
    K = match.shape[1]
    hit = match.to(torch.int32)
    rng = torch.where(match.any(dim=1), torch.argmax(hit, dim=1),
                      torch.full_like(hit[:, 0], K)).to(torch.int32)
    return range_partition_dst_by_range(go_left, rng, starts, counts, valid)


def _compact_rows_plain(bins: torch.Tensor, row_p: torch.Tensor, dst: torch.Tensor,
                        out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """out_bins[:, dst[n]] = bins[:, n], out_rows[dst[n]] = row_p[n]: the
    permutation scatter, exact."""
    idx = dst.to(torch.int64)
    if out is None:
        out = (torch.zeros_like(bins), torch.zeros_like(row_p))
    bins_o, row_o = out
    bins_o[:, idx] = bins
    row_o[idx] = row_p
    return bins_o, row_o


def compact_rows(bins: torch.Tensor, row_p: torch.Tensor, dst: torch.Tensor,
                 out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply the forward permutation dst [N] int32 to the bin plane bins
    [G, N] uint8 and the row payload row_p [N, rc] float32, bit-exactly.

    `out`, when given, is the pair of arrays written (the learner's second
    buffer; it must not alias the inputs). dst must be a permutation of
    [0, N). A CPU tensor takes the plain version; a CUDA tensor launches
    the kernel."""
    from .compact_cuda import compact

    return compact(bins, row_p, dst, out)
