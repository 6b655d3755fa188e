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

The wave learner calls `partition_wave` instead: the whole of a wave's row
partition from its K-entry tables (each row's range from its leaf id, its
side from a decision table over group bins, the forward map, the move, the
smaller child's slot vector and the children's ranges), and `relabel_rows`
for a wave's commit. Their plain versions compose the steps above; a CUDA
tensor launches ``csrc/wave_partition.cu``.

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


GROUP_BINS = 256  # every value a uint8 group bin can take


def _partition_wave_plain(bins: torch.Tensor, row_p: torch.Tensor, leaf_col: int,
                          leaf2k: Optional[torch.Tensor], rgroup: Optional[torch.Tensor],
                          lut: Optional[torch.Tensor], starts: torch.Tensor,
                          counts: torch.Tensor, valid: torch.Tensor, bagged: bool,
                          out: Optional[Tuple[torch.Tensor, torch.Tensor]],
                          slot_out: Optional[torch.Tensor]):
    """`partition_wave` composed of the steps of this module: each row's
    range and side, `range_partition_dst_by_range`, `compact_rows`, then the
    children's ranges and the slot vector."""
    N = bins.shape[1]
    K = starts.shape[0]
    dev = bins.device
    leaf = row_p[:, leaf_col].to(torch.int64)
    if bagged:
        rng = torch.zeros(N, dtype=torch.int32, device=dev)
        go_left = leaf == 0
    else:
        idx = leaf + 1
        inside = (idx >= 0) & (idx < leaf2k.shape[0])
        k = torch.where(inside, leaf2k[idx.clamp(0, leaf2k.shape[0] - 1)].to(torch.int64), K)
        rng = torch.where((k >= 0) & (k < K), k, K).to(torch.int32)
        r = rng.clamp(max=K - 1).to(torch.int64)
        gb = bins.gather(0, rgroup[r].to(torch.int64)[None, :])[0].to(torch.int64)
        go_left = (lut.reshape(-1)[r * GROUP_BINS + gb] != 0) & (rng < K)
    ok = valid != 0
    dst, n_left = range_partition_dst_by_range(go_left, rng, starts, counts, ok)
    bins_o, rows_o = _compact_rows_plain(bins, row_p, dst, out)
    n_right = counts - n_left
    left_small = n_left <= n_right
    small = torch.minimum(n_left, n_right)
    s_start = torch.where(left_small, starts, starts + n_left)
    s_end = s_start + small
    ranges = torch.stack([n_left, s_start, s_end]).to(torch.int32)
    flags = torch.stack([ok & (small > 0), left_small])
    if slot_out is not None:
        # a position keeps its range: the slot of the row that lands there
        pos = torch.arange(N, dtype=torch.int32, device=dev)
        none = torch.zeros(1, dtype=torch.int32, device=dev)
        r64 = rng.to(torch.int64)
        in_small = ((pos >= torch.cat([s_start, none])[r64])
                    & (pos < torch.cat([s_end, none])[r64]))
        slot_out.copy_(torch.where(in_small, rng, K))
    return bins_o, rows_o, ranges, flags


def partition_wave(bins: torch.Tensor, row_p: torch.Tensor, leaf_col: int,
                   leaf2k: Optional[torch.Tensor], rgroup: Optional[torch.Tensor],
                   lut: Optional[torch.Tensor], starts: torch.Tensor, counts: torch.Tensor,
                   valid: torch.Tensor, bagged: bool = False,
                   out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                   slot_out: Optional[torch.Tensor] = None):
    """One wave's stable 2-way partition of K disjoint row ranges, from the
    wave's K-entry tables (the JAX wave's ``_decide_go_left`` +
    ``range_partition_dst`` + ``compact_rows``,
    treelearner/device.py:603-646, and its slot vector, :662-666).

    bins [G, N] uint8 and row_p [N, rc] float32, whose column leaf_col is
    the row's leaf id, leaf-contiguous: range k is the positions
    [starts[k], starts[k] + counts[k]) and holds exactly the rows whose
    leaf2k[leaf + 1] is k; leaf2k maps only valid ranges (valid [K] != 0),
    every other row to K or past it. A row of range k goes left when
    lut[k, bins[rgroup[k], n]] != 0 (rgroup [>= K] int32, lut [>= K, 256]).
    `bagged`: one range [0, N) holding every row, left when the leaf id is
    0; leaf2k, rgroup and lut are not read.

    Writes `out` (bins, rows), the learner's second buffers (allocated when
    None; they must not alias the inputs), `slot_out` [N] int32 when given
    (k where the row lands in range k's smaller child, tie to the left, else
    K) when given. Returns (bins, rows,
    ranges [3, K] int32: n_left, the smaller child's start and end; flags
    [2, K] bool: the smaller child is valid and not empty, it is the left
    one). A CPU tensor takes the plain version; a CUDA tensor launches the
    three passes of the partition kernel."""
    from .compact_cuda import partition

    return partition(bins, row_p, leaf_col, leaf2k, rgroup, lut, starts, counts, valid,
                     bagged, out, slot_out)


def _relabel_rows_plain(row_p: torch.Tensor, leaf_col: int, table: torch.Tensor) -> None:
    mids, ends, new_ids = table.tolist()
    for mid, end, new_id in zip(mids, ends, new_ids):
        row_p[mid:end, leaf_col] = float(new_id)


def relabel_rows(row_p: torch.Tensor, leaf_col: int, table: torch.Tensor) -> None:
    """A wave's commit on the leaf-id column, in place: the rows at
    positions [mid[j], end[j]) (a committed range's right child) take leaf
    id new_id[j] (the JAX wave's relabel, treelearner/device.py:818-826).
    table [3, m] int64 (mid, end, new_id) on row_p's device, disjoint
    ranges; an empty range (end <= mid: a range the wave did not commit)
    relabels nothing. A CPU tensor takes the plain version; a CUDA tensor
    launches the relabel kernel, sized by row_p's rows alone."""
    from .compact_cuda import relabel

    relabel(row_p, leaf_col, table)
