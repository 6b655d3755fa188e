"""A wave's selection and replay: the plain PyTorch versions and the dispatch
to the kernels.

Counterpart of the per-wave work of the JAX grower around its partition,
histogram and split search (``lightgbm_tpu/treelearner/device.py``
``_grow_impl``): the frontier choice (:586-596), the guard on the children's
gains (``guard``, :310-315), the exact best-first replay (``replay_step``,
:750-799), the commit's tables (:801-826) and the loop condition (``cond``,
:838-840). The wave learner (``treelearner/device.py``) keeps the tree's
[L+1]-sized state on its device and calls `select_wave` before the wave's
partition and `replay_wave` after its split search, so a wave needs nothing
from the host.

The state, L = num_leaves:

    leaf_best  [L+1, REC] float32  each leaf's best split record (row L: -inf)
    depth      [L+1] int32
    start      [L+1] int32         each leaf's row range in the permuted rows
    count      [L+1] int32
    rec_store  [>= L-1, STORE] float32  the split log (replayed into a Tree)
    scalars    [SCALARS] int64     n_cur, t (splits committed), hist_rows
                                   (rows histogrammed), n_waves (live waves),
                                   done (the tree is finished)

A wave that starts with `done` set selects nothing, so it commits nothing
and leaves every output of the tree as it was.

A CPU tensor takes the plain version below; a CUDA tensor launches the
hand-written kernels (``ops/wave_cuda.py``, ``csrc/wave_step.cu``) or raises.
Both give the same bits: the float arithmetic is the replay's few float32
ops in the JAX grower's order, the rest is integer work.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..common import MISSING_NAN, MISSING_ZERO
from .compact import GROUP_BINS
from .split import SPLIT_FIELDS

REC = len(SPLIT_FIELDS)
# rec_store row: [leaf, parent_output, depth, valid] + SPLIT_FIELDS
STORE = REC + 4
N_CUR, T, HIST_ROWS, N_WAVES, DONE = range(5)  # the scalars' slots
SCALARS = 5
EPS = 1e-15  # the replay's floor under the parent's hessian (K_EPSILON)


class FeatureTables(NamedTuple):
    """Per-dense-feature decision fields for the row partition, on the
    learner's device."""

    group: torch.Tensor  # [F] int32 group row in the bin matrix
    lo: torch.Tensor  # [F] int32 EFB group-bin range
    hi: torch.Tensor  # [F] int32
    default_bin: torch.Tensor  # [F] int32
    nbins: torch.Tensor  # [F] int32
    missing_type: torch.Tensor  # [F] int32
    is_efb: torch.Tensor  # [F] bool


def decide_go_left(gb, thresh, default_left, missing_type, default_bin, nbins,
                   efb_lo, efb_hi, is_efb) -> torch.Tensor:
    """NumericalDecisionInner on raw group bins (the per-node twin of
    ops.partition.split_decision_bins; the JAX grower's `_decide_go_left`);
    all arguments broadcast."""
    gb = gb.to(torch.int32)
    in_range = (gb >= efb_lo) & (gb < efb_hi)
    shifted = gb - efb_lo
    natural = shifted + (shifted >= default_bin).to(torch.int32)
    fbin = torch.where(is_efb, torch.where(in_range, natural, default_bin), gb)
    is_missing = torch.where(missing_type == MISSING_NAN, fbin == nbins - 1,
                             (missing_type == MISSING_ZERO) & (fbin == default_bin))
    return torch.where(is_missing, default_left, fbin <= thresh)


def decision_table(tables: FeatureTables, feature: torch.Tensor, thresh: torch.Tensor,
                   default_left: torch.Tensor) -> torch.Tensor:
    """[K, 256] bool: go_left of each range's split (dense feature [K],
    threshold bin [K], default_left [K]) for every group bin value."""
    f = feature.to(torch.int64)

    def col(a):
        return a[:, None]

    gb = torch.arange(GROUP_BINS, dtype=torch.int32, device=f.device)[None, :]
    return decide_go_left(gb, col(thresh.to(torch.int32)), col(default_left),
                          col(tables.missing_type[f]), col(tables.default_bin[f]),
                          col(tables.nbins[f]), col(tables.lo[f]), col(tables.hi[f]),
                          col(tables.is_efb[f]))


def select_size(num_leaves: int, k: int) -> int:
    """Entries of `select_wave`'s int32 table."""
    return num_leaves + 2 + 5 * k + GROUP_BINS * k


def split_select(table: torch.Tensor, num_leaves: int, k: int):
    """Views of `select_wave`'s table: (leaf2k [L+2], rgroup, starts, counts,
    valid, sel [K], lut [K * 256]), the partition's inputs in its order."""
    return torch.split(table, [num_leaves + 2, k, k, k, k, k, k * GROUP_BINS])


def _select_wave_plain(leaf_best: torch.Tensor, start: torch.Tensor, count: torch.Tensor,
                       scalars: torch.Tensor, tables: FeatureTables, k: int) -> torch.Tensor:
    L = leaf_best.shape[0] - 1
    out = torch.empty(select_size(L, k), dtype=torch.int32, device=leaf_best.device)
    gains = leaf_best[:L, 0]
    # top K by gain, ties toward the lower leaf (jax.lax.top_k), NaN first
    sel = torch.sort(gains, descending=True, stable=True).indices[:k]
    ok = (gains[sel] > 0) & (scalars[DONE] == 0)
    recs = leaf_best[sel]
    feat = torch.where(ok, recs[:, 1], 0.0).to(torch.int64)
    thresh = torch.where(ok, recs[:, 2], 0.0).to(torch.int32)
    lut = decision_table(tables, feat, thresh, recs[:, 3] > 0.5) & ok[:, None]
    leaf2k, rgroup, s_k, c_k, ok_k, sel_k, lut_k = split_select(out, L, k)
    leaf2k.fill_(k)  # by leaf id + 1 (-1 -> none)
    leaf2k[sel[ok] + 1] = torch.nonzero(ok)[:, 0].to(torch.int32)
    rgroup.copy_(torch.where(ok, tables.group[feat], 0))
    s_k.copy_(start[sel])
    c_k.copy_(count[sel])
    ok_k.copy_(ok)
    sel_k.copy_(sel)
    lut_k.copy_(lut.reshape(-1))
    return out


def select_wave(leaf_best: torch.Tensor, start: torch.Tensor, count: torch.Tensor,
                scalars: torch.Tensor, tables: FeatureTables, k: int) -> torch.Tensor:
    """The wave's frontier choice and the partition's tables (the JAX
    wave, treelearner/device.py:586-596 and `_decide_go_left` at :128-139).

    The top k leaves of leaf_best[:L, 0] by gain, ties toward the lower
    leaf index as ``jax.lax.top_k`` breaks them (a NaN gain ranks first);
    a selected leaf is valid when its gain is positive and the tree is not
    done. Returns the int32 table of `select_size(L, k)` entries that `split_select` cuts into: leaf2k
    [L+2] (k for a leaf that is not a valid selection, indexed by leaf id
    + 1), rgroup [k] (the split feature's group row; 0 where invalid),
    starts and counts [k] (the leaves' row ranges), valid [k] (0 / 1), sel
    [k] (the leaf ids) and the [k, 256] decision table (each valid range's
    go_left for every group bin; 0 where invalid). A CPU tensor takes the
    plain version; a CUDA tensor launches the selection kernel."""
    from .wave_cuda import select

    return select(leaf_best, start, count, scalars, tables, k)


def guard_gain(gain: torch.Tensor, cnt: torch.Tensor, sum_h: torch.Tensor,
               depth: torch.Tensor, min_data: torch.Tensor, min_hess: torch.Tensor,
               max_depth: int) -> torch.Tensor:
    """BeforeFindBestSplit gates (serial_tree_learner.cpp:343; the JAX
    grower's `guard`) on float32 totals: the gain of a leaf that may not
    split becomes -inf."""
    ok = (cnt >= 2 * min_data) & (sum_h >= 2 * min_hess)
    if max_depth > 0:
        ok &= depth < max_depth
    return torch.where(ok, gain, gain.new_full((), float("-inf")))


def parent_output(ptot: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
    """The parent's leaf output from its (grad, hess) totals, float32 in the
    JAX replay's op order (device.py:779-783): -sign(g) * max(|g| - l1, 0)
    over max(h + l2, 1e-15), clipped to max_delta_step when positive."""
    l1, l2, max_delta = params[0], params[1], params[5]
    pnum = -torch.sign(ptot[0]) * torch.clamp(torch.abs(ptot[0]) - l1, min=0.0)
    pout = pnum / torch.clamp(ptot[1] + l2, min=EPS)
    if max_delta > 0:
        pout = torch.clamp(pout, -max_delta, max_delta)
    return pout


def _replay_wave_plain(leaf_best: torch.Tensor, depth: torch.Tensor,
                       rec_store: torch.Tensor, start: torch.Tensor, count: torch.Tensor,
                       scalars: torch.Tensor, table: torch.Tensor, n_left: torch.Tensor,
                       recs2: torch.Tensor, totals2: torch.Tensor, params: torch.Tensor,
                       max_depth: int) -> torch.Tensor:
    L = leaf_best.shape[0] - 1
    K = n_left.shape[0]
    out = torch.empty((5, K), dtype=torch.int64, device=leaf_best.device)
    _, _, s_k, c_k, ok_k, sel_k, _ = split_select(table, L, K)
    sel = sel_k.to(torch.int64)
    ok = ok_k != 0
    done_in = bool(scalars[DONE] != 0)
    # the guard on the 2K children (device.py:747), each at its parent's
    # depth + 1 before the replay moves any depth
    recs = recs2.clone()
    recs[:, 0] = guard_gain(recs2[:, 0], totals2[:, 2], totals2[:, 1],
                            torch.repeat_interleave(depth[sel] + 1, 2), params[2],
                            params[3], max_depth)
    n_cur, t = int(scalars[N_CUR]), int(scalars[T])
    committed = torch.zeros(K, dtype=torch.bool)
    newids = torch.zeros(K, dtype=torch.int64)
    while True:
        gains = leaf_best[:L, 0]
        b = int(torch.argmax(gains))  # the first maximum (a NaN first)
        top = gains[b]
        eq = (sel == b) & ok
        pos = int(torch.argmax(eq.to(torch.int8)))
        # ~committed[pos]: a left child keeps its parent's leaf id, and its
        # slot holds the PARENT's children, so it is never committed twice;
        # t < L - 1: the leaf budget binds mid-wave too
        if not (bool(top > 0) and bool(eq.any()) and not bool(committed[pos])
                and t < L - 1):
            break
        brec = leaf_best[b].clone()
        pout = parent_output(totals2[2 * pos] + totals2[2 * pos + 1], params)
        nd = depth[b] + 1
        depth[b] = nd
        depth[n_cur] = nd
        leaf_best[b] = recs[2 * pos]
        leaf_best[n_cur] = recs[2 * pos + 1]
        rec_store[t, 0] = float(b)
        rec_store[t, 1] = pout
        rec_store[t, 2] = nd.to(torch.float32)
        rec_store[t, 3] = 1.0
        rec_store[t, 4:] = brec
        committed[pos] = True
        newids[pos] = n_cur
        n_cur += 1
        t += 1
    committed = committed.to(leaf_best.device)
    newids = newids.to(leaf_best.device)
    nl = n_left.to(torch.int64)
    s, c = s_k.to(torch.int64), c_k.to(torch.int64)
    mid, end = s + nl, s + c
    none = torch.zeros_like(mid)
    out[0] = torch.where(committed, sel, L)  # the pool row of the left child
    out[1] = torch.where(committed, newids, L)  # ... of the right child
    out[2] = torch.where(committed, mid, none)  # relabel [mid, end) to newid
    out[3] = torch.where(committed, end, none)
    out[4] = torch.where(committed, newids, none)
    start[newids[committed]] = mid[committed].to(start.dtype)
    count[newids[committed]] = (c - nl)[committed].to(count.dtype)
    count[sel[committed]] = nl[committed].to(count.dtype)
    scalars[N_CUR] = n_cur
    scalars[T] = t
    scalars[HIST_ROWS] += torch.where(ok, torch.minimum(nl, c - nl), 0).sum()
    scalars[N_WAVES] += 0 if done_in else 1
    # the JAX grower's loop condition, on the state after the wave
    scalars[DONE] = int(done_in or not (t < L - 1 and bool(top > 0)))
    return out


def replay_wave(leaf_best: torch.Tensor, depth: torch.Tensor, rec_store: torch.Tensor,
                start: torch.Tensor, count: torch.Tensor, scalars: torch.Tensor,
                table: torch.Tensor, n_left: torch.Tensor, recs2: torch.Tensor,
                totals2: torch.Tensor, params: torch.Tensor, max_depth: int) -> torch.Tensor:
    """The wave's guard, exact best-first replay and commit tables (the JAX
    wave, treelearner/device.py:742-747 and :750-826, and its loop condition
    :838-840), in place on the tree's state.

    table: `select_wave`'s output for this wave; n_left [K] int32 (each
    range's left rows, from the partition); recs2 [2K, REC] float32 (the
    children's records, left then right, from find_best_split) and totals2
    [2K, CH] (their grad, hess, count); params the learner's [6] float32
    regularizers; max_depth as configured (<= 0: none).

    The guard sets to -inf the gain of a child that may not split. The
    replay commits the global argmax of leaf_best[:L, 0] (the first
    maximum) while it is a valid selection not yet split this wave and
    t < L - 1: its leaf keeps the left child, leaf n_cur takes the right,
    the split log takes row t (leaf, the parent's output, depth, 1, the
    parent's record). Then start / count of the committed children, and
    the scalars: n_cur, t, hist_rows (+ each valid range's smaller child),
    n_waves (+1 unless the wave started done), done (set unless t < L - 1
    and a gain is positive).

    Returns the commit's [5, K] int64 table: for each selected range k the pool rows of its left and right children
    and the relabel's range [mid, end) and new leaf id; a range that was
    not committed writes the dump row L twice and relabels the empty range
    [0, 0). A CPU tensor takes the plain version; a CUDA tensor launches
    the replay kernel."""
    from .wave_cuda import replay

    return replay(leaf_best, depth, rec_store, start, count, scalars, table, n_left, recs2,
                  totals2, params, max_depth)


def init_tree_state(leaf_best: torch.Tensor, depth: torch.Tensor, rec_store: torch.Tensor,
                    start: torch.Tensor, count: torch.Tensor, scalars: torch.Tensor,
                    root_rec: torch.Tensor, root_tot: torch.Tensor, n_in: torch.Tensor,
                    params: torch.Tensor, max_depth: int) -> None:
    """The state of a tree whose root holds the n_in [1] rows [0, n_in):
    the root's guarded record, every other leaf's gain -inf, no split, and
    done set unless the tree may split (L > 1 and the root's gain is
    positive: the JAX grower's `cond` before its first wave). Device ops
    only, no copy to the host."""
    L = leaf_best.shape[0] - 1
    leaf_best.fill_(float("-inf"))
    leaf_best[0] = root_rec
    leaf_best[0, 0] = guard_gain(root_rec[0], root_tot[2], root_tot[1],
                                 torch.zeros((), dtype=torch.int32, device=depth.device),
                                 params[2], params[3], max_depth)
    depth.zero_()
    rec_store.zero_()
    start.zero_()
    count.zero_()
    count[:1].copy_(n_in)
    # slices filled and copied in place: a Python number set into a CUDA
    # tensor's element goes through a host copy, which synchronizes
    scalars.zero_()
    scalars[N_CUR:N_CUR + 1].fill_(1)
    scalars[HIST_ROWS:HIST_ROWS + 1].copy_(n_in)
    if L > 1:
        scalars[DONE:DONE + 1].copy_(torch.logical_not(leaf_best[:1, 0] > 0))
    else:
        scalars[DONE:DONE + 1].fill_(1)
