"""Vectorized best-split search over histograms.

Counterpart of the JAX package's ``ops/split.py`` (FeatureHistogram::
FindBestThreshold, src/treelearner/feature_histogram.hpp:165,832): the whole
search is one computation over a dense [F, Bmax, 3] feature-histogram
tensor,

    prefix over bins -> left/right aggregates for every threshold
    -> regularized gains for both missing directions -> masked argmax.

Missing-value directionality becomes two gain lanes: the missing bin's mass
(NaN bin for MissingType::NaN, default/zero bin for MissingType::Zero) is
pulled out of the ordered scan and added to the left side in the
"default-left" lane only. Bundled features (EFB) omit their default bin in
group storage; it is reconstructed from the leaf totals like
Dataset::FixHistogram (include/LightGBM/dataset.h:770).

Categorical features take the JAX package's categorical lanes
(`per_feature_best_categorical`, FindBestThresholdCategoricalInner): the
one-hot lane and the sorted-subset lane in both directions. They run in
PyTorch ops on the histogram's device, after the split kernel has found the
best numeric record, and replace it only where their gain is strictly
larger (the JAX package concatenates the numeric records first, so a tie
goes to the numeric record). A monotone-constrained search (`constraint`,
the leaf's basic-mode output bounds) clamps each candidate's outputs into
the bounds, discards a split on a monotone feature whose clamped outputs go
against its direction and scores the rest from the clamped outputs (the
JAX package's per_feature_best, split.py:402-411, 442-444); the
categorical lanes clamp only their record's outputs. A quantized (int32)
histogram is searched as the float histogram hist.float() * scale
(`find_best_split`'s `scale`).
The numeric search goes through ``ops/scan_cuda.py``: the plain version below for a
CPU tensor, the hand-written kernel (``csrc/split_find.cu``) for a CUDA
tensor. `find_best_split` is one launch there, from the group histogram to
each leaf's record; `per_feature_best` keeps a launch that returns every
feature's record.

The two float sums over a feature's bins, the EFB default bin's missing
mass and the prefix of the scan, are float64 in the kernel's order, which
`bin_sum` and `bin_prefix` emulate exactly: the bins cut into SCAN_LANES
chunks of consecutive bins, each chunk summed in order, a Kogge-Stone scan
over the chunk sums, then each chunk's prefix from its left neighbours'
sum. On grid-snapped histograms every such sum is exact, so the order
changes nothing there.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from .. import telemetry
from ..common import MISSING_NAN, MISSING_NONE

K_EPSILON = 1e-15


@dataclass
class FeatureMeta:
    """Per-feature split metadata on the training device, built once per
    dataset."""

    gather_index: torch.Tensor  # [F, Bmax] int64 into flattened group-hist rows (+ sentinel)
    valid_slot: torch.Tensor  # [F, Bmax] bool
    default_bin: torch.Tensor  # [F] int64 zero/default bin (feature-bin space)
    efb_omitted: torch.Tensor  # [F] bool: default bin omitted in storage (EFB bundle)
    missing_type: torch.Tensor  # [F] int32
    nbins: torch.Tensor  # [F] int32 bins per feature
    is_categorical: torch.Tensor  # [F] bool
    monotone: torch.Tensor  # [F] int8 (-1 / 0 / +1)
    # derived from the above for the scan: the missing bin's position
    # (NaN bin last, else the default bin) and whether there is one
    missing_pos: torch.Tensor  # [F] int32
    has_missing: torch.Tensor  # [F] bool
    # host-side
    real_feature: List[int]  # dense idx -> original feature index
    max_bins: int
    hist_rows: int  # rows in the flattened group-hist (without sentinel)
    has_categorical: bool = False  # whether find_best_split runs the categorical lanes


def make_feature_meta(dataset, group_bin_padded: int,
                      device: torch.device) -> FeatureMeta:
    """Build FeatureMeta from a constructed io.dataset.Dataset.

    group_bin_padded is the per-group bin-axis padding of the histograms
    ([G, group_bin_padded, 3]); the flat row index of group g bin b is
    g * group_bin_padded + b.
    """
    feats = dataset.used_features
    F = len(feats)
    Bmax = max((dataset.mappers[f].num_bin for f in feats), default=2)
    gather = np.zeros((F, Bmax), dtype=np.int64)
    valid = np.zeros((F, Bmax), dtype=bool)
    default_bin = np.zeros(F, dtype=np.int64)
    efb_omitted = np.zeros(F, dtype=bool)
    missing = np.zeros(F, dtype=np.int32)
    nbins = np.zeros(F, dtype=np.int32)
    is_cat = np.zeros(F, dtype=bool)
    mono = np.zeros(F, dtype=np.int8)
    G = dataset.num_groups
    sentinel = G * group_bin_padded  # flat index of the all-zero sentinel row
    for k, f in enumerate(feats):
        m = dataset.mappers[f]
        gi, mi = dataset.feature_to_group[f]
        fg = dataset.groups[gi]
        nb = m.num_bin
        nbins[k] = nb
        missing[k] = m.missing_type
        is_cat[k] = m.bin_type == 1
        if dataset.monotone_constraints:
            mono[k] = dataset.monotone_constraints[f]
        lo, hi, dbin = fg.feature_bin_range(mi)
        gather[k, :] = sentinel
        default_bin[k] = m.default_bin
        if not fg.is_multi:
            for b in range(nb):
                gather[k, b] = gi * group_bin_padded + b
                valid[k, b] = True
        else:
            # bundle member: natural bin b != default lives at
            # lo + b - (b > default); default bin is reconstructed
            for b in range(nb):
                valid[k, b] = True
                if b == dbin:
                    continue
                slot = lo + b - (1 if b > dbin else 0)
                gather[k, b] = gi * group_bin_padded + slot
            efb_omitted[k] = True
    missing_pos = np.where(missing == MISSING_NAN, nbins - 1,
                           default_bin).astype(np.int32)

    def dev(a):
        return torch.as_tensor(a, device=device)

    return FeatureMeta(
        gather_index=dev(gather), valid_slot=dev(valid),
        default_bin=dev(default_bin), efb_omitted=dev(efb_omitted),
        missing_type=dev(missing), nbins=dev(nbins), is_categorical=dev(is_cat),
        monotone=dev(mono), missing_pos=dev(missing_pos),
        has_missing=dev(missing != MISSING_NONE),
        real_feature=list(feats), max_bins=Bmax, hist_rows=G * group_bin_padded,
        has_categorical=bool(is_cat.any()))


def threshold_l1(s, l1):
    # The op order is pinned (the JAX package pins it with an optimization
    # barrier, split.py:208-220): the soft-thresholded gradient is rounded
    # to float32 before it feeds the output division and the gain products.
    # PyTorch runs each op on its own, so the order here is the order run;
    # the CUDA split kernel repeats it op for op.
    return torch.sign(s) * torch.clamp(torch.abs(s) - l1, min=0.0)


def leaf_output(sum_grad, sum_hess, l1, l2, max_delta_step):
    """CalculateSplittedLeafOutput (feature_histogram.hpp)."""
    num = -threshold_l1(sum_grad, l1)
    out = num / torch.clamp(sum_hess + l2, min=K_EPSILON)
    return torch.where(max_delta_step > 0,
                       torch.clamp(out, -max_delta_step, max_delta_step), out)


def leaf_gain_given_output(sum_grad, sum_hess, l1, l2, output):
    g = threshold_l1(sum_grad, l1)
    return -(2.0 * g * output + (sum_hess + l2) * output * output)


def leaf_gain(sum_grad, sum_hess, l1, l2, max_delta_step):
    out = leaf_output(sum_grad, sum_hess, l1, l2, max_delta_step)
    return leaf_gain_given_output(sum_grad, sum_hess, l1, l2, out)


def constraint_bounds(constraint, device: torch.device):
    """A leaf's (min, max) output bounds, given as two host floats, as
    float32 scalars on `device`: each rounded to float32 once, as the JAX
    learner's jnp.asarray(bounds, float32) rounds them."""
    lo, hi = (float(v) for v in constraint)
    return (torch.tensor(lo, dtype=torch.float32, device=device),
            torch.tensor(hi, dtype=torch.float32, device=device))


def clip_output(out, lo, hi):
    """jnp.clip(out, lo, hi): max with lo, then min with hi (NaN stays
    NaN; crossed bounds give hi)."""
    return torch.minimum(torch.maximum(out, lo), hi)


# Packed best-split record layout (device -> host, one sync per leaf). The
# last two fields (is_cat, cat_dir) stay zero for the numeric lanes. For a
# categorical split threshold_bin holds the one-hot bin (cat_dir 0) or the
# sorted subset's LENGTH (cat_dir +1 or -1, the scan's direction); the host
# derives the bin set from the feature's histogram row
# (`derive_cat_left_bins`).
SPLIT_FIELDS = ["gain", "feature", "threshold_bin", "default_left",
                "left_sum_g", "left_sum_h", "left_count",
                "right_sum_g", "right_sum_h", "right_count",
                "left_output", "right_output", "is_cat", "cat_dir"]


@dataclass
class SplitInfo:
    """Host-side split record (counterpart of split_info.hpp SplitInfo)."""

    gain: float = -np.inf
    feature: int = -1  # dense (used-feature) index
    threshold_bin: int = 0
    default_left: bool = False
    left_sum_g: float = 0.0
    left_sum_h: float = 0.0
    left_count: int = 0
    right_sum_g: float = 0.0
    right_sum_h: float = 0.0
    right_count: int = 0
    left_output: float = 0.0
    right_output: float = 0.0
    is_categorical: bool = False
    cat_dir: int = 0  # 0 = one-hot; +1 / -1 = the sorted subset's direction
    cat_bitset_bins: Optional[List[int]] = None  # the left bin set, once derived

    @property
    def valid(self) -> bool:
        return self.feature >= 0 and np.isfinite(self.gain) and self.gain > 0

    @classmethod
    def from_packed(cls, vec: np.ndarray) -> "SplitInfo":
        return cls(gain=float(vec[0]), feature=int(vec[1]),
                   threshold_bin=int(vec[2]), default_left=bool(vec[3] > 0.5),
                   left_sum_g=float(vec[4]), left_sum_h=float(vec[5]),
                   left_count=int(round(vec[6])), right_sum_g=float(vec[7]),
                   right_sum_h=float(vec[8]), right_count=int(round(vec[9])),
                   left_output=float(vec[10]), right_output=float(vec[11]),
                   is_categorical=bool(vec[12] > 0.5), cat_dir=int(round(vec[13])))


SCAN_LANES = 32  # csrc/split_find.cu: a warp's lanes share a feature's bins


def _lane_chunks(x: torch.Tensor):
    """[..., B, CH] -> ([..., SCAN_LANES, P, CH] float64, zero past B; P):
    lane j's bins are [jP, jP + P)."""
    B, CH = x.shape[-2], x.shape[-1]
    P = max(1, -(-B // SCAN_LANES))
    xp = torch.nn.functional.pad(x.to(torch.float64), (0, 0, 0, SCAN_LANES * P - B))
    return xp.reshape(*x.shape[:-2], SCAN_LANES, P, CH), P


def _lane_scan(xp: torch.Tensor, P: int) -> torch.Tensor:
    """Each lane's chunk summed in order from +0.0, then the inclusive
    Kogge-Stone scan of the lane sums (offsets 1, 2, 4, 8, 16):
    [..., SCAN_LANES, CH] float64."""
    s = torch.zeros_like(xp[..., 0, :])
    for i in range(P):
        s = s + xp[..., i, :]
    d = 1
    while d < SCAN_LANES:
        s = torch.cat([s[..., :d, :], s[..., :-d, :] + s[..., d:, :]], dim=-2)
        d *= 2
    return s


def bin_sum(x: torch.Tensor) -> torch.Tensor:
    """[..., B, CH] float32 -> [..., CH] float64: the sum over bins in the
    split kernel's order."""
    xp, P = _lane_chunks(x)
    return _lane_scan(xp, P)[..., -1, :]


def bin_prefix(x: torch.Tensor) -> torch.Tensor:
    """[..., B, CH] float32 -> [..., B, CH] float32: the inclusive prefix over
    bins, summed in float64 in the split kernel's order and rounded to
    float32 at every bin."""
    B = x.shape[-2]
    xp, P = _lane_chunks(x)
    s = _lane_scan(xp, P)
    acc = torch.cat([torch.zeros_like(s[..., :1, :]), s[..., :-1, :]], dim=-2)
    prefix = []
    for i in range(P):
        acc = acc + xp[..., i, :]
        prefix.append(acc)
    out = torch.stack(prefix, dim=-2).reshape(*x.shape[:-2], SCAN_LANES * P, x.shape[-1])
    return out[..., :B, :].to(torch.float32)


def gather_feature_hist_raw(hist: torch.Tensor, gather_index: torch.Tensor,
                            valid_slot: torch.Tensor) -> torch.Tensor:
    """[..., G, Bg, CH] group hist -> [..., F, Bmax, CH] by pure index
    gather, no EFB reconstruction (a leading leaf dimension is batched)."""
    CH = hist.shape[-1]
    flat = hist.reshape(*hist.shape[:-3], -1, CH)
    flat = torch.cat([flat, torch.zeros((*flat.shape[:-2], 1, CH), dtype=flat.dtype,
                                        device=flat.device)], dim=-2)
    fh = flat[..., gather_index, :]  # [..., F, Bmax, CH]
    return fh * valid_slot[:, :, None].to(fh.dtype)


def fix_feature_hist(fh: torch.Tensor, totals: torch.Tensor,
                     efb_omitted: torch.Tensor,
                     default_bin: torch.Tensor) -> torch.Tensor:
    """EFB default-bin reconstruction: default = leaf totals - sum(other
    bins), added at the default bin of bundle members only (FixHistogram,
    include/LightGBM/dataset.h:770). A dtype-preserving multiply, so an
    integer histogram stays exact; a float one sums its bins in the split
    kernel's order (`bin_sum`). fh [..., F, Bmax, CH], totals [..., CH]."""
    if fh.dtype.is_floating_point:
        stored = bin_sum(fh).to(fh.dtype)
    else:
        stored = fh.sum(dim=-2)
    missing_mass = totals[..., None, :].to(fh.dtype) - stored  # [..., F, CH]
    add = missing_mass * efb_omitted[:, None].to(fh.dtype)
    rows = torch.arange(fh.shape[-3], device=fh.device)
    out = fh.clone()
    out[..., rows, default_bin, :] += add
    return out


def gather_feature_hist(hist: torch.Tensor, meta: FeatureMeta,
                        totals: torch.Tensor) -> torch.Tensor:
    """[..., G, Bg, 3] group hist -> [..., F, Bmax, 3] feature hist with EFB
    default reconstruction (FixHistogram)."""
    fh = gather_feature_hist_raw(hist, meta.gather_index, meta.valid_slot)
    return fix_feature_hist(fh, totals, meta.efb_omitted, meta.default_bin)


def _per_feature_best_plain(fh: torch.Tensor, totals: torch.Tensor,
                            meta: FeatureMeta, params: torch.Tensor,
                            feature_mask: Optional[torch.Tensor] = None,
                            penalty: Optional[torch.Tensor] = None,
                            constraint=None) -> torch.Tensor:
    """The numeric lanes of the JAX package's per_feature_best, over
    fh [..., F, Bmax, 3] and totals [..., 3] (a leading leaf dimension is
    batched; every op is elementwise or runs along the bin axis, so each
    leaf's records are the one-leaf call's bits).

    `constraint`, a leaf's (min, max) output bounds as two host floats,
    selects the constrained lane, step by step the JAX package's
    (split.py:402-411, 442-444): each candidate's two outputs clamped into
    the bounds, a split on a monotone feature whose clamped outputs go
    against its direction discarded, the gain from the clamped outputs,
    and the record's outputs clamped.

    The prefix over bins is a float64 sum in the kernel's order rounded to
    float32 at every bin (`bin_prefix`). It differs from the JAX package's
    float32 cumsum in the last bit at most per step, and not at all on
    grid-snapped histograms, whose sums are exact."""
    l1, l2, min_data, min_hess, min_gain, max_delta = (
        params[0], params[1], params[2], params[3], params[4], params[5])
    F, Bmax = fh.shape[-3], fh.shape[-2]
    dev = fh.device
    # [..., 1, 1]: broadcast against [..., F, Bmax]
    total_g = totals[..., 0, None, None]
    total_h = totals[..., 1, None, None]
    total_cnt = totals[..., 2, None, None]

    missing_pos = meta.missing_pos.to(torch.int64)
    has_missing = meta.has_missing
    rows = torch.arange(F, device=dev)
    zero = torch.zeros((), dtype=fh.dtype, device=dev)
    missing_vals = torch.where(has_missing[:, None], fh[..., rows, missing_pos, :], zero)
    tpos = torch.arange(Bmax, device=dev)[None, :]
    at_missing = has_missing[:, None] & (tpos == missing_pos[:, None])
    scan_hist = torch.where(at_missing[:, :, None], zero, fh)
    cum = bin_prefix(scan_hist)

    # lane 0: missing goes right (natural); lane 1: missing goes left
    neg_inf = torch.tensor(float("-inf"), dtype=torch.float32, device=dev)
    gate = ~meta.is_categorical
    if feature_mask is not None:
        gate = gate & feature_mask
    if constraint is not None:
        c_lo, c_hi = constraint_bounds(constraint, dev)
        mono = meta.monotone[:, None]
    results = []
    for lane, left in enumerate((cum, cum + missing_vals[..., None, :])):
        lg, lh, lc = left[..., 0], left[..., 1], left[..., 2]
        rg, rh, rc = total_g - lg, total_h - lh, total_cnt - lc
        ok = (lc >= min_data) & (rc >= min_data) & \
             (lh >= min_hess) & (rh >= min_hess)
        # threshold t must leave at least one real bin on the right
        ok &= tpos < (meta.nbins[:, None] - 1)
        ok &= meta.valid_slot
        ok &= gate[:, None]
        if lane == 1:
            ok &= has_missing[:, None]
        if constraint is not None:
            lo_ = clip_output(leaf_output(lg, lh, l1, l2, max_delta), c_lo, c_hi)
            ro_ = clip_output(leaf_output(rg, rh, l1, l2, max_delta), c_lo, c_hi)
            ok &= ~(((mono > 0) & (lo_ > ro_)) | ((mono < 0) & (lo_ < ro_)))
            gain = (leaf_gain_given_output(lg, lh, l1, l2, lo_)
                    + leaf_gain_given_output(rg, rh, l1, l2, ro_))
        else:
            gain = (leaf_gain(lg, lh, l1, l2, max_delta)
                    + leaf_gain(rg, rh, l1, l2, max_delta))
        results.append((torch.where(ok, gain, neg_inf), lg, lh, lc, rg, rh, rc))

    gain_shift = leaf_gain(total_g[..., 0], total_h[..., 0], l1, l2, max_delta) + min_gain
    lead = fh.shape[:-3]

    def lanes(i):  # [..., F, 2*Bmax], lane-major per feature
        return torch.stack([results[0][i], results[1][i]], dim=-2).reshape(
            *lead, F, 2 * Bmax)

    per_f = lanes(0)
    best_flat = torch.argmax(per_f, dim=-1)  # [..., F], first maximum
    lane_b = best_flat // Bmax
    t_b = best_flat % Bmax
    best_gain = per_f.gather(-1, best_flat[..., None])[..., 0]

    def pick(i):
        return lanes(i).gather(-1, best_flat[..., None])[..., 0]

    lg, lh, lc, rg, rh, rc = (pick(i) for i in range(1, 7))
    is_valid = torch.isfinite(best_gain) & (best_gain > gain_shift)
    out_gain = torch.where(is_valid, best_gain - gain_shift, neg_inf)
    if penalty is not None:
        out_gain = torch.where(is_valid, out_gain - penalty, neg_inf)
    lout = leaf_output(lg, lh, l1, l2, max_delta)
    rout = leaf_output(rg, rh, l1, l2, max_delta)
    if constraint is not None:
        lout, rout = clip_output(lout, c_lo, c_hi), clip_output(rout, c_lo, c_hi)
    zeros = torch.zeros_like(out_gain)
    # default_left lane semantics: lane 1 sends the missing bin left
    return torch.stack([
        out_gain,
        torch.where(is_valid, rows.to(torch.float32), -1.0),
        t_b.to(torch.float32),
        lane_b.to(torch.float32),
        lg, lh, lc, rg, rh, rc, lout, rout, zeros, zeros,
    ], dim=-1)


def per_feature_best(fh: torch.Tensor, totals: torch.Tensor, meta: FeatureMeta,
                     params: torch.Tensor,
                     feature_mask: Optional[torch.Tensor] = None,
                     penalty: Optional[torch.Tensor] = None,
                     constraint=None) -> torch.Tensor:
    """Best numeric split per feature: [F, len(SPLIT_FIELDS)] float32 records.

    fh:     [F, Bmax, 3] float32 feature histograms (gather_feature_hist),
            or [L, F, Bmax, 3] for L leaves in one launch
    totals: [3] leaf (sum_grad, sum_hess, count), or [L, 3]
    params: [lambda_l1, lambda_l2, min_data_in_leaf, min_sum_hessian_in_leaf,
             min_gain_to_split, max_delta_step] float32 on fh's device
    feature_mask: optional [F] bool (feature sampling)
    penalty: optional [F] float32 gain penalty subtracted per feature
    constraint: optional (min, max) output bounds of one leaf, two host
            floats (basic-mode monotone constraints; one leaf only)

    Returns [F, 14] (or [L, F, 14]). The `feature` field is the row index
    into fh (invalid rows get -1). A CPU tensor takes the plain version; a
    CUDA tensor the split kernel's per-feature form.
    """
    from .scan_cuda import split_scan

    return split_scan(fh, totals, meta, params, feature_mask, penalty, constraint)


def _sort_key(x: torch.Tensor) -> torch.Tensor:
    """float32 -> int32 keys in the order of the values, for a sort no
    device's float sort decides: -0.0 keys as +0.0 and every NaN as the
    largest value (the JAX package's sort standardizes both so; numpy's
    stable argsort orders them alike)."""
    x = torch.where(x == 0, torch.zeros((), dtype=x.dtype, device=x.device), x)
    bits = x.view(torch.int32)
    key = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    return torch.where(torch.isnan(x), torch.full_like(key, 0x7FFFFFFF), key)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[..., idx[...]] along the last axis (idx one dimension shorter)."""
    return x.gather(-1, idx[..., None])[..., 0]


def per_feature_best_categorical(fh: torch.Tensor, totals: torch.Tensor,
                                 meta: FeatureMeta, params: torch.Tensor,
                                 feature_mask: Optional[torch.Tensor] = None,
                                 penalty: Optional[torch.Tensor] = None,
                                 constraint: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Best categorical split per feature: [..., F, len(SPLIT_FIELDS)]
    records, the JAX package's per_feature_best_categorical
    (FindBestThresholdCategoricalInner, feature_histogram.cpp:147-241):

      * one-hot when num_bin <= max_cat_to_onehot: each bin alone goes left
        (plain lambda_l2);
      * sorted subset otherwise: bins with count >= cat_smooth, ordered by
        grad / (hess + cat_smooth), scanned as prefixes from both ends up to
        min(max_cat_threshold, (used + 1) // 2) categories, with
        lambda_l2 + cat_l2 and min_data_per_group.

    Bin 0, the dummy bin, is no candidate in either lane (LightGBM's
    used_bin); the JAX package's lanes take it, so the two agree where it
    is empty (every category kept, no NaN), and otherwise as the JAX lanes
    on the histogram with the categorical features' bin 0 zeroed.

    fh [..., F, Bmax, 3] float32 feature histograms, totals [..., 3],
    params the learner's [11] float32 vector. Every op runs on fh's device
    and gives the same bits on any device: the prefixes are float64 sums in
    the split kernel's order rounded to float32 (`bin_prefix`, exact on
    grid-snapped histograms, where the JAX package's float32 cumsum is
    too), and the sort is on integer keys (`_sort_key`). Only the prefix
    length and direction are recorded; the host derives the bin set
    (`derive_cat_left_bins`). `constraint`, a [2] float32 (min, max) of
    output bounds on fh's device, clamps the record's outputs only, not
    the gains (the JAX package's split.py:586-589)."""
    l1, l2, min_data, min_hess, min_gain, max_delta = (
        params[0], params[1], params[2], params[3], params[4], params[5])
    max_onehot, max_cat_thresh = params[6], params[7]
    cat_l2, cat_smooth, min_group = params[8], params[9], params[10]
    F, Bmax = fh.shape[-3], fh.shape[-2]
    dev = fh.device
    total_g = totals[..., 0, None]  # [..., 1]: against [..., F]
    total_h = totals[..., 1, None]
    total_cnt = totals[..., 2, None]
    gain_shift = leaf_gain(total_g, total_h, l1, l2, max_delta) + min_gain
    # constants filled on the device: a copy from the host cannot be captured
    neg_inf = torch.full((), float("-inf"), dtype=torch.float32, device=dev)
    eps = torch.full((), K_EPSILON, dtype=torch.float32, device=dev)
    tb = total_g[..., None], total_h[..., None], total_cnt[..., None]  # against [..., F, B]

    g, h, c = fh[..., 0], fh[..., 1], fh[..., 2]
    bin_pos = torch.arange(Bmax, device=dev)
    # bin 0 is the dummy bin (NaN, negative, unseen and cut categories),
    # which no split's left set holds: the model's value bitset has no bit
    # for it, so its rows go right at predict time, and LightGBM's scan
    # leaves it out (the JAX package's does not, ROADMAP Queue 3)
    bin_valid = meta.valid_slot & (bin_pos[None, :] < meta.nbins[:, None]) & \
        (bin_pos[None, :] > 0)

    # ---- one-hot lane (each bin alone goes left)
    other_h = tb[1] - h - eps
    other_c = tb[2] - c
    ok1 = bin_valid & (c >= min_data) & (h >= min_hess) & \
        (other_c >= min_data) & (other_h >= min_hess)
    gain1 = (leaf_gain(tb[0] - g, other_h, l1, l2, max_delta)
             + leaf_gain(g, h + eps, l1, l2, max_delta))
    gain1 = torch.where(ok1, gain1, neg_inf)
    onehot_t = torch.argmax(gain1, dim=-1)
    onehot_gain = _take(gain1, onehot_t)
    onehot_lg, onehot_lh, onehot_lc = _take(g, onehot_t), _take(h, onehot_t) + eps, \
        _take(c, onehot_t)

    # ---- sorted-subset lane
    l2c = l2 + cat_l2
    eligible = bin_valid & (c >= cat_smooth)
    inf = torch.full((), float("inf"), dtype=torch.float32, device=dev)
    ctr = torch.where(eligible, g / (h + cat_smooth), inf)
    order = torch.sort(_sort_key(ctr), dim=-1, stable=True).indices  # eligible first
    used = eligible.sum(dim=-1)  # [..., F]
    sorted_stats = fh.gather(-2, order[..., None].expand(*order.shape, 3))
    max_num_cat = torch.minimum(max_cat_thresh, ((used + 1) // 2).to(torch.float32))
    pos = bin_pos.to(torch.float32)
    # the backward lane reverses the order, where the ineligible (inf-keyed)
    # bins come first, so each row is rolled back by (Bmax - used) to start
    # at the last eligible bin; both directions share one prefix pass
    idx = (bin_pos + (Bmax - used)[..., None]) % Bmax
    rev = torch.flip(sorted_stats, dims=[-2])
    both = torch.stack([sorted_stats, rev.gather(-2, idx[..., None].expand(*idx.shape, 3))])
    cum = bin_prefix(both)  # [2, ..., F, Bmax, 3]
    clg, clh, clc = cum[..., 0], cum[..., 1] + eps, cum[..., 2]
    in_range = (pos < used[..., None]) & (pos < max_num_cat[..., None])
    rh = tb[1] - clh
    rc = tb[2] - clc
    ok = in_range & (clc >= min_data) & (clh >= min_hess) & \
        (rc >= min_data) & (rc >= min_group) & (rh >= min_hess)
    # min_data_per_group as the JAX package has it: the cumulative count at
    # least min_group (the reference counts the rows since the last
    # evaluated prefix)
    ok &= clc >= min_group
    gains = (leaf_gain(clg, clh, l1, l2c, max_delta)
             + leaf_gain(tb[0] - clg, rh, l1, l2c, max_delta))
    gains = torch.where(ok, gains, neg_inf)
    best_i = torch.argmax(gains, dim=-1)
    # per direction: (best gain, best length, best left g, h, count)
    fwd, bwd = ((_take(gains[d], best_i[d]), best_i[d] + 1, _take(clg[d], best_i[d]),
                 _take(clh[d], best_i[d]), _take(clc[d], best_i[d])) for d in (0, 1))

    use_onehot = meta.nbins.to(torch.float32) <= max_onehot
    lanes_gain = torch.stack([
        torch.where(use_onehot, onehot_gain, neg_inf),
        torch.where(use_onehot, neg_inf, fwd[0]),
        torch.where(use_onehot, neg_inf, bwd[0]),
    ], dim=-1)  # [..., F, 3]
    lane = torch.argmax(lanes_gain, dim=-1)
    best_gain = _take(lanes_gain, lane)

    def pick(a_one, a_fwd, a_bwd):
        return _take(torch.stack([a_one, a_fwd, a_bwd], dim=-1), lane)

    thresh = pick(onehot_t.to(torch.float32), fwd[1].to(torch.float32),
                  bwd[1].to(torch.float32))
    lg = pick(onehot_lg, fwd[2], bwd[2])
    lh = pick(onehot_lh, fwd[3], bwd[3])
    lc = pick(onehot_lc, fwd[4], bwd[4])
    ones = torch.ones_like(best_gain)
    cat_dir = pick(torch.zeros_like(best_gain), ones, -ones)
    l2_eff = torch.where(lane == 0, l2, l2c)

    rg, rh, rc = total_g - lg, total_h - lh, total_cnt - lc
    is_valid = meta.is_categorical & torch.isfinite(best_gain) & (best_gain > gain_shift)
    if feature_mask is not None:
        is_valid &= feature_mask
    out_gain = torch.where(is_valid, best_gain - gain_shift, neg_inf)
    if penalty is not None:
        out_gain = torch.where(is_valid, out_gain - penalty, neg_inf)
    lout = leaf_output(lg, lh, l1, l2_eff, max_delta)
    rout = leaf_output(rg, rh, l1, l2_eff, max_delta)
    if constraint is not None:
        lout = clip_output(lout, constraint[0], constraint[1])
        rout = clip_output(rout, constraint[0], constraint[1])
    rows = torch.arange(F, device=dev).to(torch.float32).expand_as(best_gain)
    return torch.stack([
        out_gain, torch.where(is_valid, rows, -ones), thresh,
        torch.zeros_like(best_gain),  # default_left = false (CategoricalDecision)
        lg, lh, lc, rg, rh, rc, lout, rout, ones, cat_dir,
    ], dim=-1)


def derive_cat_left_bins(bin_stats: np.ndarray, nbins: int, split: SplitInfo,
                         cat_smooth: float) -> List[int]:
    """The winning categorical split's left bin set, derived on the host
    from the feature's histogram row [>= nbins, 3] float32: the search's
    float32 ctr and its stable order replayed on the same values (numpy's
    stable argsort orders -0.0, +0.0 and NaN as the search's integer keys
    do), so only the prefix length and direction travel in the record."""
    if split.cat_dir == 0:
        return [int(split.threshold_bin)]
    g = np.asarray(bin_stats[:nbins, 0], dtype=np.float32)
    h = np.asarray(bin_stats[:nbins, 1], dtype=np.float32)
    c = np.asarray(bin_stats[:nbins, 2], dtype=np.float32)
    smooth = np.float32(cat_smooth)
    eligible = c >= smooth
    eligible[:1] = False  # the dummy bin 0 (per_feature_best_categorical)
    ctr = np.where(eligible, g / (h + smooth), np.float32(np.inf))
    order = np.argsort(ctr, kind="stable")
    used = int(eligible.sum())
    k = min(int(split.threshold_bin), used)
    chosen = order[:k] if split.cat_dir > 0 else order[used - k: used]
    return [int(b) for b in chosen]


def bins_to_bitset(values: List[int]) -> List[int]:
    """Pack non-negative ints into 32-bit bitset words (Common::ConstructBitset)."""
    vals = [v for v in values if v >= 0]
    if not vals:
        return [0]
    words = [0] * (max(vals) // 32 + 1)
    for v in vals:
        words[v // 32] |= 1 << (v % 32)
    return words


def reduce_best_record(recs: torch.Tensor) -> torch.Tensor:
    """[..., K, len(SPLIT_FIELDS)] -> [..., len(SPLIT_FIELDS)] by max gain
    (ties: first, matching the reference's SplitInfo operator> sweep
    order)."""
    best = torch.argmax(recs[..., 0], dim=-1)
    return recs.gather(-2, best[..., None, None].expand(
        *best.shape, 1, recs.shape[-1]))[..., 0, :]


def _find_best_split_plain(hist: torch.Tensor, totals: torch.Tensor, meta: FeatureMeta,
                           params: torch.Tensor,
                           feature_mask: Optional[torch.Tensor] = None,
                           penalty: Optional[torch.Tensor] = None,
                           constraint=None) -> torch.Tensor:
    """The plain version of the split kernel's find form: the feature
    gather with the EFB fix, the per-feature numeric records (constrained
    with `constraint`, two host floats), the argmax."""
    fh = gather_feature_hist(hist, meta, totals)  # [..., F, Bmax, 3]
    return reduce_best_record(_per_feature_best_plain(fh, totals, meta, params,
                                                      feature_mask, penalty, constraint))


def _best_categorical_plain(hist: torch.Tensor, totals: torch.Tensor, meta: FeatureMeta,
                            params: torch.Tensor, feature_mask: Optional[torch.Tensor],
                            penalty: Optional[torch.Tensor],
                            scale: Optional[torch.Tensor],
                            constraint: Optional[torch.Tensor] = None) -> torch.Tensor:
    """`best_categorical_record` in PyTorch ops on hist's device."""
    if scale is not None:
        hist = hist.to(torch.float32) * scale
    fh = gather_feature_hist(hist, meta, totals)
    return reduce_best_record(per_feature_best_categorical(fh, totals, meta, params,
                                                           feature_mask, penalty,
                                                           constraint))


class _CategoricalGraph:
    """`_best_categorical_plain` captured once as a CUDA graph over static
    input buffers, for one histogram shape and dtype, one FeatureMeta and
    params buffer, and whether a feature mask, penalty, scale and output
    bounds come: a call copies its inputs in and replays ~400 launches as
    one."""

    def __init__(self, hist, totals, meta, params, feature_mask, penalty, scale,
                 constraint) -> None:
        self.inputs = [t.clone() if t is not None else None
                       for t in (hist, totals, feature_mask, penalty, scale, constraint)]
        args = (self.inputs[0], self.inputs[1], meta, params, *self.inputs[2:])
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):  # warm-up: the allocator's blocks, cub's plans
            _best_categorical_plain(*args)
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.out = _best_categorical_plain(*args)
        telemetry.note_compile("categorical_scan", kernel=False)

    def __call__(self, *tensors) -> torch.Tensor:
        for buf, t in zip(self.inputs, tensors):
            if buf is not None:
                buf.copy_(t)
        self.graph.replay()
        return self.out.clone()


def best_categorical_record(hist: torch.Tensor, totals, meta: FeatureMeta,
                            params: torch.Tensor,
                            feature_mask: Optional[torch.Tensor] = None,
                            penalty: Optional[torch.Tensor] = None,
                            scale: Optional[torch.Tensor] = None,
                            constraint=None) -> torch.Tensor:
    """The best categorical record of a leaf (or of L leaves), from the
    group histogram as `find_best_split` takes it: scaled when int32, the
    feature gather with the EFB fix, the categorical lanes, the argmax,
    the outputs clamped into `constraint` (two host floats) when given. On
    the CPU the ops run one by one; on the card as a CUDA graph captured
    at the first call of a shape (`_CategoricalGraph`, kept on the
    FeatureMeta), the same ops and bits; a constrained search is its own
    graph, whose bounds are copied in with the histogram."""
    if not isinstance(totals, torch.Tensor):
        totals = torch.tensor([float(v) for v in totals], dtype=torch.float32,
                              device=hist.device)
    if constraint is not None:
        constraint = torch.stack(constraint_bounds(constraint, hist.device))
    if hist.device.type != "cuda":
        return _best_categorical_plain(hist, totals, meta, params, feature_mask, penalty,
                                       scale, constraint)
    key = (tuple(hist.shape), hist.dtype, params.data_ptr(), feature_mask is not None,
           penalty is not None, scale is not None, constraint is not None)
    graphs = meta.__dict__.setdefault("_categorical_graphs", {})
    if key not in graphs:
        graphs[key] = _CategoricalGraph(hist, totals, meta, params, feature_mask, penalty,
                                        scale, constraint)
    return graphs[key](hist, totals, feature_mask, penalty, scale, constraint)


def find_best_split(hist: torch.Tensor, totals, meta: FeatureMeta,
                    params: torch.Tensor,
                    feature_mask: Optional[torch.Tensor] = None,
                    penalty: Optional[torch.Tensor] = None,
                    scale: Optional[torch.Tensor] = None,
                    constraint=None) -> torch.Tensor:
    """Best split across all features for one leaf, or for L leaves at once
    (the JAX package vmaps it over a wave's 2K children,
    treelearner/device.py:742-747; each record is the one-leaf call's bits).

    hist:   [G, Bg, 3] group histogram for the leaf, or [L, G, Bg, 3];
            float32, or int32 with `scale`
    totals: [3] leaf (sum_grad, sum_hess, count), or [L, 3]; for one leaf
            also three floats on the host, which a launch takes by value
    scale:  [3] float32 per-channel scale of an int32 histogram (quantized
            gradients): the search runs on hist.float() * scale, each bin
            scaled before any sum, as the JAX package scales the histogram
            ahead of its scan; on the card the kernel reads it from device
            memory
    constraint: optional (min, max) output bounds of one leaf, two host
            floats (basic-mode monotone constraints), which a launch takes by
            value: the constrained mode of the kernel, or of the plain
            version on a CPU tensor
    Returns the packed split record [len(SPLIT_FIELDS)] float32, or [L, ...].
    The numeric lanes: a CPU tensor takes the plain version; a CUDA tensor
    is one launch of the split kernel. With categorical features, their
    best record (`best_categorical_record`, PyTorch ops on the histogram's
    device) replaces the numeric one where its gain is strictly larger.
    """
    from .scan_cuda import split_find

    rec = split_find(hist, totals, meta, params, feature_mask, penalty, scale, constraint)
    if not meta.has_categorical:
        return rec
    cat = best_categorical_record(hist, totals, meta, params, feature_mask, penalty, scale,
                                  constraint)
    return torch.where(cat[..., :1] > rec[..., :1], cat, rec)
