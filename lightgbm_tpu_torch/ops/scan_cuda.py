"""Wrapper of the CUDA split-search kernel (csrc/split_find.cu).

The kernel replaces ``lightgbm_tpu/ops/scan_pallas.py:fused_split_scan``
and, in its find form, the feature gather, the EFB fix and the argmax
across features around it (the note at the top of the source gives its
design and bound). It is built and loaded by ``ops/cuda_build.py``.

Dispatch is by the device of the histogram alone: a CPU tensor takes the
plain version (``ops/split.py``); a CUDA tensor launches the kernel, or
raises. There is no fallback from one to the other. A monotone-constrained
search (`constraint`, one leaf's output bounds) is the kernel's constrained
mode on the card, counted under its own names (`find_best_split_constrained`,
`_int`, `split_scan_constrained`).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .cuda_build import CudaLibrary, require_cuda, stream_of
from .split import (SPLIT_FIELDS, FeatureMeta, _find_best_split_plain,
                    _per_feature_best_plain)


def _declare(lib: ctypes.CDLL) -> None:
    ptr, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.lgbt_split_find.argtypes = ([ptr, i64, i32, i32, i32, ptr, f32, f32, f32]
                                    + [ptr] * 13 + [f32, f32, ptr, ptr])
    lib.lgbt_split_find.restype = i32


# --fmad=false: no multiply-add contracted into an FMA, so the gains round
# as the plain version's separate float32 ops do
LIB = CudaLibrary("split_find.cu", ("split_scan", "split_scan_batched", "find_best_split",
                                    "find_best_split_batched", "find_best_split_int",
                                    "find_best_split_batched_int", "split_scan_constrained",
                                    "find_best_split_constrained",
                                    "find_best_split_constrained_int"), _declare,
                  extra_flags=("--fmad=false",))
launches = LIB.launches
reset_launches = LIB.reset_launches
MAX_BINS = 1024
MAX_WARPS, SMEM_BUDGET = 32, 160 * 1024  # csrc/split_find.cu kMaxWarps, kSmemBudget


def launch_shape(n_features: int, n_bins: int):
    """(warps a block, dynamic shared memory bytes) of a split launch, as
    csrc/split_find.cu:launch_shape picks them: a warp a feature, each
    warp three channels of 32 * ceil(B / 32) bank-skewed floats."""
    chunk = -(-n_bins // 32)
    stride = (32 * chunk - 1) + ((32 * chunk - 1) >> 5) + 1
    per_warp = 4 * 3 * stride
    warps = min(n_features, MAX_WARPS)
    while warps > 1 and per_warp * warps > SMEM_BUDGET:
        warps -= 1
    return warps, per_warp * warps


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple,
           device: torch.device) -> None:
    if t.dtype != dtype or tuple(t.shape) != shape or t.device != device \
            or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {dtype} {list(shape)} "
                         f"tensor on {device}, got {t.dtype} "
                         f"{list(t.shape)} on {t.device}")


def _check_common(meta: FeatureMeta, params: torch.Tensor, F: int, B: int,
                  feature_mask: Optional[torch.Tensor], penalty: Optional[torch.Tensor],
                  dev: torch.device, constraint=None) -> None:
    if B > MAX_BINS:
        raise ValueError(f"the split kernel takes at most {MAX_BINS} bins per "
                         f"feature, got {B}")
    if params.dtype != torch.float32 or params.dim() != 1 or params.shape[0] < 6 \
            or params.device != dev or not params.is_contiguous():
        raise ValueError("params must be a contiguous float32 vector of at "
                         f"least 6 values on {dev}")
    _check("meta.missing_pos", meta.missing_pos, torch.int32, (F,), dev)
    _check("meta.has_missing", meta.has_missing, torch.bool, (F,), dev)
    _check("meta.nbins", meta.nbins, torch.int32, (F,), dev)
    _check("meta.valid_slot", meta.valid_slot, torch.bool, (F, B), dev)
    _check("meta.is_categorical", meta.is_categorical, torch.bool, (F,), dev)
    if feature_mask is not None:
        _check("feature_mask", feature_mask, torch.bool, (F,), dev)
    if penalty is not None:
        _check("penalty", penalty, torch.float32, (F,), dev)
    if constraint is not None:
        if len(constraint) != 2:
            raise ValueError("constraint is a leaf's two output bounds (min, max)")
        _check("meta.monotone", meta.monotone, torch.int8, (F,), dev)


def _launch(src: torch.Tensor, src_rows: int, L: int, F: int, B: int, totals,
            meta: FeatureMeta, params: torch.Tensor, gather: bool,
            feature_mask: Optional[torch.Tensor], penalty: Optional[torch.Tensor],
            rec: torch.Tensor, scale: Optional[torch.Tensor] = None,
            constraint=None) -> int:
    if isinstance(totals, torch.Tensor):
        tot_ptr, t = totals.data_ptr(), (0.0, 0.0, 0.0)
    else:
        tot_ptr, t = None, tuple(float(v) for v in totals)
    # the bounds by value, rounded to float32 as the plain version rounds them
    bounds = (0.0, 0.0) if constraint is None else tuple(float(v) for v in constraint)
    lib = LIB.load()
    with torch.cuda.device(src.device):
        return lib.lgbt_split_find(
            src.data_ptr(), src_rows, L, F, B, tot_ptr, *t, params.data_ptr(),
            None if scale is None else scale.data_ptr(),
            meta.gather_index.data_ptr() if gather else None,
            meta.valid_slot.data_ptr(),
            meta.default_bin.data_ptr() if gather else None,
            meta.efb_omitted.data_ptr() if gather else None,
            meta.missing_pos.data_ptr(), meta.has_missing.data_ptr(),
            meta.nbins.data_ptr(), meta.is_categorical.data_ptr(),
            None if feature_mask is None else feature_mask.data_ptr(),
            None if penalty is None else penalty.data_ptr(),
            None if constraint is None else meta.monotone.data_ptr(), *bounds,
            rec.data_ptr(), stream_of(src))


def split_scan(fh: torch.Tensor, totals: torch.Tensor, meta: FeatureMeta,
               params: torch.Tensor, feature_mask: Optional[torch.Tensor] = None,
               penalty: Optional[torch.Tensor] = None, constraint=None) -> torch.Tensor:
    """[F, Bmax, 3] float32 feature histograms -> [F, 14] split records, or
    [L, F, Bmax, 3] with totals [L, 3] -> [L, F, 14] in one launch
    (ops/split.py:per_feature_best). `constraint`, one leaf's (min, max)
    output bounds as host floats, selects the constrained mode. A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel's
    per-feature form."""
    if constraint is not None and fh.dim() != 3:
        raise ValueError("a constrained split search takes one leaf; a leaf batch "
                         "carries no bounds")
    if fh.device.type == "cpu":
        return _per_feature_best_plain(fh, totals, meta, params, feature_mask,
                                       penalty, constraint)
    require_cuda(fh, "the split scan")
    if fh.dim() not in (3, 4):
        raise ValueError(f"fh must be [F, B, 3] or [L, F, B, 3], got {list(fh.shape)}")
    lead = tuple(fh.shape[:-3])
    L = lead[0] if lead else 1
    F, B = fh.shape[-3], fh.shape[-2]
    dev = fh.device
    if L < 1:
        raise ValueError(f"the split kernel takes at least one leaf, got {L}")
    _check("fh", fh, torch.float32, lead + (F, B, 3), dev)
    _check("totals", totals, torch.float32, lead + (3,), dev)
    _check_common(meta, params, F, B, feature_mask, penalty, dev, constraint)
    rec = torch.empty(lead + (F, len(SPLIT_FIELDS)), dtype=torch.float32, device=dev)
    err = _launch(fh, 0, L, F, B, totals, meta, params, False, feature_mask, penalty, rec,
                  constraint=constraint)
    # one leaf, a leaf batch and the constrained mode count apart
    LIB.count("split_scan_batched" if lead else
              "split_scan_constrained" if constraint is not None else "split_scan", err)
    return rec


def split_find(hist: torch.Tensor, totals, meta: FeatureMeta, params: torch.Tensor,
               feature_mask: Optional[torch.Tensor] = None,
               penalty: Optional[torch.Tensor] = None,
               scale: Optional[torch.Tensor] = None, constraint=None) -> torch.Tensor:
    """Group histograms [G, Bg, 3] (or [L, G, Bg, 3]) float32, or int32 with
    `scale` [3] float32 (quantized-gradient training), -> the best split
    record [14] (or [L, 14]) (ops/split.py:find_best_split). `totals` is [3]
    (or [L, 3]) float32, or, for one leaf, three host floats passed by
    value; `constraint`, one leaf's (min, max) output bounds as host floats,
    passed by value too, selects the constrained mode. A CPU tensor takes
    the plain version; a CUDA tensor is one launch of the kernel's find
    form, which reads the scale from the card."""
    lead = tuple(hist.shape[:-3])
    if (scale is None) != (hist.dtype != torch.int32):
        raise ValueError(f"a {hist.dtype} histogram takes "
                         f"{'a' if hist.dtype == torch.int32 else 'no'} scale")
    if constraint is not None and lead:
        raise ValueError("a constrained split search takes one leaf; a leaf batch "
                         "carries no bounds")
    if hist.device.type == "cpu":
        if not isinstance(totals, torch.Tensor):
            totals = torch.tensor([float(v) for v in totals], dtype=torch.float32)
        if scale is not None:
            hist = hist.to(torch.float32) * scale
        return _find_best_split_plain(hist, totals, meta, params, feature_mask, penalty,
                                      constraint)
    require_cuda(hist, "the split search")
    if hist.dim() not in (3, 4):
        raise ValueError(f"hist must be [G, Bg, 3] or [L, G, Bg, 3], got "
                         f"{list(hist.shape)}")
    L = lead[0] if lead else 1
    G, Bg = hist.shape[-3], hist.shape[-2]
    F, B = meta.gather_index.shape
    dev = hist.device
    if L < 1:
        raise ValueError(f"the split kernel takes at least one leaf, got {L}")
    if G * Bg != meta.hist_rows:
        raise ValueError(f"hist has {G} x {Bg} rows, the feature metadata indexes "
                         f"{meta.hist_rows}")
    _check("hist", hist, torch.float32 if scale is None else torch.int32, lead + (G, Bg, 3),
           dev)
    if scale is not None:
        _check("scale", scale, torch.float32, (3,), dev)
    if isinstance(totals, torch.Tensor):
        _check("totals", totals, torch.float32, lead + (3,), dev)
    elif lead or len(totals) != 3:
        raise ValueError("host totals are three floats of one leaf")
    _check("meta.gather_index", meta.gather_index, torch.int64, (F, B), dev)
    _check("meta.default_bin", meta.default_bin, torch.int64, (F,), dev)
    _check("meta.efb_omitted", meta.efb_omitted, torch.bool, (F,), dev)
    _check_common(meta, params, F, B, feature_mask, penalty, dev, constraint)
    out = torch.empty(lead + (len(SPLIT_FIELDS),), dtype=torch.float32, device=dev)
    err = _launch(hist, G * Bg, L, F, B, totals, meta, params, True, feature_mask,
                  penalty, out, scale, constraint)
    # one leaf (the serial learner, the root) and a leaf batch (a wave's 2K
    # children) count apart, and so do the constrained and the integer modes
    name = ("find_best_split_batched" if lead else
            "find_best_split_constrained" if constraint is not None else "find_best_split")
    LIB.count(name + ("_int" if scale is not None else ""), err)
    return out
