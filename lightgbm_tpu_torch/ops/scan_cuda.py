"""Wrapper of the CUDA split-scan kernel (csrc/split_scan.cu).

The kernel replaces ``lightgbm_tpu/ops/scan_pallas.py:fused_split_scan``
(the note at the top of the source gives its design and bound). It is
built and loaded by ``ops/cuda_build.py``.

Dispatch is by the device of the histogram alone: a CPU tensor takes the
plain version (``ops/split.py:_per_feature_best_plain``); a CUDA tensor
launches the kernel, or raises. There is no fallback from one to the other.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .cuda_build import CudaLibrary, require_cuda, stream_of
from .split import SPLIT_FIELDS, FeatureMeta, _per_feature_best_plain


def _declare(lib: ctypes.CDLL) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.lgbt_split_scan.argtypes = [ptr, i32, i32, i32] + [ptr] * 10 + [ptr]
    lib.lgbt_split_scan.restype = i32


# --fmad=false: no multiply-add contracted into an FMA, so the gains round
# as the plain version's separate float32 ops do
LIB = CudaLibrary("split_scan.cu", ("split_scan", "split_scan_batched"), _declare,
                  extra_flags=("--fmad=false",))
launches = LIB.launches
reset_launches = LIB.reset_launches
MAX_BINS = 1024


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple,
           device: torch.device) -> None:
    if t.dtype != dtype or tuple(t.shape) != shape or t.device != device \
            or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {dtype} {list(shape)} "
                         f"tensor on {device}, got {t.dtype} "
                         f"{list(t.shape)} on {t.device}")


def split_scan(fh: torch.Tensor, totals: torch.Tensor, meta: FeatureMeta,
               params: torch.Tensor, feature_mask: Optional[torch.Tensor] = None,
               penalty: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[F, Bmax, 3] float32 feature histograms -> [F, 14] split records, or
    [L, F, Bmax, 3] with totals [L, 3] -> [L, F, 14] in one launch
    (ops/split.py:per_feature_best). A CPU tensor takes the plain version;
    a CUDA tensor launches the kernel."""
    if fh.device.type == "cpu":
        return _per_feature_best_plain(fh, totals, meta, params, feature_mask,
                                       penalty)
    require_cuda(fh, "the split scan")
    if fh.dim() not in (3, 4):
        raise ValueError(f"fh must be [F, B, 3] or [L, F, B, 3], got {list(fh.shape)}")
    lead = tuple(fh.shape[:-3])
    L = lead[0] if lead else 1
    F, B = fh.shape[-3], fh.shape[-2]
    dev = fh.device
    if B > MAX_BINS:
        raise ValueError(f"the split scan kernel takes at most {MAX_BINS} bins "
                         f"per feature, got {B}")
    if not 1 <= L <= 65535:
        raise ValueError(f"the split scan kernel takes 1 to 65535 leaves, got {L}")
    _check("fh", fh, torch.float32, lead + (F, B, 3), dev)
    _check("totals", totals, torch.float32, lead + (3,), dev)
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
    rec = torch.empty(lead + (F, len(SPLIT_FIELDS)), dtype=torch.float32, device=dev)
    lib = LIB.load()
    with torch.cuda.device(dev):
        err = lib.lgbt_split_scan(
            fh.data_ptr(), L, F, B, totals.data_ptr(), params.data_ptr(),
            meta.missing_pos.data_ptr(), meta.has_missing.data_ptr(),
            meta.nbins.data_ptr(), meta.valid_slot.data_ptr(),
            meta.is_categorical.data_ptr(),
            None if feature_mask is None else feature_mask.data_ptr(),
            None if penalty is None else penalty.data_ptr(),
            rec.data_ptr(), stream_of(fh))
    # one leaf and a leaf batch count apart: the wave learner's 2K children
    # are one batched launch
    LIB.count("split_scan_batched" if lead else "split_scan", err)
    return rec
