"""Leaf histograms: the plain PyTorch version and the dispatch to the kernel.

Counterpart of the JAX package's ``ops/histogram.py``. For each feature
group g,

    hist[g, b, c] = sum_p [bins[g, p] == b] * gh[p, c]

over all rows (`build_histogram`) or over a leaf's padded row-index set
(`build_histogram_rows`). The channel layout is [grad, hess, count].

Leaf row sets are padded with the sentinel index N (ops/partition.py), and
the extended gradient array gh_ext [N+1, CH] carries a zero row at N, so
padding contributes nothing; its bin gather is clamped to row N-1.

The mode follows the gradient dtype: float32 gh gives a float32 histogram,
int8 gh (quantized gradients) an exact int32 one. A CPU tensor takes the
plain version below; a CUDA tensor launches the hand-written kernel
(``ops/hist_cuda.py``, ``csrc/histogram.cu``) or raises.
"""
from __future__ import annotations

import torch


def _acc_dtype(gh: torch.Tensor) -> torch.dtype:
    """int32 for integer (quantized-gradient) histograms — exact — and
    float32 otherwise."""
    if gh.dtype == torch.int8:
        return torch.int32
    if gh.dtype == torch.float32:
        return torch.float32
    raise ValueError(f"gradients must be float32 or int8, got {gh.dtype}")


def _histogram_plain(bins: torch.Tensor, gh: torch.Tensor,
                     num_bins: int) -> torch.Tensor:
    """bins [G, P] (already gathered), gh [P, CH] -> [G, num_bins, CH].
    Each group scatter-adds its rows' channels into the flattened [B*CH]
    histogram in row order (CPU index_add_ runs sequentially over the
    index)."""
    acc = _acc_dtype(gh)
    G = bins.shape[0]
    CH = gh.shape[1]
    out = torch.zeros((G, num_bins * CH), dtype=acc, device=gh.device)
    src = gh.to(acc).reshape(-1)
    chan = torch.arange(CH, dtype=torch.int64, device=gh.device)
    for g in range(G):
        flat = (bins[g].to(torch.int64)[:, None] * CH + chan).reshape(-1)
        out[g].index_add_(0, flat, src)
    return out.reshape(G, num_bins, CH)


def _build_histogram_plain(bins: torch.Tensor, gh: torch.Tensor,
                           num_bins: int) -> torch.Tensor:
    """Full-data histogram: bins [G, N], gh [N, CH]."""
    return _histogram_plain(bins, gh, num_bins)


def _build_histogram_rows_plain(bins: torch.Tensor, gh_ext: torch.Tensor,
                                row_idx: torch.Tensor,
                                num_bins: int) -> torch.Tensor:
    """Leaf histogram: the row gather of `_build_histogram_rows_xla`
    (bins clamped to row N-1, gh read at the index so the sentinel N hits
    the zero row), then the plain histogram."""
    N = bins.shape[1]
    idx = row_idx.to(torch.int64)
    bins_leaf = bins[:, torch.clamp(idx, max=N - 1)]
    return _histogram_plain(bins_leaf, gh_ext[idx], num_bins)


def build_histogram(bins: torch.Tensor, gh: torch.Tensor,
                    num_bins: int) -> torch.Tensor:
    """Full-data histogram.

    bins: [G, N] uint8 bin plane
    gh:   [N, CH] float32 (grad, hess, 1.0) or int8
    Returns [G, num_bins, CH] float32 (int32 for int8 gh).
    """
    from .hist_cuda import histogram

    return histogram(bins, gh, None, num_bins)


def build_histogram_rows(bins: torch.Tensor, gh_ext: torch.Tensor,
                         row_idx: torch.Tensor, num_bins: int) -> torch.Tensor:
    """Leaf histogram over a padded row-index set.

    bins:    [G, N] full bin plane
    gh_ext:  [N+1, CH] gradients with a ZERO sentinel row at index N
    row_idx: [P] int32 row indices, padded with N (the sentinel)
    Returns [G, num_bins, CH] float32 (int32 for int8 gh).
    """
    from .hist_cuda import histogram

    return histogram(bins, gh_ext, row_idx, num_bins)


def subtract_histogram(parent: torch.Tensor, sibling: torch.Tensor) -> torch.Tensor:
    """The histogram-subtraction trick (FeatureHistogram::Subtract,
    src/treelearner/feature_histogram.hpp:99): larger child = parent -
    smaller child, skipping a construction pass."""
    return parent - sibling
