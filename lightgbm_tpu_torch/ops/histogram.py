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
(``ops/hist_cuda.py``, ``csrc/histogram.cu``) or raises. The kernel sums
the float mode exactly in 64-bit fixed point (`fixed_point_exponents`), so
its bits are those of `_build_histogram_rows_fixed`, which lies within the
float32 summation bound of the plain version and equals it on grid-snapped
gradients.

The wave learner's histogram is `histogram_slots_ragged` (the JAX package's
``hist_pallas.py:pallas_histogram_slots_ragged``): over K leaf-contiguous
row ranges, row n of range k adds its gh to channel block k of a
[G, B, K*CH] histogram when slot[n] == k. `histogram_slots`
(``pallas_histogram_slots``) is the same function over the whole row set.
The TPU's row-tile table (``active_tile_table``) is not carried: the card's
kernel splits the ranges' rows among its blocks itself. It sums the float
mode exactly in 64-bit fixed point (`fixed_point_exponents`), so its bits
are those of `_histogram_slots_ragged_fixed`, which lies within the float32
summation bound of the plain version.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .. import perfmodel, telemetry


def _acc_dtype(gh: torch.Tensor) -> torch.dtype:
    """int32 for integer (quantized-gradient) histograms — exact — and
    float32 otherwise."""
    if gh.dtype == torch.int8:
        return torch.int32
    if gh.dtype == torch.float32:
        return torch.float32
    raise ValueError(f"gradients must be float32 or int8, got {gh.dtype}")


def _histogram_plain(bins: torch.Tensor, gh: torch.Tensor, num_bins: int,
                     acc: Optional[torch.dtype] = None,
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """bins [G, P] (already gathered), gh [P, CH] -> [G, num_bins, CH],
    summed in `acc` (by default `_acc_dtype(gh)`). Each group scatter-adds
    its rows' channels into the flattened [B*CH] histogram in row order
    (CPU index_add_ runs sequentially over the index). With `out` (a
    contiguous [G, num_bins, CH] of dtype acc) the rows add into it in place
    and each cell's sum goes on where an earlier call left it."""
    acc = _acc_dtype(gh) if acc is None else acc
    G = bins.shape[0]
    CH = gh.shape[1]
    if out is None:
        out = torch.zeros((G, num_bins * CH), dtype=acc, device=gh.device)
    else:
        out = out.view(G, num_bins * CH)
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
                                row_idx: torch.Tensor, num_bins: int,
                                count: Optional[int] = None,
                                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Leaf histogram: the row gather of `_build_histogram_rows_xla`
    (bins clamped to row N-1, gh read at the index so the sentinel N hits
    the zero row), then the plain histogram. With `count`, only the first
    count positions are read: the rest is sentinel padding, whose zero rows
    change no sum. With `out`, the rows add into it (the carried mode's
    plain version: `hist_cuda.HistogramCarry`)."""
    N = bins.shape[1]
    idx = row_idx[:count].to(torch.int64)
    bins_leaf = bins[:, torch.clamp(idx, max=N - 1)]
    return _histogram_plain(bins_leaf, gh_ext[idx], num_bins, out=out)


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
                         row_idx: torch.Tensor, num_bins: int,
                         count: Optional[int] = None,
                         exponents: Optional[torch.Tensor] = None,
                         carry=None, last: bool = True, image: bool = False):
    """Leaf histogram over a padded row-index set.

    bins:    [G, N] full bin plane
    gh_ext:  [N+1, CH] gradients with a ZERO sentinel row at index N
    row_idx: [P] int32 row indices, padded with N (the sentinel)
    count:   the leaf's row count, when the caller knows it: only the first
             count positions are read (the rest must be sentinel padding)
    exponents: the CUDA kernel's fixed-point exponents of gh_ext
             (`fixed_point_exponents(gh_ext, N)`), when the caller computes
             them once for the leaves of a tree; the kernel trusts them
             (`hist_cuda.histogram`); ignored on the CPU
    carry, last: a `hist_cuda.HistogramCarry` to sum the leaf over the
             blocks of a streamed plane, and whether this is its last block
             (`hist_cuda.histogram`'s carried mode)
    image:   with `carry`, leave the carry open and return its `HistImage`
             (the sum a rank adds to the other ranks')
    Returns [G, num_bins, CH] float32 (int32 for int8 gh).
    """
    from .hist_cuda import histogram

    if telemetry.enabled():
        perfmodel.note_dispatch("histogram", histogram, bins, gh_ext, row_idx,
                                num_bins=num_bins, count=count)
    return histogram(bins, gh_ext, row_idx, num_bins, count, exponents, carry, last,
                     image=image)


def _ragged_cells(bins: torch.Tensor, slot: torch.Tensor, starts: torch.Tensor,
                  ends: torch.Tensor, valid: torch.Tensor, num_bins: int,
                  n_slots: int):
    """(rows, cell): the rows of the valid ranges [starts[k], ends[k]) whose
    slot is k, in range order, then row order, and each one's [G, rows]
    (bin, slot) cell; a bin past num_bins lands in a dropped cell."""
    dev = bins.device
    kept = [torch.arange(s, e, device=dev)[slot[s:e] == k]
            for k, (s, e, ok) in enumerate(zip(starts.tolist(), ends.tolist(), valid.tolist()))
            if ok and e > s]
    rows = torch.cat(kept) if kept else torch.zeros(0, dtype=torch.int64, device=dev)
    cell = (torch.clamp(bins[:, rows].to(torch.int64), max=num_bins) * n_slots
            + slot[rows].to(torch.int64))
    return rows, cell


def _histogram_slots_ragged_plain(bins: torch.Tensor, gh: torch.Tensor,
                                  slot: torch.Tensor, starts: torch.Tensor,
                                  ends: torch.Tensor, valid: torch.Tensor,
                                  num_bins: int, n_slots: int,
                                  quantized: bool = False) -> torch.Tensor:
    """[G, num_bins, n_slots*CH] histogram of the rows of the valid ranges
    [starts[k], ends[k]) whose slot is k, each into channel block k. Float
    mode sums in float32; quantized truncates gh to int32 and sums exactly.
    It is the plain histogram over (bin, slot) cells of the kept rows, in
    range order, then row order; a bin past num_bins adds to a dropped
    cell."""
    G = bins.shape[0]
    CH = gh.shape[1]
    acc = torch.int32 if quantized else torch.float32
    rows, cell = _ragged_cells(bins, slot, starts, ends, valid, num_bins, n_slots)
    hist = _histogram_plain(cell, gh[rows].to(acc), (num_bins + 1) * n_slots, acc)
    return hist.reshape(G, num_bins + 1, n_slots * CH)[:, :num_bins].contiguous()


FIXED_POINT_BITS = 62         # a fixed-point bin sum stays within 2**62 in magnitude


def fixed_point_exponents(gh: torch.Tensor, n_rows: int) -> torch.Tensor:
    """[CH] int32 exponents e_c of the CUDA histograms' float modes,
    computed on gh's device with no copy to the host: channel c's finite
    values are rounded to multiples of 2**-e_c and summed exactly in int64
    (NaN and inf stay out of the sum and make their own cells NaN or inf).

    With m_c = the largest finite |gh[:, c]| = f * 2**x_c (f in [0.5, 1), so
    m_c <= 2**x_c) and n_rows <= 2**q, e_c = 62 - q - x_c: a bin sums at
    most n_rows values, so its sum is at most 2**62 in magnitude, plus
    n_rows / 2 of rounding — below 2**63 for any n_rows < 2**62. At
    n_rows = 2**20 and m_c <= 1 the resolution is 2**-42."""
    m = gh.abs().nan_to_num_(nan=0.0, posinf=0.0).amax(dim=0)
    # x = 0 for m == 0: any exponent sums zeros exactly
    return fixed_point_exponents_of_max(m, n_rows)


def _histogram_slots_ragged_fixed(bins: torch.Tensor, gh: torch.Tensor, slot: torch.Tensor,
                                  starts: torch.Tensor, ends: torch.Tensor,
                                  valid: torch.Tensor, num_bins: int, n_slots: int,
                                  exponents: torch.Tensor) -> torch.Tensor:
    """The CUDA ragged kernel's float-mode arithmetic, written plainly: the
    kept rows of `_histogram_slots_ragged_plain` summed per (bin, slot) cell
    as `_fixed_point_sum` does. The kernel gives these bits in any summation
    order; the tests and chip_smoke.py hold it to them, and this to
    `_histogram_slots_ragged_plain`'s float32 summation bound."""
    G = bins.shape[0]
    CH = gh.shape[1]
    rows, cell = _ragged_cells(bins, slot, starts, ends, valid, num_bins, n_slots)
    out = _fixed_point_sum(cell, gh[rows], (num_bins + 1) * n_slots, exponents)
    return out.reshape(G, num_bins + 1, n_slots * CH)[:, :num_bins].contiguous()


def _fixed_point_image(cell: torch.Tensor, g: torch.Tensor, n_cells: int,
                       exponents: torch.Tensor):
    """The CUDA kernels' float-mode image, written plainly: rows g [R, CH]
    into cells cell [G, R] < n_cells, each finite value rounded (to nearest
    even) to a multiple of 2**-e_c as int64 and summed exactly per cell, and
    each cell's flag word, the OR of its non-finite values' codes (+inf 1,
    -inf 2, NaN 3). Returns (sums [G, n_cells, CH] int64, flags [G, n_cells,
    CH] int32)."""
    finite = torch.isfinite(g)
    e = exponents.to(device=g.device, dtype=torch.float64)
    fixed = torch.round(torch.where(finite, g, 0.0).to(torch.float64)
                        * torch.pow(2.0, e)).to(torch.int64)
    sums = _histogram_plain(cell, fixed, n_cells, torch.int64)
    flags = torch.zeros_like(sums, dtype=torch.int32)
    for code, hit in ((1, g == float("inf")), (2, g == float("-inf")), (3, torch.isnan(g))):
        seen = _histogram_plain(cell, hit.to(torch.int32), n_cells, torch.int32) > 0
        flags |= torch.where(seen, code, 0).to(torch.int32)
    return sums, flags


def _fixed_point_sum(cell: torch.Tensor, g: torch.Tensor, n_cells: int,
                     exponents: torch.Tensor) -> torch.Tensor:
    """The CUDA kernels' float-mode sum of rows g [R, CH] into cells cell
    [G, R] < n_cells, written plainly: each finite value rounded (to
    nearest even) to a multiple of 2**-e_c as int64, summed exactly per
    cell, then int64 -> float64 -> times 2**-e_c -> float32, each conversion
    rounding to nearest even; the cell's NaN and inf values, summed apart in
    float32 (NaN, +inf, -inf or 0), are added last, so a cell holding one
    comes out as a float sum would. Returns [G, n_cells, CH] float32: the
    conversion of `_fixed_point_image`."""
    return _image_to_float_plain(*_fixed_point_image(cell, g, n_cells, exponents), exponents)


def _histogram_slots_ragged_image_plain(bins: torch.Tensor, gh: torch.Tensor,
                                        slot: torch.Tensor, starts: torch.Tensor,
                                        ends: torch.Tensor, valid: torch.Tensor,
                                        num_bins: int, n_slots: int,
                                        exponents: torch.Tensor) -> "HistImage":
    """The ragged kernel's image mode, written plainly: the kept rows of
    `_histogram_slots_ragged_plain` as `_fixed_point_image` sums them, the
    [G, num_bins, n_slots*CH] int64 sums and int32 flag words that the
    float mode converts at its end (`_image_to_float_plain` of this is
    `_histogram_slots_ragged_fixed`)."""
    G = bins.shape[0]
    CH = gh.shape[1]
    rows, cell = _ragged_cells(bins, slot, starts, ends, valid, num_bins, n_slots)
    sums, flags = _fixed_point_image(cell, gh[rows], (num_bins + 1) * n_slots, exponents)
    return HistImage(*(t.reshape(G, num_bins + 1, n_slots * CH)[:, :num_bins].contiguous()
                       for t in (sums, flags)))


def _histogram_rows_image_plain(bins: torch.Tensor, gh: torch.Tensor,
                                row_idx: Optional[torch.Tensor], num_bins: int,
                                count: Optional[int], exponents: torch.Tensor) -> "HistImage":
    """The leaf histogram's image mode, written plainly: the rows of
    `_build_histogram_rows_fixed` (every row when row_idx is None) summed as
    `_fixed_point_image` sums them, [G, num_bins, CH] int64 sums and int32
    flag words."""
    N = bins.shape[1]
    idx = (torch.arange(N, device=bins.device) if row_idx is None
           else row_idx[:count].to(torch.int64))
    cell = torch.clamp(bins[:, torch.clamp(idx, max=N - 1)].to(torch.int64), max=num_bins)
    sums, flags = _fixed_point_image(cell, gh[idx], num_bins + 1, exponents)
    return HistImage(sums[:, :num_bins].contiguous(), flags[:, :num_bins].contiguous())


def _image_to_float_plain(sums: torch.Tensor, flags: torch.Tensor,
                          exponents: torch.Tensor) -> torch.Tensor:
    """The conversion kernel, written plainly: sums [..., M] int64, M a
    multiple of CH = len(exponents) with the channel fastest, times 2**-e_c
    as float32 (int64 -> float64 -> scaled -> float32, each
    rounding to nearest even), +inf, -inf or NaN where the flag word holds
    code 1, 2 or 3."""
    e = exponents.to(device=sums.device, dtype=torch.float64)
    e = e[torch.arange(sums.shape[-1], device=sums.device) % e.shape[0]]
    out = (sums.to(torch.float64) * torch.pow(2.0, -e)).to(torch.float32)
    # by value, no table on the device: the card's leaf sums (quantized
    # renewal) run this inside a tree that makes no host copy
    nonfinite = torch.where(flags == 1, float("inf"),
                            torch.where(flags == 2, float("-inf"), float("nan")))
    return torch.where(flags == 0, out, nonfinite.to(torch.float32))


class HistImage(NamedTuple):
    """A histogram in the form processes add exactly: `sums` the card's
    float-mode fixed-point image (int64) with its non-finite `flags` (int32
    codes), or, where the sum is already exact or the JAX contract holds
    (the integer modes' int32; the CPU's float32 plain version), the
    histogram itself with flags None. `image_to_float` turns it into what
    the split search reads."""

    sums: torch.Tensor
    flags: Optional[torch.Tensor] = None

    def map(self, fn) -> "HistImage":
        """fn applied to the sums and the flags alike (a selection, a
        reshape: the same cells of both)."""
        return HistImage(fn(self.sums), None if self.flags is None else fn(self.flags))


# the code of a - b for the codes of a and b (flat index 4 * a + b): a
# float difference of +inf, -inf or NaN cells
_SUB_CODES = (0, 2, 1, 3, 1, 3, 1, 3, 2, 2, 3, 3, 3, 3, 3, 3)


_SUB_LUTS: dict = {}


def _sub_lut(device: torch.device) -> torch.Tensor:
    """`_SUB_CODES` on the device, made once (at a first, eager wave: a
    captured graph may not copy from the host)."""
    lut = _SUB_LUTS.get(device)
    if lut is None:
        lut = _SUB_LUTS[device] = torch.tensor(_SUB_CODES, dtype=torch.int32, device=device)
    return lut


def image_sub(a: HistImage, b: HistImage) -> HistImage:
    """a - b, exact: the histogram-subtraction trick on images, whose
    flags follow float arithmetic on the cells they mark."""
    if a.flags is None:
        return HistImage(a.sums - b.sums)
    lut = _sub_lut(a.flags.device)
    return HistImage(a.sums - b.sums, lut[(4 * a.flags + b.flags).to(torch.int64)])


def stack_children(left: HistImage, right: HistImage) -> HistImage:
    """[2K, ...]: each leaf's left then right child, from [K, ...] each."""
    def st(a, b):
        return torch.stack([a, b], dim=1).reshape(2 * a.shape[0], *a.shape[1:])

    return HistImage(st(left.sums, right.sums),
                     None if left.flags is None else st(left.flags, right.flags))


def image_where(cond: torch.Tensor, a: HistImage, b: HistImage) -> HistImage:
    return HistImage(torch.where(cond, a.sums, b.sums),
                     None if a.flags is None else torch.where(cond, a.flags, b.flags))


def image_to_float(img: HistImage, exponents: Optional[torch.Tensor]) -> torch.Tensor:
    """What the split search reads: a fixed-point image converted with the
    tree's exponents (the conversion kernel on the card), anything else as
    it is."""
    if img.flags is None:
        return img.sums
    from .hist_cuda import image_to_float as convert

    return convert(img.sums, img.flags, exponents)


def wave_hist_image(bins: torch.Tensor, gh: torch.Tensor, slot: torch.Tensor,
                    starts: torch.Tensor, ends: torch.Tensor, valid: torch.Tensor,
                    num_bins: int, n_slots: int, quantized: bool,
                    exponents: Optional[torch.Tensor], image: bool) -> HistImage:
    """The wave histogram as a HistImage: with `image` (the card's float
    mode) the ragged kernel's image (`hist_cuda.histogram_ragged(image=True)`,
    its plain version on a CPU tensor); else the integer mode's exact int32
    or the float mode's float32 (on the CPU the plain version: the JAX
    package's contract, exact on grid-snapped gradients) as they are."""
    if quantized or not image:
        return HistImage(histogram_slots_ragged(bins, gh, slot, starts, ends, valid,
                                                num_bins, n_slots, quantized, exponents))
    from .hist_cuda import histogram_ragged

    return histogram_ragged(bins, gh, slot, starts, ends, valid, num_bins, n_slots,
                            exponents=exponents, image=True)


def fixed_point_exponents_of_max(m: torch.Tensor, n_rows: int) -> torch.Tensor:
    """`fixed_point_exponents` from the per-channel largest finite |gh|, m
    [CH], and the row count: what several processes compute alike from the
    MAX of their shards' maxima and the global count."""
    _, x = torch.frexp(m)
    q = max(int(n_rows) - 1, 0).bit_length()
    return (FIXED_POINT_BITS - q - x.to(torch.int64)).to(torch.int32)


def leaf_sums_fixed(gh: torch.Tensor, rows: Optional[torch.Tensor], leaf: torch.Tensor,
                    n_leaves: int) -> torch.Tensor:
    """[n_leaves, 2] float32 (sum g, sum h) by leaf: row rows[i] (every row
    of gh when rows is None) adds gh[row, :2] to leaf[i] (a leaf past
    n_leaves - 1 adds nowhere). The one-group histogram whose bin is the
    leaf, summed as `_fixed_point_sum` does with the exponents of all of
    gh: exact to 2**-e_c and the same bits in any order, on any device (the
    int64 scatter-add of the card is exact too). Quantized training's leaf
    renewal reads it; the JAX package scatter-adds in float32, which gives
    the same sums where every sum is exact (grid-snapped gradients)."""
    g = gh[:, :2] if rows is None else gh[rows, :2]
    exps = fixed_point_exponents(gh[:, :2], gh.shape[0])
    cell = torch.clamp(leaf.to(torch.int64), max=n_leaves)[None]
    return _fixed_point_sum(cell, g, n_leaves + 1, exps)[0, :n_leaves]


def _build_histogram_rows_fixed(bins: torch.Tensor, gh_ext: torch.Tensor,
                                row_idx: Optional[torch.Tensor], num_bins: int,
                                exponents: torch.Tensor,
                                count: Optional[int] = None) -> torch.Tensor:
    """The CUDA leaf histogram's arithmetic, written plainly: the rows of
    `_build_histogram_rows_plain` (every row when row_idx is None) summed
    as `_fixed_point_sum` does, a bin past num_bins adding nowhere. The
    kernel gives these bits in any summation order; the tests and
    chip_smoke.py hold it to them, and this to the plain version's float32
    summation bound (exact on grid-snapped gradients). Integer (int8) gh
    sums exactly either way: that is the plain version."""
    if _acc_dtype(gh_ext) == torch.int32:
        if row_idx is None:
            return _build_histogram_plain(bins, gh_ext, num_bins)
        return _build_histogram_rows_plain(bins, gh_ext, row_idx, num_bins, count)
    N = bins.shape[1]
    idx = (torch.arange(N, device=bins.device) if row_idx is None
           else row_idx[:count].to(torch.int64))
    cell = torch.clamp(bins[:, torch.clamp(idx, max=N - 1)].to(torch.int64), max=num_bins)
    out = _fixed_point_sum(cell, gh_ext[idx], num_bins + 1, exponents)
    return out[:, :num_bins].contiguous()


def histogram_slots_ragged(bins: torch.Tensor, gh: torch.Tensor, slot: torch.Tensor,
                           starts: torch.Tensor, ends: torch.Tensor,
                           valid: torch.Tensor, num_bins: int, n_slots: int,
                           quantized: bool = False,
                           exponents: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The wave histogram.

    bins:   [G, N] uint8 bin plane (leaf-contiguous rows)
    gh:     [N, CH] float32, rows of any stride with unit column stride (the
            wave learner passes its payload's gh columns in place); with
            quantized=True small exact integers
    slot:   [N] int32; a row of range k adds only when slot[n] == k
    starts, ends: [n_slots] int32 half-open row ranges, disjoint
    valid:  [n_slots] bool
    exponents: the CUDA kernel's fixed-point exponents of gh
            (`fixed_point_exponents(gh, N)`), when the caller computes them
            once for several calls over the same gh, or over row subsets of
            one gh; the kernel trusts them (`hist_cuda.histogram_ragged`);
            ignored on the CPU
    Returns [G, num_bins, n_slots*CH] float32 (int32 when quantized).
    """
    from .hist_cuda import histogram_ragged

    return histogram_ragged(bins, gh, slot, starts, ends, valid, num_bins, n_slots,
                            quantized, exponents=exponents)


def histogram_slots(bins: torch.Tensor, gh: torch.Tensor, slot: torch.Tensor,
                    num_bins: int, n_slots: int, quantized: bool = False) -> torch.Tensor:
    """Slot-expanded histogram over all N rows (``pallas_histogram_slots``):
    row n adds its gh to channel block slot[n], rows with a slot outside
    [0, n_slots) nowhere. The ragged kernel with n_slots ranges, each the
    whole row set: it reads the rows n_slots times."""
    N = bins.shape[1]
    dev = bins.device
    starts = torch.zeros(n_slots, dtype=torch.int32, device=dev)
    ends = torch.full((n_slots,), N, dtype=torch.int32, device=dev)
    valid = torch.ones(n_slots, dtype=torch.bool, device=dev)
    from .hist_cuda import histogram_ragged

    return histogram_ragged(bins, gh, slot, starts, ends, valid, num_bins, n_slots,
                            quantized)


def subtract_histogram(parent: torch.Tensor, sibling: torch.Tensor) -> torch.Tensor:
    """The histogram-subtraction trick (FeatureHistogram::Subtract,
    src/treelearner/feature_histogram.hpp:99): larger child = parent -
    smaller child, skipping a construction pass."""
    return parent - sibling
