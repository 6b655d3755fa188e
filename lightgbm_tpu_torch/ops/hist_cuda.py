"""Wrappers of the CUDA histogram kernels (csrc/histogram.cu).

`histogram` replaces ``lightgbm_tpu/ops/hist_pallas.py:pallas_histogram``
and the row gather in front of it (``ops/histogram.py:152-153`` of the JAX
package); with a `HistogramCarry` it sums one leaf histogram over the
blocks of a streamed plane (the kernel's carried mode, the out-of-core
learner's histogram); `histogram_ragged` replaces
``pallas_histogram_slots_ragged``, `histogram_slots` ``pallas_histogram_slots``.
`image_to_float` is the float modes' conversion, and `wave_children` the
wave learner's children step (the larger children by subtraction and both
converted, in one launch). The note at the top of the source gives their
design and bound. The library is built and loaded by ``ops/cuda_build.py``.

Dispatch is by the device of the bin plane alone: a CPU tensor takes the
plain version (``ops/histogram.py``); a CUDA tensor launches the kernel, or
raises. There is no fallback from one to the other.

The float mode (float32 gh) computes the TPU kernel's ``f32=True`` path;
the TPU's default bf16 operands are a matrix-unit rate trick, not part of
the function. Both kernels sum its finite values exactly in 64-bit fixed
point and round to float32 once (``ops/histogram.py:fixed_point_exponents``),
so their bits are those of ``_build_histogram_rows_fixed`` and
``_histogram_slots_ragged_fixed``; a NaN or inf makes its own cell NaN or
inf, as in a float sum. The integer modes sum exactly in int32.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from .cuda_build import CudaLibrary, require_cuda, stream_of
from .histogram import (HistImage, _acc_dtype, _build_histogram_plain,
                        _build_histogram_rows_plain, _histogram_rows_image_plain,
                        _histogram_slots_plain, _histogram_slots_ragged_image_plain,
                        _histogram_slots_ragged_plain, _image_to_float_plain,
                        _wave_children_plain, fixed_point_exponents)


def _declare(lib: ctypes.CDLL) -> None:
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    rows = [ptr, i64, i32, ptr, i32, ptr, i64, i32, i32, i32, ptr, ptr, ptr, i32, ptr]
    for fn in (lib.lgbt_histogram_f32, lib.lgbt_histogram_i32):
        fn.argtypes = rows
        fn.restype = i32
    ragged = [ptr, i64, i32, ptr, i64, i32, ptr, ptr, ptr, ptr, i32, i32, i32, i32,
              ptr, ptr, ptr, ptr]
    for fn in (lib.lgbt_histogram_ragged_f32, lib.lgbt_histogram_ragged_i32):
        fn.argtypes = ragged
        fn.restype = i32
    lib.lgbt_histogram_ragged_image.argtypes = ragged[:-2] + [ptr]
    lib.lgbt_histogram_ragged_image.restype = i32
    lib.lgbt_histogram_image_to_f32.argtypes = [ptr, ptr, i64, i32, ptr, ptr, ptr]
    lib.lgbt_histogram_image_to_f32.restype = i32
    slots = [ptr, i64, i32, ptr, i64, i32, ptr, i32, i32, i32, i32, i32, ptr, ptr, ptr, ptr]
    for fn in (lib.lgbt_histogram_slots_f32, lib.lgbt_histogram_slots_i32):
        fn.argtypes = slots
        fn.restype = i32
    lib.lgbt_wave_children.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, i32, i64, i32, ptr, ptr,
                                       ptr, ptr, ptr, ptr, ptr]
    lib.lgbt_wave_children.restype = i32
    lib.lgbt_wave_children_i32.argtypes = [ptr, ptr, ptr, ptr, i32, i64, i32, ptr, ptr]
    lib.lgbt_wave_children_i32.restype = i32


# the integer modes (quantized-gradient training) and the carried mode (the
# streamed learner's blocks) count apart
LIB = CudaLibrary("histogram.cu", ("histogram", "histogram_slots_ragged", "histogram_i32",
                                   "histogram_slots_ragged_i32", "histogram_carry",
                                   "histogram_carry_i32", "histogram_image",
                                   "histogram_slots_ragged_image", "histogram_image_to_float",
                                   "histogram_slots", "histogram_slots_i32", "wave_children",
                                   "wave_children_i32"),
                  _declare)
launches = LIB.launches
reset_launches = LIB.reset_launches

MAX_RANGES = 1024              # csrc/histogram.cu kMaxRanges
MAX_SLOTS = 65_535             # slots of a slot-expanded launch (its slot blocks: a grid axis)
MAX_WAVE_LEAVES = 65_535       # leaves of a children launch: a grid dimension
MAX_ROWS = (1 << 31) - 1       # rows the kernels' int32 indices and ranges address
SMEM_PER_SM = 233_472          # shared memory of a Hopper SM
SMEM_RESERVED = 1024           # ... of which the system takes this much a block
SMEM_OPT_IN = 232_448          # the most dynamic shared memory a block may opt into
RAGGED_PLAN_BYTES = 8 * (MAX_RANGES + 1 + 32)  # the ragged kernel's range scan
THREADS = 512                  # csrc/histogram.cu kThreads
BLOCKS_PER_SM = 2              # ... and both kernels' launch bounds
ROWS_PER_BLOCK = 4096          # positions a leaf histogram's block takes at least
CARRY_KEEP = 1                 # csrc/histogram.cu kCarryKeep: add into the image as it is
CARRY_OPEN = 2                 # ... kCarryOpen: more calls follow, do not convert


class HistogramCarry:
    """One leaf histogram summed over several `histogram` calls, the blocks
    of a streamed plane, in block order. On the card it holds the kernel's
    image (the int64 fixed-point sums and their flag words, or the int32
    output) from the first call to the last, which converts it once; on the
    CPU the plain version's running sum, whose float32 adds continue cell by
    cell in row order, as one call over the concatenated rows would make
    them. Either way the result is the bits of one call over all the rows.
    Every call of one carry passes the same exponents (the whole tree's)."""

    __slots__ = ("out", "image", "calls")

    def __init__(self) -> None:
        self.out: Optional[torch.Tensor] = None
        self.image: Optional[torch.Tensor] = None
        self.calls = 0


def _bin_bytes(ch: int, quantized: bool) -> int:
    """Bytes a bin of a block's shared histogram takes (csrc/histogram.cu
    bin_words): CH words in the integer mode, 2 CH in the fixed-point float
    mode, padded to an odd count."""
    return 4 * ((ch * (1 if quantized else 2)) | 1)


def _groups_fit(n_groups: int, num_bins: int, ch: int, quantized: bool,
                reserved: int = 0) -> int:
    """The most groups whose block-wide histogram (and `reserved` bytes)
    fits beside the SM's other block."""
    budget = SMEM_PER_SM // BLOCKS_PER_SM - SMEM_RESERVED - reserved
    return max(1, min(n_groups, budget // (num_bins * _bin_bytes(ch, quantized))))


def rows_launch_shape(count: int, n_groups: int, num_bins: int, ch: int, quantized: bool,
                      n_sms: int) -> Tuple[int, int]:
    """(group_block, blocks) of the leaf histogram over `count` positions:
    row chunks of ROWS_PER_BLOCK positions, as many as the card holds at
    BLOCKS_PER_SM blocks an SM beside the group blocks; while the chunks are
    few the groups are split finer, up to one a block, so a small leaf still
    spreads over the SMs. A block's zeroing and flush cost its groups' cells
    whatever its rows: the grid grows with the leaf, not with the card."""
    fit = _groups_fit(n_groups, num_bins, ch, quantized)
    slots = n_sms * BLOCKS_PER_SM
    chunks = max(1, -(-count // ROWS_PER_BLOCK))
    n_gblocks = max(-(-n_groups // fit), min(n_groups, slots // chunks))
    group_block = -(-n_groups // n_gblocks)
    n_gblocks = -(-n_groups // group_block)
    return group_block, max(1, min(chunks, slots // n_gblocks))


def rows_smem_bytes(group_block: int, num_bins: int, ch: int, quantized: bool) -> int:
    """Dynamic shared memory of a leaf-histogram block."""
    return group_block * num_bins * _bin_bytes(ch, quantized)


def _fixed_scratch(cells: int, dev: torch.device) -> torch.Tensor:
    """The float mode's scratch: `cells` int64 sums and `cells` int32 flag
    words behind them (the library lays them out and zeroes them with one
    memset)."""
    return torch.empty(cells + (cells + 1) // 2, dtype=torch.int64, device=dev)


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _check_exponents(exponents: torch.Tensor, ch: int, dev: torch.device) -> None:
    if exponents.dtype != torch.int32 or exponents.device != dev \
            or tuple(exponents.shape) != (ch,):
        raise ValueError(f"exponents must be an int32 [{ch}] tensor on {dev}, got "
                         f"{exponents.dtype} {list(exponents.shape)} on {exponents.device}")


def histogram(bins: torch.Tensor, gh: torch.Tensor, row_idx: Optional[torch.Tensor],
              num_bins: int, count: Optional[int] = None,
              exponents: Optional[torch.Tensor] = None,
              carry: Optional[HistogramCarry] = None, last: bool = True,
              image: bool = False):
    """[G, num_bins, CH] histogram of bins [G, N] over the rows of gh (all
    N rows when row_idx is None, else the padded positions row_idx [P], the
    sentinel N hitting gh's zero row N; with `count`, only the first count
    positions, the rest being sentinel padding). A CPU tensor takes the
    plain version; a CUDA tensor launches the kernel.

    The float mode's fixed-point exponents are `fixed_point_exponents(gh, N)`
    unless the caller passes `exponents`, computed once for several calls.
    The kernel trusts them: they must come from a g with N rows or more whose
    largest finite |g| per channel is at least gh's (the gh of every call, or
    a superset of its rows). Larger values overflow the int64 sums with no
    error.

    With `carry`, the call adds one block of a streamed plane (bins the
    block's [G, n] columns, gh offset to its first row, row_idx block-local
    positions, read to `count`) into the carry's histogram, and `last` says
    whether it is the leaf's last block. The returned tensor is the carry's
    output, which holds the histogram once the last call is enqueued. Every
    call must pass the same `exponents` (the tree's): required in the float
    mode, since a block's own would differ from the other blocks'.

    With `image` (float gh, `exponents` required), the float mode's image,
    unconverted: a `HistImage` of the [G, num_bins, CH] int64 fixed-point
    sums and int32 flag words, which processes add exactly and
    `image_to_float` converts; on the CPU its plain version. With `carry`
    too, every call leaves the carry open (the gang-sharded streamed
    learner's rank sums its own blocks so) and the last returns the image;
    the integer mode's image is its int32 output."""
    if carry is not None:
        return _histogram_carried(bins, gh, row_idx, num_bins, count, exponents, carry, last,
                                  image)
    if image:
        return _histogram_image(bins, gh, row_idx, num_bins, count, exponents)
    if bins.device.type == "cpu":
        if row_idx is None:
            return _build_histogram_plain(bins, gh, num_bins)
        return _build_histogram_rows_plain(bins, gh, row_idx, num_bins, count)
    require_cuda(bins, "the histogram")
    n_pos, quantized = _check_rows(bins, gh, row_idx, num_bins, count, exponents)
    dev = bins.device
    G = bins.shape[0]
    CH = gh.shape[1]
    acc = torch.int32 if quantized else torch.float32
    if n_pos == 0 or G == 0:
        return torch.zeros((G, num_bins, CH), dtype=acc, device=dev)
    if quantized:
        out = torch.empty((G, num_bins, CH), dtype=torch.int32, device=dev)
        image = out
    else:
        out = torch.empty((G, num_bins, CH), dtype=torch.float32, device=dev)
        image = _fixed_scratch(G * num_bins * CH, dev)
        if exponents is None:
            exponents = fixed_point_exponents(gh, bins.shape[1])
    err = _launch_rows(bins, gh, row_idx, num_bins, n_pos, exponents, image, out, 0)
    LIB.count("histogram_i32" if quantized else "histogram", err)
    return out


def _histogram_carried(bins: torch.Tensor, gh: torch.Tensor, row_idx: torch.Tensor,
                       num_bins: int, count: Optional[int],
                       exponents: Optional[torch.Tensor], carry: HistogramCarry,
                       last: bool, image: bool = False):
    """`histogram`'s carried mode (see there)."""
    if row_idx is None:
        raise ValueError("the carried histogram takes block-local row indices")
    quantized = _acc_dtype(gh) == torch.int32
    if not quantized and exponents is None:
        raise ValueError("the carried histogram's float mode needs the tree's exponents: "
                         "a block's own would differ from the other blocks'")
    G, CH = bins.shape[0], gh.shape[1]
    shape = (G, num_bins, CH)
    if carry.out is not None and (tuple(carry.out.shape) != shape
                                  or carry.out.device != bins.device):
        raise ValueError(f"a carry of shape {list(carry.out.shape)} on {carry.out.device} "
                         f"cannot take a {list(shape)} histogram on {bins.device}")
    first = carry.calls == 0
    carry.calls += 1
    if bins.device.type == "cpu":
        if first:
            carry.out = torch.zeros(shape, dtype=_acc_dtype(gh))
        _build_histogram_rows_plain(bins, gh, row_idx, num_bins, count, out=carry.out)
        return HistImage(carry.out) if image else carry.out
    require_cuda(bins, "the histogram")
    n_pos, _ = _check_rows(bins, gh, row_idx, num_bins, count, exponents)
    if n_pos == 0 or G == 0:
        raise ValueError("a carried histogram call must read at least one row")
    dev = bins.device
    if first:
        carry.out = torch.empty(shape, dtype=torch.int32 if quantized else torch.float32,
                                device=dev)
        carry.image = carry.out if quantized else _fixed_scratch(G * num_bins * CH, dev)
    mode = (0 if first else CARRY_KEEP) | (0 if last and not image else CARRY_OPEN)
    err = _launch_rows(bins, gh, row_idx, num_bins, n_pos, exponents, carry.image, carry.out,
                       mode)
    LIB.count("histogram_carry_i32" if quantized else "histogram_carry", err)
    if not image:
        return carry.out
    if quantized:
        return HistImage(carry.out)
    cells = G * num_bins * CH
    return _image_views(carry.image, cells, shape)


def _image_views(scratch: torch.Tensor, cells: int, shape) -> HistImage:
    """The sums and the flag words of a float-mode scratch (`_fixed_scratch`)."""
    return HistImage(scratch[:cells].view(shape),
                     scratch[cells:].view(torch.int32)[:cells].view(shape))


def _histogram_image(bins: torch.Tensor, gh: torch.Tensor, row_idx: Optional[torch.Tensor],
                     num_bins: int, count: Optional[int],
                     exponents: Optional[torch.Tensor]) -> HistImage:
    """`histogram`'s image mode (see there): the leaf histogram's kernel with
    its conversion left out (the carried mode's kCarryOpen on one call)."""
    if _acc_dtype(gh) != torch.float32 or exponents is None:
        raise ValueError("the image mode takes float32 gh and the tree's exponents")
    G, CH = bins.shape[0], gh.shape[1]
    shape = (G, num_bins, CH)
    if bins.device.type == "cpu":
        return _histogram_rows_image_plain(bins, gh, row_idx, num_bins, count, exponents)
    require_cuda(bins, "the histogram")
    n_pos, _ = _check_rows(bins, gh, row_idx, num_bins, count, exponents)
    cells = G * num_bins * CH
    scratch = _fixed_scratch(cells, bins.device)
    if n_pos == 0 or G == 0:
        scratch.zero_()
    else:
        err = _launch_rows(bins, gh, row_idx, num_bins, n_pos, exponents, scratch, scratch,
                           CARRY_OPEN)
        LIB.count("histogram_image", err)
    return _image_views(scratch, cells, shape)


def image_to_float(sums: torch.Tensor, flags: torch.Tensor,
                   exponents: torch.Tensor) -> torch.Tensor:
    """float32 of a float-mode image, sums int64 and flags int32 of one
    shape whose last dimension is a multiple of CH (the channel fastest),
    with the exponents [CH] of the histograms summed into it: the
    conversion kernel on a CUDA tensor, its plain version on a CPU one."""
    CH = exponents.shape[0]
    if sums.shape and sums.shape[-1] % CH:
        raise ValueError(f"the image's last dimension {sums.shape[-1]} is not a multiple "
                         f"of its {CH} channels")
    if sums.dtype != torch.int64 or flags.dtype != torch.int32 \
            or tuple(flags.shape) != tuple(sums.shape):
        raise ValueError(f"an image is int64 sums and int32 flags of one shape, got "
                         f"{sums.dtype} {list(sums.shape)} and {flags.dtype} "
                         f"{list(flags.shape)}")
    if sums.device.type == "cpu":
        return _image_to_float_plain(sums, flags, exponents)
    require_cuda(sums, "the image conversion")
    dev = sums.device
    _check_exponents(exponents, CH, dev)
    sums, flags = sums.contiguous(), flags.contiguous()
    out = torch.empty(sums.shape, dtype=torch.float32, device=dev)
    if sums.numel() == 0:
        return out
    lib = LIB.load()
    with torch.cuda.device(dev):
        err = lib.lgbt_histogram_image_to_f32(sums.data_ptr(), flags.data_ptr(), sums.numel(),
                                              CH, exponents.data_ptr(), out.data_ptr(),
                                              stream_of(sums))
    LIB.count("histogram_image_to_float", err)
    return out


def _check_rows(bins: torch.Tensor, gh: torch.Tensor, row_idx: Optional[torch.Tensor],
                num_bins: int, count: Optional[int],
                exponents: Optional[torch.Tensor]) -> Tuple[int, bool]:
    """Raise ValueError on what the leaf histogram's kernel does not take;
    (positions read, integer mode)."""
    dev = bins.device
    acc = _acc_dtype(gh)
    if bins.dtype != torch.uint8 or bins.dim() != 2 or not bins.is_contiguous():
        raise ValueError(f"the histogram kernel takes a contiguous [G, N] uint8 "
                         f"bin plane, got {bins.dtype} {list(bins.shape)}")
    if not 1 <= num_bins <= 256:
        raise ValueError(f"num_bins must be in [1, 256] for a uint8 plane, got "
                         f"{num_bins}")
    G, N = bins.shape
    if N > MAX_ROWS:
        raise ValueError(f"the histogram addresses rows with int32 indices: at most "
                         f"{MAX_ROWS} rows, got {N}")
    if gh.dim() != 2 or not 1 <= gh.shape[1] <= 4 or gh.device != dev \
            or not gh.is_contiguous() or gh.shape[0] < N:
        raise ValueError(f"gh must be a contiguous [N(+1), 1..4] tensor on {dev} "
                         f"with N = {N}, got {list(gh.shape)} on {gh.device}")
    CH = gh.shape[1]
    if row_idx is None:
        n_pos = N
    else:
        if row_idx.dtype != torch.int32 or row_idx.dim() != 1 \
                or row_idx.device != dev or not row_idx.is_contiguous():
            raise ValueError(f"row_idx must be a contiguous int32 vector on {dev}, "
                             f"got {row_idx.dtype} {list(row_idx.shape)} on "
                             f"{row_idx.device}")
        n_pos = row_idx.shape[0]
    if count is not None:
        if row_idx is None or not 0 <= count <= n_pos:
            raise ValueError(f"count reads the first positions of row_idx: it must be in "
                             f"[0, {n_pos}] with a row_idx, got {count}")
        n_pos = count
    quantized = acc == torch.int32
    if exponents is not None and not quantized:
        _check_exponents(exponents, CH, dev)
    return n_pos, quantized


def _launch_rows(bins: torch.Tensor, gh: torch.Tensor, row_idx: Optional[torch.Tensor],
                 num_bins: int, n_pos: int, exponents: Optional[torch.Tensor],
                 image: torch.Tensor, out: torch.Tensor, carry: int) -> int:
    """One launch of the leaf histogram's kernel over n_pos > 0 positions
    (the arguments checked by `_check_rows`); the library's error code."""
    dev = bins.device
    G, N = bins.shape
    CH = gh.shape[1]
    quantized = gh.dtype == torch.int8
    group_block, blocks = rows_launch_shape(n_pos, G, num_bins, CH, quantized,
                                            _sm_count(dev.index))
    lib = LIB.load()
    fn = lib.lgbt_histogram_i32 if quantized else lib.lgbt_histogram_f32
    with torch.cuda.device(dev):
        err = fn(bins.data_ptr(), N, G, gh.data_ptr(), CH,
                 None if row_idx is None else row_idx.data_ptr(), n_pos, num_bins,
                 group_block, blocks, None if quantized else exponents.data_ptr(),
                 image.data_ptr(), None if quantized else out.data_ptr(), carry,
                 stream_of(bins))
    return err


def ragged_launch_shape(n_groups: int, num_bins: int, ch: int, quantized: bool,
                        n_sms: int) -> Tuple[int, int]:
    """(group_block, blocks) of the ragged histogram: RAGGED_BLOCKS_PER_SM
    persistent blocks an SM, the groups split evenly over as few group
    blocks as let each block's histogram (a bin is CH words in the integer
    mode, 2 CH in the fixed-point float mode, padded to an odd count:
    csrc/histogram.cu bin_words) and range scan fit beside the SM's other
    block; blocks a group block such that all of them are resident at once."""
    fit = _groups_fit(n_groups, num_bins, ch, quantized, RAGGED_PLAN_BYTES)
    n_gblocks = -(-n_groups // fit)
    group_block = -(-n_groups // n_gblocks)
    return group_block, max(1, n_sms * BLOCKS_PER_SM // n_gblocks)


def _check_ragged(bins: torch.Tensor, gh: torch.Tensor, slot: torch.Tensor,
                  starts: torch.Tensor, ends: torch.Tensor, valid: torch.Tensor,
                  num_bins: int, n_slots: int, exponents: Optional[torch.Tensor]) -> None:
    """Raise ValueError on what the ragged kernel does not take."""
    dev = bins.device
    if bins.dtype != torch.uint8 or bins.dim() != 2 or not bins.is_contiguous():
        raise ValueError(f"the ragged histogram takes a contiguous [G, N] uint8 bin "
                         f"plane, got {bins.dtype} {list(bins.shape)}")
    if not 1 <= num_bins <= 256:
        raise ValueError(f"num_bins must be in [1, 256] for a uint8 plane, got "
                         f"{num_bins}")
    G, N = bins.shape
    if N > MAX_ROWS:
        raise ValueError(f"the ragged histogram addresses rows with int32 ranges: at "
                         f"most {MAX_ROWS} rows, got {N}")
    if gh.dtype != torch.float32 or gh.dim() != 2 or gh.shape[0] != N \
            or not 1 <= gh.shape[1] <= 4 or gh.device != dev or gh.stride(1) != 1:
        raise ValueError(f"gh must be a float32 [N, 1..4] tensor on {dev} with unit "
                         f"column stride and N = {N}, got {gh.dtype} "
                         f"{list(gh.shape)} strides {gh.stride()} on {gh.device}")
    if not 1 <= n_slots <= MAX_RANGES:
        raise ValueError(f"n_slots must be in [1, {MAX_RANGES}], got {n_slots}")
    for name, t, dtype, shape in (("slot", slot, torch.int32, (N,)),
                                  ("starts", starts, torch.int32, (n_slots,)),
                                  ("ends", ends, torch.int32, (n_slots,)),
                                  ("valid", valid, torch.bool, (n_slots,))):
        if t.dtype != dtype or tuple(t.shape) != shape or t.device != dev \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dtype} {list(shape)} "
                             f"tensor on {dev}, got {t.dtype} {list(t.shape)} on "
                             f"{t.device}")
    if exponents is not None:
        _check_exponents(exponents, gh.shape[1], dev)


def histogram_ragged(bins: torch.Tensor, gh: torch.Tensor, slot: torch.Tensor,
                     starts: torch.Tensor, ends: torch.Tensor, valid: torch.Tensor,
                     num_bins: int, n_slots: int, quantized: bool = False,
                     exponents: Optional[torch.Tensor] = None, image: bool = False):
    """[G, num_bins, n_slots*CH] wave histogram (ops/histogram.py:
    histogram_slots_ragged). A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel.

    With `image` (the float mode, `exponents` required), the kernel's image
    mode: a `HistImage` of the unconverted [G, num_bins, n_slots*CH] int64
    fixed-point sums and int32 flag words, which processes add exactly and
    `image_to_float` converts; on a CPU tensor its plain version.

    The float mode's fixed-point exponents are `fixed_point_exponents(gh, N)`
    unless the caller passes `exponents`, computed once for several calls.
    The kernel trusts them: they must come from a g with N rows or more whose
    largest finite |g| per channel is at least gh's (the gh of every call, or
    a superset of its rows). Larger values overflow the int64 sums with no
    error."""
    if image and (quantized or exponents is None):
        raise ValueError("the image mode is the float mode's, with the tree's exponents")
    if bins.device.type == "cpu":
        if image:
            return _histogram_slots_ragged_image_plain(bins, gh, slot, starts, ends, valid,
                                                       num_bins, n_slots, exponents)
        return _histogram_slots_ragged_plain(bins, gh, slot, starts, ends, valid,
                                             num_bins, n_slots, quantized)
    require_cuda(bins, "the ragged histogram")
    _check_ragged(bins, gh, slot, starts, ends, valid, num_bins, n_slots, exponents)
    if image:
        return _ragged_image(bins, gh, slot, starts, ends, valid, num_bins, n_slots, exponents)
    dev = bins.device
    G, N = bins.shape
    CH = gh.shape[1]
    acc = torch.int32 if quantized else torch.float32
    if N == 0 or G == 0:
        return torch.zeros((G, num_bins, n_slots * CH), dtype=acc, device=dev)
    group_block, blocks = ragged_launch_shape(G, num_bins, CH, quantized,
                                              _sm_count(dev.index))
    lib = LIB.load()
    count = G * num_bins * n_slots * CH
    if quantized:
        out = torch.empty((G, num_bins, n_slots * CH), dtype=torch.int32, device=dev)
        image, exps, fn = out, None, lib.lgbt_histogram_ragged_i32
    else:
        out = torch.empty((G, num_bins, n_slots * CH), dtype=torch.float32, device=dev)
        image = _fixed_scratch(count, dev)
        exps = exponents if exponents is not None else fixed_point_exponents(gh, N)
        fn = lib.lgbt_histogram_ragged_f32
    with torch.cuda.device(dev):
        err = fn(bins.data_ptr(), N, G, gh.data_ptr(), gh.stride(0), CH, slot.data_ptr(),
                 starts.data_ptr(), ends.data_ptr(), valid.data_ptr(), n_slots, num_bins,
                 group_block, blocks, None if exps is None else exps.data_ptr(),
                 image.data_ptr(), out.data_ptr(), stream_of(bins))
    LIB.count("histogram_slots_ragged_i32" if quantized else "histogram_slots_ragged", err)
    return out


def _ragged_image(bins: torch.Tensor, gh: torch.Tensor, slot: torch.Tensor,
                  starts: torch.Tensor, ends: torch.Tensor, valid: torch.Tensor,
                  num_bins: int, n_slots: int, exponents: torch.Tensor) -> HistImage:
    """`histogram_ragged`'s image mode on the card (arguments checked)."""
    dev = bins.device
    G, N = bins.shape
    CH = gh.shape[1]
    cells = G * num_bins * n_slots * CH
    scratch = _fixed_scratch(cells, dev)
    shape = (G, num_bins, n_slots * CH)
    if N == 0 or G == 0:
        scratch.zero_()
        return _image_views(scratch, cells, shape)
    group_block, blocks = ragged_launch_shape(G, num_bins, CH, False, _sm_count(dev.index))
    lib = LIB.load()
    with torch.cuda.device(dev):
        err = lib.lgbt_histogram_ragged_image(
            bins.data_ptr(), N, G, gh.data_ptr(), gh.stride(0), CH, slot.data_ptr(),
            starts.data_ptr(), ends.data_ptr(), valid.data_ptr(), n_slots, num_bins,
            group_block, blocks, exponents.data_ptr(), scratch.data_ptr(), stream_of(bins))
    LIB.count("histogram_slots_ragged_image", err)
    return _image_views(scratch, cells, shape)


def slots_launch_shape(n_rows: int, n_groups: int, num_bins: int, ch: int, n_slots: int,
                       quantized: bool, n_sms: int) -> Tuple[int, int, int]:
    """(group_block, slot_block, blocks) of the slot-expanded histogram.
    One group's slot block is as many of the n_slots as fit the opt-in
    shared memory (split evenly when they do not all fit); then as
    `rows_launch_shape`: groups as many as fit beside the SM's other block
    (one when a group's slot block takes more), row chunks of
    ROWS_PER_BLOCK rows, as many as the card holds at BLOCKS_PER_SM blocks
    an SM beside the group and slot blocks, and the groups split finer
    while the chunks are few."""
    cell = num_bins * _bin_bytes(ch, quantized)  # one group's bins of one slot
    n_sblocks = -(-n_slots // max(1, min(n_slots, SMEM_OPT_IN // cell)))
    slot_block = -(-n_slots // n_sblocks)
    budget = SMEM_PER_SM // BLOCKS_PER_SM - SMEM_RESERVED
    fit = max(1, min(n_groups, budget // (cell * slot_block)))
    slots = n_sms * BLOCKS_PER_SM
    chunks = max(1, -(-n_rows // ROWS_PER_BLOCK))
    n_gblocks = max(-(-n_groups // fit), min(n_groups, slots // (chunks * n_sblocks)))
    group_block = -(-n_groups // n_gblocks)
    n_gblocks = -(-n_groups // group_block)
    return group_block, slot_block, max(1, min(chunks, slots // (n_gblocks * n_sblocks)))


def slots_smem_bytes(group_block: int, slot_block: int, num_bins: int, ch: int,
                     quantized: bool) -> int:
    """Dynamic shared memory of a slot-expanded histogram's block."""
    return group_block * slot_block * num_bins * _bin_bytes(ch, quantized)


def _check_slots(bins: torch.Tensor, gh: torch.Tensor, slot: torch.Tensor, num_bins: int,
                 n_slots: int, exponents: Optional[torch.Tensor]) -> None:
    """Raise ValueError on what the slot-expanded histogram's kernel does not
    take."""
    dev = bins.device
    if bins.dtype != torch.uint8 or bins.dim() != 2 or not bins.is_contiguous():
        raise ValueError(f"the slot-expanded histogram takes a contiguous [G, N] uint8 bin "
                         f"plane, got {bins.dtype} {list(bins.shape)}")
    if not 1 <= num_bins <= 256:
        raise ValueError(f"num_bins must be in [1, 256] for a uint8 plane, got {num_bins}")
    G, N = bins.shape
    if N > MAX_ROWS:
        raise ValueError(f"the slot-expanded histogram addresses rows with int32 indices: "
                         f"at most {MAX_ROWS} rows, got {N}")
    if gh.dtype != torch.float32 or gh.dim() != 2 or gh.shape[0] != N \
            or not 1 <= gh.shape[1] <= 4 or gh.device != dev or gh.stride(1) != 1:
        raise ValueError(f"gh must be a float32 [N, 1..4] tensor on {dev} with unit column "
                         f"stride and N = {N}, got {gh.dtype} {list(gh.shape)} strides "
                         f"{gh.stride()} on {gh.device}")
    if slot.dtype != torch.int32 or tuple(slot.shape) != (N,) or slot.device != dev \
            or not slot.is_contiguous():
        raise ValueError(f"slot must be a contiguous int32 [{N}] tensor on {dev}, got "
                         f"{slot.dtype} {list(slot.shape)} on {slot.device}")
    if not 1 <= n_slots <= MAX_SLOTS:
        raise ValueError(f"n_slots must be in [1, {MAX_SLOTS}], got {n_slots}")
    if exponents is not None:
        _check_exponents(exponents, gh.shape[1], dev)


def histogram_slots(bins: torch.Tensor, gh: torch.Tensor, slot: torch.Tensor, num_bins: int,
                    n_slots: int, quantized: bool = False,
                    exponents: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[G, num_bins, n_slots*CH] slot-expanded histogram over every row
    (ops/histogram.py:histogram_slots): row n adds its gh to channel block
    slot[n], a row whose slot is outside [0, n_slots) nowhere. A CPU tensor
    takes the plain version; a CUDA tensor launches hist_slots_kernel, which
    reads each row once. Float mode in 64-bit fixed point (the bits of
    `_histogram_slots_ragged_fixed` over whole-row ranges) with
    `fixed_point_exponents(gh, N)` unless the caller passes `exponents`,
    which the kernel trusts as `histogram_ragged` does; the integer mode
    truncates gh to int32 and sums exactly."""
    if bins.device.type == "cpu":
        return _histogram_slots_plain(bins, gh, slot, num_bins, n_slots, quantized)
    require_cuda(bins, "the slot-expanded histogram")
    _check_slots(bins, gh, slot, num_bins, n_slots, exponents)
    dev = bins.device
    G, N = bins.shape
    CH = gh.shape[1]
    acc = torch.int32 if quantized else torch.float32
    if N == 0 or G == 0:
        return torch.zeros((G, num_bins, n_slots * CH), dtype=acc, device=dev)
    out = torch.empty((G, num_bins, n_slots * CH), dtype=acc, device=dev)
    if quantized:
        image, exps = out, None
    else:
        image = _fixed_scratch(G * num_bins * n_slots * CH, dev)
        exps = exponents if exponents is not None else fixed_point_exponents(gh, N)
    group_block, slot_block, blocks = slots_launch_shape(N, G, num_bins, CH, n_slots,
                                                         quantized, _sm_count(dev.index))
    lib = LIB.load()
    fn = lib.lgbt_histogram_slots_i32 if quantized else lib.lgbt_histogram_slots_f32
    with torch.cuda.device(dev):
        err = fn(bins.data_ptr(), N, G, gh.data_ptr(), gh.stride(0), CH, slot.data_ptr(),
                 n_slots, num_bins, group_block, slot_block, blocks,
                 None if quantized else exps.data_ptr(), image.data_ptr(), out.data_ptr(),
                 stream_of(bins))
    LIB.count("histogram_slots_i32" if quantized else "histogram_slots", err)
    return out


def wave_children(pool: HistImage, sel: torch.Tensor, small: HistImage,
                  left_small: torch.Tensor, exponents: Optional[torch.Tensor]):
    """The wave's children step (ops/histogram.py:wave_children): (left,
    right, hists) from the pool [R, G, B, CH], the selected leaves' rows sel
    [K] int32, the smaller children's image [G, B, K*CH] as the ragged
    kernel leaves it, and left_small [K] bool. A CPU tensor takes the plain
    version (the composition it replaces); a CUDA tensor launches
    wave_children_kernel: on a fixed-point pool (int64 sums, int32 flags)
    its float mode, on the quantized int32 pool (flags None) its integer
    mode, whose left and right are the halves of hists. sel is trusted: its
    rows must be the pool's (the selection kernel's)."""
    if pool.sums.device.type == "cpu":
        return _wave_children_plain(pool, sel, small, left_small, exponents)
    require_cuda(pool.sums, "the wave's children step")
    K, G, B, CH = _check_children(pool, sel, small, left_small, exponents)
    dev = pool.sums.device
    lib = LIB.load()
    if pool.flags is None:
        hists = torch.empty((2 * K, G, B, CH), dtype=torch.int32, device=dev)
        with torch.cuda.device(dev):
            err = lib.lgbt_wave_children_i32(pool.sums.data_ptr(), sel.data_ptr(),
                                             small.sums.data_ptr(), left_small.data_ptr(), K,
                                             G * B, CH, hists.data_ptr(), stream_of(sel))
        LIB.count("wave_children_i32", err)
        pair = hists.view(K, 2, G, B, CH)
        return HistImage(pair[:, 0]), HistImage(pair[:, 1]), hists
    sums = torch.empty((2, K, G, B, CH), dtype=torch.int64, device=dev)
    flags = torch.empty((2, K, G, B, CH), dtype=torch.int32, device=dev)
    hists = torch.empty((2 * K, G, B, CH), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.lgbt_wave_children(pool.sums.data_ptr(), pool.flags.data_ptr(),
                                     sel.data_ptr(), small.sums.data_ptr(),
                                     small.flags.data_ptr(), left_small.data_ptr(), K, G * B,
                                     CH, exponents.data_ptr(), sums[0].data_ptr(),
                                     flags[0].data_ptr(), sums[1].data_ptr(),
                                     flags[1].data_ptr(), hists.data_ptr(), stream_of(sel))
    LIB.count("wave_children", err)
    return HistImage(sums[0], flags[0]), HistImage(sums[1], flags[1]), hists


def _check_children(pool: HistImage, sel: torch.Tensor, small: HistImage,
                    left_small: torch.Tensor,
                    exponents: Optional[torch.Tensor]) -> Tuple[int, ...]:
    """Raise ValueError on what the children kernel does not take; (K, G,
    B, CH)."""
    dev = pool.sums.device
    fixed = pool.flags is not None
    if pool.sums.dim() != 4 or pool.sums.dtype != (torch.int64 if fixed else torch.int32):
        raise ValueError("the children step takes the pool's [R, G, B, CH] int64 sums with "
                         "their int32 flag words, or the quantized pool's int32 [R, G, B, CH], "
                         f"got {pool.sums.dtype} {list(pool.sums.shape)}"
                         f"{'' if fixed else ' without flags'}")
    _, G, B, CH = pool.sums.shape
    K = sel.shape[0] if sel.dim() == 1 else -1
    if not 1 <= K <= MAX_WAVE_LEAVES:
        raise ValueError(f"sel must be an int32 vector of 1 to {MAX_WAVE_LEAVES} leaves, "
                         f"got {list(sel.shape)}")
    sum_dtype = pool.sums.dtype
    wanted = [("pool sums", pool.sums, sum_dtype, pool.sums.shape),
              ("sel", sel, torch.int32, (K,)),
              ("small sums", small.sums, sum_dtype, (G, B, K * CH)),
              ("left_small", left_small, torch.bool, (K,))]
    if fixed:
        wanted += [("pool flags", pool.flags, torch.int32, pool.sums.shape),
                   ("small flags", small.flags, torch.int32, (G, B, K * CH))]
    elif small.flags is not None:
        raise ValueError("the quantized pool takes the smaller children's int32 image without "
                         "flags")
    for name, t, dtype, shape in wanted:
        if t is None or t.dtype != dtype or tuple(t.shape) != tuple(shape) \
                or t.device != dev or not t.is_contiguous():
            got = "None" if t is None else f"{t.dtype} {list(t.shape)} on {t.device}"
            raise ValueError(f"{name} must be a contiguous {dtype} {list(shape)} tensor on "
                             f"{dev}, got {got}")
    if fixed:
        _check_exponents(exponents, CH, dev)
    return K, G, B, CH
