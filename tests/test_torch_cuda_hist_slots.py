"""The slot-expanded histogram's kernel, the image conversion kernel and the
wave's children kernel (csrc/histogram.cu) against their plain versions.

Marked `gpu`: these need an NVIDIA card with nvcc, and skip elsewhere. Run
them on the card with `python -m pytest -m gpu --noconftest
tests/test_torch_cuda_hist_slots.py`. Whether a card is present is decided
inside the fixture, never at import.

Contracts: `histogram_slots` on the card is bit-equal to the plain
emulation of its fixed-point sum (`_histogram_slots_ragged_fixed` over
whole-row ranges) on real gradients with NaN, +inf and -inf rows, exactly
equal to the plain version on snapped gradients and in the integer mode,
with slots out of range on either side, at 1, 4, 21 slots and past the
shared-memory split, and two launches bit-equal. The conversion is
bit-equal to its plain version at a wave's 899,640 cells and at odd,
unaligned counts (its scalar path), every channel count. The children
kernel is bit-equal to its plain version (the composition it replaces),
the smaller child on either side, with non-finite cells and a dump row,
in its integer mode (the quantized pool), and inside a captured CUDA
graph.
"""
import numpy as np
import pytest
import torch

from lightgbm_tpu_torch.ops import hist_cuda
from lightgbm_tpu_torch.ops.histogram import (HistImage, _histogram_slots_plain,
                                              _histogram_slots_ragged_fixed,
                                              _image_to_float_plain, _wave_children_plain,
                                              fixed_point_exponents, histogram_slots,
                                              whole_ranges)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m gpu on the card)")
    return torch.device("cuda")


def same_or_both_nan(a, b):
    """Bit-equal, NaN matching NaN whatever its sign and payload."""
    return (torch.equal(a.isnan(), b.isnan())
            and torch.equal(a.masked_fill(a.isnan(), 0), b.masked_fill(b.isnan(), 0)))


def _slots_inputs(seed, G, N, B, S):
    rng = np.random.RandomState(seed)
    bins = rng.randint(0, B, size=(G, N)).astype(np.uint8)
    bins[:, rng.rand(N) < 0.3] = 0
    real = np.stack([rng.normal(size=N), rng.uniform(0, 0.5, N), np.ones(N)], 1)
    for r, c, v in ((3, 0, np.nan), (4, 0, np.inf), (5, 1, -np.inf), (6, 2, np.inf),
                    (7, 2, -np.inf), (N // 2, 1, np.nan)):
        real[r, c] = v
    snapped = np.round(np.nan_to_num(real, nan=0.0, posinf=0.0, neginf=0.0) * 16) / 16
    quant = rng.randint(-127, 128, size=(N, 3))
    slot = rng.randint(-2, S + 2, size=N).astype(np.int32)
    slot[3:8] = np.arange(5) % S  # the non-finite rows in range
    t = torch.from_numpy
    return (t(bins), t(slot), {"real": t(real.astype(np.float32)),
                               "snapped": t(snapped.astype(np.float32)),
                               "quantized": t(quant.astype(np.float32))})


@pytest.mark.parametrize("n_slots", [1, 4, 21, 33])
def test_slots_kernel_matches_plain(cuda, n_slots):
    G, N, B = 6, 20_000, 255
    bins, slot, gh = _slots_inputs(n_slots, G, N, B, n_slots)
    b_d, s_d = bins.to(cuda), slot.to(cuda)
    if n_slots == 33:  # one group's slots past the opt-in: two slot blocks
        assert hist_cuda.slots_launch_shape(N, G, B, 3, n_slots, False, 132)[1] < n_slots
    before = hist_cuda.launches["histogram_slots"]
    got = histogram_slots(b_d, gh["real"].to(cuda), s_d, B, n_slots)
    again = histogram_slots(b_d, gh["real"].to(cuda), s_d, B, n_slots)
    torch.cuda.synchronize()
    assert hist_cuda.launches["histogram_slots"] == before + 2
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    fixed = _histogram_slots_ragged_fixed(bins, gh["real"], slot,
                                          *whole_ranges(N, n_slots, "cpu"), B, n_slots,
                                          fixed_point_exponents(gh["real"], N))
    assert same_or_both_nan(got.cpu(), fixed)
    assert bool(got.isnan().any()) and bool(got.isposinf().any()) \
        and bool(got.isneginf().any())
    for mode in ("snapped", "quantized"):
        q = mode == "quantized"
        got = histogram_slots(b_d, gh[mode].to(cuda), s_d, B, n_slots, quantized=q)
        assert torch.equal(got.cpu(), _histogram_slots_plain(bins, gh[mode], slot, B,
                                                             n_slots, q)), mode


def test_slots_kernel_reads_a_payload_in_place(cuda):
    """gh as the wave learner's [N, 5] payload's first three columns."""
    G, N, B, S = 4, 30_001, 64, 4
    bins, slot, gh = _slots_inputs(7, G, N, B, S)
    wide = torch.zeros((N, 5))
    wide[:, :3] = gh["snapped"]
    got = histogram_slots(bins.to(cuda), wide.to(cuda)[:, :3], slot.to(cuda), B, S)
    assert torch.equal(got.cpu(), _histogram_slots_plain(bins, gh["snapped"], slot, B, S))


@pytest.mark.parametrize("count,ch,offset", [(899_640, 3, 0), (999_999, 3, 3), (999_999, 3, 0),
                                              (4 * 1001, 4, 4), (2 * 777, 2, 2), (13, 1, 1),
                                              (3, 3, 0)])
def test_conversion_matches_plain(cuda, count, ch, offset):
    """The conversion at a wave's 42 children (899,640 cells, the 16-byte
    path) and at odd or unaligned counts (the last count % 4 cells, or the
    scalar path), every code; an aligned image of fewer than four cells (no
    whole 16-byte group) still launches a grid."""
    rng = np.random.RandomState(count + offset)
    sums = torch.from_numpy(rng.randint(-2 ** 62, 2 ** 62, size=count + offset))
    flags = torch.from_numpy(rng.choice([0, 0, 0, 0, 1, 2, 3], size=count + offset)
                             .astype(np.int32))
    exps = torch.from_numpy(rng.randint(-20, 120, size=ch).astype(np.int32))
    s_d, f_d = sums.to(cuda)[offset:], flags.to(cuda)[offset:]
    before = hist_cuda.launches["histogram_image_to_float"]
    got = hist_cuda.image_to_float(s_d, f_d, exps.to(cuda))
    again = hist_cuda.image_to_float(s_d, f_d, exps.to(cuda))
    torch.cuda.synchronize()
    assert hist_cuda.launches["histogram_image_to_float"] == before + 2
    want = _image_to_float_plain(sums[offset:], flags[offset:], exps)
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))


def _children_inputs(seed, R, G, B, CH, K):
    rng = np.random.RandomState(seed)
    t = torch.from_numpy
    pool = HistImage(t(rng.randint(-2 ** 61, 2 ** 61, size=(R, G, B, CH))),
                     t(rng.choice([0, 0, 0, 1, 2, 3], size=(R, G, B, CH)).astype(np.int32)))
    pool.sums[R - 1], pool.flags[R - 1] = 0, 0  # the dump row
    small = HistImage(t(rng.randint(-2 ** 61, 2 ** 61, size=(G, B, K * CH))),
                      t(rng.choice([0, 0, 0, 1, 2, 3], size=(G, B, K * CH)).astype(np.int32)))
    sel = t(rng.choice(R - 1, K, replace=K > R - 1).astype(np.int32))
    sel[-1] = R - 1
    left_small = t(rng.rand(K) < 0.5)
    left_small[0], left_small[-1] = True, False
    exps = t(rng.randint(20, 60, size=CH).astype(np.int32))
    return pool, sel, small, left_small, exps


@pytest.mark.parametrize("K,CH", [(21, 3), (4, 1), (7, 2), (5, 4), (1, 3)])
def test_children_kernel_matches_plain(cuda, K, CH):
    R, G, B = 32, 28, 255
    args = _children_inputs(K * CH, R, G, B, CH, K)
    on = [HistImage(*(x.to(cuda) for x in a)) if isinstance(a, HistImage) else a.to(cuda)
          for a in args]
    before = hist_cuda.launches["wave_children"]
    got = hist_cuda.wave_children(*on)
    again = hist_cuda.wave_children(*on)
    torch.cuda.synchronize()
    assert hist_cuda.launches["wave_children"] == before + 2
    want = _wave_children_plain(*args)
    for g, a, w in zip(got[:2], again[:2], want[:2]):
        assert torch.equal(g.sums.cpu(), w.sums) and torch.equal(g.flags.cpu(), w.flags)
        assert torch.equal(g.sums, a.sums) and torch.equal(g.flags, a.flags)
    assert torch.equal(got[2].cpu().view(torch.int32), want[2].view(torch.int32))
    assert torch.equal(got[2].view(torch.int32), again[2].view(torch.int32))


@pytest.mark.parametrize("K,CH", [(21, 3), (4, 1), (5, 4), (1, 3)])
def test_children_kernel_integer_mode_matches_plain(cuda, K, CH):
    """The quantized pool's int32 (no flags): hists bit-equal to the plain
    version's stack, its halves the children, int32 differences wrapping."""
    R, G, B = 32, 28, 255
    pool, sel, small, left_small, _ = _children_inputs(K * CH + 1, R, G, B, CH, K)
    args = (HistImage(pool.sums.to(torch.int32)), sel,
            HistImage(small.sums.to(torch.int32)), left_small, None)
    on = [HistImage(a.sums.to(cuda)) if isinstance(a, HistImage)
          else None if a is None else a.to(cuda) for a in args]
    before = hist_cuda.launches["wave_children_i32"]
    got = hist_cuda.wave_children(*on)
    again = hist_cuda.wave_children(*on)
    torch.cuda.synchronize()
    assert hist_cuda.launches["wave_children_i32"] == before + 2
    want = _wave_children_plain(*args)
    assert got[2].dtype == torch.int32 and torch.equal(got[2].cpu(), want[2])
    assert torch.equal(got[2], again[2])
    for g, w in zip(got[:2], want[:2]):
        assert g.flags is None and torch.equal(g.sums.cpu(), w.sums)


def test_children_kernel_in_a_graph(cuda):
    """Captured into a CUDA graph, as the wave's graphs take it, and
    replayed on new inputs in the same buffers: the plain version's bits."""
    from lightgbm_tpu_torch.ops.cuda_build import CountedGraph

    R, G, B, CH, K = 16, 5, 64, 3, 6
    args = _children_inputs(1, R, G, B, CH, K)
    on = [HistImage(*(x.to(cuda) for x in a)) if isinstance(a, HistImage) else a.to(cuda)
          for a in args]
    hist_cuda.wave_children(*on)  # loads the library before the capture
    torch.cuda.synchronize()
    out = {}
    graph = CountedGraph(lambda: out.update(r=hist_cuda.wave_children(*on)))
    fresh = _children_inputs(2, R, G, B, CH, K)
    for a, b in zip(on, fresh):
        if isinstance(a, HistImage):
            a.sums.copy_(b.sums)
            a.flags.copy_(b.flags)
        else:
            a.copy_(b)
    before = hist_cuda.launches["wave_children"]
    graph.replay()
    torch.cuda.synchronize()
    assert hist_cuda.launches["wave_children"] == before + 1
    want = _wave_children_plain(*fresh)
    assert torch.equal(out["r"][2].cpu().view(torch.int32), want[2].view(torch.int32))
    assert torch.equal(out["r"][1].sums.cpu(), want[1].sums)
