"""The port's slot-expanded histogram (`histogram_slots`, ops/histogram.py;
on the card `hist_cuda.histogram_slots`, a kernel of its own) against the
JAX package's ``pallas_histogram_slots`` in interpret mode with float32
operands (``f32=True``), its launch shape against the card's shared memory,
and the wrapper's checks.

Contracts: exact on grid-snapped gradients (multiples of 2**-4 small
enough that every partial sum is exact in float32) and in the integer mode
(quantized=True); a row whose slot is outside [0, n_slots) adds nothing.
The kernel's own arithmetic (64-bit fixed point, `_histogram_slots_ragged_fixed`
over whole-row ranges) is held on the card (tests/test_torch_cuda_hist_slots.py).
"""
import numpy as np
import pytest
import torch

from lightgbm_tpu_torch.ops import hist_cuda
from lightgbm_tpu_torch.ops.histogram import (_histogram_slots_plain,
                                              _histogram_slots_ragged_fixed,
                                              fixed_point_exponents, histogram_slots,
                                              whole_ranges)
from tests.test_torch_ref import jax_ref  # noqa: F401


def _inputs(seed, n, G, B, S, mode):
    """bins [G, n] uint8, gh [n, 3] float32, slot [n] int32 in [-2, S + 2)
    (some rows out of range on either side)."""
    rng = np.random.RandomState(seed)
    bins = rng.randint(0, B, size=(G, n)).astype(np.uint8)
    bins[:, rng.rand(n) < 0.3] = 0  # a dominant bin, as a default bin is
    if mode == "quantized":
        gh = np.stack([rng.randint(-4, 5, n), rng.randint(0, 6, n), np.ones(n)], 1)
    else:
        gh = np.stack([np.round(rng.normal(size=n) * 16) / 16,
                       np.round(rng.uniform(0, 0.5, n) * 16) / 16, np.ones(n)], 1)
    slot = rng.randint(-2, S + 2, size=n).astype(np.int32)
    return bins, gh.astype(np.float32), slot


@pytest.mark.parametrize("quantized", [False, True], ids=["snapped", "quantized"])
@pytest.mark.parametrize("n_slots", [1, 4, 21])
def test_slots_match_pallas(jax_ref, n_slots, quantized):
    import jax.numpy as jnp
    from lightgbm_tpu.ops.hist_pallas import pallas_histogram_slots

    n, G, B = 2500, 3, 16
    bins, gh, slot = _inputs(11 * n_slots + quantized, n, G, B, n_slots,
                             "quantized" if quantized else "snapped")
    before = dict(hist_cuda.launches)
    port = histogram_slots(torch.from_numpy(bins), torch.from_numpy(gh),
                           torch.from_numpy(slot), B, n_slots, quantized=quantized).numpy()
    assert hist_cuda.launches == before  # a CPU tensor launches nothing
    assert port.shape == (G, B, n_slots * 3)
    assert port.dtype == (np.int32 if quantized else np.float32)
    ref = np.asarray(pallas_histogram_slots(
        jnp.asarray(bins), jnp.asarray(gh.astype(np.int8) if quantized else gh),
        jnp.asarray(slot), B, n_slots, quantized=quantized, f32=not quantized,
        interpret=True))
    np.testing.assert_array_equal(port, ref)


@pytest.mark.parametrize("n_slots", [1, 4, 21])
def test_slots_plain_is_the_fixed_point_sum_on_snapped(n_slots):
    """On snapped gradients the kernel's arithmetic (the fixed-point sum
    over whole-row ranges) gives the plain version's bits, and a row out of
    range adds nothing: the histogram of the in-range rows alone."""
    n, G, B = 3000, 2, 8
    bins, gh, slot = (torch.from_numpy(a) for a in _inputs(n_slots, n, G, B, n_slots,
                                                         "snapped"))
    plain = _histogram_slots_plain(bins, gh, slot, B, n_slots)
    fixed = _histogram_slots_ragged_fixed(bins, gh, slot, *whole_ranges(n, n_slots, "cpu"),
                                          B, n_slots, fixed_point_exponents(gh, n))
    assert torch.equal(fixed, plain)
    keep = (slot >= 0) & (slot < n_slots)
    alone = _histogram_slots_plain(bins[:, keep].contiguous(), gh[keep], slot[keep], B,
                                   n_slots)
    assert torch.equal(alone, plain)


@pytest.mark.parametrize("quantized", [False, True], ids=["fixed", "int32"])
@pytest.mark.parametrize("ch", [1, 2, 3, 4])
def test_slots_launch_fits_shared_memory(ch, quantized):
    """Every n_slots up to 64 launches within the opt-in shared memory, a
    block a slot block of one group at least; where the slots fit the SM's
    half, two blocks an SM; the slot blocks cover the slots."""
    budget = hist_cuda.SMEM_PER_SM // hist_cuda.BLOCKS_PER_SM - hist_cuda.SMEM_RESERVED
    for G, B, n in ((28, 255, 65_536), (1, 256, 4_000), (200, 64, 1_048_576)):
        for S in range(1, 65):
            gb, sb, blocks = hist_cuda.slots_launch_shape(n, G, B, ch, S, quantized, 132)
            smem = hist_cuda.slots_smem_bytes(gb, sb, B, ch, quantized)
            assert 1 <= gb <= G and 1 <= sb <= S and blocks >= 1
            assert smem <= hist_cuda.SMEM_OPT_IN
            assert gb == 1 or smem <= budget
            n_sblocks = -(-S // sb)
            assert (n_sblocks - 1) * sb < S <= n_sblocks * sb
            n_gblocks = -(-G // gb)
            assert blocks == 1 or blocks * n_gblocks * n_sblocks <= 132 * hist_cuda.BLOCKS_PER_SM
    # chip_smoke's sample: 16 row chunks, one slot block, two blocks an SM
    gb, sb, blocks = hist_cuda.slots_launch_shape(65_536, 28, 255, 3, 4, False, 132)
    assert (gb, sb, blocks) == (2, 4, 16)
    # one group's 33 slots of 255 bins x 3 fixed-point channels pass the opt-in
    assert hist_cuda.slots_launch_shape(65_536, 28, 255, 3, 32, False, 132)[1] == 32
    assert hist_cuda.slots_launch_shape(65_536, 28, 255, 3, 33, False, 132)[1] == 17


def _args(n=100, G=2, S=4):
    bins = torch.zeros((G, n), dtype=torch.uint8)
    gh = torch.zeros((n, 3))
    slot = torch.zeros(n, dtype=torch.int32)
    return bins, gh, slot, 16, S, None


@pytest.mark.parametrize("bad", ["bins_dtype", "bins_1d", "num_bins", "gh_dtype", "gh_rows",
                                 "gh_channels", "gh_column_stride", "slot_dtype", "slot_rows",
                                 "n_slots_0", "n_slots_big", "exponents"])
def test_slots_wrapper_checks(bad):
    bins, gh, slot, B, S, exps = _args()
    hist_cuda._check_slots(bins, gh, slot, B, S, exps)  # the good arguments pass
    if bad == "bins_dtype":
        bins = bins.to(torch.int32)
    elif bad == "bins_1d":
        bins = bins[0]
    elif bad == "num_bins":
        B = 257
    elif bad == "gh_dtype":
        gh = gh.double()
    elif bad == "gh_rows":
        gh = gh[:-1]
    elif bad == "gh_channels":
        gh = torch.zeros((gh.shape[0], 5))
    elif bad == "gh_column_stride":
        gh = torch.zeros((3, gh.shape[0])).t()
    elif bad == "slot_dtype":
        slot = slot.long()
    elif bad == "slot_rows":
        slot = slot[:-1]
    elif bad == "n_slots_0":
        S = 0
    elif bad == "n_slots_big":
        S = hist_cuda.MAX_SLOTS + 1
    else:
        exps = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError):
        hist_cuda._check_slots(bins, gh, slot, B, S, exps)


def test_slots_reads_a_strided_payload():
    """gh read in place from a wider payload (rows of a leading stride), as
    the wave learner's columns are: the same histogram as a copy's."""
    bins, gh, slot = (torch.from_numpy(a) for a in _inputs(5, 2000, 3, 16, 4, "snapped"))
    wide = torch.zeros((gh.shape[0], 5))
    wide[:, :3] = gh
    hist_cuda._check_slots(bins, wide[:, :3], slot, 16, 4, None)
    assert torch.equal(histogram_slots(bins, wide[:, :3], slot, 16, 4),
                       histogram_slots(bins, gh, slot, 16, 4))


def test_slots_bound_counts_the_rows_in_range():
    """Row 6's bytes: every row's slot, and only the in-range rows' bins and
    gh; with every row in range, row 2's formula over one range."""
    from lightgbm_tpu_torch import perfmodel as pm

    assert pm.hist_slots(65_536, 43_690, 28, 342_720) == (
        65_536 * 4 + 43_690 * (28 + 12) + 342_720, 3 * 28 * 43_690)
    assert pm.hist_slots(1000, 1000, 28, 77) == pm.hist_ragged(1000, 28, 1, 77)
