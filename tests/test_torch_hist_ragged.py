"""The port's wave histogram (`histogram_slots_ragged` and `histogram_slots`,
ops/histogram.py; their plain version is what the CUDA kernel is held
against on the card) against the JAX package's
``pallas_histogram_slots_ragged`` and ``pallas_histogram_slots`` in interpret
mode with float32 operands (``f32=True``), and against the XLA slot-expanded
build the JAX wave learner falls back to (``treelearner/device.py:331-336``).

Contracts: exact on grid-snapped gradients (multiples of 2**-4 small enough
that every partial sum is exact in float32) and in the integer mode
(quantized=True); on unsnapped gradients within the float32 summation
bound n * 2**-24 * sum|v| per bin. Rows inside range k carry slot k or the
dump, the JAX kernel's precondition (its tile table comes from JAX's own
``active_tile_table`` on the same ranges).
"""
import numpy as np
import pytest
import torch

from lightgbm_tpu_torch.ops import hist_cuda
from lightgbm_tpu_torch.ops.histogram import histogram_slots, histogram_slots_ragged
from tests.test_torch_ref import jax_ref  # noqa: F401

TILE = 512


def _setup(seed, n, G, B, ranges, mode):
    """bins [G, n] uint8, gh [n, 3] float32, slot [n] (range k's rows carry
    slot k, a few of them the dump, every other row the dump)."""
    rng = np.random.RandomState(seed)
    bins = rng.randint(0, B, size=(G, n)).astype(np.uint8)
    bins[:, rng.rand(n) < 0.3] = 0  # a dominant bin, as a default bin is
    if mode == "quantized":
        gh = np.stack([rng.randint(-4, 5, n), rng.randint(0, 6, n), np.ones(n)], 1)
    elif mode == "snapped":
        gh = np.stack([np.round(rng.normal(size=n) * 16) / 16,
                       np.round(rng.uniform(0, 0.5, n) * 16) / 16, np.ones(n)], 1)
    else:
        gh = np.stack([rng.normal(size=n), rng.uniform(0, 0.5, n), np.ones(n)], 1)
    K = len(ranges)
    slot = np.full(n, K, dtype=np.int32)
    for k, (s, e) in enumerate(ranges):
        slot[s:e] = k
    slot[rng.rand(n) < 0.05] = K
    return bins, gh.astype(np.float32), slot


def _port(bins, gh, slot, ranges, valid, B, quantized=False):
    K = len(ranges)
    t = torch.from_numpy
    return histogram_slots_ragged(
        t(bins), t(gh), t(slot), t(np.asarray([s for s, _ in ranges], np.int32)),
        t(np.asarray([e for _, e in ranges], np.int32)), t(np.asarray(valid)), B, K,
        quantized=quantized).numpy()


RAGGED = [
    ("spread", 4096, 3, 16, [(0, 700), (1024, 1100), (2000, 3000)]),
    ("tile_aligned", 4096, 3, 16, [(512, 1024)]),
    ("tiny_and_tail", 4096, 3, 16, [(100, 101), (3500, 4096)]),
    ("wide", 8192, 5, 255, [(0, 1500), (1500, 1501), (2048, 6000), (6000, 8190)]),
]


@pytest.mark.parametrize("case", RAGGED, ids=[c[0] for c in RAGGED])
def test_ragged_matches_pallas_and_xla_on_snapped(jax_ref, case):
    import jax.numpy as jnp
    from lightgbm_tpu.ops.hist_pallas import (active_tile_table,
                                              pallas_histogram_slots_ragged)
    from lightgbm_tpu.ops.histogram import build_histogram

    name, n, G, B, ranges = case
    K = len(ranges)
    valid = [True] * K
    if K > 2:
        valid[1] = False
    bins, gh, slot = _setup(n + G, n, G, B, ranges, "snapped")
    # an invalid range's rows are the dump's, as in a wave
    for k, (s, e) in enumerate(ranges):
        if not valid[k]:
            slot[s:e] = K
    port = _port(bins, gh, slot, ranges, valid, B)
    assert port.shape == (G, B, K * 3) and port.dtype == np.float32
    starts = jnp.asarray([s for s, _ in ranges], jnp.int32)
    ends = jnp.asarray([e for _, e in ranges], jnp.int32)
    tiles, n_act = active_tile_table(starts, ends, jnp.asarray(valid), n // TILE, TILE)
    pallas = np.asarray(pallas_histogram_slots_ragged(
        jnp.asarray(bins), jnp.asarray(gh), jnp.asarray(slot), tiles, n_act, B, K,
        tile_rows=TILE, f32=True, interpret=True))
    np.testing.assert_array_equal(port, pallas)
    col_slot = np.arange(K * 3) // 3
    ghk = np.where(slot[:, None] == col_slot[None, :], np.tile(gh, (1, K)), 0.0)
    xla = np.asarray(build_histogram(jnp.asarray(bins), jnp.asarray(ghk, jnp.float32), B))
    np.testing.assert_array_equal(port, xla)


@pytest.mark.parametrize("case", RAGGED[:2] + RAGGED[3:], ids=["spread", "tile_aligned",
                                                               "wide"])
def test_ragged_within_summation_bound(jax_ref, case):
    import jax.numpy as jnp
    from lightgbm_tpu.ops.hist_pallas import (active_tile_table,
                                              pallas_histogram_slots_ragged)

    name, n, G, B, ranges = case
    K = len(ranges)
    bins, gh, slot = _setup(3 * n, n, G, B, ranges, "real")
    port = _port(bins, gh, slot, ranges, [True] * K, B)
    absport = _port(bins, np.abs(gh), slot, ranges, [True] * K, B)
    starts = jnp.asarray([s for s, _ in ranges], jnp.int32)
    ends = jnp.asarray([e for _, e in ranges], jnp.int32)
    tiles, n_act = active_tile_table(starts, ends, jnp.ones(K, bool), n // TILE, TILE)
    pallas = np.asarray(pallas_histogram_slots_ragged(
        jnp.asarray(bins), jnp.asarray(gh), jnp.asarray(slot), tiles, n_act, B, K,
        tile_rows=TILE, f32=True, interpret=True))
    bound = n * 2.0 ** -24 * absport.astype(np.float64)
    assert (np.abs(port.astype(np.float64) - pallas) <= bound).all()


@pytest.mark.parametrize("case", RAGGED[:1] + RAGGED[3:], ids=["spread", "wide"])
def test_ragged_quantized_exact(jax_ref, case):
    import jax.numpy as jnp
    from lightgbm_tpu.ops.hist_pallas import (active_tile_table,
                                              pallas_histogram_slots_ragged)

    name, n, G, B, ranges = case
    K = len(ranges)
    bins, gh, slot = _setup(5 * n, n, G, B, ranges, "quantized")
    port = _port(bins, gh, slot, ranges, [True] * K, B, quantized=True)
    assert port.dtype == np.int32
    starts = jnp.asarray([s for s, _ in ranges], jnp.int32)
    ends = jnp.asarray([e for _, e in ranges], jnp.int32)
    tiles, n_act = active_tile_table(starts, ends, jnp.ones(K, bool), n // TILE, TILE)
    pallas = np.asarray(pallas_histogram_slots_ragged(
        jnp.asarray(bins), jnp.asarray(gh), jnp.asarray(slot), tiles, n_act, B, K,
        tile_rows=TILE, quantized=True, interpret=True))
    np.testing.assert_array_equal(port, pallas)


@pytest.mark.parametrize("quantized", [False, True], ids=["snapped", "quantized"])
def test_slots_match_pallas(jax_ref, quantized):
    import jax.numpy as jnp
    from lightgbm_tpu.ops.hist_pallas import pallas_histogram_slots

    n, G, B, S = 3000, 3, 16, 4
    bins, gh, _ = _setup(17, n, G, B, [], "quantized" if quantized else "snapped")
    slot = np.random.RandomState(3).randint(0, S + 2, size=n).astype(np.int32)
    before = dict(hist_cuda.launches)
    port = histogram_slots(torch.from_numpy(bins), torch.from_numpy(gh),
                           torch.from_numpy(slot), B, S, quantized=quantized).numpy()
    assert hist_cuda.launches == before  # a CPU tensor launches nothing
    assert port.shape == (G, B, S * 3)
    ref = np.asarray(pallas_histogram_slots(
        jnp.asarray(bins), jnp.asarray(gh.astype(np.int8) if quantized else gh),
        jnp.asarray(slot), B, S, quantized=quantized, f32=not quantized,
        interpret=True))
    np.testing.assert_array_equal(port, ref)


def test_bins_past_num_bins_add_nowhere():
    bins = np.array([[0, 1, 7, 2]], np.uint8)
    gh = np.ones((4, 3), np.float32)
    slot = np.zeros(4, np.int32)
    out = _port(bins, gh, slot, [(0, 4)], [True], 4)
    assert out.shape == (1, 4, 3)
    np.testing.assert_array_equal(out[0, :, 2], [1, 1, 1, 0])


# ------------------------------------------------- the CUDA kernel's float mode

@pytest.mark.parametrize("n_rows", [1, 2, 4097, 1 << 20, hist_cuda.MAX_ROWS])
def test_fixed_point_exponents_never_overflow(n_rows):
    """At any N the wrapper takes and any finite gh, the largest fixed-point
    value times N, plus N/2 of rounding, stays below 2**63; and the scale is
    fine enough that multiples of 2**-10 are exact while N * max|gh| <= 2**52."""
    import math

    from lightgbm_tpu_torch.ops.histogram import fixed_point_exponents

    mags = [0.0, 2.0 ** -149, 1e-30, 1e-3, 0.75, 1.0, 1.5, 1e6, 3.4e38]
    gh = torch.tensor([[m, -m, 1.0] for m in mags], dtype=torch.float32)
    for m in mags:
        e = int(fixed_point_exponents(gh[[mags.index(m)]], n_rows)[0])
        top = abs(round(math.ldexp(float(np.float32(m)), e)))
        assert n_rows * top + n_rows // 2 < 2 ** 63, (m, e)
        if m > 0 and n_rows * m <= 2.0 ** 52:
            assert e >= 10, (m, e)
    both = fixed_point_exponents(gh, n_rows)
    assert both.dtype == torch.int32 and both.shape == (3,)


def test_fixed_point_exponents_skip_nonfinite():
    """NaN and inf stay out of the fixed point: the exponents are those of
    the finite values."""
    from lightgbm_tpu_torch.ops.histogram import fixed_point_exponents

    nan, inf = float("nan"), float("inf")
    gh = torch.tensor([[1.0, nan, 0.5], [2.0, 0.25, inf], [-4.0, -inf, -0.75]])
    clean = torch.where(torch.isfinite(gh), gh, 0.0)
    assert torch.equal(fixed_point_exponents(gh, 3), fixed_point_exponents(clean, 3))


def _fixed_and_plain(case, mode, grid=16):
    from lightgbm_tpu_torch.ops.histogram import (_histogram_slots_ragged_fixed,
                                                  _histogram_slots_ragged_plain,
                                                  fixed_point_exponents)

    name, n, G, B, ranges = case
    K = len(ranges)
    bins, gh, slot = _setup(7 * n + G, n, G, B, ranges, mode)
    if mode == "snapped":
        gh = (np.round(gh.astype(np.float64) * grid) / grid).astype(np.float32)
    t = torch.from_numpy
    args = [t(slot), t(np.asarray([s for s, _ in ranges], np.int32)),
            t(np.asarray([e for _, e in ranges], np.int32)), torch.ones(K, dtype=torch.bool)]
    exps = fixed_point_exponents(t(gh), n)
    fixed = _histogram_slots_ragged_fixed(t(bins), t(gh), *args, B, K, exps)
    plain = _histogram_slots_ragged_plain(t(bins), t(gh), *args, B, K)
    absplain = _histogram_slots_ragged_plain(t(bins), t(np.abs(gh)), *args, B, K)
    return fixed, plain, absplain


@pytest.mark.parametrize("grid", [16, 1024], ids=["2^-4", "2^-10"])
@pytest.mark.parametrize("case", RAGGED, ids=[c[0] for c in RAGGED])
def test_fixed_point_exact_on_grids(case, grid):
    """On gh snapped to the 2**-4 or 2**-10 grid (every float32 partial sum
    exact), the kernel's fixed-point arithmetic gives the plain version's
    bits."""
    fixed, plain, _ = _fixed_and_plain(case, "snapped", grid)
    assert fixed.dtype == torch.float32
    assert torch.equal(fixed, plain)


@pytest.mark.parametrize("case", RAGGED, ids=[c[0] for c in RAGGED])
def test_fixed_point_within_summation_bound(case):
    """On real gh the fixed-point sum lies within the float32 summation
    bound n * 2**-24 * sum|v| of the plain version, bin by bin."""
    fixed, plain, absplain = _fixed_and_plain(case, "real")
    n = case[1]
    bound = n * 2.0 ** -24 * absplain.double()
    assert ((fixed.double() - plain.double()).abs() <= bound).all()


def test_fixed_point_nonfinite_stays_in_its_bins():
    """A NaN or inf makes only the cells that hold its row NaN or inf, as the
    plain version's float32 sum does (+inf with -inf is NaN); on snapped gh
    the emulation of the kernel equals the plain version cell for cell, and
    every other cell, and every cell of the other range, is as without it."""
    from lightgbm_tpu_torch.ops.histogram import (_histogram_slots_ragged_fixed,
                                                  _histogram_slots_ragged_plain,
                                                  fixed_point_exponents)
    from tests.test_torch_cuda_train import nonfinite_case, same_or_both_nan

    n, G, B, ranges = 600, 3, 8, [(0, 250), (300, 580)]
    bins, gh, args = nonfinite_case(11, n, G, B, ranges, snapped=True)
    t = torch.from_numpy
    exps = fixed_point_exponents(t(gh), n)
    fixed = _histogram_slots_ragged_fixed(t(bins), t(gh), *args, B, 2, exps)
    plain = _histogram_slots_ragged_plain(t(bins), t(gh), *args, B, 2)
    assert same_or_both_nan(fixed, plain)
    assert bool(fixed.isnan().any()) and bool(fixed.isposinf().any()) \
        and bool(fixed.isneginf().any())
    assert bool(fixed[0, bins[0, 5], 2].isnan())  # +inf and -inf in one cell
    clean = np.where(np.isfinite(gh), gh, 0).astype(np.float32)
    ref = _histogram_slots_ragged_fixed(t(bins), t(clean), *args, B, 2, exps)
    kept = torch.isfinite(fixed)
    assert torch.equal(fixed[kept], ref[kept])
    assert bool(kept[:, :, 3:].all())  # range 1 holds no bad row


def test_ragged_wrapper_checks():
    """What the kernel does not take is refused before any launch."""
    n, K = 64, 2
    bins = torch.zeros((3, n), dtype=torch.uint8)
    gh = torch.zeros((n, 5))[:, :3]
    slot = torch.zeros(n, dtype=torch.int32)
    se = [torch.zeros(K, dtype=torch.int32), torch.full((K,), n, dtype=torch.int32),
          torch.ones(K, dtype=torch.bool)]
    hist_cuda._check_ragged(bins, gh, slot, *se, 16, K, None)  # a payload view is taken
    bad = [
        ("uint8", dict(bins=bins.to(torch.int32))),
        ("num_bins", dict(num_bins=0)),
        ("unit column stride", dict(gh=torch.zeros((3, n)).t())),
        ("float32", dict(gh=gh.double())),
        ("n_slots", dict(n_slots=hist_cuda.MAX_RANGES + 1)),
        ("slot", dict(slot=slot.long())),
        ("starts", dict(starts=se[0][:1])),
        ("valid", dict(valid=se[2].int())),
        ("exponents", dict(exponents=torch.zeros(2, dtype=torch.int32))),
    ]
    for match, kw in bad:
        call = dict(bins=bins, gh=gh, slot=slot, starts=se[0], ends=se[1], valid=se[2],
                    num_bins=16, n_slots=K, exponents=None)
        call.update(kw)
        with pytest.raises(ValueError, match=match):
            hist_cuda._check_ragged(**call)
    with pytest.raises(ValueError, match="cpu or cuda"):
        hist_cuda.histogram_ragged(bins.to("meta"), gh.to("meta"), slot.to("meta"),
                                   *[a.to("meta") for a in se], 16, K)


@pytest.mark.parametrize("quantized", [False, True], ids=["fixed", "int32"])
@pytest.mark.parametrize("ch", [1, 2, 3, 4])
def test_ragged_launch_fits_shared_memory(ch, quantized):
    for G, B in ((28, 255), (1, 256), (200, 64)):
        gb, blocks = hist_cuda.ragged_launch_shape(G, B, ch, quantized, 132)
        bin_bytes = 4 * ((ch * (1 if quantized else 2)) | 1)
        assert 1 <= gb <= G and blocks >= 1
        per_block = hist_cuda.RAGGED_PLAN_BYTES + gb * B * bin_bytes
        assert hist_cuda.BLOCKS_PER_SM * (per_block + hist_cuda.SMEM_RESERVED) \
            <= hist_cuda.SMEM_PER_SM
        assert blocks * -(-G // gb) <= 132 * hist_cuda.BLOCKS_PER_SM
    gb, blocks = hist_cuda.ragged_launch_shape(28, 255, 3, False, 132)
    assert (gb, blocks) == (14, 132)  # the HIGGS groups in two halves, two blocks an SM
