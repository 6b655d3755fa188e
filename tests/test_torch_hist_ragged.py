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
