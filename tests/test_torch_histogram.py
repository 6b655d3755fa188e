"""The port's leaf histogram (its plain version, and the plain emulation of
the CUDA kernel's fixed-point sum, which the kernel is held against bit for
bit on the card) against the JAX package's XLA histogram and its Pallas
kernel run in interpret mode, and the kernel's launch arithmetic.

Contract: exact on grid-snapped gradients (multiples of 2**-4 small enough
that every partial sum is exact in float32, so no summation order can
change a bit), and exact in the integer (quantized) mode; otherwise the
emulation lies within the float32 summation bound of the plain version.
"""
import numpy as np
import pytest
import torch

from lightgbm_tpu_torch.ops import hist_cuda
from lightgbm_tpu_torch.ops.histogram import (build_histogram, build_histogram_rows,
                                              subtract_histogram)
from tests.test_torch_ref import jax_ref  # noqa: F401


def _inputs(seed, G, N, B, P):
    """bins [G, N] uint8 < B, snapped gh_ext [N+1, 3] with its zero
    sentinel row, int8 gh_ext, and a leaf's padded row set of P positions."""
    rng = np.random.RandomState(seed)
    bins = rng.randint(0, B, size=(G, N)).astype(np.uint8)
    bins[:, rng.rand(N) < 0.3] = 0  # a dominant bin, as a default bin is
    g = np.round(rng.normal(size=N) * 16) / 16
    h = np.round(rng.uniform(0.0, 0.5, size=N) * 16) / 16
    gh = np.stack([g, h, np.ones(N)], axis=1).astype(np.float32)
    gh_ext = np.concatenate([gh, np.zeros((1, 3), np.float32)])
    q = rng.randint(-127, 128, size=(N, 3)).astype(np.int8)
    q_ext = np.concatenate([q, np.zeros((1, 3), np.int8)])
    n_rows = min(N, P * 3 // 4)
    rows = np.sort(rng.choice(N, n_rows, replace=False)).astype(np.int32)
    idx = np.full(P, N, dtype=np.int32)
    idx[:n_rows] = rows
    return bins, gh_ext, q_ext, idx


SHAPES = [(3, 1000, 16, 256), (5, 3000, 255, 1024), (28, 2000, 256, 2048),
          (1, 700, 2, 256)]


@pytest.mark.parametrize("shape", SHAPES, ids=[str(s) for s in SHAPES])
def test_rows_match_xla_and_pallas(jax_ref, shape):
    import jax.numpy as jnp
    from lightgbm_tpu.ops.hist_pallas import pallas_histogram
    from lightgbm_tpu.ops.histogram import _build_histogram_rows_xla

    G, N, B, P = shape
    bins, gh_ext, _, idx = _inputs(sum(shape), G, N, B, P)
    port = build_histogram_rows(torch.from_numpy(bins), torch.from_numpy(gh_ext),
                                torch.from_numpy(idx), B).numpy()
    xla = np.asarray(_build_histogram_rows_xla(
        jnp.asarray(bins), jnp.asarray(gh_ext), jnp.asarray(idx), B))
    np.testing.assert_array_equal(port, xla)
    # the TPU kernel sees the gathered leaf rows (histogram.py:152-153)
    bins_leaf = bins[:, np.minimum(idx, N - 1)]
    pallas = np.asarray(pallas_histogram(jnp.asarray(bins_leaf),
                                         jnp.asarray(gh_ext[idx]), B,
                                         f32=True, interpret=True))
    np.testing.assert_array_equal(port, pallas)


@pytest.mark.parametrize("shape", SHAPES[:3], ids=[str(s) for s in SHAPES[:3]])
def test_integer_mode_matches_pallas_quantized(jax_ref, shape):
    import jax.numpy as jnp
    from lightgbm_tpu.ops.hist_pallas import pallas_histogram

    G, N, B, P = shape
    bins, _, q_ext, idx = _inputs(sum(shape) + 1, G, N, B, P)
    port = build_histogram_rows(torch.from_numpy(bins), torch.from_numpy(q_ext),
                                torch.from_numpy(idx), B)
    assert port.dtype == torch.int32
    bins_leaf = bins[:, np.minimum(idx, N - 1)]
    pallas = np.asarray(pallas_histogram(jnp.asarray(bins_leaf),
                                         jnp.asarray(q_ext[idx]), B,
                                         quantized=True, interpret=True))
    np.testing.assert_array_equal(port.numpy(), pallas)


def test_full_data_matches_xla(jax_ref):
    import jax.numpy as jnp
    from lightgbm_tpu.ops.histogram import _build_histogram_xla

    bins, gh_ext, _, _ = _inputs(9, 6, 5000, 64, 256)
    port = build_histogram(torch.from_numpy(bins), torch.from_numpy(gh_ext[:-1]), 64)
    xla = _build_histogram_xla(jnp.asarray(bins), jnp.asarray(gh_ext[:-1]), 64)
    np.testing.assert_array_equal(port.numpy(), np.asarray(xla))
    # the identity row set gives the full-data histogram
    idx = torch.arange(5000, dtype=torch.int32)
    rows = build_histogram_rows(torch.from_numpy(bins), torch.from_numpy(gh_ext),
                                idx, 64)
    assert torch.equal(rows, port)


def test_all_sentinel_rows_and_subtraction():
    bins, gh_ext, _, _ = _inputs(11, 4, 500, 32, 256)
    empty = build_histogram_rows(torch.from_numpy(bins), torch.from_numpy(gh_ext),
                                 torch.full((256,), 500, dtype=torch.int32), 32)
    assert empty.shape == (4, 32, 3) and not empty.any()
    idx = np.arange(500, dtype=np.int32)
    left, right = idx[:200], idx[200:]
    pad = lambda r, p: np.concatenate([r, np.full(p - len(r), 500, np.int32)])  # noqa: E731
    full = build_histogram_rows(torch.from_numpy(bins), torch.from_numpy(gh_ext),
                                torch.from_numpy(pad(idx, 512)), 32)
    lh = build_histogram_rows(torch.from_numpy(bins), torch.from_numpy(gh_ext),
                              torch.from_numpy(pad(left, 256)), 32)
    rh = build_histogram_rows(torch.from_numpy(bins), torch.from_numpy(gh_ext),
                              torch.from_numpy(pad(right, 512)), 32)
    assert torch.equal(subtract_histogram(full, lh), rh)  # snapped: exact


# (count, G, B, CH, quantized): the HIGGS root, a ~100,000-row leaf, a
# small plane, a narrow one, a ~4,000-row leaf, one row, the integer mode,
# four channels
LAUNCHES = [(1_048_576, 28, 256, 3, False), (100_000, 28, 256, 3, False),
            (256, 3, 16, 3, False), (5000, 1, 2, 3, False), (4_000, 28, 255, 3, False),
            (1, 28, 255, 3, False), (300_000, 28, 256, 3, True), (70_000, 200, 64, 4, False)]


@pytest.mark.parametrize("count,groups,bins,ch,quantized", LAUNCHES,
                         ids=[f"{c[0]}-{c[1]}-{c[2]}" + ("-int8" if c[4] else "")
                              + ("" if c[3] == 3 else f"-ch{c[3]}") for c in LAUNCHES])
def test_kernel_launch_shape(count, groups, bins, ch, quantized):
    """The leaf histogram's grid arithmetic (computed in Python, checked
    here): each block's histogram within the opt-in shared memory and two
    blocks an SM, no more blocks than the card holds at once, the blocks
    growing with the rows, and the row chunks covering every position once."""
    sms = 132
    gb, blocks = hist_cuda.rows_launch_shape(count, groups, bins, ch, quantized, sms)
    smem = hist_cuda.rows_smem_bytes(gb, bins, ch, quantized)
    assert 1 <= gb <= groups and blocks >= 1
    assert smem <= hist_cuda.SMEM_OPT_IN
    assert hist_cuda.BLOCKS_PER_SM * (smem + hist_cuda.SMEM_RESERVED) <= hist_cuda.SMEM_PER_SM
    n_gblocks = -(-groups // gb)
    assert blocks * n_gblocks <= max(sms * hist_cuda.BLOCKS_PER_SM, n_gblocks)
    # more rows: no fewer row chunks, and no narrower group blocks
    gb2, blocks2 = hist_cuda.rows_launch_shape(2 * count, groups, bins, ch, quantized, sms)
    assert blocks2 >= blocks and gb2 >= gb
    # the blocks' shares (hist_rows_kernel: [count * b / blocks,
    # count * (b + 1) / blocks)) tile [0, count) in order
    edges = [(count * b // blocks, count * (b + 1) // blocks) for b in range(blocks)]
    assert edges[0][0] == 0 and edges[-1][1] == count
    assert all(a[1] == b[0] for a, b in zip(edges, edges[1:]))
    assert all(z - a <= -(-count // blocks) for a, z in edges)


def test_kernel_launch_shape_follows_the_leaf():
    """A small leaf takes few row chunks and one-group blocks; the root
    fills the card with two group blocks of 14 HIGGS groups."""
    assert hist_cuda.rows_launch_shape(4_000, 28, 255, 3, False, 132) == (1, 1)
    gb, blocks = hist_cuda.rows_launch_shape(1_048_576, 28, 255, 3, False, 132)
    assert (gb, blocks) == (14, 132)
    gb, blocks = hist_cuda.rows_launch_shape(100_000, 28, 255, 3, False, 132)
    assert blocks == 25 and blocks * -(-28 // gb) <= 264


def _leaf_cases(seed, G, N, B):
    """Row sets a serial learner histograms, as (name, idx [P] or None,
    count or None): the root, a sorted random leaf, the same read only to
    its count, one row, all sentinels."""
    rng = np.random.RandomState(seed)
    leaf = np.sort(rng.choice(N, N // 3, replace=False)).astype(np.int32)
    P = 1 << int(np.ceil(np.log2(len(leaf))))
    pad = lambda r, p: np.concatenate([r, np.full(p - len(r), N, np.int32)])  # noqa: E731
    return [("root", None, None), ("leaf", pad(leaf, P), None),
            ("leaf_count", pad(leaf, P), len(leaf)),
            ("one_row", pad(leaf[7:8], 256), 1), ("all_sentinel", pad(leaf[:0], 256), None)]


FIXED_CASES = [(name, mode) for name in ("root", "leaf", "leaf_count", "one_row",
                                         "all_sentinel")
               for mode in ("snapped", "int8", "real")]


@pytest.mark.parametrize("case,mode", FIXED_CASES, ids=[f"{c}-{m}" for c, m in FIXED_CASES])
def test_fixed_point_emulation_matches_plain(case, mode):
    """`_build_histogram_rows_fixed` (the card's bits) against the plain
    version: exactly equal on snapped gradients and in the integer mode,
    within the float32 summation bound count * 2**-24 * sum|v| otherwise."""
    from lightgbm_tpu_torch.ops.histogram import (_build_histogram_plain,
                                                  _build_histogram_rows_fixed,
                                                  _build_histogram_rows_plain,
                                                  fixed_point_exponents)

    G, N, B = 5, 3000, 255
    bins, gh_ext, q_ext, _ = _inputs(41, G, N, B, 256)
    if mode == "real":
        rng = np.random.RandomState(3)
        gh_ext[:N, :2] = np.stack([rng.normal(size=N), rng.uniform(0, 0.5, N)], 1)
    values = torch.from_numpy(q_ext if mode == "int8" else gh_ext)
    b = torch.from_numpy(bins)
    exps = fixed_point_exponents(values, N) if mode != "int8" else None
    _, idx, count = next(c for c in _leaf_cases(5, G, N, B) if c[0] == case)
    if idx is None:
        got = _build_histogram_rows_fixed(b, values[:N], None, B, exps)
        ref = _build_histogram_plain(b, values[:N], B)
        ref_abs = _build_histogram_plain(b, values[:N].abs(), B)
        rows = N
    else:
        i = torch.from_numpy(idx)
        got = _build_histogram_rows_fixed(b, values, i, B, exps, count)
        ref = _build_histogram_rows_plain(b, values, i, B)
        ref_abs = _build_histogram_rows_plain(b, values.abs(), i, B)
        assert torch.equal(_build_histogram_rows_plain(b, values, i, B, count), ref)
        rows = int((idx < N).sum())
    assert got.dtype == ref.dtype and got.shape == (G, B, 3)
    if mode == "real":
        bound = rows * 2.0 ** -24 * ref_abs.double()
        assert bool(((got.double() - ref.double()).abs() <= bound).all())
    else:
        assert torch.equal(got, ref)


def test_fixed_point_emulation_keeps_nonfinite_in_its_cell():
    """A row with NaN, +inf and -inf gh makes only its own cells NaN or
    inf, as the plain float32 sum does; every other cell is as without it."""
    from lightgbm_tpu_torch.ops.histogram import (_build_histogram_rows_fixed,
                                                  _build_histogram_rows_plain,
                                                  fixed_point_exponents)

    G, N, B = 3, 2000, 16
    bins, gh_ext, _, idx = _inputs(43, G, N, B, 2048)
    b, i = torch.from_numpy(bins), torch.from_numpy(idx)
    clean = torch.from_numpy(gh_ext)
    dirty = clean.clone()
    r = int(idx[10])
    dirty[r] = torch.tensor([float("nan"), float("inf"), float("-inf")])
    exps = fixed_point_exponents(clean, N)
    got = _build_histogram_rows_fixed(b, dirty, i, B, exps)
    ref = _build_histogram_rows_plain(b, dirty, i, B)
    cells = torch.zeros((G, B, 3), dtype=torch.bool)
    cells[torch.arange(G), torch.from_numpy(bins[:, r]).long()] = True
    assert torch.equal(torch.isnan(got), torch.isnan(ref))
    assert torch.equal(torch.isinf(got), torch.isinf(ref)) and bool(torch.isinf(got).any())
    assert bool((~torch.isfinite(got) == cells).all())
    base = _build_histogram_rows_fixed(b, clean, i, B, exps)
    assert torch.equal(got[~cells], base[~cells])  # snapped: exact, as the plain sum


@pytest.mark.parametrize("shape", SHAPES, ids=[str(s) for s in SHAPES])
def test_fixed_point_emulation_matches_xla_and_pallas(jax_ref, shape):
    """The card's arithmetic against the JAX package's leaf histogram (XLA,
    and the Pallas kernel in interpret mode on the gathered rows) on snapped
    gradients: exactly equal."""
    import jax.numpy as jnp
    from lightgbm_tpu.ops.hist_pallas import pallas_histogram
    from lightgbm_tpu.ops.histogram import _build_histogram_rows_xla
    from lightgbm_tpu_torch.ops.histogram import (_build_histogram_rows_fixed,
                                                  fixed_point_exponents)

    G, N, B, P = shape
    bins, gh_ext, _, idx = _inputs(sum(shape) + 2, G, N, B, P)
    ext = torch.from_numpy(gh_ext)
    count = int((idx < N).sum())
    port = _build_histogram_rows_fixed(torch.from_numpy(bins), ext, torch.from_numpy(idx),
                                       B, fixed_point_exponents(ext, N), count).numpy()
    xla = np.asarray(_build_histogram_rows_xla(
        jnp.asarray(bins), jnp.asarray(gh_ext), jnp.asarray(idx), B))
    np.testing.assert_array_equal(port, xla)
    bins_leaf = bins[:, np.minimum(idx, N - 1)]
    pallas = np.asarray(pallas_histogram(jnp.asarray(bins_leaf), jnp.asarray(gh_ext[idx]), B,
                                         f32=True, interpret=True))
    np.testing.assert_array_equal(port, pallas)


def test_wrapper_takes_plain_version_for_cpu_only():
    bins, gh_ext, _, idx = _inputs(12, 2, 300, 8, 256)
    with pytest.raises(ValueError, match="float32 or int8"):
        build_histogram_rows(torch.from_numpy(bins),
                             torch.from_numpy(gh_ext).double(),
                             torch.from_numpy(idx), 8)
    with pytest.raises(ValueError, match="cpu or cuda"):
        hist_cuda.histogram(torch.from_numpy(bins).to("meta"),
                            torch.from_numpy(gh_ext).to("meta"), None, 8)
