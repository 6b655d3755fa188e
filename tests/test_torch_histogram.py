"""The port's leaf histogram (its plain version, which the CUDA kernel is
held against on the card) against the JAX package's XLA histogram and its
Pallas kernel run in interpret mode.

Contract: exact on grid-snapped gradients (multiples of 2**-4 small enough
that every partial sum is exact in float32, so no summation order can
change a bit), and exact in the integer (quantized) mode.
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


@pytest.mark.parametrize("n_pos,groups,bins", [(1_048_576, 28, 256), (100_000, 28, 256),
                                               (256, 3, 16), (5000, 1, 2)])
def test_kernel_launch_shape(n_pos, groups, bins):
    """The kernel's grid arithmetic (computed in Python, checked here): the
    per-warp histograms fit the shared-memory budget, and the row chunks
    cover every position in whole warp steps."""
    gb, rows, chunks = hist_cuda.launch_shape(n_pos, groups, bins, 3)
    smem = 4 * (hist_cuda.WARPS * gb * bins * 3 + hist_cuda.WARPS * 32 * 3)
    assert 1 <= gb <= groups and smem <= hist_cuda.SMEM_BUDGET
    assert rows % (hist_cuda.WARPS * 32) == 0
    assert chunks * rows >= n_pos > (chunks - 1) * rows


def test_wrapper_takes_plain_version_for_cpu_only():
    bins, gh_ext, _, idx = _inputs(12, 2, 300, 8, 256)
    with pytest.raises(ValueError, match="float32 or int8"):
        build_histogram_rows(torch.from_numpy(bins),
                             torch.from_numpy(gh_ext).double(),
                             torch.from_numpy(idx), 8)
    with pytest.raises(ValueError, match="cpu or cuda"):
        hist_cuda.histogram(torch.from_numpy(bins).to("meta"),
                            torch.from_numpy(gh_ext).to("meta"), None, 8)
