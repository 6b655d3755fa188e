"""The port's gradient discretizer (ops/quantize.py, the plain version the
CUDA kernel is held against on the card) and the split search's int32 mode
against the JAX package's.

Contracts:

* the key stream: `prng_key`, `split_key` and the per-row uniform draws
  bit-equal to ``jax.random.PRNGKey``, ``split`` and ``uniform`` under the
  partitionable threefry layout (jax 0.9's default, the one the JAX package
  trains with), over three trees of the learners' stream;
* `discretize_gradients` bit-equal to the jitted JAX function: the int8
  outputs and both scales, stochastic and nearest rounding, 2/4/16/64
  bins, random, constant-hessian, all-zero and adversarial gradients (values
  a last bit away from a rounding boundary, where a fused multiply-add and
  two roundings disagree: XLA contracts ``g * inv_g + r``), five keys;
* `find_best_split` on an int32 histogram with a scale: bit-equal to the
  JAX `find_best_split` of ``hist.astype(f32) * scale`` run op by op, on
  the histograms of quantized grid-snapped gradients (every sum exact).
"""
import numpy as np
import pytest
import torch

from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.io.dataset import Dataset
from lightgbm_tpu_torch.ops import quantize as tq
from lightgbm_tpu_torch.ops import split as ts
from lightgbm_tpu_torch.ops.histogram import build_histogram_rows, leaf_sums_fixed
from tests.test_torch_ref import jax_ref  # noqa: F401

f32 = np.float32
SEEDS = (0, 1, 7, 123456, 2**31 - 1)


def _jax_quantize():
    """The JAX package's ops/quantize.py (it imports nothing of the rest)."""
    from lightgbm_tpu.ops import quantize

    return quantize


def test_prng_key_and_split_examples():
    key = tq.prng_key(1)
    assert key.tolist() == [0, 1]
    a, b = tq.split_key(key)
    assert a.tolist() == [507451445, 1853169794]
    assert b.tolist() == [1948878966, 4237131848]


@pytest.mark.parametrize("seed", SEEDS + (-1,))
def test_key_stream_matches_jax(jax_ref, seed):
    import jax
    import jax.numpy as jnp

    assert jax.config.jax_threefry_partitionable
    key = jax.random.PRNGKey(seed)
    host = tq.prng_key(seed)
    np.testing.assert_array_equal(host, np.asarray(key))
    for _ in range(3):  # three trees: the learner's split, then the discretizer's
        key, sub = jax.random.split(key)
        host, host_sub = tq.split_key(host)
        np.testing.assert_array_equal(host, np.asarray(key))
        np.testing.assert_array_equal(host_sub, np.asarray(sub))
        kg, kh = jax.random.split(sub)
        for jk, hk in zip((kg, kh), tq.split_key(host_sub)):
            np.testing.assert_array_equal(hk, np.asarray(jk))
            ref = np.asarray(jax.random.uniform(jk, (4099,), dtype=jnp.float32))
            got = tq.uniform(hk, 4099, "cpu").numpy()
            np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))
            bits = np.asarray(jax.random.bits(jk, (257,)))
            np.testing.assert_array_equal(tq.uniform_bits(hk, 257, "cpu").numpy(), bits)


def _near_boundaries(max_abs, units, rng, n=1600):
    """float32 values a few ULP either side of (k + 0.5) * max_abs / units,
    k = 0 .. units: where g * inv + 0.5 meets an integer, so a fused
    multiply-add and a multiply then an add round differently."""
    scale = f32(max_abs / f32(units))
    out = []
    per = n // (2 * (units + 1))
    for k in range(units + 1):
        v = f32((k + 0.5) * scale)
        for direction in (f32(-1), f32(1e9)):
            w = v
            for _ in range(per):
                w = np.nextafter(w, direction)
                out.append(w)
    x = np.array(out, f32)
    x = x[np.abs(x) <= max_abs]
    rng.shuffle(x)
    return np.concatenate([[max_abs], x]).astype(f32)


def _gradients(case, bins, rng):
    n = 6000
    g = (rng.normal(size=n) * 0.37).astype(f32)
    h = rng.uniform(0.01, 0.25, size=n).astype(f32)
    if case == "adversarial":
        g = _near_boundaries(f32(0.7312345), bins // 2, rng)
        g = np.where(rng.rand(len(g)) < 0.5, g, -g).astype(f32)
        h = _near_boundaries(f32(0.2312345), bins, rng)
        n = min(len(g), len(h))
        g, h = g[:n], h[:n]
    elif case == "const_hess":
        h = np.full(n, 0.25, f32)
    elif case == "zero":
        g = np.zeros(n, f32)
        h = np.zeros(n, f32)
    return g, h


def _two_roundings(x, inv, r):
    """x * inv + r rounded twice (a multiply, then an add), float32."""
    return np.trunc(f32(x * inv) + r)


@pytest.mark.parametrize("case", ["random", "adversarial", "const_hess", "zero"])
@pytest.mark.parametrize("stochastic", [True, False], ids=["stochastic", "nearest"])
@pytest.mark.parametrize("bins", [2, 4, 16, 64])
def test_discretize_matches_jax(jax_ref, bins, stochastic, case):
    import jax.numpy as jnp

    jq = _jax_quantize()
    rng = np.random.RandomState(bins * 10 + stochastic)
    g, h = _gradients(case, bins, rng)
    for seed in SEEDS:
        key = tq.prng_key(seed)
        ref = jq.discretize_gradients(jnp.asarray(g), jnp.asarray(h), jnp.asarray(key),
                                      bins, stochastic)
        got = tq.discretize_gradients(torch.from_numpy(g), torch.from_numpy(h), key, bins,
                                      stochastic)
        for name, a, b in zip(("g_int", "h_int", "g_scale", "h_scale"), ref, got):
            a, b = np.asarray(a), b.numpy()
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a.view(np.uint8 if a.dtype == np.int8 else np.uint32),
                                          b.view(np.uint8 if b.dtype == np.int8 else np.uint32),
                                          err_msg=f"{name}, key {seed}")
    if case == "const_hess":
        assert (got[1].numpy() == 1).all() and float(got[3]) == f32(0.25)
    if case == "adversarial" and not stochastic:
        # the set reaches values where one rounding and two disagree
        inv_g = f32(1) / got[2].numpy()
        two = np.where(g >= 0, _two_roundings(g, inv_g, f32(0.5)),
                       np.trunc(f32(g * inv_g) - f32(0.5))).astype(np.int8)
        assert (two != got[0].numpy()).any()


def test_quantize_gh_layout():
    rng = np.random.RandomState(3)
    g = torch.from_numpy(rng.normal(size=500).astype(f32))
    h = torch.from_numpy(rng.uniform(0.1, 0.3, size=500).astype(f32))
    key = tq.prng_key(9)
    gh, scale = tq.quantize_gh(g, h, key, 4, True)
    gi, hi, gs, hs = tq.discretize_gradients(g, h, key, 4, True)
    assert gh.dtype == torch.int8 and gh.shape == (501, 3)
    assert torch.equal(gh[:-1, 0], gi) and torch.equal(gh[:-1, 1], hi)
    assert (gh[:-1, 2] == 1).all() and (gh[-1] == 0).all()
    assert scale.tolist() == [float(gs), float(hs), 1.0]
    assert gi.abs().max() <= 3 and hi.min() >= 0 and hi.max() <= 5


@pytest.mark.parametrize("rows,bins", [(10, 4), (2000, 16), (8000, 4), (1, 2)])
def test_int16_reduction_safe_matches_jax(jax_ref, rows, bins):
    assert tq.int16_reduction_safe(rows, bins) == _jax_quantize().int16_reduction_safe(rows,
                                                                                       bins)


def test_leaf_sums_fixed_are_exact_by_leaf():
    rng = np.random.RandomState(4)
    n, L = 3001, 7
    gh = rng.normal(size=(n, 3)).astype(f32)
    leaf = rng.randint(0, L + 2, size=n)  # leaves past L - 1 add nowhere
    got = leaf_sums_fixed(torch.from_numpy(gh), None, torch.from_numpy(leaf), L).numpy()
    ref = np.stack([gh[leaf == i, :2].astype(np.float64).sum(0) for i in range(L)])
    np.testing.assert_allclose(got, ref.astype(f32), rtol=2e-7, atol=1e-9)
    perm = rng.permutation(n)
    again = leaf_sums_fixed(torch.from_numpy(gh[perm]), None, torch.from_numpy(leaf[perm]), L)
    np.testing.assert_array_equal(again.numpy(), got)  # the order changes no bit
    rows = torch.from_numpy(perm[:1000].astype(np.int64))
    part = leaf_sums_fixed(torch.from_numpy(gh), rows, torch.from_numpy(leaf[perm[:1000]]), L)
    ref = np.stack([gh[perm[:1000]][leaf[perm[:1000]] == i, :2].astype(np.float64).sum(0)
                    for i in range(L)])
    np.testing.assert_allclose(part.numpy(), ref.astype(f32), rtol=2e-7, atol=1e-9)


def _quantized_leaf(kind, bins, seed):
    """A dataset, its FeatureMeta and one leaf's int32 histogram of
    quantized grid-snapped gradients, with the scale."""
    rng = np.random.RandomState(seed)
    n = 3000
    if kind == "bundled":
        X = np.where(rng.rand(n, 12) < 0.04, rng.normal(size=(n, 12)), 0.0)
        params = {"min_data_in_leaf": 5}
    else:
        X = rng.normal(size=(n, 7))
        X[rng.rand(n, 7) < 0.08] = np.nan
        params = {}
    ds = Dataset.from_matrix(X, label=np.zeros(n), config=Config(params))
    B = int(max(ds.group_bin_counts().max(), 2))
    g = (np.round(rng.normal(size=n) * 16) / 16).astype(f32)
    h = (np.round(rng.uniform(0.05, 0.5, size=n) * 16) / 16).astype(f32)
    gh, scale = tq.quantize_gh(torch.from_numpy(g), torch.from_numpy(h),
                               tq.prng_key(seed), bins, True)
    rows = np.sort(rng.choice(n, 1700, replace=False)).astype(np.int32)
    idx = np.full(2048, n, np.int32)
    idx[:1700] = rows
    hist = build_histogram_rows(torch.from_numpy(ds.bins), gh, torch.from_numpy(idx), B)
    return X, params, ds, B, hist, scale


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("bins", [4, 16])
@pytest.mark.parametrize("kind", ["dense", "bundled"])
def test_find_best_split_int32_matches_jax(jax_ref, kind, bins, masked):
    import jax
    import jax.numpy as jnp
    from lightgbm_tpu.config import Config as JaxConfig
    from lightgbm_tpu.io.dataset import Dataset as JaxDataset
    from lightgbm_tpu.ops import split as js

    X, params, ds, B, hist, scale = _quantized_leaf(kind, bins, 5 + bins + masked)
    assert hist.dtype == torch.int32
    # the serial learner's root totals: the scaled bins summed
    tot = (hist[0].to(torch.float32) * scale).to(torch.float64).sum(0).to(torch.float32)
    meta = ts.make_feature_meta(ds, B, "cpu")
    F = len(meta.real_feature)
    mask = (np.random.RandomState(6).rand(F) < 0.7) if masked else None
    p = [0.0, 0.0, 20.0, 1e-3, 0.0, 0.0]
    rec = ts.find_best_split(hist, tot, meta, torch.tensor(p),
                             None if mask is None else torch.from_numpy(mask),
                             scale=scale).numpy()
    jds = JaxDataset.from_matrix(X, label=np.zeros(len(X)), config=JaxConfig(params))
    jmeta = js.make_feature_meta(jds, B)
    jparams = jnp.asarray(p + [4.0, 32.0, 10.0, 10.0, 100.0], jnp.float32)
    jhist = jnp.asarray(hist.numpy()).astype(jnp.float32) * jnp.asarray(scale.numpy())
    jtot = jnp.asarray(tot.numpy())
    np.testing.assert_array_equal(np.asarray(jhist[0].sum(axis=0)), tot.numpy())
    with jax.disable_jit():
        ref = np.asarray(js.find_best_split(jhist, jtot, jmeta, jparams,
                                            None if mask is None else jnp.asarray(mask)))
    np.testing.assert_array_equal(rec.view(np.uint32), ref.view(np.uint32))
    assert rec[1] >= 0  # a valid split
    # a batch of leaves: each record the one-leaf call's bits
    both = ts.find_best_split(torch.stack([hist, hist]), torch.stack([tot, tot]), meta,
                              torch.tensor(p), scale=scale).numpy()
    np.testing.assert_array_equal(both[1].view(np.uint32), rec.view(np.uint32))


def test_find_best_split_refuses_mixed_modes():
    _, _, ds, B, hist, scale = _quantized_leaf("dense", 4, 1)
    meta = ts.make_feature_meta(ds, B, "cpu")
    p = torch.tensor([0.0, 0.0, 20.0, 1e-3, 0.0, 0.0])
    tot = torch.zeros(3)
    with pytest.raises(ValueError, match="scale"):
        ts.find_best_split(hist, tot, meta, p)
    with pytest.raises(ValueError, match="scale"):
        ts.find_best_split(hist.to(torch.float32), tot, meta, p, scale=scale)
