"""The port's split search (its plain version, which the CUDA scan kernel is
held against on the card) against the JAX package's.

Contract, on grid-snapped gradients: the per-feature records equal the JAX
package's `per_feature_best` run op by op, field for field and bit for bit,
with and without a feature mask and a penalty. Against the Pallas scan
kernel (interpret mode, through `per_feature_best_fused`) every field is
equal but the gain, which may differ by a few ULP: the kernel's own
contract with the XLA body (scan_pallas.py:30-39).
"""
import numpy as np
import pytest
import torch

from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.io.dataset import Dataset
from lightgbm_tpu_torch.ops import split as ts
from lightgbm_tpu_torch.ops.histogram import build_histogram_rows
from tests.test_torch_ref import jax_ref  # noqa: F401

PARAMS = [0.0, 0.0, 20.0, 1e-3, 0.0, 0.0]


def _dataset(kind):
    rng = np.random.RandomState({"dense": 0, "zero": 1, "bundled": 2}[kind])
    n = 3000
    if kind == "bundled":  # mostly-zero columns: EFB bundles them
        X = np.where(rng.rand(n, 12) < 0.04, rng.normal(size=(n, 12)), 0.0)
        params = {"min_data_in_leaf": 5}
    else:
        X = rng.normal(size=(n, 7))
        X[rng.rand(n, 7) < 0.08] = np.nan
        X[rng.rand(n, 7) < 0.1] = 0.0
        params = {"zero_as_missing": True} if kind == "zero" else {}
    return X, params


def _leaf(kind, seed):
    """A dataset's FeatureMeta and one leaf's (histogram, totals) on
    snapped gradients."""
    X, params = _dataset(kind)
    ds = Dataset.from_matrix(X, label=np.zeros(len(X)), config=Config(params))
    B = int(max(ds.group_bin_counts().max(), 2))
    rng = np.random.RandomState(seed)
    n = ds.num_data
    g = np.round(rng.normal(size=n) * 16) / 16
    h = np.round(rng.uniform(0.05, 0.5, size=n) * 16) / 16
    gh = np.concatenate([np.stack([g, h, np.ones(n)], 1), np.zeros((1, 3))]).astype(np.float32)
    rows = np.sort(rng.choice(n, 1700, replace=False)).astype(np.int32)
    idx = np.full(2048, n, np.int32)
    idx[:1700] = rows
    hist = build_histogram_rows(torch.from_numpy(ds.bins), torch.from_numpy(gh),
                                torch.from_numpy(idx), B)
    return ds, B, hist, hist[0].sum(dim=0)


def _jax_meta(jax_ref, X, params, B):
    from lightgbm_tpu.config import Config as JaxConfig
    from lightgbm_tpu.io.dataset import Dataset as JaxDataset
    from lightgbm_tpu.ops.split import make_feature_meta

    jds = JaxDataset.from_matrix(X, label=np.zeros(len(X)), config=JaxConfig(params))
    return make_feature_meta(jds, B)


def _jax_params():
    import jax.numpy as jnp

    return jnp.asarray(PARAMS + [4.0, 32.0, 10.0, 10.0, 100.0], jnp.float32)


@pytest.mark.parametrize("kind", ["dense", "zero", "bundled"])
@pytest.mark.parametrize("masked", [False, True])
def test_records_match_jax(jax_ref, kind, masked):
    import jax
    import jax.numpy as jnp
    from lightgbm_tpu.ops import split as js
    from lightgbm_tpu.ops.scan_pallas import per_feature_best_fused

    ds, B, hist, tot = _leaf(kind, 3 + masked)
    X, params = _dataset(kind)
    jmeta = _jax_meta(jax_ref, X, params, B)
    meta = ts.make_feature_meta(ds, B, "cpu")
    F = len(meta.real_feature)
    rng = np.random.RandomState(5)
    mask = (rng.rand(F) < 0.7) if masked else None
    penalty = (np.round(rng.uniform(0, 2, size=F) * 4) / 4).astype(np.float32) \
        if masked else None
    fh = ts.gather_feature_hist(hist, meta, tot)
    rec = ts.per_feature_best(fh, tot, meta, torch.tensor(PARAMS),
                              None if mask is None else torch.from_numpy(mask),
                              None if penalty is None else torch.from_numpy(penalty)
                              ).numpy()
    jhist, jtot = jnp.asarray(hist.numpy()), jnp.asarray(tot.numpy())
    jmask = None if mask is None else jnp.asarray(mask)
    jpen = None if penalty is None else jnp.asarray(penalty)
    with jax.disable_jit():  # op by op, as PyTorch runs
        jfh = js.gather_feature_hist(jhist, jmeta, jtot)
        ref = np.asarray(js.per_feature_best(jfh, jtot, jmeta, _jax_params(),
                                             jmask, None, jpen))
    np.testing.assert_array_equal(fh.numpy(), np.asarray(jfh))
    np.testing.assert_array_equal(rec, ref)
    assert (rec[:, 1] >= 0).any()  # some feature has a valid split
    fused = np.asarray(per_feature_best_fused(jfh, jtot, jmeta, _jax_params(),
                                              jmask, jpen, interpret=True))
    np.testing.assert_array_equal(rec[:, 1:], fused[:, 1:])
    # the gain: within 4 ULP of the un-shifted gain, whose rounding the
    # subtraction of the parent's gain carries into the record
    shift = ts.leaf_gain(tot[0], tot[1], *torch.tensor(PARAMS)[[0, 1, 5]]).numpy()
    ulp = np.spacing(np.abs(rec[:, 0] + shift).astype(np.float32))
    finite = np.isfinite(rec[:, 0])
    assert (np.isfinite(fused[:, 0]) == finite).all()
    assert (np.abs(rec[finite, 0] - fused[finite, 0]) <= 4 * ulp[finite]).all()


@pytest.mark.parametrize("kind", ["dense", "bundled"])
def test_find_best_split_matches_jax(jax_ref, kind):
    import jax
    import jax.numpy as jnp
    from lightgbm_tpu.ops import split as js

    ds, B, hist, tot = _leaf(kind, 8)
    X, params = _dataset(kind)
    jmeta = _jax_meta(jax_ref, X, params, B)
    meta = ts.make_feature_meta(ds, B, "cpu")
    rec = ts.find_best_split(hist, tot, meta, torch.tensor(PARAMS)).numpy()
    with jax.disable_jit():
        ref = np.asarray(js.find_best_split(jnp.asarray(hist.numpy()),
                                            jnp.asarray(tot.numpy()), jmeta,
                                            _jax_params()))
    np.testing.assert_array_equal(rec, ref)
    info = ts.SplitInfo.from_packed(rec)
    assert info.valid and info.left_count + info.right_count == 1700


def test_regularized_gain_arithmetic_matches_jax(jax_ref):
    """threshold_l1 / leaf_output / leaf_gain, element for element, with L1,
    L2 and max_delta_step."""
    import jax
    import jax.numpy as jnp
    from lightgbm_tpu.ops import split as js

    rng = np.random.RandomState(4)
    g = (rng.normal(size=5000) * 40).astype(np.float32)
    h = (rng.exponential(size=5000) * 20).astype(np.float32)
    for l1, l2, md in [(0.0, 0.0, 0.0), (0.5, 1.0, 0.0), (0.0, 2.0, 0.7)]:
        args_t = [torch.tensor(v, dtype=torch.float32) for v in (l1, l2, md)]
        args_j = [jnp.float32(v) for v in (l1, l2, md)]
        with jax.disable_jit():
            ref_out = np.asarray(js.leaf_output(g, h, *args_j))
            ref_gain = np.asarray(js.leaf_gain(g, h, *args_j))
        out = ts.leaf_output(torch.from_numpy(g), torch.from_numpy(h), *args_t)
        gain = ts.leaf_gain(torch.from_numpy(g), torch.from_numpy(h), *args_t)
        np.testing.assert_array_equal(out.numpy(), ref_out)
        np.testing.assert_array_equal(gain.numpy(), ref_gain)


def test_all_features_masked_gives_no_split():
    ds, B, hist, tot = _leaf("dense", 9)
    meta = ts.make_feature_meta(ds, B, "cpu")
    F = len(meta.real_feature)
    rec = ts.per_feature_best(ts.gather_feature_hist(hist, meta, tot), tot, meta,
                              torch.tensor(PARAMS), torch.zeros(F, dtype=torch.bool))
    assert (rec[:, 1] == -1).all() and torch.isinf(rec[:, 0]).all()
    assert not ts.SplitInfo.from_packed(ts.reduce_best_record(rec).numpy()).valid


# --- the fused search: group histogram -> each leaf's record, in the split
# kernel's summation order (ops/split.py:bin_sum, bin_prefix)

def _kernel_order_scalar(col):
    """The split kernel's two sums over one channel of a feature's bins,
    simulated lane by lane in Python floats (IEEE float64): (sum, prefix)."""
    B = len(col)
    P = max(1, -(-B // 32))
    x = [float(v) for v in col] + [0.0] * (32 * P - B)
    lane = [0.0] * 32
    for j in range(32):
        for i in range(P):
            lane[j] = lane[j] + x[j * P + i]
    d = 1
    while d < 32:
        lane = [lane[j] if j < d else lane[j - d] + lane[j] for j in range(32)]
        d *= 2
    prefix = []
    for j in range(32):
        acc = 0.0 if j == 0 else lane[j - 1]
        for i in range(P):
            acc = acc + x[j * P + i]
            prefix.append(np.float32(acc))
    return lane[31], np.asarray(prefix[:B], np.float32)


@pytest.mark.parametrize("B", [1, 5, 32, 33, 255, 256, 1000])
def test_bin_order_emulates_the_kernel(B):
    """bin_sum / bin_prefix are the kernel's order, checked against a
    scalar simulation of its lanes; on a 2**-4 grid they equal the
    sequential sums."""
    rng = np.random.RandomState(B)
    # values over many magnitudes, so the order shows in the low bits
    x = (rng.normal(size=(2, B, 3)) * 10.0 ** rng.randint(-6, 6, size=(2, B, 3)))
    x = torch.from_numpy(x.astype(np.float32))
    x[0, 0, 0] = -0.0
    total, prefix = ts.bin_sum(x), ts.bin_prefix(x)
    assert total.dtype == torch.float64 and prefix.dtype == torch.float32
    for a in range(2):
        for c in range(3):
            s, p = _kernel_order_scalar(x[a, :, c].numpy())
            assert total[a, c].item() == s
            np.testing.assert_array_equal(prefix[a, :, c].numpy().view(np.uint32),
                                          p.view(np.uint32))
    snapped = torch.round(x.clamp(-4, 4) * 16) / 16
    np.testing.assert_array_equal(
        ts.bin_prefix(snapped).numpy(),
        torch.cumsum(snapped.double(), dim=-2).float().numpy())
    np.testing.assert_array_equal(ts.bin_sum(snapped).numpy(),
                                  snapped.double().sum(dim=-2).numpy())


def _efb_dataset():
    """Sparse columns that EFB bundles into shared groups."""
    rng = np.random.RandomState(0)
    n = 3000
    X = np.where(rng.rand(n, 12) < 0.02, rng.normal(size=(n, 12)), 0.0)
    return X, {"min_data_in_leaf": 5}


def _fused_leaves(kind, seed, snapped, leaves):
    """A dataset, its FeatureMeta on the CPU, and `leaves` leaves' group
    histograms and totals (a leaf, then parts of it and their rests)."""
    X, params = _efb_dataset() if kind == "efb" else _dataset(kind)
    ds = Dataset.from_matrix(X, label=np.zeros(len(X)), config=Config(params))
    if kind == "efb":
        assert any(g.is_multi for g in ds.groups)
    B = int(max(ds.group_bin_counts().max(), 2))
    rng = np.random.RandomState(seed)
    n = ds.num_data
    g = rng.normal(size=n)
    h = rng.uniform(0.05, 0.5, size=n)
    if snapped:
        g, h = np.round(g * 16) / 16, np.round(h * 16) / 16
    gh = np.concatenate([np.stack([g, h, np.ones(n)], 1), np.zeros((1, 3))]).astype(np.float32)
    hists = []
    for k in range(leaves):
        m = 1700 if k == 0 else 400 + 300 * k
        idx = np.full(2048, n, np.int32)
        idx[:m] = np.sort(rng.choice(n, m, replace=False))
        hists.append(build_histogram_rows(torch.from_numpy(ds.bins), torch.from_numpy(gh),
                                          torch.from_numpy(idx), B))
    hist = hists[0] if leaves == 1 else torch.stack(hists)
    tot = hist[..., 0, :, :].sum(dim=-2)
    return X, params, ds, B, hist, tot


@pytest.mark.parametrize("kind", ["dense", "zero", "efb"])
@pytest.mark.parametrize("leaves", [1, 5])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("snapped", [True, False], ids=["snapped", "real"])
def test_fused_find_best_split_matches_jax(jax_ref, kind, leaves, masked, snapped):
    """The fused search's plain version against the JAX find_best_split run
    op by op, leaf by leaf. Snapped: every field bit-equal. Unsnapped, where
    the JAX package's float32 cumsum and this float64 sum in the kernel's
    order round apart: the same split (feature, threshold, direction), the
    sums within the float32 summation bound over the feature's bins, the
    gain within 1e-4 of its size."""
    import jax
    import jax.numpy as jnp
    from lightgbm_tpu.ops import split as js

    X, params, ds, B, hist, tot = _fused_leaves(kind, 20 + leaves, snapped, leaves)
    jmeta = _jax_meta(jax_ref, X, params, B)
    meta = ts.make_feature_meta(ds, B, "cpu")
    F = len(meta.real_feature)
    rng = np.random.RandomState(6)
    mask = (rng.rand(F) < 0.7) if masked else None
    pen = (np.round(rng.uniform(0, 2, size=F) * 4) / 4).astype(np.float32) if masked else None
    rec = ts.find_best_split(hist, tot, meta, torch.tensor(PARAMS),
                             None if mask is None else torch.from_numpy(mask),
                             None if pen is None else torch.from_numpy(pen)).numpy()
    recs = rec.reshape(-1, len(ts.SPLIT_FIELDS))
    hs, tt = hist.reshape(-1, *hist.shape[-3:]), tot.reshape(-1, 3)
    for k in range(recs.shape[0]):
        with jax.disable_jit():
            ref = np.asarray(js.find_best_split(
                jnp.asarray(hs[k].numpy()), jnp.asarray(tt[k].numpy()), jmeta,
                _jax_params(), None if mask is None else jnp.asarray(mask), None,
                None if pen is None else jnp.asarray(pen)))
        if snapped:
            np.testing.assert_array_equal(recs[k].view(np.uint32), ref.view(np.uint32))
            continue
        np.testing.assert_array_equal(recs[k][1:4], ref[1:4])
        scale = np.abs(hs[k].numpy()).sum(axis=(0, 1)).max()
        bound = B * 2.0 ** -24 * scale
        assert np.all(np.abs(recs[k][4:10] - ref[4:10]) <= bound)
        assert recs[k][0] == ref[0] or abs(recs[k][0] - ref[0]) <= 1e-4 * abs(ref[0])
    assert ts.SplitInfo.from_packed(recs[0]).valid  # the whole leaf has a split


@pytest.mark.parametrize("kind", ["dense", "efb"])
@pytest.mark.parametrize("leaves", [1, 5])
def test_fused_records_equal_per_feature_path(kind, leaves):
    """On snapped data the fused search's records are the per-feature
    path's (gather_feature_hist + per_feature_best) reduced by
    reduce_best_record, bit for bit; host totals by value give the same."""
    _, _, ds, B, hist, tot = _fused_leaves(kind, 40 + leaves, True, leaves)
    meta = ts.make_feature_meta(ds, B, "cpu")
    params = torch.tensor(PARAMS)
    fused = ts.find_best_split(hist, tot, meta, params)
    per = ts.reduce_best_record(ts.per_feature_best(ts.gather_feature_hist(hist, meta, tot),
                                                    tot, meta, params))
    assert torch.equal(fused.view(torch.int32), per.view(torch.int32))
    if leaves == 1:
        by_value = ts.find_best_split(hist, tot.tolist(), meta, params)
        assert torch.equal(by_value.view(torch.int32), fused.view(torch.int32))
