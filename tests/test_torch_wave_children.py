"""The wave's children step on images (ops/histogram.py:wave_children; on
the card one launch of the children kernel, csrc/histogram.cu) and the wave
learner on an image pool against the JAX package.

Contracts: the step's plain version gives exactly what the composition it
replaces gave (the pool's rows, `children`, `stack_children`, the
conversion), and that composition is the float arithmetic it stands for
(the JAX grower's): the larger child parent - smaller, the right child
parent - left, each flag the code of the float difference of the cells.
The kernel's subtraction table is the plain version's. On the quantized
int32 pool and the CPU's float32 pool the step is the composition's
children and their stack. On an image pool
(`WaveBuffers(..., image=True)`, forced on the CPU with the plain
versions) the wave learner grows the JAX package's trees on snapped
gradients (split log equal but split_gain, within 4 ULP; leaf ids equal)
and a GBDT through it writes the JAX package's model text.
"""
import functools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from lightgbm_tpu_torch.ops import hist_cuda
from lightgbm_tpu_torch.ops import histogram as H
from lightgbm_tpu_torch.treelearner import device as dmod
from tests.test_torch_device_learner import (F, N, _gain_within_4_ulp, _trees,
                                             _wave_boosters, learners)  # noqa: F401
from tests.test_torch_ref import jax_ref  # noqa: F401
from tests.test_torch_train import snapped_logloss

CODE_VALUE = {0: 0.0, 1: float("inf"), 2: float("-inf"), 3: float("nan")}


def _images(seed, n=3000, G=3, B=8, K=4, L=6, left=(True, False, True, False)):
    """(pool, sel, small, left_small, exponents): the pool's L + 1 rows the
    ragged image of L leaves' ranges (row L, the dump, zero), the smaller
    children's image of K ranges inside the selected leaves, from real
    gradients with NaN, +inf and -inf in a few rows of each leaf, inside its
    smaller child and past it; the last selected leaf the dump row."""
    rng = np.random.RandomState(seed)
    bins = torch.from_numpy(rng.randint(0, B, size=(G, n)).astype(np.uint8))
    gh = torch.from_numpy(np.stack([rng.normal(size=n), rng.uniform(0, 0.5, n),
                                    np.ones(n)], 1).astype(np.float32))
    edges = np.linspace(0, n, L + 1).astype(np.int32)
    for s in edges[:-1]:  # in every leaf's smaller child, and past it
        for r, c, v in ((5, 0, "nan"), (6, 0, "inf"), (7, 1, "-inf"), (8, 2, "inf"),
                        (9, 2, "-inf"), (n // L - 9, 0, "inf"), (n // L - 8, 1, "nan")):
            gh[s + r, c] = float(v)
    exps = H.fixed_point_exponents(gh, n)
    slot = torch.from_numpy(np.repeat(np.arange(L, dtype=np.int32), np.diff(edges)))
    parents = H._histogram_slots_ragged_image_plain(
        bins, gh, slot, torch.from_numpy(edges[:-1]), torch.from_numpy(edges[1:]),
        torch.ones(L, dtype=torch.bool), B, L, exps)
    pool = parents.map(lambda t: torch.cat([t.reshape(G, B, L, 3).permute(2, 0, 1, 3),
                                            t.new_zeros((1, G, B, 3))]).contiguous())
    sel = np.array(list(rng.choice(L, K - 1, replace=False)) + [L], np.int32)
    starts = np.array([edges[s] + 3 for s in sel[:-1]] + [0], np.int32)
    ends = np.array([edges[s] + (edges[s + 1] - edges[s]) // 3 for s in sel[:-1]] + [0],
                    np.int32)
    kslot = torch.full((n,), K, dtype=torch.int32)
    for k, (s, e) in enumerate(zip(starts, ends)):
        kslot[s:e] = k
    small = H._histogram_slots_ragged_image_plain(
        bins, gh, kslot, torch.from_numpy(starts), torch.from_numpy(ends),
        torch.from_numpy(np.array([True] * (K - 1) + [False])), B, K, exps)
    return pool, torch.from_numpy(sel), small, torch.tensor(left[:K]), exps


def _float_values(sums, flags, exps):
    """The cells as float64 values: the fixed-point sum scaled, or the
    non-finite value its flag code stands for."""
    e = exps.double()[torch.arange(sums.shape[-1]) % exps.shape[0]]
    vals = sums.double() * torch.pow(2.0, -e)
    for code, v in CODE_VALUE.items():
        if code:
            vals = torch.where(flags == code, v, vals)
    return vals


def _code_of(x):
    return torch.where(torch.isnan(x), 3, torch.where(x == float("inf"), 1,
                       torch.where(x == float("-inf"), 2, 0))).to(torch.int32)


@pytest.mark.parametrize("left", [(True, False, True, False), (False, True, False, True)],
                         ids=["left_small_first", "right_small_first"])
def test_children_step_equals_the_composition(left):
    pool, sel, small, ls, exps = _images(3 + left[0], left=left)
    K, (_, G, B, CH) = sel.shape[0], pool.sums.shape
    assert int((small.flags != 0).sum()) > 0 and int((pool.flags != 0).sum()) > 0
    before = dict(hist_cuda.launches)
    got_l, got_r, got = H.wave_children(pool, sel, small, ls, exps)
    assert hist_cuda.launches == before  # a CPU tensor launches nothing
    # the composition the wave learner ran before the step was one launch
    small_k = small.map(lambda t: t.reshape(G, B, K, CH).permute(2, 0, 1, 3))
    hist_l, hist_r = H.children(pool.map(lambda t: t[sel.long()]), small_k, ls)
    want = H._image_to_float_plain(*H.stack_children(hist_l, hist_r), exps)
    for a, b in ((got_l, hist_l), (got_r, hist_r)):
        assert torch.equal(a.sums, b.sums) and torch.equal(a.flags, b.flags)
    assert got.shape == (2 * K, G, B, CH) and got.dtype == torch.float32
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    # the arithmetic it stands for, each flag the code of a float difference
    # (the JAX grower's float32 left = where(left_small, small, parent -
    # small), right = parent - left): the larger child parent - smaller; the
    # smaller one's sums as they are, and its flags as they are on the left,
    # those of parent - larger on the right
    idx = sel.long()
    parent = _float_values(pool.sums[idx], pool.flags[idx], exps)
    cond = ls.reshape(-1, 1, 1, 1)
    larger = H.image_where(cond, hist_r, hist_l)
    assert torch.equal(larger.sums, pool.sums[idx] - small_k.sums)
    assert torch.equal(larger.flags,
                       _code_of(parent - _float_values(small_k.sums, small_k.flags, exps)))
    assert torch.equal(torch.where(cond, hist_l.sums, hist_r.sums), small_k.sums)
    right_small = _code_of(parent - _float_values(larger.sums, larger.flags, exps))
    assert torch.equal(torch.where(cond, hist_l.flags, hist_r.flags),
                       torch.where(cond, small_k.flags, right_small))
    # the dump row's leaf: a zero parent, an empty smaller child
    assert not bool(got[2 * K - 2:].any())


@pytest.mark.parametrize("dtype", [torch.int32, torch.float32], ids=["int32", "float32"])
def test_children_step_without_flags_equals_the_composition(dtype):
    """The quantized pool (int32, the kernel's integer mode on the card) and
    the CPU's float32 pool: the children as the composition gives them,
    hists their stack as it is."""
    rng = np.random.RandomState(11)
    R, G, B, CH, K = 7, 3, 8, 3, 4
    if dtype == torch.int32:  # a leaf's int32 sums, wrapping as the card's do
        pool = torch.from_numpy(rng.randint(-2 ** 31, 2 ** 31, size=(R, G, B, CH))
                                .astype(np.int32))
        small = torch.from_numpy(rng.randint(-2 ** 31, 2 ** 31, size=(G, B, K * CH))
                                 .astype(np.int32))
    else:
        pool = torch.from_numpy(rng.normal(size=(R, G, B, CH)).astype(np.float32))
        small = torch.from_numpy(rng.normal(size=(G, B, K * CH)).astype(np.float32))
    pool[R - 1] = 0  # the dump row
    sel = torch.tensor([2, 0, 5, R - 1], dtype=torch.int32)
    ls = torch.tensor([True, False, False, True])
    got_l, got_r, got = H.wave_children(H.HistImage(pool), sel, H.HistImage(small), ls, None)
    small_k = small.reshape(G, B, K, CH).permute(2, 0, 1, 3)
    hist_l, hist_r = H.children(H.HistImage(pool[sel.long()]), H.HistImage(small_k), ls)
    assert got_l.flags is None and got_r.flags is None
    assert torch.equal(got_l.sums, hist_l.sums) and torch.equal(got_r.sums, hist_r.sums)
    assert got.dtype == dtype and got.shape == (2 * K, G, B, CH)
    assert torch.equal(got, H.stack_children(hist_l, hist_r).sums)
    assert torch.equal(got[0::2], hist_l.sums) and torch.equal(got[1::2], hist_r.sums)


def test_sub_codes_are_the_kernels():
    """The kernel's subtraction table (csrc/histogram.cu kSubCodes) is the
    plain version's, and both are the codes of the float differences."""
    src = (Path(H.__file__).parents[1] / "csrc" / "histogram.cu").read_text()
    table = re.search(r"kSubCodes\[16\] = \{([^}]*)\}", src).group(1)
    assert tuple(int(x) for x in table.split(",")) == H._SUB_CODES
    for a in range(4):
        for b in range(4):
            x = torch.tensor(CODE_VALUE[a] - CODE_VALUE[b] if a or b else 0.0)
            assert H._SUB_CODES[4 * a + b] == int(_code_of(x))


def test_children_wrapper_checks():
    pool, sel, small, ls, exps = _images(9)
    hist_cuda._check_children(pool, sel, small, ls, exps)  # the good arguments pass
    bad = [(pool._replace(flags=None), sel, small, ls, exps),
           (pool.map(lambda t: t[0]), sel, small, ls, exps),
           (pool, sel.long(), small, ls, exps),
           (pool, sel[:, None], small, ls, exps),
           (pool, sel, small.map(lambda t: t[:, :, :-1]), ls, exps),
           (pool, sel, small._replace(flags=small.flags.long()), ls, exps),
           (pool, sel, small, ls.to(torch.uint8), exps),
           (pool, sel, small, ls[:-1], exps),
           (pool, sel, small, ls, exps[:2]),
           (pool.map(lambda t: t.transpose(1, 2)), sel, small, ls, exps)]
    for args in bad:
        with pytest.raises(ValueError):
            hist_cuda._check_children(*args)
    # the integer mode: the quantized pool's int32, no flags, no exponents read
    q_pool, q_small = pool.sums.to(torch.int32), small.sums.to(torch.int32)
    hist_cuda._check_children(H.HistImage(q_pool), sel, H.HistImage(q_small), ls, None)
    for args in [(H.HistImage(q_pool), sel, H.HistImage(q_small, small.flags), ls, None),
                 (H.HistImage(q_pool), sel, H.HistImage(small.sums), ls, None),
                 (H.HistImage(q_pool.float()), sel, H.HistImage(q_small.float()), ls, None)]:
        with pytest.raises(ValueError):
            hist_cuda._check_children(*args)


@pytest.mark.parametrize("K", [4, 21])
def test_image_pool_grows_the_jax_tree(learners, K):
    """The wave learner on an image pool, the children step on every wave,
    against the JAX package's grower on snapped gradients."""
    import jax.numpy as jnp
    from lightgbm_tpu.treelearner.device import grow_tree_on_device as jax_grow

    jl, tl, gh, _ = learners
    leaf0 = np.zeros(N, np.int32)
    L = tl.config.num_leaves
    ref = jax_grow(jnp.copy(jl.bins_dev), jnp.asarray(gh), jnp.asarray(leaf0), jl.meta,
                   jl.tables, jl.params_dev, jnp.ones(F, bool), L, jl.group_bin_padded,
                   jl.config.max_depth, batch=K, bagged=False)
    rec_ref, leaf_ref, n_ref, rows_ref, waves_ref = (np.asarray(a) for a in ref)
    buf = dmod.WaveBuffers(tl.bins_dev.shape[0], N, 5, L, tl.group_bin_padded, 3,
                           len(tl.meta.real_feature), "cpu", image=True)
    assert buf.image and buf.pool.dtype == torch.int64
    calls = []
    real = dmod.wave_children
    dmod.wave_children = lambda *a: calls.append(1) or real(*a)
    try:
        rec, leaf_id, n_cur, hist_rows, n_waves = dmod.grow_tree_on_device(
            tl.bins_dev, torch.from_numpy(gh), torch.from_numpy(leaf0), tl.meta, tl.tables,
            tl.params_dev, None, L, tl.group_bin_padded, tl.config.max_depth, batch=K,
            buffers=buf)
    finally:
        dmod.wave_children = real
    assert len(calls) >= n_waves > 0
    gain = 4  # rec_store column of split_gain
    np.testing.assert_array_equal(np.delete(rec, gain, 1), np.delete(rec_ref, gain, 1))
    assert _gain_within_4_ulp(rec[:, gain], rec_ref[:, gain], rec[:, 8] + rec[:, 11],
                              rec[:, 9] + rec[:, 12], tl.params_dev.numpy())
    np.testing.assert_array_equal(leaf_id.numpy(), leaf_ref)
    assert (n_cur, hist_rows, n_waves) == (int(n_ref), int(rows_ref), int(waves_ref))


def test_image_pool_model_text_matches_jax(jax_ref, monkeypatch):
    """A GBDT whose wave learner keeps an image pool writes the JAX
    package's model text on snapped gradients (split_gain within 4 ULP)."""
    monkeypatch.setattr(dmod, "WaveBuffers", functools.partial(dmod.WaveBuffers, image=True))
    params = {"objective": "none", "num_leaves": 15, "verbosity": -1}
    port, ref = _wave_boosters(jax_ref, monkeypatch, params, snapped_logloss, rounds=3)
    assert port._gbdt.tree_learner._buffers.pool.dtype == torch.int64
    assert port.num_trees() == ref.num_trees() == 3
    a, b = port.model_to_string(), ref.model_to_string()
    for la, lb in zip(a.splitlines(), b.splitlines(), strict=True):
        if la.split("=", 1)[0] not in ("split_gain", "tree_sizes"):
            assert la == lb, (la, lb)
    for ta, tb in zip(_trees(a), _trees(b)):
        x, y = (np.array(t["split_gain"].split(), np.float32) for t in (ta, tb))
        out = np.array(ta["internal_value"].split(), np.float32) / np.float32(0.1)
        sum_h = np.array(ta["internal_weight"].split(), np.float32)
        assert (np.abs(x - y) <= 4 * np.spacing(np.abs(y) + out * out * sum_h)).all()


def test_children_bound():
    """The children step's bytes: 24 read and 32 written a (leaf, cell), 16 in
    all in the integer mode; at a HIGGS wave (K = 21, 28 groups x 255 bins x
    3) 25.2 MB, 7.5 us on an H100."""
    from lightgbm_tpu_torch import perfmodel as pm

    cells = 21 * 28 * 255 * 3
    assert pm.wave_children(cells) == (56 * cells, 6 * cells)
    assert pm.wave_children(cells, quantized=True) == (16 * cells, 2 * cells)
    ms, by = pm.bound_ms(*pm.wave_children(cells), "NVIDIA H100 80GB HBM3")
    assert by == "bytes" and abs(ms - 56 * cells / 3.35e12 * 1e3) < 1e-12
