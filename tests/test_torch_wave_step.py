"""A wave's selection and replay on the tree's device state (ops/wave.py:
select_wave, replay_wave), against an oracle and against the JAX grower.

The oracle is the wave learner's earlier host code, kept here as it was:
the numpy selection of its wave loop (an argsort, the K-entry tables and the
decision table), `_guard_gain` and `_replay`, and the commit's bookkeeping.
Whole trees grown with it were held equal to the JAX grower
(tests/test_torch_device_learner.py).

Contracts: on random states and on constructed cases (ties in gain in the
selection and the replay, the leaf budget binding mid-wave, a left child
never committed twice, max_delta_step > 0, each of the guard's three gates,
a zero parent gradient), every output of select_wave and replay_wave equals
the oracle's exactly (float bits included): the partition's tables, the
state (leaf_best, depth, rec_store, start, count, the scalars), the commit's
tables and the done word. One wave recorded from the JAX grower run op by op
(its while_loop's carries) is replayed through the port's wave and lands on
the JAX carry after it. `grow_tree_on_device` on the CPU equals the JAX
grower with max_depth and max_delta_step set.
"""
from typing import NamedTuple

import numpy as np
import pytest
import torch

from lightgbm_tpu_torch.ops import wave_cuda
from lightgbm_tpu_torch.ops.wave import (DONE, HIST_ROWS, N_CUR, N_WAVES, T,
                                         FeatureTables, decide_go_left, replay_wave,
                                         select_wave, split_select)
from tests.test_torch_ref import jax_ref  # noqa: F401
from tests.test_torch_wave_cases import wave_children, wave_state, wave_tables_random

F = 6
GROUP_BINS = 256


# ------------------------------------------------------------------ oracle
# The wave learner's host code before the selection and the replay moved to
# the device (treelearner/device.py), unchanged but for the names it
# imported.

class _HostTables(NamedTuple):
    group: np.ndarray
    lo: np.ndarray
    hi: np.ndarray
    default_bin: np.ndarray
    nbins: np.ndarray
    missing_type: np.ndarray
    is_efb: np.ndarray


def _decision_table(tables, feature: np.ndarray, thresh: np.ndarray,
                    default_left: np.ndarray) -> np.ndarray:
    """[K, 256] go_left of each range's split for every group bin value."""
    def col(a):
        return torch.as_tensor(np.asarray(a))[:, None]

    gb = torch.arange(GROUP_BINS, dtype=torch.int32)[None, :]
    return decide_go_left(
        gb, col(thresh), col(default_left), col(tables.missing_type[feature]),
        col(tables.default_bin[feature]), col(tables.nbins[feature]),
        col(tables.lo[feature]), col(tables.hi[feature]),
        col(tables.is_efb[feature])).numpy()


def _guard_gain(gain: np.ndarray, cnt: np.ndarray, sum_h: np.ndarray,
                depth: np.ndarray, min_data: np.float32, min_hess: np.float32,
                max_depth: int) -> np.ndarray:
    """BeforeFindBestSplit gates (serial_tree_learner.cpp:343) on float32
    totals: the gain of a leaf that may not split becomes -inf."""
    ok = (cnt >= 2 * min_data) & (sum_h >= 2 * min_hess)
    if max_depth > 0:
        ok &= depth < max_depth
    return np.where(ok, gain, np.float32(-np.inf)).astype(np.float32)


def _replay(leaf_best, depth, rec_store, sel, sel_ok, recs2, totals2, n_cur, t,
            num_leaves, l1, l2, max_delta):
    """The exact best-first replay of one wave (device.py:750-799), in
    float32 with the device replay's op order: commit the global argmax
    while it is a selected leaf not yet split this wave and the leaf budget
    allows. Updates leaf_best, depth and rec_store in place; returns
    (committed [K], new leaf ids [K], n_cur, t)."""
    L = num_leaves
    K = sel.shape[0]
    committed = np.zeros(K, dtype=bool)
    newids = np.zeros(K, dtype=np.int32)
    zero, eps = np.float32(0.0), np.float32(1e-15)
    while True:
        b = int(np.argmax(leaf_best[:L, 0]))
        brec = leaf_best[b].copy()
        eq = (sel == b) & sel_ok
        pos = int(np.argmax(eq))
        # ~committed[pos]: a left child keeps its parent's leaf id, and its
        # slot holds the PARENT's children, so it is never committed twice
        if not (brec[0] > 0 and eq.any() and not committed[pos] and t < L - 1):
            break
        lrec, rrec = recs2[2 * pos], recs2[2 * pos + 1]
        ptot = totals2[2 * pos] + totals2[2 * pos + 1]
        pnum = -np.sign(ptot[0]) * np.maximum(np.abs(ptot[0]) - l1, zero)
        pout = pnum / np.maximum(ptot[1] + l2, eps)
        if max_delta > 0:
            pout = np.clip(pout, -max_delta, max_delta)
        nd = depth[b] + 1
        depth[b] = depth[n_cur] = nd
        leaf_best[b] = lrec
        leaf_best[n_cur] = rrec
        rec_store[t, :4] = (b, pout, nd, 1.0)
        rec_store[t, 4:] = brec
        committed[pos] = True
        newids[pos] = n_cur
        n_cur += 1
        t += 1
    return committed, newids, n_cur, t


def _oracle_select(leaf_best, start, count, tables, L, K, sel=None):
    """The wave loop's selection, as the host ran it. `sel`, where given,
    stands for its argsort, which ranks a NaN gain last."""
    gains = leaf_best[:L, 0]
    if sel is None:
        sel = np.argsort(-gains, kind="stable")[:K]  # ties: lower leaf first
    sel_ok = gains[sel] > 0
    recs_sel = leaf_best[sel]
    feat = np.where(sel_ok, recs_sel[:, 1], 0.0).astype(np.int64)
    thresh = np.where(sel_ok, recs_sel[:, 2], 0.0).astype(np.int32)
    lut = _decision_table(tables, feat, thresh, recs_sel[:, 3] > 0.5)
    lut[~sel_ok] = 0
    leaf2k = np.full(L + 2, K, dtype=np.int32)  # by leaf id + 1 (-1 -> none)
    leaf2k[sel[sel_ok] + 1] = np.nonzero(sel_ok)[0]
    rgroup = np.where(sel_ok, tables.group[feat], 0)
    s_k, c_k = start[sel], count[sel]
    return np.concatenate([leaf2k, rgroup, s_k, c_k, sel_ok, sel,
                           lut.reshape(-1)]).astype(np.int32), sel, sel_ok


def _oracle_wave(st, sel, sel_ok, recs2, totals2, nl_k, params, max_depth):
    """The wave loop's guard, replay and commit bookkeeping, as the host ran
    them, on a copy of the state `st` (numpy). Returns (state after, the
    commit table [5, K], done)."""
    st = {k: v.copy() for k, v in st.items()}
    L = st["leaf_best"].shape[0] - 1
    K = sel.shape[0]
    p = params.astype(np.float32)
    l1, l2, min_data, min_hess, max_delta = p[0], p[1], p[2], p[3], p[5]
    s_k, c_k = st["start"][sel].astype(np.int64), st["count"][sel].astype(np.int64)
    nl_k = nl_k.astype(np.int64)
    recs2 = recs2.copy()
    recs2[:, 0] = _guard_gain(recs2[:, 0], totals2[:, 2], totals2[:, 1],
                              np.repeat(st["depth"][sel] + 1, 2), min_data,
                              min_hess, max_depth)
    n_cur, t = int(st["scalars"][N_CUR]), int(st["scalars"][T])
    committed, newids, n_cur, t = _replay(
        st["leaf_best"], st["depth"], st["rec_store"], sel, sel_ok, recs2, totals2, n_cur,
        t, L, l1, l2, max_delta)
    nr_k = c_k - nl_k
    hist_rows = int(np.minimum(nl_k, nr_k)[sel_ok].sum())
    ck = np.nonzero(committed)[0]
    st["start"][newids[ck]] = s_k[ck] + nl_k[ck]
    st["count"][newids[ck]] = nr_k[ck]
    st["count"][sel[ck]] = nl_k[ck]
    commit = np.zeros((5, K), np.int64)
    commit[0], commit[1] = L, L
    commit[0, ck], commit[1, ck] = sel[ck], newids[ck]
    commit[2, ck], commit[3, ck], commit[4, ck] = s_k[ck] + nl_k[ck], s_k[ck] + c_k[ck], \
        newids[ck]
    done = not (t < L - 1 and st["leaf_best"][:L, 0].max() > 0)
    st["scalars"][[N_CUR, T, HIST_ROWS, N_WAVES, DONE]] = (
        n_cur, t, st["scalars"][HIST_ROWS] + hist_rows, st["scalars"][N_WAVES] + 1, done)
    return st, commit


# ------------------------------------------------------------------ states

def _torch_tables(t: _HostTables) -> FeatureTables:
    return FeatureTables(*(torch.from_numpy(np.asarray(a)) for a in t))


def _run_port(st, tables, K, recs2, totals2, nl, params, max_depth):
    """select_wave then replay_wave on CPU tensors copied from `st`."""
    s = {k: torch.from_numpy(v.copy()) for k, v in st.items()}
    before = dict(wave_cuda.launches)
    table = select_wave(s["leaf_best"], s["start"], s["count"], s["scalars"],
                        _torch_tables(tables), K)
    sel_table = table.clone()
    commit = replay_wave(s["leaf_best"], s["depth"], s["rec_store"], s["start"], s["count"],
                         s["scalars"], table, torch.from_numpy(nl),
                         torch.from_numpy(recs2), torch.from_numpy(totals2),
                         torch.from_numpy(params), max_depth)
    assert wave_cuda.launches == before  # a CPU tensor launches nothing
    return sel_table.numpy(), {k: v.numpy() for k, v in s.items()}, commit.numpy()


def _check_wave(st, tables, K, recs2, totals2, nl, params, max_depth=-1, sel=None):
    L = st["leaf_best"].shape[0] - 1
    ref_table, sel, sel_ok = _oracle_select(st["leaf_best"], st["start"], st["count"],
                                            tables, L, K, sel)
    table, got, commit = _run_port(st, tables, K, recs2, totals2, nl, params, max_depth)
    np.testing.assert_array_equal(table, ref_table)
    ref, ref_commit = _oracle_wave(st, sel, sel_ok, recs2, totals2, nl, params, max_depth)
    for key in ("leaf_best", "depth", "start", "count", "scalars"):
        np.testing.assert_array_equal(got[key].view(np.uint8), ref[key].view(np.uint8),
                                      err_msg=key)
    # the dump row is the JAX replay's scratch; the port writes none
    np.testing.assert_array_equal(got["rec_store"][:-1].view(np.int32),
                                  ref["rec_store"][:-1].view(np.int32))
    np.testing.assert_array_equal(commit, ref_commit)
    return ref, commit


PARAMS = np.array([0.0, 0.0, 5.0, 1e-3, 0.0, 0.0], np.float32)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("K", [1, 4, 21])
def test_wave_matches_oracle_on_random_states(seed, K):
    rng = np.random.RandomState(seed * 31 + K)
    L = 31 if K < 21 else 63
    n_cur = int(rng.randint(max(2, K // 2), L // 2))
    st = wave_state(rng, L, n_cur)
    tables = _HostTables(*wave_tables_random(rng, F))
    _, sel, sel_ok = _oracle_select(st["leaf_best"], st["start"], st["count"], tables, L, K)
    recs2, totals2, nl = wave_children(rng, st, sel, sel_ok)
    _check_wave(st, tables, K, recs2, totals2, nl, PARAMS, max_depth=int(rng.randint(-1, 7)))


def test_selection_ties_break_to_the_lower_leaf():
    rng = np.random.RandomState(1)
    L, K = 15, 4
    st = wave_state(rng, L, 9, gains=[1.0, 2.0, 2.0, -1.0, 2.0, 0.0, 1.0, 2.0, -np.inf])
    tables = _HostTables(*wave_tables_random(rng, F))
    table, sel, sel_ok = _oracle_select(st["leaf_best"], st["start"], st["count"], tables,
                                        L, K)
    np.testing.assert_array_equal(sel, [1, 2, 4, 7])
    got = select_wave(torch.from_numpy(st["leaf_best"]), torch.from_numpy(st["start"]),
                      torch.from_numpy(st["count"]), torch.from_numpy(st["scalars"]),
                      _torch_tables(tables), K)
    np.testing.assert_array_equal(got.numpy(), table)
    np.testing.assert_array_equal(split_select(got, L, K)[5].numpy(), [1, 2, 4, 7])


def test_selection_of_a_done_tree_is_empty():
    """A wave launched after the tree is done selects nothing, commits
    nothing and leaves the state as it was but the counters it owns."""
    rng = np.random.RandomState(2)
    L, K = 15, 4
    st = wave_state(rng, L, 6)
    st["scalars"][DONE] = 1
    tables = _HostTables(*wave_tables_random(rng, F))
    s = {k: torch.from_numpy(v.copy()) for k, v in st.items()}
    table = select_wave(s["leaf_best"], s["start"], s["count"], s["scalars"],
                        _torch_tables(tables), K)
    leaf2k, rgroup, _, _, ok, _, lut = split_select(table, L, K)
    assert (leaf2k == K).all() and (ok == 0).all() and (lut == 0).all() \
        and (rgroup == 0).all()
    _, sel, sel_ok = _oracle_select(st["leaf_best"], st["start"], st["count"], tables, L, K)
    recs2, totals2, nl = wave_children(rng, st, sel, sel_ok)
    commit = replay_wave(s["leaf_best"], s["depth"], s["rec_store"], s["start"], s["count"],
                         s["scalars"], table, torch.from_numpy(nl), torch.from_numpy(recs2),
                         torch.from_numpy(totals2), torch.from_numpy(PARAMS), -1)
    for key in ("leaf_best", "depth", "start", "count", "rec_store", "scalars"):
        np.testing.assert_array_equal(s[key].numpy(), st[key], err_msg=key)
    np.testing.assert_array_equal(commit[:2].numpy(), np.full((2, K), L))
    assert (commit[2:] == 0).all()


def test_replay_ties_take_the_lower_leaf():
    """Equal gains in the replay: the argmax takes the first maximum, so
    the lower leaf commits first and the new leaves' ids follow it."""
    rng = np.random.RandomState(3)
    L, K = 15, 3
    st = wave_state(rng, L, 5, gains=[3.0, 3.0, 3.0, -1.0, 0.5])
    tables = _HostTables(*wave_tables_random(rng, F))
    _, sel, sel_ok = _oracle_select(st["leaf_best"], st["start"], st["count"], tables, L, K)
    recs2, totals2, nl = wave_children(rng, st, sel, sel_ok, gains=[1.0, 1.0] * 3)
    ref, commit = _check_wave(st, tables, K, recs2, totals2, nl, PARAMS)
    assert ref["rec_store"][4:7, 0].tolist() == [0.0, 1.0, 2.0]
    np.testing.assert_array_equal(commit[1], [5, 6, 7])


def test_leaf_budget_binds_mid_wave():
    """t reaches L - 1 inside the wave: the replay stops there with
    selections left, and the tree is done."""
    rng = np.random.RandomState(4)
    L, K = 8, 4
    st = wave_state(rng, L, 6, gains=[5.0, 4.0, 3.0, 2.0, 1.0, -1.0])
    tables = _HostTables(*wave_tables_random(rng, F))
    _, sel, sel_ok = _oracle_select(st["leaf_best"], st["start"], st["count"], tables, L, K)
    recs2, totals2, nl = wave_children(rng, st, sel, sel_ok, gains=[0.5] * 8)
    ref, commit = _check_wave(st, tables, K, recs2, totals2, nl, PARAMS)
    assert ref["scalars"][T] == L - 1 and ref["scalars"][N_CUR] == L
    assert ref["scalars"][DONE] == 1
    assert (commit[1] < L).sum() == 2  # two of four committed


def test_left_child_is_never_committed_twice():
    """A committed left child keeps its parent's leaf id and the best gain:
    its slot holds the parent's children, so the replay stops rather than
    committing the slot again."""
    rng = np.random.RandomState(5)
    L, K = 15, 2
    st = wave_state(rng, L, 4, gains=[4.0, 3.0, -1.0, -1.0])
    tables = _HostTables(*wave_tables_random(rng, F))
    _, sel, sel_ok = _oracle_select(st["leaf_best"], st["start"], st["count"], tables, L, K)
    recs2, totals2, nl = wave_children(rng, st, sel, sel_ok, gains=[9.0, 1.0, 2.0, 2.0])
    ref, commit = _check_wave(st, tables, K, recs2, totals2, nl, PARAMS)
    assert ref["scalars"][T] == 4  # one commit: leaf 0, its left child still best
    np.testing.assert_array_equal(commit[0], [0, L])
    assert ref["scalars"][DONE] == 0


def test_max_delta_step_clips_the_parent_output():
    rng = np.random.RandomState(6)
    L, K = 15, 4
    st = wave_state(rng, L, 5)
    st["leaf_best"][:5, 0] = [3.0, 2.5, 2.0, 1.5, 1.0]
    tables = _HostTables(*wave_tables_random(rng, F))
    _, sel, sel_ok = _oracle_select(st["leaf_best"], st["start"], st["count"], tables, L, K)
    recs2, totals2, nl = wave_children(rng, st, sel, sel_ok, gains=[-1.0] * 8,
                                   g_sum=[4000.0, -3000.0, -0.5, 0.25, 7000.0, 9000.0, -3000.0,
                                          -2000.0])
    params = np.array([0.5, 1.0, 5.0, 1e-3, 0.0, 0.7], np.float32)
    ref, _ = _check_wave(st, tables, K, recs2, totals2, nl, params)
    pout = ref["rec_store"][4:8, 1]
    assert (np.abs(pout) <= np.float32(0.7)).all() and (np.abs(pout) == np.float32(0.7)).any()


@pytest.mark.parametrize("gate", ["min_data", "min_hess", "max_depth"])
def test_guard_gates(gate):
    """Each of BeforeFindBestSplit's gates sets a child's gain to -inf, so
    the replay never selects it: here every child's, so one commit a wave
    and the tree is done."""
    rng = np.random.RandomState(7)
    L, K = 15, 3
    st = wave_state(rng, L, 4, gains=[3.0, 2.0, 1.0, -1.0])
    st["depth"][:4] = 2
    tables = _HostTables(*wave_tables_random(rng, F))
    _, sel, sel_ok = _oracle_select(st["leaf_best"], st["start"], st["count"], tables, L, K)
    recs2, totals2, nl = wave_children(rng, st, sel, sel_ok, gains=[8.0] * 6)
    params, max_depth = PARAMS.copy(), -1
    if gate == "min_data":
        params[2] = totals2[:, 2].max() / 2 + 1
    elif gate == "min_hess":
        params[3] = totals2[:, 1].max() / 2 + 1
    else:
        max_depth = 3
    ref, _ = _check_wave(st, tables, K, recs2, totals2, nl, params, max_depth)
    assert ref["scalars"][T] == 3 + 3  # the three selections, best first
    assert (ref["leaf_best"][:L, 0] <= 0).all() and ref["scalars"][DONE] == 1


@pytest.mark.parametrize("g", [0.0, -0.0])
def test_zero_parent_gradient_keeps_the_sign_bit(g):
    """pnum = -sign(0) * 0 is -0.0; the parent's output keeps that sign bit
    (it reaches the model text as internal_value)."""
    rng = np.random.RandomState(8)
    L, K = 15, 1
    st = wave_state(rng, L, 3, gains=[2.0, 1.0, -1.0])
    tables = _HostTables(*wave_tables_random(rng, F))
    _, sel, sel_ok = _oracle_select(st["leaf_best"], st["start"], st["count"], tables, L, K)
    recs2, totals2, nl = wave_children(rng, st, sel, sel_ok, gains=[0.5, 0.25], g_sum=[g, g])
    ref, _ = _check_wave(st, tables, K, recs2, totals2, nl, PARAMS)
    pout = ref["rec_store"][2, 1]
    assert pout == 0.0 and np.signbit(pout)


# ------------------------------------------------- against the JAX grower

def _snapped_learners(jax_ref, n=1500, num_leaves=15, max_depth=-1, max_delta=0.0):
    from lightgbm_tpu.config import Config as JConfig
    from lightgbm_tpu.io.dataset import Dataset as JDataset
    from lightgbm_tpu.treelearner.device import DeviceTreeLearner as JLearner

    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.io.dataset import Dataset as CoreDataset
    from lightgbm_tpu_torch.treelearner.device import DeviceTreeLearner

    rng = np.random.RandomState(11)
    X = rng.normal(size=(n, 5))
    y = (X[:, 0] + X[:, 1] > 0).astype(float)
    params = {"objective": "binary", "num_leaves": num_leaves, "min_data_in_leaf": 5,
              "max_depth": max_depth, "max_delta_step": max_delta, "verbosity": -1}
    jl = JLearner(JConfig(params), JDataset.from_matrix(X, label=y, config=JConfig(params)))
    tl = DeviceTreeLearner(Config(params), CoreDataset.from_matrix(
        X, label=y, config=Config(params)), torch.device("cpu"))
    g = np.round(rng.normal(0, 0.4, n) * 16) / 16
    h = np.round(rng.uniform(0.0625, 0.25, n) * 16) / 16
    gh = np.stack([g, h, np.ones(n)], 1).astype(np.float32)
    return jl, tl, gh


def test_one_wave_lands_on_the_jax_carry(jax_ref, monkeypatch):
    """The JAX grower run op by op (jax.disable_jit), its while_loop's carry
    kept after every wave; a middle wave's and the last wave's carry before
    it, put into the port's buffers, go through the port's wave (selection,
    partition, histogram, split search, replay, commit) and land on the JAX
    carry after it: records and split log bit-equal, depths, ranges,
    scalars, pool and the permuted rows equal, and the done word equal to
    the JAX loop condition."""
    import jax
    import jax.numpy as jnp
    from lightgbm_tpu.treelearner import device as jdev

    from lightgbm_tpu_torch.treelearner.device import WaveBuffers, _wave

    jl, tl, gh = _snapped_learners(jax_ref, n=1000)
    n = gh.shape[0]
    L, K = tl.config.num_leaves, 4
    carries = []

    def recording_while(cond, body, carry):
        carries.append(carry)
        while bool(cond(carry)):
            carry = body(carry)
            carries.append(carry)
        return carry

    monkeypatch.setattr(jax.lax, "while_loop", recording_while)
    with jax.disable_jit():
        jdev.grow_tree_on_device(jnp.asarray(jl.bins_dev), jnp.asarray(gh),
                                 jnp.zeros(n, jnp.int32), jl.meta, jl.tables, jl.params_dev,
                                 jnp.ones(5, bool), L, jl.group_bin_padded,
                                 jl.config.max_depth, batch=K, bagged=False)
    assert len(carries) >= 4
    G = tl.bins_dev.shape[0]
    buf = WaveBuffers(G, n, 5, L, tl.group_bin_padded, 3, 5, torch.device("cpu"))
    buf.exponents.zero_()  # unread on the CPU
    names = ("bins_p", "row_p", "start", "count", "depth", "leaf_best", "rec_store", "pool",
             "n_cur", "t", "hist_rows", "n_waves")
    for w in (len(carries) // 2, len(carries) - 2):
        before = dict(zip(names, (np.asarray(a) for a in carries[w])))
        after = dict(zip(names, (np.asarray(a) for a in carries[w + 1])))
        buf.bins[0].copy_(torch.tensor(before["bins_p"][:G, :n]))
        buf.rows[0].copy_(torch.tensor(before["row_p"][:n]))
        for key in ("leaf_best", "depth", "start", "count", "pool"):
            getattr(buf, key).copy_(torch.tensor(before[key]))
        buf.rec_store.copy_(torch.tensor(before["rec_store"]))
        buf.scalars.copy_(torch.tensor([int(before[k]) for k in
                                        ("n_cur", "t", "hist_rows", "n_waves")] + [0]))
        _wave(buf, 0, K, tl.meta, tl.tables, tl.params_dev, False, tl.group_bin_padded,
              tl.config.max_depth)
        for key in ("leaf_best", "depth", "start", "count"):
            np.testing.assert_array_equal(getattr(buf, key)[:L].numpy().view(np.uint8),
                                          after[key][:L].view(np.uint8), err_msg=key)
        np.testing.assert_array_equal(buf.rec_store[:-1].numpy().view(np.int32),
                                      after["rec_store"][:-1].view(np.int32))
        np.testing.assert_array_equal(buf.pool[:L].numpy(), after["pool"][:L])
        np.testing.assert_array_equal(buf.rows[1].numpy().view(np.int32),
                                      after["row_p"][:n].view(np.int32))
        np.testing.assert_array_equal(buf.bins[1].numpy(), after["bins_p"][:G, :n])
        scal = buf.scalars.numpy()
        assert (scal[N_CUR], scal[T], scal[HIST_ROWS], scal[N_WAVES]) == (
            after["n_cur"], after["t"], after["hist_rows"], after["n_waves"])
        jax_continues = bool(after["t"] < L - 1 and after["leaf_best"][:L, 0].max() > 0)
        assert scal[DONE] == (not jax_continues)


@pytest.mark.parametrize("max_depth,max_delta", [(3, 0.0), (-1, 0.3)],
                         ids=["max_depth", "max_delta_step"])
def test_grow_tree_matches_jax_with_depth_and_delta(jax_ref, max_depth, max_delta):
    """Whole trees through the guard's depth gate and the parent output's
    clip, against the JAX grower run op by op (jitted, XLA rounds the
    clipped outputs' gains apart and flips near-ties): the split log
    bit-equal, leaf ids, leaf count, rows histogrammed and waves equal."""
    import jax
    import jax.numpy as jnp
    from lightgbm_tpu.treelearner.device import grow_tree_on_device as jax_grow

    from lightgbm_tpu_torch.treelearner.device import grow_tree_on_device

    jl, tl, gh = _snapped_learners(jax_ref, n=800, max_depth=max_depth, max_delta=max_delta)
    n = gh.shape[0]
    L, K = 15, 4
    with jax.disable_jit():
        ref = jax_grow(jnp.copy(jl.bins_dev), jnp.asarray(gh), jnp.zeros(n, jnp.int32),
                       jl.meta, jl.tables, jl.params_dev, jnp.ones(5, bool), L,
                       jl.group_bin_padded, jl.config.max_depth, batch=K, bagged=False)
    rec_ref, leaf_ref, n_ref, rows_ref, waves_ref = (np.asarray(a) for a in ref)
    rec, leaf_id, n_cur, hist_rows, n_waves = grow_tree_on_device(
        tl.bins_dev, torch.from_numpy(gh), torch.zeros(n, dtype=torch.int32), tl.meta,
        tl.tables, tl.params_dev, None, L, tl.group_bin_padded, tl.config.max_depth,
        batch=K)
    np.testing.assert_array_equal(rec.view(np.int32), rec_ref.view(np.int32))
    np.testing.assert_array_equal(leaf_id.numpy(), leaf_ref)
    assert (n_cur, hist_rows, n_waves) == (int(n_ref), int(rows_ref), int(waves_ref))
    valid = rec[:, 3] > 0.5
    if max_depth > 0:
        assert valid.sum() < L - 1 and rec[valid, 2].max() == max_depth
    else:
        assert (np.abs(rec[valid, 1]) <= np.float32(max_delta)).all()
        assert (np.abs(rec[valid, 1]) == np.float32(max_delta)).any()


@pytest.mark.parametrize("change", ["params", "tables", "max_depth", "num_bins"])
def test_reused_buffers_refuse_other_inputs(change):
    """Buffers keep the inputs of their first tree, which the wave graphs
    read: a later tree with the same objects grows the same tree into them,
    and one with another params, tables, max_depth or num_bins raises."""
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.io.dataset import Dataset as CoreDataset
    from lightgbm_tpu_torch.treelearner.device import (DeviceTreeLearner,
                                                       grow_tree_on_device)

    rng = np.random.RandomState(5)
    n, L = 400, 7
    X = rng.normal(size=(n, 4))
    y = (X[:, 0] > 0).astype(float)
    cfg = Config({"objective": "binary", "num_leaves": L, "min_data_in_leaf": 5,
                  "verbosity": -1})
    tl = DeviceTreeLearner(cfg, CoreDataset.from_matrix(X, label=y, config=cfg),
                           torch.device("cpu"))
    g = np.round(rng.normal(0, 0.4, n) * 16) / 16
    gh = torch.from_numpy(np.stack([g, np.full(n, 0.25), np.ones(n)], 1).astype(np.float32))
    args = dict(bins=tl.bins_dev, gh=gh, leaf_id0=torch.zeros(n, dtype=torch.int32),
                meta=tl.meta, tables=tl.tables, params=tl.params_dev, feature_mask=None,
                num_leaves=L, num_bins=tl.group_bin_padded, max_depth=-1, batch=2)
    first = grow_tree_on_device(**args, buffers=tl._buffers)
    again = grow_tree_on_device(**args, buffers=tl._buffers)
    np.testing.assert_array_equal(again[0].view(np.int32), first[0].view(np.int32))
    assert first[2] > 1 and again[2:] == first[2:]
    other = {"params": tl.params_dev.clone(),
             "tables": FeatureTables(*(t.clone() for t in tl.tables)),
             "max_depth": 3, "num_bins": tl.group_bin_padded + 1}[change]
    with pytest.raises(ValueError, match="WaveBuffers"):
        grow_tree_on_device(**{**args, change: other}, buffers=tl._buffers)
