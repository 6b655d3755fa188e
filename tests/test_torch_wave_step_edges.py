"""The wave's selection and replay (ops/wave.py: select_wave, replay_wave) at
their edges, against the oracle of tests/test_torch_wave_step.py (the wave
learner's former host code), on the states of
tests/test_torch_wave_cases.py:WAVE_EDGES. tests/test_torch_cuda_wave_step.py
holds the card's kernels to the plain versions on the same states.

Contracts: on every edge state, every output of select_wave and
replay_wave equals the oracle's exactly (float bits included): the
partition's tables, the state after the replay (leaf_best, depth, start,
count, the split log, the scalars with the done word) and the commit table.
Besides:
- NaN gains rank first, a NaN above every number, ties to the lower leaf:
  the selection's order is jax.lax.top_k's, the JAX grower's frontier
  (treelearner/device.py:586). The oracle's argsort ranks a NaN last, so
  there the oracle takes JAX's order. A NaN at the top stops the replay
  and ends the tree.
- -0.0 and +0.0 tie, the lower leaf first, as torch.sort's and numpy's
  stable sorts order them (jax.lax.top_k's total order ranks +0.0 above
  -0.0; only ranges whose gain is not positive, which never split, can
  differ).
- K = 1, K = L, 1,024 and 1,025 leaves (the kernels' two selection paths),
  4,100 leaves, up to K = 1,024.
- A done tree selects and commits nothing; the leaf budget binds mid-wave;
  max_depth gates some children and not others; a leaf the wave creates
  that is also a valid selection takes its last write.
"""
import numpy as np
import pytest
import torch

from lightgbm_tpu_torch.ops.wave import (DONE, HIST_ROWS, N_WAVES, T, replay_wave,
                                         select_wave, split_select)
from tests.test_torch_ref import jax_ref  # noqa: F401
from tests.test_torch_wave_cases import WAVE_EDGES, wave_edge
from tests.test_torch_wave_step import _check_wave, _HostTables, _torch_tables

ORACLE_EDGES = [e[0] for e in WAVE_EDGES if e[0] not in ("nan_gains", "nan_child", "done")]


def _check(name, sel=None):
    e = wave_edge(name)
    return e, _check_wave(e["state"], _HostTables(*e["tables"]), e["K"], e["recs2"],
                          e["totals2"], e["n_left"], e["params"], e["max_depth"], sel)


def _selection(e):
    """(sel, valid) of the plain selection on an edge state."""
    st, K = e["state"], e["K"]
    table = select_wave(*(torch.from_numpy(st[k].copy()) for k in
                          ("leaf_best", "start", "count", "scalars")),
                        _torch_tables(_HostTables(*e["tables"])), K)
    parts = split_select(table, st["leaf_best"].shape[0] - 1, K)
    return parts[5].numpy(), parts[4].numpy() != 0


@pytest.mark.parametrize("name", ORACLE_EDGES)
def test_edge_matches_oracle(name):
    e, (ref, commit) = _check(name)
    st, K = e["state"], e["K"]
    L = st["leaf_best"].shape[0] - 1
    n = int(ref["scalars"][T] - st["scalars"][T])
    committed = commit[0] < L
    assert committed.sum() == n
    sel, ok = _selection(e)
    if name == "signed_zero_tie":
        gains = st["leaf_best"][:L, 0]
        zeros = sel[gains[sel] == 0]
        assert len(zeros) == 6 and (np.diff(zeros) > 0).all()  # by leaf, whatever the sign
        assert np.signbit(gains[zeros]).any() and not np.signbit(gains[zeros]).all()
    elif name == "budget_mid_wave":
        assert ref["scalars"][T] == L - 1 and ref["scalars"][DONE] == 1
        assert 0 < n < ok.sum()  # valid ranges left uncommitted
    elif name == "max_depth_gate":
        rows = ref["rec_store"][st["scalars"][T]:ref["scalars"][T]]
        assert n > 0 and (rows[:, 2] <= 3).all()
        # the children at depth 3 may not split, those at depth 2 may
        assert np.isneginf(ref["leaf_best"][rows[:, 0].astype(int), 0][rows[:, 2] == 3]).all()
        assert not np.isneginf(ref["leaf_best"][rows[:, 0].astype(int), 0][rows[:, 2] == 2]).all()
    elif name in ("l4100", "l4100_k1024", "l1024", "l1025", "k_equals_l"):
        assert n > 0
    elif name == "new_leaf_selected":
        # a new leaf's id is the leaf of a valid range
        assert np.isin(commit[1][committed], sel[ok]).any()


@pytest.mark.parametrize("name", ["nan_gains", "nan_child"])
def test_nan_gains_rank_first_as_jax_top_k(jax_ref, name):
    import jax
    import jax.numpy as jnp

    e = wave_edge(name)
    st, K = e["state"], e["K"]
    L = st["leaf_best"].shape[0] - 1
    gains = st["leaf_best"][:L, 0]
    order = np.asarray(jax.lax.top_k(jnp.asarray(gains), K)[1])
    if name == "nan_gains":
        assert np.isnan(gains[order[:3]]).all() and (np.diff(order[:3]) > 0).all()
        assert not np.array_equal(np.argsort(-gains, kind="stable")[:K], order)
    ref, commit = _check_wave(st, _HostTables(*e["tables"]), K, e["recs2"], e["totals2"],
                              e["n_left"], e["params"], e["max_depth"], order)
    assert ref["scalars"][DONE] == 1  # the NaN reached the top
    n = int(ref["scalars"][T] - st["scalars"][T])
    assert n == (0 if name == "nan_gains" else 1)


def test_done_tree_edge():
    """A wave of a done tree: the ranges are the top K, none valid; the
    replay commits nothing, counts no rows and no wave, and leaves the state
    as it was."""
    e = wave_edge("done")
    st, K = e["state"], e["K"]
    L = st["leaf_best"].shape[0] - 1
    s = {k: torch.from_numpy(v.copy()) for k, v in st.items()}
    table = select_wave(s["leaf_best"], s["start"], s["count"], s["scalars"],
                        _torch_tables(_HostTables(*e["tables"])), K)
    leaf2k, rgroup, s_k, c_k, ok, sel, lut = (p.numpy() for p in split_select(table, L, K))
    ref_sel = np.argsort(-st["leaf_best"][:L, 0], kind="stable")[:K]
    np.testing.assert_array_equal(sel, ref_sel)
    np.testing.assert_array_equal(s_k, st["start"][ref_sel])
    np.testing.assert_array_equal(c_k, st["count"][ref_sel])
    assert (leaf2k == K).all() and (ok == 0).all() and (lut == 0).all() and (rgroup == 0).all()
    commit = replay_wave(s["leaf_best"], s["depth"], s["rec_store"], s["start"], s["count"],
                         s["scalars"], table, torch.from_numpy(e["n_left"]),
                         torch.from_numpy(e["recs2"]), torch.from_numpy(e["totals2"]),
                         torch.from_numpy(e["params"]), e["max_depth"])
    for key in ("leaf_best", "depth", "start", "count", "rec_store", "scalars"):
        np.testing.assert_array_equal(s[key].numpy().view(np.uint8),
                                      st[key].view(np.uint8), err_msg=key)
    assert int(s["scalars"][N_WAVES]) == int(st["scalars"][N_WAVES])
    assert int(s["scalars"][HIST_ROWS]) == int(st["scalars"][HIST_ROWS])
    np.testing.assert_array_equal(commit[:2].numpy(), np.full((2, K), L))
    assert (commit[2:] == 0).all()
