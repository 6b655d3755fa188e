"""The tree loop's condition: the done word against the JAX grower's `cond`.

The JAX grower runs a tree as ``jax.lax.while_loop(cond, wave, carry)``
with ``cond = (t < L - 1) & (max(leaf_best[:L, 0]) > 0)``
(``lightgbm_tpu/treelearner/device.py:838-840``). The port writes the
negation of that condition as the done word: the root's state
(`init_tree_state`) before the first wave, and each wave's replay
(`replay_wave`, whose kernel in a tree graph's second wave also sets the
WHILE node's condition from it). On the CPU the loop is `_waves_eager`,
which reads the done word.

Contracts: on seeded states and children, the done word after the plain
replay equals ``not cond`` with JAX's expression evaluated by jax.numpy on
the state after the wave, at L = 2, 3 and 255, t = L - 2 and L - 1 before
the wave, NaN and -0.0 gains, a stump whose root has no positive gain and
a tree already done (which stays done). The root's done word equals ``not
cond`` on the root's state. A graphed tree counts the condition kernel
once, whatever its passes.
"""
import numpy as np
import pytest
import torch

from lightgbm_tpu_torch.ops import wave_cuda
from lightgbm_tpu_torch.ops.wave import (DONE, T, FeatureTables, init_tree_state,
                                         replay_wave, select_wave, split_select)
from tests.test_torch_ref import jax_ref  # noqa: F401
from tests.test_torch_wave_cases import wave_children, wave_state, wave_tables_random

PARAMS = np.array([0.0, 0.5, 5.0, 1e-3, 0.0, 0.0], np.float32)


def _jax_cond(leaf_best: np.ndarray, t: int, L: int) -> bool:
    """The JAX grower's loop condition (device.py:838-840) on numpy arrays."""
    import jax.numpy as jnp

    return bool((jnp.int32(t) < L - 1) & (jnp.max(jnp.asarray(leaf_best)[:L, 0]) > 0))


def _wave(L, n_cur, K, seed, gains=None, child_gains=None, done_in=0):
    """One wave of the plain selection and replay on a seeded state;
    returns the state after it (numpy) and the done word."""
    rng = np.random.RandomState(seed)
    st = wave_state(rng, L, n_cur, gains=gains)
    st["scalars"][DONE] = done_in
    s = {k: torch.from_numpy(v.copy()) for k, v in st.items()}
    tables = FeatureTables(*(torch.from_numpy(a) for a in wave_tables_random(rng, 6)))
    K = max(1, min(K, L))
    table = select_wave(s["leaf_best"], s["start"], s["count"], s["scalars"], tables, K)
    parts = split_select(table, L, K)
    recs2, totals2, nl = wave_children(rng, st, parts[5].numpy(), parts[4].numpy() != 0,
                                       gains=child_gains)
    replay_wave(s["leaf_best"], s["depth"], s["rec_store"], s["start"], s["count"],
                s["scalars"], table, torch.from_numpy(nl), torch.from_numpy(recs2),
                torch.from_numpy(totals2), torch.from_numpy(PARAMS), -1)
    return s, int(s["scalars"][DONE])


CASES = [
    # (id, L, n_cur, K, gains of the live leaves, children's gains, done after)
    ("l2_t0", 2, 1, 1, [1.5], None, 1),  # t = L - 2: one commit ends the tree
    ("l2_t1", 2, 2, 1, [1.5, 2.0], None, 1),  # t = L - 1: nothing may commit
    ("l3_t1", 3, 2, 2, [0.75, 2.0], None, 1),  # t = L - 2 with two candidates
    ("l3_t2", 3, 3, 2, [1.0, 2.0, 3.0], None, 1),
    ("l31_live", 31, 4, 2, [2.0, 1.0, 3.0, 0.5], None, 0),  # unselected leaves go on
    ("l255_t253", 255, 254, 21, None, None, 1),
    ("l255_t254", 255, 255, 21, None, None, 1),
    ("l255_live", 255, 40, 21, None, None, 0),  # the tree goes on
    ("l255_children_nonpositive", 255, 30, 21, None, [-1.0, -0.0], 1),
    ("stump", 255, 1, 21, [-0.5], None, 1),  # the root has no positive gain
    ("stump_zero", 31, 1, 8, [0.0], None, 1),
    ("neg_zero_max", 31, 6, 4, [-0.0, -1.0, -0.0, -2.0, -0.0, -3.0], None, 1),
    ("nan_gain", 31, 8, 4, [1.0, np.nan, 2.0, 0.5, 1.5, 3.0, 0.25, 1.0], None, 1),
    ("nan_child", 31, 8, 4, [1.0, 2.0, 2.5, 0.5, 1.5, 3.0, 0.25, 1.0], [np.nan, 1.0], 1),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
@pytest.mark.parametrize("seed", range(2))
def test_done_word_is_not_jax_cond(jax_ref, case, seed):
    _, L, n_cur, K, gains, child, want = case
    child_gains = None
    if child is not None:
        child_gains = np.resize(np.asarray(child, np.float64), 2 * max(1, min(K, L)))
    s, done = _wave(L, n_cur, K, 100 * seed + L + n_cur, gains, child_gains)
    t = int(s["scalars"][T])
    assert done == int(not _jax_cond(s["leaf_best"].numpy(), t, L))
    assert done == want and t <= L - 1


@pytest.mark.parametrize("L", [2, 255])
def test_done_tree_stays_done(jax_ref, L):
    """A wave that starts done commits nothing and leaves done set, though
    JAX's condition on the unchanged state would run the loop."""
    s, done = _wave(L, 1, 4, 7, [2.0], done_in=1)
    assert done == 1 and int(s["scalars"][T]) == 0
    assert _jax_cond(s["leaf_best"].numpy(), 0, L)


@pytest.mark.parametrize("gain", [2.0, 0.0, -0.0, -1.0, np.nan], ids=str)
@pytest.mark.parametrize("L", [1, 2, 255])
def test_root_done_word_is_not_jax_cond(jax_ref, L, gain):
    """The root's state (the condition the tree graph's one condition
    kernel reads after the root): done unless the root may split."""
    from lightgbm_tpu_torch.ops.wave import REC, SCALARS, STORE

    leaf_best = torch.empty((L + 1, REC))
    depth = torch.empty(L + 1, dtype=torch.int32)
    rec_store = torch.empty((max(L - 1, 1) + 1, STORE))
    start = torch.empty(L + 1, dtype=torch.int32)
    count = torch.empty(L + 1, dtype=torch.int32)
    scalars = torch.empty(SCALARS, dtype=torch.int64)
    root_rec = torch.zeros(REC)
    root_rec[0] = gain
    root_tot = torch.tensor([1.0, 50.0, 1000.0])
    init_tree_state(leaf_best, depth, rec_store, start, count, scalars, root_rec, root_tot,
                    torch.tensor([1000], dtype=torch.int32), torch.from_numpy(PARAMS), -1)
    want = not _jax_cond(leaf_best.numpy(), 0, L) if L > 1 else True
    assert int(scalars[DONE]) == int(want)


@pytest.mark.parametrize("passes", [0, 1, 7])
def test_graphed_tree_counts_one_condition_launch(passes):
    """`_Grown._count`: the root's capture once, each wave capture once a
    pass, the condition kernel once a tree (a pass's condition is set by
    wave1's replay, counted with its wave)."""
    from lightgbm_tpu_torch.treelearner.device import _Grown

    runs = {}

    class Capture:
        def __init__(self, name):
            self.name = name

        def count(self, n):
            runs[self.name] = runs.get(self.name, 0) + n

    class Buffers:
        roots = {(False, True): Capture("root")}
        graphs = {(21, 0, False): Capture("wave0"), (21, 1, False): Capture("wave1")}

    grown = _Grown.__new__(_Grown)
    grown.buffers, grown.key = Buffers(), (21, False, True)
    before = wave_cuda.launches["tree_loop_cond"]
    grown._count(passes)
    assert runs == {"root": 1, "wave0": passes, "wave1": passes}
    assert wave_cuda.launches["tree_loop_cond"] - before == 1
