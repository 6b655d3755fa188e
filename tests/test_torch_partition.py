"""The port's row partition and bin-space score update against the JAX
package's: the same padded index sets (exact: a stable partition of
integers) and the same float32 score updates (exact: one add per row).

The partition's CPU path is the plain version of the card's kernels
(`_split_rows_plain`: the 256-entry go-left table, then both children's
index buffers), held here against the JAX package's `partition_rows` and
`RowPartition.split`; on the card the kernels are held against it
(tests/test_torch_cuda_train.py).
"""
import numpy as np
import pytest
import torch

from lightgbm_tpu_torch.io.dataset import Dataset
from lightgbm_tpu_torch.ops.partition import (RowPartition, _split_rows_plain, bucket_size,
                                              go_left_table, split_decision_bins, split_rows)
from lightgbm_tpu_torch.ops.score import add_tree_to_score
from tests.test_torch_ref import jax_ref  # noqa: F401

N = 1500


def _bins(seed):
    rng = np.random.RandomState(seed)
    return rng.randint(0, 40, size=N).astype(np.uint8), rng


@pytest.mark.parametrize("missing_type,default_left", [(0, False), (1, True),
                                                       (2, False), (2, True)])
def test_partition_rows_match_jax(jax_ref, missing_type, default_left):
    """`split_rows` (the plain version on the CPU) against the JAX
    partition_rows: the left buffer is its sorted indices' first n_left,
    the right buffer the next count - n_left, each then the sentinel."""
    import jax.numpy as jnp
    from lightgbm_tpu.ops.partition import partition_rows as jax_partition_rows

    bins_row, rng = _bins(missing_type)
    rows = np.sort(rng.choice(N, 900, replace=False)).astype(np.int32)
    idx = np.full(1024, N, np.int32)
    idx[:900] = rows
    decision = (17.0, float(default_left), float(missing_type), 3.0, 40.0,
                0.0, 0.0, 0.0)
    left, right, n_left = split_rows(torch.from_numpy(bins_row), torch.from_numpy(idx),
                                     900, go_left_table(decision), N)
    want, want_left = jax_partition_rows(
        jnp.asarray(bins_row), jnp.asarray(idx), jnp.asarray(900, jnp.int32),
        jnp.asarray(decision, jnp.float32), N)
    want, nl = np.asarray(want), int(want_left)
    assert int(n_left) == nl and left.dtype == right.dtype == torch.int32
    pad = lambda a: np.concatenate([a, np.full(1024 - len(a), N, np.int32)])  # noqa: E731
    np.testing.assert_array_equal(left.numpy(), pad(want[:nl]))
    np.testing.assert_array_equal(right.numpy(), pad(want[nl:900]))


# decision fields: [threshold, default_left, missing_type, default_bin,
# nbins, efb_lo, efb_hi, is_efb]
TABLES = [(mt, dl, efb) for mt in (0, 1, 2) for dl in (False, True) for efb in (False, True)]


@pytest.mark.parametrize("missing_type,default_left,efb", TABLES,
                         ids=[f"missing{m}-{'left' if d else 'right'}{'-efb' if e else ''}"
                              for m, d, e in TABLES])
def test_go_left_table_matches_split_decision_bins(jax_ref, missing_type, default_left, efb):
    """The 256-entry table against the per-row decision of both packages on
    every group bin value, each missing type, default_left both ways, and a
    feature bundled at group bins [lo, hi) of an EFB group."""
    import jax.numpy as jnp
    from lightgbm_tpu.ops.partition import split_decision_bins as jax_decision

    decision = (11.0, float(default_left), float(missing_type), 4.0, 30.0,
                *((40.0, 69.0, 1.0) if efb else (0.0, 0.0, 0.0)))
    table = go_left_table(decision)
    assert table.shape == (256,) and table.dtype == bool
    every = torch.arange(256, dtype=torch.int32)
    np.testing.assert_array_equal(table, split_decision_bins(every, decision).numpy())
    np.testing.assert_array_equal(
        table, np.asarray(jax_decision(jnp.arange(256, dtype=jnp.int32),
                                       jnp.asarray(decision, jnp.float32))))
    assert table.any() and not table.all()


def _decisions(rng, n):
    """n random numeric decisions over 40-bin features, EFB ones included."""
    out = []
    for _ in range(n):
        mt, efb = int(rng.randint(0, 3)), rng.rand() < 0.3
        out.append((float(rng.randint(0, 39)), float(rng.rand() < 0.5), float(mt),
                    float(rng.randint(0, 40)), 40.0,
                    *((5.0, 44.0, 1.0) if efb else (0.0, 0.0, 0.0))))
    return out


@pytest.mark.parametrize("bagged", [False, True], ids=["all_rows", "bagged"])
@pytest.mark.parametrize("seed", [0, 1])
def test_row_partition_split_sequence_matches_jax(jax_ref, bagged, seed):
    """A tree's worth of splits (each on the largest or a random leaf, on
    random group rows and decisions) through the port's RowPartition and the
    JAX one: the same counts and the same padded index sets after every
    split, trimmed children or views alike."""
    import jax.numpy as jnp
    from lightgbm_tpu.ops.partition import RowPartition as JaxRowPartition

    rng = np.random.RandomState(seed)
    n = 5000
    plane = rng.randint(0, 50, size=(4, n)).astype(np.uint8)
    port, ref = RowPartition(n, "cpu"), JaxRowPartition(n)
    if bagged:
        bag = np.sort(rng.choice(n, 3700, replace=False)).astype(np.int32)
        port.set_used_indices(bag)
        ref.set_used_indices(bag)
    leaves, trimmed = 1, 0
    for decision in _decisions(rng, 14):
        counts = {leaf: port.count(leaf) for leaf in range(leaves)}
        leaf = (max(counts, key=counts.get) if rng.rand() < 0.5
                else int(rng.randint(0, leaves)))
        g = int(rng.randint(0, 4))
        parent = port.indices(leaf).shape[0]
        got = port.split(leaf, leaves, torch.from_numpy(plane[g]), decision)
        assert got == ref.split(leaf, leaves, jnp.asarray(plane[g]),
                                jnp.asarray(decision, jnp.float32))
        for child in (leaf, leaves):
            idx = port.indices(child)
            assert idx.dtype == torch.int32
            assert idx.shape[0] == bucket_size(port.count(child))
            np.testing.assert_array_equal(idx.numpy(), np.asarray(ref.indices(child)))
            trimmed += RowPartition.TRIM * idx.shape[0] <= parent
        leaves += 1
    assert trimmed > 0


def test_split_rows_edges():
    """All rows left, all right, no rows, and the plain version's children
    equal to a stable sort of the positions by side."""
    rng = np.random.RandomState(9)
    bins_row = torch.from_numpy(rng.randint(0, 256, size=N).astype(np.uint8))
    idx = torch.full((2048,), N, dtype=torch.int32)
    idx[:1200] = torch.from_numpy(np.sort(rng.choice(N, 1200, replace=False)))
    for table, n_left in ((np.ones(256, bool), 1200), (np.zeros(256, bool), 0)):
        left, right, nl = split_rows(bins_row, idx, 1200, table, N)
        assert int(nl) == n_left
        full, empty = (left, right) if n_left else (right, left)
        assert torch.equal(full, idx) and bool((empty == N).all())
    left, right, nl = split_rows(bins_row, idx, 0, np.ones(256, bool), N)
    assert int(nl) == 0 and bool((left == N).all()) and bool((right == N).all())
    table = rng.rand(256) < 0.5
    left, right, nl = _split_rows_plain(bins_row, idx, 1200, table, N)
    side = torch.from_numpy(~table)[bins_row[idx[:1200].long()].long()]
    order = idx[:1200][torch.argsort(side.to(torch.int8), stable=True)]
    nl = int(nl)
    assert torch.equal(left[:nl], order[:nl]) and torch.equal(right[:1200 - nl], order[nl:])


def test_row_partition_split_and_bagging(jax_ref):
    from lightgbm_tpu.ops.partition import RowPartition as JaxRowPartition
    import jax.numpy as jnp

    bins_row, rng = _bins(7)
    bag = np.sort(rng.choice(N, 1000, replace=False)).astype(np.int32)
    port, ref = RowPartition(N, "cpu"), JaxRowPartition(N)
    port.set_used_indices(bag)
    ref.set_used_indices(bag)
    decision = (20.0, 0.0, 0.0, 0.0, 40.0, 0.0, 0.0, 0.0)
    counts = port.split(0, 1, torch.from_numpy(bins_row), decision)
    assert counts == ref.split(0, 1, jnp.asarray(bins_row),
                               jnp.asarray(decision, jnp.float32))
    for leaf in (0, 1):
        np.testing.assert_array_equal(port.indices(leaf).numpy(),
                                      np.asarray(ref.indices(leaf)))
        assert port.indices(leaf).dtype == torch.int32


def test_add_tree_to_score_matches_jax(jax_ref):
    """Out-of-bag rows scored by walking a trained tree over the bin plane."""
    import jax.numpy as jnp
    from lightgbm_tpu.io.dataset import Dataset as JaxDataset
    from lightgbm_tpu.ops.score import add_tree_to_score as jax_add

    import lightgbm_tpu_torch as lt

    rng = np.random.RandomState(3)
    X = rng.normal(size=(N, 5))
    X[rng.rand(N, 5) < 0.05] = np.nan
    y = (X[:, 0] > 0).astype(np.float64)
    bst = lt.train({"objective": "binary", "num_leaves": 15, "device_type": "cpu",
                    "feature_fraction_bynode": 0.8, "verbosity": -1},
                   lt.Dataset(X, label=y), num_boost_round=1)
    tree = bst._gbdt.models[0]
    ds, jds = Dataset.from_matrix(X, label=y), JaxDataset.from_matrix(X, label=y)
    score = rng.normal(size=N).astype(np.float32)
    rows = np.full(1024, N, np.int32)
    rows[:700] = np.sort(rng.choice(N, 700, replace=False))
    got = add_tree_to_score(tree, ds, torch.from_numpy(ds.bins),
                            torch.from_numpy(score), torch.from_numpy(rows), N, 14)
    want = jax_add(tree, jds, jnp.asarray(jds.bins), jnp.asarray(score),
                   jnp.asarray(rows), N, 14)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # walked in bin space, every training row lands in the leaf that the
    # traversal of its raw values finds
    walked = add_tree_to_score(tree, ds, torch.from_numpy(ds.bins),
                               torch.zeros(N), torch.arange(N, dtype=torch.int32), N)
    np.testing.assert_array_equal(walked.numpy(), bst.predict(X, raw_score=True))
