"""The port's row partition and bin-space score update against the JAX
package's: the same padded index sets (exact: a stable partition of
integers) and the same float32 score updates (exact: one add per row)."""
import numpy as np
import pytest
import torch

from lightgbm_tpu_torch.io.dataset import Dataset
from lightgbm_tpu_torch.ops.partition import RowPartition, partition_rows
from lightgbm_tpu_torch.ops.score import add_tree_to_score
from tests.test_torch_ref import jax_ref  # noqa: F401

N = 1500


def _bins(seed):
    rng = np.random.RandomState(seed)
    return rng.randint(0, 40, size=N).astype(np.uint8), rng


@pytest.mark.parametrize("missing_type,default_left", [(0, False), (1, True),
                                                       (2, False), (2, True)])
def test_partition_rows_match_jax(jax_ref, missing_type, default_left):
    import jax.numpy as jnp
    from lightgbm_tpu.ops.partition import partition_rows as jax_partition_rows

    bins_row, rng = _bins(missing_type)
    rows = np.sort(rng.choice(N, 900, replace=False)).astype(np.int32)
    idx = np.full(1024, N, np.int32)
    idx[:900] = rows
    decision = (17.0, float(default_left), float(missing_type), 3.0, 40.0,
                0.0, 0.0, 0.0)
    got, left = partition_rows(torch.from_numpy(bins_row), torch.from_numpy(idx),
                               900, decision, N)
    want, want_left = jax_partition_rows(
        jnp.asarray(bins_row), jnp.asarray(idx), jnp.asarray(900, jnp.int32),
        jnp.asarray(decision, jnp.float32), N)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(left) == int(want_left)


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
