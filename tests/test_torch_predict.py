"""The port's ops/predict.py against the JAX package's, on the CPU.

The same model text and the same float32 inputs (made with numpy from a
seed) go through both packages: the packed tables must be equal, leaf
indices exactly equal, and raw scores within the float32 summation bound.
"""
import numpy as np
import pytest
import torch

from lightgbm_tpu_torch.common import MISSING_NAN, MISSING_NONE, MISSING_ZERO
from lightgbm_tpu_torch.models.serialize import GBDTModel
from lightgbm_tpu_torch.models.synthetic import make_rows, random_model
from lightgbm_tpu_torch.models.tree import Tree
from lightgbm_tpu_torch.ops.predict import (TABLES, pack_ensemble,
                                            packed_from_numpy,
                                            predict_leaf_indices, predict_raw)
from lightgbm_tpu_torch.utils.log import LightGBMError
from tests.test_torch_ref import jax_ref  # noqa: F401

CASES = ("nan_zero_cat", "stumps", "multiclass3", "threshold_edges")


def _edge_trees():
    """Hand-built trees: a NaN-missing default-left root over a categorical
    node (bitset {1, 2}), a zero-missing node, and thresholds that float32
    cannot hold (so the round-toward--inf downcast decides)."""
    a = Tree(max_leaves=3)
    right = a.split(leaf=0, feature_inner=0, real_feature=0, threshold_bin=1,
                    threshold_double=0.1, default_left=True,
                    missing_type=MISSING_NAN, gain=1.0, left_value=-1.0,
                    right_value=1.0, left_count=1, right_count=1,
                    left_weight=1.0, right_weight=1.0, parent_value=0.0)
    a.split_categorical(leaf=right, feature_inner=1, real_feature=1,
                        bin_bitset=[0b110], value_bitset=[0b110],
                        missing_type=MISSING_NONE, gain=1.0, left_value=5.0,
                        right_value=7.0, left_count=1, right_count=1,
                        left_weight=1.0, right_weight=1.0, parent_value=1.0)
    b = Tree(max_leaves=3)
    left = b.split(leaf=0, feature_inner=2, real_feature=2, threshold_bin=1,
                   threshold_double=-0.3, default_left=False,
                   missing_type=MISSING_ZERO, gain=1.0, left_value=0.25,
                   right_value=-0.5, left_count=1, right_count=1,
                   left_weight=1.0, right_weight=1.0, parent_value=0.0)
    del left
    b.split(leaf=0, feature_inner=3, real_feature=3, threshold_bin=1,
            threshold_double=1.0 / 3.0, default_left=True,
            missing_type=MISSING_NONE, gain=1.0, left_value=2.0,
            right_value=3.0, left_count=1, right_count=1, left_weight=1.0,
            right_weight=1.0, parent_value=0.25)
    return [a, b, a, b]


def _thresholds_in_rows(X, trees, rng):
    """Write each numerical threshold's float32 neighbours (below, the
    nearest float32, above) into random rows of its feature column."""
    for tree in trees:
        for node in range(tree.num_leaves - 1):
            if int(tree.decision_type[node]) & 1:
                continue
            f = int(tree.split_feature[node])
            t32 = np.float32(tree.threshold[node])
            for v in (np.nextafter(t32, np.float32(-np.inf)), t32,
                      np.nextafter(t32, np.float32(np.inf))):
                X[rng.randint(X.shape[0]), f] = v
    return X


def _case(name):
    """(model text, X) for one case."""
    rng = np.random.RandomState(CASES.index(name))
    if name == "nan_zero_cat":
        model = random_model(rng, 8, 12, 15, cat_features=(3,))
        X = make_rows(rng, 400, 8, (3,), nan_frac=0.05, zero_frac=0.05)
    elif name == "stumps":
        model = random_model(rng, 5, 12, 7, stump_every=2,
                             objective="regression")
        X = make_rows(rng, 300, 5)
    elif name == "multiclass3":
        model = random_model(rng, 9, 6, 15, num_class=3, cat_features=(0, 4),
                             objective="multiclass num_class:3")
        X = make_rows(rng, 400, 9, (0, 4), nan_frac=0.03, zero_frac=0.03)
    else:
        model = GBDTModel()
        model.max_feature_idx = 3
        model.feature_names = [f"f{i}" for i in range(4)]
        model.feature_infos = ["none"] * 4
        model.trees = _edge_trees()
        X = make_rows(rng, 200, 4, (1,), nan_frac=0.1, zero_frac=0.1)
        X[:5, 2] = [0.0, -0.0, 1e-36, -1e-36, 1e-30]
    X = _thresholds_in_rows(X, model.trees, rng)
    return model.to_string(), model.num_tree_per_iteration, X


def _jax_pack(text):
    from lightgbm_tpu.models.serialize import GBDTModel as JaxModel
    from lightgbm_tpu.ops.predict import pack_ensemble as jax_pack

    return jax_pack(JaxModel.from_string(text).trees)


def _row_bound(packed, leaf):
    """Per-row bound between two float32 summation orders of the row's T
    leaf values v_t: |a - b| <= T * 2**-24 * sum_t |v_t| (each order makes
    at most T roundings, each at most 2**-24 of a partial sum no larger
    than sum |v_t|)."""
    T, L = packed.leaf_value.shape
    vals = packed.leaf_value.double().reshape(-1)[
        torch.arange(T)[None, :] * L + leaf.long()]
    return T * 2.0 ** -24 * vals.abs().sum(dim=1, keepdim=True).numpy()


@pytest.mark.parametrize("name", CASES)
def test_pack_tables_equal(jax_ref, name):
    text, _, _ = _case(name)
    ref = _jax_pack(text)
    ours = pack_ensemble(GBDTModel.from_string(text).trees)
    assert ours.max_depth == ref.max_depth
    assert ours.num_trees == ref.num_trees
    for table in TABLES:
        want = np.asarray(getattr(ref, table))
        got = getattr(ours, table).numpy()
        if table == "cat_words":
            got = got.view(np.uint32)
        assert got.dtype == want.dtype, table
        np.testing.assert_array_equal(got, want, err_msg=table)
    # the JAX pack carried across as numpy arrays is the port's own pack
    carried = packed_from_numpy([np.asarray(getattr(ref, t)) for t in TABLES],
                                max_depth=ref.max_depth,
                                num_trees=ref.num_trees)
    for table in TABLES:
        assert torch.equal(getattr(carried, table), getattr(ours, table)), table


@pytest.mark.parametrize("name", CASES)
def test_leaf_indices_exact(jax_ref, name):
    import jax.numpy as jnp
    from lightgbm_tpu.ops.predict import predict_leaf_indices as jax_leaves

    text, _, X = _case(name)
    want = np.asarray(jax_leaves(_jax_pack(text), jnp.asarray(X)))
    ours = pack_ensemble(GBDTModel.from_string(text).trees)
    got = predict_leaf_indices(ours, torch.from_numpy(X)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", CASES)
def test_raw_scores_within_summation_bound(jax_ref, name):
    import jax.numpy as jnp
    from lightgbm_tpu.ops.predict import _predict_raw_fused
    from lightgbm_tpu.ops.predict_pallas import pallas_predict_raw

    text, C, X = _case(name)
    ref = _jax_pack(text)
    xj = jnp.asarray(X)
    fused = np.asarray(_predict_raw_fused(ref, xj, C))
    pallas = np.asarray(pallas_predict_raw(ref, xj, C, tile_rows=128,
                                           interpret=True))
    ours = pack_ensemble(GBDTModel.from_string(text).trees)
    xt = torch.from_numpy(X)
    got = predict_raw(ours, xt, C).numpy()
    bound = _row_bound(ours, predict_leaf_indices(ours, xt))
    assert got.shape == fused.shape == (X.shape[0], C)
    assert np.isfinite(got).all()
    for want in (fused, pallas):
        assert (np.abs(got.astype(np.float64) - want) <= bound).all()


def test_ragged_tree_count_is_fatal():
    model = random_model(np.random.RandomState(0), 3, 5, 4)
    packed = pack_ensemble(model.trees)
    with pytest.raises(LightGBMError, match="whole iterations"):
        predict_raw(packed, torch.zeros((3, 3)), num_tree_per_iteration=2)


def _record_cases():
    """(name, model, cat_features, n_features, rows): the HIGGS profile at
    small size (13 trees: not a multiple of any tree tile), multiclass with
    categorical splits, and constant and stump trees."""
    return [
        ("higgs_profile", random_model(np.random.RandomState(20), 28, 13, 63), (), 28, 600),
        ("multiclass_cat", random_model(np.random.RandomState(21), 10, 5, 15, num_class=3,
                                        cat_features=(2, 6),
                                        objective="multiclass num_class:3"), (2, 6), 10, 500),
        ("stumps", random_model(np.random.RandomState(22), 6, 11, 7, stump_every=3,
                                objective="regression"), (), 6, 300),
    ]


@pytest.mark.parametrize("case", range(3), ids=["higgs_profile", "multiclass_cat", "stumps"])
def test_record_walk_matches_tables_and_jax(jax_ref, case):
    """The CUDA kernel's packed node records, walked plainly, reach the leaves
    of the table walk and of the JAX package's traversal."""
    import jax.numpy as jnp
    from lightgbm_tpu.ops.predict import predict_leaf_indices as jax_leaves

    from lightgbm_tpu_torch.ops.predict import _traverse_leaves, _traverse_records

    name, model, cats, F, n = _record_cases()[case]
    text = model.to_string()
    X = make_rows(np.random.RandomState(30 + case), n, F, cats, nan_frac=0.05,
                  zero_frac=0.05)
    X = _thresholds_in_rows(X, model.trees, np.random.RandomState(40 + case))
    packed = pack_ensemble(GBDTModel.from_string(text).trees)
    T, I = packed.split_feature.shape
    assert packed.records.shape[0] == T and packed.records.shape[1] % 4 == 0
    assert packed.records.shape[1] >= 4 * I + packed.leaf_value.shape[1]
    xt = torch.from_numpy(X)
    got = _traverse_records(packed, xt)
    assert torch.equal(got, _traverse_leaves(packed, xt)), name
    want = np.asarray(jax_leaves(_jax_pack(text), jnp.asarray(X)))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", CASES)
def test_record_walk_on_edge_trees(name):
    """The records of the hand-built edge trees (NaN/zero missing, bitsets,
    thresholds float32 cannot hold) and of a pack carried across from tables
    walk to the table walk's leaves; leaf values follow the node records."""
    from lightgbm_tpu_torch.ops.predict import (RECORD_WORDS, _traverse_leaves,
                                                _traverse_records)

    text, _, X = _case(name)
    packed = pack_ensemble(GBDTModel.from_string(text).trees)
    xt = torch.from_numpy(X)
    assert torch.equal(_traverse_records(packed, xt), _traverse_leaves(packed, xt))
    carried = packed_from_numpy([getattr(packed, t).numpy() for t in TABLES],
                                max_depth=packed.max_depth, num_trees=packed.num_trees)
    assert torch.equal(carried.records, packed.records)
    assert torch.equal(carried.cat_table, packed.cat_table)
    T, I = packed.split_feature.shape
    L = packed.leaf_value.shape[1]
    leaves = packed.records[:, RECORD_WORDS * I:RECORD_WORDS * I + L].contiguous()
    assert torch.equal(leaves.view(torch.float32), packed.leaf_value)


def test_forest_plan():
    """Serving batches split the trees across blocks, large batches walk all
    trees in every block; which plan depends on N and T alone, and what is
    staged fits the shared-memory budgets."""
    from lightgbm_tpu_torch.ops.predict_cuda import (MAX_THREADS, TREE_BUDGET, X_BUDGET,
                                                     forest_plan)

    R = 4 * 254 + 256  # a 255-leaf tree's blob
    for n, split in ((1, True), (64, True), (4096, True), (16384, True),
                     (65536, False), (1 << 18, False)):
        plans = {forest_plan(n, 500, F, rec).split
                 for F in (4, 28, 2000) for rec in (8, R, 1 << 14)}
        assert plans == {split}, n
        plan = forest_plan(n, 500, 28, R)
        assert plan.stage_x and plan.stage_trees
        assert plan.tile_trees == min(4, plan.trees_per_block)
        assert 32 <= plan.rows_per_block <= MAX_THREADS and plan.rows_per_block % 32 == 0
        # csrc/predict_forest.cu: two tree-tile buffers and X's row tile
        assert 2 * plan.tile_trees * R * 4 <= TREE_BUDGET
        assert plan.rows_per_block * 28 * 4 <= X_BUDGET
        blocks = -(-n // plan.rows_per_block) * -(-500 // plan.trees_per_block)
        if split:
            assert blocks >= 264, n  # a 64-row request still fills the card
        else:
            assert plan.trees_per_block == 500
    assert not forest_plan(4096, 500, 2000, R).stage_x           # X too wide: global
    assert not forest_plan(4096, 10, 28, 4 * 2046 + 2048).stage_trees  # 2047 leaves
    assert forest_plan(10, 7, 28, R).trees_per_block * 7 >= 7


def test_forest_wrapper_checks():
    from lightgbm_tpu_torch.ops import predict_cuda

    model = random_model(np.random.RandomState(6), 4, 3, 7)
    packed = pack_ensemble(model.trees)
    predict_cuda._check(packed, torch.zeros((8, 4)))
    with pytest.raises(ValueError, match="float32"):
        predict_cuda._check(packed, torch.zeros((8, 4), dtype=torch.float64))
    with pytest.raises(ValueError, match="columns"):
        predict_cuda._check(packed, torch.zeros((8, 2)))
    with pytest.raises(ValueError, match="packed table"):
        predict_cuda._check(packed, torch.zeros((8, 4), device="meta"))
    bad = pack_ensemble(model.trees)
    bad.records = bad.records[:, :8].contiguous()
    with pytest.raises(ValueError, match="records"):
        predict_cuda._check(bad, torch.zeros((8, 4)))
    with pytest.raises(ValueError, match="cpu or cuda"):
        predict_cuda.forest_raw(packed, torch.zeros((8, 4), device="meta"), 1)
