"""The CUDA forest-traversal kernel against its plain PyTorch version, in
both of its plans: every block walking all trees (large batches) and the
trees split across blocks with a second summing pass (serving batches).

Marked `gpu`: these need an NVIDIA card with nvcc, and skip elsewhere.
Run them on the card with `python -m pytest -m gpu tests/test_torch_cuda.py`.
Whether a card is present is decided inside the fixture, never at import,
so every test worker collects the same tests.
"""
import functools

import numpy as np
import pytest
import torch

from lightgbm_tpu_torch import Booster
from lightgbm_tpu_torch.models.synthetic import make_rows, random_model
from lightgbm_tpu_torch.ops import predict_cuda
from lightgbm_tpu_torch.ops.predict import (_predict_raw_fused, _traverse_leaves,
                                            pack_ensemble)
from lightgbm_tpu_torch.ops.predict_cuda import forest_plan

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m gpu on the card)")
    return torch.device("cuda")


def _cases():
    """(name, model, cat_features, n_features): binary, multiclass with
    categorical splits, stumps and constant trees, and a wide model whose
    row tile does not fit in shared memory (the unstaged kernel path)."""
    return [
        ("binary", random_model(np.random.RandomState(0), 28, 40, 63), (), 28),
        ("multiclass_cat", random_model(
            np.random.RandomState(1), 12, 10, 31, num_class=3,
            cat_features=(2, 7), objective="multiclass num_class:3"), (2, 7), 12),
        ("stumps", random_model(np.random.RandomState(2), 8, 30, 15,
                                stump_every=3), (), 8),
        ("wide", random_model(np.random.RandomState(3), 200, 10, 31), (), 200),
    ]


@pytest.mark.parametrize("case", range(4))
def test_kernel_matches_plain(cuda, case):
    name, model, cats, F = _cases()[case]
    C = model.num_tree_per_iteration
    packed = pack_ensemble(model.trees, device=cuda)
    X = torch.from_numpy(make_rows(np.random.RandomState(10 + case), 5000, F,
                                   cats)).to(cuda)
    before = dict(predict_cuda.launches)
    leaf = predict_cuda.forest_leaf_indices(packed, X)
    raw = predict_cuda.forest_raw(packed, X, C)
    raw_again = predict_cuda.forest_raw(packed, X, C)
    torch.cuda.synchronize()
    assert predict_cuda.launches["predict_forest_leaf"] == before["predict_forest_leaf"] + 1
    assert predict_cuda.launches["predict_forest_raw"] == before["predict_forest_raw"] + 2
    ref_leaf = _traverse_leaves(packed, X)
    ref_raw = _predict_raw_fused(packed, X, C)
    assert torch.equal(leaf, ref_leaf), name
    assert torch.equal(raw, raw_again), name
    # same leaves, same float32 summation order: the sums agree bit for bit
    assert torch.equal(raw, ref_raw), name


def test_booster_on_card_matches_cpu(cuda):
    model = random_model(np.random.RandomState(4), 10, 20, 31, num_class=3,
                         cat_features=(1,), objective="multiclass num_class:3")
    text = model.to_string()
    X = make_rows(np.random.RandomState(5), 3000, 10, (1,))
    card = Booster(model_str=text)
    host = Booster(model_str=text, params={"device_type": "cpu"})
    assert card.device.type == "cuda"
    np.testing.assert_array_equal(card.predict(X, pred_leaf=True),
                                  host.predict(X, pred_leaf=True))
    np.testing.assert_array_equal(card.predict(X, raw_score=True),
                                  host.predict(X, raw_score=True))
    np.testing.assert_allclose(card.predict(X), host.predict(X),
                               rtol=1e-6, atol=1e-7)


def test_wrapper_rejects_bad_input(cuda):
    model = random_model(np.random.RandomState(6), 4, 3, 7)
    packed = pack_ensemble(model.trees, device=cuda)
    X = torch.zeros((8, 4), dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        predict_cuda.forest_raw(packed, X, 1)
    with pytest.raises(ValueError, match="columns"):
        predict_cuda.forest_raw(packed, torch.zeros((8, 2), device=cuda), 1)
    host_pack = pack_ensemble(model.trees)
    with pytest.raises(ValueError, match="packed table"):
        predict_cuda.forest_raw(host_pack, torch.zeros((8, 4), device=cuda), 1)


@functools.lru_cache(maxsize=None)
def _serving_models():
    """A 255-leaf binary model of 37 trees (not a multiple of any tree
    tile), a multiclass-3 categorical one, and one whose 2047-leaf trees are
    too large to stage in shared memory (read from global memory)."""
    return [
        ("higgs_like", random_model(np.random.RandomState(7), 28, 37, 255), (), 28),
        ("multiclass_cat", random_model(
            np.random.RandomState(8), 12, 9, 31, num_class=3, cat_features=(3, 7),
            objective="multiclass num_class:3"), (3, 7), 12),
        ("big_trees", random_model(np.random.RandomState(9), 10, 3, 2047,
                                   sample_rows=16384), (), 10),
    ]


@pytest.mark.parametrize("n", [1, 64, 4096, 40000])
@pytest.mark.parametrize("case", range(3))
def test_kernel_bit_equal_at_batch_sizes(cuda, case, n):
    """Serving sizes take the split plan, 40,000 rows the all-trees plan:
    leaf indices equal and raw scores bit-equal to the plain version, and
    two launches bit-equal."""
    name, model, cats, F = _serving_models()[case]
    C = model.num_tree_per_iteration
    packed = pack_ensemble(model.trees, device=cuda)
    plan = forest_plan(n, packed.num_trees, F, packed.records.shape[1])
    assert plan.split == (n < 40000)
    assert plan.stage_trees == (name != "big_trees")
    X = torch.from_numpy(make_rows(np.random.RandomState(n + case), n, F, cats)).to(cuda)
    raw = predict_cuda.forest_raw(packed, X, C)
    again = predict_cuda.forest_raw(packed, X, C)
    leaf = predict_cuda.forest_leaf_indices(packed, X)
    torch.cuda.synchronize()
    assert torch.equal(raw, again), name
    assert torch.equal(leaf, _traverse_leaves(packed, X)), name
    assert torch.equal(raw, _predict_raw_fused(packed, X, C)), name


def test_kernel_empty_batch(cuda):
    model = random_model(np.random.RandomState(11), 6, 4, 7)
    packed = pack_ensemble(model.trees, device=cuda)
    X = torch.zeros((0, 6), dtype=torch.float32, device=cuda)
    assert predict_cuda.forest_raw(packed, X, 1).shape == (0, 1)
    assert predict_cuda.forest_leaf_indices(packed, X).shape == (0, 4)
