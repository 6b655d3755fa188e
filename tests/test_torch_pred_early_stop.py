"""Prediction early stopping (`ops/predict.py:predict_raw_early_stop`,
`Booster.predict(pred_early_stop=True)`) against the JAX package's
`predict_raw_early_stop`, on the CPU.

Models: random forests from the seed (`models/synthetic.py`), binary (40
trees) and 3-class (20 iterations), 15 leaves, categorical splits in the
3-class one; 500 rows with NaN and zeros.

Contracts:

* against the JAX function, binary (margin 2 |score|) and 3-class (the
  top-two gap), round periods 5 and 10: the same rows stop after the same
  blocks, and the scores agree within rtol 1e-5 / atol 1e-5 (the JAX
  package adds each block's XLA sum onto the running score, the port
  continues each row's chain of float32 adds); each margin is the midpoint
  of two neighbouring values among every row's margins at every block's
  end, near a target, at least 1e-4 from both: far from any margin
  either package's sums could round onto;
* an infinite margin gives the plain predict's scores bit for bit, and so
  does a margin no row reaches; a margin of 0 stops every row after the
  first block;
* `Booster.predict` with pred_early_stop, pred_early_stop_freq and
  pred_early_stop_margin (as keyword arguments or Booster parameters)
  equals the function, raw and converted;
* `PackedEnsemble.tree_slice` is a view of the pack (no copy), and the
  traversal's accumulate mode continues a running sum: a forest
  traversed in two slices, the second added onto the first's sums, equals
  the whole traversal bit for bit.
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.models.synthetic import make_rows, random_model
from lightgbm_tpu_torch.ops import predict_cuda
from lightgbm_tpu_torch.ops.predict import (pack_ensemble, predict_raw,
                                            predict_raw_early_stop)
from tests.test_torch_ref import jax_ref  # noqa: F401

N, F = 500, 8
CASES = {"binary": (1, (), "binary sigmoid:1", 40),
         "multiclass": (3, (2,), "multiclass num_class:3", 20)}
MARGINS = {"binary": 1.5, "multiclass": 0.6}


def _clear_margin(packed, X, C, freq, target):
    """A threshold between two neighbouring block-end margins of the rows
    (every row's, whether it would still be active or not), next to
    `target`."""
    sums = torch.zeros((X.shape[0], C), dtype=torch.float32)
    margins = []
    for start in range(0, packed.num_trees, freq * C):
        predict_raw(packed.tree_slice(start, min(start + freq * C, packed.num_trees)), X, C,
                    out=sums, accumulate=True)
        top = torch.topk(sums, min(C, 2), dim=1).values
        margins.append((2 * top[:, 0].abs() if C == 1 else top[:, 0] - top[:, 1]).numpy())
    m = np.unique(np.concatenate(margins).astype(np.float64))
    i = int(np.searchsorted(m, target))
    lo, hi = m[i - 1], m[i]
    assert hi - lo >= 2e-4, (lo, hi)
    return float((lo + hi) / 2)


def _model(case, seed=0):
    C, cats, objective, iters = CASES[case]
    model = random_model(np.random.RandomState(seed), F, iters, 15, num_class=C,
                         cat_features=cats, objective=objective)
    X = make_rows(np.random.RandomState(seed + 1), N, F, cats)
    return model, X, C


@pytest.mark.parametrize("freq", [5, 10])
@pytest.mark.parametrize("case", list(CASES))
def test_matches_jax(jax_ref, case, freq):
    import jax.numpy as jnp
    from lightgbm_tpu.models.serialize import GBDTModel as JaxModel
    from lightgbm_tpu.ops.predict import (pack_ensemble as jax_pack,
                                          predict_raw_early_stop as jax_early_stop)

    model, X, C = _model(case)
    packed = pack_ensemble(model.trees)
    jpacked = jax_pack(JaxModel.from_string(model.to_string()).trees)
    Xt = torch.from_numpy(X)
    margin = _clear_margin(packed, Xt, C, freq, MARGINS[case])
    got = predict_raw_early_stop(packed, Xt, C, freq, margin).numpy()
    want = np.asarray(jax_early_stop(jpacked, jnp.asarray(X), C, freq, margin))
    full = predict_raw(packed, Xt, C).numpy()
    stopped = ~np.all(got == full, axis=1)
    assert 0.05 < stopped.mean() < 0.95
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", list(CASES))
def test_infinite_margin_is_the_plain_predict_bit_for_bit(case):
    model, X, C = _model(case, seed=3)
    packed = pack_ensemble(model.trees)
    Xt = torch.from_numpy(X)
    full = predict_raw(packed, Xt, C)
    for margin in (float("inf"), 1e30):
        for freq in (3, 100):
            assert torch.equal(predict_raw_early_stop(packed, Xt, C, freq, margin), full)
    first = predict_raw(packed.tree_slice(0, 2 * C), Xt, C)
    assert torch.equal(predict_raw_early_stop(packed, Xt, C, 2, 0.0), first)


@pytest.mark.parametrize("case", list(CASES))
def test_booster_predict_with_pred_early_stop(case):
    model, X, C = _model(case, seed=5)
    text = model.to_string()
    bst = lt.Booster(model_str=text, params={"device_type": "cpu"})
    packed = pack_ensemble(model.trees)
    want = predict_raw_early_stop(packed, torch.from_numpy(X), C, 4, MARGINS[case]).numpy()
    got = bst.predict(X, raw_score=True, pred_early_stop=True, pred_early_stop_freq=4,
                      pred_early_stop_margin=MARGINS[case])
    np.testing.assert_array_equal(got, want[:, 0] if C == 1 else want)
    by_params = lt.Booster(model_str=text, params={
        "device_type": "cpu", "pred_early_stop": True, "pred_early_stop_freq": 4,
        "pred_early_stop_margin": MARGINS[case]})
    np.testing.assert_array_equal(by_params.predict(X, raw_score=True), got)
    converted = by_params.predict(X)
    expect = bst._gbdt.objective.convert_output(torch.from_numpy(want)).numpy()
    np.testing.assert_array_equal(converted, expect[:, 0] if C == 1 else expect)
    never = bst.predict(X, raw_score=True, pred_early_stop=True, pred_early_stop_margin=1e30)
    np.testing.assert_array_equal(never, bst.predict(X, raw_score=True))


def test_tree_slice_is_a_view_and_accumulate_continues_the_chain():
    model, X, C = _model("multiclass", seed=7)
    packed = pack_ensemble(model.trees)
    part = packed.tree_slice(3 * C, 9 * C)
    assert part.num_trees == 6 * C
    assert part.records.data_ptr() == packed.records[3 * C].data_ptr()
    assert part.cat_table is packed.cat_table
    Xt = torch.from_numpy(X)
    head = predict_cuda.forest_raw(packed.tree_slice(0, 4 * C), Xt, C)
    both = predict_cuda.forest_raw(packed.tree_slice(4 * C, packed.num_trees), Xt, C,
                                   out=head.clone(), accumulate=True)
    assert torch.equal(both, predict_raw(packed, Xt, C))
    with pytest.raises(ValueError, match="running sums"):
        predict_cuda.forest_raw(packed, Xt, C, accumulate=True)
