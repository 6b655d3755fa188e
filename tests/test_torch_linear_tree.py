"""Linear trees (linear_tree) through the port: the per-leaf fits on the
host, the GBDT's train and valid scores through the linear predictor, and
linear-tree prediction, against the JAX package at device_type=cpu.

Contracts:

* `treelearner/linear.py:fit_leaf_linear_models`: on the same tree, rows,
  gradients and hessians the leaves' constants, features and coefficients
  are the JAX package's bit for bit (the same float64 numpy);
* training on snapped `fobj` gradients, bagging off, on the JAX package's
  tests/test_linear_tree.py data with NaN rows (the fallback to the
  constant leaf): the model text byte-equal to the JAX serial learner's
  with its search run op by op;
* prediction: a linear model trained by the JAX package (8 trees, at
  most 3 features a leaf, NaN and infinite model features), loaded into
  the port from its text, predicts bit for bit what the JAX `predict`
  does: the port sums a leaf's K terms, then the trees, one float32 add at
  a time in order, and on this model XLA's CPU reductions sum in that
  order too (in general only rtol 1e-6 is promised, which the test also
  states). The packed linear tables equal the JAX pack's;
* the port alone: the train score equals predict(raw_score=True) within
  1e-5, the model round-trips bit-equal, and a linear model beats constant
  leaves on piecewise-linear data;
* refusals that stay: sparse input with linear_tree, regression_l1 with
  linear_tree.
"""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.io.dataset import Dataset as CoreDataset
from lightgbm_tpu_torch.models.serialize import GBDTModel
from lightgbm_tpu_torch.ops.predict import pack_ensemble, predict_raw
from lightgbm_tpu_torch.treelearner.linear import fit_leaf_linear_models
from lightgbm_tpu_torch.utils.log import LightGBMError
from tests.test_torch_constraints import _op_by_op, snapped_l2
from tests.test_torch_ref import jax_ref  # noqa: F401


def _piecewise_linear(seed=42, n=3000, nan_rows=0):
    """tests/test_linear_tree.py's data: a different slope in x1 on each
    side of x0 = 0; with nan_rows, every nan_rows-th row's x1 is NaN."""
    rng = np.random.RandomState(seed)
    X = rng.uniform(-2, 2, size=(n, 3))
    y = np.where(X[:, 0] > 0, 2.0 * X[:, 1] + 1.0, -1.5 * X[:, 1]) \
        + 0.5 * X[:, 2] + rng.randn(n) * 0.05
    if nan_rows:
        X[::nan_rows, 1] = np.nan
    return X, y


def _params(**extra):
    return {"objective": "regression", "num_leaves": 7, "linear_tree": True,
            "linear_lambda": 0.01, "device_type": "cpu", "verbosity": -1, **extra}


def test_leaf_fits_bit_equal_to_jax(jax_ref):
    from lightgbm_tpu.models.serialize import GBDTModel as JModel
    from lightgbm_tpu.treelearner.linear import fit_leaf_linear_models as jfit

    X, y = _piecewise_linear(n=1500, nan_rows=40)
    bst = lt.train(_params(), lt.Dataset(X, label=y), num_boost_round=3)
    ds = CoreDataset.from_matrix(X, label=y, config=Config(_params()))
    raw = X.astype(np.float32)
    rng = np.random.RandomState(1)
    grad = (rng.normal(size=len(X)) * 0.5).astype(np.float32)
    hess = rng.uniform(0.5, 1.5, len(X)).astype(np.float32)
    text = bst.model_to_string()
    for t in range(1, 3):
        tree = GBDTModel.from_string(text).trees[t]
        jtree = JModel.from_string(text).trees[t]
        # the leaves' rows and branch features from the tree itself
        leaves = lt.Booster(model_str=text, params={"device_type": "cpu"}).predict(
            X, pred_leaf=True)[:, t]
        rows = [np.flatnonzero(leaves == i).astype(np.int32) for i in range(tree.num_leaves)]
        used = sorted({int(f) for f in tree.split_feature[:tree.num_leaves - 1]})
        for tr in (tree, jtree):
            tr.track_branch_features = True
            tr.branch_features = [list(used) for _ in range(tr.max_leaves)]

        class Part:
            def indices(self, leaf):
                return rows[leaf]

        fit_leaf_linear_models(tree, ds, raw, rows, grad, hess, 0.01, False)
        jfit(jtree, ds, raw, Part(), grad, hess, 0.01, False)
        assert tree.to_string() == jtree.to_string()
        assert any(tree.leaf_coeff[i] for i in range(tree.num_leaves))


@pytest.mark.parametrize("nan_rows", [0, 25], ids=["dense", "nan_rows"])
def test_model_text_byte_equal(jax_ref, monkeypatch, nan_rows):
    X, y = _piecewise_linear(nan_rows=nan_rows)
    params = _params(objective=snapped_l2, learning_rate=0.2, min_data_in_leaf=40)
    port = lt.train(dict(params), lt.Dataset(X, label=y), num_boost_round=5)
    _op_by_op(monkeypatch)
    ref = jax_ref.train(dict(params), jax_ref.Dataset(X, label=y), num_boost_round=5)
    text = port.model_to_string()
    assert "is_linear=1" in text and port.num_trees() == 5
    assert text == ref.model_to_string()


def test_predict_jax_model(jax_ref):
    X, y = _piecewise_linear(n=2000, nan_rows=30)
    ref = jax_ref.train(_params(learning_rate=0.2), jax_ref.Dataset(X, label=y),
                        num_boost_round=8)
    text = ref.model_to_string()
    port = lt.Booster(model_str=text, params={"device_type": "cpu"})
    Xt, _ = _piecewise_linear(seed=7, n=3000, nan_rows=17)
    Xt[::101, 2] = np.inf  # an infinite model feature falls back too
    got, want = port.predict(Xt), ref.predict(Xt)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    # the packed tables are the JAX pack's
    from lightgbm_tpu.models.serialize import GBDTModel as JModel
    from lightgbm_tpu.ops.predict import pack_ensemble as jpack

    packed = pack_ensemble(GBDTModel.from_string(text).trees)
    jpacked = jpack(JModel.from_string(text).trees)
    assert packed.linear and jpacked.linear
    for name in ("lin_const", "lin_feat", "lin_coeff"):
        np.testing.assert_array_equal(getattr(packed, name).numpy(),
                                      np.asarray(getattr(jpacked, name)))


def test_train_score_equals_predict_and_round_trips(tmp_path):
    X, y = _piecewise_linear(n=2000, nan_rows=50)
    Xv, yv = _piecewise_linear(seed=3, n=500)
    train = lt.Dataset(X, label=y)
    evals = {}
    bst = lt.train(_params(learning_rate=0.2, metric="l2", bagging_fraction=0.7,
                           bagging_freq=1),
                   train, num_boost_round=10, valid_sets=[train.create_valid(Xv, label=yv)],
                   valid_names=["valid"], callbacks=[lt.record_evaluation(evals)])
    raw = bst.predict(X, raw_score=True)
    np.testing.assert_allclose(bst._gbdt.score[0].numpy(), raw, rtol=1e-5, atol=1e-5)
    valid_raw = bst.predict(Xv, raw_score=True)
    np.testing.assert_allclose(bst._gbdt.valid_sets[0].score[0].numpy(), valid_raw,
                               rtol=1e-5, atol=1e-5)
    l2 = evals["valid"]["l2"]
    assert l2[-1] < l2[0]
    path = str(tmp_path / "linear.txt")
    bst.save_model(path)
    loaded = lt.Booster(model_file=path, params={"device_type": "cpu"})
    np.testing.assert_array_equal(loaded.predict(X), bst.predict(X))
    assert loaded.model_to_string() == bst.model_to_string()


def test_linear_beats_constant_leaves():
    """The JAX package's test_linear_tree_beats_constant_leaves, on the port."""
    X, y = _piecewise_linear()
    base = {"objective": "regression", "num_leaves": 7, "learning_rate": 0.2,
            "min_data_in_leaf": 40, "device_type": "cpu", "verbosity": -1}
    plain = lt.train(base, lt.Dataset(X, label=y), num_boost_round=20)
    lin = lt.train({**base, "linear_tree": True, "linear_lambda": 0.01},
                   lt.Dataset(X, label=y), num_boost_round=20)
    mse_plain = float(np.mean((plain.predict(X) - y) ** 2))
    mse_lin = float(np.mean((lin.predict(X) - y) ** 2))
    assert mse_lin < mse_plain * 0.8, (mse_lin, mse_plain)


def test_linear_predict_plain_equals_the_pack_path():
    """predict_raw of a linear pack: the traversal's leaf indices then the
    epilogue; a NaN or infinite model feature takes the constant leaf."""
    X, y = _piecewise_linear(n=1000)
    bst = lt.train(_params(), lt.Dataset(X, label=y), num_boost_round=4)
    trees = bst._gbdt.models
    packed = pack_ensemble(trees)
    Xt = X[:64].astype(np.float32).copy()
    Xt[0, 1], Xt[1, 0], Xt[2, 2] = np.nan, np.inf, -np.inf
    out = predict_raw(packed, torch.from_numpy(Xt))[:, 0].numpy()
    want = np.zeros(len(Xt))
    for tree in trees:
        for r, row in enumerate(Xt.astype(np.float64)):
            want[r] += _tree_predict(tree, row)
    np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-6)


def _tree_predict(tree, row):
    """The reference's one-row linear-tree walk (Tree::Predict)."""
    node = 0
    while node >= 0 and tree.num_leaves > 1:
        f = int(tree.split_feature[node])
        v = row[f]
        missing = (int(tree.decision_type[node]) >> 2) & 3
        if np.isnan(v) and missing != 2:
            v = 0.0
        if missing == 2 and np.isnan(v):
            go_left = bool(int(tree.decision_type[node]) & 2)
        else:
            go_left = v <= tree.threshold[node]
        node = int(tree.left_child[node] if go_left else tree.right_child[node])
    leaf = ~node if tree.num_leaves > 1 else 0
    out = float(tree.leaf_const[leaf])
    for f, c in zip(tree.leaf_features[leaf], tree.leaf_coeff[leaf]):
        if not np.isfinite(row[f]):
            return float(tree.leaf_value[leaf])
        out += c * row[f]
    return out


def test_linear_lane_trains_and_predicts():
    X, y = _piecewise_linear(n=1200, nan_rows=60)
    bst = lt.train(_params(), lt.Dataset(X, label=y), num_boost_round=3)
    pred = bst.predict(X)
    assert pred.shape == (len(X),) and np.isfinite(pred).all()


REFUSED = [
    ("sparse", {}, "dense input"),
    ("l1", {"objective": "regression_l1"}, "regression_l1"),
]


@pytest.mark.parametrize("data,extra,match", REFUSED, ids=[c[0] for c in REFUSED])
def test_refusals_that_stay(data, extra, match):
    X, y = _piecewise_linear(n=500)
    if data == "sparse":
        X = sp.csr_matrix(np.where(np.abs(X) < 1.0, 0.0, X))
    with pytest.raises(LightGBMError, match=match):
        lt.train(_params(**extra), lt.Dataset(X, label=y), num_boost_round=1)
