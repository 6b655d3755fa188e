"""The model's life cycle in the port against the JAX package, on the CPU:
refit, rollback, continued training from `init_model`, `Dataset.subset` and
`cv`.

Contracts (2,000 x 8 rows, 15 leaves, at most 10 rounds):

* refit: the port sums a leaf's gradients exactly in fixed point and rounds
  once; the JAX package sums them in float32 (`jnp.zeros(L).at[leaf].add`),
  whose error reaches 3e-6 relative on a leaf whose gradients cancel. So
  the leaf values are held within rtol 1e-6 / atol 1e-9 of the JAX
  `Booster.refit` of the same model text on the same new data run under
  `jax.enable_x64`, where those sums accumulate in float64, and within
  tests/test_torch_train.py's float32 summation tolerances (rtol 1e-5 /
  atol 1e-6) of the JAX refit as it runs; bit-equal to it where every sum
  is exact (one tree, L2 on labels on a 1/64 grid: its gradients are the
  negated labels); the trees' structure unchanged;
* rollback: after training 6 rounds and taking one back, the remaining
  trees byte-equal to the 5 trees of an uninterrupted 5-round run, and the
  train score equal to predict(raw_score=True) within 1e-6, for a GBDT and
  for RF; and against the JAX package after the same 6 rounds and the same
  rollback (a GBDT on grid-snapped custom gradients, RF on L2 with labels
  on a 1/64 grid, the JAX split search run op by op, as
  tests/test_torch_train.py runs it): the model text byte-equal and the
  train scores bit-equal (a binary GBDT rolled back right after training
  is where the JAX rollback, which adds by the last tree's partition, is
  right; ROADMAP Queue 3, fault 5);
* init_model: 5 rounds, then 5 more from the Booster and from its model
  file, on grid-snapped custom gradients: the continuation from the file
  byte-equal to the one from the Booster, and both byte-equal to the JAX
  package's continuation from the same model file (the JAX search op by
  op; the first 5 rounds' parity is tests/test_torch_train.py's). The
  continuation holds the 5 new trees only, as the JAX package's does
  (ROADMAP Queue 3, fault 6): its raw scores plus the first model's are
  those of the 10 trees;
* subset: the binned rows, labels and raw rows of `Dataset.subset` equal
  the JAX package's, dense and CSR;
* cv: the fold indices equal the JAX `_make_n_folds`'s, stratified and
  shuffled, and by permutation; each round's mean and stdv within 1e-6 of
  JAX `cv` on L2 with labels on a 1/64 grid; `init_model` and
  `eval_train_metric`, which the JAX `cv` takes and ignores, refused.
"""
import numpy as np
import pytest
import scipy.sparse as sp

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.engine import _make_n_folds
from lightgbm_tpu_torch.utils.log import LightGBMError
from tests.test_torch_dart_rf import _op_by_op
from tests.test_torch_ref import jax_ref  # noqa: F401
from tests.test_torch_train import _data, snapped_logloss
from tests.torch_grid_data import grid_regression

CPU = {"device_type": "cpu", "verbosity": -1, "num_leaves": 15}
REFIT_RTOL, REFIT_ATOL = 1e-6, 1e-9  # against the JAX refit summing in float64
F32_RTOL, F32_ATOL = 1e-5, 1e-6  # against the JAX refit as it runs (float32 sums)
ROLLBACK_GAP = 1e-6
CV_TOL = 1e-6


def _leaf_values(text):
    return [np.array(line.split("=", 1)[1].split(), dtype=np.float64)
            for line in text.splitlines() if line.startswith("leaf_value=")]


def _structure(text):
    keys = ("split_feature=", "threshold=", "left_child=", "right_child=", "decision_type=")
    return [line for line in text.splitlines() if line.startswith(keys)]


def _trees(booster):
    return [t.to_string() for t in booster._gbdt.models]


@pytest.mark.parametrize("case", ["binary", "exact"])
def test_refit_matches_jax(jax_ref, case):
    if case == "binary":
        X, y = _data(with_nan=False, seed=7)
        X2, y2 = _data(with_nan=False, seed=8)
        params, rounds = {**CPU, "objective": "binary"}, 5
    else:
        X, y = grid_regression(seed=1)
        X2, y2 = grid_regression(seed=2)
        params, rounds = {**CPU, "objective": "regression"}, 1
    import jax

    text = lt.train(dict(params), lt.Dataset(X, label=y), num_boost_round=rounds).model_to_string()
    port = lt.Booster(params=dict(params), model_str=text).refit(X2, y2, decay_rate=0.5)
    ref = jax_ref.Booster(params=dict(params), model_str=text).refit(X2, y2, decay_rate=0.5)
    a, b = port.model_to_string(), ref.model_to_string()
    assert _structure(a) == _structure(b) == _structure(text)
    assert not all(np.array_equal(x, z) for x, z in zip(_leaf_values(a), _leaf_values(text)))
    assert port.num_trees() == rounds and port.current_iteration() == rounds
    if case == "exact":
        for x, z in zip(_leaf_values(a), _leaf_values(b)):
            np.testing.assert_array_equal(x, z)
        return
    with jax.enable_x64(True):
        ref64 = jax_ref.Booster(params=dict(params), model_str=text).refit(X2, y2,
                                                                           decay_rate=0.5)
    for x, z, z64 in zip(_leaf_values(a), _leaf_values(b),
                         _leaf_values(ref64.model_to_string())):
        np.testing.assert_allclose(x, z64, rtol=REFIT_RTOL, atol=REFIT_ATOL)
        np.testing.assert_allclose(x, z, rtol=F32_RTOL, atol=F32_ATOL)


@pytest.mark.parametrize("boosting", ["gbdt", "rf"])
def test_rollback_matches_the_shorter_run(boosting):
    X, y = _data(with_nan=False, seed=9)
    params = {**CPU, "objective": "binary", "boosting": boosting}
    if boosting == "rf":
        params.update(bagging_fraction=0.5, bagging_freq=1)
    short = lt.train(dict(params), lt.Dataset(X, label=y), num_boost_round=5)
    bst = lt.train(dict(params), lt.Dataset(X, label=y), num_boost_round=6)
    bst.rollback_one_iter()
    assert bst.current_iteration() == 5 and bst.num_trees() == 5
    assert _trees(bst) == _trees(short)
    gap = np.abs(bst._gbdt.score[0].numpy() - bst.predict(X, raw_score=True)).max()
    assert gap <= ROLLBACK_GAP, gap


@pytest.mark.parametrize("boosting", ["gbdt", "rf"])
def test_rollback_matches_jax(jax_ref, monkeypatch, boosting):
    if boosting == "gbdt":
        X, y = _data(seed=9)
        params = {**CPU, "objective": snapped_logloss}
    else:
        X, y = grid_regression(seed=4)
        params = {**CPU, "objective": "regression", "boosting": "rf",
                  "bagging_fraction": 0.5, "bagging_freq": 1}
    port = lt.train(dict(params), lt.Dataset(X, label=y), num_boost_round=6)
    port.rollback_one_iter()
    _op_by_op(monkeypatch)
    ref = jax_ref.train(dict(params), jax_ref.Dataset(X, label=y), num_boost_round=6)
    ref.rollback_one_iter()
    assert port.current_iteration() == ref.current_iteration() == 5
    assert port.model_to_string() == ref.model_to_string()
    np.testing.assert_array_equal(port._gbdt.score.numpy(), np.asarray(ref._gbdt.score))


def _continue(pkg, X, y, first, init_model, rounds=5):
    params = {**CPU, "objective": snapped_logloss}
    return pkg.train(dict(params), pkg.Dataset(X, label=y), num_boost_round=rounds,
                     init_model=init_model if init_model is not None else first)


def test_init_model_continues_as_jax(jax_ref, monkeypatch, tmp_path):
    from tests.test_torch_dart_rf import _op_by_op

    X, y = _data(seed=10)
    params = {**CPU, "objective": snapped_logloss}
    first = lt.train(dict(params), lt.Dataset(X, label=y), num_boost_round=5)
    path = str(tmp_path / "first.txt")
    first.save_model(path)
    from_booster = _continue(lt, X, y, first, None)
    from_file = _continue(lt, X, y, first, path)
    assert from_file.model_to_string() == from_booster.model_to_string()
    assert from_booster.num_trees() == 5 and from_booster.current_iteration() == 5
    # the new trees only: added to the first model's raw scores they give
    # the 10 trees' (one float32 add a row on each side)
    both = first.predict(X, raw_score=True) + from_booster.predict(X, raw_score=True)
    np.testing.assert_allclose(both, from_booster._gbdt.score[0].numpy(), rtol=0,
                               atol=ROLLBACK_GAP)
    _op_by_op(monkeypatch)
    ref = _continue(jax_ref, X, y, None, path)
    assert from_booster.model_to_string() == ref.model_to_string()


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "csr"])
def test_subset_matches_jax(jax_ref, sparse):
    X, y = _data(with_nan=False, seed=11)
    X[np.abs(X) < 0.5] = 0.0
    data = sp.csr_matrix(X) if sparse else X
    idx = np.sort(np.random.RandomState(3).choice(len(y), 700, replace=False))
    port = lt.Dataset(data, label=y, params={"verbosity": -1}).subset(idx)
    ref = jax_ref.Dataset(data, label=y, params={"verbosity": -1}).subset(idx)
    np.testing.assert_array_equal(port._handle.bins, ref._handle.bins)
    np.testing.assert_array_equal(port.get_label(), ref.get_label())
    assert port.num_data() == 700
    if sparse:
        np.testing.assert_array_equal(port._sparse_raw.toarray(), X[idx].astype(np.float64))
    else:
        np.testing.assert_array_equal(port._raw, X[idx].astype(np.float32))
    bst = lt.Booster({**CPU, "objective": "binary"}, port)
    bst.update()
    assert bst._gbdt.num_data == 700


@pytest.mark.parametrize("stratified", [True, False], ids=["stratified", "permutation"])
def test_fold_indices_equal_jax(jax_ref, stratified):
    from lightgbm_tpu.engine import _make_n_folds as jax_folds

    X, y = _data(with_nan=False, seed=12)
    port = list(_make_n_folds(lt.Dataset(X, label=y), None, 4, {}, 7, stratified, True))
    ref = list(jax_folds(jax_ref.Dataset(X, label=y), None, 4, {}, 7, stratified, True))
    assert len(port) == len(ref) == 4
    for (a_tr, a_te), (b_tr, b_te) in zip(port, ref):
        np.testing.assert_array_equal(a_tr, b_tr)
        np.testing.assert_array_equal(a_te, b_te)


def test_cv_matches_jax(jax_ref):
    X, y = grid_regression(seed=3)
    params = {**CPU, "objective": "regression", "metric": "l2"}
    port = lt.cv(dict(params), lt.Dataset(X, label=y), num_boost_round=3, nfold=3,
                 return_cvbooster=True)
    ref = jax_ref.cv(dict(params), jax_ref.Dataset(X, label=y), num_boost_round=3, nfold=3)
    booster = port.pop("cvbooster")
    assert len(booster.boosters) == 3
    assert sorted(port) == sorted(ref) == ["valid l2-mean", "valid l2-stdv"]
    for key in port:
        np.testing.assert_allclose(port[key], ref[key], rtol=0, atol=CV_TOL)


@pytest.mark.parametrize("option", ["init_model", "eval_train_metric"])
def test_cv_refuses_the_options_it_would_ignore(option):
    X, y = grid_regression(seed=3, n=200)
    kwargs = {"init_model": "model.txt"} if option == "init_model" else {option: True}
    with pytest.raises(LightGBMError, match=option):
        lt.cv({**CPU, "objective": "regression"}, lt.Dataset(X, label=y),
              num_boost_round=2, nfold=2, **kwargs)
