"""Cost-effective gradient boosting (CEGB) through the port's serial learner
against the JAX package at device_type=cpu.

Contracts:

* `treelearner/cegb.py`: over a sequence of committed splits, the penalty
  vectors of the port's CEGB (the lazy penalty's seen-bits kept on the
  device, the unseen rows counted there) are bit-equal to the JAX
  package's CEGB (host numpy bits), and so are the seen-bits and the
  "coupled penalty lifted" answers;
* training on snapped `fobj` gradients, bagging off: the model text
  byte-equal to the JAX serial learner's with its search run op by op, with
  the JAX package's tests/test_constraints.py:81-140 settings for the split,
  the coupled and the lazy penalties, and a coupled penalty that binds only
  for a while (the frontier searched again when it is lifted);
* the port alone: each penalty trains and predicts finite values and acts
  as the JAX package's tests expect (fewer leaves, only the free feature,
  the lazy feature used less).
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.io.dataset import Dataset as CoreDataset
from lightgbm_tpu_torch.treelearner.cegb import CEGB
from tests.test_torch_constraints import _op_by_op, snapped_l2
from tests.test_torch_ref import jax_ref  # noqa: F401


def test_penalty_vectors_bit_equal_to_jax(jax_ref):
    from lightgbm_tpu.config import Config as JConfig
    from lightgbm_tpu.io.dataset import Dataset as JDataset
    from lightgbm_tpu.treelearner.cegb import CEGB as JCEGB

    rng = np.random.RandomState(0)
    n, F = 1000, 5
    X = rng.normal(size=(n, F))
    params = {"cegb_tradeoff": 0.7, "cegb_penalty_split": 0.01,
              "cegb_penalty_feature_coupled": [3.0, 0.0, 1.5, 2.0, 0.25],
              "cegb_penalty_feature_lazy": [0.1, 0.3, 0.0, 1.0, 0.05]}
    port = CEGB(Config(params), CoreDataset.from_matrix(X, label=np.zeros(n),
                                                        config=Config(params)), "cpu")
    ref = JCEGB(JConfig(params), JDataset.from_matrix(X, label=np.zeros(n),
                                                      config=JConfig(params)))
    assert port.needs_rows and ref.needs_rows
    for step in range(12):
        rows = np.sort(rng.choice(n, rng.randint(1, n), replace=False))
        got = port.penalty_vector(float(len(rows)), torch.from_numpy(rows.astype(np.int32)))
        want = ref.penalty_vector(float(len(rows)), rows)
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
        f = int(rng.randint(F))
        split_rows = np.sort(rng.choice(n, rng.randint(1, n // 2), replace=False))
        assert (port.on_split_applied(f, torch.from_numpy(split_rows))
                == ref.on_split_applied(f, split_rows))
        np.testing.assert_array_equal(port.seen_bits.numpy(), ref.seen_bits)
        np.testing.assert_array_equal(port.used_in_split, ref.used_in_split)


def _split_data():
    rng = np.random.RandomState(42)
    X = rng.randn(2000, 5)
    y = X[:, 0] + 0.5 * X[:, 1] ** 2 + rng.randn(2000) * 0.1
    return X, y


def _coupled_data():
    rng = np.random.RandomState(43)
    X = rng.randn(2000, 4)
    y = X[:, 0] + 0.8 * X[:, 1] + 0.6 * X[:, 2] + rng.randn(2000) * 0.1
    return X, y


def _lazy_data():
    rng = np.random.RandomState(44)
    X = rng.randn(1500, 3)
    y = 1.0 * X[:, 0] + 0.95 * X[:, 1] + rng.randn(1500) * 0.1
    return X, y


# (data, leaves, rounds, penalties): the JAX package's tests' settings, a
# split penalty that prunes the trees without stopping the training (the
# tests' 2.0 stops it after the first tree on snapped gradients), a coupled
# penalty lifted during the first tree and lazy penalties that bind only
# on some leaves
CASES = {
    "split": (_split_data, 63, 5, {"cegb_penalty_split": 2.0}),
    "split-pruning": (_split_data, 63, 5, {"cegb_penalty_split": 0.05}),
    "coupled": (_coupled_data, 15, 3,
                {"cegb_penalty_feature_coupled": [1e9, 1e9, 1e9, 0.0]}),
    "coupled-lifted": (_coupled_data, 15, 3,
                       {"cegb_penalty_feature_coupled": [40.0, 300.0, 5.0, 0.0]}),
    "lazy": (_lazy_data, 15, 5, {"cegb_penalty_feature_lazy": [10.0, 0.0, 0.0],
                                 "cegb_tradeoff": 1.0}),
    "lazy-partial": (_lazy_data, 15, 5, {"cegb_penalty_feature_lazy": [0.3, 0.05, 0.0],
                                         "cegb_tradeoff": 1.0}),
}


@pytest.mark.parametrize("case", ["split-pruning", "coupled", "coupled-lifted", "lazy",
                                  "lazy-partial"])
def test_model_text_byte_equal(jax_ref, monkeypatch, case):
    data, leaves, rounds, extra = CASES[case]
    X, y = data()
    params = {"objective": snapped_l2, "num_leaves": leaves, "min_data_in_leaf": 20,
              "device_type": "cpu", "verbosity": -1, **extra}
    port = lt.train(dict(params), lt.Dataset(X, label=y), num_boost_round=rounds)
    _op_by_op(monkeypatch)
    ref = jax_ref.train(dict(params), jax_ref.Dataset(X, label=y), num_boost_round=rounds)
    assert port.num_trees() == rounds
    assert port.model_to_string() == ref.model_to_string()


def _split_counts(bst, F):
    counts = [0] * F
    for tree in bst._gbdt.models:
        for node in range(tree.num_leaves - 1):
            counts[int(tree.split_feature[node])] += 1
    return counts


@pytest.mark.parametrize("case", ["split", "coupled", "lazy"])
def test_penalty_trains_and_acts(case):
    data, leaves, rounds, extra = CASES[case]
    X, y = data()
    base = {"objective": "regression", "num_leaves": leaves, "min_data_in_leaf": 20,
            "device_type": "cpu", "verbosity": -1}
    plain = lt.train(base, lt.Dataset(X, label=y), num_boost_round=rounds)
    pen = lt.train({**base, **extra}, lt.Dataset(X, label=y), num_boost_round=rounds)
    pred = pen.predict(X)
    assert np.isfinite(pred).all()
    counts, plain_counts = _split_counts(pen, X.shape[1]), _split_counts(plain, X.shape[1])
    if case == "split":
        assert sum(counts) < sum(plain_counts)
    elif case == "coupled":
        assert counts[:3] == [0, 0, 0] and counts[3] > 0
    else:
        assert counts[1] > counts[0]
