"""Monotone and interaction constraints and forced splits through the port's
serial learner, against the JAX package at device_type=cpu.

Contracts:

* the split search with a leaf's output bounds (`constraint`, basic-mode
  monotone constraints): on histograms of grid-snapped gradients the
  port's `find_best_split` and `per_feature_best` records are bit-equal to
  the JAX functions run op by op (`jax.disable_jit`) for monotone +1, -1
  and mixed, a bound binding on one side and on both, infinite bounds
  (with no monotone feature the record is then the unconstrained one),
  `max_delta_step > 0`, NaN and zero missing lanes, an EFB bundle, a
  categorical feature beside the constrained ones (its record's outputs
  clamped, its gain not) and a CEGB penalty with a constraint;
* training on snapped `fobj` gradients, bagging off: the model text
  byte-equal to the JAX serial learner's with its search run op by op, for
  monotone constraints (the JAX package's tests/test_constraints.py data,
  [1, -1, 0]), also with `use_quantized_grad` and leaf renewal (the renewed
  outputs clamped into the leaves' bounds), interaction constraints alone
  and with feature_fraction_bynode=0.8, and forced splits (the JSON of the
  JAX package's tests/test_io_features.py:48);
* the port's own Booster passes the JAX package's monotone sweep
  (test_monotone_constraints_enforced), and each lane trains on the CPU and
  predicts finite values;
* refusals that stay: monotone_constraints_method other than basic.
"""
import json

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.io.dataset import Dataset as CoreDataset
from lightgbm_tpu_torch.ops import split as ts
from lightgbm_tpu_torch.ops.histogram import build_histogram_rows
from lightgbm_tpu_torch.treelearner.col_sampler import ColSampler
from lightgbm_tpu_torch.treelearner.serial import learner_params
from lightgbm_tpu_torch.utils.log import LightGBMError
from tests.test_torch_ref import jax_ref  # noqa: F401

CPU = torch.device("cpu")
INF = float("inf")


def _op_by_op(monkeypatch):
    """The JAX serial learner's split search run op by op."""
    import jax
    from lightgbm_tpu.ops.split import find_best_split
    from lightgbm_tpu.treelearner import serial

    def op_by_op(*args):
        with jax.disable_jit():
            return find_best_split(*args)

    monkeypatch.setattr(serial, "find_best_split", op_by_op)


# ------------------------------------------------------------ the search

def _search_data(kind):
    """(X, params, categorical columns) of a search case's dataset."""
    rng = np.random.RandomState({"nan": 0, "zero": 1, "bundled": 2, "categorical": 3}[kind])
    n = 3000
    if kind == "bundled":  # mostly-zero columns: EFB bundles them
        X = np.where(rng.rand(n, 10) < 0.04, rng.normal(size=(n, 10)), 0.0)
        X[:, 0] = rng.normal(size=n)  # a dense column beside the bundles
        return X, {"min_data_in_leaf": 5}, []
    X = rng.normal(size=(n, 8))
    X[rng.rand(n, 8) < 0.08] = np.nan
    X[rng.rand(n, 8) < 0.1] = 0.0
    if kind == "categorical":
        X[:, 3] = rng.randint(0, 12, n)
        return X, {"min_data_in_leaf": 5}, [3]
    return X, ({"zero_as_missing": True} if kind == "zero" else {}), []


MONO = {"plus": lambda F: [1] * F, "minus": lambda F: [-1] * F,
        "mixed": lambda F: [(1, -1, 0)[i % 3] for i in range(F)],
        "none": lambda F: [0] * F}


def _search_case(jax_ref, kind, mono, seed):
    """Both packages' datasets with `mono` monotone constraints, their
    FeatureMeta, and one leaf's histogram and totals of snapped gradients
    whose mean leans on the first features."""
    from lightgbm_tpu.config import Config as JConfig
    from lightgbm_tpu.io.dataset import Dataset as JDataset
    from lightgbm_tpu.ops import split as js

    X, params, cats = _search_data(kind)
    ds = CoreDataset.from_matrix(X, label=np.zeros(len(X)), config=Config(params),
                                 categorical_feature=cats)
    jds = JDataset.from_matrix(X, label=np.zeros(len(X)), config=JConfig(params),
                               categorical_feature=cats)
    constraints = MONO[mono](X.shape[1])
    ds.monotone_constraints = list(constraints)
    jds.monotone_constraints = list(constraints)
    B = int(max(ds.group_bin_counts().max(), 2))
    rng = np.random.RandomState(seed)
    n = ds.num_data
    lean = np.nan_to_num(X[:, 0]) - 0.7 * np.nan_to_num(X[:, 1])
    g = np.round((rng.normal(size=n) * 0.5 + np.tanh(lean)) * 16) / 16
    h = np.round(rng.uniform(0.05, 0.5, size=n) * 16) / 16
    gh = np.concatenate([np.stack([g, h, np.ones(n)], 1), np.zeros((1, 3))]).astype(np.float32)
    rows = np.sort(rng.choice(n, 2200, replace=False)).astype(np.int32)
    hist = build_histogram_rows(torch.from_numpy(ds.bins), torch.from_numpy(gh),
                                torch.from_numpy(rows), B, count=len(rows))
    meta = ts.make_feature_meta(ds, B, CPU)
    assert meta.monotone.dtype == torch.int8
    assert meta.monotone.tolist() == [constraints[f] for f in meta.real_feature]
    return meta, js.make_feature_meta(jds, B), hist, hist[0].sum(dim=0)


def _bounds(rec, which):
    """Output bounds that bind the unconstrained record `rec` as `which`."""
    lout, rout = float(rec[10]), float(rec[11])
    mid, half = (lout + rout) / 2.0, abs(lout - rout) / 2.0
    if which == "inf":
        return (-INF, INF)
    if which == "upper":  # binds the larger output
        return (-INF, mid + half / 2)
    if which == "lower":  # binds the smaller output
        return (mid - half / 2, INF)
    return (mid - 0.75 * half, mid + 0.75 * half)  # both sides


SEARCH = [  # (data, monotone, bounds, max_delta_step, penalty)
    ("nan", "plus", "upper", 0.0, False),
    ("nan", "minus", "lower", 0.0, False),
    ("nan", "mixed", "both", 0.0, False),
    ("zero", "mixed", "upper", 0.0, False),
    ("nan", "mixed", "inf", 0.0, False),
    ("nan", "none", "inf", 0.0, False),
    ("nan", "mixed", "both", 0.3, False),
    ("bundled", "mixed", "both", 0.0, False),
    ("categorical", "mixed", "both", 0.0, False),
    ("nan", "mixed", "upper", 0.0, True),
]


@pytest.mark.parametrize("case", SEARCH, ids=["-".join(map(str, c)) for c in SEARCH])
def test_constrained_search_bit_equal_to_jax(jax_ref, case):
    import jax
    import jax.numpy as jnp
    from lightgbm_tpu.ops import split as js

    kind, mono, which, max_delta, with_penalty = case
    meta, jmeta, hist, tot = _search_case(jax_ref, kind, mono, seed=len(kind) + len(which))
    cfg = Config({"min_data_in_leaf": 5, "max_delta_step": max_delta,
                  "max_cat_to_onehot": 4, "cat_smooth": 10.0})
    p = learner_params(cfg, CPU)
    F = len(meta.real_feature)
    penalty = (torch.from_numpy((np.round(np.random.RandomState(6).uniform(0, 2, F) * 4) / 4)
                                .astype(np.float32)) if with_penalty else None)
    free = ts.find_best_split(hist, tot, meta, p, None, penalty).numpy()
    assert free[1] >= 0  # the unconstrained search finds a split to bind
    bounds = _bounds(free, which)
    got = ts.find_best_split(hist, tot, meta, p, None, penalty, constraint=bounds).numpy()
    jargs = (jnp.asarray(hist.numpy()), jnp.asarray(tot.numpy()), jmeta,
             jnp.asarray(p.numpy()), None, jnp.asarray(bounds, dtype=jnp.float32),
             None if penalty is None else jnp.asarray(penalty.numpy()))
    with jax.disable_jit():  # op by op, as PyTorch runs
        ref = np.asarray(js.find_best_split(*jargs))
        jfh = js.gather_feature_hist(jargs[0], jmeta, jargs[1])
        jper = np.asarray(js.per_feature_best(jfh, *jargs[1:]))
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))
    fh = ts.gather_feature_hist(hist, meta, tot)
    per = ts.per_feature_best(fh, tot, meta, p, None, penalty, constraint=bounds).numpy()
    np.testing.assert_array_equal(per.view(np.int32), jper.view(np.int32))
    if which == "inf" and mono == "none":
        np.testing.assert_array_equal(got.view(np.int32), free.view(np.int32))
    elif which != "inf":
        assert got[1] >= 0 and not np.array_equal(got, free)  # the bounds bind
        lo, hi = np.float32(bounds)  # as the search rounds them
        assert lo <= got[10] <= hi and lo <= got[11] <= hi
    if kind == "categorical":
        # the categorical lanes clamp their record's outputs, not their gain
        cat = ts.best_categorical_record(hist, tot, meta, p, constraint=bounds).numpy()
        cat_free = ts.best_categorical_record(hist, tot, meta, p).numpy()
        assert cat[12] == 1 and cat[0] == cat_free[0]
        assert (cat[10], cat[11]) == tuple(np.clip(cat_free[10:12], *np.float32(bounds)))
        seen = hist.clone()
        seen[[meta.real_feature.index(3)], 0] = 0.0  # the dummy bin (ROADMAP Queue 3)
        with jax.disable_jit():
            jfh = js.gather_feature_hist(jnp.asarray(seen.numpy()), jmeta, jargs[1])
            jcat = np.asarray(js.per_feature_best_categorical(jfh, *jargs[1:]))
        recs = ts.per_feature_best_categorical(
            ts.gather_feature_hist(hist, meta, tot), tot, meta, p, None, None,
            torch.tensor(bounds, dtype=torch.float32)).numpy()
        row = meta.real_feature.index(3)
        np.testing.assert_array_equal(recs[row].view(np.int32), jcat[row].view(np.int32))


def test_constrained_search_refuses_a_leaf_batch():
    X, params, _ = _search_data("nan")
    ds = CoreDataset.from_matrix(X, label=np.zeros(len(X)), config=Config(params))
    B = int(max(ds.group_bin_counts().max(), 2))
    meta = ts.make_feature_meta(ds, B, CPU)
    hist = torch.zeros((2, len(ds.groups), B, 3))
    with pytest.raises(ValueError, match="one leaf"):
        ts.find_best_split(hist, hist[:, 0].sum(dim=1), meta, learner_params(Config({}), CPU),
                           constraint=(-1.0, 1.0))


# ------------------------------------------------------------ training

def _mono_data(seed=42, n=3000):
    """The JAX package's tests/test_constraints.py data: y increases in x0,
    decreases in x1, noisy in x2."""
    rng = np.random.RandomState(seed)
    X = rng.uniform(-3, 3, size=(n, 3))
    y = 2.0 * X[:, 0] - 1.5 * X[:, 1] + 0.3 * np.sin(3 * X[:, 2]) + rng.randn(n) * 0.2
    return X, y


def snapped_l2(preds, dataset):
    """L2 gradients snapped to a 2**-4 grid with a hessian of one: every
    histogram and split sum of them is exact in float32."""
    grad = np.round((preds - dataset.get_label()) * 16) / 16
    return grad, np.ones_like(grad)


def _both(jax_ref, monkeypatch, X, y, params, rounds):
    port = lt.train(dict(params), lt.Dataset(X, label=y), num_boost_round=rounds)
    _op_by_op(monkeypatch)
    ref = jax_ref.train(dict(params), jax_ref.Dataset(X, label=y), num_boost_round=rounds)
    return port, ref


MONO_TRAIN = [
    ({}, "float"),
    ({"use_quantized_grad": True, "num_grad_quant_bins": 4, "quant_train_renew_leaf": True},
     "quantized"),
]


@pytest.mark.parametrize("extra,what", MONO_TRAIN, ids=[w for _, w in MONO_TRAIN])
def test_monotone_model_text_byte_equal(jax_ref, monkeypatch, extra, what):
    X, y = _mono_data()
    params = {"objective": snapped_l2, "num_leaves": 15, "min_data_in_leaf": 20,
              "learning_rate": 0.1, "monotone_constraints": [1, -1, 0], "device_type": "cpu",
              "verbosity": -1, **extra}
    port, ref = _both(jax_ref, monkeypatch, X, y, params, 4)
    assert port.num_trees() == 4
    assert port.model_to_string() == ref.model_to_string()


INTERACTION = [({}, "alone"), ({"feature_fraction_bynode": 0.8}, "bynode")]


@pytest.mark.parametrize("extra,what", INTERACTION, ids=[w for _, w in INTERACTION])
def test_interaction_constraints_model_text_byte_equal(jax_ref, monkeypatch, extra, what):
    from tests.test_torch_train import _data, snapped_logloss

    X, y = _data()
    params = {"objective": snapped_logloss, "num_leaves": 15, "device_type": "cpu",
              "interaction_constraints": "[0,1],[2,3]", "verbosity": -1, **extra}
    port, ref = _both(jax_ref, monkeypatch, X, y, params, 4)
    assert port.model_to_string() == ref.model_to_string()
    # every root-to-leaf path stays inside one group
    for tree in port._gbdt.models:
        for leaf in range(tree.num_leaves):
            path, node = set(), ~leaf
            parents = {int(c): i for i in range(tree.num_leaves - 1)
                       for c in (tree.left_child[i], tree.right_child[i])}
            while node in parents:
                node = parents[node]
                path.add(int(tree.split_feature[node]))
            assert path <= {0, 1} or path <= {2, 3}, path


def test_forced_splits_model_text_byte_equal(jax_ref, monkeypatch, tmp_path):
    from tests.test_torch_train import _data, snapped_logloss

    X, y = _data(with_nan=False, seed=7)
    path = str(tmp_path / "forced_splits.json")
    with open(path, "w") as fh:
        json.dump({"feature": 2, "threshold": 0.25,
                   "left": {"feature": 3, "threshold": -0.1}}, fh)
    params = {"objective": snapped_logloss, "num_leaves": 15, "device_type": "cpu",
              "forcedsplits_filename": path, "verbosity": -1}
    port, ref = _both(jax_ref, monkeypatch, X, y, params, 3)
    assert port.model_to_string() == ref.model_to_string()
    for t in port.dump_model()["tree_info"]:
        root = t["tree_structure"]
        assert root["split_feature"] == 2
        assert root["left_child"].get("split_feature") == 3


def test_node_mask_follows_the_path(jax_ref):
    """`get_by_node` with a path: the port's sampler draws the JAX one's
    masks, node for node, with bynode sampling over the constraint's
    closure."""
    from lightgbm_tpu.config import Config as JConfig
    from lightgbm_tpu.treelearner.col_sampler import ColSampler as JColSampler

    params = {"interaction_constraints": "[0,1,2],[2,3,4],[5]",
              "feature_fraction_bynode": 0.6, "feature_fraction": 0.9}
    port, ref = ColSampler(Config(params), list(range(7))), \
        JColSampler(JConfig(params), list(range(7)))
    for tree in range(3):
        np.testing.assert_array_equal(port.reset_by_tree(), ref.reset_by_tree())
        for path in (set(), {2}, {0, 2}, {3}, {5}, {1, 4}):
            np.testing.assert_array_equal(port.get_by_node(path), ref.get_by_node(path))


# ------------------------------------------------------------ the port alone

def _sweep(bst, feature, others, k=64):
    grid = np.linspace(-3, 3, k)
    X = np.tile(others, (k, 1))
    X[:, feature] = grid
    return bst.predict(X)


def test_monotone_sweep_holds():
    """The JAX package's test_monotone_constraints_enforced, on the port."""
    rng = np.random.RandomState(42)
    X, y = _mono_data(seed=43)
    params = {"objective": "regression", "num_leaves": 31, "learning_rate": 0.1,
              "min_data_in_leaf": 20, "monotone_constraints": [1, -1, 0],
              "device_type": "cpu", "verbosity": -1}
    bst = lt.train(params, lt.Dataset(X, label=y), num_boost_round=30)
    for _ in range(20):
        others = rng.uniform(-3, 3, size=3)
        assert np.all(np.diff(_sweep(bst, 0, others)) >= -1e-10)
        assert np.all(np.diff(_sweep(bst, 1, others)) <= 1e-10)
    assert float(np.mean((bst.predict(X) - y) ** 2)) < np.var(y) * 0.3


LANES = [
    ({"monotone_constraints": [1, -1, 0]}, "monotone"),
    ({"monotone_constraints": [1, -1, 0], "use_quantized_grad": True}, "monotone-quantized"),
    ({"interaction_constraints": "[0,1],[1,2]"}, "interaction"),
    ({"forcedsplits_filename": "FORCED"}, "forced"),
]


@pytest.mark.parametrize("extra,what", LANES, ids=[w for _, w in LANES])
def test_lane_trains_and_predicts(tmp_path, extra, what):
    X, y = _mono_data(seed=5, n=1500)
    if extra.get("forcedsplits_filename") == "FORCED":
        path = str(tmp_path / "forced.json")
        with open(path, "w") as fh:
            json.dump({"feature": 1, "threshold": 0.0, "right": {"feature": 0,
                                                                "threshold": 1.0}}, fh)
        extra = {"forcedsplits_filename": path}
    bst = lt.train({"objective": "regression", "num_leaves": 7, "device_type": "cpu",
                    "verbosity": -1, **extra}, lt.Dataset(X, label=y), num_boost_round=3)
    pred = bst.predict(X)
    assert pred.shape == (len(X),) and np.isfinite(pred).all()
    loaded = lt.Booster(model_str=bst.model_to_string(), params={"device_type": "cpu"})
    np.testing.assert_array_equal(loaded.predict(X), pred)


def test_monotone_method_other_than_basic_is_refused():
    X, y = _mono_data(n=500)
    with pytest.raises(LightGBMError, match="monotone_constraints_method"):
        lt.train({"objective": "regression", "num_leaves": 7, "device_type": "cpu",
                  "monotone_constraints": [1, 0, 0], "verbosity": -1,
                  "monotone_constraints_method": "intermediate"},
                 lt.Dataset(X, label=y), num_boost_round=2)
