"""Categorical features through the serial learner (ops/split.py
`per_feature_best_categorical`, `derive_cat_left_bins`, `bins_to_bitset`;
ops/partition.py's categorical go-left table; treelearner/serial.py's
categorical `_apply_split`; ops/score.py's categorical traversal; the
pandas `category` columns of basic.py) against the JAX package.

Contracts:

* `find_best_split` on histograms of grid-snapped gradients (every sum
  exact): the record bit-equal to the JAX `find_best_split` run op by op
  (`jax.disable_jit`), for the one-hot lane, the sorted subset in both
  directions, `max_cat_threshold` binding, `min_data_per_group`, a NaN
  category, categorical mixed with numeric features, and a tie between a
  numeric and a categorical split (the numeric record wins, as the JAX
  package's concatenation has it); `derive_cat_left_bins` and
  `bins_to_bitset` equal to the JAX functions;
* training on snapped `fobj` gradients, bagging off: the model text
  byte-equal to the JAX serial learner's (its search op by op) on the six
  data sets of the JAX package's tests/test_categorical.py, also with
  `use_quantized_grad`;
* with bagging: the first tree byte-equal to the JAX package's, and the
  port's train score equal to its own predict(raw_score=True) within 1e-6,
  where the JAX package's is not (its bin-space traversal of out-of-bag
  rows compares the bin with a categorical node's bitset index, ROADMAP
  Queue 3);
* a pandas DataFrame with `category` columns trains (`categorical_feature`
  "auto"), saves its `pandas_categorical:` line, and the loaded model
  predicts new frames, unseen categories included, as the training
  Booster; the model text byte-equal to the JAX package's; categorical
  features named by index and by name train the same model.
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.io.dataset import Dataset as CoreDataset
from lightgbm_tpu_torch.ops import split as ts
from lightgbm_tpu_torch.ops.histogram import build_histogram_rows
from lightgbm_tpu_torch.ops.partition import go_left_table
from lightgbm_tpu_torch.treelearner.serial import learner_params
from tests.test_torch_ref import jax_ref  # noqa: F401
from tests.test_torch_train import snapped_logloss

CPU = torch.device("cpu")


def _cat_data(n=2000, n_cats=12, seed=9):
    """tests/test_categorical.py's data: a few categories strongly
    positive, one numeric column."""
    rng = np.random.RandomState(seed)
    cats = rng.randint(0, n_cats, size=n)
    effect = np.where(np.isin(cats, [2, 5, 7]), 2.0, -1.0)
    X = np.column_stack([cats.astype(np.float64), rng.randn(n)])
    y = (effect + 0.3 * X[:, 1] + rng.randn(n) * 0.3 > 0).astype(np.float64)
    return X, y


def _onehot_data():
    rng = np.random.RandomState(3)
    cats = rng.randint(0, 3, size=1500)
    y = (cats == 1).astype(np.float64)
    return np.column_stack([cats.astype(np.float64), rng.randn(1500)]), y


def _mixed_data():
    rng = np.random.RandomState(5)
    n = 2000
    cats = rng.randint(0, 8, size=n)
    x1 = rng.randn(n)
    y = ((np.isin(cats, [1, 3]) & (x1 > 0)) | (x1 > 1.5)).astype(np.float64)
    return np.column_stack([x1, cats.astype(np.float64), rng.randn(n)]), y


# ------------------------------------------------------------ the search

def _search_case(case, seed):
    """(X, categorical columns, params) of one search case."""
    rng = np.random.RandomState(seed)
    n = 3000
    params = {"min_data_in_leaf": 5, "min_sum_hessian_in_leaf": 1e-3, "verbosity": -1}
    if case == "onehot":
        X = np.column_stack([rng.randint(0, 3, n), rng.randn(n)]).astype(np.float64)
        return X, [0], params
    c1 = rng.randint(0, 24, n).astype(np.float64)
    c2 = rng.randint(0, 40, n).astype(np.float64)
    X = np.column_stack([c1, rng.randn(n), c2])
    if case == "max_cat_threshold":
        params["max_cat_threshold"] = 2
    elif case == "min_data_per_group":
        params["min_data_per_group"] = 400
    elif case == "nan_category":
        X[rng.rand(n) < 0.1, 0] = np.nan
    elif case == "mixed":
        X = np.column_stack([X, rng.randn(n, 3)])
        params["cat_smooth"] = 2.0
    return X, [0, 2], params


def _histograms(ds, seed, n_leaves=6):
    """Leaf histograms of random row sets, from snapped gradients whose
    per-category means differ: a few categories stand out above the rest
    in even leaves and below it in odd ones, so both scan directions win
    somewhere."""
    rng = np.random.RandomState(seed)
    N = ds.num_data
    bpad = int(max(ds.group_bin_counts().max(), 2))
    bins = torch.from_numpy(np.ascontiguousarray(ds.bins))
    shift = np.where(rng.rand(64) < 0.15, 1.0, -0.1)
    code = np.asarray(ds.bins[0], dtype=np.int64) % 64
    h = np.round(rng.uniform(0.0625, 0.5, N) * 16) / 16
    out = []
    for leaf in range(n_leaves):
        g = np.round((rng.normal(0, 0.3, N) + (-1) ** leaf * shift[code]) * 16) / 16
        gh = torch.from_numpy(np.concatenate([np.stack([g, h, np.ones(N)], 1),
                                              np.zeros((1, 3))]).astype(np.float32))
        idx = np.sort(rng.choice(N, rng.randint(N // 4, N), replace=False)).astype(np.int32)
        hist = build_histogram_rows(bins, gh, torch.from_numpy(idx), bpad, count=len(idx))
        out.append((hist, hist[0].sum(dim=0)))
    return out, bpad


SEARCH = ["onehot", "subset", "max_cat_threshold", "min_data_per_group", "nan_category",
          "mixed"]


@pytest.mark.parametrize("case", SEARCH)
def test_find_best_split_bit_equal_to_jax(jax_ref, case):
    import jax
    import jax.numpy as jnp
    from lightgbm_tpu.config import Config as JConfig
    from lightgbm_tpu.io.dataset import Dataset as JDataset
    from lightgbm_tpu.ops import split as js

    X, cats, params = _search_case(case, seed=len(case))
    cfg = Config(params)
    ds = CoreDataset.from_matrix(X, label=np.zeros(len(X)), config=cfg,
                                 categorical_feature=cats)
    jds = JDataset.from_matrix(X, label=np.zeros(len(X)), config=JConfig(params),
                               categorical_feature=cats)
    hists, bpad = _histograms(ds, seed=len(case) + 1)
    meta = ts.make_feature_meta(ds, bpad, CPU)
    jmeta = js.make_feature_meta(jds, bpad)
    assert meta.has_categorical and jmeta.has_categorical
    p = learner_params(cfg, CPU)
    # the dummy bin 0 of a categorical feature is no candidate of the port's
    # lanes (LightGBM's), but one of the JAX lanes: it holds rows only with a
    # NaN category, where the JAX search sees it zeroed (ROADMAP Queue 3)
    cat_groups = [ds.feature_to_group[f][0] for f in cats]
    dirs, dummy_rows = set(), 0
    for hist, totals in hists:
        seen = hist.clone()
        seen[cat_groups, 0] = 0.0
        dummy_rows += int(hist[cat_groups, 0, 2].sum())
        got = ts.find_best_split(hist, totals, meta, p).numpy()
        with jax.disable_jit():
            ref = np.asarray(js.find_best_split(jnp.asarray(seen.numpy()),
                                                jnp.asarray(totals.numpy()), jmeta,
                                                jnp.asarray(p.numpy())))
        np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))
        cat = ts.best_categorical_record(hist, totals, meta, p).numpy()
        dirs.add(int(cat[13]))
        # the categorical lanes alone, against the JAX lanes op by op
        with jax.disable_jit():
            fh = js.gather_feature_hist(jnp.asarray(seen.numpy()),
                                        jmeta, jnp.asarray(totals.numpy()))
            jrecs = np.asarray(js.per_feature_best_categorical(
                fh, jnp.asarray(totals.numpy()), jmeta, jnp.asarray(p.numpy())))
        recs = ts.per_feature_best_categorical(ts.gather_feature_hist(hist, meta, totals),
                                               totals, meta, p).numpy()
        rows = meta.is_categorical.numpy()  # a numeric feature's row is invalid on both
        np.testing.assert_array_equal(recs[rows].view(np.int32), jrecs[rows].view(np.int32))
        assert (recs[~rows, 1] == -1).all() and (jrecs[~rows, 1] == -1).all()
    assert (dummy_rows > 0) == (case == "nan_category")
    if case == "onehot":
        assert dirs == {0}
    elif case == "subset":
        assert dirs == {1, -1}, dirs  # both scan directions won a leaf


def test_numeric_categorical_tie_goes_to_numeric(jax_ref):
    """A 0/1 numeric column and the same column as a 2-category feature
    split the rows alike, with the same gain: the numeric record wins."""
    import jax
    import jax.numpy as jnp
    from lightgbm_tpu.config import Config as JConfig
    from lightgbm_tpu.io.dataset import Dataset as JDataset
    from lightgbm_tpu.ops import split as js

    rng = np.random.RandomState(4)
    b = rng.randint(0, 2, 2000).astype(np.float64)
    X = np.column_stack([b, b])
    params = {"min_data_in_leaf": 5, "verbosity": -1}
    cfg = Config(params)
    ds = CoreDataset.from_matrix(X, label=np.zeros(len(X)), config=cfg, categorical_feature=[1])
    jds = JDataset.from_matrix(X, label=np.zeros(len(X)), config=JConfig(params),
                               categorical_feature=[1])
    ((hist, totals),), bpad = _histograms(ds, seed=5, n_leaves=1)
    meta = ts.make_feature_meta(ds, bpad, CPU)
    p = learner_params(cfg, CPU)
    got = ts.find_best_split(hist, totals, meta, p).numpy()
    cat = ts.best_categorical_record(hist, totals, meta, p).numpy()
    assert got[0] == cat[0] and got[12] == 0.0 and cat[12] == 1.0
    with jax.disable_jit():
        ref = np.asarray(js.find_best_split(jnp.asarray(hist.numpy()),
                                            jnp.asarray(totals.numpy()),
                                            js.make_feature_meta(jds, bpad),
                                            jnp.asarray(p.numpy())))
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))


def test_derive_left_bins_and_bitsets(jax_ref):
    from lightgbm_tpu.ops import split as js

    rng = np.random.RandomState(0)
    for trial in range(40):
        nb = rng.randint(2, 70)
        stats = np.stack([rng.choice([-1.0, -0.5, -0.0, 0.0, 0.25, 0.5], nb),
                          rng.choice([0.0, 0.5, 1.0], nb),
                          rng.randint(0, 30, nb)], 1).astype(np.float32)
        if trial % 4 == 0:
            stats[rng.randint(nb), 0] = np.nan
        for cat_dir in (0, 1, -1):
            k = rng.randint(0, nb)
            a = ts.SplitInfo(threshold_bin=k, cat_dir=cat_dir, is_categorical=True)
            b = js.SplitInfo(threshold_bin=k, cat_dir=cat_dir, is_categorical=True)
            left = ts.derive_cat_left_bins(stats, nb, a, 10.0)
            seen = stats.copy()
            seen[0] = 0.0  # the dummy bin 0, no candidate of the port's lanes
            assert left == js.derive_cat_left_bins(seen, nb, b, 10.0)
            assert ts.bins_to_bitset(left) == js.bins_to_bitset(left)
    assert ts.bins_to_bitset([]) == [0] and ts.bins_to_bitset([0, 33, 64]) == [1, 2, 1]


def test_go_left_table_of_a_bin_set():
    """The partition's table: bins in the set go left, bins past it right."""
    decision = (3.0, 0.0, 0.0, 0.0, 6.0, 0.0, 0.0, 0.0)
    mask = np.zeros(8, dtype=bool)
    mask[[1, 4, 5]] = True
    table = go_left_table(decision, mask)
    assert table.shape == (256,)
    assert np.nonzero(table)[0].tolist() == [1, 4, 5]


# ------------------------------------------------------------ training

TRAIN = {"onehot": (_onehot_data, [0], 4, 4),
         "sorted_subset": (_cat_data, [0], 7, 4),
         "roundtrip": (_cat_data, [0], 7, 3),
         "unseen": (lambda: _cat_data(seed=11), [0], 7, 3),
         "score_consistency": (lambda: _cat_data(n=1200), [0], 7, 3),
         "numerical_mix": (_mixed_data, [1], 15, 3)}


def _op_by_op(monkeypatch):
    import jax
    from lightgbm_tpu.ops.split import find_best_split
    from lightgbm_tpu.treelearner import serial

    def op_by_op(*args):
        with jax.disable_jit():
            return find_best_split(*args)

    monkeypatch.setattr(serial, "find_best_split", op_by_op)


def _both(jax_ref, monkeypatch, X, y, cats, params, rounds):
    _op_by_op(monkeypatch)
    out = []
    for pkg in (lt, jax_ref):
        out.append(pkg.train(dict(params), pkg.Dataset(X, label=y, categorical_feature=cats),
                             num_boost_round=rounds))
    return out


@pytest.mark.parametrize("quantized", [False, True], ids=["float", "quantized"])
@pytest.mark.parametrize("case", list(TRAIN))
def test_training_byte_equal_to_jax(jax_ref, monkeypatch, case, quantized):
    make, cats, leaves, rounds = TRAIN[case]
    X, y = make()
    params = {"objective": snapped_logloss, "num_leaves": leaves, "device_type": "cpu",
              "verbosity": -1}
    if quantized:
        params.update(use_quantized_grad=True, num_grad_quant_bins=4)
    port, ref = _both(jax_ref, monkeypatch, X, y, cats, params, rounds)
    text = port.model_to_string()
    assert text == ref.model_to_string()
    assert sum(t.num_cat for t in port._gbdt.models) > 0
    # the two packages' traversals sum the trees in their own float32 order
    np.testing.assert_allclose(port.predict(X, raw_score=True),
                               ref.predict(X, raw_score=True), rtol=1e-6, atol=1e-6)
    # the train score is the model's prediction (no bagging: each row
    # scored through the partition)
    np.testing.assert_allclose(port._gbdt.score[0].numpy(), port.predict(X, raw_score=True),
                               rtol=0, atol=1e-6)
    if case == "roundtrip":
        loaded = lt.Booster(model_str=text, params={"device_type": "cpu"})
        np.testing.assert_array_equal(loaded.predict(X), port.predict(X))
    if case == "unseen":
        X_unseen = X[:5].copy()
        X_unseen[:, 0] = 999
        out = port.predict(X_unseen)
        assert np.isfinite(out).all()
        np.testing.assert_allclose(out, ref.predict(X_unseen), rtol=1e-6, atol=1e-6)


def _fault_data():
    """One 20-category feature and one normal column, 4,000 rows."""
    rng = np.random.RandomState(1)
    n = 4000
    cats = rng.randint(0, 20, n)
    effect = rng.normal(0, 1, 20)[cats]
    X = np.column_stack([cats.astype(np.float64), rng.randn(n)])
    y = (effect + 0.5 * X[:, 1] + rng.randn(n) * 0.5 > 0).astype(np.float64)
    return X, y


BAGGED = {"objective": snapped_logloss, "num_leaves": 15, "bagging_fraction": 0.5,
          "bagging_freq": 1, "device_type": "cpu", "verbosity": -1}


def test_bagged_train_score_equals_predict(jax_ref, monkeypatch):
    """Under bagging the out-of-bag rows' train scores come from the
    bin-space traversal, which decides a categorical node by its bin
    bitset: the train score equals predict(raw_score=True). The JAX
    package's traversal compares the bin with the node's bitset index
    there, and its train score is off by far more (fault 1, ROADMAP Queue
    3); its first tree, grown before any out-of-bag update, is the port's."""
    X, y = _fault_data()
    port, ref = _both(jax_ref, monkeypatch, X, y, [0], BAGGED, 3)
    assert port._gbdt.models[0].to_string() == ref._gbdt.models[0].to_string()
    assert sum(t.num_cat for t in port._gbdt.models) > 0
    gap = np.abs(port._gbdt.score[0].numpy() - port.predict(X, raw_score=True)).max()
    assert gap <= 1e-6, gap
    ref_gap = np.abs(np.asarray(ref._gbdt.score[0]) - ref.predict(X, raw_score=True)).max()
    assert ref_gap > 1e-2, ref_gap


def test_dummy_bin_goes_right_as_at_predict(jax_ref):
    """The dummy bin 0 of a categorical feature (NaN here) is no left-set
    candidate, so its rows go right in training as at predict, and the
    train score equals predict(raw_score=True). The JAX package's lanes
    take bin 0, its model's value bitset cannot hold it, and its train
    score is off where the NaN rows went left (ROADMAP Queue 3)."""
    rng = np.random.RandomState(3)
    n = 3000
    cats = rng.randint(0, 12, n).astype(np.float64)
    nan = rng.rand(n) < 0.15
    cats[nan] = np.nan
    X = np.column_stack([cats, rng.randn(n)])
    y = ((nan | np.isin(cats, [2, 5])) ^ (rng.rand(n) < 0.05)).astype(np.float64)
    params = {"objective": "binary", "num_leaves": 7, "device_type": "cpu", "verbosity": -1}
    gaps = []
    for pkg in (lt, jax_ref):
        bst = pkg.train(dict(params), pkg.Dataset(X, label=y, categorical_feature=[0]),
                        num_boost_round=5)
        gaps.append(np.abs(np.asarray(bst._gbdt.score[0])
                           - bst.predict(X, raw_score=True)).max())
    assert gaps[0] <= 1e-6 and gaps[1] > 1e-2, gaps


def test_bagged_goss_and_quantized_train_score_equals_predict():
    X, y = _fault_data()
    for extra in ({"use_quantized_grad": True},
                  {"bagging_fraction": 1.0, "data_sample_strategy": "goss",
                   "learning_rate": 0.5}):
        bst = lt.train({**BAGGED, "objective": "binary", **extra},
                       lt.Dataset(X, label=y, categorical_feature=[0]),
                       num_boost_round=5)
        assert sum(t.num_cat for t in bst._gbdt.models) > 0
        gap = np.abs(bst._gbdt.score[0].numpy() - bst.predict(X, raw_score=True)).max()
        assert gap <= 1e-6, (extra, gap)


# ------------------------------------------------------------ pandas

def _frame(seed, n, unseen=False):
    import pandas as pd

    rng = np.random.RandomState(seed)
    carriers = ["AA", "DL", "UA", "WN", "B6", "AS"]
    days = ["Mon", "Tue", "Wed", "Thu", "Fri", "Sat", "Sun"]
    c = rng.choice(carriers + (["ZZ"] if unseen else []), n)
    d = rng.choice(days, n)
    x = rng.randn(n)
    df = pd.DataFrame({"carrier": pd.Categorical(c, categories=carriers if not unseen
                                                   else carriers + ["ZZ"]),
                       "dep": x,
                       "day": pd.Categorical(d, categories=days)})
    y = ((np.isin(c, ["DL", "WN"]) + 0.4 * x + 0.3 * (d == "Fri")
          + rng.randn(n) * 0.3) > 0.5).astype(np.float64)
    return df, y


def test_pandas_category_round_trip(jax_ref, monkeypatch, tmp_path):
    df, y = _frame(0, 3000)
    params = {"objective": snapped_logloss, "num_leaves": 7, "device_type": "cpu",
              "verbosity": -1}
    _op_by_op(monkeypatch)
    port = lt.train(dict(params), lt.Dataset(df, label=y), num_boost_round=4)
    ref = jax_ref.train(dict(params), jax_ref.Dataset(df, label=y), num_boost_round=4)
    text = port.model_to_string()
    assert text == ref.model_to_string()
    assert "pandas_categorical:" in text
    assert port.pandas_categorical == [list(df["carrier"].cat.categories),
                                       list(df["day"].cat.categories)]
    assert sum(t.num_cat for t in port._gbdt.models) > 0
    path = str(tmp_path / "cat.txt")
    port.save_model(path)
    loaded = lt.Booster(model_file=path, params={"device_type": "cpu"})
    assert loaded.pandas_categorical == port.pandas_categorical
    new, _ = _frame(1, 500, unseen=True)  # an unseen carrier, categories in another order
    new["carrier"] = new["carrier"].cat.reorder_categories(
        list(reversed(new["carrier"].cat.categories)))
    want = port.predict(new, raw_score=True)
    np.testing.assert_array_equal(loaded.predict(new, raw_score=True), want)
    np.testing.assert_allclose(ref.predict(new, raw_score=True), want, rtol=1e-6, atol=1e-6)
    assert np.isfinite(want).all()


def test_categorical_feature_by_index_and_name():
    X, y = _cat_data()
    base = {"objective": "binary", "num_leaves": 7, "device_type": "cpu", "verbosity": -1}
    a = lt.train(base, lt.Dataset(X, label=y, categorical_feature=[0]), num_boost_round=4)
    b = lt.train(base, lt.Dataset(X, label=y, feature_name=["cat", "x"],
                                  categorical_feature=["cat"]), num_boost_round=4)
    c = lt.train({**base, "categorical_feature": "0"}, lt.Dataset(X, label=y),
                 num_boost_round=4)
    assert sum(t.num_cat for t in a._gbdt.models) > 0
    for other in (b, c):
        for ta, tb in zip(a._gbdt.models, other._gbdt.models):
            assert ta.to_string() == tb.to_string()
