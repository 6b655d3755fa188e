"""Datasets from text files and binary caches (`Dataset(path)`,
`Dataset.save_binary`, `io.dataset.Dataset.load_binary`).

Contracts (1,200 x 6 rows from a seed, NaN in 5% of the cells):
* a cache written by either package loads in the other to the same bins,
  bin mappers, feature groups, used features, feature names and metadata
  (label, weights, init score, query boundaries, positions) and raw rows;
* the port's query weights after a load are those of `set_query` on the
  same rows (the JAX load leaves them unset: ROADMAP Queue 3);
* a model trained from a port-written `.bin` is byte-equal to one trained
  from the same arrays, on snapped gradients (`snapped_logloss`) and on the
  built-in objective; a text file with a `.weight` side file trains as the
  arrays and weights it holds;
* constructor arguments override a cache's metadata.
"""
import json

import numpy as np
import pytest

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.io.parser import parse_file
from tests.test_torch_ref import jax_ref  # noqa: F401
from tests.test_torch_train import snapped_logloss

PARAMS = {"num_leaves": 15, "device_type": "cpu", "verbosity": -1}


def _data(seed=0, n=1200, f=6):
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, f))
    X[rng.rand(n, f) < 0.05] = np.nan
    y = (np.nan_to_num(X[:, 0]) + 0.5 * np.nan_to_num(X[:, 1])
         + 0.3 * rng.normal(size=n) > 0).astype(np.float64)
    w = rng.uniform(0.5, 2.0, size=n)
    return X, y, w


def _ranking_meta(n):
    rng = np.random.RandomState(7)
    group = np.full(n // 40, 40)
    return group, rng.randint(0, 5, n), rng.normal(size=n)


def _state(core, raw):
    md = core.metadata
    return {  # mappers as JSON text: their NaN bounds compare equal there
        "bins": core.bins, "mappers": json.dumps([m.to_dict() for m in core.mappers]),
        "groups": [(g.feature_indices, g.is_multi) for g in core.groups],
        "used": core.used_features, "names": core.feature_names,
        "ntotal": core.num_total_features, "label": md.label, "weight": md.weights,
        "init_score": md.init_score, "qb": md.query_boundaries, "pos": md.positions,
        "pos_ids": md.position_ids, "raw": raw}


def _assert_state_equal(a, b):
    assert a.keys() == b.keys()
    for key in a:
        x, y = a[key], b[key]
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            assert x is not None and y is not None, key
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=key)
            assert np.asarray(x).dtype == np.asarray(y).dtype, key
        else:
            assert x == y, key


def _make(pkg, X, y, w, ranked):
    kw = {}
    if ranked:
        group, pos, init = _ranking_meta(len(y))
        kw = dict(group=group, position=pos, init_score=init)
    return pkg.Dataset(X, label=y, weight=w, params={"max_bin": 63, "verbosity": -1}, **kw)


@pytest.mark.parametrize("ranked", [False, True])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_cache_loads_across_packages(jax_ref, tmp_path, writer, ranked):
    X, y, w = _data()
    port_ds, ref_ds = _make(lt, X, y, w, ranked), _make(jax_ref, X, y, w, ranked)
    path = str(tmp_path / "train.bin")
    (port_ds if writer == "port" else ref_ds).save_binary(path)
    port_ds.construct()
    ref_ds.construct()
    loaded_port = lt.Dataset(path).construct()
    loaded_ref = jax_ref.Dataset(path).construct()
    want = _state(port_ds._handle, port_ds._raw)
    _assert_state_equal(_state(loaded_port._handle, loaded_port._raw), want)
    _assert_state_equal(_state(loaded_ref._handle, loaded_ref._raw), want)
    _assert_state_equal(_state(ref_ds._handle, ref_ds._raw), want)
    if ranked:
        np.testing.assert_array_equal(loaded_port._handle.metadata.query_weights,
                                      port_ds._handle.metadata.query_weights)
        assert loaded_ref._handle.metadata.query_weights is None  # the JAX gap


@pytest.mark.parametrize("objective", ["snapped", "binary"])
def test_training_from_bin_equals_arrays(tmp_path, objective):
    X, y, w = _data(1)
    params = dict(PARAMS, objective=snapped_logloss if objective == "snapped" else "binary")
    from_arrays = lt.train(dict(params), lt.Dataset(X, label=y, weight=w),
                           num_boost_round=4)
    path = str(tmp_path / "train.bin")
    lt.Dataset(X, label=y, weight=w).save_binary(path)
    valid = lt.Dataset(X[:300], label=y[:300])
    from_bin = lt.train(dict(params), lt.Dataset(path), num_boost_round=4,
                        valid_sets=[valid])
    assert from_bin.model_to_string() == from_arrays.model_to_string()


def test_text_file_with_weight_side_file(tmp_path):
    X, y, w = _data(2, n=600)
    path = str(tmp_path / "train.tsv")
    np.savetxt(path, np.column_stack([y, X]), delimiter="\t", fmt="%.17g")
    np.savetxt(path + ".weight", w, fmt="%.17g")
    Xp, yp, _ = parse_file(path)
    np.testing.assert_array_equal(Xp, X)
    params = dict(PARAMS, objective="binary")
    from_text = lt.train(dict(params), lt.Dataset(path), num_boost_round=3)
    from_arrays = lt.train(dict(params), lt.Dataset(X, label=y, weight=w), num_boost_round=3)
    assert from_text.model_to_string() == from_arrays.model_to_string()
    ds = lt.Dataset(path).construct()
    np.testing.assert_array_equal(ds._handle.metadata.weights, w.astype(np.float32))
    assert ds.get_feature_name() == [f"Column_{i}" for i in range(X.shape[1])]


def test_constructor_arguments_override_the_cache(tmp_path):
    X, y, w = _data(3, n=400)
    path = str(tmp_path / "train.bin")
    lt.Dataset(X, label=y, weight=w).save_binary(path)
    flipped = 1.0 - y
    ds = lt.Dataset(path, label=flipped, weight=np.ones(len(y))).construct()
    np.testing.assert_array_equal(ds.get_label(), flipped.astype(np.float32))
    np.testing.assert_array_equal(ds._handle.metadata.weights, np.ones(len(y), np.float32))
    plain = lt.Dataset(path).construct()
    np.testing.assert_array_equal(plain._handle.metadata.weights, w.astype(np.float32))
