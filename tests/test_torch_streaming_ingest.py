"""Streaming ingest (streaming/ingest.py, io/dataset.py:from_layout) on the
CPU, against one-shot construction and against the JAX package's store.

Contracts:

* pushes (dense, CSR, an iterator, CSV chunks) finalize into the plane,
  label and groups of one-shot construction, and train its model text;
* the layout is fitted on exactly `bin_sample_rows` rows, so it is the
  same however the rows were chunked;
* the plane, the mappers and the label are byte-equal to the JAX package's
  RowBlockStore fed the same seeded blocks, past the sample budget too;
* a store's finalized Dataset, saved with `save_binary`, loads in the other
  package with an equal plane, mappers and label, both ways;
* bad pushes raise as in the JAX package.
"""
import json

import numpy as np
import pytest

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.io.dataset import Dataset as CoreDataset
from lightgbm_tpu_torch.streaming import RowBlockStore, wrap_dataset
from tests.test_torch_ref import jax_ref  # noqa: F401

BASE = {"objective": "binary", "num_leaves": 15, "learning_rate": 0.1, "verbosity": -1,
        "min_data_in_leaf": 5, "device_type": "cpu"}


def _data(seed=3, n=2048, f=12, sparse_tail=False):
    rng = np.random.RandomState(seed)
    X = rng.standard_normal((n, f))
    if sparse_tail:
        X[X < -1.2] = 0.0  # zeros, so CSR pushes carry absent entries
    X[rng.rand(n, f) < 0.02] = np.nan
    y = (np.nan_to_num(X[:, 0]) - 0.5 * np.nan_to_num(X[:, 1])
         + rng.standard_normal(n) * 0.3 > 0)
    return X, y.astype(np.float64)


def _dense_to_csr(M):
    indptr, indices, values = [0], [], []
    for row in M:
        nz = np.flatnonzero(row)
        indices.extend(nz.tolist())
        values.extend(row[nz].tolist())
        indptr.append(len(indices))
    return (np.asarray(indptr, np.int64), np.asarray(indices, np.int32),
            np.asarray(values, np.float64))


def _mapper_dicts(core):
    return json.dumps([m.to_dict() for m in core.mappers], sort_keys=True)


def test_push_rows_matches_one_shot():
    X, y = _data(n=900)
    store = RowBlockStore(params=dict(BASE))
    for lo in range(0, 900, 256):
        store.push_rows(X[lo:lo + 256], label=y[lo:lo + 256])
    core = store.finalize()
    oneshot = CoreDataset.from_matrix(X, label=y, config=Config(dict(BASE)))
    assert np.array_equal(core.bins, oneshot.bins)
    assert core.num_data == oneshot.num_data == 900
    assert [g.feature_indices for g in core.groups] == \
        [g.feature_indices for g in oneshot.groups]
    np.testing.assert_array_equal(core.metadata.label, oneshot.metadata.label)
    pushed = lt.train(dict(BASE), store.to_basic_dataset(params=dict(BASE)),
                      num_boost_round=5)
    direct = lt.train(dict(BASE), lt.Dataset(X, label=y), num_boost_round=5)
    assert pushed.model_to_string() == direct.model_to_string()


def test_push_csr_iterator_and_csv_match_dense(tmp_path):
    X, y = _data(n=600, f=8, sparse_tail=True)
    X = np.nan_to_num(X)  # a CSV round trip of NaN is the parser's business
    chunks = [(X[lo:lo + 200], y[lo:lo + 200]) for lo in range(0, 600, 200)]
    dense, csr, it, csv = (RowBlockStore(params=dict(BASE)) for _ in range(4))
    for cx, cy in chunks:
        dense.push_rows(cx, label=cy)
        csr.push_csr(*_dense_to_csr(cx), X.shape[1], label=cy)
    it.push_from_iterator(iter(chunks))
    path = tmp_path / "rows.csv"
    with open(path, "w") as fh:
        for row, label in zip(X, y):
            fh.write(",".join([repr(float(label))] + [repr(float(v)) for v in row]) + "\n")
    csv.push_csv(str(path), chunk_rows=128)
    a = dense.finalize()
    for other in (csr, it, csv):
        b = other.finalize()
        assert np.array_equal(a.bins, b.bins)
        np.testing.assert_array_equal(a.metadata.label, b.metadata.label)
    assert csv.total_rows == 600


@pytest.mark.parametrize("source", ["dense64", "dense256", "dense_whole", "csr", "iterator"])
def test_layout_the_same_across_chunkings(source):
    X, y = _data(n=1500, f=6, sparse_tail=True)

    def store():
        return RowBlockStore(params=dict(BASE), bin_sample_rows=1000)

    baseline = store()
    baseline.push_rows(X, label=y)
    base_cuts = _mapper_dicts(baseline._layout)  # NaN-safe: the NaN bins' bounds
    s = store()
    if source.startswith("dense") and source != "dense_whole":
        step = int(source[5:])
        for lo in range(0, 1500, step):
            s.push_rows(X[lo:lo + step], label=y[lo:lo + step])
    elif source == "dense_whole":
        s.push_rows(X, label=y)
    elif source == "csr":
        for lo in range(0, 1500, 300):
            s.push_csr(*_dense_to_csr(X[lo:lo + 300]), 6, label=y[lo:lo + 300])
    else:
        s.push_from_iterator((X[lo:lo + 200], y[lo:lo + 200]) for lo in range(0, 1500, 200))
    assert _mapper_dicts(s._layout) == base_cuts
    assert np.array_equal(s.finalize().bins, baseline.finalize().bins)


def _both_stores(jax_ref, X, y, step, **kw):
    from lightgbm_tpu.streaming import RowBlockStore as JaxStore

    ours, theirs = RowBlockStore(params=dict(BASE), **kw), JaxStore(params=dict(BASE), **kw)
    for lo in range(0, X.shape[0], step):
        ours.push_rows(X[lo:lo + step], label=y[lo:lo + step])
        theirs.push_rows(X[lo:lo + step], label=y[lo:lo + step])
    return ours, theirs


@pytest.mark.parametrize("sample", [None, 700], ids=["whole", "prefix"])
def test_plane_and_mappers_byte_equal_to_jax_store(jax_ref, sample):
    X, y = _data(n=1800)
    ours, theirs = _both_stores(jax_ref, X, y, 300, bin_sample_rows=sample)
    a, b = ours.finalize(), theirs.finalize()
    assert a.bins.dtype == b.bins.dtype and np.array_equal(a.bins, b.bins)
    assert _mapper_dicts(a) == _mapper_dicts(b)
    assert [g.feature_indices for g in a.groups] == [g.feature_indices for g in b.groups]
    np.testing.assert_array_equal(a.metadata.label, np.asarray(b.metadata.label))
    # a watermark snapshot: the first rows only
    a, b = ours.finalize(1000), theirs.finalize(1000)
    assert np.array_equal(a.bins, b.bins) and a.num_data == b.num_data == 1000


def test_bin_cache_cross_read(jax_ref, tmp_path):
    X, y = _data(n=1200)
    ours, theirs = _both_stores(jax_ref, X, y, 400)
    p_ours, p_theirs = str(tmp_path / "ours.bin"), str(tmp_path / "theirs.bin")
    ours.to_basic_dataset(params=dict(BASE)).save_binary(p_ours)
    theirs.to_basic_dataset(params={"verbosity": -1}).save_binary(p_theirs)
    jax_loaded = jax_ref.Dataset(p_ours).construct()._handle
    port_loaded = lt.Dataset(p_theirs, params=dict(BASE)).construct()._handle
    for got, want in ((jax_loaded, ours.finalize()), (port_loaded, theirs.finalize())):
        assert np.array_equal(got.bins, want.bins)
        assert _mapper_dicts(got) == _mapper_dicts(want)
        np.testing.assert_array_equal(np.asarray(got.metadata.label),
                                      np.asarray(want.metadata.label))


def test_from_layout_and_wrap_dataset():
    X, y = _data(n=500)
    layout = CoreDataset.from_matrix(X, label=y, config=Config(dict(BASE)))
    core = CoreDataset.from_layout(layout, layout.bins[:, :300].copy(), 300, label=y[:300],
                                   weight=np.ones(300))
    assert core.mappers is layout.mappers and core.num_data == 300
    np.testing.assert_array_equal(core.metadata.label, y[:300])
    ds = wrap_dataset(core, params={"verbosity": -1})
    assert ds.construct()._handle is core and ds._raw is None


def test_push_errors(jax_ref):
    from lightgbm_tpu.streaming import RowBlockStore as JaxStore

    for cls in (RowBlockStore, JaxStore):
        store = cls()
        store.push_rows(np.zeros((4, 3), np.float32))
        with pytest.raises(ValueError, match="features"):
            store.push_rows(np.zeros((4, 5), np.float32))
        with pytest.raises(ValueError, match="label length"):
            store.push_rows(np.zeros((4, 3), np.float32), label=np.zeros(3))
        with pytest.raises(ValueError, match="exceeds pushed rows"):
            store.finalize(99)
        with pytest.raises(ValueError, match="empty"):
            cls().finalize()
    store = RowBlockStore()
    store.push_rows(np.ones((4, 3)), label=np.ones(4))
    store.push_rows(np.ones((4, 3)))
    with pytest.raises(ValueError, match="some pushes but not others"):
        store.finalize()


def test_holdout_snapshot_is_the_newest_rows():
    X, y = _data(n=700)
    store = RowBlockStore(params=dict(BASE), holdout_rows=250)
    for lo in range(0, 700, 100):
        store.push_rows(X[lo:lo + 100], label=y[lo:lo + 100])
    hx, hy = store.holdout_snapshot()
    np.testing.assert_array_equal(hx, X[450:])
    np.testing.assert_array_equal(hy, y[450:])
