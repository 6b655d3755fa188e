"""The port's text parser (`io/parser.py`, `native/parser.cpp`) against the
JAX package's, and the native parser against its plain version.

Contracts, on files written here from a seed:
* `parse_file` returns the JAX package's X, y and names exactly (float64,
  NaN where NaN) on CSV, TSV, a headered CSV with a `name:` label and
  ignore columns, whitespace-delimited rows, LibSVM, and `max_rows`; the
  side-file loaders return the same arrays;
* the native dense parse equals `np.genfromtxt` (`plain_parse_dense`)
  exactly, on one shard and on a file past the 4 MB shard threshold;
* a malformed file answers as in the JAX package: rows of unequal length go
  to the plain parse, a LibSVM `qid:` token raises ValueError in both;
* the library builds into build/lightgbm_tpu_torch/, not the package.
"""
from pathlib import Path

import numpy as np
import pytest

import lightgbm_tpu_torch
from lightgbm_tpu_torch import native
from lightgbm_tpu_torch.io import parser
from tests.test_torch_ref import jax_ref  # noqa: F401


def _assert_same(a, b):
    Xa, ya, na = a
    Xb, yb, nb = b
    assert Xa.dtype == Xb.dtype == np.float64 and Xa.shape == Xb.shape
    np.testing.assert_array_equal(Xa, Xb)  # NaN equal to NaN
    np.testing.assert_array_equal(ya, yb)
    assert na == nb


def _rows(seed, n, f, nan=0.05):
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, f))
    X[rng.rand(n, f) < nan] = np.nan
    y = rng.randint(0, 2, n).astype(np.float64)
    return X, y


def _write_dense(path, X, y, delim, header=None, label_at=0):
    with open(path, "w") as fh:
        if header:
            fh.write(delim.join(header) + "\n")
        for row, lab in zip(X, y):
            toks = ["nan" if np.isnan(v) else repr(float(v)) for v in row]
            toks.insert(label_at, repr(float(lab)))
            fh.write(delim.join(toks) + "\n")


def _cases(tmp_path):
    X, y = _rows(0, 300, 6)
    out = {}
    for name, delim in (("csv", ","), ("tsv", "\t"), ("space", " ")):
        p = tmp_path / f"d.{name}"
        _write_dense(p, X, y, delim)
        out[name] = (str(p), {})
    p = tmp_path / "h.csv"
    _write_dense(p, X, y, ",", header=["f0", "f1", "target", "f2", "f3", "f4", "f5"],
                 label_at=2)
    out["header"] = (str(p), dict(header=True, label_column="name:target",
                                  ignore_columns=["name:f1,f4", 0]))
    out["header_index"] = (str(p), dict(header=True, label_column="2"))
    out["max_rows"] = (out["tsv"][0], dict(max_rows=40))
    return out


@pytest.mark.parametrize("case", ["csv", "tsv", "space", "header", "header_index",
                                  "max_rows"])
def test_parse_file_equals_jax(jax_ref, tmp_path, case):
    from lightgbm_tpu.io.parser import parse_file as ref_parse

    path, kw = _cases(tmp_path)[case]
    got = parser.parse_file(path, **kw)
    _assert_same(got, ref_parse(path, **kw))
    if case == "header":
        assert got[2] == ["f2", "f3", "f5"]  # f1, f4 and column 0 (f0) ignored


def _write_libsvm(path, seed, qid=False):
    rng = np.random.RandomState(seed)
    with open(path, "w") as fh:
        for i in range(200):
            feats = sorted(rng.choice(12, size=rng.randint(0, 6), replace=False))
            toks = [str(rng.randint(0, 4))] + (["qid:3"] if qid else [])
            toks += [f"{j}:{rng.normal():.6g}" for j in feats]
            fh.write(" ".join(toks) + "\n")


def test_libsvm_equals_jax(jax_ref, tmp_path):
    from lightgbm_tpu.io.parser import parse_file as ref_parse

    p = str(tmp_path / "rank.svm")
    _write_libsvm(p, 1)
    got = parser.parse_file(p)
    _assert_same(got, ref_parse(p))
    _assert_same(got, parser._parse_libsvm_plain(p, False))


def test_libsvm_qid_token_raises_in_both(jax_ref, tmp_path):
    from lightgbm_tpu.io.parser import parse_file as ref_parse

    p = str(tmp_path / "qid.svm")
    _write_libsvm(p, 2, qid=True)
    with pytest.raises(ValueError):
        parser.parse_file(p)
    with pytest.raises(ValueError):
        ref_parse(p)


def test_side_files_equal_jax(jax_ref, tmp_path):
    from lightgbm_tpu.io import parser as ref

    data = str(tmp_path / "d.tsv")
    rng = np.random.RandomState(3)
    np.savetxt(data + ".weight", rng.rand(30), fmt="%.9g")
    np.savetxt(data + ".group", [10, 12, 8], fmt="%d")
    np.savetxt(data + ".position", rng.randint(0, 5, 30), fmt="%d")
    for name in ("load_weights", "load_query_boundaries", "load_positions"):
        got, want = getattr(parser, name)(data), getattr(ref, name)(data)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert parser.load_query_boundaries(str(tmp_path / "none")) is None
    np.savetxt(data + ".query", [30], fmt="%d")  # .query comes before .group
    np.testing.assert_array_equal(parser.load_query_boundaries(data), [30])


@pytest.mark.parametrize("delim", ["\t", ",", " "])
def test_native_equals_plain_parse(tmp_path, delim):
    X, y = _rows(4, 500, 5)
    p = str(tmp_path / "d.txt")
    _write_dense(p, X, y, delim)
    native_rows = parser._native_parse_dense(p, delim, 0)
    np.testing.assert_array_equal(native_rows, parser.plain_parse_dense(p, delim, 0))
    np.testing.assert_array_equal(native_rows[:, 1:], X)


def test_native_multishard_equals_plain_parse(tmp_path):
    """Past 4 MB the native parse splits the file at line boundaries into a
    shard a thread; the concatenation equals the plain parse."""
    rng = np.random.RandomState(3)
    M = rng.randn(70_000, 10)
    path = tmp_path / "big.csv"
    np.savetxt(path, M, delimiter=",", fmt="%.9g")
    assert path.stat().st_size > (4 << 20)
    got = parser._native_parse_dense(str(path), ",", 0)
    np.testing.assert_array_equal(got, parser.plain_parse_dense(str(path), ",", 0))


def test_malformed_rows_answer_as_jax(jax_ref, tmp_path):
    from lightgbm_tpu.io.parser import parse_file as ref_parse

    p = str(tmp_path / "bad.csv")
    with open(p, "w") as fh:
        fh.write("1,0.5,2.5\n0,1.5\n1,3.5,4.5\n0,na,?\n")
    assert parser._native_parse_dense(p, ",", 0) is None  # rejected natively
    got = parser.parse_file(p)
    _assert_same(got, ref_parse(p))


def test_parser_builds_outside_the_package():
    module = native.get_parser()
    built = Path(module.__file__)
    assert built.parent == native.BUILD_DIR
    package = Path(lightgbm_tpu_torch.__file__).parent
    assert not list(package.rglob("*.so"))
