"""Text data parsers: CSV / TSV / LibSVM with format autodetection.

Counterpart of the JAX package's ``io/parser.py`` (the reference Parser
factory, include/LightGBM/dataset.h:401-482, src/io/parser.cpp): detects the
delimiter and format from the first data lines, handles ``label_column``
(an index or a ``name:`` prefix), headers, ignore columns, and the side
files the CLI reads (``<data>.weight``, ``<data>.query`` / ``<data>.group``,
``<data>.position``; dataset_loader.cpp's metadata loading).

Parsing is host work on numpy; the result feeds Dataset.from_matrix. Dense
files and LibSVM files go through the native parser (``native/parser.cpp``,
built with g++ at first use; a failed build raises). ``np.genfromtxt`` is
the dense parser's plain version, and answers where the native parser
rejects a file (a row with another column count) or ``max_rows`` is set,
as in the JAX package.
"""
from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..native import get_parser
from ..utils.log import Log


def _detect_format(sample_lines: List[str]) -> Tuple[str, str]:
    """Returns (kind, delimiter) with kind in {csv, tsv, libsvm}."""
    for line in sample_lines:
        if not line.strip():
            continue
        tokens = line.replace("\t", " ").split()
        colon_tokens = sum(1 for t in tokens[1:] if ":" in t)
        if tokens and colon_tokens and colon_tokens >= max(1, (len(tokens) - 1) // 2):
            return "libsvm", " "
        if "\t" in line:
            return "tsv", "\t"
        if "," in line:
            return "csv", ","
        return "csv", " "
    return "csv", "\t"


def _native_parse_dense(path: str, delim: str, skip_header: int) -> Optional[np.ndarray]:
    """The native dense parse; None where it rejects the file (a row with
    another column count) or finds no values: the plain parse answers."""
    try:
        buf, nrows, ncols = get_parser().parse_dense(
            path, 0 if delim == " " else ord(delim), int(skip_header))
    except ValueError:
        return None
    if nrows == 0 or ncols == 0:
        return None
    return np.frombuffer(buf, dtype=np.float64).reshape(nrows, ncols)


def plain_parse_dense(path: str, delim: str, skip_header: int,
                      max_rows: Optional[int] = None) -> np.ndarray:
    """The dense parser's plain version (numpy)."""
    return np.genfromtxt(path, delimiter=delim if delim != " " else None,
                         skip_header=skip_header, dtype=np.float64,
                         max_rows=max_rows, loose=True, invalid_raise=False)


def parse_file(path: str, header: bool = False, label_column: str = "0",
               ignore_columns: Sequence = (), max_rows: Optional[int] = None
               ) -> Tuple[np.ndarray, np.ndarray, List[str]]:
    """Parse a data file -> (X [N,F] float64, y [N] float64, feature_names).

    label_column follows the reference convention: an integer index into the
    file's columns, or "name:<colname>" with header=True. The label column is
    removed from X (Parser label_idx handling, parser.cpp).
    """
    with open(path) as fh:
        first = []
        for _ in range(3):
            line = fh.readline()
            if not line:
                break
            first.append(line.rstrip("\n"))
    kind, delim = _detect_format(first[1:] if header else first)
    if kind == "libsvm":
        return _parse_libsvm(path, header)

    names: List[str] = []
    skip = 1 if header else 0
    if header and first:
        names = [t.strip() for t in first[0].split(delim)]

    label_idx = 0
    if isinstance(label_column, str) and label_column.startswith("name:"):
        want = label_column[5:]
        if want not in names:
            Log.fatal("Could not find label column %s in data file", want)
        label_idx = names.index(want)
    elif label_column not in (None, ""):
        label_idx = int(label_column)

    raw = _native_parse_dense(path, delim, skip) if max_rows is None else None
    if raw is None:
        raw = plain_parse_dense(path, delim, skip, max_rows)
    if raw.ndim == 1:
        raw = raw.reshape(-1, 1)
    ncol = raw.shape[1]

    ignore = set()
    for c in ignore_columns:
        if isinstance(c, str) and c.startswith("name:"):
            for nm in c[5:].split(","):
                if nm in names:
                    ignore.add(names.index(nm))
        else:
            ignore.add(int(c))

    y = raw[:, label_idx].copy() if label_idx >= 0 else np.zeros(len(raw))
    keep = [c for c in range(ncol) if c != label_idx and c not in ignore]
    X = raw[:, keep]
    if names:
        feature_names = [names[c] for c in keep]
    else:
        feature_names = [f"Column_{i}" for i in range(len(keep))]
    return X, y, feature_names


def _parse_libsvm(path: str, header: bool) -> Tuple[np.ndarray, np.ndarray, List[str]]:
    """LibSVM through the native parser; where it rejects the file (a
    non-numeric feature index) the Python loop answers, as in the JAX
    package."""
    try:
        lab_buf, tri_buf, max_feat = get_parser().parse_libsvm(path, int(header))
    except ValueError:
        return _parse_libsvm_plain(path, header)
    y = np.frombuffer(lab_buf, dtype=np.float64).copy()
    trips = np.frombuffer(tri_buf, dtype=np.float64).reshape(-1, 3)
    X = np.zeros((len(y), int(max_feat) + 1), dtype=np.float64)
    X[trips[:, 0].astype(np.int64), trips[:, 1].astype(np.int64)] = trips[:, 2]
    return X, y, [f"Column_{i}" for i in range(int(max_feat) + 1)]


def _parse_libsvm_plain(path: str, header: bool) -> Tuple[np.ndarray, np.ndarray, List[str]]:
    rows: List[dict] = []
    labels: List[float] = []
    max_feat = -1
    with open(path) as fh:
        if header:
            fh.readline()
        for line in fh:
            toks = line.split()
            if not toks:
                continue
            labels.append(float(toks[0]))
            feats = {}
            for t in toks[1:]:
                if ":" not in t:
                    continue
                k, v = t.split(":", 1)
                k = int(k)
                feats[k] = float(v)
                max_feat = max(max_feat, k)
            rows.append(feats)
    X = np.zeros((len(rows), max_feat + 1), dtype=np.float64)
    for i, feats in enumerate(rows):
        for k, v in feats.items():
            X[i, k] = v
    names = [f"Column_{i}" for i in range(max_feat + 1)]
    return X, np.asarray(labels), names


def load_side_file(data_path: str, suffixes: Sequence[str], dtype) -> Optional[np.ndarray]:
    """Load `<data>.weight` / `<data>.query` style side files if present."""
    for suf in suffixes:
        p = data_path + suf
        if os.path.exists(p):
            return np.loadtxt(p, dtype=dtype).ravel()
    return None


def load_query_boundaries(data_path: str) -> Optional[np.ndarray]:
    return load_side_file(data_path, [".query", ".group"], np.int64)


def load_weights(data_path: str) -> Optional[np.ndarray]:
    return load_side_file(data_path, [".weight"], np.float64)


def load_positions(data_path: str) -> Optional[np.ndarray]:
    return load_side_file(data_path, [".position"], np.int64)
