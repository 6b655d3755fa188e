"""Build and load the port's host-side native sources with ``g++``.

Two sources build here at first use: ``native/parser.cpp`` (the text
parser, a CPython extension module with a threaded dense parse) and
``capi/lgbm_capi.c`` (the C API's exported ``LGBM_*`` symbols). Each
compiles into the repository's ``build/lightgbm_tpu_torch/`` (which
.gitignore lists), never into the package directory, under a name keyed by
the hash of its source and flags, so an edited source never loads a stale
build. A build writes a per-process temporary file and renames it into
place, so a concurrent process (a pytest-xdist worker) loads either the
old file or the whole new one. A build that fails raises with the
compiler's output: nothing falls back to running without the library.
"""
from __future__ import annotations

import hashlib
import importlib.util
import os
import shutil
import subprocess
import sysconfig
import threading
from pathlib import Path
from typing import Sequence

BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "lightgbm_tpu_torch"
_PARSER_SRC = Path(__file__).resolve().parent / "parser.cpp"
_lock = threading.Lock()
_parser = None


def python_include() -> str:
    return sysconfig.get_paths()["include"]


def build_host_library(source: Path, flags: Sequence[str], suffix: str = ".so",
                       depends: Sequence[Path] = (), libs: Sequence[str] = ()) -> Path:
    """Compile `source` with g++ and `flags`, linking `libs` after it, into
    BUILD_DIR unless its library is there already; returns the library's
    path. The files it includes (`depends`) are hashed with it."""
    flags = tuple(flags)
    libs = tuple(libs)
    digest = hashlib.sha256(source.read_bytes() + " ".join(flags + libs).encode())
    for dep in depends:
        digest.update(dep.read_bytes())
    tag = digest.hexdigest()[:16]
    out = BUILD_DIR / f"{source.stem}_{tag}{suffix}"
    if out.exists():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(f"g++ not found: {source.name} is built from source at first use")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([gxx, *flags, str(source), *libs, "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed to build {source.name}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a racing process loads either file
    return out


def get_parser():
    """The compiled ``_lgbt_torch_parser`` module, built at first use."""
    global _parser
    with _lock:
        if _parser is None:
            path = build_host_library(
                _PARSER_SRC, ("-O2", "-shared", "-fPIC", "-pthread", f"-I{python_include()}"),
                suffix=sysconfig.get_config_var("EXT_SUFFIX") or ".so")
            spec = importlib.util.spec_from_file_location("_lgbt_torch_parser", path)
            module = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(module)
            _parser = module
        return _parser
