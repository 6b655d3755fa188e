"""C API: a shared library exporting the reference's LGBM_* surface.

Counterpart of the JAX package's ``capi/`` (the reference's src/c_api.cpp
and include/LightGBM/c_api.h). The engine is Python, so the library is a
small C source, ``lgbm_capi.c``, whose exported functions take the GIL and
call ``impl`` (this package's handle registry over ``Dataset`` and
``Booster``); it embeds no interpreter of its own, so a C program that
loads it starts one at its first call. It is built with g++ against the
Python headers into ``build/lightgbm_tpu_torch/`` at first use
(`library_path`), and C clients include ``lightgbm_tpu_torch_c.h``:

    LGBM_DatasetCreateFromFile -> LGBM_BoosterCreate ->
    LGBM_BoosterUpdateOneIter -> LGBM_BoosterPredictForMat ->
    LGBM_BoosterSaveModel / LGBM_GetLastError

From Python, `load()` opens the library through ctypes with every
function's argument and result types set from the header. The streaming
handles (LGBM_DatasetCreateStreaming, LGBM_DatasetPushRows*) push rows into
a `streaming.RowBlockStore`, which LGBM_BoosterCreate finalizes.

Constants mirror c_api.h:35-43 (dtype and predict-type enums).
"""
from __future__ import annotations

import ctypes
import re
import sysconfig
from pathlib import Path

C_API_DTYPE_FLOAT32 = 0
C_API_DTYPE_FLOAT64 = 1
C_API_DTYPE_INT32 = 2
C_API_DTYPE_INT64 = 3

C_API_PREDICT_NORMAL = 0
C_API_PREDICT_RAW_SCORE = 1
C_API_PREDICT_LEAF_INDEX = 2
C_API_PREDICT_CONTRIB = 3

_DIR = Path(__file__).resolve().parent
SOURCE = _DIR / "lgbm_capi.c"
HEADER = _DIR / "lightgbm_tpu_torch_c.h"
REPO_ROOT = _DIR.parents[1]

_CTYPES = {
    "int": ctypes.c_int, "int32_t": ctypes.c_int32, "int64_t": ctypes.c_int64,
    "const void*": ctypes.c_void_p, "const char*": ctypes.c_char_p, "char*": ctypes.c_void_p,
    "DatasetHandle": ctypes.c_void_p, "BoosterHandle": ctypes.c_void_p,
    "DatasetHandle*": ctypes.POINTER(ctypes.c_void_p),
    "BoosterHandle*": ctypes.POINTER(ctypes.c_void_p),
    "int*": ctypes.POINTER(ctypes.c_int), "int32_t*": ctypes.POINTER(ctypes.c_int32),
    "int64_t*": ctypes.POINTER(ctypes.c_int64), "double*": ctypes.POINTER(ctypes.c_double),
    "const int32_t*": ctypes.c_void_p,
}


def declarations() -> str:
    """The header's declarations block (the functions and handle types)."""
    text = HEADER.read_text()
    return text.split("/* declarations: begin */")[1].split("/* declarations: end */")[0]


def signatures():
    """{name: (result type, [argument types])} parsed from the header, as
    C type spellings."""
    out = {}
    for m in re.finditer(r"(const char\*|int)\s+(LGBM_\w+)\(([^)]*)\);", declarations()):
        args = []
        for arg in m.group(3).split(","):
            arg = " ".join(arg.split())
            if arg in ("void", ""):
                continue
            args.append(arg.rsplit(" ", 1)[0].replace(" *", "*"))
        out[m.group(2)] = (m.group(1), args)
    return out


def _libpython():
    """libpython to link, where Python is a shared library: a C program
    that loads the C API gets it with it, and a Python process already
    holds the same library (one soname)."""
    if not sysconfig.get_config_var("Py_ENABLE_SHARED"):
        return []
    libdir = sysconfig.get_config_var("LIBDIR")
    return [f"-L{libdir}", f"-l:{sysconfig.get_config_var('INSTSONAME')}",
            f"-Wl,-rpath,{libdir}"]


def library_path() -> Path:
    """The built library (g++ at first use; a failed build raises)."""
    from ..native import build_host_library, python_include

    flags = ["-O2", "-shared", "-fPIC", "-pthread", f"-I{python_include()}", f"-I{_DIR}",
             f'-DLGBM_TPU_TORCH_ROOT="{REPO_ROOT}"']
    return build_host_library(SOURCE, flags, depends=(HEADER,), libs=_libpython())


def load() -> ctypes.CDLL:
    """The library through ctypes, each function's types set from the
    header."""
    lib = ctypes.CDLL(str(library_path()))
    for name, (res, args) in signatures().items():
        fn = getattr(lib, name)
        fn.restype = _CTYPES[res]
        fn.argtypes = [_CTYPES[a] for a in args]
    return lib
