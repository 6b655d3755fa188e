// Native text parser for lightgbm_tpu_torch.
//
// Counterpart of the reference's C++ Parser stack
// (src/io/parser.cpp CSVParser/TSVParser/LibSVMParser + the OMP block
// parsing in src/io/dataset_loader.cpp LoadTextDataToMemory): tokenizes
// CSV/TSV (single-char or whitespace delimited) and LibSVM files with
// strtod. Dense parsing is PIPELINED: the buffer splits at line boundaries
// into one shard per hardware thread, shards parse concurrently with the
// GIL released, results concatenate in order — the std::thread analog of
// the reference's `#pragma omp parallel for` over line blocks. Exposed as
// a tiny CPython extension module (no pybind11 — plain Python C API)
// returning raw double buffers the Python side wraps with np.frombuffer;
// built on demand by __init__.py into build/lightgbm_tpu_torch/.
#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cctype>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

bool read_file(const char* path, std::string* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  out->resize(static_cast<size_t>(size));
  size_t got = size ? std::fread(&(*out)[0], 1, static_cast<size_t>(size), f)
                    : 0;
  std::fclose(f);
  out->resize(got);
  return true;
}

inline double parse_token(const char* tok, const char* end) {
  if (tok == end) return NAN;
  char* stop = nullptr;
  double v = std::strtod(tok, &stop);
  if (stop == tok) {
    // na / NA / ? / empty -> NaN (reference Atof NaN semantics)
    return NAN;
  }
  return v;
}

struct ShardResult {
  std::vector<double> values;
  long rows = 0;
  long ncols = -1;
  bool bad = false;  // inconsistent column count inside this shard
};

// parse one [p, fend) line-aligned shard; delim == 0 means "any whitespace"
void parse_dense_range(const char* p, const char* fend, char delim,
                       ShardResult* out) {
  while (p < fend) {
    const char* line_end = static_cast<const char*>(
        std::memchr(p, '\n', static_cast<size_t>(fend - p)));
    if (!line_end) line_end = fend;
    const char* q = p;
    const char* qe = line_end;
    if (qe > q && qe[-1] == '\r') --qe;
    if (q == qe) {  // blank line
      p = line_end + 1;
      continue;
    }
    long row_cols = 0;
    if (delim == 0) {
      while (q < qe) {
        while (q < qe && std::isspace(static_cast<unsigned char>(*q))) ++q;
        if (q >= qe) break;
        const char* tok = q;
        while (q < qe && !std::isspace(static_cast<unsigned char>(*q))) ++q;
        out->values.push_back(parse_token(tok, q));
        ++row_cols;
      }
    } else {
      const char* tok = q;
      for (;; ++q) {
        if (q == qe || *q == delim) {
          out->values.push_back(parse_token(tok, q));
          ++row_cols;
          if (q == qe) break;
          tok = q + 1;
        }
      }
    }
    if (out->ncols < 0) {
      out->ncols = row_cols;
    } else if (row_cols != out->ncols) {
      out->bad = true;
      return;
    }
    ++out->rows;
    p = line_end + 1;
  }
}

// dense CSV/TSV: pipelined over hardware threads, GIL released
PyObject* parse_dense(PyObject*, PyObject* args) {
  const char* path;
  int delim_int, skip_header;
  if (!PyArg_ParseTuple(args, "sii", &path, &delim_int, &skip_header)) {
    return nullptr;
  }
  const char delim = static_cast<char>(delim_int);
  std::string buf;
  if (!read_file(path, &buf)) {
    PyErr_SetString(PyExc_OSError, "cannot open data file");
    return nullptr;
  }
  const char* p = buf.data();
  const char* fend = p + buf.size();
  if (skip_header && p < fend) {  // drop the first line
    const char* line_end = static_cast<const char*>(
        std::memchr(p, '\n', static_cast<size_t>(fend - p)));
    p = line_end ? line_end + 1 : fend;
  }

  unsigned hw = std::thread::hardware_concurrency();
  size_t n_shards = hw ? (hw > 16 ? 16 : hw) : 1;
  if (static_cast<size_t>(fend - p) < (4u << 20)) n_shards = 1;
  std::vector<ShardResult> shards(n_shards);
  {
    // shard boundaries snapped forward to the next newline
    std::vector<const char*> starts(n_shards + 1);
    size_t span = static_cast<size_t>(fend - p) / n_shards;
    starts[0] = p;
    for (size_t s = 1; s < n_shards; ++s) {
      const char* cut = p + s * span;
      if (cut >= fend) {
        cut = fend;
      } else {
        const char* nl = static_cast<const char*>(
            std::memchr(cut, '\n', static_cast<size_t>(fend - cut)));
        cut = nl ? nl + 1 : fend;
      }
      starts[s] = cut < starts[s - 1] ? starts[s - 1] : cut;
    }
    starts[n_shards] = fend;

    Py_BEGIN_ALLOW_THREADS;
    std::vector<std::thread> workers;
    for (size_t s = 1; s < n_shards; ++s) {
      workers.emplace_back(parse_dense_range, starts[s], starts[s + 1],
                           delim, &shards[s]);
    }
    parse_dense_range(starts[0], starts[1], delim, &shards[0]);
    for (auto& w : workers) w.join();
    Py_END_ALLOW_THREADS;
  }

  Py_ssize_t nrows = 0, ncols = -1;
  size_t total_values = 0;
  for (const auto& sh : shards) {
    if (sh.bad) {
      PyErr_SetString(PyExc_ValueError, "inconsistent column count");
      return nullptr;
    }
    if (sh.ncols >= 0) {
      if (ncols < 0) {
        ncols = sh.ncols;
      } else if (sh.ncols != ncols) {
        PyErr_SetString(PyExc_ValueError, "inconsistent column count");
        return nullptr;
      }
    }
    nrows += sh.rows;
    total_values += sh.values.size();
  }
  if (ncols < 0) ncols = 0;
  PyObject* bytes = PyBytes_FromStringAndSize(
      nullptr, static_cast<Py_ssize_t>(total_values * sizeof(double)));
  if (!bytes) return nullptr;
  char* dst = PyBytes_AS_STRING(bytes);
  for (const auto& sh : shards) {
    std::memcpy(dst, sh.values.data(), sh.values.size() * sizeof(double));
    dst += sh.values.size() * sizeof(double);
  }
  return Py_BuildValue("(Nnn)", bytes, nrows, ncols);
}

// LibSVM: label idx:val idx:val ... -> (labels, triplets of (row, col, val))
PyObject* parse_libsvm(PyObject*, PyObject* args) {
  const char* path;
  int skip_header;
  if (!PyArg_ParseTuple(args, "si", &path, &skip_header)) return nullptr;
  std::string buf;
  if (!read_file(path, &buf)) {
    PyErr_SetString(PyExc_OSError, "cannot open data file");
    return nullptr;
  }
  std::vector<double> labels;
  std::vector<double> trips;  // row, col, val
  long max_feat = -1;
  const char* p = buf.data();
  const char* fend = p + buf.size();
  int line_no = 0;
  long row = 0;
  while (p < fend) {
    const char* line_end = static_cast<const char*>(
        std::memchr(p, '\n', static_cast<size_t>(fend - p)));
    if (!line_end) line_end = fend;
    const char* q = p;
    const char* qe = line_end;
    if (qe > q && qe[-1] == '\r') --qe;
    ++line_no;
    if ((skip_header && line_no == 1) || q == qe) {
      p = line_end + 1;
      continue;
    }
    bool first = true;
    while (q < qe) {
      while (q < qe && std::isspace(static_cast<unsigned char>(*q))) ++q;
      if (q >= qe) break;
      const char* tok = q;
      while (q < qe && !std::isspace(static_cast<unsigned char>(*q))) ++q;
      const char* colon = static_cast<const char*>(
          std::memchr(tok, ':', static_cast<size_t>(q - tok)));
      if (first && !colon) {
        labels.push_back(parse_token(tok, q));
        first = false;
      } else if (colon) {
        if (first) {  // qid-less line starting with idx:val -> label 0
          labels.push_back(0.0);
          first = false;
        }
        // the index must be purely numeric: `qid:3`-style tokens are NOT
        // silently coerced (strtol would map them to feature 0) — error out
        // so the caller surfaces the same failure as the python parser
        for (const char* c = tok; c < colon; ++c) {
          if (!std::isdigit(static_cast<unsigned char>(*c))) {
            PyErr_Format(PyExc_ValueError,
                         "non-numeric feature index in libsvm token at "
                         "line %d", line_no);
            return nullptr;
          }
        }
        long idx = std::strtol(tok, nullptr, 10);
        double val = parse_token(colon + 1, q);
        if (idx > max_feat) max_feat = idx;
        trips.push_back(static_cast<double>(row));
        trips.push_back(static_cast<double>(idx));
        trips.push_back(val);
      }
    }
    if (first) labels.push_back(0.0);
    ++row;
    p = line_end + 1;
  }
  PyObject* lab = PyBytes_FromStringAndSize(
      reinterpret_cast<const char*>(labels.data()),
      static_cast<Py_ssize_t>(labels.size() * sizeof(double)));
  PyObject* tri = PyBytes_FromStringAndSize(
      reinterpret_cast<const char*>(trips.data()),
      static_cast<Py_ssize_t>(trips.size() * sizeof(double)));
  if (!lab || !tri) return nullptr;
  return Py_BuildValue("(NNl)", lab, tri, max_feat);
}

PyMethodDef methods[] = {
    {"parse_dense", parse_dense, METH_VARARGS,
     "parse_dense(path, delim_ord, skip_header) -> (bytes, nrows, ncols)"},
    {"parse_libsvm", parse_libsvm, METH_VARARGS,
     "parse_libsvm(path, skip_header) -> (labels, triplets, max_feat)"},
    {nullptr, nullptr, 0, nullptr}};

PyModuleDef moduledef = {PyModuleDef_HEAD_INIT, "_lgbt_torch_parser",
                         "native text parser", -1, methods,
                         nullptr, nullptr, nullptr, nullptr};

}  // namespace

PyMODINIT_FUNC PyInit__lgbt_torch_parser(void) {
  return PyModule_Create(&moduledef);
}
