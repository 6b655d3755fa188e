/* The C API's exported LGBM_* symbols (lightgbm_tpu_torch_c.h).
 *
 * The engine is Python, so each function is a trampoline: it takes the GIL
 * (PyGILState_Ensure), calls the function of the same name in
 * lightgbm_tpu_torch.capi.impl with every pointer passed as an integer, and
 * returns its status. impl catches its own exceptions and keeps the
 * message; on a nonzero status the message is copied into this thread's
 * buffer, which LGBM_GetLastError returns (c_api.cpp's thread_local
 * convention). Loaded into a Python process (ctypes) the running
 * interpreter serves the calls; loaded by a C program, the first call
 * initializes Python, puts the repository root (LGBM_TPU_TORCH_ROOT, set at
 * build time) on sys.path and releases the GIL for the calls to take.
 *
 * Built with g++ by lightgbm_tpu_torch.capi.library_path(). */
#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <pthread.h>
#include <stdarg.h>
#include <stdint.h>
#include <string.h>

#include "lightgbm_tpu_torch_c.h"

#ifndef LGBM_TPU_TORCH_ROOT
#error "LGBM_TPU_TORCH_ROOT (the repository root) must be defined at build time"
#endif

#define P(x) ((unsigned long long)(uintptr_t)(x))

static __thread char g_last_error[4096] = "ok";
static pthread_once_t g_python_once = PTHREAD_ONCE_INIT;

static void set_error(const char* msg) {
  strncpy(g_last_error, msg, sizeof(g_last_error) - 1);
  g_last_error[sizeof(g_last_error) - 1] = '\0';
}

static void start_python(void) {
  if (Py_IsInitialized()) return;
  Py_InitializeEx(0);
  PyObject* path = PySys_GetObject("path"); /* borrowed */
  PyObject* root = PyUnicode_FromString(LGBM_TPU_TORCH_ROOT);
  if (path && root) PyList_Insert(path, 0, root);
  Py_XDECREF(root);
  PyEval_SaveThread(); /* every call takes the GIL with PyGILState_Ensure */
}

/* The message of the pending Python exception, or `fallback`. */
static void error_from_python(const char* fallback) {
  PyObject *type = NULL, *value = NULL, *tb = NULL;
  PyErr_Fetch(&type, &value, &tb);
  PyObject* text = value ? PyObject_Str(value) : NULL;
  const char* msg = text ? PyUnicode_AsUTF8(text) : NULL;
  set_error(msg ? msg : fallback);
  Py_XDECREF(text);
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(tb);
  PyErr_Clear();
}

/* impl.<name>(*args), args built from `fmt`; returns its int status. */
static int call_impl(const char* name, const char* fmt, ...) {
  pthread_once(&g_python_once, start_python);
  PyGILState_STATE gil = PyGILState_Ensure();
  int rc = -1;
  PyObject* impl = PyImport_ImportModule("lightgbm_tpu_torch.capi.impl");
  PyObject* fn = impl ? PyObject_GetAttrString(impl, name) : NULL;
  PyObject* args = NULL;
  PyObject* res = NULL;
  if (fn) {
    va_list ap;
    va_start(ap, fmt);
    args = Py_VaBuildValue(fmt, ap);
    va_end(ap);
  }
  if (args) res = PyObject_CallObject(fn, args);
  if (res) rc = (int)PyLong_AsLong(res);
  if (PyErr_Occurred()) {
    error_from_python(name);
    rc = -1;
  } else if (rc != 0) {
    PyObject* msg = PyObject_CallMethod(impl, "last_error", NULL);
    const char* text = msg ? PyUnicode_AsUTF8(msg) : NULL;
    if (text) {
      set_error(text);
    } else {
      error_from_python(name);
    }
    Py_XDECREF(msg);
  }
  Py_XDECREF(res);
  Py_XDECREF(args);
  Py_XDECREF(fn);
  Py_XDECREF(impl);
  PyGILState_Release(gil);
  return rc;
}

const char* LGBM_GetLastError(void) { return g_last_error; }

int LGBM_DatasetCreateFromMat(const void* data, int data_type, int32_t nrow, int32_t ncol,
                              int is_row_major, const char* parameters,
                              DatasetHandle reference, DatasetHandle* out) {
  return call_impl("dataset_create_from_mat", "(KiiiiKKK)", P(data), data_type, (int)nrow,
                   (int)ncol, is_row_major, P(parameters), P(reference), P(out));
}

int LGBM_DatasetCreateFromFile(const char* filename, const char* parameters,
                               DatasetHandle reference, DatasetHandle* out) {
  return call_impl("dataset_create_from_file", "(KKKK)", P(filename), P(parameters),
                   P(reference), P(out));
}

int LGBM_DatasetSetField(DatasetHandle handle, const char* field_name, const void* field_data,
                         int32_t num_element, int data_type) {
  return call_impl("dataset_set_field", "(KKKii)", P(handle), P(field_name), P(field_data),
                   (int)num_element, data_type);
}

int LGBM_DatasetGetNumData(DatasetHandle handle, int32_t* out) {
  return call_impl("dataset_get_num_data", "(KK)", P(handle), P(out));
}

int LGBM_DatasetGetNumFeature(DatasetHandle handle, int32_t* out) {
  return call_impl("dataset_get_num_feature", "(KK)", P(handle), P(out));
}

int LGBM_DatasetFree(DatasetHandle handle) {
  return call_impl("dataset_free", "(K)", P(handle));
}

int LGBM_DatasetCreateStreaming(int32_t ncol, const char* parameters, DatasetHandle* out) {
  return call_impl("dataset_create_streaming", "(iKK)", (int)ncol, P(parameters), P(out));
}

int LGBM_DatasetPushRows(DatasetHandle dataset, const void* data, int data_type, int32_t nrow,
                         int32_t ncol, int32_t start_row) {
  return call_impl("dataset_push_rows", "(KKiiii)", P(dataset), P(data), data_type, (int)nrow,
                   (int)ncol, (int)start_row);
}

int LGBM_DatasetPushRowsByCSR(DatasetHandle dataset, const void* indptr, int indptr_type,
                              const int32_t* indices, const void* data, int data_type,
                              int64_t nindptr, int64_t nelem, int64_t num_col,
                              int64_t start_row) {
  return call_impl("dataset_push_rows_by_csr", "(KKiKKiLLLL)", P(dataset), P(indptr),
                   indptr_type, P(indices), P(data), data_type, (long long)nindptr,
                   (long long)nelem, (long long)num_col, (long long)start_row);
}

int LGBM_BoosterCreate(DatasetHandle train_data, const char* parameters, BoosterHandle* out) {
  return call_impl("booster_create", "(KKK)", P(train_data), P(parameters), P(out));
}

int LGBM_BoosterAddValidData(BoosterHandle handle, DatasetHandle valid_data) {
  return call_impl("booster_add_valid_data", "(KK)", P(handle), P(valid_data));
}

int LGBM_BoosterCreateFromModelfile(const char* filename, int* out_num_iterations,
                                    BoosterHandle* out) {
  return call_impl("booster_create_from_modelfile", "(KKK)", P(filename),
                   P(out_num_iterations), P(out));
}

int LGBM_BoosterLoadModelFromString(const char* model_str, int* out_num_iterations,
                                    BoosterHandle* out) {
  return call_impl("booster_load_model_from_string", "(KKK)", P(model_str),
                   P(out_num_iterations), P(out));
}

int LGBM_BoosterSaveModel(BoosterHandle handle, int start_iteration, int num_iteration,
                          int feature_importance_type, const char* filename) {
  return call_impl("booster_save_model", "(KiiiK)", P(handle), start_iteration, num_iteration,
                   feature_importance_type, P(filename));
}

int LGBM_BoosterSaveModelToString(BoosterHandle handle, int start_iteration, int num_iteration,
                                  int feature_importance_type, int64_t buffer_len,
                                  int64_t* out_len, char* out_str) {
  return call_impl("booster_save_model_to_string", "(KiiiLKK)", P(handle), start_iteration,
                   num_iteration, feature_importance_type, (long long)buffer_len, P(out_len),
                   P(out_str));
}

int LGBM_BoosterUpdateOneIter(BoosterHandle handle, int* is_finished) {
  return call_impl("booster_update_one_iter", "(KK)", P(handle), P(is_finished));
}

int LGBM_BoosterGetCurrentIteration(BoosterHandle handle, int* out_iteration) {
  return call_impl("booster_get_current_iteration", "(KK)", P(handle), P(out_iteration));
}

int LGBM_BoosterGetNumClasses(BoosterHandle handle, int* out_len) {
  return call_impl("booster_get_num_classes", "(KK)", P(handle), P(out_len));
}

int LGBM_BoosterNumberOfTotalModel(BoosterHandle handle, int* out_models) {
  return call_impl("booster_number_of_total_model", "(KK)", P(handle), P(out_models));
}

int LGBM_BoosterPredictForMat(BoosterHandle handle, const void* data, int data_type,
                              int32_t nrow, int32_t ncol, int is_row_major, int predict_type,
                              int start_iteration, int num_iteration, const char* parameter,
                              int64_t* out_len, double* out_result) {
  return call_impl("booster_predict_for_mat", "(KKiiiiiiiKKK)", P(handle), P(data), data_type,
                   (int)nrow, (int)ncol, is_row_major, predict_type, start_iteration,
                   num_iteration, P(parameter), P(out_len), P(out_result));
}

int LGBM_BoosterPredictForCSR(BoosterHandle handle, const void* indptr, int indptr_type,
                              const int32_t* indices, const void* data, int data_type,
                              int64_t nindptr, int64_t nelem, int64_t num_col,
                              int predict_type, int start_iteration, int num_iteration,
                              const char* parameter, int64_t* out_len, double* out_result) {
  return call_impl("booster_predict_for_csr", "(KKiKKiLLLiiiKKK)", P(handle), P(indptr),
                   indptr_type, P(indices), P(data), data_type, (long long)nindptr,
                   (long long)nelem, (long long)num_col, predict_type, start_iteration,
                   num_iteration, P(parameter), P(out_len), P(out_result));
}

int LGBM_BoosterFree(BoosterHandle handle) {
  return call_impl("booster_free", "(K)", P(handle));
}
