/* lightgbm_tpu_torch C API: the LGBM_* surface of the reference's c_api.h.
 *
 * Built from capi/lgbm_capi.c with g++ at first use (lightgbm_tpu_torch.capi.
 * library_path()). Every function takes the GIL, initializing Python first
 * when a C program loads the library, and calls lightgbm_tpu_torch.capi.impl;
 * it returns 0, or -1 with the message in LGBM_GetLastError(). */
#ifndef LIGHTGBM_TPU_TORCH_C_H_
#define LIGHTGBM_TPU_TORCH_C_H_
#include <stdint.h>

#define C_API_DTYPE_FLOAT32 (0)
#define C_API_DTYPE_FLOAT64 (1)
#define C_API_DTYPE_INT32   (2)
#define C_API_DTYPE_INT64   (3)

#define C_API_PREDICT_NORMAL     (0)
#define C_API_PREDICT_RAW_SCORE  (1)
#define C_API_PREDICT_LEAF_INDEX (2)
#define C_API_PREDICT_CONTRIB    (3)

#ifdef __cplusplus
extern "C" {
#endif
/* declarations: begin */
typedef void* DatasetHandle;
typedef void* BoosterHandle;

const char* LGBM_GetLastError(void);

int LGBM_DatasetCreateFromMat(const void* data, int data_type,
                              int32_t nrow, int32_t ncol, int is_row_major,
                              const char* parameters,
                              DatasetHandle reference, DatasetHandle* out);
int LGBM_DatasetCreateFromFile(const char* filename, const char* parameters,
                               DatasetHandle reference, DatasetHandle* out);
int LGBM_DatasetSetField(DatasetHandle handle, const char* field_name,
                         const void* field_data, int32_t num_element,
                         int data_type);
int LGBM_DatasetGetNumData(DatasetHandle handle, int32_t* out);
int LGBM_DatasetGetNumFeature(DatasetHandle handle, int32_t* out);
int LGBM_DatasetFree(DatasetHandle handle);

int LGBM_DatasetCreateStreaming(int32_t ncol, const char* parameters,
                                DatasetHandle* out);
int LGBM_DatasetPushRows(DatasetHandle dataset, const void* data,
                         int data_type, int32_t nrow, int32_t ncol,
                         int32_t start_row);
int LGBM_DatasetPushRowsByCSR(DatasetHandle dataset, const void* indptr,
                              int indptr_type, const int32_t* indices,
                              const void* data, int data_type,
                              int64_t nindptr, int64_t nelem,
                              int64_t num_col, int64_t start_row);

int LGBM_BoosterCreate(DatasetHandle train_data, const char* parameters,
                       BoosterHandle* out);
int LGBM_BoosterAddValidData(BoosterHandle handle, DatasetHandle valid_data);
int LGBM_BoosterCreateFromModelfile(const char* filename,
                                    int* out_num_iterations,
                                    BoosterHandle* out);
int LGBM_BoosterLoadModelFromString(const char* model_str,
                                    int* out_num_iterations,
                                    BoosterHandle* out);
int LGBM_BoosterSaveModel(BoosterHandle handle, int start_iteration,
                          int num_iteration, int feature_importance_type,
                          const char* filename);
int LGBM_BoosterSaveModelToString(BoosterHandle handle, int start_iteration,
                                  int num_iteration,
                                  int feature_importance_type,
                                  int64_t buffer_len, int64_t* out_len,
                                  char* out_str);
int LGBM_BoosterUpdateOneIter(BoosterHandle handle, int* is_finished);
int LGBM_BoosterGetCurrentIteration(BoosterHandle handle, int* out_iteration);
int LGBM_BoosterGetNumClasses(BoosterHandle handle, int* out_len);
int LGBM_BoosterNumberOfTotalModel(BoosterHandle handle, int* out_models);
int LGBM_BoosterPredictForMat(BoosterHandle handle, const void* data,
                              int data_type, int32_t nrow, int32_t ncol,
                              int is_row_major, int predict_type,
                              int start_iteration, int num_iteration,
                              const char* parameter, int64_t* out_len,
                              double* out_result);
int LGBM_BoosterPredictForCSR(BoosterHandle handle, const void* indptr,
                              int indptr_type, const int32_t* indices,
                              const void* data, int data_type,
                              int64_t nindptr, int64_t nelem,
                              int64_t num_col, int predict_type,
                              int start_iteration, int num_iteration,
                              const char* parameter, int64_t* out_len,
                              double* out_result);
int LGBM_BoosterFree(BoosterHandle handle);
/* declarations: end */
#ifdef __cplusplus
}
#endif
#endif  /* LIGHTGBM_TPU_TORCH_C_H_ */
