// A CUDA stream of the caller's own, for graph captures (ops/cuda_build.py:
// capture_stream). It holds no kernel.
//
// Why not torch.cuda.Stream(): PyTorch hands its streams out round robin
// from a pool of 32 a priority and device, so a new torch.cuda.Stream() can
// be the very stream another thread already works on (a prediction
// service's batcher, serving/batcher.py). A capture on such a stream
// records that thread's launches into the graph, and PyTorch refuses that
// thread's copies from pageable host memory while its stream captures. A
// stream made here belongs to the capturing thread alone; it is
// non-blocking, so the legacy default stream's work never joins a capture.

#include <cuda_runtime.h>

extern "C" {

// A new non-blocking stream on `device` through stream_out; returns a
// cudaError_t. The calling thread's current device is restored.
int lgbt_stream_create(int device, void** stream_out) {
  int previous = 0;
  cudaError_t err = cudaGetDevice(&previous);
  if (err != cudaSuccess) return int(err);
  if ((err = cudaSetDevice(device)) != cudaSuccess) return int(err);
  cudaStream_t stream = nullptr;
  err = cudaStreamCreateWithFlags(&stream, cudaStreamNonBlocking);
  cudaError_t back = cudaSetDevice(previous);
  if (err != cudaSuccess) return int(err);
  *stream_out = stream;
  return int(back);
}

int lgbt_stream_destroy(void* stream) {
  return int(cudaStreamDestroy(static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
