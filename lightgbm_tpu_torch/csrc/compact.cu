// Row compaction for Hopper (sm_90a): the port of the TPU kernel
// lightgbm_tpu/ops/compact_pallas.py:compact_rows (Pallas call
// _pallas_compact_call, kernel _make_compact_kernel), reached from the wave
// learner (treelearner/device.py) at the bagged initial compaction and in
// every wave.
//
// What it computes. For a bin plane bins [G, N] uint8, a row payload
// rows [N, rc] float32 (the wave learner's gh channels, original position
// and leaf id) and a permutation dst [N] int32:
//   bins_out[g, dst[n]] = bins[g, n],   rows_out[dst[n], c] = rows[n, c]
// moving bits exactly (the payload travels as 32-bit words, never through
// float arithmetic). dst comes from ops/compact.py:range_partition_dst, a
// stable left|right partition of K disjoint leaf ranges with every other
// row mapped to itself; like the TPU kernel, which copies the untouched
// tiles too, this one touches all N rows.
//
// Design. The TPU has no fast scatter, so its kernel moves tiles through
// one-hot bf16 matmuls over (input tile, output tile) pairs; the card
// scatters directly. One thread per row, out of place into the learner's
// second buffer: it reads dst[n] and its payload row (a warp reads 32
// consecutive rows, so the loads are coalesced), writes the row at dst[n],
// then moves the row's byte of each group. Within a range the destinations
// of consecutive rows are two increasing runs, so the writes are mostly
// coalesced too. A destination outside [0, N) is skipped, never written.
//
// What bounds it. Bytes: read and write G + 4 * rc bytes a row, plus 4 bytes
// of dst — at HIGGS width (G = 28, rc = 5, N = 1,048,576) 2 * 48 + 4 = 100
// bytes a row, 105 MB, ~31 us at 3.35 TB/s. The byte-wide bin stores are
// the likely limit of this simple form.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void compact_rows_kernel(const uint8_t* __restrict__ bins,
                                    const uint32_t* __restrict__ rows,
                                    const int* __restrict__ dst, long long n, int g,
                                    int rc, uint8_t* __restrict__ bins_out,
                                    uint32_t* __restrict__ rows_out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long d = dst[i];
  if (d < 0 || d >= n) return;
  for (int c = 0; c < rc; ++c) rows_out[d * rc + c] = rows[i * rc + c];
  for (int gi = 0; gi < g; ++gi) bins_out[gi * n + d] = bins[gi * n + i];
}

}  // namespace

extern "C" {

// bins [G, N] uint8, rows [N, rc] float32 (as 32-bit words), dst [N] int32
// -> bins_out, rows_out of the same shapes. Returns cudaGetLastError()
// after the launch.
int lgbt_compact_rows(const uint8_t* bins, const uint32_t* rows, const int* dst,
                      long long n, int g, int rc, uint8_t* bins_out, uint32_t* rows_out,
                      void* stream) {
  if (n < 0 || g < 0 || rc < 0) return int(cudaErrorInvalidValue);
  if (n == 0) return int(cudaSuccess);
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  compact_rows_kernel<<<unsigned(blocks), threads, 0, static_cast<cudaStream_t>(stream)>>>(
      bins, rows, dst, n, g, rc, bins_out, rows_out);
  return int(cudaGetLastError());
}

}  // extern "C"
