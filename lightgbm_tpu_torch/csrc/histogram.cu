// Leaf histogram for Hopper (sm_90a): the port of the TPU kernel
// lightgbm_tpu/ops/hist_pallas.py:pallas_histogram (kernel body _make_kernel),
// reached on the TPU through ops/histogram.py:build_histogram_rows, which
// gathers the leaf's rows with a separate jnp.take before the kernel.
//
// What it computes. For a bin plane bins [G, N] uint8, gradients gh [*, CH]
// and a leaf's padded row-index set idx [P] (sentinel N = no row):
//   hist[g, b, c] = sum over p < P with idx[p] < N of
//                   [bins[g, idx[p]] == b] * gh[idx[p], c]
// (with idx == NULL, the identity: every row p < P). Float mode takes float32
// gh and sums in float32; integer mode takes int8 gh and sums exactly in int32
// (the TPU kernel's quantized=True). The gather is done here, through idx: no
// [G, P] copy of the leaf's bins is made. Sentinel rows carry a zero gh row,
// so they are skipped without reading bins.
//
// Design. Pass 1: grid (row chunks, group blocks); 8 warps per block. Every
// warp owns a private histogram in shared memory for the block's GB groups
// ([GB, B, CH] of float or int, 3 KB per group at B=256, CH=3). A warp takes
// 32 consecutive positions at a time, in a fixed order; each lane stages its
// row's gh in shared memory, then for each group the lanes whose rows fall in
// the same bin find each other with __match_any_sync and the lowest such lane
// adds their staged values in ascending lane order and then adds that sum to
// the warp's bin. The warps' histograms are then summed in warp order and
// written as the block's partial. Pass 2 sums the partials of the row chunks
// in chunk order. No float atomics anywhere: the sum order is fixed by the
// shapes alone, so two launches give the same bits (the determinism the
// JAX package's byte-identical-model promise needs). A leaf small enough for
// one chunk is written by pass 1 directly.
//
// What bounds it. Bytes: the gathered bins (G bytes per row), gh (CH * 4 bytes
// per row), idx (4 bytes per position) and the output — at the HIGGS root
// (G = 28, P = N = 1,048,576) 29.4 + 12.6 + 4.2 MB, ~14 us at 3.35 TB/s. Away
// from the root the reads through idx are scattered: each bin byte costs a
// 32-byte sector (correct, slow; a later PR may compact the plane instead).
// Same-bin lanes serialise on their leader, so a bin that holds most rows
// (a dominant default bin) costs up to 32 adds per warp step.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kMaxChannels = 4;

template <typename GH, typename ACC>
__global__ void hist_partial_kernel(const uint8_t* __restrict__ bins, long long n_rows,
                                    int n_groups, const GH* __restrict__ gh, int ch,
                                    const int* __restrict__ idx, long long n_pos,
                                    int num_bins, int group_block,
                                    long long rows_per_chunk, ACC* __restrict__ partial) {
  extern __shared__ unsigned char smem_raw[];
  ACC* hist = reinterpret_cast<ACC*>(smem_raw);            // [kWarps][GB][B][CH]
  const int per_warp = group_block * num_bins * ch;
  ACC* stage = hist + kWarps * per_warp;                     // [kWarps][32][CH]
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g0 = blockIdx.y * group_block;
  const int ng = min(group_block, n_groups - g0);

  for (int i = threadIdx.x; i < kWarps * per_warp; i += blockDim.x) hist[i] = ACC(0);
  __syncthreads();

  ACC* my_hist = hist + warp * per_warp;
  ACC* my_stage = stage + warp * 32 * ch;
  const long long lo = (long long)blockIdx.x * rows_per_chunk;
  const long long hi = min(n_pos, lo + rows_per_chunk);
  for (long long base = lo + warp * 32; base < hi; base += kWarps * 32) {
    const long long p = base + lane;
    long long r = n_rows;  // the sentinel: no row
    if (p < hi) r = idx ? (long long)idx[p] : p;
    const bool valid = r >= 0 && r < n_rows;
    if (valid) {
      for (int c = 0; c < ch; ++c) my_stage[lane * ch + c] = ACC(gh[r * ch + c]);
    }
    __syncwarp();
    for (int gi = 0; gi < ng; ++gi) {
      // an empty lane gets a key no bin can have, so it matches no one
      const int key = valid ? int(bins[(long long)(g0 + gi) * n_rows + r]) : 256 + lane;
      const unsigned peers = __match_any_sync(0xffffffffu, key);
      // a bin past num_bins adds nowhere, as the TPU kernel's one-hot
      // compare never matches it
      if (valid && key < num_bins && lane == __ffs(peers) - 1) {
        ACC* h = my_hist + (gi * num_bins + key) * ch;
        for (int c = 0; c < ch; ++c) {
          ACC s = ACC(0);
          for (unsigned m = peers; m; m &= m - 1) s += my_stage[(__ffs(m) - 1) * ch + c];
          h[c] += s;
        }
      }
    }
    __syncwarp();
  }
  __syncthreads();

  // the warps' histograms summed in warp order: this block's partial
  ACC* out = partial + ((long long)blockIdx.x * n_groups + g0) * num_bins * ch;
  for (int i = threadIdx.x; i < ng * num_bins * ch; i += blockDim.x) {
    ACC s = hist[i];
    for (int w = 1; w < kWarps; ++w) s += hist[w * per_warp + i];
    out[i] = s;
  }
}

template <typename ACC>
__global__ void hist_reduce_kernel(const ACC* __restrict__ partial, int n_chunks,
                                   long long per_chunk, ACC* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= per_chunk) return;
  ACC s = partial[i];
  for (int k = 1; k < n_chunks; ++k) s += partial[(long long)k * per_chunk + i];
  out[i] = s;
}

template <typename GH, typename ACC>
int launch(const uint8_t* bins, long long n_rows, int n_groups, const GH* gh, int ch,
           const int* idx, long long n_pos, int num_bins, int group_block,
           long long rows_per_chunk, int n_chunks, ACC* partial, ACC* out,
           cudaStream_t stream) {
  if (ch < 1 || ch > kMaxChannels || num_bins < 1 || num_bins > 256 || group_block < 1
      || n_chunks < 1) {
    return int(cudaErrorInvalidValue);
  }
  const size_t smem = sizeof(ACC) * (size_t(kWarps) * group_block * num_bins * ch
                                     + size_t(kWarps) * 32 * ch);
  auto kernel = hist_partial_kernel<GH, ACC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid(n_chunks, (n_groups + group_block - 1) / group_block);
  ACC* first = n_chunks == 1 ? out : partial;
  kernel<<<grid, kWarps * 32, smem, stream>>>(bins, n_rows, n_groups, gh, ch, idx, n_pos,
                                               num_bins, group_block, rows_per_chunk, first);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_chunks == 1) return int(err);
  const long long per_chunk = (long long)n_groups * num_bins * ch;
  const int threads = 256;
  hist_reduce_kernel<ACC><<<int((per_chunk + threads - 1) / threads), threads, 0, stream>>>(
      partial, n_chunks, per_chunk, out);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// partial: [n_chunks, G, num_bins, ch] scratch (unused when n_chunks == 1);
// out: [G, num_bins, ch]. Returns cudaGetLastError() after the launches.
int lgbt_histogram_f32(const uint8_t* bins, long long n_rows, int n_groups,
                       const float* gh, int ch, const int* idx, long long n_pos,
                       int num_bins, int group_block, long long rows_per_chunk,
                       int n_chunks, float* partial, float* out, void* stream) {
  return launch<float, float>(bins, n_rows, n_groups, gh, ch, idx, n_pos, num_bins,
                              group_block, rows_per_chunk, n_chunks, partial, out,
                              static_cast<cudaStream_t>(stream));
}

int lgbt_histogram_i32(const uint8_t* bins, long long n_rows, int n_groups,
                       const int8_t* gh, int ch, const int* idx, long long n_pos,
                       int num_bins, int group_block, long long rows_per_chunk,
                       int n_chunks, int* partial, int* out, void* stream) {
  return launch<int8_t, int>(bins, n_rows, n_groups, gh, ch, idx, n_pos, num_bins,
                             group_block, rows_per_chunk, n_chunks, partial, out,
                             static_cast<cudaStream_t>(stream));
}

}  // extern "C"
