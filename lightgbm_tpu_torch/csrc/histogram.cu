// Leaf histograms for Hopper (sm_90a). Two kernels share one design:
//
// (1) hist_partial_kernel, the port of the TPU kernel
//     lightgbm_tpu/ops/hist_pallas.py:pallas_histogram (kernel body
//     _make_kernel), reached on the TPU through
//     ops/histogram.py:build_histogram_rows, which gathers the leaf's rows with
//     a separate jnp.take before the kernel. The serial learner's histogram.
// (2) hist_ragged_partial_kernel, the port of the TPU kernel
//     lightgbm_tpu/ops/hist_pallas.py:pallas_histogram_slots_ragged (kernel
//     _make_slots_ragged_kernel, tile table active_tile_table), the wave
//     learner's histogram; with every range the whole row set it also computes
//     pallas_histogram_slots (kernel _make_slots_kernel).
//
// What (1) computes. For a bin plane bins [G, N] uint8, gradients gh [*, CH]
// and a leaf's padded row-index set idx [P] (sentinel N = no row):
//   hist[g, b, c] = sum over p < P with idx[p] < N of
//                   [bins[g, idx[p]] == b] * gh[idx[p], c]
// (with idx == NULL, the identity: every row p < P). Float mode takes float32
// gh and sums in float32; integer mode takes int8 gh and sums exactly in int32
// (the TPU kernel's quantized=True). The gather is done here, through idx: no
// [G, P] copy of the leaf's bins is made. Sentinel rows carry a zero gh row,
// so they are skipped without reading bins.
//
// What (2) computes. For K row ranges [starts[k], ends[k]) with a valid flag,
// a per-row slot [N] int32 and gh [N, CH] float32 (rows of a leading stride,
// so the wave learner's payload columns are read in place):
//   out[g, b, k*CH + c] = sum over valid k, rows n in [starts[k], ends[k])
//                         with slot[n] == k of [bins[g, n] == b] * gh[n, c]
// Range k feeds slot k, and a row whose slot is another (the dump) is
// skipped: the TPU kernel's precondition that inside the ranges a row of
// range k carries slot k or the dump. Float mode sums in float32 (the TPU
// kernel's f32=True path; its bf16 default is a matrix-unit rate trick, not
// part of the function); integer mode truncates each gh value to int32 and
// sums exactly (quantized=True, whose gh holds small exact ints).
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
// JAX package's byte-identical-model promise needs). In (1) a leaf small
// enough for one chunk is written by pass 1 directly.
// In (2) the TPU's tile table becomes a chunk plan built on the card from the
// ranges themselves (hist_ragged_plan_kernel, one block): the rows are cut
// by a fixed grid of R-row tiles (R from N, so that a whole-plane range
// fills the card), and a chunk is one range's part of one tile. A range's
// chunks, and so its summation order, depend on its own bounds alone, never
// on the other ranges of the wave. Should the ranges hold more rows than
// the host's bound (the grid is sized without reading them back), the plan
// doubles R until its chunks fit. A pass-1 block finds its chunk by a
// binary search over the plan's offsets; blocks past the last chunk return
// at once. Pass 2 sums range k's chunks in chunk order
// into channel block k, zero for an empty or invalid range. The wave layout
// is leaf-contiguous, so (2) reads its rows coalesced, unlike (1) away from
// the root.
//
// What bounds them. Bytes: the bins (G bytes per row), gh (CH * 4 bytes per
// row), idx or slot (4 bytes per position) and the output — at the HIGGS root
// (G = 28, N = 1,048,576) 29.4 + 12.6 + 4.2 MB, ~14 us at 3.35 TB/s. A wave
// of (2) reads the smaller children's rows, 44 bytes each. Away from the root
// the reads of (1) through idx are scattered: each bin byte costs a 32-byte
// sector. Same-bin lanes serialise on their leader, so a bin that holds most
// rows (a dominant default bin) costs up to 32 adds per warp step.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kMaxChannels = 4;
constexpr int kMaxRanges = 1024;

// Zero the block's per-warp histograms.
template <typename ACC>
__device__ __forceinline__ void zero_hist(ACC* hist, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) hist[i] = ACC(0);
  __syncthreads();
}

// One warp step: each lane's row r (when `valid`) stages its gh channels,
// then for each of the block's groups the lanes of one bin add their values
// in lane order, led by the lowest lane.
template <typename GH, typename ACC>
__device__ __forceinline__ void warp_step(const uint8_t* __restrict__ bins, long long n_rows,
                                          int g0, int ng, const GH* __restrict__ gh,
                                          long long gh_stride, int ch, long long r,
                                          bool valid, int num_bins, int lane, ACC* my_hist,
                                          ACC* my_stage) {
  if (valid) {
    for (int c = 0; c < ch; ++c) my_stage[lane * ch + c] = ACC(gh[r * gh_stride + c]);
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

// The warps' histograms summed in warp order into `out` (count values).
template <typename ACC>
__device__ __forceinline__ void write_partial(const ACC* hist, int per_warp, int count,
                                              ACC* __restrict__ out) {
  __syncthreads();
  for (int i = threadIdx.x; i < count; i += blockDim.x) {
    ACC s = hist[i];
    for (int w = 1; w < kWarps; ++w) s += hist[w * per_warp + i];
    out[i] = s;
  }
}

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

  zero_hist(hist, kWarps * per_warp);
  ACC* my_hist = hist + warp * per_warp;
  ACC* my_stage = stage + warp * 32 * ch;
  const long long lo = (long long)blockIdx.x * rows_per_chunk;
  const long long hi = min(n_pos, lo + rows_per_chunk);
  for (long long base = lo + warp * 32; base < hi; base += kWarps * 32) {
    const long long p = base + lane;
    long long r = n_rows;  // the sentinel: no row
    if (p < hi) r = idx ? (long long)idx[p] : p;
    const bool valid = r >= 0 && r < n_rows;
    warp_step(bins, n_rows, g0, ng, gh, ch, ch, r, valid, num_bins, lane, my_hist, my_stage);
  }
  write_partial(hist, per_warp, ng * num_bins * ch,
                partial + ((long long)blockIdx.x * n_groups + g0) * num_bins * ch);
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

// Range k's chunks on a grid of `rows`-row tiles: one per tile it touches.
__device__ __forceinline__ long long range_chunks(long long s, long long e, long long rows) {
  return e > s ? (e - 1) / rows - s / rows + 1 : 0;
}

// The chunk plan of the ragged histogram: plan[0] = R, the rows of a tile;
// plan[1 + k] = the first chunk of range k, plan[1 + K] = the chunk count
// (at most max_chunks: R doubles until it is).
__global__ void hist_ragged_plan_kernel(const int* __restrict__ starts,
                                        const int* __restrict__ ends,
                                        const uint8_t* __restrict__ valid, int n_ranges,
                                        long long tile_rows, long long max_chunks,
                                        long long* __restrict__ plan) {
  __shared__ long long lo[kMaxRanges], hi[kMaxRanges];
  for (int k = threadIdx.x; k < n_ranges; k += blockDim.x) {
    const bool ok = valid[k] != 0;
    lo[k] = ok ? starts[k] : 0;
    hi[k] = ok ? ends[k] : 0;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  long long rows = tile_rows;
  for (;;) {
    long long n = 0;
    for (int k = 0; k < n_ranges; ++k) n += range_chunks(lo[k], hi[k], rows);
    if (n <= max_chunks) break;
    rows *= 2;
  }
  plan[0] = rows;
  long long off = 0;
  plan[1] = 0;
  for (int k = 0; k < n_ranges; ++k) {
    off += range_chunks(lo[k], hi[k], rows);
    plan[2 + k] = off;
  }
}

template <typename ACC>
__global__ void hist_ragged_partial_kernel(const uint8_t* __restrict__ bins, long long n_rows,
                                           int n_groups, const float* __restrict__ gh,
                                           long long gh_stride, int ch,
                                           const int* __restrict__ slot,
                                           const int* __restrict__ starts,
                                           const int* __restrict__ ends,
                                           const long long* __restrict__ plan, int n_ranges,
                                           int num_bins, int group_block,
                                           ACC* __restrict__ partial) {
  __shared__ int s_range;
  __shared__ long long s_lo, s_hi;
  if (threadIdx.x == 0) {
    const long long* off = plan + 1;
    const long long c = blockIdx.x;
    int k = -1;
    if (c < off[n_ranges]) {
      // off[lo] <= c < off[hi]; an empty range has off[k] == off[k + 1]
      int lo = 0, hi = n_ranges;
      while (hi - lo > 1) {
        const int mid = (lo + hi) >> 1;
        if (off[mid] <= c) lo = mid; else hi = mid;
      }
      k = lo;
      const long long rows = plan[0];
      const long long tile = starts[k] / rows + (c - off[k]);
      s_lo = max((long long)starts[k], tile * rows);
      s_hi = min((long long)ends[k], (tile + 1) * rows);
    }
    s_range = k;
  }
  __syncthreads();
  const int k = s_range;
  if (k < 0) return;  // past the last chunk: the whole block leaves

  extern __shared__ unsigned char smem_raw[];
  ACC* hist = reinterpret_cast<ACC*>(smem_raw);            // [kWarps][GB][B][CH]
  const int per_warp = group_block * num_bins * ch;
  ACC* stage = hist + kWarps * per_warp;                     // [kWarps][32][CH]
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g0 = blockIdx.y * group_block;
  const int ng = min(group_block, n_groups - g0);

  zero_hist(hist, kWarps * per_warp);
  ACC* my_hist = hist + warp * per_warp;
  ACC* my_stage = stage + warp * 32 * ch;
  const long long lo = s_lo, hi = s_hi;
  for (long long base = lo + warp * 32; base < hi; base += kWarps * 32) {
    const long long r = base + lane;
    const bool valid = r < hi && slot[r] == k;
    warp_step(bins, n_rows, g0, ng, gh, gh_stride, ch, r, valid, num_bins, lane, my_hist,
              my_stage);
  }
  write_partial(hist, per_warp, ng * num_bins * ch,
                partial + ((long long)blockIdx.x * n_groups + g0) * num_bins * ch);
}

// out[gb, k, c] = range k's chunk partials summed in chunk order; one thread
// per (group-bin, channel), so a chunk's partial is read coalesced.
template <typename ACC>
__global__ void hist_ragged_reduce_kernel(const ACC* __restrict__ partial,
                                          const long long* __restrict__ plan, int n_ranges,
                                          long long per_chunk, int ch, ACC* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= per_chunk) return;
  const long long gb = i / ch;
  const int c = int(i - gb * ch);
  const long long* off = plan + 1;
  for (int k = 0; k < n_ranges; ++k) {
    ACC s = ACC(0);
    for (long long j = off[k]; j < off[k + 1]; ++j) s += partial[j * per_chunk + i];
    out[(gb * n_ranges + k) * ch + c] = s;
  }
}

template <typename ACC>
size_t smem_bytes(int group_block, int num_bins, int ch) {
  return sizeof(ACC) * (size_t(kWarps) * group_block * num_bins * ch + size_t(kWarps) * 32 * ch);
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
  const size_t smem = smem_bytes<ACC>(group_block, num_bins, ch);
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

template <typename ACC>
int launch_ragged(const uint8_t* bins, long long n_rows, int n_groups, const float* gh,
                  long long gh_stride, int ch, const int* slot, const int* starts,
                  const int* ends, const uint8_t* valid, int n_ranges, int num_bins,
                  int group_block, long long tile_rows, int max_chunks, long long* plan,
                  ACC* partial, ACC* out, cudaStream_t stream) {
  if (ch < 1 || ch > kMaxChannels || num_bins < 1 || num_bins > 256 || group_block < 1
      || n_ranges < 1 || n_ranges > kMaxRanges || tile_rows < 1
      || max_chunks < 2 * n_ranges) {
    return int(cudaErrorInvalidValue);
  }
  hist_ragged_plan_kernel<<<1, 256, 0, stream>>>(starts, ends, valid, n_ranges, tile_rows,
                                                 max_chunks, plan);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  const size_t smem = smem_bytes<ACC>(group_block, num_bins, ch);
  auto kernel = hist_ragged_partial_kernel<ACC>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid(max_chunks, (n_groups + group_block - 1) / group_block);
  kernel<<<grid, kWarps * 32, smem, stream>>>(bins, n_rows, n_groups, gh, gh_stride, ch, slot,
                                               starts, ends, plan, n_ranges, num_bins,
                                               group_block, partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  const long long per_chunk = (long long)n_groups * num_bins * ch;
  const int threads = 256;
  hist_ragged_reduce_kernel<ACC>
      <<<int((per_chunk + threads - 1) / threads), threads, 0, stream>>>(
          partial, plan, n_ranges, per_chunk, ch, out);
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

// The ragged (wave) histogram. gh [N, ch] float32 with row stride gh_stride;
// slot [N] int32; starts/ends [K] int32, valid [K] bytes; tile_rows the grid
// of row tiles (a multiple of 256); plan [K + 2] int64 scratch; partial
// [max_chunks, G, num_bins, ch] scratch (max_chunks >= 2K); out
// [G, num_bins, K * ch]. The _i32 form truncates gh to int32 and sums exactly.
int lgbt_histogram_ragged_f32(const uint8_t* bins, long long n_rows, int n_groups,
                              const float* gh, long long gh_stride, int ch, const int* slot,
                              const int* starts, const int* ends, const uint8_t* valid,
                              int n_ranges, int num_bins, int group_block,
                              long long tile_rows, int max_chunks, long long* plan,
                              float* partial, float* out, void* stream) {
  return launch_ragged<float>(bins, n_rows, n_groups, gh, gh_stride, ch, slot, starts, ends,
                              valid, n_ranges, num_bins, group_block, tile_rows, max_chunks,
                              plan, partial, out, static_cast<cudaStream_t>(stream));
}

int lgbt_histogram_ragged_i32(const uint8_t* bins, long long n_rows, int n_groups,
                              const float* gh, long long gh_stride, int ch, const int* slot,
                              const int* starts, const int* ends, const uint8_t* valid,
                              int n_ranges, int num_bins, int group_block,
                              long long tile_rows, int max_chunks, long long* plan,
                              int* partial, int* out, void* stream) {
  return launch_ragged<int>(bins, n_rows, n_groups, gh, gh_stride, ch, slot, starts, ends,
                            valid, n_ranges, num_bins, group_block, tile_rows, max_chunks,
                            plan, partial, out, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
