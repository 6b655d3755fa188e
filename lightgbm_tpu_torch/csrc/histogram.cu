// Leaf histograms for Hopper (sm_90a). Two kernels:
//
// (1) hist_partial_kernel, the port of the TPU kernel
//     lightgbm_tpu/ops/hist_pallas.py:pallas_histogram (kernel body
//     _make_kernel), reached on the TPU through
//     ops/histogram.py:build_histogram_rows, which gathers the leaf's rows with
//     a separate jnp.take before the kernel. The serial learner's histogram.
// (2) hist_ragged_kernel, the port of the TPU kernel
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
// Design of (1). Pass 1: grid (row chunks, group blocks); 8 warps per block.
// Every warp owns a private histogram in shared memory for the block's GB
// groups ([GB, B, CH] of float or int, 3 KB per group at B=256, CH=3). A warp
// takes 32 consecutive positions at a time, in a fixed order; each lane
// stages its row's gh in shared memory, then for each group the lanes whose
// rows fall in the same bin find each other with __match_any_sync and the
// lowest such lane adds their staged values in ascending lane order and then
// adds that sum to the warp's bin. The warps' histograms are then summed in
// warp order and written as the block's partial. Pass 2 sums the partials of
// the row chunks in chunk order. No float atomics: the sum order is fixed by
// the shapes alone, so two launches give the same bits. A leaf small enough
// for one chunk is written by pass 1 directly. Bound: bins (G bytes a row),
// gh (4 CH bytes), idx (4 bytes) and the output — at the HIGGS root (G = 28,
// N = 1,048,576) ~46 MB, ~14 us at 3.35 TB/s; away from the root the reads
// through idx are scattered, each bin byte a 32-byte sector.
//
// What (2) computes. For K row ranges [starts[k], ends[k]) with a valid flag,
// a per-row slot [N] int32 and gh [N, CH] float32 (rows of a leading stride,
// so the wave learner's payload columns are read in place):
//   out[g, b, k*CH + c] = sum over valid k, rows n in [starts[k], ends[k])
//                         with slot[n] == k of [bins[g, n] == b] * gh[n, c]
// Range k feeds slot k, and a row whose slot is another (the dump) is
// skipped: the TPU kernel's precondition that inside the ranges a row of
// range k carries slot k or the dump. A bin >= num_bins adds nowhere. Float
// mode returns float32; integer mode truncates each gh value to int32 and
// sums exactly (quantized=True, whose gh holds small exact ints).
//
// What bounds (2). Bytes: G + 4 CH + 4 (slot) a row in the ranges plus the
// output: ~14 us at the HIGGS root, ~7 us for a wave's 21 ranges over half
// the rows. The work the bytes do not show is one add a (row, group,
// channel), 88 M at the root. A fixed float order needs (1)'s per-warp
// histograms: 24 KB a group, so few groups a block, every row's slot and gh
// read once a group block, a serial leader add per bin and warp step, and a
// zeroed histogram and a full partial for every row chunk. Here the adds go
// to shared-memory integer atomics: two 32-bit ones a fixed-point value.
//
// Design of (2). Determinism from integer arithmetic instead of a fixed
// order: integer adds give the same bits in any order, so shared-memory
// atomics become allowed. The integer mode adds int32. The float mode adds
// fixed point: channel c's values are rounded (to nearest even) to multiples
// of 2^-e_c, e_c = 62 - ceil(log2 N) - ceil(log2 max_n |gh[n, c]|) over the
// finite values of the whole of gh (ops/histogram.py:fixed_point_exponents,
// computed on the card once a tree by the wave learner; the kernel trusts
// them: exponents of another gh could overflow), so no bin's sum of at most N
// values can
// pass 2^62 in magnitude, and summed exactly in 64 bits; the sum becomes
// float32 once, at the end (int64 -> double -> scale by 2^-e_c -> float32,
// each rounding to nearest even). At N = 2^20 and |gh| <= 1 the resolution
// is 2^-42: values on the 2^-4 or 2^-10 grid are exact, and the error is far
// inside the float32 summation bound of the plain version. A range's result
// depends on its own rows alone. A NaN or inf value stays out of the fixed
// point (the exponents come from the finite values): it ORs a code into its
// own cell's flag word (+inf 1, -inf 2, NaN 3; +inf with -inf is 3, as
// their float sum is NaN), and such a cell comes out +inf, -inf or NaN, as
// the plain version's float32 sum of that cell does. A row's non-finite
// values are rare, so their flags go straight to global memory.
// Hopper has no native 64-bit shared-memory add (atomicAdd on 64 bits
// compiles to a compare-and-swap loop, ATOMS.CAST.SPIN.64), so the 64-bit
// sum is two 32-bit words: the low word's atomicAdd returns the old value,
// and its carry goes to the high word with the value's high half.
//  * One block-wide histogram for many groups (at 255 bins x 3 channels a
//    group takes 7 KB with its bins padded to odd word counts), so each
//    row's slot and gh are read and converted once for all of the block's
//    groups: half the HIGGS groups a block, two blocks an SM.
//  * Persistent blocks (two an SM, 512 threads each, a group block's worth
//    on each of them) each take an equal share of the ranges' rows in range
//    order (a block-wide scan of the range lengths in its prologue finds
//    where each share starts); a block accumulates in shared memory and
//    flushes — its nonzero cells added to the output's integer image with
//    global atomics, then zeroed — only when its share leaves a range. A
//    wave's partial chunks cost nothing extra, and while one block of an SM
//    waits at a flush the other works.
//  * A thread takes 4 consecutive rows (one 32-bit load of their bins a
//    group), keeps their converted gh in registers for all groups, and adds
//    runs of equal bins in registers before one atomic: a dominant bin (a
//    default bin, HIGGS's four-valued tagging columns) costs fewer atomics,
//    not more.
// A second small kernel turns the float mode's int64 image and its flag
// words into float32.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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

// ---------------------------------------------------------------- (2)

constexpr int kRaggedThreads = 512;
constexpr int kRowsPerThread = 4;

// 32-bit words a bin of the ragged kernel's shared histogram takes: CH
// channels of one (integer) or two (fixed point: low, high) words, padded
// to an odd count, so a warp's lanes adding to random bins spread over all
// 32 banks.
__host__ __device__ constexpr int bin_words(int ch, bool fixed) {
  return (ch * (fixed ? 2 : 1)) | 1;
}

// off[k] = rows of the valid ranges before range k (off[K] = all of them):
// each thread sums a run of consecutive ranges, then a block-wide scan of
// the runs (blockDim.x a multiple of 32, at most 1024).
__device__ __forceinline__ void range_offsets(const int* __restrict__ starts,
                                              const int* __restrict__ ends,
                                              const uint8_t* __restrict__ valid, int n_ranges,
                                              long long* off, long long* warp_sums) {
  const int per = (n_ranges + blockDim.x - 1) / blockDim.x;
  const int k0 = threadIdx.x * per;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  long long x = 0;
  for (int k = k0; k < min(n_ranges, k0 + per); ++k) {
    const long long s = starts[k], e = ends[k];
    off[k + 1] = valid[k] && e > s ? e - s : 0;  // the length, for now
    x += off[k + 1];
  }
  for (int d = 1; d < 32; d <<= 1) {
    const long long y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    long long w = lane < int(blockDim.x >> 5) ? warp_sums[lane] : 0;
    for (int d = 1; d < 32; d <<= 1) {
      const long long y = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += y;
    }
    warp_sums[lane] = w;
  }
  __syncthreads();
  // x is the inclusive sum through this thread's run: walk it back
  long long end = x + (warp > 0 ? warp_sums[warp - 1] : 0);
  for (int k = min(n_ranges, k0 + per) - 1; k >= k0; --k) {
    const long long len = off[k + 1];
    off[k + 1] = end;
    end -= len;
  }
  if (threadIdx.x == 0) off[0] = 0;
  __syncthreads();
}

// The bins of rows r0 .. r0 + 3 of one group's plane, byte i for row r0 + i
// (rows past the plane read as 0; their gh is 0, so they add nothing).
__device__ __forceinline__ uint32_t load4(const uint8_t* __restrict__ plane, long long r0,
                                          long long n_rows) {
  const uint8_t* p = plane + r0;
  if (r0 + 3 < n_rows && (reinterpret_cast<uintptr_t>(p) & 3) == 0) {
    return __ldg(reinterpret_cast<const unsigned*>(p));
  }
  uint32_t w = 0;
  for (int i = 0; i < kRowsPerThread; ++i) {
    if (r0 + i < n_rows) w |= uint32_t(__ldg(p + i)) << (8 * i);
  }
  return w;
}

// Add one run's sums to bin b of group gi in the block's histogram.
template <bool kFixed, int CH, typename V>
__device__ __forceinline__ void emit(unsigned* hist, int gi, int b, int num_bins,
                                     const V (&acc)[CH]) {
  if (b >= num_bins) return;
  unsigned* cell = hist + (gi * num_bins + b) * bin_words(CH, kFixed);
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    if (acc[c] == 0) continue;
    if constexpr (kFixed) {
      const unsigned lo = static_cast<unsigned>(acc[c]);
      int hi = static_cast<int>(acc[c] >> 32);
      if (lo != 0) {
        const unsigned old = atomicAdd(cell + 2 * c, lo);
        hi += (old + lo < old);  // the carry out of the low word
      }
      if (hi != 0) atomicAdd(cell + 2 * c + 1, static_cast<unsigned>(hi));
    } else {
      atomicAdd(reinterpret_cast<int*>(cell) + c, static_cast<int>(acc[c]));
    }
  }
}

// The flag code of a non-finite float: +inf 1, -inf 2, NaN 3.
__device__ __forceinline__ unsigned nonfinite_code(float x) {
  return isnan(x) ? 3u : (x > 0.0f ? 1u : 2u);
}

// grid (persistent blocks, group blocks). Image: [G, num_bins, K, CH] int64
// (fixed) or int32 (integer mode: the output itself), and in the fixed mode
// flags, [G, num_bins, K, CH] codes of the non-finite values; both zeroed by
// the caller.
template <bool kFixed, int CH>
__global__ void __launch_bounds__(kRaggedThreads, 2)
hist_ragged_kernel(const uint8_t* __restrict__ bins, long long n_rows, int n_groups,
                   const float* __restrict__ gh, long long gh_stride,
                   const int* __restrict__ slot, const int* __restrict__ starts,
                   const int* __restrict__ ends, const uint8_t* __restrict__ valid,
                   int n_ranges, int num_bins, int group_block, const int* __restrict__ exps,
                   void* __restrict__ image, unsigned* __restrict__ flags) {
  using V = typename std::conditional<kFixed, long long, int>::type;
  constexpr int kWords = bin_words(CH, kFixed);
  extern __shared__ __align__(16) unsigned char smem[];
  long long* off = reinterpret_cast<long long*>(smem);           // [kMaxRanges + 1]
  long long* warp_sums = off + kMaxRanges + 1;                    // [32]
  unsigned* hist = reinterpret_cast<unsigned*>(warp_sums + 32);   // [GB][B][kWords]
  const int g0 = blockIdx.y * group_block;
  const int ng = min(group_block, n_groups - g0);
  const int cells = ng * num_bins * CH;
  for (int i = threadIdx.x; i < ng * num_bins * kWords; i += blockDim.x) hist[i] = 0;
  range_offsets(starts, ends, valid, n_ranges, off, warp_sums);

  double scale[CH];
#pragma unroll
  for (int c = 0; c < CH; ++c) scale[c] = kFixed ? ldexp(1.0, exps[c]) : 1.0;
  const long long total = off[n_ranges];
  long long a = total * blockIdx.x / gridDim.x;
  const long long z = total * (blockIdx.x + 1) / gridDim.x;
  int k = 0;
  {  // the range that holds position a: off[k] <= a < off[k + 1]
    int lo = 0, hi = n_ranges;
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (off[mid] <= a) lo = mid; else hi = mid;
    }
    k = lo;
  }
  while (a < z) {
    while (off[k + 1] <= a) ++k;  // past empty and invalid ranges
    const long long stop = min(z, off[k + 1]);
    const long long lo = starts[k] + (a - off[k]);
    const long long hi = starts[k] + (stop - off[k]);
    const long long step = static_cast<long long>(kRowsPerThread) * blockDim.x;
    for (long long base = lo & ~3LL; base < hi; base += step) {
      const long long r0 = base + kRowsPerThread * threadIdx.x;
      if (r0 >= hi) continue;
      V v[kRowsPerThread][CH];
      bool any = false;
      unsigned nf = 0;  // the non-finite codes, 2 bits a (row, channel)
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const long long r = r0 + i;
        const bool ok = r >= lo && r < hi && slot[r] == k;
        any |= ok;
#pragma unroll
        for (int c = 0; c < CH; ++c) {
          const float x = ok ? gh[r * gh_stride + c] : 0.0f;
          if constexpr (kFixed) {
            const bool fin = isfinite(x);
            v[i][c] = fin ? __double2ll_rn(static_cast<double>(x) * scale[c]) : 0;
            if (!fin) nf |= nonfinite_code(x) << (2 * (i * CH + c));
          } else {
            v[i][c] = static_cast<int>(x);
          }
        }
      }
      if (!any) continue;
      uint32_t next = load4(bins + static_cast<long long>(g0) * n_rows, r0, n_rows);
      for (int gi = 0; gi < ng; ++gi) {
        const uint32_t word = next;
        if (gi + 1 < ng) {
          next = load4(bins + static_cast<long long>(g0 + gi + 1) * n_rows, r0, n_rows);
        }
        int cur = word & 0xff;
        V acc[CH];
#pragma unroll
        for (int c = 0; c < CH; ++c) acc[c] = v[0][c];
#pragma unroll
        for (int i = 1; i < kRowsPerThread; ++i) {
          const int b = (word >> (8 * i)) & 0xff;
          if (b != cur) {
            emit<kFixed, CH>(hist, gi, cur, num_bins, acc);
            cur = b;
#pragma unroll
            for (int c = 0; c < CH; ++c) acc[c] = 0;
          }
#pragma unroll
          for (int c = 0; c < CH; ++c) acc[c] += v[i][c];
        }
        emit<kFixed, CH>(hist, gi, cur, num_bins, acc);
        if (kFixed && nf != 0) {  // each non-finite value flags its own cell
#pragma unroll
          for (int i = 0; i < kRowsPerThread; ++i) {
            const int b = (word >> (8 * i)) & 0xff;
            if (b >= num_bins) continue;
#pragma unroll
            for (int c = 0; c < CH; ++c) {
              const unsigned code = (nf >> (2 * (i * CH + c))) & 3u;
              if (code != 0) {
                atomicOr(flags + ((static_cast<long long>(g0 + gi) * num_bins + b) * n_ranges
                                  + k) * CH + c, code);
              }
            }
          }
        }
      }
    }
    __syncthreads();
    // flush range k's share: nonzero cells to the image, then zero them
    for (int i = threadIdx.x; i < cells; i += blockDim.x) {
      const int c = i % CH;
      const long long gb = static_cast<long long>(g0) * num_bins + i / CH;
      const long long at = (gb * n_ranges + k) * CH + c;
      if constexpr (kFixed) {
        unsigned* cell = hist + (i / CH) * kWords + 2 * c;
        const long long s = static_cast<long long>(
            (static_cast<unsigned long long>(cell[1]) << 32) | cell[0]);
        if (s != 0) {
          atomicAdd(reinterpret_cast<unsigned long long*>(image) + at,
                    static_cast<unsigned long long>(s));
        }
        cell[0] = 0;
        cell[1] = 0;
      } else {
        unsigned* cell = hist + (i / CH) * kWords + c;
        if (*cell != 0) atomicAdd(reinterpret_cast<int*>(image) + at, static_cast<int>(*cell));
        *cell = 0;
      }
    }
    __syncthreads();
    a = stop;
  }
}

// out[i] = image[i] * 2^-e_c as float32, c = i % CH; +inf, -inf or NaN
// where flags[i] holds code 1, 2 or 3.
__global__ void hist_fixed_to_float_kernel(const long long* __restrict__ image,
                                           const unsigned* __restrict__ flags, long long count,
                                           int ch, const int* __restrict__ exps,
                                           float* __restrict__ out) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= count) return;
  const unsigned code = flags[i];
  out[i] = code == 0 ? __double2float_rn(__ll2double_rn(image[i]) * ldexp(1.0, -exps[i % ch]))
         : code == 1 ? __int_as_float(0x7f800000)
         : code == 2 ? __int_as_float(0xff800000)
                     : __int_as_float(0x7fc00000);
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

size_t ragged_smem_bytes(int group_block, int num_bins, int ch, bool fixed) {
  return sizeof(long long) * (kMaxRanges + 1 + 32) +
         sizeof(unsigned) * size_t(group_block) * num_bins * bin_words(ch, fixed);
}

template <bool kFixed, int CH>
cudaError_t launch_ragged(dim3 grid, size_t smem, cudaStream_t stream, const uint8_t* bins,
                          long long n_rows, int n_groups, const float* gh, long long gh_stride,
                          const int* slot, const int* starts, const int* ends,
                          const uint8_t* valid, int n_ranges, int num_bins, int group_block,
                          const int* exps, void* image, unsigned* flags) {
  auto kernel = hist_ragged_kernel<kFixed, CH>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, kRaggedThreads, smem, stream>>>(bins, n_rows, n_groups, gh, gh_stride, slot,
                                                 starts, ends, valid, n_ranges, num_bins,
                                                 group_block, exps, image, flags);
  return cudaGetLastError();
}

template <bool kFixed>
int ragged(const uint8_t* bins, long long n_rows, int n_groups, const float* gh,
           long long gh_stride, int ch, const int* slot, const int* starts, const int* ends,
           const uint8_t* valid, int n_ranges, int num_bins, int group_block, int blocks,
           const int* exps, void* image, unsigned* flags, float* out, cudaStream_t stream) {
  if (ch < 1 || ch > kMaxChannels || num_bins < 1 || num_bins > 256 || group_block < 1
      || n_ranges < 1 || n_ranges > kMaxRanges || blocks < 1
      || (kFixed && (exps == nullptr || flags == nullptr))) {
    return int(cudaErrorInvalidValue);
  }
  const size_t smem = ragged_smem_bytes(group_block, num_bins, ch, kFixed);
  const dim3 grid(blocks, (n_groups + group_block - 1) / group_block);
  cudaError_t err;
  switch (ch) {
    case 1: err = launch_ragged<kFixed, 1>(grid, smem, stream, bins, n_rows, n_groups, gh,
                                           gh_stride, slot, starts, ends, valid, n_ranges,
                                           num_bins, group_block, exps, image, flags); break;
    case 2: err = launch_ragged<kFixed, 2>(grid, smem, stream, bins, n_rows, n_groups, gh,
                                           gh_stride, slot, starts, ends, valid, n_ranges,
                                           num_bins, group_block, exps, image, flags); break;
    case 3: err = launch_ragged<kFixed, 3>(grid, smem, stream, bins, n_rows, n_groups, gh,
                                           gh_stride, slot, starts, ends, valid, n_ranges,
                                           num_bins, group_block, exps, image, flags); break;
    default: err = launch_ragged<kFixed, 4>(grid, smem, stream, bins, n_rows, n_groups, gh,
                                            gh_stride, slot, starts, ends, valid, n_ranges,
                                            num_bins, group_block, exps, image, flags); break;
  }
  if (err != cudaSuccess || !kFixed) return int(err);
  const long long count = (long long)n_groups * num_bins * n_ranges * ch;
  const int threads = 256;
  hist_fixed_to_float_kernel<<<int((count + threads - 1) / threads), threads, 0, stream>>>(
      static_cast<const long long*>(image), flags, count, ch, exps, out);
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
// slot [N] int32; starts/ends [K] int32, valid [K] bytes; `blocks` persistent
// blocks a group block. Float mode (_f32): exps [ch] int32 the fixed-point
// exponents, image [G, num_bins, K, ch] int64 and flags [G, num_bins, K, ch]
// uint32 scratch zeroed by the caller, out [G, num_bins, K * ch] float32.
// Integer mode (_i32): image is the int32 output itself, zeroed by the
// caller; exps, flags and out unused.
int lgbt_histogram_ragged_f32(const uint8_t* bins, long long n_rows, int n_groups,
                              const float* gh, long long gh_stride, int ch, const int* slot,
                              const int* starts, const int* ends, const uint8_t* valid,
                              int n_ranges, int num_bins, int group_block, int blocks,
                              const int* exps, long long* image, unsigned* flags, float* out,
                              void* stream) {
  return ragged<true>(bins, n_rows, n_groups, gh, gh_stride, ch, slot, starts, ends, valid,
                      n_ranges, num_bins, group_block, blocks, exps, image, flags, out,
                      static_cast<cudaStream_t>(stream));
}

int lgbt_histogram_ragged_i32(const uint8_t* bins, long long n_rows, int n_groups,
                              const float* gh, long long gh_stride, int ch, const int* slot,
                              const int* starts, const int* ends, const uint8_t* valid,
                              int n_ranges, int num_bins, int group_block, int blocks,
                              const int* exps, int* image, unsigned* flags, float* out,
                              void* stream) {
  return ragged<false>(bins, n_rows, n_groups, gh, gh_stride, ch, slot, starts, ends, valid,
                       n_ranges, num_bins, group_block, blocks, exps, image, flags, out,
                       static_cast<cudaStream_t>(stream));
}

}  // extern "C"
