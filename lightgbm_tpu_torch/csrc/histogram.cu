// Leaf histograms for Hopper (sm_90a). Three kernels on one scheme, and the
// float modes' conversion:
//
// (1) hist_rows_kernel, the port of the TPU kernel
//     lightgbm_tpu/ops/hist_pallas.py:pallas_histogram (kernel body
//     _make_kernel), reached on the TPU through
//     ops/histogram.py:build_histogram_rows, which gathers the leaf's rows with
//     a separate jnp.take before the kernel. The serial learner's histogram.
// (2) hist_ragged_kernel, the port of the TPU kernel
//     lightgbm_tpu/ops/hist_pallas.py:pallas_histogram_slots_ragged (kernel
//     _make_slots_ragged_kernel, tile table active_tile_table), the wave
//     learner's histogram.
// (3) hist_slots_kernel, the port of the TPU kernel
//     lightgbm_tpu/ops/hist_pallas.py:pallas_histogram_slots (kernel
//     _make_slots_kernel): the slot-expanded histogram over every row.
// (4) hist_image_to_float_kernel and wave_children_kernel: the float modes'
//     last step (image -> float32), alone or fused into the wave's children
//     step (below).
//
// What (1) computes. For a bin plane bins [G, N] uint8, gradients gh [*, CH]
// and a leaf's padded row-index set idx [P] (sentinel N = no row), of whose
// positions the first `count` are read (the caller's row count; the rest is
// sentinel padding, which costs nothing):
//   hist[g, b, c] = sum over p < count with idx[p] < N of
//                   [bins[g, idx[p]] == b] * gh[idx[p], c]
// (with idx == NULL, the identity: every row p < count). Float mode takes
// float32 gh; integer mode takes int8 gh and sums exactly in int32 (the TPU
// kernel's quantized=True). The gather is done here, through idx: no [G, P]
// copy of the leaf's bins is made. A bin >= num_bins adds nowhere.
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
// What bounds them. Bytes: (1) reads G bin bytes, 4 CH gh bytes and a 4-byte
// index a row of the leaf, (2) G + 4 CH + 4 (slot) a row in the ranges, plus
// the output: ~14 us at the HIGGS root (G = 28, N = 1,048,576) at 3.35 TB/s,
// ~1.4 us for a 100,000-row leaf. The work the bytes do not show is one add a
// (row, group, channel), 88 M at the root.
//
// Design, shared. Determinism from integer arithmetic instead of a fixed
// order: integer adds give the same bits in any order, so shared-memory
// atomics become allowed. The integer modes add int32. The float modes add
// fixed point: channel c's values are rounded (to nearest even) to multiples
// of 2^-e_c, e_c = 62 - ceil(log2 N) - ceil(log2 max_n |gh[n, c]|) over the
// finite values of the whole of gh (ops/histogram.py:fixed_point_exponents,
// computed on the card once a tree by both learners; the kernels trust them:
// exponents of another gh could overflow), so no bin's sum of at most N
// values can pass 2^62 in magnitude, and summed exactly in 64 bits; the sum
// becomes float32 once, at the end (int64 -> double -> scale by 2^-e_c ->
// float32, each rounding to nearest even). At N = 2^20 and |gh| <= 1 the
// resolution is 2^-42: values on the 2^-4 or 2^-10 grid are exact, and the
// error is far inside the float32 summation bound of the plain version. A
// leaf's or a range's result depends on its own rows alone. A NaN or inf
// value stays out of the fixed point (the exponents come from the finite
// values): it ORs a code into its own cell's flag word (+inf 1, -inf 2, NaN
// 3; +inf with -inf is 3, as their float sum is NaN), and such a cell comes
// out +inf, -inf or NaN, as the plain version's float32 sum of that cell
// does. A row's non-finite values are rare, so their flags go straight to
// global memory. Hopper has no native 64-bit shared-memory add (atomicAdd on
// 64 bits compiles to a compare-and-swap loop, ATOMS.CAST.SPIN.64), so the
// 64-bit sum is two 32-bit words: the low word's atomicAdd returns the old
// value, and its carry goes to the high word with the value's high half.
//  * One block-wide histogram for many groups (at 255 bins x 3 channels a
//    group takes 7 KB with its bins padded to odd word counts), so each
//    row's gh (and slot or index) is read and converted once for all of the
//    block's groups.
//  * A thread takes 4 consecutive rows (positions in (1)), keeps their
//    converted gh in registers for all groups, and adds runs of equal bins in
//    registers before one atomic: a dominant bin (a default bin, HIGGS's
//    four-valued tagging columns) costs fewer atomics, not more.
//  * A block accumulates in shared memory and flushes its nonzero cells into
//    the output's integer image with global atomics; a small kernel turns
//    the float mode's int64 image and its flag words into float32.
//
// Design of (1). A block's zeroing and flush cost its group block's cells
// (G_b * B * CH) whatever its rows, so the grid follows the leaf:
// ops/hist_cuda.py:rows_launch_shape gives each block ~4,096 positions, up
// to two 512-thread blocks an SM, and splits the groups finer while the row
// chunks are few (a 4,000-row leaf: one chunk, 28 one-group blocks; the
// HIGGS root: 132 chunks x 2 group blocks of 14). Each block takes an equal
// share of the positions in order; idx is read as one 16-byte load of four
// positions, and a thread's four rows, when consecutive (the root, dense
// leaves), as one 32-bit load of their bins a group, else four byte loads.
// The bin plane stays group-major [G, N], where a leaf's row costs a
// 32-byte sector a group unless its neighbours in the plane are in the leaf
// too. The serial learner's leaves hold sorted rows, so a large leaf's rows
// share sectors, and a sparse leaf is small. Measured (chip_smoke.py,
// NVIDIA H100 80GB HBM3, 700 W): 100,000 sorted rows drawn from 1,048,576
// take 0.032 ms of kernel time, the same count of consecutive rows 0.022
// ms, a 4,000-row leaf 0.012 ms (launch latency), the root 0.137 ms. A
// row-major copy of the plane would save at most the 0.010 ms a 100,000-row
// leaf pays for the gather, for 28-32 MB more device memory and a second
// layout to keep: not taken.
//
// The carried mode of (1): one leaf histogram summed over several calls, the
// blocks of a plane that streams onto the card block by block
// (streaming/learner.py, the out-of-core learner). Each call reads one
// block's rows (gh offset to the block's first row, block-local indices)
// and adds into the caller's image: `carry` says whether the image already
// holds earlier blocks' sums (kCarryKeep: no memset) and whether more
// blocks follow (kCarryOpen: no conversion). The fixed-point sums are
// exact, so converting once after the last block gives the bits of one call
// over all the leaf's rows; the flag words lie behind the sums and OR
// across blocks as they are. The exponents must be the whole tree's, never
// a block's. The integer mode adds into the same int32 output.
//
// Design of (2).
//  * Persistent blocks (two an SM, 512 threads each, a group block's worth
//    on each of them) each take an equal share of the ranges' rows in range
//    order (a block-wide scan of the range lengths in its prologue finds
//    where each share starts); a block flushes — its nonzero cells added to
//    the output's integer image, then zeroed — only when its share leaves a
//    range. A wave's partial chunks cost nothing extra, and while one block
//    of an SM waits at a flush the other works.
//
// What (3) computes. For a per-row slot [N] int32 and gh [N, CH] float32
// (rows of a leading stride):
//   out[g, b, s*CH + c] = sum over rows n with slot[n] == s in [0, S) of
//                         [bins[g, n] == b] * gh[n, c]
// A row whose slot is outside [0, S) adds nothing and its gh is not read.
// Its bound is (2)'s bytes over every row: ~1 us at 65,536 rows x 28 groups.
//
// Design of (3). Until this kernel it was (2) with S ranges, each the whole
// row set: every row read S times, and each persistent block zeroing and
// flushing its groups once a range (PERF.md, section 6, row 6, times both on
// the card). Here the grid follows the rows, as (1)'s does
// (ops/hist_cuda.py:slots_launch_shape, ~4,096 rows a block), and each row is
// read once: a block's shared histogram is slot-expanded,
// [GB][B][SB][bin_words], a row's slot picking its cell; a thread's four rows
// merge in registers only when bin and slot both match; one flush a block into
// the image [G, B, S, CH], which is the output's [G, B, S*CH] layout. When one
// group's S slots outgrow the opt-in shared memory (255 bins x 3 channels in
// fixed point: past 32 slots), the slots split into blocks along a third grid
// dimension; a slot block reads the slot vector of its rows and only its own
// rows' bins and gh.
//
// The conversion (4). The float modes' int64 image becomes float32 (int64 ->
// double -> x 2^-e_c -> float32, each rounding to nearest even; NaN and +-inf
// from the flag words). It reads 12 B and writes 4 B a cell: its bound at a
// wave's 42 children (899,640 cells) is 4.3 us. Its first form took one thread
// a cell with a 64-bit i % CH, the exponents reloaded and a double ldexp a
// cell, scalar loads (PERF.md, section 6, row 2j, times both; a call timed
// back to back is host-bound). Now: the grid's thread count is a multiple of
// 12, so a thread's cells keep their channels in a grid-stride loop and their
// scales stay in registers, computed once; cells go four at a time with
// 16-byte loads and stores where the three arrays are aligned.
//
// The wave's children step (4). A wave's children were ~36 device operations
// over [K, G, B, CH] (the pool gather, two subtractions with flag-table
// gathers, a where, two stacks, the conversion; PERF.md, section 6, row 2k,
// times both on the card). One launch now: the selected leaves' pool rows, the
// smaller children's image read in place in (2)'s [G, B, K, CH] layout, the
// larger child parent - smaller with the flags through the subtraction table
// (kSubCodes), both children's images written for the pool and the [2K, G, B,
// CH] float32 that the split search reads. Exact integer arithmetic: the bits
// of that composition. Bytes: 24 read and 32 written a (leaf, cell). The
// quantized pool (int32, no flags, nothing to convert) takes the same kernel
// in its integer mode, which writes only the [2K, G, B, CH] int32 whose halves
// are the children.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kMaxChannels = 4;
constexpr int kMaxRanges = 1024;
constexpr int kThreads = 512;
constexpr int kRowsPerThread = 4;
// the leaf histogram's carried mode (bits of its `carry` argument)
constexpr int kCarryKeep = 1;  // the image holds earlier calls' sums: no memset
constexpr int kCarryOpen = 2;  // more calls follow: no conversion to float32

// 32-bit words a bin of a block's shared histogram takes: CH channels of one
// (integer) or two (fixed point: low, high) words, padded to an odd count,
// so a warp's lanes adding to random bins spread over all 32 banks.
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

// The flag code of a non-finite float: +inf 1, -inf 2, NaN 3.
__device__ __forceinline__ unsigned nonfinite_code(float x) {
  return isnan(x) ? 3u : (x > 0.0f ? 1u : 2u);
}

// One gh value as the sum adds it: fixed point (a non-finite value adds 0
// and ORs its code into nf at bit `shift`) or a truncated int.
template <bool kFixed, typename V, typename T>
__device__ __forceinline__ V to_value(T x, double scale, unsigned& nf, int shift) {
  if constexpr (kFixed) {
    const bool fin = isfinite(x);
    if (!fin) nf |= nonfinite_code(x) << shift;
    return fin ? __double2ll_rn(static_cast<double>(x) * scale) : 0;
  } else {
    return static_cast<int>(x);
  }
}

// Add one run's sums to a cell of the block's histogram.
template <bool kFixed, int CH, typename V>
__device__ __forceinline__ void add_cell(unsigned* cell, const V (&acc)[CH]) {
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

// Add one run's sums to bin b of group gi in the block's histogram.
template <bool kFixed, int CH, typename V>
__device__ __forceinline__ void emit(unsigned* hist, int gi, int b, int num_bins,
                                     const V (&acc)[CH]) {
  if (b >= num_bins) return;
  add_cell<kFixed, CH>(hist + (gi * num_bins + b) * bin_words(CH, kFixed), acc);
}

// A thread's four rows into group gi of the block's histogram: `word` holds
// their bins (byte i for row i), v their values. Runs of equal bins are
// summed in registers first. Each non-finite value (its code in nf, 2 bits a
// (row, channel)) flags its own cell: flags[at + b * bin_stride + c].
template <bool kFixed, int CH, typename V>
__device__ __forceinline__ void add_rows(unsigned* hist, int gi, uint32_t word,
                                         const V (&v)[kRowsPerThread][CH], unsigned nf,
                                         int num_bins, unsigned* __restrict__ flags,
                                         long long at, long long bin_stride) {
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
  if (kFixed && nf != 0) {
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int b = (word >> (8 * i)) & 0xff;
      if (b >= num_bins) continue;
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const unsigned code = (nf >> (2 * (i * CH + c))) & 3u;
        if (code != 0) atomicOr(flags + at + b * bin_stride + c, code);
      }
    }
  }
}

// Flush the block's histogram [groups][num_bins][ns][CH] of groups g0 ..
// g0 + cells / (num_bins * ns * CH) into slots s0 .. s0 + ns - 1 of an image
// [G, num_bins, n_slots, CH] (int64 fixed point or int32): its nonzero cells
// with global atomics, then zero them. ns is kNs where that is given (the
// rows and ragged kernels' one slot), else the argument `slots` (the
// slot-expanded kernel's slot block). Called by every thread between two
// __syncthreads.
template <bool kFixed, int CH, int kNs>
__device__ __forceinline__ void flush(unsigned* hist, int cells, int g0, int num_bins,
                                      int n_slots, int s0, int slots, void* __restrict__ image) {
  constexpr int kWords = bin_words(CH, kFixed);
  const int ns = kNs > 0 ? kNs : slots;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    const int c = i % CH;
    const int q = i / CH;  // the block's (group, bin, slot) cell
    const int gb_local = q / ns;
    const long long gb = static_cast<long long>(g0) * num_bins + gb_local;
    const long long at = (gb * n_slots + s0 + (q - gb_local * ns)) * CH + c;
    if constexpr (kFixed) {
      unsigned* cell = hist + q * kWords + 2 * c;
      const long long s = static_cast<long long>(
          (static_cast<unsigned long long>(cell[1]) << 32) | cell[0]);
      if (s != 0) {
        atomicAdd(reinterpret_cast<unsigned long long*>(image) + at,
                  static_cast<unsigned long long>(s));
      }
      cell[0] = 0;
      cell[1] = 0;
    } else {
      unsigned* cell = hist + q * kWords + c;
      if (*cell != 0) atomicAdd(reinterpret_cast<int*>(image) + at, static_cast<int>(*cell));
      *cell = 0;
    }
  }
}

// ---------------------------------------------------------------- (1)

// grid (row chunks, group blocks). Image: [G, num_bins, CH] int64 (float
// gh) or int32 (int8 gh: the output itself), and for float gh flags, the
// [G, num_bins, CH] codes of the non-finite values; both zeroed before the
// launch.
template <typename GH, int CH>
__global__ void __launch_bounds__(kThreads, 2)
hist_rows_kernel(const uint8_t* __restrict__ bins, long long n_rows, int n_groups,
                 const GH* __restrict__ gh, const int* __restrict__ idx, long long count,
                 int num_bins, int group_block, const int* __restrict__ exps,
                 void* __restrict__ image, unsigned* __restrict__ flags) {
  constexpr bool kFixed = std::is_same<GH, float>::value;
  using V = typename std::conditional<kFixed, long long, int>::type;
  constexpr int kWords = bin_words(CH, kFixed);
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned* hist = reinterpret_cast<unsigned*>(smem);  // [GB][B][kWords]
  const int g0 = blockIdx.y * group_block;
  const int ng = min(group_block, n_groups - g0);
  for (int i = threadIdx.x; i < ng * num_bins * kWords; i += blockDim.x) hist[i] = 0;
  __syncthreads();

  double scale[CH];
#pragma unroll
  for (int c = 0; c < CH; ++c) scale[c] = kFixed ? ldexp(1.0, exps[c]) : 1.0;
  const long long a = count * blockIdx.x / gridDim.x;
  const long long z = count * (blockIdx.x + 1) / gridDim.x;
  const long long step = static_cast<long long>(kRowsPerThread) * blockDim.x;
  for (long long base = a & ~3LL; base < z; base += step) {
    const long long p0 = base + kRowsPerThread * threadIdx.x;
    if (p0 >= z) continue;
    long long r[kRowsPerThread];
    if (idx != nullptr && p0 >= a && p0 + 3 < z
        && (reinterpret_cast<uintptr_t>(idx + p0) & 15) == 0) {
      const int4 q = __ldg(reinterpret_cast<const int4*>(idx + p0));
      r[0] = q.x, r[1] = q.y, r[2] = q.z, r[3] = q.w;
    } else {
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const long long p = p0 + i;
        r[i] = p < a || p >= z ? n_rows : idx != nullptr ? idx[p] : p;
      }
    }
    V v[kRowsPerThread][CH];
    unsigned nf = 0;  // the non-finite codes, 2 bits a (row, channel)
    unsigned ok = 0;  // bit i: row i is a row of the plane
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const bool in = r[i] >= 0 && r[i] < n_rows;
      ok |= unsigned(in) << i;
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const GH x = in ? gh[r[i] * CH + c] : GH(0);
        v[i][c] = to_value<kFixed, V>(x, scale[c], nf, 2 * (i * CH + c));
      }
    }
    if (ok == 0) continue;
    const bool run = ok == 0xf && r[1] == r[0] + 1 && r[2] == r[0] + 2 && r[3] == r[0] + 3;
    auto load = [&](int gi) -> uint32_t {
      const uint8_t* plane = bins + static_cast<long long>(g0 + gi) * n_rows;
      if (run) return load4(plane, r[0], n_rows);
      uint32_t w = 0;
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        if (ok >> i & 1) w |= uint32_t(__ldg(plane + r[i])) << (8 * i);
      }
      return w;
    };
    uint32_t next = load(0);
    for (int gi = 0; gi < ng; ++gi) {
      const uint32_t word = next;
      if (gi + 1 < ng) next = load(gi + 1);
      add_rows<kFixed, CH>(hist, gi, word, v, nf, num_bins, flags,
                           static_cast<long long>(g0 + gi) * num_bins * CH, CH);
    }
  }
  __syncthreads();
  flush<kFixed, CH, 1>(hist, ng * num_bins * CH, g0, num_bins, 1, 0, 1, image);
}

// ---------------------------------------------------------------- (2)

// grid (persistent blocks, group blocks). Image: [G, num_bins, K, CH] int64
// (fixed) or int32 (integer mode: the output itself), and in the fixed mode
// flags, [G, num_bins, K, CH] codes of the non-finite values; both zeroed
// before the launch.
template <bool kFixed, int CH>
__global__ void __launch_bounds__(kThreads, 2)
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
          v[i][c] = to_value<kFixed, V>(x, scale[c], nf, 2 * (i * CH + c));
        }
      }
      if (!any) continue;
      uint32_t next = load4(bins + static_cast<long long>(g0) * n_rows, r0, n_rows);
      for (int gi = 0; gi < ng; ++gi) {
        const uint32_t word = next;
        if (gi + 1 < ng) {
          next = load4(bins + static_cast<long long>(g0 + gi + 1) * n_rows, r0, n_rows);
        }
        add_rows<kFixed, CH>(hist, gi, word, v, nf, num_bins, flags,
                             (static_cast<long long>(g0 + gi) * num_bins * n_ranges + k) * CH,
                             static_cast<long long>(n_ranges) * CH);
      }
    }
    __syncthreads();
    // flush range k's share
    flush<kFixed, CH, 1>(hist, cells, g0, num_bins, n_ranges, k, 1, image);
    __syncthreads();
    a = stop;
  }
}

// ---------------------------------------------------------------- (3)

// A thread's four rows into one group's slot-expanded histogram [B][ns]
// (`hist`, the group's first cell): `word` holds their bins (byte i for row
// i), ls their slots less the block's first, ok which rows fall in the
// block's slots, v their values. Runs of rows equal in bin and slot are
// summed in registers first. Each non-finite value (its code in nf, 2 bits a
// (row, channel)) flags its own cell: flags[at + (b * n_slots + ls) * CH + c].
template <bool kFixed, int CH, typename V>
__device__ __forceinline__ void add_slot_rows(unsigned* hist, uint32_t word,
                                              const int (&ls)[kRowsPerThread], unsigned ok,
                                              const V (&v)[kRowsPerThread][CH], unsigned nf,
                                              int num_bins, int ns, int n_slots,
                                              unsigned* __restrict__ flags, long long at) {
  constexpr int kWords = bin_words(CH, kFixed);
  int cur = -1;  // the run's cell, b * ns + ls
  V acc[CH];
#pragma unroll
  for (int c = 0; c < CH; ++c) acc[c] = 0;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int b = (word >> (8 * i)) & 0xff;
    if (!(ok >> i & 1) || b >= num_bins) continue;
    const int key = b * ns + ls[i];
    if (key != cur) {
      if (cur >= 0) add_cell<kFixed, CH>(hist + cur * kWords, acc);
      cur = key;
#pragma unroll
      for (int c = 0; c < CH; ++c) acc[c] = 0;
    }
#pragma unroll
    for (int c = 0; c < CH; ++c) acc[c] += v[i][c];
  }
  if (cur >= 0) add_cell<kFixed, CH>(hist + cur * kWords, acc);
  if (kFixed && nf != 0) {
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int b = (word >> (8 * i)) & 0xff;
      if (!(ok >> i & 1) || b >= num_bins) continue;
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const unsigned code = (nf >> (2 * (i * CH + c))) & 3u;
        if (code != 0) {
          atomicOr(flags + at + (static_cast<long long>(b) * n_slots + ls[i]) * CH + c, code);
        }
      }
    }
  }
}

// grid (row chunks, group blocks, slot blocks). Image: [G, num_bins,
// n_slots, CH] int64 (fixed) or int32 (integer mode: the output itself),
// and in the fixed mode flags, [G, num_bins, n_slots, CH] codes of the
// non-finite values; both zeroed before the launch.
template <bool kFixed, int CH>
__global__ void __launch_bounds__(kThreads, 2)
hist_slots_kernel(const uint8_t* __restrict__ bins, long long n_rows, int n_groups,
                  const float* __restrict__ gh, long long gh_stride,
                  const int* __restrict__ slot, int n_slots, int num_bins, int group_block,
                  int slot_block, const int* __restrict__ exps, void* __restrict__ image,
                  unsigned* __restrict__ flags) {
  using V = typename std::conditional<kFixed, long long, int>::type;
  constexpr int kWords = bin_words(CH, kFixed);
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned* hist = reinterpret_cast<unsigned*>(smem);  // [GB][B][SB][kWords]
  const int g0 = blockIdx.y * group_block;
  const int ng = min(group_block, n_groups - g0);
  const int s0 = blockIdx.z * slot_block;
  const int ns = min(slot_block, n_slots - s0);
  const int group_words = num_bins * ns * kWords;
  for (int i = threadIdx.x; i < ng * group_words; i += blockDim.x) hist[i] = 0;
  __syncthreads();

  double scale[CH];
#pragma unroll
  for (int c = 0; c < CH; ++c) scale[c] = kFixed ? ldexp(1.0, exps[c]) : 1.0;
  const long long a = n_rows * blockIdx.x / gridDim.x;
  const long long z = n_rows * (blockIdx.x + 1) / gridDim.x;
  const long long step = static_cast<long long>(kRowsPerThread) * blockDim.x;
  for (long long base = a & ~3LL; base < z; base += step) {
    const long long r0 = base + kRowsPerThread * threadIdx.x;
    if (r0 >= z) continue;
    int ls[kRowsPerThread];  // each row's slot; a row outside [a, z): -1
    if (r0 >= a && r0 + 3 < z && (reinterpret_cast<uintptr_t>(slot + r0) & 15) == 0) {
      const int4 q = __ldg(reinterpret_cast<const int4*>(slot + r0));
      ls[0] = q.x, ls[1] = q.y, ls[2] = q.z, ls[3] = q.w;
    } else {
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const long long r = r0 + i;
        ls[i] = r >= a && r < z ? __ldg(slot + r) : -1;
      }
    }
    unsigned ok = 0;  // bit i: row i's slot is one of this block's
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const unsigned u = static_cast<unsigned>(ls[i]) - static_cast<unsigned>(s0);
      ok |= unsigned(u < static_cast<unsigned>(ns)) << i;
      ls[i] = static_cast<int>(u);
    }
    if (ok == 0) continue;
    V v[kRowsPerThread][CH];
    unsigned nf = 0;  // the non-finite codes, 2 bits a (row, channel)
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const float x = ok >> i & 1 ? gh[(r0 + i) * gh_stride + c] : 0.0f;
        v[i][c] = to_value<kFixed, V>(x, scale[c], nf, 2 * (i * CH + c));
      }
    }
    uint32_t next = load4(bins + static_cast<long long>(g0) * n_rows, r0, n_rows);
    for (int gi = 0; gi < ng; ++gi) {
      const uint32_t word = next;
      if (gi + 1 < ng) {
        next = load4(bins + static_cast<long long>(g0 + gi + 1) * n_rows, r0, n_rows);
      }
      add_slot_rows<kFixed, CH>(hist + gi * group_words, word, ls, ok, v, nf, num_bins, ns,
                                n_slots, flags,
                                (static_cast<long long>(g0 + gi) * num_bins * n_slots + s0) * CH);
    }
  }
  __syncthreads();
  flush<kFixed, CH, 0>(hist, ng * num_bins * ns * CH, g0, num_bins, n_slots, s0, ns, image);
}

// ---------------------------------------------------------------- (4)

constexpr int kConvertThreads = 256;
// Blocks of a conversion or children launch at most, and the multiple of 3
// their count is rounded up to: with kConvertThreads a multiple of 4, the
// grid's threads are a multiple of 12, so the cells a thread takes along its
// grid-stride loop, four or one at a time, keep their channels (CH <= 4).
constexpr int kConvertMaxBlocks = 132 * 12;

int convert_blocks(long long items) {
  long long blocks = (items + kConvertThreads - 1) / kConvertThreads;
  blocks = (blocks < 1 ? 3 : blocks + 2) / 3 * 3;  // at least one multiple of 3
  return int(blocks < kConvertMaxBlocks ? blocks : kConvertMaxBlocks);
}

// One cell of a float-mode image as float32: s * 2^-e_c (int64 -> double ->
// scaled exactly -> float32, each rounding to nearest even), or +inf, -inf,
// NaN for flag code 1, 2, 3.
__device__ __forceinline__ float fixed_value(long long s, unsigned code, double scale) {
  return code == 0 ? __double2float_rn(__ll2double_rn(s) * scale)
       : code == 1 ? __int_as_float(0x7f800000)
       : code == 2 ? __int_as_float(0xff800000)
                   : __int_as_float(0x7fc00000);
}

// out[i] = fixed_value(sums[i], flags[i], 2^-exps[i % ch]). With `vec` (the
// three arrays 16-byte aligned) a thread takes cells four at a time (two
// 16-byte loads of sums, one of flags, one 16-byte store), the last
// count % 4 by the first threads; else one at a time.
__global__ void __launch_bounds__(kConvertThreads)
hist_image_to_float_kernel(const long long* __restrict__ sums,
                           const unsigned* __restrict__ flags, long long count, int ch,
                           const int* __restrict__ exps, float* __restrict__ out, int vec) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const long long T = static_cast<long long>(gridDim.x) * blockDim.x;  // a multiple of 12
  if (vec) {
    double sc[4];  // cell 4 j + m's scale, the same for every j of this thread
#pragma unroll
    for (int m = 0; m < 4; ++m) sc[m] = ldexp(1.0, -__ldg(exps + (4 * t + m) % ch));
    const long long quads = count >> 2;
    const longlong2* s2 = reinterpret_cast<const longlong2*>(sums);
    const uint4* f4 = reinterpret_cast<const uint4*>(flags);
    float4* o4 = reinterpret_cast<float4*>(out);
    for (long long j = t; j < quads; j += T) {
      const longlong2 a = __ldg(s2 + 2 * j);
      const longlong2 b = __ldg(s2 + 2 * j + 1);
      const uint4 f = __ldg(f4 + j);
      o4[j] = make_float4(fixed_value(a.x, f.x, sc[0]), fixed_value(a.y, f.y, sc[1]),
                          fixed_value(b.x, f.z, sc[2]), fixed_value(b.y, f.w, sc[3]));
    }
    const long long i = (quads << 2) + t;
    if (i < count) {
      out[i] = fixed_value(sums[i], flags[i], ldexp(1.0, -__ldg(exps + int(i % ch))));
    }
  } else {
    const double sc = ldexp(1.0, -__ldg(exps + t % ch));
    for (long long i = t; i < count; i += T) {
      out[i] = fixed_value(__ldg(sums + i), __ldg(flags + i), sc);
    }
  }
}

// The flag code of a - b for the codes of a and b (index 4 a + b): a float
// difference of +inf, -inf or NaN cells; ops/histogram.py:_SUB_CODES, two
// bits a code in kSubWord.
constexpr unsigned char kSubCodes[16] = {0, 2, 1, 3, 1, 3, 1, 3, 2, 2, 3, 3, 3, 3, 3, 3};

constexpr unsigned pack_sub_codes() {
  unsigned w = 0;
  for (int i = 0; i < 16; ++i) w |= unsigned(kSubCodes[i]) << (2 * i);
  return w;
}

constexpr unsigned kSubWord = pack_sub_codes();

__device__ __forceinline__ unsigned sub_code(unsigned a, unsigned b) {
  return (kSubWord >> (2 * (4 * (a & 3u) + (b & 3u)))) & 3u;
}

// The wave's children step, grid (cell blocks, K leaves). pool [*, G, B, CH]
// sums S, leaf k's parent at row sel[k]; small the smaller children's image
// [G, B, K, CH] as (2) writes it; left_small [K] bytes. The left child is
// the smaller one, or parent - smaller, on its side; the right one parent -
// left, as ops/histogram.py:children composes them. Fixed point (S = long
// long): pool_flags and small_flags the uint32 flag words, the children's
// flags by sub_code; writes left, right [K, G, B, CH] (sums and flags) and
// out [2K, G, B, CH] float32. Integer mode (S = int, the quantized pool: no
// flags, nothing to convert): writes only out [2K, G, B, CH] int32, whose
// halves are the children. Leaf k's left child is out's 2k, its right 2k +
// 1. A thread's cells keep their channel (convert_blocks).
template <typename S, int CH>
__global__ void __launch_bounds__(kConvertThreads)
wave_children_kernel(const S* __restrict__ pool, const unsigned* __restrict__ pool_flags,
                     const int* __restrict__ sel, const S* __restrict__ small,
                     const unsigned* __restrict__ small_flags,
                     const uint8_t* __restrict__ left_small, long long gb_count,
                     const int* __restrict__ exps, S* __restrict__ left,
                     unsigned* __restrict__ left_flags, S* __restrict__ right,
                     unsigned* __restrict__ right_flags, void* __restrict__ out) {
  constexpr bool kFixed = std::is_same<S, long long>::value;
  using U = typename std::make_unsigned<S>::type;  // wrapping differences
  const int k = blockIdx.y;
  const int n_leaves = gridDim.y;
  const long long cells = gb_count * CH;
  const long long parent = static_cast<long long>(__ldg(sel + k)) * cells;
  const bool small_left = __ldg(left_small + k) != 0;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const long long T = static_cast<long long>(gridDim.x) * blockDim.x;  // a multiple of 12
  const int c = t % CH;
  const double sc = kFixed ? ldexp(1.0, -__ldg(exps + c)) : 1.0;
  const long long at = static_cast<long long>(k) * cells;  // leaf k in left, right
  using O = typename std::conditional<kFixed, float, int>::type;
  O* out_l = static_cast<O*>(out) + 2 * at;
  O* out_r = out_l + cells;
  for (long long i = t; i < cells; i += T) {
    const long long si = (i / CH * n_leaves + k) * CH + c;
    const U p = static_cast<U>(__ldg(pool + parent + i));
    const U s = static_cast<U>(__ldg(small + si));
    const U l = small_left ? s : p - s;
    const U r = p - l;
    if constexpr (kFixed) {
      const unsigned pf = __ldg(pool_flags + parent + i);
      const unsigned sf = __ldg(small_flags + si);
      const unsigned lf = small_left ? sf : sub_code(pf, sf);
      const unsigned rf = sub_code(pf, lf);
      left[at + i] = static_cast<S>(l);
      left_flags[at + i] = lf;
      right[at + i] = static_cast<S>(r);
      right_flags[at + i] = rf;
      out_l[i] = fixed_value(static_cast<S>(l), lf, sc);
      out_r[i] = fixed_value(static_cast<S>(r), rf, sc);
    } else {
      out_l[i] = static_cast<S>(l);
      out_r[i] = static_cast<S>(r);
    }
  }
}

// The float modes' scratch is one buffer, `cells` int64 sums and behind
// them `cells` flag words, zeroed with one memset; the integer modes' image
// is the int32 output.
size_t image_bytes(long long cells, bool fixed) {
  return size_t(cells) * (fixed ? sizeof(long long) + sizeof(unsigned) : sizeof(int));
}

unsigned* flag_words(void* image, long long cells) {
  return reinterpret_cast<unsigned*>(static_cast<long long*>(image) + cells);
}

// Opt the kernel into `smem` bytes of dynamic shared memory on the current
// device, once for each size it grows to (`opted`, the caller's, one for
// each kernel instantiation, by device): the first launches set it, so a
// launch captured into a CUDA graph after them makes no call but the launch.
constexpr int kMaxDevices = 64;
template <typename Kernel>
cudaError_t opt_in(Kernel kernel, size_t smem, size_t (&opted)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 0 && dev < kMaxDevices && smem <= opted[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err == cudaSuccess && dev >= 0 && dev < kMaxDevices) opted[dev] = smem;
  return err;
}

// The float modes' last step, on `count` cells.
cudaError_t fixed_to_float(const void* image, const unsigned* flags, long long count, int ch,
                           const int* exps, float* out, cudaStream_t stream) {
  const bool vec = ((reinterpret_cast<uintptr_t>(image) | reinterpret_cast<uintptr_t>(flags)
                     | reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  hist_image_to_float_kernel<<<convert_blocks(vec ? count / 4 : count), kConvertThreads, 0,
                               stream>>>(static_cast<const long long*>(image), flags, count, ch,
                                         exps, out, vec ? 1 : 0);
  return cudaGetLastError();
}

template <typename GH, int CH>
cudaError_t launch_rows(dim3 grid, size_t smem, cudaStream_t stream, const uint8_t* bins,
                        long long n_rows, int n_groups, const GH* gh, const int* idx,
                        long long count, int num_bins, int group_block, const int* exps,
                        void* image, unsigned* flags) {
  auto kernel = hist_rows_kernel<GH, CH>;
  static size_t opted[kMaxDevices] = {};
  cudaError_t err = opt_in(kernel, smem, opted);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(bins, n_rows, n_groups, gh, idx, count, num_bins,
                                           group_block, exps, image, flags);
  return cudaGetLastError();
}

template <typename GH>
int rows(const uint8_t* bins, long long n_rows, int n_groups, const GH* gh, int ch,
         const int* idx, long long count, int num_bins, int group_block, int blocks,
         const int* exps, void* image, float* out, int carry, cudaStream_t stream) {
  constexpr bool kFixed = std::is_same<GH, float>::value;
  if (ch < 1 || ch > kMaxChannels || num_bins < 1 || num_bins > 256 || group_block < 1
      || blocks < 1 || count < 1 || (kFixed && exps == nullptr)
      || carry < 0 || carry > (kCarryKeep | kCarryOpen)) {
    return int(cudaErrorInvalidValue);
  }
  const size_t smem = sizeof(unsigned) * size_t(group_block) * num_bins * bin_words(ch, kFixed);
  const dim3 grid(blocks, (n_groups + group_block - 1) / group_block);
  const long long cells = (long long)n_groups * num_bins * ch;
  unsigned* flags = kFixed ? flag_words(image, cells) : nullptr;
  cudaError_t err = cudaSuccess;
  if (!(carry & kCarryKeep)) {
    err = cudaMemsetAsync(image, 0, image_bytes(cells, kFixed), stream);
    if (err != cudaSuccess) return int(err);
  }
  switch (ch) {
    case 1: err = launch_rows<GH, 1>(grid, smem, stream, bins, n_rows, n_groups, gh, idx,
                                     count, num_bins, group_block, exps, image, flags); break;
    case 2: err = launch_rows<GH, 2>(grid, smem, stream, bins, n_rows, n_groups, gh, idx,
                                     count, num_bins, group_block, exps, image, flags); break;
    case 3: err = launch_rows<GH, 3>(grid, smem, stream, bins, n_rows, n_groups, gh, idx,
                                     count, num_bins, group_block, exps, image, flags); break;
    default: err = launch_rows<GH, 4>(grid, smem, stream, bins, n_rows, n_groups, gh, idx,
                                      count, num_bins, group_block, exps, image, flags); break;
  }
  if (err != cudaSuccess || !kFixed || (carry & kCarryOpen)) return int(err);
  return int(fixed_to_float(image, flags, cells, ch, exps, out, stream));
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
  static size_t opted[kMaxDevices] = {};
  cudaError_t err = opt_in(kernel, smem, opted);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(bins, n_rows, n_groups, gh, gh_stride, slot,
                                           starts, ends, valid, n_ranges, num_bins,
                                           group_block, exps, image, flags);
  return cudaGetLastError();
}

template <bool kFixed>
int ragged(const uint8_t* bins, long long n_rows, int n_groups, const float* gh,
           long long gh_stride, int ch, const int* slot, const int* starts, const int* ends,
           const uint8_t* valid, int n_ranges, int num_bins, int group_block, int blocks,
           const int* exps, void* image, float* out, bool open, cudaStream_t stream) {
  if (ch < 1 || ch > kMaxChannels || num_bins < 1 || num_bins > 256 || group_block < 1
      || n_ranges < 1 || n_ranges > kMaxRanges || blocks < 1 || (kFixed && exps == nullptr)) {
    return int(cudaErrorInvalidValue);
  }
  const size_t smem = ragged_smem_bytes(group_block, num_bins, ch, kFixed);
  const dim3 grid(blocks, (n_groups + group_block - 1) / group_block);
  const long long cells = (long long)n_groups * num_bins * n_ranges * ch;
  unsigned* flags = kFixed ? flag_words(image, cells) : nullptr;
  cudaError_t err = cudaMemsetAsync(image, 0, image_bytes(cells, kFixed), stream);
  if (err != cudaSuccess) return int(err);
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
  if (err != cudaSuccess || !kFixed || open) return int(err);
  return int(fixed_to_float(image, flags, cells, ch, exps, out, stream));
}

size_t slots_smem_bytes(int group_block, int slot_block, int num_bins, int ch, bool fixed) {
  return sizeof(unsigned) * size_t(group_block) * num_bins * slot_block * bin_words(ch, fixed);
}

template <bool kFixed, int CH>
cudaError_t launch_slots(dim3 grid, size_t smem, cudaStream_t stream, const uint8_t* bins,
                         long long n_rows, int n_groups, const float* gh, long long gh_stride,
                         const int* slot, int n_slots, int num_bins, int group_block,
                         int slot_block, const int* exps, void* image, unsigned* flags) {
  auto kernel = hist_slots_kernel<kFixed, CH>;
  static size_t opted[kMaxDevices] = {};
  cudaError_t err = opt_in(kernel, smem, opted);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(bins, n_rows, n_groups, gh, gh_stride, slot, n_slots,
                                           num_bins, group_block, slot_block, exps, image,
                                           flags);
  return cudaGetLastError();
}

template <bool kFixed>
int slots(const uint8_t* bins, long long n_rows, int n_groups, const float* gh,
          long long gh_stride, int ch, const int* slot, int n_slots, int num_bins,
          int group_block, int slot_block, int blocks, const int* exps, void* image, float* out,
          cudaStream_t stream) {
  if (ch < 1 || ch > kMaxChannels || num_bins < 1 || num_bins > 256 || n_rows < 1
      || n_groups < 1 || n_slots < 1 || group_block < 1 || slot_block < 1
      || slot_block > n_slots || blocks < 1 || (kFixed && exps == nullptr)) {
    return int(cudaErrorInvalidValue);
  }
  const int n_gblocks = (n_groups + group_block - 1) / group_block;
  const int n_sblocks = (n_slots + slot_block - 1) / slot_block;
  if (n_gblocks > 65535 || n_sblocks > 65535) return int(cudaErrorInvalidValue);
  const size_t smem = slots_smem_bytes(group_block, slot_block, num_bins, ch, kFixed);
  const dim3 grid(blocks, n_gblocks, n_sblocks);
  const long long cells = (long long)n_groups * num_bins * n_slots * ch;
  unsigned* flags = kFixed ? flag_words(image, cells) : nullptr;
  cudaError_t err = cudaMemsetAsync(image, 0, image_bytes(cells, kFixed), stream);
  if (err != cudaSuccess) return int(err);
  switch (ch) {
    case 1: err = launch_slots<kFixed, 1>(grid, smem, stream, bins, n_rows, n_groups, gh,
                                          gh_stride, slot, n_slots, num_bins, group_block,
                                          slot_block, exps, image, flags); break;
    case 2: err = launch_slots<kFixed, 2>(grid, smem, stream, bins, n_rows, n_groups, gh,
                                          gh_stride, slot, n_slots, num_bins, group_block,
                                          slot_block, exps, image, flags); break;
    case 3: err = launch_slots<kFixed, 3>(grid, smem, stream, bins, n_rows, n_groups, gh,
                                          gh_stride, slot, n_slots, num_bins, group_block,
                                          slot_block, exps, image, flags); break;
    default: err = launch_slots<kFixed, 4>(grid, smem, stream, bins, n_rows, n_groups, gh,
                                           gh_stride, slot, n_slots, num_bins, group_block,
                                           slot_block, exps, image, flags); break;
  }
  if (err != cudaSuccess || !kFixed) return int(err);
  return int(fixed_to_float(image, flags, cells, ch, exps, out, stream));
}

template <typename S, int CH>
cudaError_t launch_children(dim3 grid, cudaStream_t stream, const void* pool,
                            const unsigned* pool_flags, const int* sel, const void* small,
                            const unsigned* small_flags, const uint8_t* left_small,
                            long long gb_count, const int* exps, void* left,
                            unsigned* left_flags, void* right, unsigned* right_flags,
                            void* out) {
  wave_children_kernel<S, CH><<<grid, kConvertThreads, 0, stream>>>(
      static_cast<const S*>(pool), pool_flags, sel, static_cast<const S*>(small), small_flags,
      left_small, gb_count, exps, static_cast<S*>(left), left_flags, static_cast<S*>(right),
      right_flags, out);
  return cudaGetLastError();
}

template <typename S>
int children(const void* pool, const unsigned* pool_flags, const int* sel, const void* small,
             const unsigned* small_flags, const uint8_t* left_small, int n_leaves,
             long long gb_count, int ch, const int* exps, void* left, unsigned* left_flags,
             void* right, unsigned* right_flags, void* out, void* stream) {
  constexpr bool kFixed = std::is_same<S, long long>::value;
  if (ch < 1 || ch > kMaxChannels || n_leaves < 1 || n_leaves > 65535 || gb_count < 0
      || (kFixed && exps == nullptr)) {
    return int(cudaErrorInvalidValue);
  }
  if (gb_count == 0) return int(cudaSuccess);
  const dim3 grid(convert_blocks(gb_count * ch), n_leaves);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (ch) {
    case 1: err = launch_children<S, 1>(grid, s, pool, pool_flags, sel, small, small_flags,
                                        left_small, gb_count, exps, left, left_flags, right,
                                        right_flags, out); break;
    case 2: err = launch_children<S, 2>(grid, s, pool, pool_flags, sel, small, small_flags,
                                        left_small, gb_count, exps, left, left_flags, right,
                                        right_flags, out); break;
    case 3: err = launch_children<S, 3>(grid, s, pool, pool_flags, sel, small, small_flags,
                                        left_small, gb_count, exps, left, left_flags, right,
                                        right_flags, out); break;
    default: err = launch_children<S, 4>(grid, s, pool, pool_flags, sel, small, small_flags,
                                         left_small, gb_count, exps, left, left_flags, right,
                                         right_flags, out); break;
  }
  return int(err);
}

}  // namespace

extern "C" {

// The leaf histogram. gh [*, ch] (rows idx[p] < n_rows are read, rows of
// stride ch); idx [>= count] int32 or NULL (the identity); `count` positions
// read; `blocks` row chunks a group block. Float mode (_f32): exps [ch]
// int32 the fixed-point exponents, image the scratch of G * num_bins * ch
// int64 sums and as many uint32 flag words behind them, out
// [G, num_bins, ch] float32. Integer mode (_i32, int8 gh): image is the
// int32 output itself; exps and out unused. `carry` 0 is one call (the
// image zeroed here, then converted into out); otherwise the bits of
// kCarryKeep (add into the image as it is) and kCarryOpen (leave it
// unconverted) carry one histogram across calls.
int lgbt_histogram_f32(const uint8_t* bins, long long n_rows, int n_groups, const float* gh,
                       int ch, const int* idx, long long count, int num_bins,
                       int group_block, int blocks, const int* exps, void* image, float* out,
                       int carry, void* stream) {
  return rows<float>(bins, n_rows, n_groups, gh, ch, idx, count, num_bins, group_block,
                     blocks, exps, image, out, carry, static_cast<cudaStream_t>(stream));
}

int lgbt_histogram_i32(const uint8_t* bins, long long n_rows, int n_groups, const int8_t* gh,
                       int ch, const int* idx, long long count, int num_bins,
                       int group_block, int blocks, const int* exps, void* image, float* out,
                       int carry, void* stream) {
  return rows<int8_t>(bins, n_rows, n_groups, gh, ch, idx, count, num_bins, group_block,
                      blocks, exps, image, out, carry, static_cast<cudaStream_t>(stream));
}

// The ragged (wave) histogram. gh [N, ch] float32 with row stride gh_stride;
// slot [N] int32; starts/ends [K] int32, valid [K] bytes; `blocks` persistent
// blocks a group block. Float mode (_f32): exps [ch] int32 the fixed-point
// exponents, image the scratch of G * num_bins * K * ch int64 sums and as
// many uint32 flag words behind them (zeroed here), out [G, num_bins, K * ch]
// float32. Integer mode (_i32): image is the int32 output itself (zeroed
// here); exps and out unused.
int lgbt_histogram_ragged_f32(const uint8_t* bins, long long n_rows, int n_groups,
                              const float* gh, long long gh_stride, int ch, const int* slot,
                              const int* starts, const int* ends, const uint8_t* valid,
                              int n_ranges, int num_bins, int group_block, int blocks,
                              const int* exps, void* image, float* out, void* stream) {
  return ragged<true>(bins, n_rows, n_groups, gh, gh_stride, ch, slot, starts, ends, valid,
                      n_ranges, num_bins, group_block, blocks, exps, image, out, false,
                      static_cast<cudaStream_t>(stream));
}

int lgbt_histogram_ragged_i32(const uint8_t* bins, long long n_rows, int n_groups,
                              const float* gh, long long gh_stride, int ch, const int* slot,
                              const int* starts, const int* ends, const uint8_t* valid,
                              int n_ranges, int num_bins, int group_block, int blocks,
                              const int* exps, void* image, float* out, void* stream) {
  return ragged<false>(bins, n_rows, n_groups, gh, gh_stride, ch, slot, starts, ends, valid,
                       n_ranges, num_bins, group_block, blocks, exps, image, out, false,
                       static_cast<cudaStream_t>(stream));
}

// The ragged histogram's image mode: the float mode's int64 fixed-point
// sums [G, num_bins, K * ch] and the uint32 flag words behind them, left in
// `image` unconverted (zeroed here first), so the images of several
// processes' rows can be added exactly before one conversion
// (lgbt_histogram_image_to_f32). Arguments as lgbt_histogram_ragged_f32's.
int lgbt_histogram_ragged_image(const uint8_t* bins, long long n_rows, int n_groups,
                                const float* gh, long long gh_stride, int ch, const int* slot,
                                const int* starts, const int* ends, const uint8_t* valid,
                                int n_ranges, int num_bins, int group_block, int blocks,
                                const int* exps, void* image, void* stream) {
  return ragged<true>(bins, n_rows, n_groups, gh, gh_stride, ch, slot, starts, ends, valid,
                      n_ranges, num_bins, group_block, blocks, exps, image, nullptr, true,
                      static_cast<cudaStream_t>(stream));
}

// The conversion of a float-mode image: out[i] = sums[i] * 2^-exps[i % ch]
// as float32 (int64 -> double -> scaled -> float32, each rounding to nearest
// even), or +inf, -inf, NaN where flags[i] holds code 1, 2 or 3. sums
// [count] int64, flags [count] uint32, out [count] float32, count a
// multiple of ch with channel fastest. The last step of both kernels' float
// modes, for an image that was carried over calls or summed over processes.
int lgbt_histogram_image_to_f32(const void* sums, const unsigned* flags, long long count,
                                int ch, const int* exps, float* out, void* stream) {
  if (ch < 1 || ch > kMaxChannels || count < 0 || count % ch != 0 || exps == nullptr) {
    return int(cudaErrorInvalidValue);
  }
  if (count == 0) return int(cudaSuccess);
  return int(fixed_to_float(sums, flags, count, ch, exps, out,
                            static_cast<cudaStream_t>(stream)));
}

// The slot-expanded histogram over every row (hist_slots_kernel). gh [N, ch]
// float32 with row stride gh_stride; slot [N] int32, a row adding to slot
// slot[n] when it lies in [0, n_slots); a grid of `blocks` row chunks, group
// blocks of group_block groups and slot blocks of slot_block slots. Float
// mode (_f32): exps [ch] int32 the fixed-point exponents, image the scratch
// of G * num_bins * n_slots * ch int64 sums and as many uint32 flag words
// behind them (zeroed here), out [G, num_bins, n_slots * ch] float32.
// Integer mode (_i32): image is the int32 output itself (zeroed here); exps
// and out unused.
int lgbt_histogram_slots_f32(const uint8_t* bins, long long n_rows, int n_groups,
                             const float* gh, long long gh_stride, int ch, const int* slot,
                             int n_slots, int num_bins, int group_block, int slot_block,
                             int blocks, const int* exps, void* image, float* out,
                             void* stream) {
  return slots<true>(bins, n_rows, n_groups, gh, gh_stride, ch, slot, n_slots, num_bins,
                     group_block, slot_block, blocks, exps, image, out,
                     static_cast<cudaStream_t>(stream));
}

int lgbt_histogram_slots_i32(const uint8_t* bins, long long n_rows, int n_groups,
                             const float* gh, long long gh_stride, int ch, const int* slot,
                             int n_slots, int num_bins, int group_block, int slot_block,
                             int blocks, const int* exps, void* image, float* out,
                             void* stream) {
  return slots<false>(bins, n_rows, n_groups, gh, gh_stride, ch, slot, n_slots, num_bins,
                      group_block, slot_block, blocks, exps, image, out,
                      static_cast<cudaStream_t>(stream));
}

// The wave's children step (wave_children_kernel): pool [*, gb_count, ch]
// int64 and pool_flags uint32, sel [n_leaves] int32 rows of the pool (the
// caller's: not checked), small [gb_count, n_leaves, ch] int64 and
// small_flags uint32, left_small [n_leaves] bytes, exps [ch] int32; writes
// left, right [n_leaves, gb_count, ch] int64 with their uint32 flag words
// and out [2 n_leaves, gb_count, ch] float32.
int lgbt_wave_children(const void* pool, const unsigned* pool_flags, const int* sel,
                       const void* small, const unsigned* small_flags,
                       const uint8_t* left_small, int n_leaves, long long gb_count, int ch,
                       const int* exps, void* left, unsigned* left_flags, void* right,
                       unsigned* right_flags, float* out, void* stream) {
  return children<long long>(pool, pool_flags, sel, small, small_flags, left_small, n_leaves,
                             gb_count, ch, exps, left, left_flags, right, right_flags, out,
                             stream);
}

// Its integer mode (the quantized pool): pool [*, gb_count, ch] and small
// [gb_count, n_leaves, ch] int32, no flags; writes only out [2 n_leaves,
// gb_count, ch] int32, leaf k's left child at 2k and its right at 2k + 1.
int lgbt_wave_children_i32(const void* pool, const int* sel, const void* small,
                           const uint8_t* left_small, int n_leaves, long long gb_count, int ch,
                           int* out, void* stream) {
  return children<int>(pool, nullptr, sel, small, nullptr, left_small, n_leaves, gb_count, ch,
                       nullptr, nullptr, nullptr, nullptr, nullptr, out, stream);
}

}  // extern "C"
