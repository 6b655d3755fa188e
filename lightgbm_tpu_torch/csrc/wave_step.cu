// A wave's selection and replay for Hopper (sm_90a): the wave learner's
// per-wave work around its partition, histogram and split search, on the
// card. It is glue, not a TPU kernel: the JAX grower computes it in XLA
// inside its while_loop (lightgbm_tpu/treelearner/device.py _grow_impl: the
// frontier choice jax.lax.top_k and the selected leaves' fields, :586-596;
// _decide_go_left, :128-139; the guard, :310-315; replay_step, :750-799;
// the commit, :801-826; the loop condition cond, :838-840). The plain
// versions are ops/wave.py:_select_wave_plain and _replay_wave_plain, and
// both kernels give their bits exactly.
//
// The tree's state lives on the card (ops/wave.py): leaf_best [L+1, 14]
// float32 records, depth, start, count [L+1] int32, rec_store [*, 18] float32
// (the split log), and five int64 scalars (n_cur, t, hist_rows, n_waves,
// done).
//
// The order. Leaf i ranks before leaf j when its gain is larger, a NaN
// ranking above every number and -0 equal to +0, ties to the lower leaf
// index (torch.sort(descending, stable), jax.lax.top_k, and the first
// maximum of torch.argmax). Each leaf gets one integer key that orders so:
// its gain's bits made monotone (every NaN one key above +inf, -0 the key
// of +0) above its leaf index inverted. Keys are distinct, so a leaf's rank
// is a count and the top K are a set.
//
// What bounds them. Bytes: the selection reads L gains and K records and
// writes (L + 2 + 5K + 256K) int32; the replay reads 2K records and totals
// and L gains and writes a few [L+1] rows: a few KB, well under a
// microsecond of device memory time. Both are latency-bound, so the design
// counts dependent steps, not bytes: each kernel makes every global load in
// one or two parallel rounds at its start, works in shared memory and
// registers, and writes once at its end.
//
// wave_select_kernel (one block of the power of two >= L threads, L <= 1,024).
// Each thread loads its own leaf's record, range and (while its gain is
// positive) its split feature's six int32 fields and is_efb byte at once;
// the feature's loads wait on the record's, but nothing waits on them until
// the rank is known. The keys are sorted by a bitonic network, a key a
// thread: partners in one warp by shuffles, in other warps through shared
// memory (log2(n) (log2(n) + 1) / 2 steps, 36 at L = 255, of which 6 cross
// warps). Each position's thread tells its leaf its rank; each leaf of rank
// below K writes its range's fields from its registers; then the block
// writes the [K, 256] decision table (NumericalDecisionInner on the raw
// group bin).
//
// wave_select_large_kernel (1,024 threads, L > 1,024: keys that cannot all
// be held). A radix select of the K-th largest key, a byte a pass (8
// passes of a shared histogram over the keys, each thread ceil(L / 1,024)
// of them, and a warp's scan of 256 counts), gathers the K keys at or
// above it, sorts them by the bitonic network in shared memory, and reads
// the selected leaves' fields.
//
// wave_replay_kernel (one block of 512 threads). The replay commits, while
// the tree's largest gain is positive, belongs to a valid selected range
// not yet committed this wave, and t < L - 1: that leaf keeps the left
// child, leaf n_cur takes the right, the split log takes row t. A commit
// changes the gains of two leaves only, both known before the chain
// starts: a valid selected leaf, and a leaf n_cur + c. So the chain's
// argmax runs over at most 2K + 1 entries in shared memory: the valid
// selected ranges' leaves, the leaves n_cur + c (c < K) that are not valid
// selections, and one entry for the largest key of every other leaf, which
// the wave does not change (a block-wide max in the prologue, at any L).
// An entry's low bits carry its range, or a stop mark for an entry that
// may not be committed (another leaf, a committed range), so the argmax
// alone decides a step.
//
// Prologue (all threads, two rounds of global loads: the table's and the
// children's, then the selected leaves' depths and records and the new
// leaves' gains): the guard on the 2K children's gains at their parents'
// depth + 1, the children's keys, each range's parent output in float32 in
// the JAX replay's op order (built with --fmad=false), the rows
// histogrammed, the entries. The chain (one warp): each lane keeps the
// largest key of its entries; a step is two warp max-reductions
// (__reduce_max_sync, the gain's bits, then the leaf and range bits among
// the lanes that hold that gain); a commit sets two entries' keys from the
// children's, only their lanes rescan their entries, and lane 0 appends
// the range to the commit list. It reads and writes shared memory only.
// Epilogue (all threads): from the commit list the split log's rows (the
// parent's record as it was before the wave: the records are read in the
// prologue, and a block barrier parts the reads of the rest from the
// writes), both children's records and depths, the committed children's
// start and count, the [5, K] int64 commit table (an uncommitted range
// writes the dump row L and the empty range [0, 0)), and the scalars:
// n_cur, t, hist_rows + each valid range's smaller child, n_waves + 1 when
// the wave started live, and done unless t < L - 1 and the largest gain is
// positive. A leaf written twice in a wave (a leaf n_cur + c that is also
// a valid selection, which a real tree never has) takes its last write, as
// the plain version's in-order writes give it.
//
// lgbt_tree_graph: a whole tree as one CUDA graph, built with the runtime's
// graph API. The root's work (a captured child graph), then
// tree_loop_cond_kernel (one thread), which sets the condition of a WHILE
// node from the done word, then the WHILE node, whose body is two waves
// (captured child graphs of both buffer parities, so a pass ends on the
// parity it began with). The body's condition is set by the second wave's
// own replay kernel: lgbt_tree_graph switches that launch to
// wave_replay_kernel<true> in the body's clone of the wave (the captures,
// and every wave launched outside a tree graph, run <false>, which has no
// device-side runtime call), and the replay, after it writes the
// done word, counts the pass and sets the condition (done == 0 and passes
// at most max_passes). So a pass launches the waves' kernels and nothing
// else: the one-thread condition kernel a pass, a launch floor of its own
// (~0.002 ms), is gone. A pass past max_passes clears the condition and
// leaves the count above the bound, which the host reads as a loop that
// never finished. The condition after the root stays a kernel: the root's
// last writer of the done word is a PyTorch operation.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <cstring>
#include <tuple>
#include <utility>
#include <vector>

namespace {

constexpr int kRec = 14;               // ops/split.py SPLIT_FIELDS
constexpr int kStore = kRec + 4;       // a split-log row
constexpr int kGroupBins = 256;
constexpr int kMaxK = 1024;            // ranges a wave (the partition's kMaxRanges)
constexpr int kSortLeaves = 1024;      // the selection sorts a key a thread up to this many
constexpr int kLargeThreads = 1024;
constexpr int kReplayThreads = 512;
constexpr int kPrefetch = 2;           // (range, field) items a replay thread loads up front
constexpr int kLeafBits = 20;          // leaf ids below 2^20 (LightGBM's num_leaves <= 131,072)
constexpr unsigned kStop = 0xfffu;     // an entry's range bits: not a range to commit
constexpr unsigned kNanKey = 0xffffffffu;
constexpr unsigned kZeroKey = 0x80000000u;  // the key of +0 and -0
constexpr int kMissingZero = 1, kMissingNan = 2;  // common.py MISSING_ZERO, MISSING_NAN
constexpr int kNCur = 0, kT = 1, kHistRows = 2, kNWaves = 3, kDone = 4;  // the scalars
constexpr float kEps = 1e-15f;         // the replay's floor under the parent's hessian
constexpr unsigned kFull = 0xffffffffu;

// The tree loop's condition in the replay kernel's epilogue, read only by
// wave_replay_kernel<true> (a tree graph's second wave), which counts the
// pass in *passes and sets the WHILE node's condition.
struct TreeLoop {
  cudaGraphConditionalHandle handle;
  long long* passes;
  long long max_passes;
};

// a gain's bits, monotone in the gain: every NaN above +inf, -0 as +0
__device__ __forceinline__ unsigned gain_key(float g) {
  if (g != g) return kNanKey;
  unsigned u = __float_as_uint(g);
  if ((u << 1) == 0u) u = 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ bool positive_key(unsigned k) { return k > kZeroKey && k != kNanKey; }

// the selection's key: the gain's above the leaf inverted (lower leaf, larger key)
__device__ __forceinline__ unsigned long long leaf_key(float g, int leaf) {
  return (static_cast<unsigned long long>(gain_key(g)) << 32) | (0xffffffffu - unsigned(leaf));
}

__device__ __forceinline__ int key_leaf(unsigned long long key) {
  return int(0xffffffffu - unsigned(key));
}

// the replay's entry bits below the gain's: the leaf inverted, then the range or kStop
__device__ __forceinline__ unsigned entry_low(int leaf, unsigned range) {
  return ((((1u << kLeafBits) - 1u) - unsigned(leaf)) << 12) | range;
}

__device__ __forceinline__ unsigned long long umax64(unsigned long long a, unsigned long long b) {
  return a > b ? a : b;
}

__device__ __forceinline__ unsigned long long umin64(unsigned long long a, unsigned long long b) {
  return a < b ? a : b;
}

__device__ __forceinline__ bool decide_go_left(int gb, int thresh, bool default_left,
                                               int missing_type, int default_bin, int nbins,
                                               int lo, int hi, bool is_efb) {
  const bool in_range = gb >= lo && gb < hi;
  const int shifted = gb - lo;
  const int natural = shifted + (shifted >= default_bin ? 1 : 0);
  const int fbin = is_efb ? (in_range ? natural : default_bin) : gb;
  const bool missing = missing_type == kMissingNan ? fbin == nbins - 1
                                                   : (missing_type == kMissingZero
                                                      && fbin == default_bin);
  return missing ? default_left : fbin <= thresh;
}

// max(x, lo) keeping a NaN, as torch.clamp does
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x != x ? x : (x < lo ? lo : x);
}

// ops/wave.py:parent_output: -sign(g) * max(|g| - l1, 0) / max(h + l2, eps),
// clipped to max_delta when positive; sign(NaN) = 0 as torch.sign gives it.
// The zero gradient's product -0 * a is an explicit IEEE multiply: folded
// as a select of 0 it would lose the sign bit the plain version keeps.
__device__ __forceinline__ float parent_output(float g, float h, float l1, float l2,
                                               float max_delta) {
  const float a = clamp_min(__fsub_rn(fabsf(g), l1), 0.f);
  const float num = g > 0.f ? -a : (g < 0.f ? a : __fmul_rn(-0.f, a));
  float out = __fdiv_rn(num, clamp_min(__fadd_rn(h, l2), kEps));
  if (max_delta > 0.f && out == out) {
    out = out < -max_delta ? -max_delta : (out > max_delta ? max_delta : out);
  }
  return out;
}

struct Tables {
  const int* group;
  const int* lo;
  const int* hi;
  const int* default_bin;
  const int* nbins;
  const int* missing_type;
  const uint8_t* is_efb;
};

// a split feature's decision fields, and a selected leaf's
struct Feature {
  int group = 0, lo = 0, hi = 0, default_bin = 0, nbins = 0, missing_type = 0;
  bool is_efb = false;
};

__device__ __forceinline__ Feature load_feature(const Tables& tb, int f) {
  Feature ft;
  ft.group = tb.group[f];
  ft.lo = tb.lo[f];
  ft.hi = tb.hi[f];
  ft.default_bin = tb.default_bin[f];
  ft.nbins = tb.nbins[f];
  ft.missing_type = tb.missing_type[f];
  ft.is_efb = tb.is_efb[f] != 0;
  return ft;
}

struct Leaf {
  float gain = 0.f, feature = 0.f, thresh = 0.f, default_left = 0.f;
  int start = 0, count = 0;
};

__device__ __forceinline__ Leaf load_leaf(const float* leaf_best, const int* start,
                                          const int* count, int i) {
  const float* rec = leaf_best + (long long)i * kRec;
  Leaf lf;
  lf.gain = rec[0];
  lf.feature = rec[1];
  lf.thresh = rec[2];
  lf.default_left = rec[3];
  lf.start = start[i];
  lf.count = count[i];
  return lf;
}

// the decision fields of the selected ranges, for the [K, 256] table
struct Ranges {
  int flags[kMaxK];  // bit 0 valid, 1 default_left, 2 is_efb; missing type << 3
  int thresh[kMaxK], default_bin[kMaxK], nbins[kMaxK], lo[kMaxK], hi[kMaxK];
};

// The selection table's views (ops/wave.py:split_select).
struct SelectTable {
  int *leaf2k, *rgroup, *start, *count, *valid, *sel, *lut;
  __device__ SelectTable(int* table, int L, int K)
      : leaf2k(table), rgroup(table + L + 2), start(rgroup + K), count(start + K),
        valid(count + K), sel(valid + K), lut(sel + K) {}
};

// range r's entries: the selected leaf, its row range, its partition fields
__device__ __forceinline__ void put_range(const SelectTable& out, Ranges& rs, int r, int leaf,
                                          const Leaf& lf, const Feature& ft, bool ok) {
  out.rgroup[r] = ok ? ft.group : 0;
  out.start[r] = lf.start;
  out.count[r] = lf.count;
  out.valid[r] = ok ? 1 : 0;
  out.sel[r] = leaf;
  rs.flags[r] = (ok ? 1 : 0) | (lf.default_left > 0.5f ? 2 : 0) | (ft.is_efb ? 4 : 0)
                | (ft.missing_type << 3);
  rs.thresh[r] = ok ? int(lf.thresh) : 0;
  rs.default_bin[r] = ft.default_bin;
  rs.nbins[r] = ft.nbins;
  rs.lo[r] = ft.lo;
  rs.hi[r] = ft.hi;
}

__device__ __forceinline__ void put_lut(const SelectTable& out, const Ranges& rs, int K) {
  for (int idx = threadIdx.x; idx < K * kGroupBins; idx += blockDim.x) {
    const int k = idx / kGroupBins, gb = idx - k * kGroupBins;
    const int fl = rs.flags[k];
    out.lut[idx] = (fl & 1) && decide_go_left(gb, rs.thresh[k], (fl & 2) != 0, fl >> 3,
                                              rs.default_bin[k], rs.nbins[k], rs.lo[k],
                                              rs.hi[k], (fl & 4) != 0) ? 1 : 0;
  }
}

__global__ void __launch_bounds__(kSortLeaves)
wave_select_kernel(const float* __restrict__ leaf_best, int n_leaves,
                   const int* __restrict__ start, const int* __restrict__ count,
                   const long long* __restrict__ scalars, Tables tb, int K,
                   int* __restrict__ table) {
  __shared__ unsigned long long sbuf[2][kSortLeaves];  // the sort's steps across warps
  __shared__ int srank[kSortLeaves];                    // each leaf's rank
  __shared__ Ranges rs;
  const int L = n_leaves, i = threadIdx.x, n = blockDim.x;
  const SelectTable out(table, L, K);
  const bool done = scalars[kDone] != 0;
  Leaf lf;
  Feature ft;  // loaded now, read once the rank is known
  unsigned long long key = 0ull;  // below every leaf's: the padding sorts last
  if (i < L) {
    lf = load_leaf(leaf_best, start, count, i);
    if (lf.gain > 0.f) ft = load_feature(tb, int(lf.feature));
    key = leaf_key(lf.gain, i);
  }
  // bitonic sort, descending, thread i holding position i
  int buf = 0;
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      unsigned long long other;
      if (j >= 32) {
        sbuf[buf][i] = key;
        __syncthreads();
        other = sbuf[buf][i ^ j];
        buf ^= 1;  // the next cross-warp step writes the other buffer
      } else {
        other = __shfl_xor_sync(kFull, key, j);
      }
      key = (((i & j) == 0) == ((i & k) == 0)) ? umax64(key, other) : umin64(key, other);
    }
  }
  if (i < L) srank[key_leaf(key)] = i;
  __syncthreads();
  if (i < L) {
    const int r = srank[i];
    const bool ok = lf.gain > 0.f && !done;
    out.leaf2k[i + 1] = (r < K && ok) ? r : K;  // by leaf id + 1 (-1 -> none)
    if (r < K) put_range(out, rs, r, i, lf, ft, ok);
  }
  if (i == 0) {
    out.leaf2k[0] = K;
    out.leaf2k[L + 1] = K;
  }
  __syncthreads();
  put_lut(out, rs, K);
}

__global__ void __launch_bounds__(kLargeThreads)
wave_select_large_kernel(const float* __restrict__ leaf_best, int n_leaves,
                         const int* __restrict__ start, const int* __restrict__ count,
                         const long long* __restrict__ scalars, Tables tb, int K,
                         int* __restrict__ table) {
  __shared__ unsigned shist[256];
  __shared__ unsigned long long stop[kMaxK];  // the top K keys, then in order
  __shared__ Ranges rs;
  __shared__ int s_digit, s_need, s_n;
  const int L = n_leaves, tid = threadIdx.x, T = blockDim.x;
  const SelectTable out(table, L, K);
  const bool done = scalars[kDone] != 0;
  auto key_of = [&](int i) { return leaf_key(leaf_best[(long long)i * kRec], i); };
  // radix select: the K-th largest key, a byte a pass from the top
  unsigned long long prefix = 0ull, mask = 0ull;
  int need = K;  // keys still to take below the prefix
  for (int shift = 56; shift >= 0; shift -= 8) {
    for (int d = tid; d < 256; d += T) shist[d] = 0u;
    __syncthreads();
    for (int i = tid; i < L; i += T) {
      const unsigned long long key = key_of(i);
      if ((key & mask) == prefix) atomicAdd(&shist[(key >> shift) & 255u], 1u);
    }
    __syncthreads();
    if (tid < 32) {  // the digit at which the count from the top reaches need
      const int lane = tid;
      unsigned h[8], sum = 0u;
      for (int j = 0; j < 8; ++j) {
        h[j] = shist[255 - 8 * lane - j];
        sum += h[j];
      }
      unsigned incl = sum;
      for (int d = 1; d < 32; d <<= 1) {
        const unsigned o = __shfl_up_sync(kFull, incl, d);
        if (lane >= d) incl += o;
      }
      unsigned above = incl - sum;
      for (int j = 0; j < 8; ++j) {
        if (above < unsigned(need) && above + h[j] >= unsigned(need)) {
          s_digit = 255 - 8 * lane - j;
          s_need = need - int(above);
        }
        above += h[j];
      }
    }
    __syncthreads();
    prefix |= static_cast<unsigned long long>(s_digit) << shift;
    mask |= 255ull << shift;
    need = s_need;
  }
  // prefix is the K-th largest key: gather the K keys at or above it
  if (tid == 0) s_n = 0;
  __syncthreads();
  for (int i = tid; i < L; i += T) {
    const unsigned long long key = key_of(i);
    if (key >= prefix) stop[atomicAdd(&s_n, 1)] = key;
  }
  int m = 1;
  while (m < K) m <<= 1;
  for (int r = K + tid; r < m; r += T) stop[r] = 0ull;
  __syncthreads();
  for (int k = 2; k <= m; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int a = tid; a < m; a += T) {
        const int b = a ^ j;
        if (b > a) {
          const unsigned long long x = stop[a], y = stop[b];
          if (((a & k) == 0) ? x < y : x > y) {
            stop[a] = y;
            stop[b] = x;
          }
        }
      }
      __syncthreads();
    }
  }
  for (int i = tid; i < L + 2; i += T) out.leaf2k[i] = K;
  for (int r = tid; r < K; r += T) {
    const int leaf = key_leaf(stop[r]);
    const Leaf lf = load_leaf(leaf_best, start, count, leaf);
    const bool ok = lf.gain > 0.f && !done;
    put_range(out, rs, r, leaf, lf, ok ? load_feature(tb, int(lf.feature)) : Feature(), ok);
  }
  __syncthreads();  // leaf2k's fill lands before the valid ranges' entries
  for (int r = tid; r < K; r += T) {
    if (rs.flags[r] & 1) out.leaf2k[key_leaf(stop[r]) + 1] = r;
  }
  put_lut(out, rs, K);
}

// kLoop: the tree loop's condition in the epilogue (`TreeLoop`). Only
// lgbt_tree_graph's clone of wave1 launches <true>; every capture and eager
// launch runs <false>, which never touches `loop` and carries no device-side
// runtime call.
template <bool kLoop>
__global__ void __launch_bounds__(kReplayThreads)
wave_replay_kernel(float* __restrict__ leaf_best, int* __restrict__ depth,
                   float* __restrict__ rec_store, int* __restrict__ start,
                   int* __restrict__ count, long long* __restrict__ scalars,
                   const int* __restrict__ table, const int* __restrict__ n_left,
                   const float* __restrict__ recs2, const float* __restrict__ totals2, int ch,
                   const float* __restrict__ params, int max_depth, int n_leaves, int K,
                   long long* __restrict__ commit, TreeLoop loop) {
  // the chain's entries: [0, K) the valid selected ranges' leaves, [K, 2K)
  // the leaves n_cur + c that are not, 2K the largest key of the others
  __shared__ unsigned ehi[2 * kMaxK + 1], elo[2 * kMaxK + 1];
  __shared__ unsigned schild[2 * kMaxK];      // the children's guarded gain keys
  __shared__ unsigned char sguard[2 * kMaxK];  // 1 where a child may split
  __shared__ int ssel[kMaxK], sdepth[kMaxK];  // each range's leaf, its depth before the wave
  __shared__ float spout[kMaxK];              // each range's parent output
  __shared__ short scommit[kMaxK];            // each range's commit, -1 for none
  __shared__ short spos[kMaxK];               // each commit's range
  __shared__ short sright[kMaxK];             // each commit's right child's entry, -1 for none
  __shared__ unsigned long long s_other, s_rows;
  __shared__ long long s_passes;  // the tree loop's pass count, read up front
  __shared__ int s_commits;
  __shared__ unsigned s_top;
  const int L = n_leaves, tid = threadIdx.x, T = blockDim.x;
  const int* leaf2k = table;
  const int* s_k = table + L + 2 + K;
  const int* c_k = s_k + K;
  const int* ok_k = c_k + K;
  const int* sel = ok_k + K;
  const float l1 = params[0], l2 = params[1], min_data = params[2], min_hess = params[3],
              max_delta = params[5];
  const long long n0 = scalars[kNCur], t0 = scalars[kT];
  const bool done_in = scalars[kDone] != 0;
  if (tid == 0) {
    s_other = 0ull;
    s_rows = 0ull;
    if constexpr (kLoop) s_passes = *loop.passes;
  }
  // each thread's first (range, field) items: both children's field and
  // the selected leaf's, read before the epilogue writes any record
  float pre_l[kPrefetch], pre_r[kPrefetch], pre_b[kPrefetch];
#pragma unroll
  for (int s = 0; s < kPrefetch; ++s) {
    const int idx = tid + s * T;
    if (idx < K * kRec) {
      const int k = idx / kRec, f = idx - k * kRec;
      pre_l[s] = recs2[2LL * k * kRec + f];
      pre_r[s] = recs2[(2LL * k + 1) * kRec + f];
      pre_b[s] = leaf_best[(long long)sel[k] * kRec + f];
    }
  }
  unsigned long long rows = 0ull;
  for (int k = tid; k < K; k += T) {
    const int leaf = sel[k], d = depth[leaf];
    const bool ok = ok_k[k] != 0;
    ssel[k] = leaf;
    sdepth[k] = d;
    scommit[k] = -1;
    const long long l = 2LL * k * ch, r = l + ch;
    spout[k] = parent_output(totals2[l] + totals2[r], totals2[l + 1] + totals2[r + 1], l1, l2,
                             max_delta);
    for (int side = 0; side < 2; ++side) {  // the guard, at the parent's depth + 1
      const int j = 2 * k + side;
      const float* tot = totals2 + (long long)j * ch;
      bool may = tot[2] >= 2.f * min_data && tot[1] >= 2.f * min_hess;
      if (max_depth > 0) may = may && d + 1 < max_depth;
      sguard[j] = may ? 1 : 0;
      schild[j] = gain_key(may ? recs2[(long long)j * kRec] : -INFINITY);
    }
    ehi[k] = ok ? gain_key(leaf_best[(long long)leaf * kRec]) : 0u;
    elo[k] = ok ? entry_low(leaf, unsigned(k)) : 0u;
    if (ok) {
      const long long nl = n_left[k], nr = (long long)c_k[k] - nl;
      rows += (unsigned long long)(nl < nr ? nl : nr);
    }
  }
  for (int c = tid; c < K; c += T) {  // the leaves this wave may create
    const long long leaf = n0 + c;
    int right = -1;
    unsigned hi = 0u, lo = 0u;
    if (leaf >= 0 && leaf < L) {
      const int w = leaf2k[leaf + 1];
      if (w < K) {
        right = w;  // a valid selection: its range's entry stands for it
      } else {
        right = K + c;
        hi = gain_key(leaf_best[leaf * kRec]);
        lo = entry_low(int(leaf), kStop);
      }
    }
    sright[c] = short(right);
    ehi[K + c] = hi;
    elo[K + c] = lo;
  }
  unsigned long long other = 0ull;  // the largest key of the leaves no entry stands for
  for (int i = tid; i < L; i += T) {
    if (leaf2k[i + 1] < K || (i >= n0 && i < n0 + K)) continue;
    other = umax64(other, (static_cast<unsigned long long>(
                               gain_key(leaf_best[(long long)i * kRec])) << 32)
                              | entry_low(i, kStop));
  }
  for (int d = 16; d > 0; d >>= 1) {
    other = umax64(other, __shfl_xor_sync(kFull, other, d));
    rows += __shfl_xor_sync(kFull, rows, d);
  }
  __syncthreads();  // s_other and s_rows zeroed
  if ((tid & 31) == 0) {
    atomicMax(&s_other, other);
    atomicAdd(&s_rows, rows);
  }
  __syncthreads();

  if (tid < 32) {  // the replay: one warp, shared memory only
    const int lane = tid, E = 2 * K + 1;
    if (lane == 0) {
      ehi[2 * K] = unsigned(s_other >> 32);
      elo[2 * K] = unsigned(s_other);
    }
    __syncwarp();
    unsigned bh = 0u, bl = 0u;  // the lane's largest entry
    auto rescan = [&]() {
      bh = 0u;
      bl = 0u;
      for (int e = lane; e < E; e += 32) {
        const unsigned h = ehi[e], l = elo[e];
        if (h > bh || (h == bh && l > bl)) {
          bh = h;
          bl = l;
        }
      }
    };
    rescan();
    int c = 0;
    unsigned top;
    while (true) {
      const unsigned mh = __reduce_max_sync(kFull, bh);
      const unsigned ml = __reduce_max_sync(kFull, bh == mh ? bl : 0u);
      top = mh;
      const unsigned pos = ml & kStop;
      // an uncommitted valid range, a positive gain, the leaf budget
      if (!(positive_key(mh) && pos < unsigned(K) && t0 + c < L - 1)) break;
      const int right = sright[c];
      if (lane == 0) {
        spos[c] = short(pos);
        scommit[pos] = short(c);
      }
      bool moved = false;
      if (lane == int(pos & 31u)) {  // the range's leaf keeps the left child
        ehi[pos] = schild[2 * pos];
        elo[pos] |= kStop;
        moved = true;
      }
      if (right >= 0 && lane == (right & 31)) {  // leaf n_cur takes the right
        ehi[right] = schild[2 * pos + 1];
        moved = true;
      }
      if (moved) rescan();
      ++c;
    }
    if (lane == 0) {
      s_commits = c;
      s_top = top;
    }
  }
  __syncthreads();

  const int nc = s_commits;
  // commit c's parent leaf before commit c: the right child of commit c' < c
  // when c' created it (returns -1 otherwise)
  auto created_by = [&](int leaf, int c) {
    const long long cp = leaf - n0;
    return (cp >= 0 && cp < c) ? int(cp) : -1;
  };
  auto child_field = [&](int j, int f) {
    return f == 0 ? (sguard[j] ? recs2[(long long)j * kRec] : -INFINITY)
                  : recs2[(long long)j * kRec + f];
  };
  // the split log's parent records: commit c's leaf as it was before c
  auto log_parent = [&](int idx, bool fetched, float vb) {
    const int k = idx / kRec, f = idx - k * kRec, c = scommit[k];
    if (c < 0) return;
    const int leaf = ssel[k], cp = created_by(leaf, c);
    const float v = cp >= 0 ? child_field(2 * spos[cp] + 1, f)
                            : (fetched ? vb : leaf_best[(long long)leaf * kRec + f]);
    rec_store[(t0 + c) * kStore + 4 + f] = v;
  };
#pragma unroll
  for (int s = 0; s < kPrefetch; ++s) {
    if (tid + s * T < K * kRec) log_parent(tid + s * T, true, pre_b[s]);
  }
  for (int idx = tid + kPrefetch * T; idx < K * kRec; idx += T) log_parent(idx, false, 0.f);
  __syncthreads();  // every parent record read before a record is written

  // leaf b's left write is superseded when a later commit's right child is
  // b; leaf n_cur + c's right write when a later commit's parent is it
  auto left_last = [&](int leaf, int c) {
    const long long cp = leaf - n0;
    return !(cp > c && cp < nc);
  };
  auto right_last = [&](int c) {
    const int w = sright[c];
    return !(w >= 0 && w < K && scommit[w] > c);
  };
  auto write_children = [&](int idx, bool fetched, float vl, float vr) {
    const int k = idx / kRec, f = idx - k * kRec, c = scommit[k];
    if (c < 0) return;
    const int leaf = ssel[k];
    const long long nw = n0 + c;
    if (left_last(leaf, c)) {
      leaf_best[(long long)leaf * kRec + f] =
          f == 0 ? (sguard[2 * k] ? (fetched ? vl : recs2[2LL * k * kRec]) : -INFINITY)
                 : (fetched ? vl : recs2[2LL * k * kRec + f]);
    }
    if (right_last(c) && nw <= L) {
      leaf_best[nw * kRec + f] =
          f == 0 ? (sguard[2 * k + 1] ? (fetched ? vr : recs2[(2LL * k + 1) * kRec]) : -INFINITY)
                 : (fetched ? vr : recs2[(2LL * k + 1) * kRec + f]);
    }
  };
#pragma unroll
  for (int s = 0; s < kPrefetch; ++s) {
    if (tid + s * T < K * kRec) write_children(tid + s * T, true, pre_l[s], pre_r[s]);
  }
  for (int idx = tid + kPrefetch * T; idx < K * kRec; idx += T) {
    write_children(idx, false, 0.f, 0.f);
  }

  long long* wb = commit;
  long long* wn = commit + K;
  long long* mid = commit + 2 * K;
  long long* end = commit + 3 * K;
  long long* nid = commit + 4 * K;
  for (int k = tid; k < K; k += T) {
    const int c = scommit[k];
    if (c < 0) {
      wb[k] = L;
      wn[k] = L;
      mid[k] = 0;
      end[k] = 0;
      nid[k] = 0;
      continue;
    }
    const int leaf = ssel[k];
    const long long nw = n0 + c, t = t0 + c;
    int nd = 1, x = c;  // the new depth: one below the parent's when it split
    for (int cp = created_by(ssel[spos[x]], x); cp >= 0; cp = created_by(ssel[spos[x]], x)) {
      ++nd;
      x = cp;
    }
    nd += sdepth[spos[x]];
    float* row = rec_store + t * kStore;
    row[0] = float(leaf);
    row[1] = spout[k];
    row[2] = float(nd);
    row[3] = 1.f;
    if (left_last(leaf, c)) depth[leaf] = nd;
    const long long s = s_k[k], cnt = c_k[k], nl = n_left[k];
    wb[k] = leaf;
    wn[k] = nw;
    mid[k] = s + nl;
    end[k] = s + cnt;
    nid[k] = nw;
    count[leaf] = int(nl);
    if (nw <= L) {
      if (right_last(c)) depth[nw] = nd;
      start[nw] = int(s + nl);
      // a committed range's leaf keeps its left count (the plain version
      // writes the left counts last)
      const int w = sright[c];
      if (!(w >= 0 && w < K && scommit[w] >= 0)) count[nw] = int(cnt - nl);
    }
  }
  if (tid == 0) {
    const long long t = t0 + nc;
    scalars[kNCur] = n0 + nc;
    scalars[kT] = t;
    scalars[kHistRows] += (long long)s_rows;
    scalars[kNWaves] += done_in ? 0 : 1;
    const bool done = done_in || !(t < L - 1 && positive_key(s_top));
    scalars[kDone] = done ? 1 : 0;
    if constexpr (kLoop) {  // a tree graph's second wave: the pass counted, the loop's condition
      const long long n = s_passes + 1;
      *loop.passes = n;
      cudaGraphSetConditional(loop.handle, (!done && n <= loop.max_passes) ? 1u : 0u);
    }
  }
}

__global__ void tree_loop_cond_kernel(cudaGraphConditionalHandle handle,
                                      const long long* __restrict__ scalars) {
  cudaGraphSetConditional(handle, scalars[kDone] == 0 ? 1u : 0u);
}

cudaError_t add_cond_node(cudaGraphNode_t* node, cudaGraph_t graph, const cudaGraphNode_t* dep,
                          cudaGraphConditionalHandle handle, const long long* scalars) {
  void* args[] = {&handle, &scalars};
  cudaKernelNodeParams p = {};
  p.func = reinterpret_cast<void*>(tree_loop_cond_kernel);
  p.gridDim = dim3(1);
  p.blockDim = dim3(1);
  p.kernelParams = args;
  return cudaGraphAddKernelNode(node, graph, dep, dep ? 1 : 0, &p);
}

// A kernel node's argument values, copied out of the node (which owns the
// values its kernelParams point to) so that one can be changed and all set
// back: A... the kernel's parameter types.
template <typename... A>
struct ArgCopy {
  std::tuple<A...> value;
  void* ptr[sizeof...(A)];
  explicit ArgCopy(void* const* src) { load(src, std::index_sequence_for<A...>{}); }
  template <size_t... I>
  void load(void* const* src, std::index_sequence<I...>) {
    ((std::memcpy(&std::get<I>(value), src[I], sizeof(A)), ptr[I] = &std::get<I>(value)), ...);
  }
};
template <typename F>
struct ArgsOf;
template <typename... A>
struct ArgsOf<void (*)(A...)> {
  using type = ArgCopy<A...>;
};
using ReplayArgs = ArgsOf<decltype(&wave_replay_kernel<false>)>::type;
constexpr size_t kLoopArg = std::tuple_size<decltype(ReplayArgs::value)>::value - 1;

// Switch the tree loop's condition on in the replay kernel of `wave` (a
// child graph node's own graph, not the capture it was cloned from): the
// one kernel node there that launches wave_replay_kernel<false> launches
// wave_replay_kernel<true> instead, with `loop` as its last argument. Nodes
// the runtime cannot name (kernels of another module's runtime) are not it.
// Returns an error left pending by an earlier call on this thread, else
// cudaErrorSymbolNotFound when the wave has no replay node and
// cudaErrorInvalidValue when it has two.
cudaError_t patch_replay(cudaGraph_t wave, TreeLoop loop) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  size_t n = 0;
  if ((err = cudaGraphGetNodes(wave, nullptr, &n)) != cudaSuccess) return err;
  if (err != cudaSuccess) return err;
  std::vector<cudaGraphNode_t> nodes(n);
  if (n > 0 && (err = cudaGraphGetNodes(wave, nodes.data(), &n)) != cudaSuccess) return err;
  cudaGraphNode_t found = nullptr;
  cudaKernelNodeParams p = {};
  for (cudaGraphNode_t node : nodes) {
    cudaGraphNodeType type;
    if ((err = cudaGraphNodeGetType(node, &type)) != cudaSuccess) return err;
    if (type != cudaGraphNodeTypeKernel) continue;
    cudaKernelNodeParams q = {};
    if (cudaGraphKernelNodeGetParams(node, &q) != cudaSuccess) {
      cudaGetLastError();  // this walk's own error: a later launch's check must not see it
      continue;
    }
    if (q.func != reinterpret_cast<void*>(wave_replay_kernel<false>)) continue;
    if (found != nullptr) return cudaErrorInvalidValue;
    found = node;
    p = q;
  }
  if (found == nullptr) return cudaErrorSymbolNotFound;
  if (p.kernelParams == nullptr) return cudaErrorInvalidValue;
  ReplayArgs args(p.kernelParams);
  std::get<kLoopArg>(args.value) = loop;
  p.func = reinterpret_cast<void*>(wave_replay_kernel<true>);
  p.kernelParams = args.ptr;
  p.extra = nullptr;
  return cudaGraphKernelNodeSetParams(found, &p);
}

}  // namespace

extern "C" {

// One tree as one executable graph: root (cudaGraph_t), then while the done
// word scalars[4] is 0 and the passes are at most max_passes (>= 1), wave0
// then wave1 (cudaGraph_t each, wave1 holding one wave_replay_kernel node;
// cloned, so the caller keeps and frees them). passes [1] int64 counts the
// body's passes, in wave1's replay; the root must zero it. Returns the
// cudaGraphExec_t through exec_out and a cudaError_t: any failure to build
// the graph or to find and patch wave1's replay node.
int lgbt_tree_graph(void* root, void* wave0, void* wave1, const long long* scalars,
                    long long* passes, long long max_passes, void** exec_out) {
  if (max_passes < 1) return int(cudaErrorInvalidValue);
  cudaGraph_t graph = nullptr;
  cudaGraphExec_t exec = nullptr;
  cudaGraphNode_t n_root, n_cond, n_while, n_w0, n_w1;
  cudaGraphConditionalHandle handle;
  cudaGraphNodeParams wp = {};
  cudaGraph_t body = nullptr, w1 = nullptr;
  cudaError_t err = cudaGraphCreate(&graph, 0);
  if (err != cudaSuccess) return int(err);
#define TRY(call)                       \
  do {                                  \
    err = (call);                       \
    if (err != cudaSuccess) goto done;  \
  } while (0)
  TRY(cudaGraphAddChildGraphNode(&n_root, graph, nullptr, 0, static_cast<cudaGraph_t>(root)));
  TRY(cudaGraphConditionalHandleCreate(&handle, graph, 0, cudaGraphCondAssignDefault));
  TRY(add_cond_node(&n_cond, graph, &n_root, handle, scalars));
  wp.type = cudaGraphNodeTypeConditional;
  wp.conditional.handle = handle;
  wp.conditional.type = cudaGraphCondTypeWhile;
  wp.conditional.size = 1;
#if CUDART_VERSION >= 13000
  TRY(cudaGraphAddNode(&n_while, graph, &n_cond, nullptr, 1, &wp));
#else
  TRY(cudaGraphAddNode(&n_while, graph, &n_cond, 1, &wp));
#endif
  body = wp.conditional.phGraph_out[0];
  TRY(cudaGraphAddChildGraphNode(&n_w0, body, nullptr, 0, static_cast<cudaGraph_t>(wave0)));
  TRY(cudaGraphAddChildGraphNode(&n_w1, body, &n_w0, 1, static_cast<cudaGraph_t>(wave1)));
  TRY(cudaGraphChildGraphNodeGetGraph(n_w1, &w1));
  TRY(patch_replay(w1, TreeLoop{handle, passes, max_passes}));
  TRY(cudaGraphInstantiate(&exec, graph, 0));
  *exec_out = exec;
#undef TRY
done:
  cudaGraphDestroy(graph);
  return int(err);
}

int lgbt_tree_graph_launch(void* exec, void* stream) {
  return int(cudaGraphLaunch(static_cast<cudaGraphExec_t>(exec),
                             static_cast<cudaStream_t>(stream)));
}

int lgbt_tree_graph_destroy(void* exec) {
  return int(cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec)));
}


// leaf_best [L+1, 14] f32, start / count [L+1] int32, scalars [5] int64;
// the feature tables [F] (int32, is_efb bytes) -> table [L + 2 + 5K + 256K]
// int32 (leaf2k, rgroup, starts, counts, valid, sel, lut). Up to 1,024
// leaves one block of the power of two >= L threads sorts them; above, the
// radix select's block. Returns cudaGetLastError() after the launch.
int lgbt_wave_select(const float* leaf_best, int n_leaves, const int* start, const int* count,
                     const long long* scalars, const int* group, const int* lo, const int* hi,
                     const int* default_bin, const int* nbins, const int* missing_type,
                     const uint8_t* is_efb, int k, int* table, void* stream) {
  if (n_leaves < 1 || n_leaves >= (1 << kLeafBits) || k < 1 || k > kMaxK || k > n_leaves) {
    return int(cudaErrorInvalidValue);
  }
  const Tables tb{group, lo, hi, default_bin, nbins, missing_type, is_efb};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_leaves <= kSortLeaves) {
    int threads = 32;
    while (threads < n_leaves) threads <<= 1;
    wave_select_kernel<<<1, threads, 0, s>>>(leaf_best, n_leaves, start, count, scalars, tb, k,
                                             table);
  } else {
    wave_select_large_kernel<<<1, kLargeThreads, 0, s>>>(leaf_best, n_leaves, start, count,
                                                         scalars, tb, k, table);
  }
  return int(cudaGetLastError());
}

// In place on leaf_best, depth, rec_store [*, 18] f32, start, count, scalars;
// table from lgbt_wave_select, n_left [K] int32, recs2 [2K, 14] and totals2
// [2K, ch] f32, params [6] f32 -> commit [5, K] int64 (wb, wn, mid, end,
// new id).
int lgbt_wave_replay(float* leaf_best, int* depth, float* rec_store, int* start, int* count,
                     long long* scalars, const int* table, const int* n_left,
                     const float* recs2, const float* totals2, int ch, const float* params,
                     int max_depth, int n_leaves, int k, long long* commit, void* stream) {
  if (n_leaves < 1 || n_leaves >= (1 << kLeafBits) || k < 1 || k > kMaxK || k > n_leaves
      || ch < 3) {
    return int(cudaErrorInvalidValue);
  }
  wave_replay_kernel<false><<<1, kReplayThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      leaf_best, depth, rec_store, start, count, scalars, table, n_left, recs2, totals2, ch,
      params, max_depth, n_leaves, k, commit, TreeLoop{});
  return int(cudaGetLastError());
}

}  // extern "C"
