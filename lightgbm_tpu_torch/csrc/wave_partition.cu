// The wave partition for Hopper (sm_90a): the port of the TPU kernel
// lightgbm_tpu/ops/compact_pallas.py:compact_rows (Pallas call
// _pallas_compact_call) together with the per-row work around it in a wave
// of the JAX grower (lightgbm_tpu/treelearner/device.py:603-646: the
// per-row split fields, _decide_go_left, range_partition_dst) and the
// smaller child's slot vector the ragged histogram reads (:662-666). The
// wave learner (treelearner/device.py) calls it once a wave and once for the
// bagged initial partition of a tree; the relabel kernel applies a wave's
// commit to the leaf-id column (:818-826).
//
// What it computes. The learner keeps its rows leaf-contiguous: a bin plane
// bins [G, N] uint8 and a payload rows [N, rc] float32 whose column
// leaf_col holds each row's leaf id. A wave splits K disjoint position
// ranges [starts[k], starts[k] + counts[k]) at once. A row belongs to range
// k = leaf2k[leaf + 1] (k >= K: to none), goes left when
// lut[k * 256 + bins[rgroup[k], n]] != 0 (the [K, 256] decision table of the
// range's split over every group bin), and lands stably: left rows of range
// k at starts[k] + (left rows of k before it), right rows after the
// range's n_left[k] left rows; a row of no range stays where it is. The
// bagged form has one range [0, N) and sends a row left when its leaf id is
// 0 (in the bag). Outputs, out of place: the moved plane and payload
// (bit-exact), slot [N] (k where the row lands in range k's smaller child,
// tie to the left, else K), and per range n_left, the smaller child's
// [start, end), whether that child is histogrammed (range valid, rows > 0)
// and whether it is the left one. It is the one stable 2-way partition, so
// everything equals the plain version (ops/compact.py:_partition_wave_plain)
// exactly.
//
// Design: LightGBM's CUDADataPartition::SplitInner (a bit vector and a
// prefix-scan compaction) for K ranges in tiles of kTile rows, three
// launches:
//   1. decide: a warp takes 32 rows, writes their go-left bits as one ballot
//      word, and adds each range's left rows to the tile's count (one shared
//      atomic per range a warp holds, through __match_any_sync);
//   2. scan: one block turns the [tiles, K] counts into each tile's count of
//      left rows of range k before it, in place (a warp a range, over only
//      the tiles the range covers), and writes n_left and the smaller child;
//   3. scatter: a tile ranks its rows stably from the popcounts of its ballot
//      words: all rows of a range between two positions belong to it, so the
//      left rows before a row are the tile's offset plus a difference of two
//      prefix counts, and the right rows the rest. Each row's destination
//      stays in shared memory in destination order (a tile's rows of one
//      range land in two runs), and the payload words and the group bytes
//      are written run by run, consecutive threads on consecutive addresses
//      (tiles of 1,024 rows: 1,024 blocks at N = 2^20, all resident at once,
//      so enough loads are in flight to cover the latency).
// The relabel kernel writes new leaf ids over committed ranges' right rows,
// [start + n_left, end), from a K-entry table that stays on the card (the
// wave's replay writes it; an uncommitted range is empty): every block
// takes the exclusive prefix of the ranges' lengths and a grid-stride loop
// over their sum finds each position's range by binary search.
//
// What bounds it. Bytes: the decide pass reads the leaf id (its 4 bytes
// touch the whole 4 * rc-byte payload row's sectors) and one bin byte, and
// writes a bit, a row; the scatter reads and writes G + 4 * rc bytes and
// writes the 4-byte slot. At HIGGS width (G = 28, rc = 5, N = 1,048,576):
// 21 + 2 * 48 + 4 = ~121 bytes a row, ~127 MB, ~38 us at 3.35 TB/s.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 1024;           // rows a tile (a multiple of 32)
constexpr int kThreads = 256;         // threads of a decide or scatter block
constexpr int kRowsPerThread = kTile / kThreads;
constexpr int kScanThreads = 1024;    // the scan's one block
constexpr int kMaxRanges = 1024;
constexpr int kGroupBins = 256;       // every value a uint8 group bin takes
constexpr unsigned kFull = 0xffffffffu;

// the range of a row with leaf id `leaf` (K: none). The float is
// range-checked before it becomes an index (int(leaf) + 1 in [0, n_leaf2k),
// as the plain version's int64 cast gives it; a NaN or a value past int32
// names no range), so no payload value can address outside leaf2k.
__device__ __forceinline__ int range_of(float leaf, const int* leaf2k, int n_leaf2k, int K,
                                        int bagged) {
  if (bagged) return 0;
  if (!(leaf > -2.f && leaf < float(n_leaf2k - 1))) return K;
  const int k = leaf2k[int(leaf) + 1];
  return (k >= 0 && k < K) ? k : K;
}

// the bagged partition's side: the row is in the bag (leaf id 0)
__device__ __forceinline__ bool in_bag(float leaf) { return leaf > -1.f && leaf < 1.f; }

__global__ void __launch_bounds__(kThreads)
decide_kernel(const uint8_t* __restrict__ bins, const float* __restrict__ rows, long long n,
              int rc, int leaf_col, const int* __restrict__ leaf2k, int n_leaf2k,
              const int* __restrict__ rgroup, const int* __restrict__ lut, int K, int bagged,
              uint32_t* __restrict__ bits, int* __restrict__ tile_cnt) {
  __shared__ int cnt[kMaxRanges];
  const long long ts = (long long)blockIdx.x * kTile;
  const long long te = ts + kTile < n ? ts + kTile : n;
  for (int k = threadIdx.x; k < K; k += blockDim.x) cnt[k] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
  for (long long base = ts + warp * 32; base < te; base += n_warps * 32) {
    const long long i = base + lane;
    int k = K;
    bool left = false;
    if (i < te) {
      const float leaf = rows[i * rc + leaf_col];
      k = range_of(leaf, leaf2k, n_leaf2k, K, bagged);
      if (k < K) {
        if (bagged) {
          left = in_bag(leaf);
        } else {
          const int gb = bins[(long long)rgroup[k] * n + i];
          left = lut[k * kGroupBins + gb] != 0;
        }
      }
    }
    const unsigned word = __ballot_sync(kFull, left);
    if (lane == 0) bits[base >> 5] = word;
    const unsigned peers = __match_any_sync(kFull, k);
    if (k < K && lane == __ffs(peers) - 1) {
      const int c = __popc(peers & word);
      if (c) atomicAdd(&cnt[k], c);
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    tile_cnt[(long long)blockIdx.x * K + k] = cnt[k];
  }
}

__global__ void __launch_bounds__(kScanThreads)
scan_kernel(int* __restrict__ tile_cnt, int K, const int* __restrict__ starts,
            const int* __restrict__ counts, const int* __restrict__ valid,
            int* __restrict__ ranges, uint8_t* __restrict__ flags) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
  for (int k = warp; k < K; k += n_warps) {
    const int s = starts[k], c = counts[k];
    const bool ok = valid[k] != 0;
    int total = 0;
    if (ok && c > 0) {
      const int t0 = s / kTile, t1 = (s + c - 1) / kTile;
      for (int base = t0; base <= t1; base += 32) {
        const int t = base + lane;
        const long long at = (long long)t * K + k;
        const int v = t <= t1 ? tile_cnt[at] : 0;
        int x = v;
        for (int d = 1; d < 32; d <<= 1) {
          const int y = __shfl_up_sync(kFull, x, d);
          if (lane >= d) x += y;
        }
        if (t <= t1) tile_cnt[at] = total + x - v;  // left rows of k before tile t
        total += __shfl_sync(kFull, x, 31);
      }
    }
    if (lane == 0) {
      const int nl = ok ? total : 0, nr = c - nl;
      const bool left_small = nl <= nr;
      const int sc = left_small ? nl : nr;
      const int ss = left_small ? s : s + nl;
      ranges[k] = nl;
      ranges[K + k] = ss;
      ranges[2 * K + k] = ss + sc;
      flags[k] = ok && sc > 0;
      flags[K + k] = left_small;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
scatter_kernel(const uint8_t* __restrict__ bins, const uint32_t* __restrict__ rows, long long n,
               int g, int rc, int leaf_col, const int* __restrict__ leaf2k, int n_leaf2k,
               int K, int bagged, const uint32_t* __restrict__ bits,
               const int* __restrict__ tile_off, const int* __restrict__ starts,
               const int* __restrict__ counts, const int* __restrict__ ranges,
               uint8_t* __restrict__ bins_out, uint32_t* __restrict__ rows_out,
               int* __restrict__ slot_out) {
  __shared__ uint32_t words[kTile / 32];
  __shared__ int word_pre[kTile / 32 + 1];
  __shared__ int sdst[kTile];          // destination of staging entry r
  __shared__ short ssrc[kTile];        // its row, as an offset in the tile
  const long long ts = (long long)blockIdx.x * kTile;
  const long long te = ts + kTile < n ? ts + kTile : n;
  const int n_rows = int(te - ts), n_words = (n_rows + 31) / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int w = threadIdx.x; w < n_words; w += blockDim.x) words[w] = bits[(ts >> 5) + w];
  __syncthreads();
  if (warp == 0) {  // exclusive prefix of the words' popcounts
    int carry = 0;
    for (int base = 0; base < n_words; base += 32) {
      const int w = base + lane;
      const int v = w < n_words ? __popc(words[w]) : 0;
      int x = v;
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(kFull, x, d);
        if (lane >= d) x += y;
      }
      if (w < n_words) word_pre[w] = carry + x - v;
      carry += __shfl_sync(kFull, x, 31);
    }
    if (lane == 0) word_pre[n_words] = carry;
  }
  __syncthreads();
  // left rows in [ts, ts + o), for o in [0, n_rows]
  auto left_before = [&](int o) {
    const int w = o >> 5, b = o & 31;
    return b == 0 ? word_pre[w] : word_pre[w] + __popc(words[w] & ((1u << b) - 1u));
  };

  for (int o = threadIdx.x; o < n_rows; o += blockDim.x) {
    const long long i = ts + o;
    const int k = range_of(__uint_as_float(rows[i * rc + leaf_col]), leaf2k, n_leaf2k, K,
                           bagged);
    long long dst = i;
    int sidx = o, slot = K;
    if (k < K) {
      const long long s = starts[k], e = s + counts[k];
      const int a = int((s > ts ? s : ts) - ts), b = int((e < te ? e : te) - ts);
      const int pa = left_before(a), pn = left_before(o), pb = left_before(b);
      const bool left = (words[o >> 5] >> (o & 31)) & 1u;
      const long long lr = tile_off[(long long)blockIdx.x * K + k] + (pn - pa);
      dst = left ? s + lr : s + ranges[k] + (i - s) - lr;
      sidx = a + (left ? pn - pa : (pb - pa) + (o - a) - (pn - pa));
      if (dst >= ranges[K + k] && dst < ranges[2 * K + k]) slot = k;
    }
    sdst[sidx] = int(dst);
    ssrc[sidx] = short(o);
    if (slot_out != nullptr) slot_out[dst] = slot;
  }
  __syncthreads();

  // the payload, word by word in destination order
  for (int w = threadIdx.x; w < n_rows * rc; w += blockDim.x) {
    const int r = w / rc, c = w - r * rc;
    rows_out[(long long)sdst[r] * rc + c] = rows[(ts + ssrc[r]) * rc + c];
  }
  // the bin plane, a group at a time, byte by byte in destination order;
  // each thread keeps its staging entries' rows in registers
  int dst_r[kRowsPerThread], src_r[kRowsPerThread];
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) {
    const int r = threadIdx.x + j * kThreads;
    dst_r[j] = r < n_rows ? sdst[r] : -1;
    src_r[j] = r < n_rows ? ssrc[r] : 0;
  }
  for (int gi = 0; gi < g; ++gi) {
    const uint8_t* src = bins + (long long)gi * n + ts;
    uint8_t* out = bins_out + (long long)gi * n;
    uint8_t v[kRowsPerThread];
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) v[j] = dst_r[j] >= 0 ? src[src_r[j]] : 0;
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) {
      if (dst_r[j] >= 0) out[dst_r[j]] = v[j];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
relabel_kernel(uint32_t* __restrict__ rows, int rc, int leaf_col,
               const long long* __restrict__ table, int m) {
  __shared__ long long pre[kMaxRanges + 1];  // exclusive prefix of the ranges' lengths
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    long long carry = 0;
    for (int base = 0; base < m; base += 32) {
      const int j = base + lane;
      long long v = 0;
      if (j < m) {
        const long long len = table[m + j] - table[j];
        v = len > 0 ? len : 0;
      }
      long long x = v;
      for (int d = 1; d < 32; d <<= 1) {
        const long long y = __shfl_up_sync(kFull, x, d);
        if (lane >= d) x += y;
      }
      if (j < m) pre[j] = carry + x - v;
      carry += __shfl_sync(kFull, x, 31);
    }
    if (lane == 0) pre[m] = carry;
  }
  __syncthreads();
  const long long total = pre[m];
  for (long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x; q < total;
       q += (long long)gridDim.x * blockDim.x) {
    int lo = 0, hi = m;  // pre[lo] <= q < pre[hi]: range lo holds q
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (pre[mid] <= q) lo = mid; else hi = mid;
    }
    rows[(table[lo] + (q - pre[lo])) * rc + leaf_col] = __float_as_uint(float(table[2 * m + lo]));
  }
}

long long n_tiles(long long n) { return (n + kTile - 1) / kTile; }

}  // namespace

extern "C" {

// Pass 1. bins [G, N] uint8, rows [N, rc] f32, leaf2k [n_leaf2k] int32 (by
// leaf id + 1), rgroup [K] int32, lut [K, 256] int32 (both unread when
// bagged) -> bits [ceil(N / 32)] uint32, tile_cnt [tiles, K] int32.
int lgbt_partition_decide(const uint8_t* bins, const float* rows, long long n, int rc,
                          int leaf_col, const int* leaf2k, int n_leaf2k, const int* rgroup,
                          const int* lut, int k, int bagged, uint32_t* bits, int* tile_cnt,
                          void* stream) {
  if (n < 1 || n >= (1LL << 31) || k < 1 || k > kMaxRanges || rc < 1 || leaf_col < 0
      || leaf_col >= rc) {
    return int(cudaErrorInvalidValue);
  }
  decide_kernel<<<unsigned(n_tiles(n)), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      bins, rows, n, rc, leaf_col, leaf2k, n_leaf2k, rgroup, lut, k, bagged, bits, tile_cnt);
  return int(cudaGetLastError());
}

// Pass 2. tile_cnt in place -> per-tile offsets; starts/counts/valid [K]
// int32 -> ranges [3, K] int32 (n_left, smaller child's start, end), flags
// [2, K] bytes (child histogrammed, left is smaller).
int lgbt_partition_scan(int* tile_cnt, int k, const int* starts, const int* counts,
                        const int* valid, int* ranges, uint8_t* flags, void* stream) {
  if (k < 1 || k > kMaxRanges) return int(cudaErrorInvalidValue);
  scan_kernel<<<1, kScanThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      tile_cnt, k, starts, counts, valid, ranges, flags);
  return int(cudaGetLastError());
}

// Pass 3 -> bins_out [G, N], rows_out [N, rc], slot_out [N] int32 or NULL.
int lgbt_partition_scatter(const uint8_t* bins, const uint32_t* rows, long long n, int g,
                           int rc, int leaf_col, const int* leaf2k, int n_leaf2k, int k,
                           int bagged, const uint32_t* bits, const int* tile_off,
                           const int* starts, const int* counts, const int* ranges,
                           uint8_t* bins_out, uint32_t* rows_out, int* slot_out,
                           void* stream) {
  if (n < 1 || n >= (1LL << 31) || g < 0 || k < 1 || k > kMaxRanges || rc < 1
      || leaf_col < 0 || leaf_col >= rc) {
    return int(cudaErrorInvalidValue);
  }
  scatter_kernel<<<unsigned(n_tiles(n)), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      bins, rows, n, g, rc, leaf_col, leaf2k, n_leaf2k, k, bagged, bits, tile_off, starts,
      counts, ranges, bins_out, rows_out, slot_out);
  return int(cudaGetLastError());
}

// rows [n_rows, rc] f32: rows[p, leaf_col] = newid[j] for p in [mid[j],
// end[j]), table [3, m] int64 (mid, end, newid; an empty range relabels
// nothing). The grid follows n_rows, never the table, which stays on the
// card: every block scans the m lengths and takes its share of their sum.
int lgbt_relabel_rows(uint32_t* rows, long long n_rows, int rc, int leaf_col,
                      const long long* table, int m, void* stream) {
  if (m < 1 || m > kMaxRanges || rc < 1 || leaf_col < 0 || leaf_col >= rc || n_rows < 0) {
    return int(cudaErrorInvalidValue);
  }
  // a fixed share of n_rows (half of them, four a thread, at most 1024
  // blocks), since the ranges' total is on the card: the grid-stride loop
  // covers any total up to n_rows
  long long blocks = (n_rows / 2 + 4 * kThreads - 1) / (4 * kThreads);
  if (blocks < 1) blocks = 1;
  if (blocks > 1024) blocks = 1024;
  relabel_kernel<<<unsigned(blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      rows, rc, leaf_col, table, m);
  return int(cudaGetLastError());
}

}  // extern "C"
