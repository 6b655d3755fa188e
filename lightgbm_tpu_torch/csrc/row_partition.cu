// The serial learner's row partition for Hopper (sm_90a): a split of one
// leaf's padded row-index set into its children's. Not the port of a TPU
// kernel: the JAX package runs it in XLA (lightgbm_tpu/ops/partition.py:
// partition_rows, a stable argsort on a 3-way key, and RowPartition.split,
// the children's padded buffers); it is the glue around the leaf histogram
// (csrc/histogram.cu hist_rows_kernel), folded into one launch.
//
// What it computes. For the split group's bin row bins_row [N] uint8, the
// leaf's padded index set idx [P] int32 of which the first `count`
// positions are rows (the rest the sentinel N), and the split's go-left bit
// for each of the 256 group bin values (a table the host builds from the
// split's decision, ops/partition.py:go_left_table):
//   left  [P]: the rows p < count with table[bins_row[idx[p]]] set, in
//              position order, then N up to P;
//   right [P]: the other rows p < count in position order, then N;
//   n_left:    the number of left rows.
// It is one stable 2-way partition of integers, so everything equals the
// plain version (ops/partition.py:_split_rows_plain) exactly. The children
// take their buffers' first bucket_size(n) positions (RowPartition.split),
// so nothing runs on the card after the host reads n_left.
//
// Design: one pass, a stable partition with a decoupled look-back (Merrill
// and Garland, "Single-pass Parallel Prefix Scan with Decoupled
// Look-back", 2016; the scheme of CUB's DevicePartition), in tiles of kTile
// positions, a block a tile:
//   * the block loads its tile's indices once (kItems a thread, a warp's 32
//     consecutive positions a load), gathers their bins, looks the go-left
//     bits up in the table (shared memory, passed by value: no copy to the
//     card) and ballots: a warp holds its words in registers, and the
//     warps' counts give each warp its offset in the tile;
//   * tile t publishes its left count in its status word, then the whole
//     block reads the status words of the kThreads (256) tiles before it at
//     once, adding counts back to the nearest tile that has published its
//     inclusive prefix; it then publishes its own. A tile takes its index
//     from a ticket (an atomic add), so it only ever waits on tiles that are
//     already running, on any grid size. A leaf of one tile takes no ticket
//     and looks back at nothing;
//   * the tile adapts to the leaf: 1,024 positions (4 a thread) up to
//     262,144 positions, 4,096 (16 a thread) above. Small tiles give a
//     100,000- or 4,000-row leaf more blocks loading at once, while at the
//     root 1,024 small tiles lose more to the look-back and its waits (a
//     tile's scatter waits for every earlier tile's count) than 256 large
//     ones do (PERF.md row 5a);
//   * each row goes to its child at its rank; the padding needs no total:
//     below `count` the left child's padding is [n_left, count) and the
//     right child's [count - n_left, count), so a row of right rank j
//     writes left[count - 1 - j] = N and a row of left rank i writes
//     right[count - 1 - i] = N, which covers both ranges exactly. The
//     positions [count, P) are padded by the tiles that cover them, and the
//     tile holding position count - 1 writes n_left from its inclusive
//     prefix (tile 0 writes 0 for an empty leaf).
// The tile states need no memset and no launch of their own: they live in a
// buffer the wrapper keeps per device and stream (ops/partition_cuda.py),
// word 0 the ticket counter, then a 64-bit status word a tile tagged with
// the call's epoch (passed by value; the buffer is zeroed when it is
// allocated and when the epoch wraps), so the words a former call left are
// never read as this call's.
//
// What bounds it. Bytes: the index and a bin byte a row in (a 32-byte
// sector where the leaf's rows are sparse in the plane), both children out
// over all P positions, n_left: 5 * rows + 8 * P + 4 (perfmodel.py
// row_partition). At the root of 1,048,576 rows ~13.6 MB, ~4.1 us at
// 3.35 TB/s; a leaf of a few thousand rows is one launch's latency.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;                 // threads of a block
constexpr int kWarps = kThreads / 32;
// positions a thread: 4 (tiles of 1,024) up to kSmallPositions positions,
// 16 (tiles of 4,096) above, where more, smaller tiles lose more to the
// look-back than they gain in parallel loads (ops/partition_cuda.py:tile)
constexpr int kSmallItems = 4, kLargeItems = 16;
constexpr int kSmallPositions = 1 << 18;
constexpr unsigned kFull = 0xffffffffu;
// a status word: epoch << 33 | flag << 31 | left rows (< 2**31)
constexpr int kEpochShift = 33;
constexpr unsigned long long kCountOnly = 1ull << 31;  // the tile's own count
constexpr unsigned long long kPrefix = 2ull << 31;     // the inclusive prefix
constexpr unsigned long long kValue = (1ull << 31) - 1;

struct Table {
  uint32_t w[8];  // bit b % 32 of word b / 32: group bin b goes left
};

__device__ __forceinline__ unsigned long long load_relaxed(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_relaxed(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

template <int kItems>
__global__ void __launch_bounds__(kThreads)
row_partition_kernel(const uint8_t* __restrict__ bins_row, int n_rows,
                     const int* __restrict__ idx, int count, int n_pos, Table table,
                     unsigned long long* __restrict__ state, unsigned long long ticket0,
                     unsigned long long epoch, int* __restrict__ left,
                     int* __restrict__ right, int* __restrict__ n_left_out) {
  __shared__ uint32_t t[8];
  __shared__ int warp_count[kWarps], warp_stop[kWarps], warp_sum[kWarps];
  __shared__ int tile_sh;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x < 8) t[threadIdx.x] = table.w[threadIdx.x];
  if (threadIdx.x == 0) {
    tile_sh = gridDim.x == 1 ? 0 : static_cast<int>(atomicAdd(state, 1ull) - ticket0);
  }
  __syncthreads();
  const int tile = tile_sh;
  constexpr int kTile = kThreads * kItems;
  const int ts = tile * kTile;
  const int n = max(0, min(kTile, count - ts));  // rows of this tile
  // warp w holds positions [w * kItems * 32, (w + 1) * kItems * 32) of the
  // tile, 32 consecutive ones a load; its ballot words stay in registers
  const int base = warp * kItems * 32 + lane;
  int rows[kItems];
  uint32_t words[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int o = base + k * 32;
    rows[k] = o < n ? idx[ts + o] : n_rows;
  }
  int mine = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    bool go = false;
    if (base + k * 32 < n) {
      const int r = rows[k];
      const int b = bins_row[r < n_rows ? r : n_rows - 1];
      go = (t[b >> 5] >> (b & 31)) & 1u;
    }
    words[k] = __ballot_sync(kFull, go);
    mine += __popc(words[k]);
  }
  if (lane == 0) warp_count[warp] = mine;
  __syncthreads();
  int in_tile = 0, total = 0;  // left rows of the warps before this one, of the tile
  for (int w = 0; w < kWarps; ++w) {
    in_tile += w < warp ? warp_count[w] : 0;
    total += warp_count[w];
  }
  const unsigned long long tag = epoch << kEpochShift;
  int before = 0;  // left rows of the tiles before this one
  if (n > 0 && gridDim.x > 1) {
    if (threadIdx.x == 0) {
      store_relaxed(state + 1 + tile, tag | (tile == 0 ? kPrefix : kCountOnly) | unsigned(total));
    }
    if (tile > 0) {
      // look back: thread i reads tile j - i, a window of kThreads tiles at
      // once; a tile before 0 is a prefix of 0
      for (int j = tile - 1;; j -= kThreads) {
        const int q = j - static_cast<int>(threadIdx.x);
        unsigned long long s;
        do {
          s = q >= 0 ? load_relaxed(state + 1 + q) : (tag | kPrefix);
        } while (!__syncthreads_and((s >> kEpochShift) == epoch));
        // the nearest tile with its prefix: the least thread whose word has one
        const unsigned pre = __ballot_sync(kFull, (s & kPrefix) != 0);
        if (lane == 0) warp_stop[warp] = pre ? warp * 32 + __ffs(pre) - 1 : kThreads;
        __syncthreads();
        int stop = kThreads;
        for (int w = 0; w < kWarps; ++w) stop = min(stop, warp_stop[w]);
        int c = static_cast<int>(threadIdx.x) <= stop ? static_cast<int>(s & kValue) : 0;
        for (int d = 16; d > 0; d >>= 1) c += __shfl_xor_sync(kFull, c, d);
        if (lane == 0) warp_sum[warp] = c;
        __syncthreads();
        for (int w = 0; w < kWarps; ++w) before += warp_sum[w];
        __syncthreads();  // warp_stop and warp_sum are rewritten by the next window
        if (stop < kThreads) break;
      }
      if (threadIdx.x == 0) {
        store_relaxed(state + 1 + tile, tag | kPrefix | unsigned(before + total));
      }
    }
  }
  // the tile holding position count - 1 (tile 0 for an empty leaf)
  if (threadIdx.x == 0 && ((n > 0 && ts + n == count) || (count == 0 && tile == 0))) {
    *n_left_out = before + total;
  }
  int i = before + in_tile;  // the left rank of the warp's next left row
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int o = base + k * 32;
    if (o < n) {
      const uint32_t word = words[k];
      const int li = i + __popc(word & ((1u << lane) - 1u));  // this row's left rank
      const int rj = ts + o - li;                               // its right rank
      if ((word >> lane) & 1u) {
        left[li] = rows[k];
        right[count - 1 - li] = n_rows;
      } else {
        right[rj] = rows[k];
        left[count - 1 - rj] = n_rows;
      }
    }
    i += __popc(words[k]);
  }
  // the padding past `count` over this tile's positions
  for (int q = max(ts, count) + threadIdx.x; q < min(ts + kTile, n_pos); q += kThreads) {
    left[q] = n_rows;
    right[q] = n_rows;
  }
}

}  // namespace

extern "C" {

// bins_row [n_rows] uint8, idx [n_pos] int32 (the first `count` positions
// rows), table_host: 8 words on the host (bit b of the 256: group bin b goes
// left); state: the ticket word and at least ceil(n_pos / tile) status
// words, int64, whose ticket word has taken `ticket0` tickets and whose
// status words carry epochs below `epoch` (1 <= epoch < 2**31) -> left
// [n_pos], right [n_pos] int32, n_left [1] int32. ceil(n_pos / tile)
// blocks, the tile 1,024 positions up to kSmallPositions and 4,096 above;
// with more than one block the call takes as many tickets.
int lgbt_row_partition(const uint8_t* bins_row, int n_rows, const int* idx, int count,
                       int n_pos, const uint32_t* table_host, unsigned long long* state,
                       unsigned long long ticket0, unsigned long long epoch, int* left,
                       int* right, int* n_left, void* stream) {
  if (n_rows < 1 || n_pos < 1 || count < 0 || count > n_pos || table_host == nullptr ||
      epoch < 1 || epoch >= (1ull << 31)) {
    return int(cudaErrorInvalidValue);
  }
  Table table;
  for (int i = 0; i < 8; ++i) table.w[i] = table_host[i];
  const bool small = n_pos <= kSmallPositions;
  const long long tile = kThreads * static_cast<long long>(small ? kSmallItems : kLargeItems);
  const unsigned grid = unsigned((n_pos + tile - 1) / tile);
  auto kernel = small ? row_partition_kernel<kSmallItems> : row_partition_kernel<kLargeItems>;
  kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      bins_row, n_rows, idx, count, n_pos, table, state, ticket0, epoch, left, right, n_left);
  return int(cudaGetLastError());
}

}  // extern "C"
