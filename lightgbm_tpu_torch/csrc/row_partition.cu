// The serial learner's row partition for Hopper (sm_90a): a split of one
// leaf's padded row-index set into its children's. Not the port of a TPU
// kernel: the JAX package runs it in XLA (lightgbm_tpu/ops/partition.py:
// partition_rows, a stable argsort on a 3-way key, and RowPartition.split,
// the children's padded buffers); it is the glue around the leaf histogram
// (csrc/histogram.cu hist_rows_kernel), folded into two launches.
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
// Design: LightGBM's CUDADataPartition::SplitInner (a bit vector and a
// prefix-scan compaction) for one range, in tiles of kTile positions:
//   1. decide: a warp takes 32 positions, writes their go-left bits as one
//      ballot word (the table in shared memory, passed by value: no copy to
//      the card), and the tile's left count;
//   2. scatter: each block sums the tiles' left counts before its own and in
//      all (at most a few thousand ints, from L2), ranks its rows stably from
//      the popcount prefixes of its ballot words, writes each row to its
//      child, and writes the sentinel padding of both children over its own
//      positions; block 0 writes n_left.
//
// What bounds it. Bytes: the decide pass reads 4 index bytes and one bin
// byte (a 32-byte sector where the leaf's rows are sparse in the plane) a
// row and writes a bit; the scatter reads the index and the bit again and
// writes 4 bytes a position into each child. At the root of 1,048,576 rows:
// ~4 + 1 + 4 + 8 = ~17 bytes a row, ~18 MB, ~5 us at 3.35 TB/s; a few
// hundred rows are launch latency.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 1024;           // positions a tile (a multiple of 32)
constexpr int kThreads = 256;         // threads of a block
constexpr unsigned kFull = 0xffffffffu;

struct Table {
  uint32_t w[8];  // bit b % 32 of word b / 32: group bin b goes left
};

__global__ void __launch_bounds__(kThreads)
row_decide_kernel(const uint8_t* __restrict__ bins_row, int n_rows,
                  const int* __restrict__ idx, int count, Table table,
                  uint32_t* __restrict__ bits, int* __restrict__ tile_cnt) {
  __shared__ uint32_t t[8];
  __shared__ int cnt;
  if (threadIdx.x < 8) t[threadIdx.x] = table.w[threadIdx.x];
  if (threadIdx.x == 0) cnt = 0;
  __syncthreads();
  const int ts = blockIdx.x * kTile;
  const int te = min(ts + kTile, count);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int mine = 0;
  for (int base = ts + warp * 32; base < te; base += kThreads) {
    const int p = base + lane;
    bool left = false;
    if (p < te) {
      const int r = idx[p];
      const int b = bins_row[r < n_rows ? r : n_rows - 1];
      left = (t[b >> 5] >> (b & 31)) & 1u;
    }
    const unsigned word = __ballot_sync(kFull, left);
    if (lane == 0) {
      bits[base >> 5] = word;
      mine += __popc(word);
    }
  }
  if (lane == 0 && mine != 0) atomicAdd(&cnt, mine);
  __syncthreads();
  if (threadIdx.x == 0) tile_cnt[blockIdx.x] = cnt;
}

__global__ void __launch_bounds__(kThreads)
row_scatter_kernel(const int* __restrict__ idx, int count, int n_pos, int n_rows,
                   const uint32_t* __restrict__ bits, const int* __restrict__ tile_cnt,
                   int n_tiles, int* __restrict__ left, int* __restrict__ right,
                   int* __restrict__ n_left_out) {
  __shared__ uint32_t words[kTile / 32];
  __shared__ int word_pre[kTile / 32 + 1];
  __shared__ int sums[2][kThreads / 32];
  const int ts = blockIdx.x * kTile;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // the left rows of the tiles before this one, and of all of them
  int before = 0, total = 0;
  for (int t = threadIdx.x; t < n_tiles; t += kThreads) {
    const int c = tile_cnt[t];
    total += c;
    if (t < int(blockIdx.x)) before += c;
  }
  for (int d = 16; d > 0; d >>= 1) {
    before += __shfl_down_sync(kFull, before, d);
    total += __shfl_down_sync(kFull, total, d);
  }
  if (lane == 0) {
    sums[0][warp] = before;
    sums[1][warp] = total;
  }
  const int te = min(ts + kTile, count);
  const int n = te - ts, n_words = n > 0 ? (n + 31) / 32 : 0;
  for (int w = threadIdx.x; w < n_words; w += kThreads) words[w] = bits[(ts >> 5) + w];
  __syncthreads();
  before = 0;
  total = 0;
  for (int w = 0; w < kThreads / 32; ++w) {
    before += sums[0][w];
    total += sums[1][w];
  }
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
  }
  __syncthreads();
  if (blockIdx.x == 0 && threadIdx.x == 0) *n_left_out = total;
  for (int o = threadIdx.x; o < n; o += kThreads) {
    const int w = o >> 5, b = o & 31;
    const int lb = before + word_pre[w] + __popc(words[w] & ((1u << b) - 1u));
    const int r = idx[ts + o];
    if ((words[w] >> b) & 1u) {
      left[lb] = r;
    } else {
      right[ts + o - lb] = r;  // the right rows before position ts + o
    }
  }
  // the children's sentinel padding over this tile's positions
  const int n_right = count - total;
  for (int q = ts + threadIdx.x; q < min(ts + kTile, n_pos); q += kThreads) {
    if (q >= total) left[q] = n_rows;
    if (q >= n_right) right[q] = n_rows;
  }
}

int tiles(long long n) { return int((n + kTile - 1) / kTile); }

}  // namespace

extern "C" {

// Pass 1. bins_row [n_rows] uint8, idx [>= count] int32, table_host: 8
// words on the host (bit b of the 256: group bin b goes left) -> bits
// [ceil(count / 32)] uint32, tile_cnt [ceil(count / kTile)] int32.
int lgbt_row_partition_decide(const uint8_t* bins_row, int n_rows, const int* idx, int count,
                              const uint32_t* table_host, uint32_t* bits, int* tile_cnt,
                              void* stream) {
  if (n_rows < 1 || count < 1 || table_host == nullptr) return int(cudaErrorInvalidValue);
  Table table;
  for (int i = 0; i < 8; ++i) table.w[i] = table_host[i];
  row_decide_kernel<<<tiles(count), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      bins_row, n_rows, idx, count, table, bits, tile_cnt);
  return int(cudaGetLastError());
}

// Pass 2 -> left [n_pos], right [n_pos] int32 (the children's buffers),
// n_left [1] int32. With count == 0 pass 1 is not run and both children are
// all padding.
int lgbt_row_partition_scatter(const int* idx, int count, int n_pos, int n_rows,
                               const uint32_t* bits, const int* tile_cnt, int* left,
                               int* right, int* n_left, void* stream) {
  if (n_pos < 1 || count < 0 || count > n_pos || n_rows < 1) {
    return int(cudaErrorInvalidValue);
  }
  row_scatter_kernel<<<tiles(n_pos), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      idx, count, n_pos, n_rows, bits, tile_cnt, tiles(count), left, right, n_left);
  return int(cudaGetLastError());
}

}  // extern "C"
