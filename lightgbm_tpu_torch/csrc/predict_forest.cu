// Forest traversal for Hopper (sm_90a): the port of the TPU kernel
// lightgbm_tpu/ops/predict_pallas.py:pallas_predict_raw (kernel body
// _make_kernel, which runs ops/predict.py:forest_level_step for every level,
// then the leaf-value gather and the per-class sum).
//
// What it computes. For each row of X [N, F] and each tree t of the packed
// forest, walk from the root to a leaf with the decision rules of
// Tree::Decision (numerical `<=` on the float32 threshold; MISSING_ZERO via
// |x| <= kZeroThreshold; MISSING_NAN; default-left; categorical bitset
// membership, with NaN, negative and out-of-range values going right).
// Single-leaf trees sit at leaf 0. Two outputs:
//   raw:  out[N, C] float32, class c summing the leaf values of trees
//         c, c + C, c + 2C, ... in ascending order, one float32 add at a
//         time from 0 — the order of the plain PyTorch version, so the two
//         agree bit for bit. With `accumulate` the chain starts from the
//         value out holds: prediction early stopping adds a block of trees
//         onto the running sums of its active rows this way, and a row's
//         sum is then the whole traversal's chain of adds;
//   leaf: out[N, T] int32 leaf indices (pred_leaf).
// A third entry point, lgbt_predict_early_stop (its own note below), runs
// one block of prediction early stopping over a list of active rows.
//
// What bounds it. Bytes: X once (4F bytes a row), the output, the model once
// (~3 MB for 500 trees x 255 leaves): ~20 us for a 262,144 x 28 chunk at
// 3.35 TB/s. The work that the bytes do not show is N * T * depth dependent
// steps, each a node load and a feature load that the next step waits on:
// the walk is bound by the latency and the bandwidth of the memory that
// holds the nodes. Nodes read from global memory cost an L2 round trip a
// step (five, as five separate tables), and a thread a row with all trees
// in its loop leaves a 64-row serving batch 64 threads on a 132-SM card.
// In shared memory a warp's 16-byte loads of random nodes of one tree take
// several wavefronts: that is where the chunk's time goes.
//
// Design.
//  * Packed node record (ops/predict.py:forest_records). One aligned 16-byte
//    load a step: threshold bits (or, for a categorical node, the index of
//    [n_words, words...] in cat_table), feature, and both children with the
//    four decision-type bits in their low two bits each. A tree is one blob
//    of R words: its I records, then its leaf values padded to 16 bytes.
//  * Tree tiles in shared memory. A block walks a tile of rows (one thread a
//    row; X's row tile staged feature-major, so a warp's feature loads hit
//    32 distinct banks whatever features its rows split on) against tiles
//    of tile_trees trees, copied with cp.async into two buffers: tile i + 1
//    lands while tile i is walked. Whole trees are staged (leaf-wise growth numbers nodes in split
//    order, not by level). A tree too large for the budget, or X too wide to
//    stage, is read from global memory by the same kernel (template flags);
//    a step then costs an L2 round trip again, as before.
//  * Two plans, chosen by the wrapper from N and T alone (ops/predict_cuda.py
//    forest_plan). Large N: every block walks all trees, in class-major order
//    (class 0's trees ascending, then class 1's ...), carrying each row's
//    running sum in a register and writing it at the end of its class.
//    Small N (serving batches): the trees are split across blocks as well
//    (grid.y), so a 64-row request still fills the card; each (row, tree)
//    leaf value goes to a [T, N] scratch and a second kernel sums each row's
//    class in ascending tree order, [128 trees, 32 rows] tiles of the
//    scratch streaming through shared memory with cp.async, so the sum is
//    one chain of dependent adds and not of dependent loads. Leaf mode
//    writes its [N, T] indices in either plan.
// No atomics: each output element is written by one thread, in an order
// fixed by the shapes alone, so two launches give the same bits and a row
// predicts the same bits in any batch. The kernels allocate nothing, do not
// synchronise, and launch on the caller's stream; the entry point returns
// cudaGetLastError() after each launch.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 512;
constexpr int kSumTrees = 128;  // trees per scratch tile of the sum kernel
constexpr int kSumWarps = 8;
constexpr int kSumClasses = 4;  // classes a warp of the sum kernel carries at once
constexpr float kZeroThreshold = 1e-35f;  // meta.h kZeroThreshold
constexpr int kMissingZero = 1;
constexpr int kMissingNan = 2;

enum Mode { kRaw = 0, kRawSplit = 1, kLeaf = 2 };

struct Forest {
  const int4* records;   // [T, R / 4]: a tree's node records, then its leaf values
  const int* cat_table;  // [n_words, word 0, ...] per categorical node
  int T, R, I, C, max_depth;
};

template <bool kGlobal, typename V>
__device__ __forceinline__ V load(const V* p) {
  if (kGlobal) return __ldg(p);
  return *p;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// The leaf that row x (feature f at x[f * xs]) reaches in the tree whose
// records start at `nodes`.
template <bool kGlobalNodes, bool kGlobalX>
__device__ __forceinline__ int walk(const int4* nodes, const int* __restrict__ cat_table,
                                    const float* x, int xs, int max_depth) {
  int node = 0;
  for (int level = 0; level < max_depth; ++level) {
    const int4 r = load<kGlobalNodes>(nodes + node);
    const int dt = (r.z & 3) | ((r.w & 3) << 2);
    float v = load<kGlobalX>(x + static_cast<long long>(r.y) * xs);
    bool left;
    if (dt & 1) {
      // categorical: truncate toward zero, saturating (NaN handled first)
      const int iv = isnan(v) ? -1 : __float2int_rz(v);
      left = false;
      if (iv >= 0 && (iv >> 5) < __ldg(cat_table + r.x)) {
        left = ((__ldg(cat_table + r.x + 1 + (iv >> 5)) >> (iv & 31)) & 1) != 0;
      }
    } else {
      const int missing_type = dt >> 2;
      const bool nan = isnan(v);
      if (nan && missing_type != kMissingNan) v = 0.0f;
      const bool missing = (missing_type == kMissingZero && fabsf(v) <= kZeroThreshold) ||
                           (missing_type == kMissingNan && nan);
      left = missing ? ((dt & 2) != 0) : (v <= __int_as_float(r.x));
    }
    node = (left ? r.z : r.w) >> 2;
    if (node < 0) break;
  }
  return ~node;
}

// grid (row tiles, tree splits); blockDim.x rows a block, one a thread. The
// block walks its trees [p0, p1) of the walk order: class-major for kRaw
// (q -> tree (q % per_class) * C + q / per_class), ascending otherwise.
template <int kMode, bool kStageX, bool kStageTrees>
__global__ void __launch_bounds__(kMaxThreads, 2)
predict_forest_kernel(const float* __restrict__ X, long long n, int F,
                      Forest f, int trees_per_block, int tile_trees, bool accumulate,
                      float* __restrict__ out_raw, int* __restrict__ out_leaf,
                      float* __restrict__ vals) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tile_words = kStageTrees ? tile_trees * f.R : 0;
  int* tree_buf = reinterpret_cast<int*>(smem);          // [2][tile_trees * R]
  float* xtile = reinterpret_cast<float*>(smem) + 2 * tile_words;  // [F][blockDim.x]
  const long long row0 = static_cast<long long>(blockIdx.x) * blockDim.x;
  const long long row = row0 + threadIdx.x;
  const bool live = row < n;
  const int p0 = blockIdx.y * trees_per_block;
  const int p1 = min(f.T, p0 + trees_per_block);
  const int per_class = f.T / f.C;
  const int units = f.R / 4;  // 16-byte units a tree
  auto tree_of = [&](int q) {
    return kMode == kRaw ? (q % per_class) * f.C + q / per_class : q;
  };
  auto stage = [&](int tile) {
    const int q0 = p0 + tile * tile_trees;
    const int count = (min(p1, q0 + tile_trees) - q0) * units;
    int4* dst = reinterpret_cast<int4*>(tree_buf + (tile & 1) * tile_words);
    for (int u = threadIdx.x; u < count; u += blockDim.x) {
      const int j = u / units;
      cp_async16(dst + u, f.records + static_cast<long long>(tree_of(q0 + j)) * units +
                              (u - j * units));
    }
    cp_async_commit();
  };
  const int n_tiles = kStageTrees ? (p1 - p0 + tile_trees - 1) / tile_trees : 1;
  if (kStageTrees) stage(0);

  // X's row tile feature-major: a warp's lanes (rows) read one word each
  // of 32 consecutive words whatever features they split on, so the
  // feature loads are free of bank conflicts
  const float* x;
  int xs;
  if (kStageX) {
    const long long left_in_x = n - row0;
    const int rows = left_in_x < blockDim.x ? static_cast<int>(left_in_x) : blockDim.x;
    const float* src = X + row0 * F;
    for (int i = threadIdx.x; i < blockDim.x * F; i += blockDim.x) {
      const int feat = i / blockDim.x, r = i - feat * blockDim.x;
      if (r < rows) xtile[i] = __ldg(src + static_cast<long long>(r) * F + feat);
    }
    x = xtile + threadIdx.x;
    xs = blockDim.x;
  } else {
    x = X + (live ? row : 0) * F;
    xs = 1;
  }
  __syncthreads();

  // kRaw walks every tree (trees_per_block == T): class 0's chain first
  float acc = (kMode == kRaw && accumulate && live) ? out_raw[row * f.C] : 0.0f;
  for (int tile = 0; tile < n_tiles; ++tile) {
    int q0 = p0, q1 = p1;
    const int* buf = nullptr;
    if (kStageTrees) {
      if (tile + 1 < n_tiles) stage(tile + 1); else cp_async_commit();
      cp_async_wait_one();  // this thread's copies of tile `tile` have landed
      __syncthreads();      // ... and everyone's
      q0 = p0 + tile * tile_trees;
      q1 = min(p1, q0 + tile_trees);
      buf = tree_buf + (tile & 1) * tile_words;
    }
    if (live) {
      for (int q = q0; q < q1; ++q) {
        const int t = tree_of(q);
        const int* blob = kStageTrees
            ? buf + (q - q0) * f.R
            : reinterpret_cast<const int*>(f.records) + static_cast<long long>(t) * f.R;
        const int leaf = walk<!kStageTrees, !kStageX>(reinterpret_cast<const int4*>(blob),
                                                      f.cat_table, x, xs, f.max_depth);
        if (kMode == kLeaf) {
          out_leaf[row * f.T + t] = leaf;
        } else {
          const float v = __int_as_float(load<!kStageTrees>(blob + 4 * f.I + leaf));
          if (kMode == kRawSplit) {
            vals[static_cast<long long>(t) * n + row] = v;
          } else {
            acc += v;
            if ((q + 1) % per_class == 0) {
              const int c = q / per_class;
              out_raw[row * f.C + c] = acc;
              acc = (accumulate && c + 1 < f.C) ? out_raw[row * f.C + c + 1] : 0.0f;
            }
          }
        }
      }
    }
    if (kStageTrees) __syncthreads();  // tile's buffer is free for tile + 2
  }
}

// out[row, c] = vals[c, row] + vals[c + C, row] + ... in ascending tree
// order from 0. 32 rows a block. [kSumTrees, 32] tiles of vals go through
// two shared-memory buffers with cp.async (tile i + 1 lands while tile i is
// summed), and warp w sums classes w, w + kSumWarps, ... (kSumClasses at a
// time; more classes take further passes over vals). A row's sum is one
// chain of dependent adds; its loads come from shared memory.
__global__ void __launch_bounds__(kSumWarps * 32)
predict_forest_sum_kernel(const float* __restrict__ vals, long long n, int T, int C,
                          bool accumulate, float* __restrict__ out) {
  __shared__ float tile[2][kSumTrees][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long row0 = static_cast<long long>(blockIdx.x) * 32;
  const long long row = row0 + lane;
  const int n_tiles = (T + kSumTrees - 1) / kSumTrees;
  auto stage = [&](int i) {
    const int t0 = i * kSumTrees;
    for (int e = threadIdx.x; e < kSumTrees * 32; e += blockDim.x) {
      const int tt = e >> 5, r = e & 31;
      if (t0 + tt < T && row0 + r < n) {
        cp_async4(&tile[i & 1][tt][r], vals + static_cast<long long>(t0 + tt) * n + row0 + r);
      }
    }
    cp_async_commit();
  };
  for (int cg = 0; cg < C; cg += kSumWarps * kSumClasses) {
    float acc[kSumClasses];
#pragma unroll
    for (int j = 0; j < kSumClasses; ++j) {
      const int c = cg + warp + j * kSumWarps;
      acc[j] = (accumulate && row < n && c < C) ? out[row * C + c] : 0.0f;
    }
    stage(0);
    for (int i = 0; i < n_tiles; ++i) {
      if (i + 1 < n_tiles) stage(i + 1); else cp_async_commit();
      cp_async_wait_one();
      __syncthreads();
      const int t0 = i * kSumTrees;
      const int t1 = min(T, t0 + kSumTrees);
#pragma unroll
      for (int j = 0; j < kSumClasses; ++j) {
        const int c = cg + warp + j * kSumWarps;
        if (c < C) {
          // the first tree of class c at or after t0
          int t = t0 + ((c - t0 % C) + C) % C;
#pragma unroll 8
          for (; t < t1; t += C) acc[j] += tile[i & 1][t - t0][lane];
        }
      }
      __syncthreads();  // tile i's buffer is free for tile i + 2
    }
    if (row < n) {
#pragma unroll
      for (int j = 0; j < kSumClasses; ++j) {
        const int c = cg + warp + j * kSumWarps;
        if (c < C) out[row * C + c] = acc[j];
      }
    }
  }
}

template <int kMode, bool kStageX, bool kStageTrees>
cudaError_t launch_walk(dim3 grid, int threads, size_t smem, cudaStream_t stream,
                        const float* X, long long n, int F, const Forest& f,
                        int trees_per_block, int tile_trees, bool accumulate, float* out_raw,
                        int* out_leaf, float* vals) {
  auto kernel = predict_forest_kernel<kMode, kStageX, kStageTrees>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(X, n, F, f, trees_per_block, tile_trees,
                                          accumulate, out_raw, out_leaf, vals);
  return cudaGetLastError();
}

template <int kMode>
cudaError_t dispatch(bool stage_x, bool stage_trees, dim3 grid, int threads, size_t smem,
                     cudaStream_t stream, const float* X, long long n, int F,
                     const Forest& f, int trees_per_block, int tile_trees, bool accumulate,
                     float* out_raw, int* out_leaf, float* vals) {
  if (stage_x && stage_trees)
    return launch_walk<kMode, true, true>(grid, threads, smem, stream, X, n, F, f,
                                          trees_per_block, tile_trees, accumulate, out_raw,
                                          out_leaf, vals);
  if (stage_x)
    return launch_walk<kMode, true, false>(grid, threads, smem, stream, X, n, F, f,
                                           trees_per_block, tile_trees, accumulate, out_raw,
                                           out_leaf, vals);
  if (stage_trees)
    return launch_walk<kMode, false, true>(grid, threads, smem, stream, X, n, F, f,
                                           trees_per_block, tile_trees, accumulate, out_raw,
                                           out_leaf, vals);
  return launch_walk<kMode, false, false>(grid, threads, smem, stream, X, n, F, f,
                                          trees_per_block, tile_trees, accumulate, out_raw,
                                          out_leaf, vals);
}

}  // namespace

// One traversal. mode 0: raw scores [n, C] into out (every block walks all
// trees: trees_per_block == T); mode 1: raw scores through the [T, n]
// scratch `vals` and the sum kernel; mode 2: leaf indices [n, T] into out.
// accumulate (modes 0 and 1): each class's sum starts from out's value.
// records [T, R] int32 (R a multiple of 4, the first 4 * I words node
// records), cat_table int32. rows_per_block threads a block (at most 512),
// tile_trees trees a shared-memory tile when stage_trees, X's row tile
// staged when stage_x. Returns cudaGetLastError() after the launches.
extern "C" int lgbt_predict_forest(const float* X, long long n, int F, const int* records,
                                   int R, int I, const int* cat_table, int T, int max_depth,
                                   int C, int mode, int rows_per_block, int trees_per_block,
                                   int tile_trees, int stage_x, int stage_trees,
                                   int accumulate, void* out, float* vals, void* stream_ptr) {
  if (n < 1 || T < 1 || C < 1 || T % C != 0 || R < 4 || R % 4 != 0 || I < 1 || 4 * I >= R ||
      rows_per_block < 32 || rows_per_block > kMaxThreads || rows_per_block % 32 != 0 ||
      trees_per_block < 1 || tile_trees < 1 || mode < 0 || mode > 2 ||
      (mode == kRaw && trees_per_block < T) || (mode == kRawSplit && vals == nullptr) ||
      (mode == kLeaf && accumulate)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const Forest f{reinterpret_cast<const int4*>(records), cat_table, T, R, I, C, max_depth};
  const size_t smem = (stage_trees ? size_t(2) * tile_trees * R * 4 : 0) +
                      (stage_x ? size_t(rows_per_block) * F * 4 : 0);
  const dim3 grid(static_cast<unsigned>((n + rows_per_block - 1) / rows_per_block),
                  static_cast<unsigned>((T + trees_per_block - 1) / trees_per_block));
  cudaError_t err;
  if (mode == kLeaf) {
    err = dispatch<kLeaf>(stage_x, stage_trees, grid, rows_per_block, smem, stream, X, n, F,
                          f, trees_per_block, tile_trees, false, nullptr,
                          static_cast<int*>(out), nullptr);
  } else if (mode == kRaw) {
    err = dispatch<kRaw>(stage_x, stage_trees, grid, rows_per_block, smem, stream, X, n, F,
                         f, trees_per_block, tile_trees, accumulate != 0,
                         static_cast<float*>(out), nullptr, nullptr);
  } else {
    err = dispatch<kRawSplit>(stage_x, stage_trees, grid, rows_per_block, smem, stream, X, n,
                              F, f, trees_per_block, tile_trees, false, nullptr, nullptr,
                              vals);
    if (err == cudaSuccess) {
      predict_forest_sum_kernel<<<static_cast<unsigned>((n + 31) / 32), kSumWarps * 32, 0,
                                  stream>>>(vals, n, T, C, accumulate != 0,
                                            static_cast<float*>(out));
      err = cudaGetLastError();
    }
  }
  return static_cast<int>(err);
}

// ---------------------------------------------------------------------------
// Prediction early stopping's block (PERF.md row 1b): the port of the JAX
// package's ops/predict.py:_early_stop_block with _compact_active (XLA over
// the traversal). Not a Pallas kernel: one launch does a whole block of the
// early-stopping loop (ops/predict.py:predict_raw_early_stop), so the loop
// launches its blocks back to back with no host read between them.
//
// What it computes. For a block of the forest (a tree_slice of round_period
// x C trees) and the list of active rows rows_in[0, *count_in) (no list:
// rows 0 .. *count_in - 1, the first block; a count past n is taken as n),
// each listed row r walks the
// block's trees, reading its features from X by index, and continues each
// class's chain of float32 adds from scores[r, c] in place, class-major and
// in ascending tree order: the accumulate mode's chain, so the bits are the
// whole traversal's. Then the plain version's margin test
// (ops/predict.py:_early_stop_block_plain): one class, 2 |s| > margin;
// several, the gap between the top two in torch.topk's order (NaN above
// everything: a NaN or an inf - inf gap stops nothing); margin is the
// float32 of the threshold. A row that does not stop is appended to
// rows_out, and *count_out (zero before the launch) counts them. The order
// of rows_out is not fixed (a warp appends its rows with one atomic add);
// each row's chain is its own, so no result depends on it. A linear-tree
// block scores a leaf as ops/predict.py:_linear_leaf_scores does, each
// product and add rounded on its own (__fmul_rn, __fadd_rn).
//
// What bounds it. Bytes: the active rows' features (4F a row), their sums
// read and written (8C), the list read and the next list written (4 + 4 a
// kept row), the block's trees: at 1,048,576 active rows x 28 features, 10
// trees of 255 leaves, ~130 MB, ~39 us at 3.35 TB/s (perfmodel.py
// early_stop_block). The walk is row 1's: dependent node loads.
//
// Design. A persistent grid (no more blocks than the card holds at once,
// none past the rows) reads the count from device memory, so no launch
// waits for the host to know it; a block with no rows returns at once.
//  * The block's trees (~50 KB for 10 trees of 255 leaves) are staged into
//    shared memory once a block, whole, as row 1's tiles are; a block too
//    large for the budget is read from global memory (template flag).
//  * A warp takes 32 listed rows at a time (grid-stride over warps) and
//    loads their F features cooperatively into its own feature-major
//    shared tile [F][32]: 16-byte vectors where 4F is a multiple of 16 and
//    X is 16-byte aligned, else words. A lane then walks its row with
//    conflict-free feature reads (stride 32), as row 1's tile does; X too
//    wide for the budget is read from global memory (template flag).
//  * The sums continue in registers; the top two classes are kept on the
//    fly, so the margin test needs no second pass.
//  * The surviving rows of a warp are one ballot, one atomic add and one
//    write each.
// The walk and the node records are row 1's (walk, Forest).

namespace {

struct Linear {
  const float* lin_const;  // [T, L] each leaf's constant
  const int* lin_feat;     // [T, L, K] (-1: an unused slot)
  const float* lin_coeff;  // [T, L, K]
  int L, K;
};

// a above b in torch.topk's order: NaN above every number
__device__ __forceinline__ bool above(float a, float b) {
  return isnan(a) ? !isnan(b) : a > b;
}

template <bool kStageTrees, bool kStageX, bool kLinear>
__global__ void __launch_bounds__(kMaxThreads, 2)
early_stop_kernel(const float* __restrict__ X, int n, int F, bool vec4, Forest f, Linear lin,
                  float* __restrict__ scores, const int* __restrict__ rows_in,
                  const int* __restrict__ count_in, int* __restrict__ rows_out,
                  int* __restrict__ count_out, float margin) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int count = min(*count_in, n);
  if (static_cast<long long>(blockIdx.x) * blockDim.x >= count) return;
  const int warps = blockDim.x >> 5;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tree_words = kStageTrees ? f.T * f.R : 0;
  int4* trees = reinterpret_cast<int4*>(smem);
  float* xt = reinterpret_cast<float*>(smem) + tree_words + warp * F * 32;  // [F][32]
  int* ids = reinterpret_cast<int*>(smem) + tree_words + warps * F * 32 + warp * 32;
  if (kStageTrees) {
    for (int u = threadIdx.x; u < tree_words / 4; u += blockDim.x) trees[u] = __ldg(f.records + u);
    __syncthreads();
  }
  const int per_class = f.T / f.C;
  const unsigned full = 0xffffffffu;
  for (long long base = (static_cast<long long>(blockIdx.x) * warps + warp) * 32; base < count;
       base += static_cast<long long>(gridDim.x) * warps * 32) {
    const int pos = static_cast<int>(base) + lane;
    const bool live = pos < count;
    const int row = live ? (rows_in != nullptr ? rows_in[pos] : pos) : -1;
    const float* x;
    int xs;
    if (kStageX) {
      ids[lane] = row;
      __syncwarp();
      if (vec4) {
        const int F4 = F >> 2;
        for (int i = lane; i < 32 * F4; i += 32) {
          const int r = i / F4, part = i - r * F4;
          const int src = ids[r];
          if (src >= 0) {
            const float4 v =
                __ldg(reinterpret_cast<const float4*>(X + static_cast<long long>(src) * F) + part);
            float* d = xt + part * 4 * 32 + r;
            d[0] = v.x;
            d[32] = v.y;
            d[64] = v.z;
            d[96] = v.w;
          }
        }
      } else {
        for (int i = lane; i < 32 * F; i += 32) {
          const int r = i / F, feat = i - r * F;
          const int src = ids[r];
          if (src >= 0) xt[feat * 32 + r] = __ldg(X + static_cast<long long>(src) * F + feat);
        }
      }
      __syncwarp();
      x = xt + lane;
      xs = 32;
    } else {
      x = X + static_cast<long long>(live ? row : 0) * F;
      xs = 1;
    }
    bool keep = false;
    if (live) {
      float t1 = 0.0f, t2 = 0.0f;
      for (int c = 0; c < f.C; ++c) {
        float* s = scores + static_cast<long long>(row) * f.C + c;
        float acc = *s;
        for (int q = 0; q < per_class; ++q) {
          const int t = q * f.C + c;
          const int* blob =
              kStageTrees ? reinterpret_cast<const int*>(trees) + t * f.R
                          : reinterpret_cast<const int*>(f.records) + static_cast<long long>(t) * f.R;
          const int leaf = walk<!kStageTrees, !kStageX>(reinterpret_cast<const int4*>(blob),
                                                        f.cat_table, x, xs, f.max_depth);
          float v = __int_as_float(load<!kStageTrees>(blob + 4 * f.I + leaf));
          if (kLinear) {
            const long long li = static_cast<long long>(t) * lin.L + leaf;
            float total = 0.0f;
            bool bad = false;
            for (int k = 0; k < lin.K; ++k) {
              const int feat = __ldg(lin.lin_feat + li * lin.K + k);
              float term = 0.0f;
              if (feat >= 0) {
                const float fv = load<!kStageX>(x + static_cast<long long>(min(feat, F - 1)) * xs);
                bad |= !isfinite(fv);
                term = __fmul_rn(__ldg(lin.lin_coeff + li * lin.K + k), fv);
              }
              total = __fadd_rn(total, term);
            }
            const float lv = __fadd_rn(__ldg(lin.lin_const + li), total);
            if (!bad) v = lv;
          }
          acc = __fadd_rn(acc, v);
        }
        *s = acc;
        if (c == 0) {  // the top two so far (torch.topk's values, in its order)
          t1 = acc;
        } else if (above(acc, t1)) {
          t2 = t1;
          t1 = acc;
        } else if (c == 1 || above(acc, t2)) {
          t2 = acc;
        }
      }
      const float m = f.C == 1 ? __fmul_rn(2.0f, fabsf(t1)) : __fsub_rn(t1, t2);
      keep = !(m > margin);
    }
    const unsigned mask = __ballot_sync(full, keep);
    if (mask != 0) {
      int at = 0;
      if (lane == 0) at = atomicAdd(count_out, __popc(mask));
      at = __shfl_sync(full, at, 0);
      if (keep) rows_out[at + __popc(mask & ((1u << lane) - 1u))] = row;
    }
    __syncwarp();  // ids and xt are rewritten by the warp's next rows
  }
}

template <bool kStageTrees, bool kStageX, bool kLinear>
cudaError_t launch_early_stop(int threads, size_t smem, long long n, cudaStream_t stream,
                              const float* X, int F, bool vec4, const Forest& f,
                              const Linear& lin, float* scores, const int* rows_in,
                              const int* count_in, int* rows_out, int* count_out,
                              float margin) {
  auto kernel = early_stop_kernel<kStageTrees, kStageX, kLinear>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
      cudaSuccess) {
    return err;
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long wanted = (n + threads - 1) / threads;
  const long long resident = static_cast<long long>(per_sm) * sms;
  const unsigned grid = static_cast<unsigned>(wanted < resident ? wanted : resident);
  kernel<<<grid, threads, smem, stream>>>(X, static_cast<int>(n), F, vec4, f, lin, scores,
                                          rows_in, count_in, rows_out, count_out, margin);
  return cudaGetLastError();
}

template <bool kStageTrees, bool kStageX>
cudaError_t early_stop_linear(bool linear, int threads, size_t smem, long long n,
                              cudaStream_t stream, const float* X, int F, bool vec4,
                              const Forest& f, const Linear& lin, float* scores,
                              const int* rows_in, const int* count_in, int* rows_out,
                              int* count_out, float margin) {
  if (linear)
    return launch_early_stop<kStageTrees, kStageX, true>(threads, smem, n, stream, X, F, vec4,
                                                         f, lin, scores, rows_in, count_in,
                                                         rows_out, count_out, margin);
  return launch_early_stop<kStageTrees, kStageX, false>(threads, smem, n, stream, X, F, vec4, f,
                                                        lin, scores, rows_in, count_in,
                                                        rows_out, count_out, margin);
}

}  // namespace

// One block of prediction early stopping. X [n, F] float32; records [T, R]
// int32, the block's trees (R a multiple of 4, the first 4 * I words node
// records), cat_table int32; scores [n, C] float32, updated in place for
// the listed rows; rows_in [n] int32 or null (rows 0, 1, ...);
// count_in, count_out one int32 each on the card, *count_out zero before
// the launch; rows_out [n] int32. A linear block passes lin_const [T, L],
// lin_feat [T, L, K], lin_coeff [T, L, K] (else null, L = K = 0). margin:
// the float32 threshold. threads a block (at most 512), the block's trees
// staged in shared memory when stage_trees, each warp's rows of X when
// stage_x (then vec4: 16-byte loads of X). Returns cudaGetLastError()
// after the launch.
extern "C" int lgbt_predict_early_stop(const float* X, long long n, int F, const int* records,
                                       int R, int I, const int* cat_table, int T, int max_depth,
                                       int C, const float* lin_const, const int* lin_feat,
                                       const float* lin_coeff, int L, int K, float* scores,
                                       const int* rows_in, const int* count_in, int* rows_out,
                                       int* count_out, float margin, int threads,
                                       int stage_trees, int stage_x, int vec4,
                                       void* stream_ptr) {
  const bool linear = lin_const != nullptr;
  if (n < 1 || n >= (1ll << 31) || F < 1 || T < 1 || C < 1 || T % C != 0 || R < 4 ||
      R % 4 != 0 || I < 1 || 4 * I >= R || threads < 32 || threads > kMaxThreads ||
      threads % 32 != 0 || count_in == nullptr || count_out == nullptr || rows_out == nullptr ||
      (linear && (L < 1 || K < 0 || (K > 0 && (lin_feat == nullptr || lin_coeff == nullptr)))) ||
      (vec4 && (F % 4 != 0 || reinterpret_cast<uintptr_t>(X) % 16 != 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const Forest f{reinterpret_cast<const int4*>(records), cat_table, T, R, I, C, max_depth};
  const Linear lin{lin_const, lin_feat, lin_coeff, L, K};
  const size_t smem = (stage_trees ? size_t(T) * R * 4 : 0) +
                      (stage_x ? size_t(threads) * (F + 1) * 4 : 0);
  const bool v4 = vec4 != 0;
  cudaError_t err;
  if (stage_trees && stage_x)
    err = early_stop_linear<true, true>(linear, threads, smem, n, stream, X, F, v4, f, lin,
                                        scores, rows_in, count_in, rows_out, count_out, margin);
  else if (stage_trees)
    err = early_stop_linear<true, false>(linear, threads, smem, n, stream, X, F, v4, f, lin,
                                         scores, rows_in, count_in, rows_out, count_out, margin);
  else if (stage_x)
    err = early_stop_linear<false, true>(linear, threads, smem, n, stream, X, F, v4, f, lin,
                                         scores, rows_in, count_in, rows_out, count_out, margin);
  else
    err = early_stop_linear<false, false>(linear, threads, smem, n, stream, X, F, v4, f, lin,
                                          scores, rows_in, count_in, rows_out, count_out,
                                          margin);
  return static_cast<int>(err);
}
