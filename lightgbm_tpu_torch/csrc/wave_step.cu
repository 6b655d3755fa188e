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
// wave_select_kernel (one block). The top K leaves by gain: leaf i ranks
// before leaf j when its gain is larger, a NaN ranking above every number,
// ties to the lower leaf index (torch.sort(descending, stable) and
// jax.lax.top_k's tie order). Each thread counts, for its leaves, the leaves
// that rank before them and stops at K, so only the top K finish a full pass
// over the gains (staged in shared memory up to kSharedLeaves leaves). Then
// per selected range the partition's inputs: leaf2k, the split feature's
// group row, the range's start and count, valid (a positive gain and the
// tree not done), the leaf id, and the [K, 256] decision table, one thread
// per (range, group bin), NumericalDecisionInner on the raw group bin.
//
// wave_replay_kernel (one block). The guard on the 2K children's gains,
// a thread a child; then one warp replays: each of the up to K + 1 dependent
// steps is a warp-wide argmax over the L gains (kept in shared memory in
// step with leaf_best; the first maximum, a NaN first, as torch.argmax and
// jnp.argmax take it), and a commit writes two records, two depths and a
// split-log row, the parent's output in float32 in the JAX replay's op order
// (built with --fmad=false, no contraction). Then the block writes the
// commit's [5, K] int64 table (pool rows, relabel ranges; an uncommitted
// range writes the dump row L and the empty range [0, 0)), the committed
// children's start and count, and the scalars: hist_rows + each valid
// range's smaller child, n_waves + 1 when the wave started live, and done
// unless t < L - 1 and the largest gain is positive.
//
// tree_loop_cond_kernel (one thread) and lgbt_tree_graph: a whole tree as
// one CUDA graph, built with the runtime's graph API. The root's work (a
// captured child graph), then this kernel, which sets the condition of a
// WHILE node from the done word, then the WHILE node, whose body is two waves
// (captured child graphs of both buffer parities, so a pass ends on the
// parity it began with) and this kernel again, which also counts the body's
// passes. A pass past max_passes clears the condition and leaves the count
// above the bound, which the host reads as a loop that never finished.
//
// What bounds them. Bytes: the selection reads L gains and K records and
// writes (L + 2 + 5K + 256K) int32; the replay reads 2K records and totals
// and L gains and writes a few [L+1] rows: a few KB, well under a
// microsecond of device memory time. Both are latency-bound: one block, a
// chain of K + 1 dependent warp reductions in the replay.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRec = 14;               // ops/split.py SPLIT_FIELDS
constexpr int kStore = kRec + 4;       // a split-log row
constexpr int kGroupBins = 256;
constexpr int kMaxK = 1024;            // ranges a wave (the partition's kMaxRanges)
constexpr int kSharedLeaves = 4096;    // gains staged in shared memory up to this many
constexpr int kSelectThreads = 1024;
constexpr int kReplayThreads = 256;
constexpr int kMissingZero = 1, kMissingNan = 2;  // common.py MISSING_ZERO, MISSING_NAN
constexpr int kNCur = 0, kT = 1, kHistRows = 2, kNWaves = 3, kDone = 4;  // the scalars
constexpr float kEps = 1e-15f;         // the replay's floor under the parent's hessian
constexpr unsigned kFull = 0xffffffffu;

// leaf (a, ia) ranks before leaf (b, ib): larger gain first, NaN largest,
// ties to the lower index
__device__ __forceinline__ bool before(float a, int ia, float b, int ib) {
  const bool na = a != a, nb = b != b;
  if (na || nb) return na && (!nb || ia < ib);
  return a > b || (a == b && ia < ib);
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

__global__ void __launch_bounds__(kSelectThreads)
wave_select_kernel(const float* __restrict__ leaf_best, int n_leaves,
                   const int* __restrict__ start, const int* __restrict__ count,
                   const long long* __restrict__ scalars, Tables tb, int K,
                   int* __restrict__ table) {
  __shared__ float sgain[kSharedLeaves];
  __shared__ int ssel[kMaxK];
  __shared__ int sflags[kMaxK];  // bit 0 valid, 1 default_left, 2 is_efb; missing type << 3
  __shared__ int sthresh[kMaxK], sdefault[kMaxK], snbins[kMaxK], slo[kMaxK], shi[kMaxK];
  const int L = n_leaves;
  const bool staged = L <= kSharedLeaves;
  if (staged) {
    for (int i = threadIdx.x; i < L; i += blockDim.x) sgain[i] = leaf_best[(long long)i * kRec];
  }
  __syncthreads();
  auto gain = [&](int i) { return staged ? sgain[i] : leaf_best[(long long)i * kRec]; };
  for (int i = threadIdx.x; i < L; i += blockDim.x) {
    const float gi = gain(i);
    int r = 0;
    for (int j = 0; j < L && r < K; ++j) r += before(gain(j), j, gi, i) ? 1 : 0;
    if (r < K) ssel[r] = i;
  }
  __syncthreads();
  int* leaf2k = table;
  int* rgroup = leaf2k + L + 2;
  int* s_k = rgroup + K;
  int* c_k = s_k + K;
  int* ok_k = c_k + K;
  int* sel_k = ok_k + K;
  int* lut = sel_k + K;
  const bool done = scalars[kDone] != 0;
  for (int i = threadIdx.x; i < L + 2; i += blockDim.x) leaf2k[i] = K;
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    const int leaf = ssel[k];
    const float* rec = leaf_best + (long long)leaf * kRec;
    const bool ok = rec[0] > 0.f && !done;
    const int f = ok ? int(rec[1]) : 0;
    const bool defl = rec[3] > 0.5f;
    rgroup[k] = ok ? tb.group[f] : 0;
    s_k[k] = start[leaf];
    c_k[k] = count[leaf];
    ok_k[k] = ok ? 1 : 0;
    sel_k[k] = leaf;
    sflags[k] = (ok ? 1 : 0) | (defl ? 2 : 0) | (tb.is_efb[f] ? 4 : 0) | (tb.missing_type[f] << 3);
    sthresh[k] = ok ? int(rec[2]) : 0;
    sdefault[k] = tb.default_bin[f];
    snbins[k] = tb.nbins[f];
    slo[k] = tb.lo[f];
    shi[k] = tb.hi[f];
  }
  __syncthreads();  // leaf2k's fill lands before the valid ranges' entries
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    if (sflags[k] & 1) leaf2k[ssel[k] + 1] = k;
  }
  for (int idx = threadIdx.x; idx < K * kGroupBins; idx += blockDim.x) {
    const int k = idx / kGroupBins, gb = idx - k * kGroupBins;
    const int fl = sflags[k];
    lut[idx] = (fl & 1) && decide_go_left(gb, sthresh[k], (fl & 2) != 0, fl >> 3, sdefault[k],
                                          snbins[k], slo[k], shi[k], (fl & 4) != 0) ? 1 : 0;
  }
}

__global__ void __launch_bounds__(kReplayThreads)
wave_replay_kernel(float* __restrict__ leaf_best, int* __restrict__ depth,
                   float* __restrict__ rec_store, int* __restrict__ start,
                   int* __restrict__ count, long long* __restrict__ scalars,
                   const int* __restrict__ table, const int* __restrict__ n_left,
                   const float* __restrict__ recs2, const float* __restrict__ totals2, int ch,
                   const float* __restrict__ params, int max_depth, int n_leaves, int K,
                   long long* __restrict__ commit) {
  __shared__ float sgain[kSharedLeaves];  // leaf_best[:L, 0], in step with it
  __shared__ float g2[2 * kMaxK];         // the children's guarded gains
  __shared__ int scommitted[kMaxK], snewid[kMaxK];
  __shared__ long long s_end[2];          // n_cur, t after the replay
  __shared__ float s_top;                 // the largest gain after the replay
  const int L = n_leaves;
  const int* s_k = table + L + 2 + K;
  const int* c_k = s_k + K;
  const int* ok_k = c_k + K;
  const int* sel = ok_k + K;
  const float l1 = params[0], l2 = params[1], min_data = params[2], min_hess = params[3],
              max_delta = params[5];
  const bool done_in = scalars[kDone] != 0;
  const bool staged = L <= kSharedLeaves;
  if (staged) {
    for (int i = threadIdx.x; i < L; i += blockDim.x) sgain[i] = leaf_best[(long long)i * kRec];
  }
  for (int j = threadIdx.x; j < 2 * K; j += blockDim.x) {
    const int d = depth[sel[j >> 1]] + 1;
    bool ok = totals2[j * ch + 2] >= 2.f * min_data && totals2[j * ch + 1] >= 2.f * min_hess;
    if (max_depth > 0) ok = ok && d < max_depth;
    g2[j] = ok ? recs2[(long long)j * kRec] : -INFINITY;
  }
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    scommitted[k] = 0;
    snewid[k] = 0;
  }
  __syncthreads();

  if (threadIdx.x < 32) {  // the replay: one warp, K + 1 dependent steps at most
    const int lane = threadIdx.x;
    auto gain = [&](int i) { return staged ? sgain[i] : leaf_best[(long long)i * kRec]; };
    long long n_cur = scalars[kNCur], t = scalars[kT];
    float top;
    while (true) {
      float bv = 0.f;
      int bi = INT_MAX;  // none yet
      for (int i = lane; i < L; i += 32) {
        const float v = gain(i);
        if (bi == INT_MAX || before(v, i, bv, bi)) { bv = v; bi = i; }
      }
      for (int d = 16; d > 0; d >>= 1) {
        const float ov = __shfl_down_sync(kFull, bv, d);
        const int oi = __shfl_down_sync(kFull, bi, d);
        if (oi != INT_MAX && (bi == INT_MAX || before(ov, oi, bv, bi))) { bv = ov; bi = oi; }
      }
      const int b = __shfl_sync(kFull, bi, 0);
      top = __shfl_sync(kFull, bv, 0);
      int pos = K;  // the valid selection of leaf b (sel holds distinct leaves)
      for (int k = lane; k < K; k += 32) {
        if (sel[k] == b && ok_k[k] != 0) pos = k;
      }
      for (int d = 16; d > 0; d >>= 1) pos = min(pos, __shfl_xor_sync(kFull, pos, d));
      // ~committed[pos]: a left child keeps its parent's leaf id and its
      // slot holds the PARENT's children; t < L - 1: the leaf budget
      if (!(top > 0.f && pos < K && !scommitted[pos] && t < L - 1)) break;
      const float brec = lane < kRec ? leaf_best[(long long)b * kRec + lane] : 0.f;
      const int nd = depth[b] + 1;
      __syncwarp();
      if (lane < kRec) {
        const long long l = 2LL * pos, r = l + 1;
        leaf_best[(long long)b * kRec + lane] = lane == 0 ? g2[l] : recs2[l * kRec + lane];
        leaf_best[n_cur * kRec + lane] = lane == 0 ? g2[r] : recs2[r * kRec + lane];
        rec_store[t * kStore + 4 + lane] = brec;
      }
      if (lane == 0) {
        const long long l = 2LL * pos, r = l + 1;
        const float pg = totals2[l * ch] + totals2[r * ch];
        const float ph = totals2[l * ch + 1] + totals2[r * ch + 1];
        depth[b] = nd;
        depth[n_cur] = nd;
        rec_store[t * kStore + 0] = float(b);
        rec_store[t * kStore + 1] = parent_output(pg, ph, l1, l2, max_delta);
        rec_store[t * kStore + 2] = float(nd);
        rec_store[t * kStore + 3] = 1.f;
        scommitted[pos] = 1;
        snewid[pos] = int(n_cur);
        if (staged) {
          sgain[b] = g2[l];
          sgain[n_cur] = g2[r];
        }
      }
      __syncwarp();
      ++n_cur;
      ++t;
    }
    if (lane == 0) {
      s_end[0] = n_cur;
      s_end[1] = t;
      s_top = top;
    }
  }
  __syncthreads();

  long long* wb = commit;
  long long* wn = commit + K;
  long long* mid = commit + 2 * K;
  long long* end = commit + 3 * K;
  long long* nid = commit + 4 * K;
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    const long long s = s_k[k], c = c_k[k], nl = n_left[k];
    if (scommitted[k]) {
      const int leaf = sel[k], nw = snewid[k];
      wb[k] = leaf;
      wn[k] = nw;
      mid[k] = s + nl;
      end[k] = s + c;
      nid[k] = nw;
      start[nw] = int(s + nl);
      count[nw] = int(c - nl);
      count[leaf] = int(nl);
    } else {
      wb[k] = L;
      wn[k] = L;
      mid[k] = 0;
      end[k] = 0;
      nid[k] = 0;
    }
  }
  if (threadIdx.x == 0) {
    long long rows = 0;
    for (int k = 0; k < K; ++k) {
      if (ok_k[k] != 0) {
        const long long nl = n_left[k], nr = (long long)c_k[k] - nl;
        rows += nl < nr ? nl : nr;
      }
    }
    const long long t = s_end[1];
    scalars[kNCur] = s_end[0];
    scalars[kT] = t;
    scalars[kHistRows] += rows;
    scalars[kNWaves] += done_in ? 0 : 1;
    scalars[kDone] = (done_in || !(t < L - 1 && s_top > 0.f)) ? 1 : 0;
  }
}

__global__ void tree_loop_cond_kernel(cudaGraphConditionalHandle handle,
                                      const long long* __restrict__ scalars,
                                      long long* __restrict__ passes, long long max_passes,
                                      int in_body) {
  long long n = *passes;
  if (in_body) *passes = ++n;
  cudaGraphSetConditional(handle, (scalars[kDone] == 0 && n <= max_passes) ? 1u : 0u);
}

cudaError_t add_cond_node(cudaGraphNode_t* node, cudaGraph_t graph, const cudaGraphNode_t* dep,
                          cudaGraphConditionalHandle handle, const long long* scalars,
                          long long* passes, long long max_passes, int in_body) {
  void* args[] = {&handle, &scalars, &passes, &max_passes, &in_body};
  cudaKernelNodeParams p = {};
  p.func = reinterpret_cast<void*>(tree_loop_cond_kernel);
  p.gridDim = dim3(1);
  p.blockDim = dim3(1);
  p.kernelParams = args;
  return cudaGraphAddKernelNode(node, graph, dep, dep ? 1 : 0, &p);
}

}  // namespace

extern "C" {

// One tree as one executable graph: root (cudaGraph_t), then while the done
// word scalars[4] is 0 and the passes are at most max_passes, wave0 then
// wave1 (cudaGraph_t each; cloned, so the caller keeps and frees them).
// passes [1] int64 counts the body's passes; the root must zero it. Returns
// the cudaGraphExec_t through exec_out and a cudaError_t.
int lgbt_tree_graph(void* root, void* wave0, void* wave1, const long long* scalars,
                    long long* passes, long long max_passes, void** exec_out) {
  cudaGraph_t graph = nullptr;
  cudaGraphExec_t exec = nullptr;
  cudaGraphNode_t n_root, n_cond, n_while, n_w0, n_w1, n_again;
  cudaGraphConditionalHandle handle;
  cudaGraphNodeParams wp = {};
  cudaGraph_t body = nullptr;
  cudaError_t err = cudaGraphCreate(&graph, 0);
  if (err != cudaSuccess) return int(err);
#define TRY(call)                       \
  do {                                  \
    err = (call);                       \
    if (err != cudaSuccess) goto done;  \
  } while (0)
  TRY(cudaGraphAddChildGraphNode(&n_root, graph, nullptr, 0, static_cast<cudaGraph_t>(root)));
  TRY(cudaGraphConditionalHandleCreate(&handle, graph, 0, cudaGraphCondAssignDefault));
  TRY(add_cond_node(&n_cond, graph, &n_root, handle, scalars, passes, max_passes, 0));
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
  TRY(add_cond_node(&n_again, body, &n_w1, handle, scalars, passes, max_passes, 1));
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
// int32 (leaf2k, rgroup, starts, counts, valid, sel, lut). Returns
// cudaGetLastError() after the launch.
int lgbt_wave_select(const float* leaf_best, int n_leaves, const int* start, const int* count,
                     const long long* scalars, const int* group, const int* lo, const int* hi,
                     const int* default_bin, const int* nbins, const int* missing_type,
                     const uint8_t* is_efb, int k, int* table, void* stream) {
  if (n_leaves < 1 || k < 1 || k > kMaxK || k > n_leaves) return int(cudaErrorInvalidValue);
  const Tables tb{group, lo, hi, default_bin, nbins, missing_type, is_efb};
  wave_select_kernel<<<1, kSelectThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      leaf_best, n_leaves, start, count, scalars, tb, k, table);
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
  if (n_leaves < 1 || k < 1 || k > kMaxK || k > n_leaves || ch < 3) {
    return int(cudaErrorInvalidValue);
  }
  wave_replay_kernel<<<1, kReplayThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      leaf_best, depth, rec_store, start, count, scalars, table, n_left, recs2, totals2, ch,
      params, max_depth, n_leaves, k, commit);
  return int(cudaGetLastError());
}

}  // extern "C"
