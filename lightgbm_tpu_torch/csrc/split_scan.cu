// Per-feature split scan for Hopper (sm_90a): the port of the TPU kernel
// lightgbm_tpu/ops/scan_pallas.py:fused_split_scan (kernel _make_scan_kernel,
// operands built by per_feature_best_fused), reached from
// ops/split.py:per_feature_best for numeric f32 lanes.
//
// What it computes. For L leaves' feature histograms fh [L, F, B, 3] (grad,
// hess, count), the leaves' totals [L, 3], params [6] = (lambda_l1, lambda_l2,
// min_data_in_leaf, min_sum_hessian_in_leaf, min_gain_to_split,
// max_delta_step) and per-feature metadata, the best numeric split of each
// (leaf, feature) as the 14-field record of ops/split.py:SPLIT_FIELDS — the
// wave learner's 2K children in one launch, where the JAX package vmaps
// find_best_split (treelearner/device.py:742-747); L = 1 is one leaf:
//   - the missing bin (the NaN bin, or the zero bin for MissingType::Zero)
//     is taken out of the ordered scan, its value read exactly;
//   - the prefix over bins in ascending order gives the left sums of lane 0
//     (missing goes right); lane 1 adds the missing bin to the left;
//   - min-data / min-hessian / "one real bin on the right" / valid-slot /
//     numeric-and-sampled gates, then the L1/L2/max_delta_step regularized
//     gains of both children;
//   - the argmax over lane 0's thresholds and then lane 1's takes the first
//     maximum, the winning statistics are read as exact values, and the
//     record is valid when its gain beats the parent's gain + min_gain.
//
// Bit-identity with the plain version (ops/split.py:_per_feature_best_plain,
// run on the CPU). The prefix is a sequential sum in float64, each prefix
// rounded to float32 — what torch.cumsum does on the CPU for the plain
// version's float64 histogram; a parallel scan would reassociate. All gain
// arithmetic is float32 in the plain version's op order, built with
// --fmad=false so no multiply-add is contracted into an FMA, and without
// fast math. threshold_l1 keeps its order: sign(s) * max(|s| - l1, 0), with
// sign(NaN) = 0 as torch.sign gives.
//
// Design. One block per (feature, leaf), one thread per bin (the bin axis is
// never split: B <= 1024 here, and <= 256 for max_bin <= 255). A leaf's
// block does exactly what the one-leaf launch does, so each record is
// bit-equal to the one-leaf call. Three threads run
// the three channels' sequential prefixes into shared memory; every thread
// then computes both lanes' gains for its bin; a block reduction finds the
// first maximum (NaN counting as the largest, as torch.argmax does); thread 0
// writes the record.
//
// What bounds it. At HIGGS width (F = 28, B = 255) it reads 86 KB and
// writes 1.6 KB a leaf, and the sequential prefix is 255 dependent float64
// adds: a few microseconds of latency. One leaf is launch-bound; a wave's
// 42 leaves fill 1,176 blocks.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kFields = 14;
constexpr float kEpsilon = 1e-15f;  // K_EPSILON as float32

struct Params {
  float l1, l2, min_data, min_hess, min_gain, max_delta;
};

__device__ __forceinline__ float threshold_l1(float s, float l1) {
  const float sign = float(int(s > 0.f) - int(s < 0.f));
  float m = fabsf(s) - l1;
  if (m < 0.f) m = 0.f;
  return sign * m;
}

__device__ __forceinline__ float leaf_output(float sg, float sh, const Params& p) {
  const float num = -threshold_l1(sg, p.l1);
  float den = sh + p.l2;
  if (den < kEpsilon) den = kEpsilon;
  float out = num / den;
  if (p.max_delta > 0.f) {
    if (out < -p.max_delta) out = -p.max_delta;
    if (out > p.max_delta) out = p.max_delta;
  }
  return out;
}

__device__ __forceinline__ float leaf_gain(float sg, float sh, const Params& p) {
  const float out = leaf_output(sg, sh, p);
  const float g = threshold_l1(sg, p.l1);
  return -(2.0f * g * out + (sh + p.l2) * out * out);
}

// a beats b: larger, NaN largest, ties to the smaller index
__device__ __forceinline__ bool beats(float av, int ai, float bv, int bi) {
  const bool an = isnan(av), bn = isnan(bv);
  if (an != bn) return an;
  if (an || av == bv) return ai < bi;
  return av > bv;
}

__global__ void split_scan_kernel(const float* __restrict__ fh, int n_features, int n_bins,
                                  const float* __restrict__ totals,
                                  const float* __restrict__ params,
                                  const int* __restrict__ missing_pos,
                                  const uint8_t* __restrict__ has_missing,
                                  const int* __restrict__ nbins,
                                  const uint8_t* __restrict__ valid_slot,
                                  const uint8_t* __restrict__ is_categorical,
                                  const uint8_t* __restrict__ feature_mask,
                                  const float* __restrict__ penalty,
                                  float* __restrict__ rec) {
  extern __shared__ float smem[];
  const int B = n_bins;
  float* cum = smem;                                   // [3][B] lane-0 left sums
  float* gain = smem + 3 * B;                          // [2][B] lane-major
  float* red_v = smem + 5 * B;                         // [blockDim]
  int* red_i = reinterpret_cast<int*>(red_v + blockDim.x);
  __shared__ float miss[3];

  const int f = blockIdx.x;
  const long long leaf = blockIdx.y;
  const int t = threadIdx.x;
  const float* h = fh + (leaf * n_features + f) * B * 3;
  totals += leaf * 3;
  const int mpos = missing_pos[f];
  const bool hm = has_missing[f] != 0;
  const Params p{params[0], params[1], params[2], params[3], params[4], params[5]};
  const float tg = totals[0], th = totals[1], tc = totals[2];

  if (t < 3) {
    double acc = 0.0;
    for (int b = 0; b < B; ++b) {
      const float v = (hm && b == mpos) ? 0.0f : h[b * 3 + t];
      acc += double(v);
      cum[t * B + b] = float(acc);
    }
    miss[t] = hm ? h[mpos * 3 + t] : 0.0f;
  }
  __syncthreads();

  const bool gate = is_categorical[f] == 0 && (feature_mask == nullptr || feature_mask[f] != 0);
  const int nb = nbins[f];
  for (int b = t; b < B; b += blockDim.x) {
    const bool base_ok = gate && b < nb - 1 && valid_slot[(long long)f * B + b] != 0;
    for (int lane = 0; lane < 2; ++lane) {
      float lg = cum[b], lh = cum[B + b], lc = cum[2 * B + b];
      if (lane == 1) {
        lg = lg + miss[0];
        lh = lh + miss[1];
        lc = lc + miss[2];
      }
      const float rg = tg - lg, rh = th - lh, rc = tc - lc;
      const bool ok = base_ok && (lane == 0 || hm) && lc >= p.min_data && rc >= p.min_data
                      && lh >= p.min_hess && rh >= p.min_hess;
      const float g = leaf_gain(lg, lh, p) + leaf_gain(rg, rh, p);
      gain[lane * B + b] = ok ? g : -INFINITY;
    }
  }
  __syncthreads();

  // first maximum over the lane-major [2B] gains
  float bv = -INFINITY;
  int bi = 2 * B;
  for (int k = t; k < 2 * B; k += blockDim.x) {
    if (beats(gain[k], k, bv, bi)) {
      bv = gain[k];
      bi = k;
    }
  }
  red_v[t] = bv;
  red_i[t] = bi;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (t < s && beats(red_v[t + s], red_i[t + s], red_v[t], red_i[t])) {
      red_v[t] = red_v[t + s];
      red_i[t] = red_i[t + s];
    }
    __syncthreads();
  }
  if (t != 0) return;

  const int best = red_i[0];
  const int lane_b = best / B;
  const int t_b = best - lane_b * B;
  const float best_gain = gain[best];
  float lg = cum[t_b], lh = cum[B + t_b], lc = cum[2 * B + t_b];
  if (lane_b == 1) {
    lg = lg + miss[0];
    lh = lh + miss[1];
    lc = lc + miss[2];
  }
  const float rg = tg - lg, rh = th - lh, rc = tc - lc;
  const float gain_shift = leaf_gain(tg, th, p) + p.min_gain;
  const bool is_valid = isfinite(best_gain) && best_gain > gain_shift;
  float out_gain = is_valid ? best_gain - gain_shift : -INFINITY;
  if (penalty != nullptr) out_gain = is_valid ? out_gain - penalty[f] : -INFINITY;
  float* r = rec + (leaf * n_features + f) * kFields;
  r[0] = out_gain;
  r[1] = is_valid ? float(f) : -1.0f;
  r[2] = float(t_b);
  r[3] = float(lane_b);
  r[4] = lg;
  r[5] = lh;
  r[6] = lc;
  r[7] = rg;
  r[8] = rh;
  r[9] = rc;
  r[10] = leaf_output(lg, lh, p);
  r[11] = leaf_output(rg, rh, p);
  r[12] = 0.0f;
  r[13] = 0.0f;
}

}  // namespace

extern "C" {

// fh [L, F, B, 3] f32, totals [L, 3], params [6], missing_pos/nbins [F] int32,
// has_missing/is_categorical [F] and valid_slot [F, B] as bytes (torch.bool),
// feature_mask [F] bytes or NULL, penalty [F] f32 or NULL -> rec [L, F, 14]
// f32. Returns cudaGetLastError() after the launch.
int lgbt_split_scan(const float* fh, int n_leaves, int n_features, int n_bins,
                    const float* totals,
                    const float* params, const int* missing_pos,
                    const uint8_t* has_missing, const int* nbins,
                    const uint8_t* valid_slot, const uint8_t* is_categorical,
                    const uint8_t* feature_mask, const float* penalty, float* rec,
                    void* stream) {
  if (n_leaves < 1 || n_leaves > 65535 || n_features < 1 || n_bins < 1 || n_bins > 1024) {
    return int(cudaErrorInvalidValue);
  }
  int threads = 32;  // a power of two: the argmax reduction halves it
  while (threads < n_bins) threads *= 2;
  const size_t smem = sizeof(float) * (5 * size_t(n_bins) + threads) + sizeof(int) * threads;
  const dim3 grid(n_features, n_leaves);
  split_scan_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      fh, n_features, n_bins, totals, params, missing_pos, has_missing, nbins, valid_slot,
      is_categorical, feature_mask, penalty, rec);
  return int(cudaGetLastError());
}

}  // extern "C"
