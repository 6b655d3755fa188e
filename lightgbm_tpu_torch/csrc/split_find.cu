// Split search for Hopper (sm_90a): the port of the TPU kernel
// lightgbm_tpu/ops/scan_pallas.py:fused_split_scan (kernel _make_scan_kernel,
// operands built by per_feature_best_fused), together with the PyTorch glue
// around it on the port's main path: the feature gather, the EFB default-bin
// fix and the argmax across features (ops/split.py:find_best_split).
//
// What it computes. For L leaves, each leaf's best numeric split as the
// 14-field record of ops/split.py:SPLIT_FIELDS, in one launch (a wave's 2K
// children, where the JAX package vmaps find_best_split; L = 1 is one leaf,
// the serial learner's call). Two forms of one kernel:
//   - find (kGather): from the group histogram [L, rows, 3] (rows = G * Bg),
//     gather each feature's bins through gather_index [F, B] (a row index
//     past the histogram is the all-zero sentinel), multiply by valid_slot,
//     add the leaf's missing mass at the default bin of an EFB bundle member
//     (totals - sum of the feature's bins, times efb_omitted, as
//     FixHistogram does), scan, and keep the first maximum across features:
//     rec [L, 14]. The histogram is float32, or int32 (quantized-gradient
//     training) with a per-channel scale [3] read from device memory, so a
//     captured graph reads each tree's scale: each int32 value is converted
//     to float32 and multiplied by its scale as it is loaded, before the
//     sums (the JAX package's hist.astype(f32) * scale ahead of the scan,
//     treelearner/device.py:301-304);
//   - per feature (!kGather): from feature histograms fh [L, F, B, 3], the
//     record of every (leaf, feature): rec [L, F, 14]
//     (ops/split.py:per_feature_best).
// Per feature: the missing bin (the NaN bin, or the zero bin for
// MissingType::Zero) is taken out of the ordered scan; the prefix over bins
// gives the left sums of lane 0 (missing goes right), lane 1 adds the missing
// bin to the left; the min-data / min-hessian / "one real bin on the right" /
// valid-slot / numeric-and-sampled gates; the L1/L2/max_delta_step gains of
// both children; the first maximum over lane 0's thresholds then lane 1's;
// the record is valid when its gain beats the parent's gain + min_gain.
//
// The constrained mode (kMono; the monotone lane that the JAX package runs in
// XLA beside its Pallas scan, lightgbm_tpu/ops/split.py:359-364, 402-411,
// 442-444): the leaf's basic-mode output bounds (lo, hi) come by value, as
// the host totals do. Each candidate's two outputs are clamped into them
// (max with lo, then min with hi, as jnp.clip), a split on a feature whose
// monotone direction (+1 / -1, the monotone vector [F] int8) its clamped
// outputs go against is no candidate, the gain is computed from the clamped
// outputs, and the record's outputs are clamped. The gain shift stays the
// unconstrained parent's. One leaf a launch (the serial learner's).
//
// Bit-identity with the plain version (ops/split.py, run on the CPU). The two
// sums over a feature's bins are float64 in a fixed order that the plain
// version emulates (ops/split.py:bin_sum, bin_prefix): lane j of the warp
// owns the P = ceil(B / 32) consecutive bins [jP, jP + P) (zero past B); it
// sums them in ascending order from +0.0; a Kogge-Stone scan over the 32
// lane sums (offsets 1, 2, 4, 8, 16) gives the inclusive sums; the EFB sum is
// lane 31's; the prefix of bin jP + i starts from lane j - 1's inclusive sum
// (+0.0 for lane 0) and adds the lane's bins in order, rounding each prefix
// to float32. All other arithmetic is float32 in the plain version's op
// order, built with --fmad=false (no multiply-add contracted into an FMA) and
// without fast math; threshold_l1 keeps sign(s) * max(|s| - l1, 0) with
// sign(NaN) = 0, and an argmax takes the first maximum with NaN largest, as
// torch.argmax does.
//
// Design. A block per leaf, a warp per feature (W = min(F, 32) warps, fewer
// when the bins do not fit; each warp loops over features f = w, w + W,
// ...). The warp loads the feature's metadata at once and its bins a few a
// lane at a time, every gather index before every value, so the loads of
// a batch overlap, into its own shared-memory slice
// (three channels of 32 * P floats, bank-skewed so the lanes' chunk reads
// hit 32 banks), applies the EFB fix, takes the missing bin, writes the
// prefix in place, computes both lanes' gains for bins lane, lane + 32, ...,
// and reduces with shuffles. The find form keeps the warp's best record in
// registers and ends with one reduction across the block's warps; only the
// record leaves the chip.
//
// What bounds it. Bytes: a leaf reads its features' bins (F * B * 12 bytes,
// 86 KB at HIGGS width, F = 28, B = 255) and the gather table, and writes 56
// bytes; a wave's 42 children read ~3.6 MB, ~1.1 us at 3.35 TB/s. One leaf is
// bound by latency: a launch, a gather from device memory and two short
// chains of float64 adds (8 + 5 + 8 at B = 255) per channel.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kFields = 14;
constexpr int kMaxWarps = 32;
constexpr int kSmemBudget = 160 * 1024;  // dynamic shared memory a block (opted in)
constexpr int kLoadBatch = 4;            // bins a lane loads at once
constexpr float kEpsilon = 1e-15f;      // K_EPSILON as float32
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  float l1, l2, min_data, min_hess, min_gain, max_delta;
};

struct Meta {
  const long long* gather_index;  // [F, B] (find form)
  const uint8_t* valid_slot;      // [F, B]
  const long long* default_bin;   // [F] (find form)
  const uint8_t* efb_omitted;     // [F] (find form)
  const int* missing_pos;         // [F]
  const uint8_t* has_missing;     // [F]
  const int* nbins;               // [F]
  const uint8_t* is_categorical;  // [F]
  const int8_t* monotone;         // [F] (constrained mode)
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

__device__ __forceinline__ float gain_given_output(float sg, float sh, float out,
                                                   const Params& p) {
  const float g = threshold_l1(sg, p.l1);
  return -(2.0f * g * out + (sh + p.l2) * out * out);
}

__device__ __forceinline__ float leaf_gain(float sg, float sh, const Params& p) {
  return gain_given_output(sg, sh, leaf_output(sg, sh, p), p);
}

// jnp.clip(x, lo, hi): the larger of x and lo, then the smaller of that and
// hi; a NaN stays NaN
__device__ __forceinline__ float clip_output(float x, float lo, float hi) {
  const float y = x < lo ? lo : x;
  return y > hi ? hi : y;
}

// a beats b: larger, NaN largest, ties to the smaller index
__device__ __forceinline__ bool beats(float av, int ai, float bv, int bi) {
  const bool an = isnan(av), bn = isnan(bv);
  if (an != bn) return an;
  if (an || av == bv) return ai < bi;
  return av > bv;
}

// shared-memory slot of bin b: one skip every 32 bins, so lane j reading bin
// jP + i hits bank (jP + i + (jP + i) / 32) % 32, distinct across the lanes
__device__ __forceinline__ int skew(int b) { return b + (b >> 5); }

// the lane's chunk sum, then the inclusive Kogge-Stone scan of those sums
__device__ __forceinline__ double lane_scan(const float* x, int lane, int chunk) {
  double s = 0.0;
  for (int i = 0; i < chunk; ++i) s += double(x[skew(lane * chunk + i)]);
  for (int d = 1; d < 32; d <<= 1) {
    const double up = __shfl_up_sync(kFull, s, d);
    if (lane >= d) s = up + s;
  }
  return s;
}

// kInt (find form only): src is an int32 histogram, each value converted to
// float32 and multiplied by its channel's scale as it is loaded, before any
// sum: the plain version's hist.float() * scale. kMono: the constrained mode,
// with the output bounds (c_lo, c_hi).
template <bool kGather, bool kInt, bool kMono>
__global__ void __launch_bounds__(kMaxWarps * 32)
split_kernel(const void* __restrict__ src, long long src_rows, int n_features, int n_bins,
             int chunk, const float* __restrict__ totals, float t0, float t1, float t2,
             const float* __restrict__ params, const float* __restrict__ scale, Meta m,
             const uint8_t* __restrict__ feature_mask, const float* __restrict__ penalty,
             float c_lo, float c_hi, float* __restrict__ rec) {
  extern __shared__ float smem[];
  __shared__ float best_rec[kMaxWarps][kFields];
  __shared__ float best_gain[kMaxWarps];
  __shared__ int best_feature[kMaxWarps];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  const int B = n_bins, P = chunk;
  const int stride = skew(32 * P - 1) + 1;  // floats a channel
  float* x = smem + warp * 3 * stride;
  const long long leaf = blockIdx.x;
  float tot[3] = {t0, t1, t2};
  if (totals != nullptr) {
    for (int c = 0; c < 3; ++c) tot[c] = totals[leaf * 3 + c];
  }
  const Params p{params[0], params[1], params[2], params[3], params[4], params[5]};
  float sc[3] = {1.0f, 1.0f, 1.0f};
  if (kInt) {
    for (int c = 0; c < 3; ++c) sc[c] = scale[c];
  }
  const float gain_shift = leaf_gain(tot[0], tot[1], p) + p.min_gain;

  float wgain = -INFINITY;  // the warp's best record so far (find form)
  int wfeature = INT_MAX;
  float wrec[kFields];
  for (int i = 0; i < kFields; ++i) wrec[i] = 0.0f;

  for (int f = warp; f < n_features; f += n_warps) {
    // ---- the feature's metadata, loaded together
    const bool hm = m.has_missing[f] != 0;
    const int mpos = m.missing_pos[f];
    const int nb = m.nbins[f];
    const bool gate = m.is_categorical[f] == 0 && (feature_mask == nullptr || feature_mask[f] != 0);
    const float pen = penalty != nullptr ? penalty[f] : 0.0f;
    const float efb = kGather && m.efb_omitted[f] ? 1.0f : 0.0f;
    const int db = kGather ? int(m.default_bin[f]) : 0;
    const int mono = kMono ? int(m.monotone[f]) : 0;

    // ---- the feature's bins into shared memory (zero past B): lane j takes
    // bins j, j + 32, ...; kLoadBatch of them at a time, every index
    // loaded, then every value, so the loads overlap
    unsigned valid_bits = 0;  // bit i: bin lane + 32 i is a valid slot
    for (int i0 = 0; i0 < P; i0 += kLoadBatch) {
      long long r[kLoadBatch];
      float keep[kLoadBatch];
#pragma unroll
      for (int i = 0; i < kLoadBatch; ++i) {
        const int b = lane + 32 * (i0 + i);
        const long long at = (long long)f * B + b;
        const bool in = i0 + i < P && b < B;
        r[i] = in ? (kGather ? m.gather_index[at] : (leaf * n_features + f) * B + b) : -1;
        keep[i] = in && m.valid_slot[at] ? 1.0f : 0.0f;
      }
      float h[kLoadBatch][3];
#pragma unroll
      for (int i = 0; i < kLoadBatch; ++i) {
        const bool in = r[i] >= 0 && (!kGather || r[i] < src_rows);
        const long long at = ((kGather ? leaf * src_rows : 0) + (in ? r[i] : 0)) * 3;
        if (kInt) {
          const int* row = static_cast<const int*>(src) + at;
          for (int c = 0; c < 3; ++c) {
            h[i][c] = in ? __fmul_rn(__int2float_rn(row[c]), sc[c]) : 0.0f;
          }
        } else {
          const float* row = static_cast<const float*>(src) + at;
          for (int c = 0; c < 3; ++c) h[i][c] = in ? row[c] : 0.0f;
        }
      }
#pragma unroll
      for (int i = 0; i < kLoadBatch; ++i) {
        if (i0 + i >= P) break;
        const int b = lane + 32 * (i0 + i);
        if (keep[i] != 0.0f) valid_bits |= 1u << (i0 + i);
        // the find form multiplies by the valid slot as the plain gather
        // does (x * 0.0 keeps a sign and a NaN)
        for (int c = 0; c < 3; ++c) x[c * stride + skew(b)] = kGather ? h[i][c] * keep[i] : h[i][c];
      }
    }
    __syncwarp();

    // ---- EFB: the leaf's mass outside the stored bins, at the default bin
    if (kGather) {
      double sum[3];
      for (int c = 0; c < 3; ++c) {
        sum[c] = __shfl_sync(kFull, lane_scan(x + c * stride, lane, P), 31);
      }
      __syncwarp();
      if (lane == 0) {
        for (int c = 0; c < 3; ++c) {
          const float add = (tot[c] - float(sum[c])) * efb;
          x[c * stride + skew(db)] = x[c * stride + skew(db)] + add;
        }
      }
      __syncwarp();
    }

    // ---- the missing bin, out of the ordered scan
    float miss[3] = {0.0f, 0.0f, 0.0f};
    if (hm) {
      for (int c = 0; c < 3; ++c) miss[c] = x[c * stride + skew(mpos)];
    }
    __syncwarp();
    if (hm && lane == 0) {
      for (int c = 0; c < 3; ++c) x[c * stride + skew(mpos)] = 0.0f;
    }
    __syncwarp();

    // ---- the prefix over bins, in place (each lane rewrites its own chunk)
    for (int c = 0; c < 3; ++c) {
      float* xc = x + c * stride;
      double acc = __shfl_up_sync(kFull, lane_scan(xc, lane, P), 1);
      if (lane == 0) acc = 0.0;
      for (int i = 0; i < P; ++i) {
        const int s = skew(lane * P + i);
        acc += double(xc[s]);
        xc[s] = float(acc);
      }
    }
    __syncwarp();

    // ---- both lanes' gains, first maximum over the lane-major [2B]
    float bv = -INFINITY;
    int bi = 2 * B;
    for (int b = lane; b < B; b += 32) {
      const bool base_ok = gate && b < nb - 1 && ((valid_bits >> ((b - lane) >> 5)) & 1u);
      const float cg = x[skew(b)], ch = x[stride + skew(b)], cc = x[2 * stride + skew(b)];
      for (int side = 0; side < 2; ++side) {
        float lg = cg, lh = ch, lc = cc;
        if (side == 1) {
          lg = lg + miss[0];
          lh = lh + miss[1];
          lc = lc + miss[2];
        }
        const float rg = tot[0] - lg, rh = tot[1] - lh, rc = tot[2] - lc;
        bool ok = base_ok && (side == 0 || hm) && lc >= p.min_data && rc >= p.min_data
                  && lh >= p.min_hess && rh >= p.min_hess;
        float g;
        if (kMono) {
          const float lo_ = clip_output(leaf_output(lg, lh, p), c_lo, c_hi);
          const float ro_ = clip_output(leaf_output(rg, rh, p), c_lo, c_hi);
          ok = ok && !((mono > 0 && lo_ > ro_) || (mono < 0 && lo_ < ro_));
          g = gain_given_output(lg, lh, lo_, p) + gain_given_output(rg, rh, ro_, p);
        } else {
          g = leaf_gain(lg, lh, p) + leaf_gain(rg, rh, p);
        }
        const float gv = ok ? g : -INFINITY;
        const int k = side * B + b;
        if (beats(gv, k, bv, bi)) {
          bv = gv;
          bi = k;
        }
      }
    }
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(kFull, bv, o);
      const int oi = __shfl_xor_sync(kFull, bi, o);
      if (beats(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }

    // ---- the feature's record (every lane holds the same)
    const int side = bi / B;
    const int t_b = bi - side * B;
    float lg = x[skew(t_b)], lh = x[stride + skew(t_b)], lc = x[2 * stride + skew(t_b)];
    if (side == 1) {
      lg = lg + miss[0];
      lh = lh + miss[1];
      lc = lc + miss[2];
    }
    const float rg = tot[0] - lg, rh = tot[1] - lh, rc = tot[2] - lc;
    const bool is_valid = isfinite(bv) && bv > gain_shift;
    float out_gain = is_valid ? bv - gain_shift : -INFINITY;
    if (penalty != nullptr) out_gain = is_valid ? out_gain - pen : -INFINITY;
    float r[kFields];
    r[0] = out_gain;
    r[1] = is_valid ? float(f) : -1.0f;
    r[2] = float(t_b);
    r[3] = float(side);
    r[4] = lg;
    r[5] = lh;
    r[6] = lc;
    r[7] = rg;
    r[8] = rh;
    r[9] = rc;
    r[10] = leaf_output(lg, lh, p);
    r[11] = leaf_output(rg, rh, p);
    if (kMono) {
      r[10] = clip_output(r[10], c_lo, c_hi);
      r[11] = clip_output(r[11], c_lo, c_hi);
    }
    r[12] = 0.0f;
    r[13] = 0.0f;
    if (kGather) {
      if (beats(out_gain, f, wgain, wfeature)) {
        wgain = out_gain;
        wfeature = f;
        for (int i = 0; i < kFields; ++i) wrec[i] = r[i];
      }
    } else if (lane < kFields) {
      float v = r[0];
      for (int i = 1; i < kFields; ++i) v = lane == i ? r[i] : v;
      rec[(leaf * n_features + f) * kFields + lane] = v;
    }
    __syncwarp();  // the next feature overwrites this warp's bins
  }

  if (!kGather) return;
  // ---- the first maximum across the block's warps
  if (lane == 0) {
    best_gain[warp] = wgain;
    best_feature[warp] = wfeature;
    for (int i = 0; i < kFields; ++i) best_rec[warp][i] = wrec[i];
  }
  __syncthreads();
  if (threadIdx.x < kFields) {
    int w = 0;
    for (int o = 1; o < n_warps; ++o) {
      if (beats(best_gain[o], best_feature[o], best_gain[w], best_feature[w])) w = o;
    }
    rec[leaf * kFields + threadIdx.x] = best_rec[w][threadIdx.x];
  }
}

// warps a block and dynamic shared memory for B bins
int launch_shape(int n_features, int n_bins, int* chunk, size_t* smem) {
  *chunk = (n_bins + 31) / 32;
  const int stride = (32 * *chunk - 1) + ((32 * *chunk - 1) >> 5) + 1;
  const size_t per_warp = sizeof(float) * 3 * size_t(stride);
  int warps = n_features < kMaxWarps ? n_features : kMaxWarps;
  while (warps > 1 && per_warp * warps > size_t(kSmemBudget)) --warps;
  *smem = per_warp * warps;
  return warps;
}

}  // namespace

extern "C" {

// The find form: hist [L, rows, 3] f32 (rows = G * Bg), or int32 with scale
// [3] f32 (NULL for a float histogram), totals [L, 3] f32 or NULL for (t0,
// t1, t2) (L = 1), params [6]; gather_index [F, B] and default_bin [F] int64,
// valid_slot [F, B], efb_omitted / has_missing / is_categorical [F] as bytes
// (torch.bool), missing_pos / nbins [F] int32, feature_mask [F] bytes or
// NULL, penalty [F] f32 or NULL -> rec [L, 14]. The per-feature form
// (gather_index NULL, scale NULL): fh [L, F, B, 3] f32 -> rec [L, F, 14].
// monotone [F] int8 selects the constrained mode with the bounds (c_lo,
// c_hi), one leaf only (NULL: unconstrained).
// Returns cudaGetLastError() after the launch.
int lgbt_split_find(const void* src, long long src_rows, int n_leaves, int n_features,
                    int n_bins, const float* totals, float t0, float t1, float t2,
                    const float* params, const float* scale, const long long* gather_index,
                    const uint8_t* valid_slot, const long long* default_bin,
                    const uint8_t* efb_omitted, const int* missing_pos,
                    const uint8_t* has_missing, const int* nbins,
                    const uint8_t* is_categorical, const uint8_t* feature_mask,
                    const float* penalty, const int8_t* monotone, float c_lo, float c_hi,
                    float* rec, void* stream) {
  if (n_leaves < 1 || n_features < 1 || n_bins < 1 || n_bins > 1024
      || (scale != nullptr && gather_index == nullptr)
      || (monotone != nullptr && n_leaves != 1)) {
    return int(cudaErrorInvalidValue);
  }
  int chunk;
  size_t smem;
  const int warps = launch_shape(n_features, n_bins, &chunk, &smem);
  const Meta m{gather_index, valid_slot, default_bin, efb_omitted, missing_pos,
               has_missing, nbins, is_categorical, monotone};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  static bool opted_in = false;  // above 48 KB a block asks for its shared memory
  if (!opted_in) {
    const void* kernels[] = {
        (const void*)split_kernel<true, false, false>, (const void*)split_kernel<true, true, false>,
        (const void*)split_kernel<false, false, false>, (const void*)split_kernel<true, false, true>,
        (const void*)split_kernel<true, true, true>, (const void*)split_kernel<false, false, true>};
    for (const void* k : kernels) {
      cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBudget);
    }
    opted_in = true;
  }
  const dim3 grid(n_leaves), block(warps * 32);
#define LGBT_SPLIT_LAUNCH(G, I, M)                                                         \
  split_kernel<G, I, M><<<grid, block, smem, s>>>(src, src_rows, n_features, n_bins, chunk, \
                                                  totals, t0, t1, t2, params, scale, m,     \
                                                  feature_mask, penalty, c_lo, c_hi, rec)
  const bool mono = monotone != nullptr;
  if (scale != nullptr) {
    if (mono) LGBT_SPLIT_LAUNCH(true, true, true); else LGBT_SPLIT_LAUNCH(true, true, false);
  } else if (gather_index != nullptr) {
    if (mono) LGBT_SPLIT_LAUNCH(true, false, true); else LGBT_SPLIT_LAUNCH(true, false, false);
  } else {
    if (mono) LGBT_SPLIT_LAUNCH(false, false, true); else LGBT_SPLIT_LAUNCH(false, false, false);
  }
#undef LGBT_SPLIT_LAUNCH
  return int(cudaGetLastError());
}

}  // extern "C"
