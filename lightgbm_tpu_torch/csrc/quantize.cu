// Gradient discretizer for Hopper (sm_90a): quantized-gradient training's
// per-tree pass over every row, the JAX package's discretize_gradients
// (lightgbm_tpu/ops/quantize.py:45-75, which XLA computes) together with the
// packing of its result into the learners' extended gradient rows
// (lightgbm_tpu/treelearner/serial.py:_prepare_gh). It replaces no TPU
// kernel: on the TPU this is XLA glue.
//
// What it computes. From float32 grad [N] and hess [N] (any row stride), a
// tree's key pair (the gradient's and the hessian's threefry keys) and
// num_bins:
//   max_g = max(max|g|, 1e-35), max_h = max(max|h|, 1e-35), min_h = min h;
//   const_hess = (max_h - min_h) <= 1e-12 * max_h;
//   g_scale = max_g / (num_bins / 2), h_scale = const_hess ? max_h : max_h / num_bins;
//   inv_g = 1 / g_scale, inv_h = 1 / h_scale;
//   r_g, r_h = the float32 uniform draws of jax.random (threefry2x32, the
//     partitionable layout: the two words at counter (0, i) xored, the top 23
//     bits as a mantissa in [1, 2), minus one), or 0.5 under nearest rounding;
//   g_int = trunc(g >= 0 ? g * inv_g + r_g : g * inv_g - r_g);
//   h_int = const_hess ? 1 : trunc(h * inv_h + r_h);
// out [N+1, 3] int8: the rows (g_int, h_int, 1) and a zero sentinel row at N;
// scale [3] float32: (g_scale, h_scale, 1).
//
// Bit-identity. With the plain version (ops/quantize.py:_quantize_gh_plain)
// and the jitted JAX function: every float op is IEEE float32 in the JAX
// order, built with --fmad=false, and the two multiply-adds are explicit
// __fmaf_rn, because XLA on the CPU contracts them into fused multiply-adds.
// Max and min are order-free, so the reduction is deterministic however its
// blocks run. NaN propagates through the max and min as in jnp.max.
//
// Design. Two launches. (1) reduce: a grid-stride pass, each block's
// (max|g|, max|h|, min h) by warp shuffles and shared memory into one partial
// a block. (2) quantize: every block first reduces the partials (at most
// kMaxReduceBlocks) with one warp and derives the scales, the same in every
// block; then a grid-stride pass draws each row's two uniforms from its
// counter and writes its three bytes. Block 0 writes the scale vector and the
// sentinel row.
//
// What bounds it. Bytes: 8 bytes of (g, h) read by each pass and 3 written, 19
// bytes a row, ~20 MB at 1,048,576 rows. The quantize pass is bound by its
// instructions, not its bytes: in the stochastic mode its row loop issues
// 181 instructions a row (this build's SASS, perfmodel.row_loop_mix), most
// of them the two threefry draws and their uniforms. At 128 issued a clock
// an SM that is ~0.0057 ms at 1,048,576 rows; the 89 a row that only the
// integer ALU pipe runs (the draws' rotates and xors, 64 a clock) take
// ~0.0056 ms, the bytes ~0.0034 ms (perfmodel.quantize). The reduce pass is
// bound by its bytes.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxReduceBlocks = 256;
constexpr float kEps = 1e-35f;
constexpr unsigned kFull = 0xffffffffu;

struct Stats {
  float max_g, max_h, min_h;
};

// NaN-propagating max and min (jnp.max, torch.amax)
__device__ __forceinline__ float nan_max(float a, float b) { return (b > a || b != b) ? b : a; }
__device__ __forceinline__ float nan_min(float a, float b) { return (b < a || b != b) ? b : a; }

__device__ __forceinline__ Stats merge(Stats a, Stats b) {
  return Stats{nan_max(a.max_g, b.max_g), nan_max(a.max_h, b.max_h), nan_min(a.min_h, b.min_h)};
}

__device__ __forceinline__ Stats warp_merge(Stats s) {
  for (int o = 16; o > 0; o >>= 1) {
    const Stats t{__shfl_xor_sync(kFull, s.max_g, o), __shfl_xor_sync(kFull, s.max_h, o),
                  __shfl_xor_sync(kFull, s.min_h, o)};
    s = merge(s, t);
  }
  return s;
}

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) { return (x << r) | (x >> (32 - r)); }

__device__ __forceinline__ void mix4(uint32_t& x0, uint32_t& x1, int r0, int r1, int r2, int r3) {
  x0 += x1; x1 = rotl(x1, r0); x1 ^= x0;
  x0 += x1; x1 = rotl(x1, r1); x1 ^= x0;
  x0 += x1; x1 = rotl(x1, r2); x1 ^= x0;
  x0 += x1; x1 = rotl(x1, r3); x1 ^= x0;
}

// threefry2x32 (20 rounds) of key (k0, k1) at counter (0, i), its two words
// xored: jax.random.bits of row i
__device__ __forceinline__ uint32_t threefry_bits(uint32_t k0, uint32_t k1, uint32_t i) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  uint32_t x0 = k0, x1 = i + k1;
  mix4(x0, x1, 13, 15, 26, 6);
  x0 += k1; x1 += k2 + 1u;
  mix4(x0, x1, 17, 29, 16, 24);
  x0 += k2; x1 += k0 + 2u;
  mix4(x0, x1, 13, 15, 26, 6);
  x0 += k0; x1 += k1 + 3u;
  mix4(x0, x1, 17, 29, 16, 24);
  x0 += k1; x1 += k2 + 4u;
  mix4(x0, x1, 13, 15, 26, 6);
  x0 += k2; x1 += k0 + 5u;
  return x0 ^ x1;
}

__device__ __forceinline__ float uniform01(uint32_t bits) {
  return __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f);
}

__global__ void __launch_bounds__(kThreads)
quantize_reduce_kernel(const float* __restrict__ grad, long long g_stride,
                       const float* __restrict__ hess, long long h_stride, long long n,
                       float* __restrict__ partials) {
  __shared__ Stats warp_stats[kThreads / 32];
  Stats s{0.0f, 0.0f, INFINITY};
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const float h = hess[i * h_stride];
    s = merge(s, Stats{fabsf(grad[i * g_stride]), fabsf(h), h});
  }
  s = warp_merge(s);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) warp_stats[warp] = s;
  __syncthreads();
  if (warp == 0) {
    const int n_warps = blockDim.x >> 5;
    s = lane < n_warps ? warp_stats[lane] : Stats{0.0f, 0.0f, INFINITY};
    s = warp_merge(s);
    if (lane == 0) {
      partials[blockIdx.x * 3 + 0] = s.max_g;
      partials[blockIdx.x * 3 + 1] = s.max_h;
      partials[blockIdx.x * 3 + 2] = s.min_h;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
quantize_kernel(const float* __restrict__ grad, long long g_stride,
                const float* __restrict__ hess, long long h_stride, long long n,
                uint32_t kg0, uint32_t kg1, uint32_t kh0, uint32_t kh1, int num_bins,
                int stochastic, const float* __restrict__ partials, int n_partials,
                int8_t* __restrict__ out, float* __restrict__ scale) {
  __shared__ float sh[5];  // inv_g, inv_h, const_hess, g_scale, h_scale
  if (threadIdx.x < 32) {
    Stats s{0.0f, 0.0f, INFINITY};
    for (int b = threadIdx.x; b < n_partials; b += 32) {
      s = merge(s, Stats{partials[b * 3], partials[b * 3 + 1], partials[b * 3 + 2]});
    }
    s = warp_merge(s);
    if (threadIdx.x == 0) {
      const float max_g = nan_max(s.max_g, kEps);
      const float max_h = nan_max(s.max_h, kEps);
      const bool const_hess = __fsub_rn(max_h, s.min_h) <= __fmul_rn(1e-12f, max_h);
      const float g_scale = __fdiv_rn(max_g, float(num_bins / 2));
      const float h_scale = const_hess ? max_h : __fdiv_rn(max_h, float(num_bins));
      sh[0] = __fdiv_rn(1.0f, g_scale);
      sh[1] = __fdiv_rn(1.0f, h_scale);
      sh[2] = const_hess ? 1.0f : 0.0f;
      sh[3] = g_scale;
      sh[4] = h_scale;
    }
  }
  __syncthreads();
  const float inv_g = sh[0], inv_h = sh[1];
  const bool const_hess = sh[2] != 0.0f;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    scale[0] = sh[3];
    scale[1] = sh[4];
    scale[2] = 1.0f;
    out[n * 3] = 0;
    out[n * 3 + 1] = 0;
    out[n * 3 + 2] = 0;
  }
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const float g = grad[i * g_stride], h = hess[i * h_stride];
    float rg = 0.5f, rh = 0.5f;
    if (stochastic) {
      rg = uniform01(threefry_bits(kg0, kg1, uint32_t(i)));
      rh = uniform01(threefry_bits(kh0, kh1, uint32_t(i)));
    }
    const float gq = g >= 0.0f ? __fmaf_rn(g, inv_g, rg) : __fmaf_rn(g, inv_g, -rg);
    const int8_t gi = int8_t(__float2int_rz(gq));
    const int8_t hi = const_hess ? int8_t(1) : int8_t(__float2int_rz(__fmaf_rn(h, inv_h, rh)));
    out[i * 3] = gi;
    out[i * 3 + 1] = hi;
    out[i * 3 + 2] = 1;
  }
}

}  // namespace

extern "C" {

// grad, hess [n] float32 at row strides g_stride, h_stride (in floats);
// (kg0, kg1), (kh0, kh1) the gradient's and the hessian's keys (read only
// when stochastic != 0); partials the scratch of reduce_blocks x 3 floats
// (reduce_blocks in [1, 256]) -> out [n + 1, 3] int8, scale [3] float32.
// Returns cudaGetLastError() after each launch (the first error).
int lgbt_quantize(const float* grad, long long g_stride, const float* hess, long long h_stride,
                  long long n, unsigned kg0, unsigned kg1, unsigned kh0, unsigned kh1,
                  int num_bins, int stochastic, float* partials, int reduce_blocks,
                  int quantize_blocks, int8_t* out, float* scale, void* stream) {
  if (n < 1 || n >= (1LL << 32) || num_bins < 2 || reduce_blocks < 1
      || reduce_blocks > kMaxReduceBlocks || quantize_blocks < 1) {
    return int(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  quantize_reduce_kernel<<<reduce_blocks, kThreads, 0, s>>>(grad, g_stride, hess, h_stride, n,
                                                            partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  quantize_kernel<<<quantize_blocks, kThreads, 0, s>>>(grad, g_stride, hess, h_stride, n, kg0,
                                                       kg1, kh0, kh1, num_bins, stochastic,
                                                       partials, reduce_blocks, out, scale);
  return int(cudaGetLastError());
}

}  // extern "C"
