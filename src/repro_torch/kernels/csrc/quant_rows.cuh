// Activation quantizer shared by act_quant.cu, fused_prologue.cu and (the
// group body) fused_w4a4_lrc.cu, so the kernels' codes and scales are
// bitwise the same by construction.
//
// Numerics follow repro/kernels/rowops.py::scale_round_quantize exactly:
// amax = max |x| over the row (per token) or over each group of g
// contiguous values (group-wise), guarded (amax <= 0 -> 1); s = (clip *
// amax) / qmax; q = clamp(rint(x / s), -qmax - 1, qmax), with true IEEE
// multiplication and division (no FMA contraction, no reciprocal) and
// round-half-to-even.  A max is exact in any order, so the reductions below
// give the reference's amax whatever the thread count.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace quant_rows {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// Sixteen bytes of x as f32: 4 f32 or 8 bf16 values (p 16-byte aligned).
template <typename TX>
struct Vec16;

template <>
struct Vec16<float> {
  static constexpr int N = 4;
  __device__ static __forceinline__ void load(const float* p, float* v) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    v[0] = u.x, v[1] = u.y, v[2] = u.z, v[3] = u.w;
  }
};

template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static __forceinline__ void load(const __nv_bfloat16* p, float* v) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      v[2 * e] = __uint_as_float(w[e] << 16);
      v[2 * e + 1] = __uint_as_float(w[e] & 0xFFFF0000u);
    }
  }
};

// Quantizes one row of K values with the whole block: q[0..K) gets the
// codes and *s the scale.  `red` is NTHREADS/32 floats of shared memory.
// Every thread of the block must call it (it synchronises).  Where x is
// 16-byte aligned, K a multiple of Vec16<TX>::N and q aligned to it, the
// row is read 16 bytes a load and the codes stored N bytes at a time; the
// values and the order-free max are the same either way.
template <int NTHREADS, typename TX>
__device__ void quantize_row(const TX* __restrict__ x, int K,
                             int8_t* __restrict__ q, float* __restrict__ s,
                             int qmax, float clip_ratio, float* red) {
  constexpr int N = Vec16<TX>::N;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool vec = K % N == 0 && ((reinterpret_cast<uintptr_t>(x) & 15) |
                                  (reinterpret_cast<uintptr_t>(q) & (N - 1))) == 0;
  float a = 0.f;
  if (vec) {
#pragma unroll 4
    for (int i = tid; i < K / N; i += NTHREADS) {
      float v[N];
      Vec16<TX>::load(x + (size_t)i * N, v);
#pragma unroll
      for (int e = 0; e < N; ++e) a = fmaxf(a, fabsf(v[e]));
    }
  } else {
#pragma unroll 8
    for (int k = tid; k < K; k += NTHREADS) a = fmaxf(a, fabsf(to_f32(x[k])));
  }
  for (int off = 16; off > 0; off >>= 1)
    a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, off));
  if (lane == 0) red[warp] = a;
  __syncthreads();
  a = red[0];
#pragma unroll
  for (int w = 1; w < NTHREADS / 32; ++w) a = fmaxf(a, red[w]);
  if (a <= 0.f) a = 1.f;
  const float sc = __fdiv_rn(__fmul_rn(clip_ratio, a), (float)qmax);
  if (tid == 0) *s = sc;
  const float lo = (float)(-qmax - 1), hi = (float)qmax;
  if (vec) {
#pragma unroll 4
    for (int i = tid; i < K / N; i += NTHREADS) {
      float v[N];
      Vec16<TX>::load(x + (size_t)i * N, v);
      uint32_t w[N / 4] = {};
#pragma unroll
      for (int e = 0; e < N; ++e) {
        const int c = (int)fminf(fmaxf(rintf(__fdiv_rn(v[e], sc)), lo), hi);
        w[e / 4] |= (uint32_t)(uint8_t)(int8_t)c << (8 * (e % 4));
      }
      if (N == 8)
        *reinterpret_cast<uint2*>(q + (size_t)i * N) = make_uint2(w[0], w[N / 4 - 1]);
      else
        *reinterpret_cast<uint32_t*>(q + (size_t)i * N) = w[0];
    }
  } else {
#pragma unroll 8
    for (int k = tid; k < K; k += NTHREADS)
      q[k] = (int8_t)(int)fminf(fmaxf(rintf(__fdiv_rn(to_f32(x[k]), sc)), lo), hi);
  }
  __syncthreads();  // `red` may be reused by the caller
}

// Quantizes one group of g values with one warp (every lane must call it):
// q[0..g) gets the codes and *s the group's scale.
template <typename TX>
__device__ __forceinline__ void quantize_group(const TX* __restrict__ x, int g,
                                               int8_t* __restrict__ q,
                                               float* __restrict__ s, int qmax,
                                               float clip_ratio) {
  const int lane = threadIdx.x & 31;
  float a = 0.f;
  for (int k = lane; k < g; k += 32) a = fmaxf(a, fabsf(to_f32(x[k])));
  for (int off = 16; off > 0; off >>= 1)
    a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, off));
  if (a <= 0.f) a = 1.f;
  const float sc = __fdiv_rn(__fmul_rn(clip_ratio, a), (float)qmax);
  if (lane == 0) *s = sc;
  const float lo = (float)(-qmax - 1), hi = (float)qmax;
  for (int k = lane; k < g; k += 32)
    q[k] = (int8_t)(int)fminf(fmaxf(rintf(__fdiv_rn(to_f32(x[k]), sc)), lo), hi);
}

// Quantizes one row of K values in groups of g (g divides K) with the whole
// block, one warp per group at a time: q[0..K) gets the codes and s[0..K/g)
// the scale plane's row.  No barrier: the caller synchronises if it reuses
// what it wrote.
template <int NTHREADS, typename TX>
__device__ void quantize_row_grouped(const TX* __restrict__ x, int K, int g,
                                     int8_t* __restrict__ q, float* __restrict__ s,
                                     int qmax, float clip_ratio) {
  for (int grp = threadIdx.x >> 5; grp < K / g; grp += NTHREADS / 32)
    quantize_group(x + (size_t)grp * g, g, q + (size_t)grp * g, s + grp, qmax,
                   clip_ratio);
}

}  // namespace quant_rows
