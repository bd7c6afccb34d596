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

// Quantizes one row of K values with the whole block: q[0..K) gets the
// codes and *s the scale.  `red` is NTHREADS/32 floats of shared memory.
// Every thread of the block must call it (it synchronises).
template <int NTHREADS, typename TX>
__device__ void quantize_row(const TX* __restrict__ x, int K,
                             int8_t* __restrict__ q, float* __restrict__ s,
                             int qmax, float clip_ratio, float* red) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float a = 0.f;
#pragma unroll 8
  for (int k = tid; k < K; k += NTHREADS) a = fmaxf(a, fabsf(to_f32(x[k])));
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
#pragma unroll 8
  for (int k = tid; k < K; k += NTHREADS)
    q[k] = (int8_t)(int)fminf(fmaxf(rintf(__fdiv_rn(to_f32(x[k]), sc)), lo), hi);
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
