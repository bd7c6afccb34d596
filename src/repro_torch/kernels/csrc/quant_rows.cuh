// Activation quantizer shared by act_quant.cu, fused_prologue.cu and (the
// group body) fused_w4a4_lrc.cu, so the kernels' codes and scales are
// bitwise the same by construction.  quantize_row, quantize_group and
// quantize_row_grouped are #1's and #3's bodies; quantize_held and
// quantize_staged (at the end) are act_quant.cu's, which compute the same
// formulas through scale_of and code_of.
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

// The scale of a row or group from its amax: guarded (amax <= 0 -> 1), then
// (clip * amax) / qmax with true IEEE multiply and divide.
__device__ __forceinline__ float scale_of(float amax, float clip_ratio, int qmax) {
  if (amax <= 0.f) amax = 1.f;
  return __fdiv_rn(__fmul_rn(clip_ratio, amax), (float)qmax);
}

// The code of v at scale s: clamp(rint(v / s), lo, hi), lo = -qmax - 1 and
// hi = qmax, the division true IEEE, the rounding half to even.
__device__ __forceinline__ int8_t code_of(float v, float s, float lo, float hi) {
  return (int8_t)(int)fminf(fmaxf(rintf(__fdiv_rn(v, s)), lo), hi);
}

// A thread's unit of a row: N values, held as loaded (Raw) until used.
// VEC: one 16-byte load (8 bf16 or 4 f32; x 16-byte aligned, the codes
// N-byte aligned) and N codes stored at once; otherwise one value and one
// code (the element-wise reader).
template <typename TX, bool VEC>
struct Units;

template <typename TX>
struct Units<TX, true> {
  static constexpr int N = Vec16<TX>::N;
  using Raw = uint4;
  __device__ static __forceinline__ Raw load(const TX* x, int i) {
    return *reinterpret_cast<const uint4*>(x + (size_t)i * N);
  }
  __device__ static __forceinline__ void unpack(const Raw& r, float* v) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if constexpr (N == 8) {  // as Vec16<__nv_bfloat16>::load
        v[2 * e] = __uint_as_float(w[e] << 16);
        v[2 * e + 1] = __uint_as_float(w[e] & 0xFFFF0000u);
      } else {
        v[e] = __uint_as_float(w[e]);
      }
    }
  }
  __device__ static __forceinline__ void store(int8_t* q, int i, const float* v, float s,
                                               float lo, float hi) {
    uint32_t w[N / 4] = {};
#pragma unroll
    for (int e = 0; e < N; ++e)
      w[e / 4] |= (uint32_t)(uint8_t)code_of(v[e], s, lo, hi) << (8 * (e % 4));
    if constexpr (N == 8)
      *reinterpret_cast<uint2*>(q + (size_t)i * N) = make_uint2(w[0], w[N / 4 - 1]);
    else
      *reinterpret_cast<uint32_t*>(q + (size_t)i * N) = w[0];
  }
};

template <typename TX>
struct Units<TX, false> {
  static constexpr int N = 1;
  using Raw = TX;
  __device__ static __forceinline__ Raw load(const TX* x, int i) { return x[i]; }
  __device__ static __forceinline__ void unpack(const Raw& r, float* v) { v[0] = to_f32(r); }
  __device__ static __forceinline__ void store(int8_t* q, int i, const float* v, float s,
                                               float lo, float hi) {
    q[i] = code_of(v[0], s, lo, hi);
  }
};

// Quantizes one row of `width` values (x) into q and *s with the tpr
// threads that share it (tpr a power of two; tpr <= 32: a lane segment of
// one warp, several rows a warp; tpr > 32: the whole block, one row).
// Thread t = threadIdx.x % tpr holds the units t, t + tpr, ... (at most C)
// as loaded: every load is issued before the first value is used, the
// row's amax is reduced from the held values by __shfl_xor_sync within the
// segment (and through `red`, blockDim.x / 32 floats of shared memory,
// across the block's warps), and the codes are computed from the same
// registers: x is read once.  `live` false (a row past M) loads and stores
// nothing but takes part in the reduction.  Every thread of the block must
// call it.
template <typename TX, bool VEC, int C>
__device__ __forceinline__ void quantize_held(const TX* __restrict__ x, int width,
                                              int8_t* __restrict__ q, float* __restrict__ s,
                                              bool live, int tpr, int qmax, float clip_ratio,
                                              float* red) {
  using U = Units<TX, VEC>;
  constexpr int N = U::N;
  const int units = width / N;
  const int t = threadIdx.x & (tpr - 1);
  typename U::Raw raw[C];
#pragma unroll
  for (int j = 0; j < C; ++j)
    if (live && t + j * tpr < units) raw[j] = U::load(x, t + j * tpr);
  float a = 0.f;
#pragma unroll
  for (int j = 0; j < C; ++j)
    if (live && t + j * tpr < units) {
      float v[N];
      U::unpack(raw[j], v);
#pragma unroll
      for (int e = 0; e < N; ++e) a = fmaxf(a, fabsf(v[e]));
    }
  for (int off = min(tpr, 32) >> 1; off > 0; off >>= 1)
    a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, off));
  if (tpr > 32) {
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = a;
    __syncthreads();
    a = red[0];
    for (int w = 1; w < tpr / 32; ++w) a = fmaxf(a, red[w]);
  }
  const float sc = scale_of(a, clip_ratio, qmax);
  if (live && t == 0) *s = sc;
  const float lo = (float)(-qmax - 1), hi = (float)qmax;
#pragma unroll
  for (int j = 0; j < C; ++j)
    if (live && t + j * tpr < units) {
      float v[N];
      U::unpack(raw[j], v);
      U::store(q, t + j * tpr, v, sc, lo, hi);
    }
}

// Quantizes one row too wide for the block's registers with the whole
// block: the row is read once, its values kept in `row_s` (width floats of
// shared memory) while the amax is taken, and the codes computed from
// there; each thread reads back only what it wrote.  `red` as above.
template <typename TX, bool VEC>
__device__ void quantize_staged(const TX* __restrict__ x, int width, int8_t* __restrict__ q,
                                float* __restrict__ s, int qmax, float clip_ratio,
                                float* row_s, float* red) {
  using U = Units<TX, VEC>;
  constexpr int N = U::N;
  const int units = width / N;
  float a = 0.f;
#pragma unroll 4
  for (int i = threadIdx.x; i < units; i += blockDim.x) {
    float v[N];
    U::unpack(U::load(x, i), v);
#pragma unroll
    for (int e = 0; e < N; ++e) {
      a = fmaxf(a, fabsf(v[e]));
      row_s[i * N + e] = v[e];
    }
  }
  for (int off = 16; off > 0; off >>= 1)
    a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, off));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = a;
  __syncthreads();
  a = red[0];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w) a = fmaxf(a, red[w]);
  const float sc = scale_of(a, clip_ratio, qmax);
  if (threadIdx.x == 0) *s = sc;
  const float lo = (float)(-qmax - 1), hi = (float)qmax;
#pragma unroll 4
  for (int i = threadIdx.x; i < units; i += blockDim.x) {
    float v[N];
#pragma unroll
    for (int e = 0; e < N; ++e) v[e] = row_s[i * N + e];
    U::store(q, i, v, sc, lo, hi);
  }
}

}  // namespace quant_rows
