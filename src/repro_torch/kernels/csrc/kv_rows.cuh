// K/V row readers shared by the attention kernels (paged_attention.cuh,
// flash_attention.cuh): element i of K or V row `row` as f32, where a row
// is one (token, kv head) of a (…, KH, D | D/2) tensor, so row r starts at
// element r·width (int4: r·width/2 bytes).  The paged kernels index rows
// of the page pool ((pid·P + t)·KH + kh); the dense kernels rows of a
// (B, S, KH, ·) view ((b·S + s)·KH + kh).
//
// A quantized row dequantizes element by element as ONE f32 multiply
// float(code) · scale[group] (__fmul_rn is never contracted), bitwise
// rowops.dequant_rows_grouped and serve/kvquant.dequantize_kv.
//
// Besides the element reader, each reader loads a packet: N elements of
// one row from element i by ONE aligned load of 4 or 16 bytes (f32: 1
// element a 32-bit word, bf16: 2, int8: 4, int4: 8), with the scale of
// their group for codes (the N codes lie in one group).  `packet` issues
// the load and `elem` converts element j of a packet (j a constant); the
// codes' `vec` does both.  Each element comes out bitwise as operator()
// gives it.  The dense quantized kernel stages codes by `vec` a 32-bit
// word at a time; the paged kernels read whole 16-byte packets.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace kv {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
// round to nearest even, as torch's .to(torch.bfloat16)
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// The integer u - bias as f32, exactly, for u < 2²³: u in the low bits of
// 2²³, minus 2²³ + bias (a logic op and an add, where an int-to-float
// conversion issues at a quarter of the f32 rate).  A code's value is the
// same as static_cast<float> gives.
__device__ __forceinline__ float small_int(uint32_t u, float bias) {
  return __fsub_rn(__uint_as_float(0x4B000000u | u), 8388608.f + bias);
}

// W 32-bit words read by one aligned load, and the scale of their group
// (1 for float rows).
template <int W>
struct Packet {
  uint32_t w[W];
  float scale;
};

template <int W>
__device__ __forceinline__ void load_words(const void* p, uint32_t (&w)[W]) {
  if constexpr (W == 1) {
    w[0] = *static_cast<const uint32_t*>(p);
  } else {
    static_assert(W == 4, "a packet is one load of 4 or 16 bytes");
    const uint4 v = *static_cast<const uint4*>(p);
    w[0] = v.x;
    w[1] = v.y;
    w[2] = v.z;
    w[3] = v.w;
  }
}

// f32 or bf16 rows of `width` (D or Dv) elements.
template <typename T>
struct FloatRows {
  static constexpr int PER_WORD = 4 / static_cast<int>(sizeof(T));
  template <int N>
  using Pack = Packet<N / PER_WORD>;
  const T* data;
  int width;
  __device__ __forceinline__ float operator()(int64_t row, int i) const {
    return to_f32(data[row * width + i]);
  }
  template <int N>
  __device__ __forceinline__ Pack<N> packet(int64_t row, int i) const {
    Pack<N> p;
    load_words(data + row * width + i, p.w);
    p.scale = 1.f;
    return p;
  }
  // a bf16 is the high half of its f32: the low half of a word is the
  // even element
  template <int N>
  __device__ __forceinline__ static float elem(const Pack<N>& p, int j) {
    if constexpr (PER_WORD == 1) return __uint_as_float(p.w[j]);
    return __uint_as_float((j & 1) ? p.w[j >> 1] & 0xFFFF0000u : p.w[j >> 1] << 16);
  }
};

// int8 codes with their (…, KH, D/group) f32 scale plane.
struct Int8Rows {
  static constexpr int PER_WORD = 4;
  template <int N>
  using Pack = Packet<N / PER_WORD>;
  const int8_t* data;
  const float* scales;
  int width, group, n_groups;
  __device__ __forceinline__ float operator()(int64_t row, int i) const {
    const uint32_t u = static_cast<uint8_t>(data[row * width + i]) ^ 0x80u;
    return __fmul_rn(small_int(u, 128.f), scales[row * n_groups + i / group]);
  }
  template <int N>
  __device__ __forceinline__ Pack<N> packet(int64_t row, int i) const {
    Pack<N> p;
    load_words(data + row * width + i, p.w);
    p.scale = scales[row * n_groups + i / group];
    return p;
  }
  template <int N>
  __device__ __forceinline__ static float elem(const Pack<N>& p, int j) {
    return __fmul_rn(small_int(((p.w[j / 4] >> (8 * (j % 4))) & 0xFFu) ^ 0x80u, 128.f),
                     p.scale);
  }
  template <int N>
  __device__ __forceinline__ void vec(int64_t row, int i, float (&out)[N]) const {
    const Pack<N> p = packet<N>(row, i);
#pragma unroll
    for (int j = 0; j < N; ++j) out[j] = elem<N>(p, j);
  }
};

// int4 codes packed two per byte along D: the low nibble is the even
// element; the sign is restored as (u ^ 8) - 8.
struct Int4Rows {
  static constexpr int PER_WORD = 8;
  template <int N>
  using Pack = Packet<N / PER_WORD>;
  const uint8_t* data;
  const float* scales;
  int width, group, n_groups;  // width = D (the packed row holds D/2 bytes)
  __device__ __forceinline__ float operator()(int64_t row, int i) const {
    const unsigned byte = data[row * (width / 2) + i / 2];
    const uint32_t u = (i & 1) ? byte >> 4 : byte & 0xFu;
    return __fmul_rn(small_int(u ^ 8u, 8.f), scales[row * n_groups + i / group]);
  }
  template <int N>
  __device__ __forceinline__ Pack<N> packet(int64_t row, int i) const {
    Pack<N> p;
    load_words(data + row * (width / 2) + i / 2, p.w);
    p.scale = scales[row * n_groups + i / group];
    return p;
  }
  template <int N>
  __device__ __forceinline__ static float elem(const Pack<N>& p, int j) {
    return __fmul_rn(small_int(((p.w[j / 8] >> (4 * (j % 8))) & 0xFu) ^ 8u, 8.f), p.scale);
  }
  template <int N>
  __device__ __forceinline__ void vec(int64_t row, int i, float (&out)[N]) const {
    const Pack<N> p = packet<N>(row, i);
#pragma unroll
    for (int j = 0; j < N; ++j) out[j] = elem<N>(p, j);
  }
};

}  // namespace kv
