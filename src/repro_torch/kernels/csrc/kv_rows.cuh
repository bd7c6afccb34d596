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

// f32 or bf16 rows of `width` (D or Dv) elements.
template <typename T>
struct FloatRows {
  const T* data;
  int width;
  __device__ __forceinline__ float operator()(int64_t row, int i) const {
    return to_f32(data[row * width + i]);
  }
};

// int8 codes with their (…, KH, D/group) f32 scale plane.
struct Int8Rows {
  const int8_t* data;
  const float* scales;
  int width, group, n_groups;
  __device__ __forceinline__ float operator()(int64_t row, int i) const {
    return __fmul_rn(static_cast<float>(data[row * width + i]),
                     scales[row * n_groups + i / group]);
  }
};

// int4 codes packed two per byte along D: the low nibble is the even
// element; the sign is restored as (u ^ 8) - 8.
struct Int4Rows {
  const uint8_t* data;
  const float* scales;
  int width, group, n_groups;  // width = D (the packed row holds D/2 bytes)
  __device__ __forceinline__ float operator()(int64_t row, int i) const {
    const unsigned byte = data[row * (width / 2) + i / 2];
    const int u = (i & 1) ? static_cast<int>(byte >> 4) : static_cast<int>(byte & 0xF);
    return __fmul_rn(static_cast<float>((u ^ 8) - 8),
                     scales[row * n_groups + i / group]);
  }
};

}  // namespace kv
