// Causal GQA flash attention over quantized K/V, for Hopper (sm_90a):
//
//     out (B, Sq, H, D) = attention of q (B, Sq, H, D) over k / v codes
//                         (B, Skv, KH, D | D/2) int8 or packed-int4 uint8
//                         with f32 scale planes (B, Skv, KH, D/group),
//                         query row i of sequence b at position
//                         q_start[b] + i (null: 0)
//
// Replaces the TPU kernel repro/kernels/flash_attn.py::
// flash_attention_quant_kernel (behind ops.flash_attention_quant, whose
// wrapper repeats the KV heads; here each query head reads its kv head in
// place).  Each K/V unit dequantizes as it is staged into the same f32
// shared-memory units as flash_attention.cu's: ONE f32 multiply
// float(code) · scale[group] per element (int4: low nibble = even element,
// sign (u ^ 8) - 8), as serve/kvquant.dequantize_kv does, so the f32 K/V
// never reach device memory and this kernel on codes is bitwise
// flash_attention.cu on dequantize_kv(codes).  Bound: operations, as
// flash_attention.cu, against D or D/2 bytes a row plus 4·D/group of
// scales.  Head dims up to 256.  The body, its numerics, its accuracy
// standard and its design are in flash_attention.cuh.

#include <stdint.h>

#include "flash_attention.cuh"

namespace {

template <typename Q>
int dispatch(const void* q, const void* k, const void* k_scales, const void* v,
             const void* v_scales, int packed, int group, const void* q_start, void* out,
             int b, int sq, int skv, int h, int kh, int d, float scale, int causal,
             void* stream) {
  const int n_groups = d / group;
  const float* ks = static_cast<const float*>(k_scales);
  const float* vs = static_cast<const float*>(v_scales);
  // whole 32-bit words of one group's codes: 4 int8 or 8 int4 codes
  const int per_word = packed ? 8 : 4;
  const bool vec = reinterpret_cast<uintptr_t>(k) % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(v) % 4 == 0 && d % per_word == 0 &&
                   group % per_word == 0;
  if (packed) {
    kv::Int4Rows kr{static_cast<const uint8_t*>(k), ks, d, group, n_groups};
    kv::Int4Rows vr{static_cast<const uint8_t*>(v), vs, d, group, n_groups};
    return flash::launch<Q>(q, kr, vr, q_start, out, b, sq, skv, h, kh, d, d, scale, causal,
                            vec, stream);
  }
  kv::Int8Rows kr{static_cast<const int8_t*>(k), ks, d, group, n_groups};
  kv::Int8Rows vr{static_cast<const int8_t*>(v), vs, d, group, n_groups};
  return flash::launch<Q>(q, kr, vr, q_start, out, b, sq, skv, h, kh, d, d, scale, causal, vec,
                          stream);
}

}  // namespace

extern "C" {

// The largest D the kernel takes.
int flash_attention_quant_max_d() { return flash::MAX_D; }

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok).
// q / out f32 (q_bf16 = 0) or bf16; k / v int8 (packed = 0) or packed
// int4; scales f32; all contiguous; q_start null or (B,) int32.
int flash_attention_quant(const void* q, int q_bf16, const void* k, const void* k_scales,
                          const void* v, const void* v_scales, int packed, int group,
                          const void* q_start, void* out, int b, int sq, int skv, int h,
                          int kh, int d, float scale, int causal, void* stream) {
  if (group <= 0 || d % group != 0 || (packed && d % 2)) return static_cast<int>(cudaErrorInvalidValue);
  if (q_bf16)
    return dispatch<__nv_bfloat16>(q, k, k_scales, v, v_scales, packed, group, q_start, out, b,
                                   sq, skv, h, kh, d, scale, causal, stream);
  return dispatch<float>(q, k, k_scales, v, v_scales, packed, group, q_start, out, b, sq, skv,
                         h, kh, d, scale, causal, stream);
}

}  // extern "C"
