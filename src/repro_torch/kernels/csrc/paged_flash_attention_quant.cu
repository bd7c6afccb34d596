// Paged decode attention over a quantized page pool, for Hopper (sm_90a):
//
//     out (B, H, D) = attention of q (B, H, D) over the pages of k_pages /
//                     v_pages (NP, P, KH, D | D/2) int8 or packed-int4
//                     uint8, dequantized per element with the f32 scale
//                     planes k_scales / v_scales (NP, P, KH, D/group),
//                     through block_table (B, MPB) int32, positions >=
//                     lengths (B,) masked
//
// Replaces the TPU kernel repro/kernels/flash_attn.py::
// paged_flash_attention_quant_kernel.  Codes and scales are read in place
// through the same page ids; each element dequantizes as ONE f32 multiply
// float(code) · scale[group] (int4: low nibble = even element, sign
// (u ^ 8) - 8), so the operands are bitwise serve/kvquant.dequantize_kv's.
// Bound: memory, now D or D/2 bytes a row plus 4·D/group of scales.  The
// body, its bound and its design are in paged_attention.cuh.

#include "paged_attention.cuh"

namespace {

template <typename Q, typename Rows>
int run(const void* q, Rows kr, Rows vr, const void* block_table,
        const void* lengths, void* out, int b, int h, int kh, int d, int page,
        int mpb, float scale, void* stream) {
  return paged::launch<Q>(q, kr, vr, block_table, lengths, out, b, h, kh, d, d,
                          page, mpb, scale, stream);
}

template <typename Q>
int dispatch(const void* q, const void* k_pages, const void* k_scales,
             const void* v_pages, const void* v_scales, int packed,
             int group, const void* block_table, const void* lengths,
             void* out, int b, int h, int kh, int d, int page, int mpb,
             float scale, void* stream) {
  const int n_groups = d / group;
  const float* ks = static_cast<const float*>(k_scales);
  const float* vs = static_cast<const float*>(v_scales);
  if (packed) {
    paged::Int4Rows kr{static_cast<const uint8_t*>(k_pages), ks, d, group, n_groups};
    paged::Int4Rows vr{static_cast<const uint8_t*>(v_pages), vs, d, group, n_groups};
    return run<Q>(q, kr, vr, block_table, lengths, out, b, h, kh, d, page, mpb, scale, stream);
  }
  paged::Int8Rows kr{static_cast<const int8_t*>(k_pages), ks, d, group, n_groups};
  paged::Int8Rows vr{static_cast<const int8_t*>(v_pages), vs, d, group, n_groups};
  return run<Q>(q, kr, vr, block_table, lengths, out, b, h, kh, d, page, mpb, scale, stream);
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok).
int paged_flash_attention_quant(const void* q, int q_bf16, const void* k_pages,
                                const void* k_scales, const void* v_pages,
                                const void* v_scales, int packed, int group,
                                const void* block_table, const void* lengths,
                                void* out, int b, int h, int kh, int d,
                                int page, int mpb, float scale, void* stream) {
  if (group <= 0 || d % group != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (q_bf16)
    return dispatch<__nv_bfloat16>(q, k_pages, k_scales, v_pages, v_scales, packed, group,
                                   block_table, lengths, out, b, h, kh, d, page, mpb, scale, stream);
  return dispatch<float>(q, k_pages, k_scales, v_pages, v_scales, packed, group,
                         block_table, lengths, out, b, h, kh, d, page, mpb, scale, stream);
}

}  // extern "C"
