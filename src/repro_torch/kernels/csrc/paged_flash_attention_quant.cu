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
// through the same page ids, 16 int8 or 32 int4 codes a lane by one
// 16-byte load with their group's scale where D and the group hold whole
// packets and the pools are 16-byte aligned, else element by element in
// the same kernel; each element dequantizes as ONE f32 multiply
// float(code) · scale[group] (int4: low nibble = even element, sign
// (u ^ 8) - 8; kv_rows.cuh), so the operands are bitwise
// serve/kvquant.dequantize_kv's.  Bound: memory, now D or D/2 bytes a row
// plus 4·D/group of scales.  The split-KV body, its accuracy standard, its
// bound and its design are in paged_attention.cuh.

#include <stdint.h>

#include "paged_attention.cuh"

namespace {

template <typename Q, typename Rows, int E>
int run(const void* q, const Rows& kr, const Rows& vr, bool vec, const void* block_table,
        const void* lengths, void* out, void* part, int b, int h, int kh, int d, int page,
        int mpb, float scale, void* stream) {
  if (vec)
    return paged::launch<Q>(q, paged::Packets<Rows, E>{kr}, paged::Packets<Rows, E>{vr},
                            block_table, lengths, out, part, b, h, kh, d, d, page, mpb, scale,
                            stream);
  return paged::launch<Q>(q, paged::Elements<Rows>{kr}, paged::Elements<Rows>{vr}, block_table,
                          lengths, out, part, b, h, kh, d, d, page, mpb, scale, stream);
}

template <typename Q>
int dispatch(const void* q, const void* k_pages, const void* k_scales,
             const void* v_pages, const void* v_scales, int packed,
             int group, const void* block_table, const void* lengths,
             void* out, void* part, int b, int h, int kh, int d, int page, int mpb,
             float scale, void* stream) {
  const int n_groups = d / group;
  const float* ks = static_cast<const float*>(k_scales);
  const float* vs = static_cast<const float*>(v_scales);
  // a 16-byte packet of codes lies in one group of one row
  const int per_packet = packed ? 32 : 16;
  const bool vec = reinterpret_cast<uintptr_t>(k_pages) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(v_pages) % 16 == 0 && d % per_packet == 0 &&
                   group % per_packet == 0;
  if (packed) {
    const kv::Int4Rows kr{static_cast<const uint8_t*>(k_pages), ks, d, group, n_groups};
    const kv::Int4Rows vr{static_cast<const uint8_t*>(v_pages), vs, d, group, n_groups};
    return run<Q, kv::Int4Rows, 32>(q, kr, vr, vec, block_table, lengths, out, part, b, h, kh,
                                    d, page, mpb, scale, stream);
  }
  const kv::Int8Rows kr{static_cast<const int8_t*>(k_pages), ks, d, group, n_groups};
  const kv::Int8Rows vr{static_cast<const int8_t*>(v_pages), vs, d, group, n_groups};
  return run<Q, kv::Int8Rows, 16>(q, kr, vr, vec, block_table, lengths, out, part, b, h, kh, d,
                                  page, mpb, scale, stream);
}

}  // namespace

extern "C" {

// The split's constants, for the wrapper's workspace and the bound.
int paged_flash_attention_quant_pages_per_split() { return paged::PAGES_PER_SPLIT; }
int paged_flash_attention_quant_warps() { return paged::WARPS; }

// Launch on `stream`; returns cudaGetLastError() after the launches (0 =
// ok).  `part`: the f32 workspace (S, B, H, D + 2), S = max(1, ceil(MPB /
// PAGES_PER_SPLIT)); null when S == 1.
int paged_flash_attention_quant(const void* q, int q_bf16, const void* k_pages,
                                const void* k_scales, const void* v_pages,
                                const void* v_scales, int packed, int group,
                                const void* block_table, const void* lengths,
                                void* out, void* part, int b, int h, int kh, int d,
                                int page, int mpb, float scale, void* stream) {
  if (group <= 0 || d % group != 0 || (packed && d % 2))
    return static_cast<int>(cudaErrorInvalidValue);
  if (q_bf16)
    return dispatch<__nv_bfloat16>(q, k_pages, k_scales, v_pages, v_scales, packed, group,
                                   block_table, lengths, out, part, b, h, kh, d, page, mpb,
                                   scale, stream);
  return dispatch<float>(q, k_pages, k_scales, v_pages, v_scales, packed, group, block_table,
                         lengths, out, part, b, h, kh, d, page, mpb, scale, stream);
}

}  // extern "C"
