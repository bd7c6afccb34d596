// Paged decode attention over a float page pool, for Hopper (sm_90a):
//
//     out (B, H, Dv) = attention of q (B, H, D) over the pages of k_pages /
//                      v_pages (NP, P, KH, D | Dv) named by block_table
//                      (B, MPB) int32, positions >= lengths (B,) masked
//
// Replaces the TPU kernel repro/kernels/flash_attn.py::
// paged_flash_attention_kernel.  q and out are f32 or bf16 (bf16 in
// serving); the pool is f32 or bf16 (the f32 and bf16 KVSpecs), read in
// place.  The body, its bound and its design are in paged_attention.cuh.

#include "paged_attention.cuh"

namespace {

template <typename Q, typename T>
int run(const void* q, const void* k_pages, const void* v_pages,
        const void* block_table, const void* lengths, void* out, int b, int h,
        int kh, int d, int dv, int page, int mpb, float scale, void* stream) {
  paged::FloatRows<T> kr{static_cast<const T*>(k_pages), d};
  paged::FloatRows<T> vr{static_cast<const T*>(v_pages), dv};
  return paged::launch<Q>(q, kr, vr, block_table, lengths, out, b, h, kh, d,
                          dv, page, mpb, scale, stream);
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok).
int paged_flash_attention(const void* q, int q_bf16, const void* k_pages,
                          const void* v_pages, int kv_bf16,
                          const void* block_table, const void* lengths,
                          void* out, int b, int h, int kh, int d, int dv,
                          int page, int mpb, float scale, void* stream) {
  using bf16 = __nv_bfloat16;
  if (q_bf16)
    return kv_bf16
        ? run<bf16, bf16>(q, k_pages, v_pages, block_table, lengths, out, b, h, kh, d, dv, page, mpb, scale, stream)
        : run<bf16, float>(q, k_pages, v_pages, block_table, lengths, out, b, h, kh, d, dv, page, mpb, scale, stream);
  return kv_bf16
      ? run<float, bf16>(q, k_pages, v_pages, block_table, lengths, out, b, h, kh, d, dv, page, mpb, scale, stream)
      : run<float, float>(q, k_pages, v_pages, block_table, lengths, out, b, h, kh, d, dv, page, mpb, scale, stream);
}

}  // extern "C"
