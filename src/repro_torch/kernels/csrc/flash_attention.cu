// Causal GQA flash attention over f32 or bf16 K/V, for Hopper (sm_90a):
//
//     out (B, Sq, H, Dv) = attention of q (B, Sq, H, D) over k / v
//                          (B, Skv, KH, D | Dv), query row i of sequence b
//                          at position q_start[b] + i (null: 0)
//
// Replaces the TPU kernel repro/kernels/flash_attn.py::
// flash_attention_kernel (behind ops.flash_attention's GQA fold), and
// extends it with the query offset that a prefill chunk over the paged KV
// pool needs.  q and out are f32 or bf16; K and V share one dtype, f32 or
// bf16, which may differ from q's (a bf16 model over an f32 pool).  The
// body, its numerics, its bound and its design are in flash_attention.cuh.

#include "flash_attention.cuh"

namespace {

template <typename Q, typename T>
int run(const void* q, const void* k, const void* v, const void* q_start, void* out, int b,
        int sq, int skv, int h, int kh, int d, int dv, float scale, int causal, void* stream,
        bool wide) {
  kv::FloatRows<T> kr{static_cast<const T*>(k), d};
  kv::FloatRows<T> vr{static_cast<const T*>(v), dv};
  return flash::launch<Q>(q, kr, vr, q_start, out, b, sq, skv, h, kh, d, dv, scale, causal,
                          stream, wide);
}

int dispatch(const void* q, int q_bf16, const void* k, const void* v, int kv_bf16,
             const void* q_start, void* out, int b, int sq, int skv, int h, int kh, int d,
             int dv, float scale, int causal, void* stream, bool wide) {
  using bf16 = __nv_bfloat16;
  if (q_bf16)
    return kv_bf16 ? run<bf16, bf16>(q, k, v, q_start, out, b, sq, skv, h, kh, d, dv, scale, causal, stream, wide)
                   : run<bf16, float>(q, k, v, q_start, out, b, sq, skv, h, kh, d, dv, scale, causal, stream, wide);
  return kv_bf16 ? run<float, bf16>(q, k, v, q_start, out, b, sq, skv, h, kh, d, dv, scale, causal, stream, wide)
                 : run<float, float>(q, k, v, q_start, out, b, sq, skv, h, kh, d, dv, scale, causal, stream, wide);
}

}  // namespace

extern "C" {

// The largest D and Dv the kernel takes (the wide instantiation's).
int flash_attention_max_d() { return flash::WIDE_MAX_D; }

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok).
// q / out are f32 (q_bf16 = 0) or bf16, k / v f32 (kv_bf16 = 0) or bf16,
// all contiguous; q_start is null or (B,) int32.
int flash_attention(const void* q, int q_bf16, const void* k, const void* v, int kv_bf16,
                    const void* q_start, void* out, int b, int sq, int skv, int h, int kh,
                    int d, int dv, float scale, int causal, void* stream) {
  return dispatch(q, q_bf16, k, v, kv_bf16, q_start, out, b, sq, skv, h, kh, d, dv, scale,
                  causal, stream, false);
}

// The same through the wide instantiation at any D, Dv <= 256: for tests
// only, which hold it bitwise the narrow one at D, Dv <= 128.
int flash_attention_wide(const void* q, int q_bf16, const void* k, const void* v, int kv_bf16,
                         const void* q_start, void* out, int b, int sq, int skv, int h, int kh,
                         int d, int dv, float scale, int causal, void* stream) {
  return dispatch(q, q_bf16, k, v, kv_bf16, q_start, out, b, sq, skv, h, kh, d, dv, scale,
                  causal, stream, true);
}

}  // extern "C"
