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
// body, its numerics, its accuracy standard, its bound and its design are in
// flash_attention.cuh.  flash_attention_probe runs the body's TF32 split
// and one tensor-core product on chosen inputs, so a card run can check the
// premises of the accuracy standard.

#include <stdint.h>

#include "flash_attention.cuh"

namespace {

template <typename Q, typename T>
int run(const void* q, const void* k, const void* v, const void* q_start, void* out, int b,
        int sq, int skv, int h, int kh, int d, int dv, float scale, int causal, void* stream) {
  kv::FloatRows<T> kr{static_cast<const T*>(k), d};
  kv::FloatRows<T> vr{static_cast<const T*>(v), dv};
  // cp.async staging: every row starts on a 16-byte boundary
  constexpr int VEC = 16 / static_cast<int>(sizeof(T));
  const bool vec = reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(v) % 16 == 0 && d % VEC == 0 && dv % VEC == 0;
  return flash::launch<Q>(q, kr, vr, q_start, out, b, sq, skv, h, kh, d, dv, scale, causal, vec,
                          stream);
}

__global__ void probe_kernel(const float* x, float* hi, float* lo, float* hi_cvt,
                             float* lo_cvt, int n, const float* a, const float* bt,
                             const float* c, float* d) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    uint32_t h, l;
    flash::split(x[i], h, l);
    hi[i] = __uint_as_float(h);
    lo[i] = __uint_as_float(l);
    h = flash::tf32_cvt_rna(x[i]);
    hi_cvt[i] = __uint_as_float(h);
    lo_cvt[i] = __uint_as_float(flash::tf32_cvt_rna(__fsub_rn(x[i], __uint_as_float(h))));
  }
  if (threadIdx.x < 32) {
    const int g = threadIdx.x >> 2;
    const int t = threadIdx.x & 3;
    const uint32_t af[4] = {__float_as_uint(a[g * 8 + t]), __float_as_uint(a[(g + 8) * 8 + t]),
                            __float_as_uint(a[g * 8 + t + 4]),
                            __float_as_uint(a[(g + 8) * 8 + t + 4])};
    float acc[4] = {c[g * 8 + 2 * t], c[g * 8 + 2 * t + 1], c[(g + 8) * 8 + 2 * t],
                    c[(g + 8) * 8 + 2 * t + 1]};
    flash::mma_tf32(acc, af, __float_as_uint(bt[g * 8 + t]), __float_as_uint(bt[g * 8 + t + 4]));
    d[g * 8 + 2 * t] = acc[0];
    d[g * 8 + 2 * t + 1] = acc[1];
    d[(g + 8) * 8 + 2 * t] = acc[2];
    d[(g + 8) * 8 + 2 * t + 1] = acc[3];
  }
}

}  // namespace

extern "C" {

// The largest D and Dv the kernel takes.
int flash_attention_max_d() { return flash::MAX_D; }

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok).
// q / out are f32 (q_bf16 = 0) or bf16, k / v f32 (kv_bf16 = 0) or bf16,
// all contiguous; q_start is null or (B,) int32.
int flash_attention(const void* q, int q_bf16, const void* k, const void* v, int kv_bf16,
                    const void* q_start, void* out, int b, int sq, int skv, int h, int kh,
                    int d, int dv, float scale, int causal, void* stream) {
  using bf16 = __nv_bfloat16;
  if (q_bf16)
    return kv_bf16 ? run<bf16, bf16>(q, k, v, q_start, out, b, sq, skv, h, kh, d, dv, scale, causal, stream)
                   : run<bf16, float>(q, k, v, q_start, out, b, sq, skv, h, kh, d, dv, scale, causal, stream);
  return kv_bf16 ? run<float, bf16>(q, k, v, q_start, out, b, sq, skv, h, kh, d, dv, scale, causal, stream)
                 : run<float, float>(q, k, v, q_start, out, b, sq, skv, h, kh, d, dv, scale, causal, stream);
}

// The premises' probe, one block on `stream`: hi / lo (n,) = the body's
// split of x (n,), hi_cvt / lo_cvt the same split by cvt.rna.tf32.f32; d
// (16, 8) = c (16, 8) + a (16, 8) · btᵀ, bt (8, 8) holding B's columns as
// rows, through one m16n8k8 TF32 mma (a and bt must be TF32 values
// already).  All f32, contiguous.  Returns cudaGetLastError().
int flash_attention_probe(const float* x, float* hi, float* lo, float* hi_cvt, float* lo_cvt,
                          int n, const float* a, const float* bt, const float* c, float* d,
                          void* stream) {
  probe_kernel<<<1, 256, 0, static_cast<cudaStream_t>(stream)>>>(x, hi, lo, hi_cvt, lo_cvt, n,
                                                                  a, bt, c, d);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
