// Paged decode attention over a float page pool, for Hopper (sm_90a):
//
//     out (B, H, Dv) = attention of q (B, H, D) over the pages of k_pages /
//                      v_pages (NP, P, KH, D | Dv) named by block_table
//                      (B, MPB) int32, positions >= lengths (B,) masked
//
// Replaces the TPU kernel repro/kernels/flash_attn.py::
// paged_flash_attention_kernel.  q and out are f32 or bf16 (bf16 in
// serving); the pool is f32 or bf16 (the f32 and bf16 KVSpecs), read in
// place, by 16-byte loads (4 f32 or 8 bf16 a lane) where D and Dv hold
// whole 16-byte vectors and both pools are 16-byte aligned, else element
// by element in the same kernel.  The split-KV body, its accuracy
// standard, its bound and its design are in paged_attention.cuh.

#include <stdint.h>

#include "paged_attention.cuh"

namespace {

template <typename Q, typename T>
int run(const void* q, const void* k_pages, const void* v_pages, const void* block_table,
        const void* lengths, void* out, void* part, int b, int h, int kh, int d, int dv,
        int page, int mpb, float scale, void* stream) {
  using Rows = kv::FloatRows<T>;
  constexpr int E = 16 / static_cast<int>(sizeof(T));
  const Rows kr{static_cast<const T*>(k_pages), d};
  const Rows vr{static_cast<const T*>(v_pages), dv};
  const bool vec = reinterpret_cast<uintptr_t>(k_pages) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(v_pages) % 16 == 0 && d % E == 0 && dv % E == 0;
  if (vec)
    return paged::launch<Q>(q, paged::Packets<Rows, E>{kr}, paged::Packets<Rows, E>{vr},
                            block_table, lengths, out, part, b, h, kh, d, dv, page, mpb, scale,
                            stream);
  return paged::launch<Q>(q, paged::Elements<Rows>{kr}, paged::Elements<Rows>{vr}, block_table,
                          lengths, out, part, b, h, kh, d, dv, page, mpb, scale, stream);
}

}  // namespace

extern "C" {

// The split's constants, for the wrapper's workspace and the bound.
int paged_flash_attention_pages_per_split() { return paged::PAGES_PER_SPLIT; }
int paged_flash_attention_warps() { return paged::WARPS; }

// Launch on `stream`; returns cudaGetLastError() after the launches (0 =
// ok).  `part`: the f32 workspace (S, B, H, Dv + 2), S = max(1, ceil(MPB /
// PAGES_PER_SPLIT)); null when S == 1.
int paged_flash_attention(const void* q, int q_bf16, const void* k_pages,
                          const void* v_pages, int kv_bf16,
                          const void* block_table, const void* lengths,
                          void* out, void* part, int b, int h, int kh, int d, int dv,
                          int page, int mpb, float scale, void* stream) {
  using bf16 = __nv_bfloat16;
  auto go = [&](auto run_qt) {
    return run_qt(q, k_pages, v_pages, block_table, lengths, out, part, b, h, kh, d, dv, page,
                  mpb, scale, stream);
  };
  if (q_bf16) return kv_bf16 ? go(run<bf16, bf16>) : go(run<bf16, float>);
  return kv_bf16 ? go(run<float, bf16>) : go(run<float, float>);
}

}  // extern "C"
