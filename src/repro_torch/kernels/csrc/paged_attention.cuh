// Paged decode attention for Hopper (sm_90a): the body shared by
// paged_flash_attention.cu (f32 / bf16 pools) and
// paged_flash_attention_quant.cu (int8 / packed-int4 pools with f32 scale
// planes).  Each source supplies a row reader and instantiates the kernel.
//
//     out (B, H, Dv) = softmax(q·scale · Kᵀ, positions >= length masked) · V
//
// for one query token per sequence, K/V read IN PLACE from the layer's page
// pool (NP, P, KH, D) through the block table (B, MPB): a token at position
// j·P + t of row b sits in page block_table[b, j] at slot t, and its K row
// for kv head kh starts at element ((pid·P + t)·KH + kh)·D.  The pool is
// never copied, transposed or cast.
//
// Numerics follow the Pallas body (repro/kernels/flash_attn.py
// _paged_kernel / _paged_kernel_quant) step by step, in f32: q·scale first;
// per page in ascending block-table order the scores, the -1e30 mask at
// positions >= length, the running max m, corr = exp(m - m_new),
// l = l·corr + Σp, acc = acc·corr + p·V; finally acc / max(l, 1e-30) in
// q's dtype.  expf (not __expf) and no fast math.  Pages wholly at or past
// the length are skipped: for finite pool contents the Pallas loop leaves
// m, l and acc bitwise unchanged there (p = 0, corr = 1), and skipping
// reads only the valid bytes.  A row of length 0 reads nothing (its output
// is 0 and is ignored by the caller).  Only the order of the three f32
// sums (the D-term dot, the P-term Σp and the P-term p·V) differs from the
// plain PyTorch version.
//
// Bound on an H100 SXM: memory.  A call must read each valid K/V row once
// (plus its scales), q, the block table and the lengths, and write the
// output; the flops (4·G·D per token and kv head) are far below the card's
// rate.  Design, simple first: one block of 128 threads per (sequence, kv
// head), as the Pallas grid (B, KH); the G = H/KH query rows of the group
// sit in shared memory, scaled; per page, each warp takes (query row,
// token) pairs and reduces the D-term dot with shuffles (a K row is read
// by G warps, from L1 after the first), one thread per query row runs the
// softmax step, and each thread owns (query row, feature) elements of acc
// (kept in shared memory) and walks the page's valid tokens.  KV is not
// split across blocks: a row's result depends only on its own pages, so
// outputs stay bitwise invariant to co-tenancy and page placement.  Later
// work (ROADMAP Queue 2): split-KV with a fixed per-row split, vector
// loads, tensor cores for G > 1.

#pragma once

#include "kv_rows.cuh"

namespace paged {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr float NEG_INF = -1e30f;

using kv::store;
using kv::to_f32;
// element i of pool row `row` (= (pid·P + t)·KH + kh) as f32
template <typename T>
using FloatRows = kv::FloatRows<T>;
using Int8Rows = kv::Int8Rows;
using Int4Rows = kv::Int4Rows;

// Dynamic shared memory of one block: q (G·D), acc (G·Dv), scores (G·P),
// m, l and corr (G each), all f32.
inline size_t smem_bytes(int g, int d, int dv, int page) {
  return sizeof(float) * (static_cast<size_t>(g) * (d + dv + page) + 3 * static_cast<size_t>(g));
}

template <typename Q, typename Rows>
__global__ void __launch_bounds__(THREADS)
paged_attention_kernel(const Q* __restrict__ q, Rows krows, Rows vrows,
                       const int* __restrict__ block_table,
                       const int* __restrict__ lengths, Q* __restrict__ out,
                       int h, int kh, int d, int dv, int page, int mpb,
                       float scale) {
  const int k_head = blockIdx.x;
  const int b = blockIdx.y;
  const int g = h / kh;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  extern __shared__ float smem[];
  float* q_s = smem;             // (G, D) q · scale
  float* acc = q_s + g * d;      // (G, Dv)
  float* s_s = acc + g * dv;     // (G, P) scores, then probabilities
  float* m_s = s_s + g * page;   // (G,) running max
  float* l_s = m_s + g;          // (G,) running sum
  float* c_s = l_s + g;          // (G,) this page's correction

  // the group's query heads are k_head·G .. k_head·G + G - 1
  const int64_t q_off = (static_cast<int64_t>(b) * h + static_cast<int64_t>(k_head) * g);
  const Q* qb = q + q_off * d;
  for (int i = tid; i < g * d; i += THREADS) q_s[i] = to_f32(qb[i]) * scale;
  for (int i = tid; i < g * dv; i += THREADS) acc[i] = 0.f;
  for (int i = tid; i < g; i += THREADS) {
    m_s[i] = NEG_INF;
    l_s[i] = 0.f;
  }
  const int length = max(0, min(lengths[b], mpb * page));
  const int n_pages = (length + page - 1) / page;
  const int* bt = block_table + static_cast<int64_t>(b) * mpb;
  __syncthreads();

  for (int j = 0; j < n_pages; ++j) {
    const int64_t base = static_cast<int64_t>(bt[j]) * page;  // pid · P
    const int valid = min(page, length - j * page);
    // scores: one warp per (query row, token) pair
    for (int pair = warp; pair < g * page; pair += WARPS) {
      const int gi = pair / page;
      const int t = pair - gi * page;
      float s = NEG_INF;
      if (t < valid) {  // warp-uniform
        const int64_t row = (base + t) * kh + k_head;
        const float* qr = q_s + gi * d;
        float part = 0.f;
        for (int i = lane; i < d; i += 32) part += qr[i] * krows(row, i);
        for (int off = 16; off; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
        s = part;
      }
      if (lane == 0) s_s[pair] = s;
    }
    __syncthreads();
    // the online-softmax step, one thread per query row
    for (int gi = tid; gi < g; gi += THREADS) {
      float* sr = s_s + gi * page;
      const float m = m_s[gi];
      float m_new = m;
      for (int t = 0; t < page; ++t) m_new = fmaxf(m_new, sr[t]);
      float sum = 0.f;
      for (int t = 0; t < page; ++t) {
        const float p = expf(sr[t] - m_new);
        sr[t] = p;
        sum += p;
      }
      const float corr = expf(m - m_new);
      // two roundings, as the plain version's l·corr + Σp (no contraction)
      l_s[gi] = __fadd_rn(__fmul_rn(l_s[gi], corr), sum);
      m_s[gi] = m_new;
      c_s[gi] = corr;
    }
    __syncthreads();
    // acc = acc·corr + p·V over the page's valid tokens (masked p are 0)
    for (int i = tid; i < g * dv; i += THREADS) {
      const int gi = i / dv;
      const int e = i - gi * dv;
      const float* pr = s_s + gi * page;
      float pv = 0.f;
      for (int t = 0; t < valid; ++t) pv += pr[t] * vrows((base + t) * kh + k_head, e);
      acc[i] = __fadd_rn(__fmul_rn(acc[i], c_s[gi]), pv);
    }
    __syncthreads();
  }

  Q* ob = out + q_off * dv;
  for (int i = tid; i < g * dv; i += THREADS) store(ob + i, acc[i] / fmaxf(l_s[i / dv], 1e-30f));
}

// Launch one (kv head, sequence) block each on `stream`; returns
// cudaGetLastError() after the launch (0 = ok).
template <typename Q, typename Rows>
int launch(const void* q, Rows krows, Rows vrows, const void* block_table,
           const void* lengths, void* out, int b, int h, int kh, int d, int dv,
           int page, int mpb, float scale, void* stream) {
  if (b == 0 || kh == 0) return 0;
  const size_t smem = smem_bytes(h / kh, d, dv, page);
  auto kernel = paged_attention_kernel<Q, Rows>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<dim3(kh, b), THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Q*>(q), krows, vrows, static_cast<const int*>(block_table),
      static_cast<const int*>(lengths), static_cast<Q*>(out), h, kh, d, dv, page,
      mpb, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace paged
