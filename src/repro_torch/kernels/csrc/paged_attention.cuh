// Paged decode attention for Hopper (sm_90a): the body shared by
// paged_flash_attention.cu (f32 / bf16 pools) and
// paged_flash_attention_quant.cu (int8 / packed-int4 pools with f32 scale
// planes).  Each source supplies its row readers (kv_rows.cuh) and
// instantiates the kernels.
//
//     out (B, H, Dv) = softmax(q·scale · Kᵀ, positions >= length masked) · V
//
// for one query token per sequence, K/V read IN PLACE from the layer's page
// pool (NP, P, KH, D | Dv) through the block table (B, MPB): a token at
// position j·P + t of row b sits in page block_table[b, j] at slot t, and
// its K row for kv head kh starts at element ((pid·P + t)·KH + kh)·D.  The
// pool is never copied, transposed or cast, and no page at or past a row's
// length is read.
//
// Split.  A row's keys are split by a rule fixed per row: split s holds
// its pages s·PAGES_PER_SPLIT … (s + 1)·PAGES_PER_SPLIT - 1 (256 tokens at
// P 16).  The grid is (KH·ceil(G / GT)·n_dvc, B, S) with S =
// max(1, ceil(MPB / PAGES_PER_SPLIT)), from shapes alone; a row of length
// n uses ceil(ceil(n / P) / PAGES_PER_SPLIT) splits, and a block past its
// row's last split exits at once.  A block takes one kv head, GT query
// rows of its group (GT = 1 for G = 1, else 4: SmolLM's three rows share
// one block, so each K row is loaded once for all of them), one chunk of
// Dv (n_dvc > 1 only for f32 Dv > 128 or bf16 Dv > 256; each chunk's block
// computes the same scores, bitwise) and one split.  With S == 1 (MPB <=
// 16: every served shape) the block writes the output; with S > 1 it
// writes its (m, l, acc[Dv]) per query row in f32 to a workspace (S, B,
// H, Dv + 2) that the wrapper allocates, and a second launch in the same C
// call combines each row's splits in ascending order.
//
// Inside a block: WARPS = 4 warps.  The block stages q·scale and the
// split's block-table entries in shared memory while its row's length is
// on its way (one memory latency before the first K/V load).  The split's
// token range is cut into steps of STEP tokens, step k taken by warp k mod
// 4, each warp with its own online-softmax state per query row.  A
// token's K (and V) row is read by a group of `lanes` lanes (the row's
// 16-byte vectors rounded up to a power of two, at most 32), one 16-byte
// load a lane: 4 f32, 8 bf16, 16 int8 or 32 int4 codes, the codes with
// their group's scale (kv_rows.cuh packets, whose codes turn into f32
// without a conversion instruction); a lane reads further vectors of a
// wider K row in more rounds.  A warp takes 32 / lanes tokens a pass and
// NPASS passes a step (8 for f32, 4 for bf16 and int8, 2 for int4): STEP
// = 8 tokens at D 96 for f32 and bf16, 16 for int8 and int4.  It issues
// the step's V loads and then its K loads, unconditionally (a token past
// the range reads the step's first row, a lane past the row a vector that
// exists, and their products are masked), before it computes, so each
// step waits on about one memory latency; a lane dots its K vectors with
// the query rows held in shared memory, the group's partial dots meet by
// xor shuffles, and the step's max and Σp over its tokens are xor
// shuffles across the groups.  No thread walks a page alone.  Each lane
// keeps acc for its own V features as a partial over its group's tokens;
// the groups' partials meet by xor shuffles once, after the last step.
// The warps' states meet in shared memory in warp order after ONE barrier
// (the only other barrier follows the staging).  Where G = 1 a thread
// keeps to 128 registers, so four blocks (16 warps) share an SM.  The
// combine (S > 1) takes one thread an output element and loads 16
// splits' partials at once before it adds them in order.
//
// Rows whose width breaks the 16-byte vectors (D·itemsize % 16, codes
// whose group is not a multiple of a packet, an unaligned pool) take the
// element-wise reader inside the same kernel: vectors of 4 elements read
// one by one, any width and group.
//
// Numerics, in f32, expf (not __expf), no fast math, __fmul_rn / __fadd_rn
// where a product and a sum must not contract.  q' = q·scale (one
// rounding, as the plain version).  A score is the D-term dot of q' and
// K (an fma chain per lane over its features, then the group's xor tree).
// Per step of a warp: m_new = max(m, the step's scores), corr = expf(m -
// m_new), p = expf(s - m_new) (0 past the range), l = l·corr + Σp, acc =
// acc·corr + Σ_pass p·v (an fma chain over the lane's passes).  The warps
// of a block, then the splits of a row, combine as
//
//     M = max_i m_i,  e_i = (m_i == M ? 1 : expf(m_i - M)),
//     A = acc_0·e_0 + acc_1·e_1 + …,  L = l_0·e_0 + l_1·e_1 + …
//
// in ascending index order, and out = A / max(L, 1e-30) in q's dtype.
// The plain version (flash_attn._online_softmax) keeps the Pallas body's
// order: page by page, one max, corr and update per page.
//
// Accuracy standard (u = 2⁻²⁴; derived before this body's first card run
// and never fitted to measured errors; flash_attn.paged_attention_bound
// implements it and both chip_smoke.py and the CPU test call it).  Let
// M be the row's largest score, x_t = M - s_t >= 0, w_t the exact softmax
// weights, v_max = max |v| over the row's valid rows.
//
//   Scores.  q' is the same f32 value in both versions; each computes the
//   dot in its own order, within D·u·S of the exact one (S = the largest
//   Σ_d |q'_d·k_d| of a valid token), so a weight e^(s_t - M) moves by a
//   factor within e^(±D·u·S).
//
//   Weights.  A token's weight is p_t times the factors that rescale it
//   later (corr, then the warp's e_w, then the split's e_s; the plain
//   version: corr of each later page).  Each factor and p are ONE expf of
//   a difference: CUDA documents expf within 2 ulp of the correctly
//   rounded result, so within 2.5 ulp <= 5u relative of the exact value
//   (the CPU's exp is within 1 ulp).  Each difference rounds once, and
//   the differences on a token's path add up to x_t, so their roundings
//   move its weight by a factor within e^(±u·x_t).  Kernel: 1 + (n_w - 1)
//   + 1 + 1 = n_w + 2 expf a path, n_w = the steps of one warp <= ceil(T /
//   4) with T = min(n, PAGES_PER_SPLIT·P) tokens a split (a step holds at
//   least one token); plain: `pages` = ceil(n / P).  So each version's
//   weights are the exact ones times factors within e^(±E), E = D·u·S +
//   5u·(its exp count) + u·x̄, x̄ = Σ_t w_t x_t <= min(n / e, 2S), which
//   moves the output by at most 2c/(1 - c)·v_max, c = e^E - 1.
//
//   Sums.  A rounding of acc or l scales a partial whose magnitude is at
//   most v_max (resp. 1) times its share of L, so each moves the output by
//   at most u·v_max along a token's path; the worst path counts.  Kernel,
//   acc: the pass chain (<= 8), the step updates (2 a step: <= 2n_w), the
//   groups' tree (<= 5), the warp merge (1 + 3), the split combine (1 +
//   ns - 1 = ns, ns = ceil(pages / PAGES_PER_SPLIT)); l: the same with Σp's
//   in-lane sum (<= 7) and tree (<= 5): each <= 2n_w + ns + 17.  Plain:
//   the page's product or sum (<= P) and 2 a page: each <= P + 2·pages.
//   The final division rounds once in each (u·|y| <= u·v_max).
//
//   |kernel - plain| <= v_max·[2c_k/(1 - c_k) + 2c_p/(1 - c_p)
//                              + (1 + 2⁻⁸)·u·(4n_w + 2ns + 34 + 2P + 4·pages + 2)],
//   plus one bf16 ulp of the larger side (2⁻⁶·|plain|) for a bf16 q.
//   Underflowed weights (x_t > 87) err by less than 2⁻¹⁴⁸ each, far below
//   the (1 + 2⁻⁸) margin.  The bound it replaces, for the page-walking
//   body that took the plain version's steps: 2·v_max·(2·D·u·S + 2·(n +
//   2·pages + 4)·u).
//
// Invariance.  A row's blocks read only its own pages, length and q; its
// split rule, steps, warps, lanes and combine order depend on D, Dv, the
// pool's type and alignment, P and its length, never on the other rows,
// where its pages sit, or MPB.  With one split, the combine gives M = m_0,
// e_0 = 1 exactly, A = acc_0 and L = l_0, and divides as the S == 1 block
// does, so S = 1 and S > 1 agree bitwise.  A row's output is bitwise the
// same whatever rows share the call, wherever its pages sit and whatever
// MPB the table has (chip_smoke.py phase 3 gates it on the card).
//
// Bound on an H100 SXM: memory.  A call must read each valid K/V row once
// (with its scales), q, the block table and the lengths, and write the
// output; 4·G·D f32 operations a token and kv head are far below the
// card's rate.  No tensor cores: at G <= 3 decode does about 1.5 f32
// operations per byte read, and an mma tile of 16 query rows would be
// mostly padding.  No cp.async prefetch of the next step: four blocks of
// 4 warps an SM, each warp with a step's K and V rows in flight, and a
// long row's splits spread over the SMs; on the card the f32 split kernel
// reads a 4096-token batch at ~80 % of the bytes bound, while bf16 and
// the codes stay well above theirs (PERF.md §5).

#pragma once

#include "kv_rows.cuh"

namespace paged {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int PAGES_PER_SPLIT = 16;
constexpr int COMBINE_THREADS = 256;
constexpr int COMBINE_CHUNK = 16;
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

using kv::store;
using kv::to_f32;

// A row access by whole 16-byte packets of E elements (kv_rows.cuh).
template <typename Rows, int E_>
struct Packets {
  static constexpr int E = E_;
  static constexpr int NPASS = E == 4 ? 8 : E == 32 ? 2 : 4;
  using Raw = typename Rows::template Pack<E>;
  Rows rows;
  __device__ __forceinline__ Raw load(int64_t row, int c) const {
    return rows.template packet<E>(row, c * E);
  }
  __device__ __forceinline__ static float get(const Raw& r, int j) {
    return Rows::template elem<E>(r, j);
  }
};

// A row access of any width and group: vectors of 4 elements, each read by
// the element reader, those at or past the width as 0.
template <typename Rows>
struct Elements {
  static constexpr int E = 4;
  static constexpr int NPASS = 8;
  struct Raw {
    float v[E];
  };
  Rows rows;
  __device__ __forceinline__ Raw load(int64_t row, int c) const {
    Raw r;
#pragma unroll
    for (int j = 0; j < E; ++j) {  // every load unconditional, past the width from its end
      const int i = c * E + j;
      const float x = rows(row, min(i, rows.width - 1));
      r.v[j] = i < rows.width ? x : 0.f;
    }
    return r;
  }
  __device__ __forceinline__ static float get(const Raw& r, int j) { return r.v[j]; }
};

// Lanes a token: the wider row's vectors rounded up to a power of two, at
// most 32.
inline int lanes_for(int nvk, int nvv) {
  const int nv = nvk > nvv ? nvk : nvv;
  int lanes = 1;
  while (lanes < nv && lanes < 32) lanes <<= 1;
  return lanes;
}

// Splits of a call: from MPB alone.
inline int splits_for(int mpb) {
  const int s = (mpb + PAGES_PER_SPLIT - 1) / PAGES_PER_SPLIT;
  return s > 1 ? s : 1;
}

// Dynamic shared memory of a block: q·scale (GT, dq), the split's page ids,
// the warps' states (WARPS, GT, ch + 2).
inline size_t smem_bytes(int gt, int dq, int ch) {
  return sizeof(float) * (static_cast<size_t>(gt) * dq + PAGES_PER_SPLIT +
                          static_cast<size_t>(WARPS) * gt * (ch + 2));
}

template <typename Q, typename A, int GT>
__global__ void __launch_bounds__(THREADS, GT == 1 ? 4 : 1)
split_kernel(const Q* __restrict__ q, A kacc, A vacc, const int* __restrict__ block_table,
             const int* __restrict__ lengths, Q* __restrict__ out, float* __restrict__ part,
             int h, int kh, int d, int dv, int page, int page_shift, int mpb, float scale,
             int lanes) {
  constexpr int E = A::E;
  constexpr int NPASS = A::NPASS;
  using Raw = typename A::Raw;
  const int g = h / kh;
  const int n_gt = (g + GT - 1) / GT;
  const int nvk = (d + E - 1) / E;  // K vectors a row
  const int nvv = (dv + E - 1) / E;  // V vectors a row
  const int n_dvc = (nvv + lanes - 1) / lanes;
  const int ch = lanes * E;  // V features a block
  int x = blockIdx.x;
  const int dc = x % n_dvc;
  x /= n_dvc;
  const int g0 = (x % n_gt) * GT;
  const int kvh = x / n_gt;
  const int gn = min(GT, g - g0);
  const int b = blockIdx.y;
  const int s = blockIdx.z;
  const int head0 = kvh * g + g0;  // the block's first query head
  const int f0 = dc * ch;
  const int fn = min(ch, dv - f0);
  const int tid = threadIdx.x;
  const int length = lengths[b];

  // q·scale and the split's block-table entries are staged while the
  // length is on its way (no K/V row is read before it is known)
  const int dq = nvk * E;  // q rows padded with zeros to whole vectors
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                                                // (GT, dq) q · scale
  int* pid_s = reinterpret_cast<int*>(q_s + GT * dq);               // the split's page ids
  float* mrg = reinterpret_cast<float*>(pid_s + PAGES_PER_SPLIT);   // (WARPS, GT, ch + 2)
  const Q* qb = q + (static_cast<int64_t>(b) * h + head0) * d;
  for (int i = tid; i < GT * dq; i += THREADS) {
    const int gi = i / dq;
    const int e = i - gi * dq;
    q_s[i] = gi < gn && e < d ? __fmul_rn(to_f32(qb[gi * d + e]), scale) : 0.f;
  }
  const int j0 = s * PAGES_PER_SPLIT;
  const int* bt = block_table + static_cast<int64_t>(b) * mpb;
  for (int j = tid; j < PAGES_PER_SPLIT; j += THREADS) pid_s[j] = j0 + j < mpb ? bt[j0 + j] : 0;

  const int n = max(0, min(length, mpb * page));
  const int n_pages = (n + page - 1) / page;
  const int ns = (n_pages + PAGES_PER_SPLIT - 1) / PAGES_PER_SPLIT;
  const bool direct = gridDim.z == 1;
  if (s >= ns) {  // past the row's last page (with S == 1: a row of length 0)
    if (direct)
      for (int i = tid; i < gn * fn; i += THREADS) {
        const int gi = i / fn;
        store(out + (static_cast<int64_t>(b) * h + head0 + gi) * dv + f0 + (i - gi * fn), 0.f);
      }
    return;
  }
  __syncthreads();

  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tp = 32 / lanes;          // tokens a pass
  const int grp = lane / lanes;       // this lane's token of a pass
  const int li = lane - grp * lanes;  // and its vector
  const int step = tp * NPASS;
  const int t0 = j0 * page;
  const int t1 = min(n, t0 + PAGES_PER_SPLIT * page);
  const int n_steps = (t1 - t0 + step - 1) / step;
  const int n_rk = (nvk + lanes - 1) / lanes;  // K vectors a lane
  const int cv = dc * lanes + li;              // this lane's V vector
  const bool v_ok = cv < nvv;

  float m[GT], l[GT], acc[GT][E];
#pragma unroll
  for (int gi = 0; gi < GT; ++gi) {
    m[gi] = NEG_INF;
    l[gi] = 0.f;
#pragma unroll
    for (int j = 0; j < E; ++j) acc[gi][j] = 0.f;
  }

  for (int k = warp; k < n_steps; k += WARPS) {
    const int base = t0 + k * step;
    int row[NPASS];  // pool rows (the wrapper keeps NP·P·KH below 2³¹)
    bool ok[NPASS];
#pragma unroll
    for (int i = 0; i < NPASS; ++i) {
      const int pos = base + i * tp + grp;
      ok[i] = pos < t1;
      const int r = (ok[i] ? pos : base) - t0;
      const int jp = page_shift >= 0 ? r >> page_shift : r / page;
      row[i] = (pid_s[jp] * page + (r - jp * page)) * kh + kvh;
    }
    // the step's V rows, then its K rows, all in flight before the dot:
    // every load unconditional, from a row and vector that exist (a token
    // past the range reads the step's first row, its p is 0; a lane past
    // the V row reads vector 0 into features that are never written out)
    Raw vr[NPASS];
#pragma unroll
    for (int i = 0; i < NPASS; ++i) vr[i] = vacc.load(row[i], v_ok ? cv : 0);
    float sc[GT][NPASS];
#pragma unroll
    for (int gi = 0; gi < GT; ++gi)
#pragma unroll
      for (int i = 0; i < NPASS; ++i) sc[gi][i] = 0.f;
    for (int rk = 0; rk < n_rk; ++rk) {
      const int c = li + rk * lanes;
      const bool c_ok = c < nvk;
      Raw kr[NPASS];
#pragma unroll
      for (int i = 0; i < NPASS; ++i) kr[i] = kacc.load(row[i], c_ok ? c : 0);
      const float* qc = q_s + (c_ok ? c : 0) * E;  // a lane past the K row adds 0·k
#pragma unroll
      for (int j = 0; j < E; ++j) {
        float qj[GT];
#pragma unroll
        for (int gi = 0; gi < GT; ++gi) qj[gi] = c_ok ? qc[gi * dq + j] : 0.f;
#pragma unroll
        for (int i = 0; i < NPASS; ++i) {
          const float kj = A::get(kr[i], j);
#pragma unroll
          for (int gi = 0; gi < GT; ++gi) sc[gi][i] = __fmaf_rn(qj[gi], kj, sc[gi][i]);
        }
      }
    }
    for (int off = 1; off < lanes; off <<= 1)  // the group's partial dots
#pragma unroll
      for (int gi = 0; gi < GT; ++gi)
#pragma unroll
        for (int i = 0; i < NPASS; ++i)
          sc[gi][i] = __fadd_rn(sc[gi][i], __shfl_xor_sync(FULL, sc[gi][i], off));

    // the online-softmax step of the warp, every lane alike
    float corr[GT], p[GT][NPASS];
#pragma unroll
    for (int gi = 0; gi < GT; ++gi) {
      float mx = NEG_INF;
#pragma unroll
      for (int i = 0; i < NPASS; ++i) {
        if (!ok[i]) sc[gi][i] = NEG_INF;
        mx = fmaxf(mx, sc[gi][i]);
      }
      for (int off = lanes; off < 32; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
      const float m_new = fmaxf(m[gi], mx);
      corr[gi] = expf(m[gi] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < NPASS; ++i) {
        p[gi][i] = expf(sc[gi][i] - m_new);
        sum = __fadd_rn(sum, p[gi][i]);
      }
      for (int off = lanes; off < 32; off <<= 1)
        sum = __fadd_rn(sum, __shfl_xor_sync(FULL, sum, off));
      l[gi] = __fadd_rn(__fmul_rn(l[gi], corr[gi]), sum);
      m[gi] = m_new;
    }
    // acc = acc·corr + Σ_pass p·v over this lane's features
#pragma unroll
    for (int j = 0; j < E; ++j) {
      float vj[NPASS];
#pragma unroll
      for (int i = 0; i < NPASS; ++i) vj[i] = A::get(vr[i], j);
#pragma unroll
      for (int gi = 0; gi < GT; ++gi) {
        float pv = __fmul_rn(p[gi][0], vj[0]);
#pragma unroll
        for (int i = 1; i < NPASS; ++i) pv = __fmaf_rn(p[gi][i], vj[i], pv);
        acc[gi][j] = __fadd_rn(__fmul_rn(acc[gi][j], corr[gi]), pv);
      }
    }
  }
  // the groups' partials of acc
  for (int off = lanes; off < 32; off <<= 1)
#pragma unroll
    for (int gi = 0; gi < GT; ++gi)
#pragma unroll
      for (int j = 0; j < E; ++j)
        acc[gi][j] = __fadd_rn(acc[gi][j], __shfl_xor_sync(FULL, acc[gi][j], off));

  const int rec = ch + 2;
  float* mw = mrg + warp * GT * rec;
  if (grp == 0)
#pragma unroll
    for (int gi = 0; gi < GT; ++gi)
#pragma unroll
      for (int j = 0; j < E; ++j) mw[gi * rec + 2 + li * E + j] = acc[gi][j];
  if (lane == 0)
#pragma unroll
    for (int gi = 0; gi < GT; ++gi) {
      mw[gi * rec] = m[gi];
      mw[gi * rec + 1] = l[gi];
    }
  __syncthreads();

  // the warps' states in warp order; the output, or the split's partial
  for (int i = tid; i < gn * fn; i += THREADS) {
    const int gi = i / fn;
    const int f = i - gi * fn;
    float mx = mrg[gi * rec];
    for (int w = 1; w < WARPS; ++w) mx = fmaxf(mx, mrg[(w * GT + gi) * rec]);
    float a = 0.f, sum = 0.f;
    for (int w = 0; w < WARPS; ++w) {
      const float* r = mrg + (w * GT + gi) * rec;
      const float e = r[0] == mx ? 1.f : expf(r[0] - mx);
      const float aw = __fmul_rn(r[2 + f], e);
      const float lw = __fmul_rn(r[1], e);
      a = w == 0 ? aw : __fadd_rn(a, aw);
      sum = w == 0 ? lw : __fadd_rn(sum, lw);
    }
    const int64_t o = static_cast<int64_t>(b) * h + head0 + gi;  // (b, head)
    if (direct) {
      store(out + o * dv + f0 + f, a / fmaxf(sum, 1e-30f));
    } else {
      float* pr = part + (static_cast<int64_t>(s) * gridDim.y * h + o) * (dv + 2);
      pr[2 + f0 + f] = a;
      if (f0 + f == 0) {
        pr[0] = mx;
        pr[1] = sum;
      }
    }
  }
}

// A row's splits 0 … ns - 1 in ascending order, one thread an output
// element; each chunk of COMBINE_CHUNK splits' values is loaded at once
// (past ns: the last split again, unused) before it is added.
template <typename Q>
__global__ void __launch_bounds__(COMBINE_THREADS)
combine_kernel(const float* __restrict__ part, const int* __restrict__ lengths,
               Q* __restrict__ out, int b_n, int h, int dv, int page, int mpb) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * COMBINE_THREADS + threadIdx.x;
  if (i >= static_cast<int64_t>(b_n) * h * dv) return;
  const int64_t bh = i / dv;  // (b, head)
  const int f = static_cast<int>(i - bh * dv);
  const int b = static_cast<int>(bh / h);
  const int n = max(0, min(lengths[b], mpb * page));
  const int ns = ((n + page - 1) / page + PAGES_PER_SPLIT - 1) / PAGES_PER_SPLIT;
  if (ns == 0) {
    store(out + i, 0.f);
    return;
  }
  const int64_t stride = static_cast<int64_t>(b_n) * h * (dv + 2);  // between splits
  const float* r = part + bh * (dv + 2);
  float mx = NEG_INF;
  for (int s0 = 0; s0 < ns; s0 += COMBINE_CHUNK) {
    float mv[COMBINE_CHUNK];
#pragma unroll
    for (int k = 0; k < COMBINE_CHUNK; ++k) mv[k] = r[min(s0 + k, ns - 1) * stride];
#pragma unroll
    for (int k = 0; k < COMBINE_CHUNK; ++k) mx = fmaxf(mx, mv[k]);
  }
  float a = 0.f, sum = 0.f;
  for (int s0 = 0; s0 < ns; s0 += COMBINE_CHUNK) {
    float mv[COMBINE_CHUNK], lv[COMBINE_CHUNK], av[COMBINE_CHUNK];
#pragma unroll
    for (int k = 0; k < COMBINE_CHUNK; ++k) {
      const float* rs = r + min(s0 + k, ns - 1) * stride;
      mv[k] = rs[0];
      lv[k] = rs[1];
      av[k] = rs[2 + f];
    }
#pragma unroll
    for (int k = 0; k < COMBINE_CHUNK; ++k) {
      if (s0 + k >= ns) break;
      const float e = mv[k] == mx ? 1.f : expf(mv[k] - mx);
      const float as = __fmul_rn(av[k], e);
      const float ls = __fmul_rn(lv[k], e);
      a = s0 + k == 0 ? as : __fadd_rn(a, as);
      sum = s0 + k == 0 ? ls : __fadd_rn(sum, ls);
    }
  }
  store(out + i, a / fmaxf(sum, 1e-30f));
}

template <typename Q, typename A, int GT>
int launch_gt(const void* q, A kacc, A vacc, const void* block_table, const void* lengths,
              void* out, void* part, int b, int h, int kh, int d, int dv, int page, int mpb,
              float scale, void* stream) {
  constexpr int E = A::E;
  const int nvk = (d + E - 1) / E;
  const int nvv = (dv + E - 1) / E;
  const int lanes = lanes_for(nvk, nvv);
  const int n_dvc = (nvv + lanes - 1) / lanes;
  const int n_gt = (h / kh + GT - 1) / GT;
  const int splits = splits_for(mpb);
  int page_shift = 0;  // log2(P), or -1 where P is no power of two
  while ((1 << page_shift) < page) ++page_shift;
  if ((1 << page_shift) != page) page_shift = -1;
  const size_t smem = smem_bytes(GT, nvk * E, lanes * E);
  auto kernel = split_kernel<Q, A, GT>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  kernel<<<dim3(kh * n_gt * n_dvc, b, splits), THREADS, smem, st>>>(
      static_cast<const Q*>(q), kacc, vacc, static_cast<const int*>(block_table),
      static_cast<const int*>(lengths), static_cast<Q*>(out), static_cast<float*>(part), h, kh,
      d, dv, page, page_shift, mpb, scale, lanes);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return static_cast<int>(e);
  const int64_t total = static_cast<int64_t>(b) * h * dv;
  combine_kernel<Q><<<static_cast<unsigned>((total + COMBINE_THREADS - 1) / COMBINE_THREADS),
                      COMBINE_THREADS, 0, st>>>(static_cast<const float*>(part),
                                                static_cast<const int*>(lengths),
                                                static_cast<Q*>(out), b, h, dv, page, mpb);
  return static_cast<int>(cudaGetLastError());
}

// Launch one call on `stream`: the split kernel, and with S > 1 the
// combine into `out`; `part` is the f32 workspace (S, B, H, Dv + 2) (null
// when S == 1).  Returns cudaGetLastError() after the launches (0 = ok).
template <typename Q, typename A>
int launch(const void* q, A kacc, A vacc, const void* block_table, const void* lengths,
           void* out, void* part, int b, int h, int kh, int d, int dv, int page, int mpb,
           float scale, void* stream) {
  if (kh <= 0 || h % kh || page <= 0 || d <= 0 || dv <= 0 ||
      (splits_for(mpb) > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0 || h == 0) return 0;
  if (h == kh)
    return launch_gt<Q, A, 1>(q, kacc, vacc, block_table, lengths, out, part, b, h, kh, d, dv,
                              page, mpb, scale, stream);
  return launch_gt<Q, A, 4>(q, kacc, vacc, block_table, lengths, out, part, b, h, kh, d, dv,
                            page, mpb, scale, stream);
}

}  // namespace paged
