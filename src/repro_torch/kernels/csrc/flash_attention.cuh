// Causal GQA flash attention for Hopper (sm_90a): the body shared by
// flash_attention.cu (f32 / bf16 K and V) and flash_attention_quant.cu
// (int8 / packed-int4 K and V with f32 scale planes).  Each source supplies
// a row reader (kv_rows.cuh) and instantiates the kernel.
//
//     out (B, Sq, H, Dv) = softmax(q·scale · Kᵀ, kpos > qpos masked) · V
//
// with q (B, Sq, H, D) f32 or bf16 and K / V (B, Skv, KH, D | Dv) in the
// layout the model holds them.  Query head h reads kv head h / (H / KH) in
// place: no KV head is repeated and nothing is transposed or copied.  Query
// row i of sequence b sits at absolute position q_start[b] + i (q_start
// null: 0, the aligned mask of a calibration walk or a cache-free forward);
// key positions count from 0.  `causal` = 0 attends to all keys.
//
// Numerics follow the Pallas bodies (repro/kernels/flash_attn.py _kernel,
// _kernel_quant) step by step, in f32, per key tile of BKV = 128 rows
// anchored at key 0 (the tile of the plain PyTorch versions and of the
// reference wrapper): q in f32 times `scale` first; the scores; -1e30 where
// kpos > qpos; the running max m_new; p = expf(s - m_new) and
// corr = expf(m - m_new); l = l·corr + Σp and acc = acc·corr + p·V, each
// with two roundings (__fmul_rn / __fadd_rn are never contracted into an
// FMA); finally acc / max(l, 1e-30) in q's dtype.  expf, not __expf, and
// no fast math.  Only the order of three f32 sums differs from the plain
// version: the D-term score dot, the tile's Σp and its p·V.  Any Sq and
// Skv: the last tiles are ragged, and a key row past Skv enters as a -1e30
// score with a zero V row, which is exactly its absence; no key past Skv
// is read.
//
// Chunking: a key tile wholly above a query row's diagonal is an exact
// no-op for that row once tile 0 has set m (p = 0, corr = 1, and p·V adds
// exact zeros), and every sum runs over a tile's columns in a fixed order.
// So a row's result depends only on its absolute position and its keys:
// it is bitwise the same whatever chunk of a prompt it arrived in and
// whatever rows share its query block.  A block skips the tiles above the
// diagonal of all its rows.
//
// Bound on an H100 SXM: operations.  The causal product takes
// 4·B·H·D·Σ_rows(qpos + 1)/2 f32 operations (67 TFLOP/s outside the tensor
// cores), against the bytes of q, K, V (codes and scales) and the output
// read or written once each.  Design, simple first: one block of 256
// threads (16 × 16) per (query tile of BQ = 64 rows, head, sequence).  Per
// key tile the block stages K (transposed, so a thread's 8 columns are
// conflict-free) and V in shared memory as f32, dequantizing a quantized
// row as it loads it; each thread computes a 4 × 8 block of scores with
// f32 FMAs on CUDA cores, one warp per 8 query rows runs the
// online-softmax step with shuffles, and each thread keeps a 4 × (Dv/16)
// block of acc in registers.  Shared memory: 117,760 B at D = 64, 158,848 B
// at D = 96, 199,936 B at D = 128 (MAX_D).  Later work (ROADMAP): tensor
// cores (mma.sync / wgmma), TMA loads of the tiles, a deeper pipeline, more
// blocks per SM.
//
// Wide heads (MAX_D < D or Dv <= WIDE_MAX_D = 256): the f32 staging above
// would take 364,288 B at D = 256, past the 232,448 B a block may hold, so
// flash_attention_wide_kernel stages less: q·scale whole (66,560 B at
// D = 256), but each 128-row key tile's K in slices of DS = 64 features
// (the transposed slice, 33,024 B) and its V in slices of DS features
// (32,768 B): 166,912 B in all at D = 256.  The order of every sum is the
// narrow kernel's: a thread carries each score's fmaf chain over e in
// ascending order across the K slices, and each output feature's p·V chain
// over the tile's rows c in ascending order within its slice; the softmax
// step is the same code.  So at D, Dv <= 128 the wide kernel is bitwise
// the narrow one (launch's `wide` switch, set only by the test entry
// points), and at D = 256 it sits within the same f32 bound of the plain
// version.  Each thread keeps a 4 × 16 block of acc (Dv 256); the V slices
// are an unrolled loop, so acc's indices are compile-time constants and
// acc stays in registers.  D and Dv are independent (e.g. 192 / 128), and
// the GQA grouping depends on H and KH only.  launch() takes the narrow
// kernel whenever D, Dv <= MAX_D, so those calls do not change.

#pragma once

#include "kv_rows.cuh"

namespace flash {

constexpr int BQ = 64;        // query rows per block
constexpr int BKV = 128;      // key rows per tile
constexpr int THREADS = 256;  // 16 x 16
constexpr int TM = BQ / 16;   // query rows per thread
constexpr int TN = BKV / 16;  // key columns per thread
constexpr int MAX_D = 128;
constexpr int TJ = MAX_D / 16;  // output features per thread, at most
constexpr int KT_STRIDE = BKV + 1;
constexpr int S_STRIDE = BKV + 4;
constexpr float NEG_INF = -1e30f;

inline size_t smem_bytes(int d, int dv) {
  return sizeof(float) * (static_cast<size_t>(BQ) * (d + 4) + static_cast<size_t>(d) * KT_STRIDE +
                          static_cast<size_t>(BKV) * dv + static_cast<size_t>(BQ) * S_STRIDE + 3 * BQ);
}

template <typename Q, typename Rows>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const Q* __restrict__ q, Rows krows, Rows vrows,
                       const int* __restrict__ q_start, Q* __restrict__ out, int sq, int skv,
                       int h, int kh, int d, int dv, float scale, int causal) {
  const int q0 = blockIdx.x * BQ;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int kv_head = head / (h / kh);
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int q_rows = min(BQ, sq - q0);
  const int q_stride_s = d + 4;
  const int pos0 = (q_start != nullptr ? q_start[b] : 0) + q0;  // row 0's position

  extern __shared__ float smem[];
  float* q_s = smem;                       // (BQ, D) q · scale, row stride q_stride_s
  float* kt_s = q_s + BQ * q_stride_s;     // (D, BKV) the K tile transposed
  float* v_s = kt_s + d * KT_STRIDE;       // (BKV, Dv) the V tile
  float* s_s = v_s + BKV * dv;             // (BQ, BKV) scores, then probabilities
  float* m_s = s_s + BQ * S_STRIDE;        // (BQ,) running max
  float* l_s = m_s + BQ;                   // (BQ,) running sum
  float* c_s = l_s + BQ;                   // (BQ,) this tile's correction

  const int64_t q_stride = static_cast<int64_t>(h) * d;  // between positions
  const Q* qb = q + (static_cast<int64_t>(b) * sq + q0) * q_stride + static_cast<int64_t>(head) * d;
  // K / V row of key position p: (b·Skv + p)·KH + kv_head
  const int64_t row0 = static_cast<int64_t>(b) * skv * kh + kv_head;

  for (int i = tid; i < BQ * d; i += THREADS) {
    const int r = i / d;
    const int e = i - r * d;
    q_s[r * q_stride_s + e] = r < q_rows ? kv::to_f32(qb[r * q_stride + e]) * scale : 0.f;
  }
  for (int r = tid; r < BQ; r += THREADS) {
    m_s[r] = NEG_INF;
    l_s[r] = 0.f;
  }
  float acc[TM][TJ];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int jj = 0; jj < TJ; ++jj) acc[i][jj] = 0.f;

  const int pos_last = pos0 + q_rows - 1;  // the block's last query position
  int n_tiles = (skv + BKV - 1) / BKV;
  if (causal) n_tiles = min(n_tiles, pos_last / BKV + 1);

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * BKV;
    const int k_rows = min(BKV, skv - k0);
    __syncthreads();  // the previous tile's readers of kt_s, v_s, s_s are done
    for (int i = tid; i < BKV * d; i += THREADS) {
      const int c = i / d;
      const int e = i - c * d;
      kt_s[e * KT_STRIDE + c] = c < k_rows ? krows(row0 + static_cast<int64_t>(k0 + c) * kh, e) : 0.f;
    }
    for (int i = tid; i < BKV * dv; i += THREADS) {
      const int c = i / dv;
      const int e = i - c * dv;
      v_s[c * dv + e] = c < k_rows ? vrows(row0 + static_cast<int64_t>(k0 + c) * kh, e) : 0.f;
    }
    __syncthreads();

    // scores: thread (ty, tx) owns rows ty·TM + i and columns tx + 16·jj
    float s[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int jj = 0; jj < TN; ++jj) s[i][jj] = 0.f;
    for (int e = 0; e < d; ++e) {
      float qv[TM], kv_[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) qv[i] = q_s[(ty * TM + i) * q_stride_s + e];
#pragma unroll
      for (int jj = 0; jj < TN; ++jj) kv_[jj] = kt_s[e * KT_STRIDE + tx + 16 * jj];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int jj = 0; jj < TN; ++jj) s[i][jj] = fmaf(qv[i], kv_[jj], s[i][jj]);
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = ty * TM + i;
#pragma unroll
      for (int jj = 0; jj < TN; ++jj) {
        const int c = tx + 16 * jj;
        const bool masked = c >= k_rows || (causal && k0 + c > pos0 + r);
        s_s[r * S_STRIDE + c] = masked ? NEG_INF : s[i][jj];
      }
    }
    __syncthreads();

    // the online-softmax step: warp w owns rows w·(BQ/8) … w·(BQ/8) + BQ/8 - 1
    for (int rr = 0; rr < BQ / (THREADS / 32); ++rr) {
      const int r = warp * (BQ / (THREADS / 32)) + rr;
      float* sr = s_s + r * S_STRIDE;
      float mx = NEG_INF;
      for (int c = lane; c < BKV; c += 32) mx = fmaxf(mx, sr[c]);
      for (int off = 16; off; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int c = lane; c < BKV; c += 32) {
        const float p = expf(sr[c] - m_new);
        sr[c] = p;
        sum += p;
      }
      for (int off = 16; off; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        l_s[r] = __fadd_rn(__fmul_rn(l_s[r], corr), sum);
        m_s[r] = m_new;
        c_s[r] = corr;
      }
    }
    __syncthreads();

    // acc = acc·corr + p·V over the tile's rows (masked p are exactly 0)
    int c_end = k_rows;
    if (causal) c_end = min(c_end, pos_last - k0 + 1);
    float pv[TM][TJ];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int jj = 0; jj < TJ; ++jj) pv[i][jj] = 0.f;
    for (int c = 0; c < c_end; ++c) {
      float pr[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) pr[i] = s_s[(ty * TM + i) * S_STRIDE + c];
#pragma unroll
      for (int jj = 0; jj < TJ; ++jj) {
        const int e = tx + 16 * jj;
        if (e < dv) {
          const float vv = v_s[c * dv + e];
#pragma unroll
          for (int i = 0; i < TM; ++i) pv[i][jj] = fmaf(pr[i], vv, pv[i][jj]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const float corr = c_s[ty * TM + i];
#pragma unroll
      for (int jj = 0; jj < TJ; ++jj) acc[i][jj] = __fadd_rn(__fmul_rn(acc[i][jj], corr), pv[i][jj]);
    }
  }

  // l_s is final: its last writer passed the loop's last barrier
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = ty * TM + i;
    if (r >= q_rows) continue;
    const float denom = fmaxf(l_s[r], 1e-30f);
    Q* orow = out + ((static_cast<int64_t>(b) * sq + q0 + r) * h + head) * dv;
#pragma unroll
    for (int jj = 0; jj < TJ; ++jj) {
      const int e = tx + 16 * jj;
      if (e < dv) kv::store(orow + e, acc[i][jj] / denom);
    }
  }
}

constexpr int WIDE_MAX_D = 256;
constexpr int DS = 64;                       // features per staged K / V slice
constexpr int WIDE_SLICES = WIDE_MAX_D / DS;
constexpr int SJ = DS / 16;                  // output features per thread per slice
constexpr int WIDE_TJ = WIDE_MAX_D / 16;     // output features per thread, at most

inline size_t wide_smem_bytes(int d) {
  return sizeof(float) * (static_cast<size_t>(BQ) * (d + 4) + static_cast<size_t>(DS) * KT_STRIDE +
                          static_cast<size_t>(BKV) * DS + static_cast<size_t>(BQ) * S_STRIDE + 3 * BQ);
}

template <typename Q, typename Rows>
__global__ void __launch_bounds__(THREADS)
flash_attention_wide_kernel(const Q* __restrict__ q, Rows krows, Rows vrows,
                            const int* __restrict__ q_start, Q* __restrict__ out, int sq,
                            int skv, int h, int kh, int d, int dv, float scale, int causal) {
  const int q0 = blockIdx.x * BQ;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int kv_head = head / (h / kh);
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int q_rows = min(BQ, sq - q0);
  const int q_stride_s = d + 4;
  const int pos0 = (q_start != nullptr ? q_start[b] : 0) + q0;  // row 0's position

  extern __shared__ float smem[];
  float* q_s = smem;                       // (BQ, D) q · scale, row stride q_stride_s
  float* kt_s = q_s + BQ * q_stride_s;     // (DS, BKV) one D slice of the K tile, transposed
  float* v_s = kt_s + DS * KT_STRIDE;      // (BKV, DS) one Dv slice of the V tile
  float* s_s = v_s + BKV * DS;             // (BQ, BKV) scores, then probabilities
  float* m_s = s_s + BQ * S_STRIDE;        // (BQ,) running max
  float* l_s = m_s + BQ;                   // (BQ,) running sum
  float* c_s = l_s + BQ;                   // (BQ,) this tile's correction

  const int64_t q_stride = static_cast<int64_t>(h) * d;  // between positions
  const Q* qb = q + (static_cast<int64_t>(b) * sq + q0) * q_stride + static_cast<int64_t>(head) * d;
  const int64_t row0 = static_cast<int64_t>(b) * skv * kh + kv_head;

  for (int i = tid; i < BQ * d; i += THREADS) {
    const int r = i / d;
    const int e = i - r * d;
    q_s[r * q_stride_s + e] = r < q_rows ? kv::to_f32(qb[r * q_stride + e]) * scale : 0.f;
  }
  for (int r = tid; r < BQ; r += THREADS) {
    m_s[r] = NEG_INF;
    l_s[r] = 0.f;
  }
  float acc[TM][WIDE_TJ];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int jj = 0; jj < WIDE_TJ; ++jj) acc[i][jj] = 0.f;

  const int pos_last = pos0 + q_rows - 1;
  int n_tiles = (skv + BKV - 1) / BKV;
  if (causal) n_tiles = min(n_tiles, pos_last / BKV + 1);

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * BKV;
    const int k_rows = min(BKV, skv - k0);

    // scores: thread (ty, tx) owns rows ty·TM + i and columns tx + 16·jj;
    // each fmaf chain runs over e = 0 … D-1 across the slices
    float s[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int jj = 0; jj < TN; ++jj) s[i][jj] = 0.f;
    for (int e0 = 0; e0 < d; e0 += DS) {
      const int ds = min(DS, d - e0);
      __syncthreads();  // the readers of the previous slice (or tile) are done
      for (int i = tid; i < BKV * ds; i += THREADS) {
        const int c = i / ds;
        const int e = i - c * ds;
        kt_s[e * KT_STRIDE + c] =
            c < k_rows ? krows(row0 + static_cast<int64_t>(k0 + c) * kh, e0 + e) : 0.f;
      }
      __syncthreads();
      for (int e = 0; e < ds; ++e) {
        float qv[TM], kv_[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) qv[i] = q_s[(ty * TM + i) * q_stride_s + e0 + e];
#pragma unroll
        for (int jj = 0; jj < TN; ++jj) kv_[jj] = kt_s[e * KT_STRIDE + tx + 16 * jj];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int jj = 0; jj < TN; ++jj) s[i][jj] = fmaf(qv[i], kv_[jj], s[i][jj]);
      }
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = ty * TM + i;
#pragma unroll
      for (int jj = 0; jj < TN; ++jj) {
        const int c = tx + 16 * jj;
        const bool masked = c >= k_rows || (causal && k0 + c > pos0 + r);
        s_s[r * S_STRIDE + c] = masked ? NEG_INF : s[i][jj];
      }
    }
    __syncthreads();

    // the online-softmax step, as the narrow kernel's
    for (int rr = 0; rr < BQ / (THREADS / 32); ++rr) {
      const int r = warp * (BQ / (THREADS / 32)) + rr;
      float* sr = s_s + r * S_STRIDE;
      float mx = NEG_INF;
      for (int c = lane; c < BKV; c += 32) mx = fmaxf(mx, sr[c]);
      for (int off = 16; off; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int c = lane; c < BKV; c += 32) {
        const float p = expf(sr[c] - m_new);
        sr[c] = p;
        sum += p;
      }
      for (int off = 16; off; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        l_s[r] = __fadd_rn(__fmul_rn(l_s[r], corr), sum);
        m_s[r] = m_new;
        c_s[r] = corr;
      }
    }

    // acc = acc·corr + p·V, one Dv slice at a time (unrolled: acc's index
    // is then known at compile time and acc stays in registers)
    int c_end = k_rows;
    if (causal) c_end = min(c_end, pos_last - k0 + 1);
#pragma unroll
    for (int sl = 0; sl < WIDE_SLICES; ++sl) {
      const int e0 = sl * DS;
      if (e0 < dv) {  // the same for every thread: the barriers stay uniform
        const int ds = min(DS, dv - e0);
        __syncthreads();  // the step above, or the previous slice's readers, are done
        for (int i = tid; i < BKV * ds; i += THREADS) {
          const int c = i / ds;
          const int e = i - c * ds;
          v_s[c * DS + e] =
              c < k_rows ? vrows(row0 + static_cast<int64_t>(k0 + c) * kh, e0 + e) : 0.f;
        }
        __syncthreads();
        float pv[TM][SJ];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int jj = 0; jj < SJ; ++jj) pv[i][jj] = 0.f;
        for (int c = 0; c < c_end; ++c) {
          float pr[TM];
#pragma unroll
          for (int i = 0; i < TM; ++i) pr[i] = s_s[(ty * TM + i) * S_STRIDE + c];
#pragma unroll
          for (int jj = 0; jj < SJ; ++jj) {
            const int e = tx + 16 * jj;
            if (e < ds) {
              const float vv = v_s[c * DS + e];
#pragma unroll
              for (int i = 0; i < TM; ++i) pv[i][jj] = fmaf(pr[i], vv, pv[i][jj]);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float corr = c_s[ty * TM + i];
#pragma unroll
          for (int jj = 0; jj < SJ; ++jj)
            acc[i][sl * SJ + jj] = __fadd_rn(__fmul_rn(acc[i][sl * SJ + jj], corr), pv[i][jj]);
        }
      }
    }
  }

  __syncthreads();  // l_s is final (with no key tile: its initial 0 is visible)
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = ty * TM + i;
    if (r >= q_rows) continue;
    const float denom = fmaxf(l_s[r], 1e-30f);
    Q* orow = out + ((static_cast<int64_t>(b) * sq + q0 + r) * h + head) * dv;
#pragma unroll
    for (int jj = 0; jj < WIDE_TJ; ++jj) {
      const int e = tx + 16 * jj;
      if (e < dv) kv::store(orow + e, acc[i][jj] / denom);
    }
  }
}

template <typename Kernel, typename Q, typename Rows>
int launch_kernel(Kernel kernel, size_t smem, const void* q, Rows krows, Rows vrows,
                  const void* q_start, void* out, int b, int sq, int skv, int h, int kh,
                  int d, int dv, float scale, int causal, void* stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((sq + BQ - 1) / BQ, h, b);
  kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Q*>(q), krows, vrows, static_cast<const int*>(q_start),
      static_cast<Q*>(out), sq, skv, h, kh, d, dv, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

// Launch one (query tile, head, sequence) block each on `stream`: the
// narrow kernel for D, Dv <= MAX_D, the wide one up to WIDE_MAX_D (or for
// any D, Dv <= WIDE_MAX_D when `wide`, the test entry points' switch);
// returns cudaGetLastError() after the launch (0 = ok).
template <typename Q, typename Rows>
int launch(const void* q, Rows krows, Rows vrows, const void* q_start, void* out, int b, int sq,
           int skv, int h, int kh, int d, int dv, float scale, int causal, void* stream,
           bool wide = false) {
  if (d > WIDE_MAX_D || dv > WIDE_MAX_D || kh == 0 || h % kh)
    return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0 || sq == 0 || h == 0) return 0;
  if (!wide && d <= MAX_D && dv <= MAX_D)
    return launch_kernel<decltype(&flash_attention_kernel<Q, Rows>), Q>(
        flash_attention_kernel<Q, Rows>, smem_bytes(d, dv), q, krows, vrows, q_start, out, b,
        sq, skv, h, kh, d, dv, scale, causal, stream);
  return launch_kernel<decltype(&flash_attention_wide_kernel<Q, Rows>), Q>(
      flash_attention_wide_kernel<Q, Rows>, wide_smem_bytes(d), q, krows, vrows, q_start, out,
      b, sq, skv, h, kh, d, dv, scale, causal, stream);
}

}  // namespace flash
