// Causal GQA flash attention for Hopper (sm_90a) on the tensor cores: the
// body shared by flash_attention.cu (f32 / bf16 K and V) and
// flash_attention_quant.cu (int8 / packed-int4 K and V with f32 scale
// planes).  Each source supplies a row reader (kv_rows.cuh) and
// instantiates the kernel.
//
//     out (B, Sq, H, Dv) = softmax(q·scale · Kᵀ, kpos > qpos masked) · V
//
// with q (B, Sq, H, D) f32 or bf16 and K / V (B, Skv, KH, D | Dv) in the
// layout the model holds them, D and Dv independent, each up to MAX_D = 256.
// Query head h reads kv head h / (H / KH) in place: no KV head is repeated
// and nothing is transposed or copied.  Query row i of sequence b sits at
// absolute position q_start[b] + i (q_start null: 0, the aligned mask of a
// calibration walk or a cache-free forward); key positions count from 0.
// `causal` = 0 attends to all keys.
//
// Numerics follow the Pallas bodies (repro/kernels/flash_attn.py _kernel,
// _kernel_quant) step by step, in f32, per key tile of BKV = 128 rows
// anchored at key 0 (the tile of the plain PyTorch versions and of the
// reference wrapper): q in f32 times `scale` first; the scores; -1e30 where
// kpos > qpos or past Skv; the running max m_new; p = expf(s - m_new) and
// corr = expf(m - m_new); l = l·corr + Σp and acc = acc·corr + pv, each
// with two roundings (__fmul_rn / __fadd_rn are never contracted into an
// FMA), pv being the tile's P·V; finally acc / max(l, 1e-30) in q's dtype.
// expf, not __expf, and no fast math.
//
// The two products, q·Kᵀ and P·V, run on the tensor cores as
// mma.sync.m16n8k8 in TF32, three passes ("3xTF32"): each f32 operand x is
// split into hi = tf32_rna(x) and lo = tf32_rna(x - hi), tf32_rna rounding
// as cvt.rna.tf32.f32 does (to nearest, ties away from zero, the 13 low
// bits cleared) by an integer add and mask; hi·hi is
// accumulated in one f32 accumulator, hi·lo + lo·hi in another, and the two
// are added in f32 round-to-nearest when the tile's product is done (the
// cross terms are ~2⁻¹¹ of hi·hi, so keeping them apart keeps the large
// accumulator's error to one chain).  lo·lo is dropped.  A D or Dv that is
// not a multiple of 8 is padded with zero features in shared memory, which
// add exact zeros.
//
// Accuracy standard (u = 2⁻²⁴; chip_smoke.py _flash_tolerance implements
// it, and a fatal sub-phase of its phase 3 probes both premises on the card
// through flash_attention_probe below).
//
//   Premise 1.  tf32_rna rounds to nearest (ties away from zero) and
//   clears the 13 low bits: |x - hi| <= 2⁻¹¹|x| and, x - hi being exact
//   in f32, |x - hi - lo| <= 2⁻¹¹|x - hi| <= 2⁻²²|x| (plus 2⁻¹³⁷ where a
//   residual is subnormal).  With A = hi_a + lo_a, a product keeps
//   hi_a·hi_b + hi_a·lo_b + lo_a·hi_b and drops lo_a·lo_b + A·(b - hi_b -
//   lo_b) + (a - A)·b, at most 3·2⁻²²(1 + 2⁻¹⁰)|a·b| = 12(1 + 2⁻¹⁰)·u·|a·b|.
//   tf32 x tf32 products (11-bit significands) are exact in the unit.
//
//   Premise 2.  One mma adds its k = 8 products and its C operand with
//   truncated alignment and no round-to-nearest.  Model: its result is
//   within (k + 1)·2⁻²³ = 18u of its largest addend of the exact sum.
//
//   A score over D features takes n = ceil(D / 8) mmas per pass.  The hi·hi
//   chain's addends are at most T(1 + 2⁻¹⁰)(1 + 18nu), T = Σ_d |q_d·scale·
//   k_d|, so the chain errs by at most 18n(1 + 2⁻⁹)·u·T; the cross chain's
//   addends are ~2⁻¹⁰ of those (18n·2⁻¹⁰(1 + 2⁻¹⁰)·u·T); the final add one
//   rounding (u·T(1 + 2⁻⁹)); the split 12(1 + 2⁻¹⁰)·u·T.  In all, the
//   kernel's score is within (18n + 13)(1 + 2⁻⁸)·u·T of the exact one, and
//   T <= S = Σ_d |q_d·scale|·max_keys |k_d|.  The plain version's f32
//   product errs by D·u·S (to first order), so |kernel - plain| <=
//   (18n + 13 + D)(1 + 2⁻⁸)·u·S per score: (3.25·D + 13)(1 + 2⁻⁸)·u·S for
//   D a multiple of 8.  A tile's pv is the same product over the tile's 128 keys
//   (16 mmas a pass): within (18·16 + 13)(1 + 2⁻⁸)·u of Σ|p·v| <=
//   max|v|·Σp.  Σp stays an f32 sum on the CUDA cores (each thread's 32
//   terms in order, then two shuffles), l and acc take two roundings a tile,
//   so with N = qpos + 1 keys over `tiles` tiles the output errs by at most
//   max|v|·u·(N + 2·tiles + 4) through l and max|v|·u·((18·16 + 13)(1 + 2⁻⁸)
//   + 2·tiles + 4) through acc; the plain version's sums by max|v|·u·(N +
//   2·tiles + 4) each.  Scores off by at most δ move the softmax weights by
//   factors within e^(±δ), the output by at most 2·δ·max|v|.  The formula is
//   a function of the inputs alone, never fitted to measured errors.
//
// Chunking: a key tile wholly above a query row's diagonal is an exact
// no-op for that row once tile 0 has set m (p = 0, corr = 1, pv an mma
// chain of zero products from a zero accumulator), every sum runs over a
// tile's columns in a fixed order, and an mma computes each output element
// from its own row of A.  So a row's result depends only on its absolute
// position and its keys: it is bitwise the same whatever chunk of a prompt
// it arrived in and whatever rows share its query block.  A block reads no
// key past its last row's position (nor past Skv); such rows enter as zeros
// with -1e30 scores.  A block skips the tiles above the diagonal of all its
// rows, and the q·Kᵀ of a 64-key half tile that lies wholly there.
//
// Bound on an H100 SXM: operations.  The causal products take
// 2·B·H·(D + Dv)·Σ_rows(qpos + 1) f32 operations, three TF32 passes of them
// at 495 TFLOP/s (chip_smoke.py prints the same count at the non-tensor f32 rate
// beside it), against the bytes of q, K, V (codes and scales) and the output
// moved once each.  Design: one block of 4 warps per (query tile of BQ = 64
// rows, head, Dv chunk of up to 128 features, sequence), the longest query
// tiles launched first; each warp owns 16 query rows.  q·scale sits whole in
// shared memory as f32 (row stride D + 4 padded to 8, so the A fragments load
// without bank conflicts); K and V stream through a ring of three 18 KB units
// in shared memory: K in units of 64 keys × 64 features, V in units of 128
// keys × 32 features.  f32 and bf16 rows (bf16 kept as bf16: exact in TF32)
// arrive by 16-byte cp.async, two units ahead of the one computed, one block
// barrier a unit; quantized rows are dequantized as they are staged (one
// __fmul_rn an element, as kv_rows.cuh's readers), a 32-bit word of one
// group's codes at a time.  A warp keeps its 16 × 128 scores (64 f32 a
// thread) and its 16 × Dv-chunk accumulator (up to 64 a thread) in registers;
// the accumulator layout of m16n8k8 serves as P's A fragment once the tile's
// 8 keys of each k-step are taken in the order (0, 2, 4, 6, 1, 3, 5, 7), with
// V's rows read in the same order, so P never leaves the registers.  A Dv
// above 128 takes a second block per (query tile, head), which computes the
// same scores again (bitwise) for its half of Dv.  The V units run as a loop,
// not unrolled, which keeps the body's code small; the k-steps of P·V past
// the block's last key are skipped (zero products, which the probe shows
// leave an accumulator bitwise as it is).

#pragma once

#include "kv_rows.cuh"

namespace flash {

constexpr int BQ = 64;                // query rows per block
constexpr int WARPS = BQ / 16;        // one warp per 16 query rows
constexpr int THREADS = 32 * WARPS;
constexpr int BKV = 128;              // key rows per tile
constexpr int MAX_D = 256;            // the widest D and Dv
constexpr int KU_ROWS = 64;           // a K unit: 64 keys x 64 features
constexpr int KU_COLS = 64;
constexpr int VU_COLS = 32;           // a V unit: 128 keys x 32 features
constexpr int STAGES = 3;             // units in flight
constexpr int UNIT_BYTES = 4 * BKV * (VU_COLS + 4);  // 18,432: the largest unit
constexpr float NEG_INF = -1e30f;

// Row strides of the staged units, in elements of the staged type S: one
// 16-byte chunk of padding, so the B fragments load without bank conflicts.
template <typename S>
struct Layout {
  static constexpr int PAD = 16 / static_cast<int>(sizeof(S));
  static constexpr int SK = KU_COLS + PAD;
  static constexpr int SV = VU_COLS + PAD;
};

// Shared memory of a block: q·scale (BQ rows of D padded to 8, plus 4)
// and the ring of K/V units.
inline size_t smem_bytes(int d) {
  return sizeof(float) * BQ * (((d + 7) & ~7) + 4) + static_cast<size_t>(STAGES) * UNIT_BYTES;
}

// x rounded to TF32 as cvt.rna.tf32.f32 rounds a finite x: to nearest,
// ties away from zero, the 13 low bits cleared; by an integer add and mask
// (two integer operations, where the conversion unit takes a quarter of the
// issue rate), which the probe holds bitwise against cvt.rna itself.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ uint32_t tf32_cvt_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo + (at most 2⁻²²|x|): the split of every operand
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(__fsub_rn(x, __uint_as_float(hi)));
}

// d += a · b on the tensor cores (m16n8k8, TF32 in, f32 accumulate); the
// fragments in the PTX ISA's layout: with g = lane / 4 and t = lane % 4,
// a = A(g, t), A(g + 8, t), A(g, t + 4), A(g + 8, t + 4); b = B(t, g),
// B(t + 4, g); d = D(g, 2t), D(g, 2t + 1), D(g + 8, 2t), D(g + 8, 2t + 1).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s), "l"(gmem),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

template <typename S>
__device__ __forceinline__ S zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() { return __float2bfloat16_rn(0.f); }

// How a row reader's elements reach shared memory: f32 and bf16 rows as
// they are (S = their type; by cp.async where the rows are 16-byte
// aligned), quantized rows dequantized to f32 by the reader.
template <typename Rows>
struct Staging;

template <typename T>
struct Staging<kv::FloatRows<T>> {
  using S = T;
  static constexpr bool ASYNC = true;
  __device__ static const T* at(const kv::FloatRows<T>& r, int64_t row, int i) {
    return r.data + row * r.width + i;
  }
  __device__ static T value(const kv::FloatRows<T>& r, int64_t row, int i) {
    return *at(r, row, i);
  }
};

// Codes dequantize as kv_rows.cuh's readers do (one __fmul_rn an element);
// where the rows allow it (`vec`), VEC codes of one group at a time from
// one 32-bit load (the readers' `vec`).
template <>
struct Staging<kv::Int8Rows> {
  using S = float;
  static constexpr bool ASYNC = false;
  static constexpr int VEC = 4;
  __device__ static float value(const kv::Int8Rows& r, int64_t row, int i) { return r(row, i); }
};

template <>
struct Staging<kv::Int4Rows> {
  using S = float;
  static constexpr bool ASYNC = false;
  static constexpr int VEC = 8;
  __device__ static float value(const kv::Int4Rows& r, int64_t row, int i) { return r(row, i); }
};

// Stage ROWS key rows (key0 + r, those at or past key_end as zeros) of
// COLS features (f0 + c, those at or past `width` as zeros) into `buf`,
// row stride STRIDE.  `vec`: the rows are aligned for whole chunks, so f32
// and bf16 rows go by 16-byte cp.async (the caller commits the group) and
// codes by 32-bit loads of one group's VEC codes, all loads first.
template <typename Rows, int ROWS, int COLS, int STRIDE>
__device__ __forceinline__ void stage_unit(typename Staging<Rows>::S* buf, const Rows& rows,
                                           int64_t row0, int kh, int key0, int key_end, int f0,
                                           int width, bool vec) {
  using St = Staging<Rows>;
  using S = typename St::S;
  if constexpr (!St::ASYNC) {
    if (vec) {
      constexpr int VEC = St::VEC;
      constexpr int CPR = COLS / VEC;  // chunks a row
      constexpr int N = ROWS * CPR / THREADS;
      float v[N][VEC];
#pragma unroll
      for (int it = 0; it < N; ++it) {
        const int i = threadIdx.x + it * THREADS;
        const int r = i / CPR;
        const int c = (i % CPR) * VEC;
        if (key0 + r < key_end && f0 + c < width) {
          rows.template vec<VEC>(row0 + static_cast<int64_t>(key0 + r) * kh, f0 + c, v[it]);
        } else {
#pragma unroll
          for (int j = 0; j < VEC; ++j) v[it][j] = 0.f;
        }
      }
#pragma unroll
      for (int it = 0; it < N; ++it) {
        const int i = threadIdx.x + it * THREADS;
        float* dst = buf + (i / CPR) * STRIDE + (i % CPR) * VEC;
#pragma unroll
        for (int j = 0; j < VEC; j += 4)
          *reinterpret_cast<float4*>(dst + j) = make_float4(v[it][j], v[it][j + 1], v[it][j + 2],
                                                            v[it][j + 3]);
      }
      return;
    }
  }
  if constexpr (St::ASYNC) {
    if (vec) {
      constexpr int VEC = 16 / static_cast<int>(sizeof(S));
      constexpr int CPR = COLS / VEC;  // 16-byte chunks a row
#pragma unroll
      for (int it = 0; it < ROWS * CPR / THREADS; ++it) {
        const int i = threadIdx.x + it * THREADS;
        const int r = i / CPR;
        const int c = (i % CPR) * VEC;
        const bool ok = key0 + r < key_end && f0 + c < width;
        const S* src = ok ? St::at(rows, row0 + static_cast<int64_t>(key0 + r) * kh, f0 + c)
                          : rows.data;
        cp_async16(buf + r * STRIDE + c, src, ok);
      }
      return;
    }
  }
#pragma unroll 8
  for (int it = 0; it < ROWS * COLS / THREADS; ++it) {
    const int i = threadIdx.x + it * THREADS;
    const int r = i / COLS;
    const int c = i % COLS;
    buf[r * STRIDE + c] = key0 + r < key_end && f0 + c < width
                              ? St::value(rows, row0 + static_cast<int64_t>(key0 + r) * kh, f0 + c)
                              : zero<S>();
  }
}

template <typename Q, typename Rows, int DVB>
__global__ void __launch_bounds__(THREADS, 2)
flash_attention_kernel(const Q* __restrict__ q, Rows krows, Rows vrows,
                       const int* __restrict__ q_start, Q* __restrict__ out, int sq, int skv,
                       int h, int kh, int d, int dv, float scale, int causal, int vec) {
  using S = typename Staging<Rows>::S;
  using L = Layout<S>;
  const int n_dvc = (dv + DVB - 1) / DVB;
  const int head = blockIdx.x / n_dvc;
  const int dv0 = (blockIdx.x - head * n_dvc) * DVB;  // this block's output features
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;   // the longest query tiles first
  const int kv_head = head / (h / kh);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int q_rows = min(BQ, sq - q0);
  const int dp = (d + 7) & ~7;
  const int qs_stride = dp + 4;
  const int pos0 = (q_start != nullptr ? q_start[b] : 0) + q0;  // row 0's position
  const int key_end = causal ? min(skv, pos0 + q_rows) : skv;   // no key at or past it is read
  const int n_tiles = (key_end + BKV - 1) / BKV;
  const int n_ks = (dp + KU_COLS - 1) / KU_COLS;                // K units per 64-key half
  const int n_vu = (min(DVB, dv - dv0) + VU_COLS - 1) / VU_COLS;  // V units per tile
  const int units = 2 * n_ks + n_vu;
  const int n_units = n_tiles * units;

  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);  // (BQ, dp) q · scale, row stride qs_stride
  unsigned char* ring = smem + sizeof(float) * BQ * qs_stride;

  // K / V row of key position p: (b·Skv + p)·KH + kv_head
  const int64_t row0 = static_cast<int64_t>(b) * skv * kh + kv_head;

  // unit u of the block's sequence: tile u / units; within it the K units
  // (half, slice) in order, then the V units
  auto stage = [&](int u) {
    if (u >= n_units) return;
    const int j = u / units;
    const int x = u - j * units;
    S* buf = reinterpret_cast<S*>(ring + (u % STAGES) * UNIT_BYTES);
    if (x < 2 * n_ks) {
      const int half = x / n_ks;
      stage_unit<Rows, KU_ROWS, KU_COLS, L::SK>(buf, krows, row0, kh, j * BKV + half * KU_ROWS,
                                                key_end, (x - half * n_ks) * KU_COLS, d, vec);
    } else {
      stage_unit<Rows, BKV, VU_COLS, L::SV>(buf, vrows, row0, kh, j * BKV, key_end,
                                            dv0 + (x - 2 * n_ks) * VU_COLS, dv, vec);
    }
  };
  stage(0);
  cp_async_commit();
  stage(1);
  cp_async_commit();

  const int64_t q_stride = static_cast<int64_t>(h) * d;  // between positions
  const Q* qb = q + (static_cast<int64_t>(b) * sq + q0) * q_stride + static_cast<int64_t>(head) * d;
  for (int r = warp; r < BQ; r += WARPS)
    for (int e = lane; e < dp; e += 32)
      q_s[r * qs_stride + e] =
          r < q_rows && e < d ? __fmul_rn(kv::to_f32(qb[r * q_stride + e]), scale) : 0.f;

  // the next unit: landed and visible to all, the unit two ahead staged
  // into the buffer every thread has finished reading
  int u = 0;
  auto next = [&]() -> const S* {
    cp_async_wait<1>();
    __syncthreads();
    stage(u + 2);
    cp_async_commit();
    const S* buf = reinterpret_cast<const S*>(ring + (u % STAGES) * UNIT_BYTES);
    ++u;
    return buf;
  };

  const int r0 = warp * 16 + g;  // this thread's rows: r0 and r0 + 8
  const int qpos0 = pos0 + r0;
  const int qpos1 = qpos0 + 8;
  float o[DVB / 8][4];
#pragma unroll
  for (int nb = 0; nb < DVB / 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nb][e] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
  float s[BKV / 8][4];  // the tile's scores of rows r0, r0 + 8, then their p

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * BKV;

    // s = (q·scale)·Kᵀ, one 64-key half at a time: hi·hi in s, the cross
    // terms in sm, over the D slices in ascending order
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float sm[8][4];
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[half * 8 + nb][e] = sm[nb][e] = 0.f;
      const bool live = k0 + half * KU_ROWS < key_end;  // else every score is masked
      for (int sl = 0; sl < n_ks; ++sl) {
        const S* kb = next();
        if (!live) continue;
        const int f0 = sl * KU_COLS;
        const int n_k = min(KU_COLS, dp - f0) / 8;
        for (int ks = 0; ks < n_k; ++ks) {
          const float* qa = q_s + r0 * qs_stride + f0 + ks * 8 + t;
          uint32_t ah[4], al[4];
          split(qa[0], ah[0], al[0]);
          split(qa[8 * qs_stride], ah[1], al[1]);
          split(qa[4], ah[2], al[2]);
          split(qa[8 * qs_stride + 4], ah[3], al[3]);
#pragma unroll
          for (int nb = 0; nb < 8; ++nb) {
            const S* kr = kb + (nb * 8 + g) * L::SK + ks * 8 + t;
            uint32_t bh0, bl0, bh1, bl1;
            split(kv::to_f32(kr[0]), bh0, bl0);
            split(kv::to_f32(kr[4]), bh1, bl1);
            mma_tf32(s[half * 8 + nb], ah, bh0, bh1);
            mma_tf32(sm[nb], ah, bl0, bl1);
            mma_tf32(sm[nb], al, bh0, bh1);
          }
        }
      }
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[half * 8 + nb][e] = __fadd_rn(s[half * 8 + nb][e], sm[nb][e]);
    }

    // the online-softmax step; s[nb][e] is key k0 + 8·nb + 2t + (e & 1) of
    // row r0 (e < 2) or r0 + 8; a row's four threads (one quad) combine
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int nb = 0; nb < BKV / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + nb * 8 + 2 * t + (e & 1);
        if (key >= skv || (causal && key > (e < 2 ? qpos0 : qpos1))) s[nb][e] = NEG_INF;
        if (e < 2)
          mx0 = fmaxf(mx0, s[nb][e]);
        else
          mx1 = fmaxf(mx1, s[nb][e]);
      }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0);
    const float mn1 = fmaxf(m1, mx1);
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int nb = 0; nb < BKV / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(__fsub_rn(s[nb][e], e < 2 ? mn0 : mn1));
        s[nb][e] = p;
        if (e < 2)
          sum0 = __fadd_rn(sum0, p);
        else
          sum1 = __fadd_rn(sum1, p);
      }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      sum0 = __fadd_rn(sum0, __shfl_xor_sync(0xffffffffu, sum0, off));
      sum1 = __fadd_rn(sum1, __shfl_xor_sync(0xffffffffu, sum1, off));
    }
    const float c0 = expf(__fsub_rn(m0, mn0));
    const float c1 = expf(__fsub_rn(m1, mn1));
    l0 = __fadd_rn(__fmul_rn(l0, c0), sum0);
    l1 = __fadd_rn(__fmul_rn(l1, c1), sum1);
    m0 = mn0;
    m1 = mn1;

    // acc = acc·corr + P·V, one V unit (32 output features) at a time; the
    // k-step over keys 8kk… takes them as (0, 2, 4, 6, 1, 3, 5, 7), so P's
    // A fragment is the score accumulator as it stands
    const int kk_end = min(BKV, key_end - k0);  // the tile's keys any row may attend
    for (int vu = 0; vu < n_vu; ++vu) {
      const S* vb = next();
      float pb[4][4], ps[4][4];
#pragma unroll
      for (int nb = 0; nb < 4; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) pb[nb][e] = ps[nb][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < BKV / 8; ++kk) {
        if (kk * 8 >= kk_end) break;  // P is zero there: zero products leave pv as it is
        uint32_t ah[4], al[4];
        split(s[kk][0], ah[0], al[0]);
        split(s[kk][2], ah[1], al[1]);
        split(s[kk][1], ah[2], al[2]);
        split(s[kk][3], ah[3], al[3]);
#pragma unroll
        for (int nb = 0; nb < 4; ++nb) {
          const S* vr = vb + (kk * 8 + 2 * t) * L::SV + nb * 8 + g;
          uint32_t bh0, bl0, bh1, bl1;
          split(kv::to_f32(vr[0]), bh0, bl0);
          split(kv::to_f32(vr[L::SV]), bh1, bl1);
          mma_tf32(pb[nb], ah, bh0, bh1);
          mma_tf32(ps[nb], ah, bl0, bl1);
          mma_tf32(ps[nb], al, bh0, bh1);
        }
      }
      // o's indices must be compile-time constants to stay in registers
#pragma unroll
      for (int c = 0; c < DVB / VU_COLS; ++c)
        if (c == vu)
#pragma unroll
          for (int nb = 0; nb < 4; ++nb)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              o[c * 4 + nb][e] = __fadd_rn(__fmul_rn(o[c * 4 + nb][e], e < 2 ? c0 : c1),
                                           __fadd_rn(pb[nb][e], ps[nb][e]));
    }
  }
  cp_async_wait<0>();

  const float den0 = fmaxf(l0, 1e-30f);
  const float den1 = fmaxf(l1, 1e-30f);
#pragma unroll
  for (int nb = 0; nb < DVB / 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + (e < 2 ? 0 : 8);
      const int col = dv0 + nb * 8 + 2 * t + (e & 1);
      if (r < q_rows && col < dv)
        kv::store(out + ((static_cast<int64_t>(b) * sq + q0 + r) * h + head) * dv + col,
                  o[nb][e] / (e < 2 ? den0 : den1));
    }
}

template <typename Q, typename Rows, int DVB>
int launch_kernel(const void* q, Rows krows, Rows vrows, const void* q_start, void* out, int b,
                  int sq, int skv, int h, int kh, int d, int dv, float scale, int causal,
                  bool vec, void* stream) {
  auto kernel = flash_attention_kernel<Q, Rows, DVB>;
  const size_t smem = smem_bytes(d);
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(h * ((dv + DVB - 1) / DVB), b, (sq + BQ - 1) / BQ);
  kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Q*>(q), krows, vrows, static_cast<const int*>(q_start),
      static_cast<Q*>(out), sq, skv, h, kh, d, dv, scale, causal, vec ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

// Launch the blocks of one call on `stream` (Dv chunks of 64 output features
// a block for Dv <= 64, else of 128); `vec`: every K and V row is aligned
// for whole chunks (16-byte cp.async of f32 / bf16 rows; 32-bit loads of
// one group's codes).  Returns cudaGetLastError() after the launch (0 = ok).
template <typename Q, typename Rows>
int launch(const void* q, Rows krows, Rows vrows, const void* q_start, void* out, int b, int sq,
           int skv, int h, int kh, int d, int dv, float scale, int causal, bool vec,
           void* stream) {
  if (d < 1 || dv < 1 || d > MAX_D || dv > MAX_D || kh == 0 || h % kh)
    return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0 || sq == 0 || h == 0) return 0;
  if (dv <= 64)
    return launch_kernel<Q, Rows, 64>(q, krows, vrows, q_start, out, b, sq, skv, h, kh, d, dv,
                                      scale, causal, vec, stream);
  return launch_kernel<Q, Rows, 128>(q, krows, vrows, q_start, out, b, sq, skv, h, kh, d, dv,
                                     scale, causal, vec, stream);
}

}  // namespace flash
