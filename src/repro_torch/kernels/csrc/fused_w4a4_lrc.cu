// Fused W4A4+LRC forward for Hopper (sm_90a): one launch computes
//
//     out = (Q_a(x) · unpack(W)) · sx · sw  +  (x · V) · Uᵀ        (M, N) f32
//
// Replaces the TPU kernel repro/kernels/fused_gemm.py::fused_w4a4_lrc_kernel
// with per-token activation scales and with its `act_group` branch, with and
// without the online rotation.  As there, the int8 codes of x (xq) never
// reach device memory: each block
// quantizes its rows into shared memory and runs the int4 GEMM straight from
// there.  With `rotate`, Q_a and x·V take x·H_K (K a power of two): the
// block rotates its staged f32 rows in place with fwht_rows.cuh (the body of
// fwht.cu and of the prologue's rotation, bitwise rowops.fwht_rows) before
// the amax, so the shared-memory footprint does not change.
//
// Layouts (the JAX package's): x (M, K) f32 or bf16, row-major; V (K, R) and
// U (N, R) in the LR storage dtype (bf16 or f32); W (K/2, N) uint8 holding two
// int4 codes per byte along K, the low nibble on the even K row, sign restored
// as (u ^ 8) - 8; sw (N,) f32.
//
// Numerics follow repro/kernels/rowops.py exactly: the per-row amax is
// guarded (amax <= 0 -> 1), s = (clip * amax) / qmax, q = clamp(rint(x / s),
// -qmax-1, qmax) with a true IEEE division and round-half-to-even.  The int32
// accumulation is exact in any order; the epilogue is ((float)acc * sx) * sw
// without FMA contraction, plus the f32 LR term from the bf16-stored factors.
// Only the LR sums (x·V and xv·Uᵀ) are ordered differently from the plain
// version, so the output agrees with it to f32 rounding of those sums.
//
// Group-wise (`group` g > 0, g divides K): the block quantizes each staged
// (rotated) row in groups of g with quant_rows.cuh's group body, one warp
// per group, into a [ROWS][K/g] scale plane in shared memory, and the GEMM
// sums fl(p_g · s_g) in f32 in ascending g from 0.f (rowops.gemm_grouped's
// canonical order, p_g the exact int32 partial of group g), then
// multiplies by sw: thread (r, n) owns whole outputs, column n of rows r and
// r + 8, over all of K, so each p_g is exact in one register.  The
// grouped GEMM output (before the LR term) is bitwise the plain version's.
//
// Bound on an H100 SXM: at decode (M = a few rows) the work is memory-bound.
// The bytes are K·N/2 (packed W) + 4N (sw) + 2·R·(K+N) (bf16 V and U) + the
// activations (M·K in, 4·M·N out), at 3.35 TB/s: about 0.2 us for the widest
// SmolLM-135M site.  The int8 and f32 operations are far below the peak rates.
//
// The design is the simple correct one the first slice asks for.  Grid is
// (N-tile, M-tile) with ROWS = 4 or 16 rows (a template parameter, so the
// per-row loops are straight-line code) and BN = 32 columns per block, 256
// threads.  Every block reads its rows once into shared memory and does the
// whole prologue for them (amax, quantize, x·V): with several N-tiles this is
// recomputed per tile, and V is read from L2 once per tile.  The block's W
// tile is staged in shared memory together with x and U, its nibbles
// unpacked there into the signed bytes __dp4a takes; every staging loop
// issues all its loads before its first store, so the loads are in flight
// together.  V streams through a 32 KB shared buffer in 16-byte pieces, the
// next chunk in registers while the current one is used.  The GEMM runs on
// CUDA cores, one column per thread, K split eight ways.  There are no
// tensor cores, TMA or cp.async yet, and the shared-memory footprint (about
// 112·K bytes, plus 64·K/g for the scale plane) limits K to about 1600.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stddef.h>
#include <stdint.h>

#include "fwht_rows.cuh"
#include "quant_rows.cuh"

namespace {

constexpr int MAX_ROWS = 16;        // rows per block (M-tile) at most
constexpr int BN = 32;              // output columns per block (one N-tile)
constexpr int KG = 8;               // K-splits of the GEMM within a block
constexpr int THREADS = BN * KG;    // 256
constexpr int NWARPS = THREADS / 32;
constexpr int VPIECES = 8;          // 16-byte pieces of V per thread per chunk
constexpr int VBYTES = VPIECES * 16 * THREADS;  // V chunk buffer (32 KB)
// the V chunks, then the x·V partials [NWARPS][ROWS][64], then the GEMM
// partials [KG][ROWS][BN] share one buffer of VBYTES
static_assert(NWARPS * MAX_ROWS * 64 * 4 <= VBYTES, "partial buffer too small");
static_assert(KG * MAX_ROWS * BN * 4 <= VBYTES, "reduction buffer too small");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// signed int4 code of nibble u (0..15), as a byte
__device__ __forceinline__ unsigned nibble_byte(unsigned u) {
  return (unsigned)((int)((u ^ 8u) & 0xFu) - 8) & 0xFFu;
}

// the four codes of one K quad of one column, from its two packed bytes
__device__ __forceinline__ int quad_codes(unsigned b0, unsigned b1) {
  return (int)(nibble_byte(b0 & 0xFu) | (nibble_byte(b0 >> 4) << 8)
               | (nibble_byte(b1 & 0xFu) << 16) | (nibble_byte(b1 >> 4) << 24));
}

// S scales per row: 1 per-token, K/g group-wise
__host__ __device__ inline size_t smem_bytes(int rows, int K, int R, int S) {
  const size_t k16 = (size_t)((K + 15) & ~15);
  return sizeof(float) * ((size_t)rows * K + (size_t)rows * R + (size_t)BN * R
                          + (size_t)rows * S)
       + (size_t)VBYTES + (size_t)rows * k16 + k16 * BN;
}

// Loads this thread's VPIECES 16-byte pieces of a `bytes`-long contiguous
// chunk at g into registers.  All loads are issued before any is used (a
// store right after each load would wait for it).  A piece that runs past
// the chunk's end is left zero here and copied by store_chunk.
__device__ __forceinline__ void fetch_chunk(uint4 (&pre)[VPIECES],
                                            const unsigned char* g, int bytes,
                                            int tid) {
#pragma unroll
  for (int i = 0; i < VPIECES; ++i) {
    const int off = (tid + i * THREADS) * 16;
    pre[i] = (off + 16 <= bytes) ? __ldg(reinterpret_cast<const uint4*>(g + off))
                                 : make_uint4(0u, 0u, 0u, 0u);
  }
}

__device__ __forceinline__ void store_chunk(uint4* dst, const uint4 (&pre)[VPIECES],
                                            const unsigned char* g, int bytes,
                                            int tid) {
#pragma unroll
  for (int i = 0; i < VPIECES; ++i) {
    const int off = (tid + i * THREADS) * 16;
    dst[tid + i * THREADS] = pre[i];
    if (off < bytes && off + 16 > bytes) {  // the chunk's ragged last piece
      unsigned char* d = reinterpret_cast<unsigned char*>(dst) + off;
      for (int b = 0; b < bytes - off; b += 2)
        *reinterpret_cast<unsigned short*>(d + b) =
            *reinterpret_cast<const unsigned short*>(g + off + b);
    }
  }
}

template <int ROWS, bool GROUPED, typename TX, typename TF>
__global__ void __launch_bounds__(THREADS)
fused_w4a4_lrc_kernel(const TX* __restrict__ x, const TF* __restrict__ v,
                      const uint8_t* __restrict__ w, const float* __restrict__ sw,
                      const TF* __restrict__ u, float* __restrict__ out,
                      int M, int K, int N, int R, int group, int qmax,
                      float clip_ratio, int rotate, float nrm) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int K16 = (K + 15) & ~15;  // xq row stride; K padded with zero codes
  const int S = GROUPED ? K / group : 1;               // scales per row
  float* xs = reinterpret_cast<float*>(smem);         // [ROWS][K]  rows in f32
  float* xvs = xs + (size_t)ROWS * K;                  // [ROWS][R]  x·V
  float* us = xvs + (size_t)ROWS * R;                  // [BN][R]    U tile in f32
  float* sxs = us + (size_t)BN * R;                    // [ROWS][S]  row or group scales
  int* red = reinterpret_cast<int*>(sxs + (size_t)ROWS * S);  // VBYTES, see VPIECES
  int8_t* xq = reinterpret_cast<int8_t*>(red) + VBYTES;      // [ROWS][K16] codes
  int* ws = reinterpret_cast<int*>(xq + (size_t)ROWS * K16);  // [K16/4][BN] W codes

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.y * ROWS, n0 = blockIdx.x * BN;
  const int mv = min(ROWS, M - m0);  // valid rows of this tile (rest are zero)
  const int nv = min(BN, N - n0);    // valid columns of this tile
  const int kh = K >> 1;             // packed rows of W
  const int nq = K16 >> 2;           // K quads, padding included

  // 1. stage the rows in f32 (zero past M), the U tile (zero past N) and the
  //    W tile, each W quad unpacked to the int of four codes __dp4a takes
  for (int i0 = 0; i0 < ROWS * K; i0 += 16 * THREADS) {
    TX t[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int i = min(i0 + j * THREADS + tid, mv * K - 1);  // rows past M: any
      t[j] = x[(size_t)m0 * K + i];                          // valid element
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int i = i0 + j * THREADS + tid;
      if (i < ROWS * K) xs[i] = (i < mv * K) ? to_f32(t[j]) : 0.f;
    }
  }
  for (int i0 = 0; i0 < BN * R; i0 += 8 * THREADS) {
    float t[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int i = i0 + j * THREADS + tid;
      t[j] = (i < nv * R) ? to_f32(u[(size_t)n0 * R + i]) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int i = i0 + j * THREADS + tid;
      if (i < BN * R) us[i] = t[j];
    }
  }
  if ((N & 3) == 0) {  // 4 columns at a time with word loads
    for (int i0 = 0; i0 < nq * (BN / 4); i0 += 4 * THREADS) {
      uint32_t lo[4], hi[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = i0 + j * THREADS + tid;
        const int q = i / (BN / 4), c4 = (i % (BN / 4)) * 4;
        const bool in = i < nq * (BN / 4) && n0 + c4 < N;
        const uint32_t* src =
            reinterpret_cast<const uint32_t*>(w + (size_t)(2 * q) * N + n0 + c4);
        lo[j] = (in && 2 * q < kh) ? __ldg(src) : 0u;
        hi[j] = (in && 2 * q + 1 < kh) ? __ldg(src + N / 4) : 0u;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = i0 + j * THREADS + tid;
        if (i >= nq * (BN / 4)) continue;
        const int q = i / (BN / 4), c4 = (i % (BN / 4)) * 4;
#pragma unroll
        for (int b = 0; b < 4; ++b)
          ws[q * BN + c4 + b] = quad_codes((lo[j] >> (8 * b)) & 0xFFu,
                                           (hi[j] >> (8 * b)) & 0xFFu);
      }
    }
  } else {
    for (int i = tid; i < nq * BN; i += THREADS) {
      const int q = i / BN, c = i % BN;
      const unsigned b0 = (c < nv && 2 * q < kh) ? w[(size_t)(2 * q) * N + n0 + c] : 0u;
      const unsigned b1 = (c < nv && 2 * q + 1 < kh) ? w[(size_t)(2 * q + 1) * N + n0 + c] : 0u;
      ws[i] = quad_codes(b0, b1);
    }
  }
  __syncthreads();

  // 1b. the online rotation of the staged rows, in place (rows past M stay 0)
  if (rotate) fwht_rows::rotate<THREADS>(xs, ROWS * K, K, nrm);

  const float qlo = (float)(-qmax - 1), qhi = (float)qmax;
  if constexpr (GROUPED) {
    // 2-3 group-wise: one warp per (row, group) quantizes into shared int8
    // and the scale plane; K is padded to a multiple of 16 with zero codes
    for (int i = warp; i < ROWS * S; i += NWARPS) {
      const int m = i / S, grp = i % S;
      quant_rows::quantize_group(xs + (size_t)m * K + (size_t)grp * group, group,
                                 xq + (size_t)m * K16 + (size_t)grp * group,
                                 sxs + i, qmax, clip_ratio);
    }
    for (int i = tid; i < ROWS * (K16 - K); i += THREADS)
      xq[(i / (K16 - K)) * K16 + K + i % (K16 - K)] = 0;
  } else {
  // 2. per-row amax -> scale, one warp per row (a zero row gets scale
  //    clip/qmax and zero codes)
  for (int m = warp; m < ROWS; m += NWARPS) {
    float a = 0.f;
    for (int k = lane; k < K; k += 32) a = fmaxf(a, fabsf(xs[m * K + k]));
    for (int off = 16; off > 0; off >>= 1)
      a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, off));
    if (lane == 0) {
      if (a <= 0.f) a = 1.f;
      sxs[m] = __fdiv_rn(__fmul_rn(clip_ratio, a), (float)qmax);
    }
  }
  __syncthreads();

  // 3. quantize into shared int8; K is padded to a multiple of 16 with zeros
  for (int m = 0; m < ROWS; ++m) {
    const float s = sxs[m];
#pragma unroll 4
    for (int k = tid; k < K16; k += THREADS) {
      int q = 0;
      if (k < K) q = (int)fminf(fmaxf(rintf(__fdiv_rn(xs[m * K + k], s)), qlo), qhi);
      xq[m * K16 + k] = (int8_t)q;
    }
  }
  }  // per-token

  // 4. xv = x·V in f32.  V streams through shared memory in chunks of vc
  //    rows, copied as flat 16-byte pieces (the chunk is contiguous in V),
  //    the next chunk's pieces held in registers while the current one is
  //    multiplied.  Each warp takes vc/NWARPS rows of a chunk and 64 columns
  //    of V (two per lane) for every row; the warps' sums are added in warp
  //    order at the end (deterministic).
  if (R > 0) {
    uint4* vraw = reinterpret_cast<uint4*>(red);
    float* part = reinterpret_cast<float*>(red);
    const TF* vsm = reinterpret_cast<const TF*>(red);
    const unsigned char* vbytes = reinterpret_cast<const unsigned char*>(v);
    const int row_bytes = R * (int)sizeof(TF);
    const int vc = max(NWARPS, (VBYTES / row_bytes) & ~(NWARPS - 1));
    const int rows_w = vc / NWARPS;
    const int nchunk = (K + vc - 1) / vc;
    for (int r0 = 0; r0 < R; r0 += 64) {
      const int ra = min(r0 + lane, R - 1), rb = min(r0 + 32 + lane, R - 1);
      const float ma = (r0 + lane < R) ? 1.f : 0.f;
      const float mb = (r0 + 32 + lane < R) ? 1.f : 0.f;
      float acc_a[ROWS], acc_b[ROWS];
#pragma unroll
      for (int m = 0; m < ROWS; ++m) acc_a[m] = acc_b[m] = 0.f;
      uint4 pre[VPIECES];
      fetch_chunk(pre, vbytes, min(vc, K) * row_bytes, tid);
      for (int c = 0; c < nchunk; ++c) {
        const unsigned char* g = vbytes + (size_t)c * vc * row_bytes;
        const int k0 = c * vc, rows = min(vc, K - k0);
        __syncthreads();  // everyone is done with the previous chunk
        store_chunk(vraw, pre, g, rows * row_bytes, tid);
        __syncthreads();
        if (c + 1 < nchunk)  // in flight during the products
          fetch_chunk(pre, g + (size_t)vc * row_bytes,
                      min(vc, K - k0 - vc) * row_bytes, tid);
        const int jb = warp * rows_w, je = min(rows, jb + rows_w);
#pragma unroll 4
        for (int j = jb; j < je; ++j) {
          const float va = ma * to_f32(vsm[j * R + ra]);
          const float vb = mb * to_f32(vsm[j * R + rb]);
#pragma unroll
          for (int m = 0; m < ROWS; ++m) {
            const float xk = xs[m * K + k0 + j];
            acc_a[m] = fmaf(xk, va, acc_a[m]);
            acc_b[m] = fmaf(xk, vb, acc_b[m]);
          }
        }
      }
      __syncthreads();  // the chunk buffer becomes the partial-sum buffer
#pragma unroll
      for (int m = 0; m < ROWS; ++m) {
        part[(warp * ROWS + m) * 64 + lane] = acc_a[m];
        part[(warp * ROWS + m) * 64 + 32 + lane] = acc_b[m];
      }
      __syncthreads();
      for (int i = tid; i < ROWS * 64; i += THREADS) {
        const int m = i >> 6, l = i & 63;
        if (r0 + l < R) {
          float s = 0.f;
          for (int w2 = 0; w2 < NWARPS; ++w2) s += part[(w2 * ROWS + m) * 64 + l];
          xvs[m * R + r0 + l] = s;
        }
      }
    }
  }
  __syncthreads();

  // 5. int4 GEMM from shared memory: thread (kg, nl) owns column n0+nl
  //    over an eighth of K and accumulates every row with __dp4a, 16 K
  //    values of a row per 16-byte load of its codes.  Group-wise, thread
  //    (mr, nl) owns rows mr + KG·j of column n0+nl over all of K and sums
  //    each group's exact partial times its scale in ascending g; the f32
  //    sums go to `red` as [ROWS][BN]
  if constexpr (GROUPED) {
    constexpr int RPT = (ROWS + KG - 1) / KG;
    const int nl = tid % BN, mr = tid / BN;
    int gacc[RPT], gcur = 0, gend = group;
    float gsum[RPT];
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      gacc[j] = 0;
      gsum[j] = 0.f;
    }
    auto flush = [&]() {
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        const int m = mr + KG * j;
        if (m < ROWS)
          gsum[j] = __fadd_rn(gsum[j], __fmul_rn((float)gacc[j], sxs[m * S + gcur]));
        gacc[j] = 0;
      }
      ++gcur;
      gend += group;
    };
    if (mr < ROWS) {
      for (int q = 0; q < nq; q += 4) {
        const int kq = 4 * q;
        if (kq >= K) break;
        if (kq + 16 <= gend) {  // four whole quads of the current group
          const int w0 = ws[q * BN + nl], w1 = ws[(q + 1) * BN + nl];
          const int w2 = ws[(q + 2) * BN + nl], w3 = ws[(q + 3) * BN + nl];
#pragma unroll
          for (int j = 0; j < RPT; ++j) {
            const int4 a = *reinterpret_cast<const int4*>(xq + (mr + KG * j) * K16 + kq);
            gacc[j] = __dp4a(a.x, w0, gacc[j]);
            gacc[j] = __dp4a(a.y, w1, gacc[j]);
            gacc[j] = __dp4a(a.z, w2, gacc[j]);
            gacc[j] = __dp4a(a.w, w3, gacc[j]);
          }
          if (kq + 16 == gend) flush();
          continue;
        }
        for (int qq = q; qq < q + 4; ++qq) {  // a group ends inside
          const int k4 = 4 * qq;
          if (k4 >= K) break;
          const int wq = ws[qq * BN + nl];
          for (int b = 0; b < 4 && k4 + b < K;) {
            const int e = min(4, gend - k4);  // bytes [b, e) are in group gcur
            const unsigned hi = e >= 4 ? 0xFFFFFFFFu : (1u << (8 * e)) - 1u;
            const int mask = (int)(hi & ~((1u << (8 * b)) - 1u));
#pragma unroll
            for (int j = 0; j < RPT; ++j)
              gacc[j] = __dp4a(
                  *reinterpret_cast<const int*>(xq + (mr + KG * j) * K16 + k4) & mask,
                  wq, gacc[j]);
            if (k4 + e == gend) flush();
            b = e;
          }
        }
      }
    }
    float* gout = reinterpret_cast<float*>(red);
#pragma unroll
    for (int j = 0; j < RPT; ++j)
      if (mr + KG * j < ROWS) gout[(mr + KG * j) * BN + nl] = gsum[j];
  } else {
    const int nl = tid % BN, kg = tid / BN;
    const int qper = ((nq + KG - 1) / KG + 3) & ~3;
    const int qb = kg * qper, qe = min(nq, qb + qper);
    int acc[ROWS];
#pragma unroll
    for (int m = 0; m < ROWS; ++m) acc[m] = 0;
#pragma unroll 2
    for (int q = qb; q < qe; q += 4) {
      const int w0 = ws[q * BN + nl], w1 = ws[(q + 1) * BN + nl];
      const int w2 = ws[(q + 2) * BN + nl], w3 = ws[(q + 3) * BN + nl];
#pragma unroll
      for (int m = 0; m < ROWS; ++m) {
        const int4 a = *reinterpret_cast<const int4*>(xq + m * K16 + 4 * q);
        acc[m] = __dp4a(a.x, w0, acc[m]);
        acc[m] = __dp4a(a.y, w1, acc[m]);
        acc[m] = __dp4a(a.z, w2, acc[m]);
        acc[m] = __dp4a(a.w, w3, acc[m]);
      }
    }
#pragma unroll
    for (int m = 0; m < ROWS; ++m) red[(kg * ROWS + m) * BN + nl] = acc[m];
  }
  __syncthreads();

  // 6. epilogue: ((float)acc * sx) * sw + xv·Uᵀ (group-wise: the f32 sum
  //    times sw, + xv·Uᵀ), one f32 write per output
  for (int i = tid; i < ROWS * BN; i += THREADS) {
    const int m = i / BN, nl = i % BN;
    if (m >= mv || nl >= nv) continue;
    float o;
    if constexpr (GROUPED) {
      o = __fmul_rn(reinterpret_cast<const float*>(red)[m * BN + nl], sw[n0 + nl]);
    } else {
      int a = 0;
#pragma unroll
      for (int g = 0; g < KG; ++g) a += red[(g * ROWS + m) * BN + nl];
      o = __fmul_rn(__fmul_rn((float)a, sxs[m]), sw[n0 + nl]);
    }
    if (R > 0) {
      float lr = 0.f;
      for (int r = 0; r < R; ++r) lr = fmaf(xvs[m * R + r], us[nl * R + r], lr);
      o = __fadd_rn(o, lr);
    }
    out[(size_t)(m0 + m) * N + n0 + nl] = o;
  }
}

template <int ROWS, bool GROUPED, typename TX, typename TF>
int launch(const void* x, const void* v, const void* w, const void* sw,
           const void* u, void* out, int M, int K, int N, int R, int group,
           int qmax, float clip_ratio, int rotate, cudaStream_t stream) {
  auto kern = fused_w4a4_lrc_kernel<ROWS, GROUPED, TX, TF>;
  const size_t smem = smem_bytes(ROWS, K, R, group > 0 ? K / group : 1);
  static size_t configured = 48 * 1024;  // per instantiation
  if (smem > configured) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    configured = smem;
  }
  dim3 grid((N + BN - 1) / BN, (M + ROWS - 1) / ROWS);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const TX*>(x), static_cast<const TF*>(v),
      static_cast<const uint8_t*>(w), static_cast<const float*>(sw),
      static_cast<const TF*>(u), static_cast<float*>(out),
      M, K, N, R, group, qmax, clip_ratio, rotate, fwht_rows::norm(K));
  return (int)cudaGetLastError();
}

template <typename TX, typename TF>
int launch_rows(const void* x, const void* v, const void* w, const void* sw,
                const void* u, void* out, int M, int K, int N, int R, int group,
                int qmax, float clip_ratio, int rotate, cudaStream_t stream) {
  // decode batches of up to 4 rows take the 4-row tile, larger M the 16-row
  // one; the group branch is its own instantiation, so the per-token code is
  // compiled as if it were not there
  auto fn = M <= 4 ? (group > 0 ? launch<4, true, TX, TF> : launch<4, false, TX, TF>)
                   : (group > 0 ? launch<MAX_ROWS, true, TX, TF>
                                : launch<MAX_ROWS, false, TX, TF>);
  return fn(x, v, w, sw, u, out, M, K, N, R, group, qmax, clip_ratio, rotate, stream);
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs at (K, R, group), with the larger
// tile (group 0: per-token scales).
size_t fused_w4a4_lrc_smem_bytes(int K, int R, int group) {
  return smem_bytes(MAX_ROWS, K, R, group > 0 ? K / group : 1);
}

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok).
// x_bf16 / f_bf16 select bf16 (1) or f32 (0) for x and for the U/V factors;
// group 0 quantizes per token, group g > 0 (dividing K) per group of g;
// rotate (1) applies the online rotation, K a power of two (the wrapper
// checks).
int fused_w4a4_lrc(const void* x, int x_bf16, const void* v, const void* w,
                   const void* sw, const void* u, int f_bf16, void* out,
                   int M, int K, int N, int R, int group, int qmax,
                   float clip_ratio, int rotate, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rotate && (K & (K - 1))) return (int)cudaErrorInvalidValue;
  if (group < 0 || (group > 0 && K % group)) return (int)cudaErrorInvalidValue;
  if (x_bf16 && f_bf16)
    return launch_rows<__nv_bfloat16, __nv_bfloat16>(x, v, w, sw, u, out, M, K, N, R, group, qmax, clip_ratio, rotate, s);
  if (x_bf16)
    return launch_rows<__nv_bfloat16, float>(x, v, w, sw, u, out, M, K, N, R, group, qmax, clip_ratio, rotate, s);
  if (f_bf16)
    return launch_rows<float, __nv_bfloat16>(x, v, w, sw, u, out, M, K, N, R, group, qmax, clip_ratio, rotate, s);
  return launch_rows<float, float>(x, v, w, sw, u, out, M, K, N, R, group, qmax, clip_ratio, rotate, s);
}

}  // extern "C"
