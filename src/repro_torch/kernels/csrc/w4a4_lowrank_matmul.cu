// W4A4 GEMM with the low-rank epilogue for Hopper (sm_90a):
//
//     out = (xq · unpack(W)) · sx · sw  +  xv · Uᵀ                 (M, N) f32
//
// from precomputed xq (M, K) int8, sx (M, 1) f32, W (K/2, N) uint8, sw (N,)
// f32, xv (M, R) f32 and U (N, R) bf16 or f32 (R may be 0).  With `group`
// g > 0 (g divides K), sx is the (M, K/g) scale plane of group-wise
// activation scales, and the GEMM dequantizes in the K loop:
//
//     out = (Σ_g fl(p_g · sx[:, g])) · sw  +  xv · Uᵀ
//
// p_g the exact int32 partial over group g.  Replaces the TPU kernel
// repro/kernels/w4a4.py::w4a4_lowrank_matmul_kernel, per-token and with its
// `group` branch: the GEMM of the chained (after fused_prologue.cu) and
// unfused (after act_quant.cu) paths.
//
// Numerics are those of fused_w4a4_lrc.cu: the int32 accumulation is exact
// in any order; the epilogue is ((float)acc * sx) * sw without FMA
// contraction, plus the LR term as one f32 FMA chain over R in ascending
// order.  Only that LR sum is ordered differently from the plain version.
// Group-wise, the f32 sum over groups is the canonical order of
// rowops.gemm_grouped: ascending g from 0.f, __fmul_rn then __fadd_rn, so
// the result is bitwise the plain version's whatever the grid, the K-split,
// the row tile or M (with g = K, bitwise the per-token result).
//
// Bound on an H100 SXM: at decode, memory.  The bytes are K·N/2 (packed W)
// + 4N (sw) + R·N·2 (bf16 U) + the activations (M·K + 4M + 4·M·R in, 4·M·N
// out), at 3.35 TB/s: 12.6 MB and 3.8 us for Phi-3-mini's K=8192, N=3072
// site.  The int8 and f32 operations are far below the peak rates.
//
// Design: the shared-memory footprint does not depend on K (or R), so any
// K works.  Grid (N-tile, M-tile, K-split), BN = 32 columns and ROWS = 4 or
// 16 rows (a template parameter: the per-row loops are straight-line code)
// per block, 256 threads.  K streams through shared memory in chunks of
// KC = 512 values: the W chunk's nibbles unpacked into the four-code words
// __dp4a takes, and the rows' codes as words.  The next chunk's loads are
// issued into registers before the current chunk is multiplied.  Thread
// (kg, n) owns column n over an eighth of each chunk; the eight int32 sums
// are added at the end.  At decode the (N, M) tiles alone are too few to
// keep enough loads in flight, so K is split across blocks (whole chunks,
// about two waves of blocks over the SMs); each split writes its int32
// partials to scratch and the tile's last block to finish (an atomic
// ticket) adds them and runs the epilogue.  Integer sums are exact in any
// order, so neither the split nor the finishing order changes a bit of the
// result.  The LR epilogue streams U and xv through shared memory in chunks
// of 128 ranks.  No tensor cores, TMA or cp.async yet.
//
// The group branch (a template parameter) stages the same chunks, but
// thread (r, n) owns whole outputs, column n of rows r and r + 8, over every
// quad of the chunk, so each group's int32 partial is exact in one register
// and no in-block reduction is needed.  Unsplit, the thread adds
// fl(p_g · s_g) to its f32 sum as each group ends; split, each block adds its
// groups' int32 partials into a zeroed (tile, group, row, column) plane with
// integer atomics (a group may straddle two splits), and the tile's last
// block runs the f32 sum over the plane in ascending g.  The plane is
// M·N·(K/g)·4 bytes, at the few-tile decode shapes only (3.1 MB at
// Phi-3-mini's wd, M 4, g 128).  A quad that a group boundary cuts (g not a
// multiple of 4) is split with byte masks.  At decode a 4-row tile leaves
// half the threads without a row in the products.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int BN = 32;              // output columns per block
constexpr int KG = 8;               // K-splits of a chunk within a block
constexpr int THREADS = BN * KG;    // 256
constexpr int KC = 512;             // K values per chunk
constexpr int QC = KC / 4;          // K quads per chunk
constexpr int QPER = QC / KG;       // quads per thread per chunk (16)
constexpr int RC = 128;             // ranks per LR chunk
constexpr int MAX_ROWS = 16;
constexpr int WITEMS = QC * (BN / 4) / THREADS;  // word-path W loads per thread (4)

// signed int4 code of nibble u (0..15), as a byte
__device__ __forceinline__ unsigned nibble_byte(unsigned u) {
  return (unsigned)((int)((u ^ 8u) & 0xFu) - 8) & 0xFFu;
}

// the four codes of one K quad of one column, from its two packed bytes
__device__ __forceinline__ int quad_codes(unsigned b0, unsigned b1) {
  return (int)(nibble_byte(b0 & 0xFu) | (nibble_byte(b0 >> 4) << 8)
               | (nibble_byte(b1 & 0xFu) << 16) | (nibble_byte(b1 >> 4) << 24));
}

template <int ROWS>
struct Smem {
  static constexpr int GEMM = 4 * (QC * BN + ROWS * QC);     // ws + xs
  static constexpr int RED = 4 * KG * ROWS * BN;              // int32 partials
  static constexpr int LR = 4 * (BN * (RC + 1) + ROWS * RC);  // us + xvs
  static constexpr int BYTES = GEMM > LR ? (GEMM > RED ? GEMM : RED)
                                         : (LR > RED ? LR : RED);
};

// The W chunk's loads into registers (word path: N % 4 == 0, four columns a
// load, the even and the odd packed row of each quad).
__device__ __forceinline__ void fetch_w(uint32_t (&lo)[WITEMS], uint32_t (&hi)[WITEMS],
                                        const uint8_t* __restrict__ w, int q0,
                                        int nq, int kh, int N, int n0, int tid) {
#pragma unroll
  for (int j = 0; j < WITEMS; ++j) {
    const int i = j * THREADS + tid, ql = i / (BN / 4), c4 = (i % (BN / 4)) * 4;
    const int q = q0 + ql;
    const bool in = q < nq && n0 + c4 < N;
    const uint32_t* src =
        reinterpret_cast<const uint32_t*>(w + (size_t)(2 * q) * N + n0 + c4);
    lo[j] = (in && 2 * q < kh) ? __ldg(src) : 0u;
    hi[j] = (in && 2 * q + 1 < kh) ? __ldg(src + N / 4) : 0u;
  }
}

// rows' codes per chunk, 16 a load (K % 16 == 0): loads per thread
template <int ROWS>
struct XItems {
  static constexpr int N = (ROWS * KC / 16 + THREADS - 1) / THREADS;
};

// The rows' codes of chunk c into registers (zero past M and past K).
template <int ROWS>
__device__ __forceinline__ void fetch_x(uint4 (&pre)[XItems<ROWS>::N],
                                        const int8_t* __restrict__ xq, int c,
                                        int mv, int m0, int K, int tid) {
#pragma unroll
  for (int j = 0; j < XItems<ROWS>::N; ++j) {
    const int i = j * THREADS + tid, m = i / (KC / 16);
    const int k = c * KC + (i % (KC / 16)) * 16;
    pre[j] = (i < ROWS * KC / 16 && m < mv && k < K)
                 ? __ldg(reinterpret_cast<const uint4*>(xq + (size_t)(m0 + m) * K + k))
                 : make_uint4(0u, 0u, 0u, 0u);
  }
}

// bytes [b, e) of a word of four codes (0 <= b < e <= 4)
__device__ __forceinline__ int byte_mask(int b, int e) {
  const unsigned hi = e >= 4 ? 0xFFFFFFFFu : (1u << (8 * e)) - 1u;
  return (int)(hi & ~((1u << (8 * b)) - 1u));
}

template <int ROWS, bool GROUPED>
__global__ void __launch_bounds__(THREADS)
w4a4_lowrank_matmul_kernel(const int8_t* __restrict__ xq, const float* __restrict__ sx,
                           const uint8_t* __restrict__ w, const float* __restrict__ sw,
                           const float* __restrict__ xv, const void* __restrict__ u,
                           int u_bf16, float* __restrict__ out,
                           int* __restrict__ part, int* __restrict__ tickets,
                           int M, int K, int N, int R, int group, int cps,
                           int vec_w, int vec_x) {
  __shared__ __align__(16) unsigned char smem[Smem<ROWS>::BYTES];
  __shared__ int last;
  int* ws = reinterpret_cast<int*>(smem);  // [QC][BN] W codes, four per word
  int* xs = ws + QC * BN;                  // [ROWS][QC] row codes, four per word

  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * ROWS, n0 = blockIdx.x * BN;
  const int mv = min(ROWS, M - m0), nv = min(BN, N - n0);
  const int kh = K >> 1;              // packed rows of W
  const int nq = (K + 3) >> 2;        // K quads (the last may be half)
  const int nc = (K + KC - 1) / KC;   // chunks
  const int cb = blockIdx.z * cps, ce = min(nc, cb + cps);  // this block's chunks
  const int nl = tid % BN, kg = tid / BN;

  int acc[ROWS];
#pragma unroll
  for (int m = 0; m < ROWS; ++m) acc[m] = 0;

  // group branch: thread (mr, nl) owns rows mr + KG·j (j < RPT) of column nl
  constexpr int RPT = (ROWS + KG - 1) / KG;
  const int mr = tid / BN;
  const int G = GROUPED ? K / group : 1;
  const size_t tile = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
  int* plane = part + tile * G * ROWS * BN;  // split: [G][ROWS][BN] int32
  const int kend = min(K, ce * KC);          // this block's K range ends here
  int gcur = GROUPED ? (cb * KC) / group : 0, gend = (gcur + 1) * group;
  int gacc[RPT];
  float gsum[RPT];
#pragma unroll
  for (int j = 0; j < RPT; ++j) {
    gacc[j] = 0;
    gsum[j] = 0.f;
  }
  // the current group ends: its exact partial into the f32 sum (unsplit)
  // or into the plane (split)
  auto flush = [&]() {
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      const int m = mr + KG * j;
      if (m < mv) {
        if (gridDim.z > 1) {
          if (gacc[j]) atomicAdd(plane + ((size_t)gcur * ROWS + m) * BN + nl, gacc[j]);
        } else {
          gsum[j] = __fadd_rn(gsum[j], __fmul_rn((float)gacc[j],
                                                 __ldg(sx + (size_t)(m0 + m) * G + gcur)));
        }
      }
      gacc[j] = 0;
    }
    ++gcur;
    gend += group;
  };

  uint32_t lo[WITEMS], hi[WITEMS];
  uint4 xpre[XItems<ROWS>::N];
  if (vec_w) fetch_w(lo, hi, w, cb * QC, nq, kh, N, n0, tid);
  if (vec_x) fetch_x<ROWS>(xpre, xq, cb, mv, m0, K, tid);

  for (int c = cb; c < ce; ++c) {
    const int q0 = c * QC;
    __syncthreads();  // everyone is done with the previous chunk
    // stage the chunk: W codes and row codes (zero past K, N and M)
    if (vec_w) {
#pragma unroll
      for (int j = 0; j < WITEMS; ++j) {
        const int i = j * THREADS + tid, ql = i / (BN / 4), c4 = (i % (BN / 4)) * 4;
#pragma unroll
        for (int b = 0; b < 4; ++b)
          ws[ql * BN + c4 + b] = quad_codes((lo[j] >> (8 * b)) & 0xFFu,
                                            (hi[j] >> (8 * b)) & 0xFFu);
      }
    } else {
      for (int i = tid; i < QC * BN; i += THREADS) {
        const int ql = i / BN, cc = i % BN, q = q0 + ql;
        const bool in = cc < nv && q < nq;
        const unsigned b0 = (in && 2 * q < kh) ? w[(size_t)(2 * q) * N + n0 + cc] : 0u;
        const unsigned b1 = (in && 2 * q + 1 < kh) ? w[(size_t)(2 * q + 1) * N + n0 + cc] : 0u;
        ws[i] = quad_codes(b0, b1);
      }
    }
    if (vec_x) {
#pragma unroll
      for (int j = 0; j < XItems<ROWS>::N; ++j) {
        const int i = j * THREADS + tid;
        if (i < ROWS * KC / 16) reinterpret_cast<uint4*>(xs)[i] = xpre[j];
      }
    } else {
      for (int i = tid; i < ROWS * QC; i += THREADS) {
        const int m = i / QC, k = (q0 + i % QC) * 4;
        unsigned word = 0u;
        if (m < mv) {
          const int8_t* row = xq + (size_t)(m0 + m) * K;
#pragma unroll
          for (int b = 0; b < 4; ++b)
            if (k + b < K) word |= ((unsigned)(uint8_t)row[k + b]) << (8 * b);
        }
        xs[i] = (int)word;
      }
    }
    __syncthreads();
    if (c + 1 < ce) {  // in flight during the products
      if (vec_w) fetch_w(lo, hi, w, q0 + QC, nq, kh, N, n0, tid);
      if (vec_x) fetch_x<ROWS>(xpre, xq, c + 1, mv, m0, K, tid);
    }
    if constexpr (GROUPED) {
      // every quad of the chunk for this thread's rows, in ascending K; a
      // group's partial is flushed where the group ends
      if (mr < ROWS) {
        for (int q = 0; q < QC; q += 4) {
          const int kq = (q0 + q) * 4;
          if (kq >= kend) break;
          if (kq + 16 <= gend) {  // four whole quads of the current group
            const int w0 = ws[q * BN + nl], w1 = ws[(q + 1) * BN + nl];
            const int w2 = ws[(q + 2) * BN + nl], w3 = ws[(q + 3) * BN + nl];
#pragma unroll
            for (int j = 0; j < RPT; ++j) {
              const int4 a = *reinterpret_cast<const int4*>(xs + (mr + KG * j) * QC + q);
              gacc[j] = __dp4a(a.x, w0, gacc[j]);
              gacc[j] = __dp4a(a.y, w1, gacc[j]);
              gacc[j] = __dp4a(a.z, w2, gacc[j]);
              gacc[j] = __dp4a(a.w, w3, gacc[j]);
            }
            if (kq + 16 == gend) flush();
            continue;
          }
          for (int qq = q; qq < q + 4; ++qq) {  // a group ends inside
            const int k4 = (q0 + qq) * 4;
            if (k4 >= kend) break;
            const int wq = ws[qq * BN + nl];
            for (int b = 0; b < 4 && k4 + b < kend;) {
              const int e = min(4, gend - k4);  // bytes [b, e) are in group gcur
              const int mask = byte_mask(b, e);
#pragma unroll
              for (int j = 0; j < RPT; ++j)
                gacc[j] = __dp4a(xs[(mr + KG * j) * QC + qq] & mask, wq, gacc[j]);
              if (k4 + e == gend) flush();
              b = e;
            }
          }
        }
      }
    } else {
      // this thread's QPER quads of the chunk, every row
      const int qb = kg * QPER;
#pragma unroll
      for (int q = qb; q < qb + QPER; q += 4) {
        const int w0 = ws[q * BN + nl], w1 = ws[(q + 1) * BN + nl];
        const int w2 = ws[(q + 2) * BN + nl], w3 = ws[(q + 3) * BN + nl];
#pragma unroll
        for (int m = 0; m < ROWS; ++m) {
          const int4 a = *reinterpret_cast<const int4*>(xs + m * QC + q);
          acc[m] = __dp4a(a.x, w0, acc[m]);
          acc[m] = __dp4a(a.y, w1, acc[m]);
          acc[m] = __dp4a(a.z, w2, acc[m]);
          acc[m] = __dp4a(a.w, w3, acc[m]);
        }
      }
    }
  }

  constexpr int OUTS = (ROWS * BN + THREADS - 1) / THREADS;
  float o[OUTS];
  if constexpr (GROUPED) {
    // output j of this thread is (mr + KG·j, nl): the rows it summed
    static_assert(OUTS == RPT, "group outputs follow the epilogue's layout");
    if (gridDim.z > 1) {  // K is split: the tile's last block sums the plane
      if (mr < ROWS && gcur < G) flush();  // a group that runs on into the next split
      __threadfence();  // the partials are visible before the ticket is taken
      __syncthreads();
      if (tid == 0) last = (atomicAdd(&tickets[tile], 1) == (int)gridDim.z - 1);
      __syncthreads();
      if (!last) return;
      __threadfence();
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        const int m = mr + KG * j;
        gsum[j] = 0.f;
        if (m < mv) {
          const float* srow = sx + (size_t)(m0 + m) * G;
          for (int g = 0; g < G; ++g)
            gsum[j] = __fadd_rn(gsum[j], __fmul_rn(
                (float)__ldcg(plane + ((size_t)g * ROWS + m) * BN + nl), __ldg(srow + g)));
        }
      }
    }
#pragma unroll
    for (int j = 0; j < OUTS; ++j) {
      const int m = mr + KG * j;
      o[j] = (m < mv && nl < nv) ? __fmul_rn(gsum[j], sw[n0 + nl]) : 0.f;
    }
  } else {
    __syncthreads();  // the chunk buffers become the partial-sum buffer

    int* red = reinterpret_cast<int*>(smem);  // [KG][ROWS][BN]
#pragma unroll
    for (int m = 0; m < ROWS; ++m) red[(kg * ROWS + m) * BN + nl] = acc[m];
    __syncthreads();

    // this block's int32 sums, one per output it owns
    int a[OUTS];
#pragma unroll
    for (int j = 0; j < OUTS; ++j) {
      const int i = j * THREADS + tid, m = i / BN, cc = i % BN;
      a[j] = 0;
      if (i < ROWS * BN) {
#pragma unroll
        for (int g = 0; g < KG; ++g) a[j] += red[(g * ROWS + m) * BN + cc];
      }
    }

    if (gridDim.z > 1) {  // K is split: the tile's last block adds the partials
      int* mine = part + tile * gridDim.z * ROWS * BN;
#pragma unroll
      for (int j = 0; j < OUTS; ++j) {
        const int i = j * THREADS + tid;
        if (i < ROWS * BN) mine[(size_t)blockIdx.z * ROWS * BN + i] = a[j];
      }
      __threadfence();  // the partial is visible before the ticket is taken
      __syncthreads();
      if (tid == 0) last = (atomicAdd(&tickets[tile], 1) == (int)gridDim.z - 1);
      __syncthreads();
      if (!last) return;
      __threadfence();
#pragma unroll
      for (int j = 0; j < OUTS; ++j) {
        const int i = j * THREADS + tid;
        a[j] = 0;
        if (i < ROWS * BN) {
          for (int z = 0; z < (int)gridDim.z; ++z)  // integer sums: exact in any order
            a[j] += __ldcg(mine + (size_t)z * ROWS * BN + i);
        }
      }
    }

    // epilogue: ((float)acc * sx) * sw per output, kept in registers
#pragma unroll
    for (int j = 0; j < OUTS; ++j) {
      const int i = j * THREADS + tid, m = i / BN, cc = i % BN;
      o[j] = (i < ROWS * BN && m < mv && cc < nv)
                 ? __fmul_rn(__fmul_rn((float)a[j], sx[m0 + m]), sw[n0 + cc]) : 0.f;
    }
  }  // per-token

  if (R > 0) {  // + xv·Uᵀ, U and xv staged RC ranks at a time
    __syncthreads();  // done with the partials
    float* us = reinterpret_cast<float*>(smem);  // [BN][RC + 1] (padded: no bank conflicts)
    float* xvs = us + BN * (RC + 1);             // [ROWS][RC]
    constexpr int XV_ITEMS = (ROWS * RC + THREADS - 1) / THREADS;
    float lr[OUTS];
#pragma unroll
    for (int j = 0; j < OUTS; ++j) lr[j] = 0.f;
    for (int r0 = 0; r0 < R; r0 += RC) {
      const int rn = min(RC, R - r0);
      __syncthreads();  // done with the previous rank chunk
      // every load of the chunk is issued before the first store
      float ut[BN * RC / THREADS], xt[XV_ITEMS];
#pragma unroll
      for (int j = 0; j < BN * RC / THREADS; ++j) {
        const int i = j * THREADS + tid, cc = i / RC, rr = i % RC;
        const size_t g = (size_t)(n0 + cc) * R + r0 + rr;
        ut[j] = (cc < nv && rr < rn)
                    ? (u_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(u)[g])
                              : static_cast<const float*>(u)[g])
                    : 0.f;
      }
#pragma unroll
      for (int j = 0; j < XV_ITEMS; ++j) {
        const int i = j * THREADS + tid, m = i / RC, rr = i % RC;
        xt[j] = (i < ROWS * RC && m < mv && rr < rn)
                    ? xv[(size_t)(m0 + m) * R + r0 + rr] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < BN * RC / THREADS; ++j) {
        const int i = j * THREADS + tid;
        us[(i / RC) * (RC + 1) + i % RC] = ut[j];
      }
#pragma unroll
      for (int j = 0; j < XV_ITEMS; ++j) {
        const int i = j * THREADS + tid;
        if (i < ROWS * RC) xvs[i] = xt[j];
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < OUTS; ++j) {
        const int i = j * THREADS + tid, m = i / BN, cc = i % BN;
        if (i < ROWS * BN) {
          for (int rr = 0; rr < rn; ++rr)
            lr[j] = fmaf(xvs[m * RC + rr], us[cc * (RC + 1) + rr], lr[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < OUTS; ++j) o[j] = __fadd_rn(o[j], lr[j]);
  }

#pragma unroll
  for (int j = 0; j < OUTS; ++j) {
    const int i = j * THREADS + tid, m = i / BN, cc = i % BN;
    if (i < ROWS * BN && m < mv && cc < nv) out[(size_t)(m0 + m) * N + n0 + cc] = o[j];
  }
}

// How K is split across blocks: enough blocks for two waves of the SMs,
// each split a whole number of chunks.  Integer partial sums are exact, so
// the split never changes the result.
struct Split {
  int rows, tiles, cps, ks;
};

inline Split split_of(int M, int K, int N) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      sms = 132;
  }
  Split s;
  s.rows = M <= 4 ? 4 : MAX_ROWS;
  s.tiles = ((N + BN - 1) / BN) * ((M + s.rows - 1) / s.rows);
  const int nc = (K + KC - 1) / KC;
  const int want = (2 * sms + s.tiles - 1) / s.tiles;
  s.cps = (nc + want - 1) / want;
  if (s.cps < 1) s.cps = 1;
  s.ks = (nc + s.cps - 1) / s.cps;
  if (s.ks < 1) s.ks = 1;
  return s;
}

// int32 partials per tile: [ks][ROWS][BN] per-token, the [K/g][ROWS][BN]
// group plane group-wise
size_t partial_ints(const Split& s, int K, int group) {
  return (size_t)s.tiles * (group > 0 ? K / group : s.ks) * s.rows * BN;
}

size_t scratch_bytes(const Split& s, int K, int group) {
  if (s.ks <= 1) return 0;
  return sizeof(int) * (partial_ints(s, K, group) + s.tiles);
}

template <int ROWS>
int launch(const void* xq, const void* sx, const void* w, const void* sw,
           const void* xv, const void* u, int u_bf16, void* out, void* scratch,
           const Split& sp, int M, int K, int N, int R, int group,
           cudaStream_t stream) {
  // word loads of W need N % 4 == 0, vector loads of the codes K % 16 == 0
  const int vec_w = (N % 4 == 0) && (reinterpret_cast<uintptr_t>(w) % 4 == 0);
  const int vec_x = (K % 16 == 0) && (reinterpret_cast<uintptr_t>(xq) % 16 == 0);
  int* part = static_cast<int*>(scratch);
  int* tickets = sp.ks > 1 ? part + partial_ints(sp, K, group) : nullptr;
  if (sp.ks > 1) {  // group-wise the plane is summed into, so it is zeroed too
    cudaError_t e = group > 0
        ? cudaMemsetAsync(part, 0, scratch_bytes(sp, K, group), stream)
        : cudaMemsetAsync(tickets, 0, sizeof(int) * sp.tiles, stream);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((N + BN - 1) / BN, (M + ROWS - 1) / ROWS, sp.ks);
  auto kern = group > 0 ? w4a4_lowrank_matmul_kernel<ROWS, true>
                        : w4a4_lowrank_matmul_kernel<ROWS, false>;
  kern<<<grid, THREADS, 0, stream>>>(
      static_cast<const int8_t*>(xq), static_cast<const float*>(sx),
      static_cast<const uint8_t*>(w), static_cast<const float*>(sw),
      static_cast<const float*>(xv), u, u_bf16, static_cast<float*>(out),
      part, tickets, M, K, N, R, group, sp.cps, vec_w, vec_x);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of device scratch one launch at (M, K, N, group) needs (0 when K is
// not split).
size_t w4a4_lowrank_matmul_scratch_bytes(int M, int K, int N, int group) {
  return scratch_bytes(split_of(M, K, N), K, group);
}

// Launch on `stream`; returns the first CUDA error of the launch (0 = ok).
// With R = 0, xv and u may be null; u_bf16 selects bf16 (1) or f32 (0) U;
// group 0 takes per-token sx (M, 1), group g > 0 (dividing K) the (M, K/g)
// plane; scratch holds w4a4_lowrank_matmul_scratch_bytes(M, K, N, group)
// bytes.
int w4a4_lowrank_matmul(const void* xq, const void* sx, const void* w,
                        const void* sw, const void* xv, const void* u,
                        int u_bf16, void* out, void* scratch, int M, int K,
                        int N, int R, int group, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (group < 0 || (group > 0 && K % group)) return (int)cudaErrorInvalidValue;
  const Split sp = split_of(M, K, N);
  // decode batches of up to 4 rows take the 4-row tile, larger M the 16-row one
  if (M <= 4)
    return launch<4>(xq, sx, w, sw, xv, u, u_bf16, out, scratch, sp, M, K, N, R, group, s);
  return launch<MAX_ROWS>(xq, sx, w, sw, xv, u, u_bf16, out, scratch, sp, M, K, N, R,
                          group, s);
}

}  // extern "C"
