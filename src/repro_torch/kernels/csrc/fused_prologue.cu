// Fused activation prologue for Hopper (sm_90a): per call
//
//     xq (M, K) int8, sx (M, 1) f32  =  Q_a(x)        (per-token)
//     xv (M, R) f32                  =  x · V
//
// from x (M, K) f32 or bf16 and V (K, R) bf16 or f32, or with `rotate` the
// same of x·H_K (K a power of two; H_K the normalized Walsh-Hadamard
// matrix).  With `group` g > 0 (g divides K) sx is the (M, K/g) scale
// plane, one scale per g contiguous values of the (rotated) row.  Replaces
// the TPU kernel repro/kernels/prologue.py::fused_prologue_kernel, per-token
// and with its `act_group` branch, with and without the rotation and V; its
// output feeds w4a4_lowrank_matmul.cu (the chained path).
//
// Numerics.  The quantizer is quant_rows.cuh, shared with act_quant.cu: the
// codes and scales are bitwise those of rowops.scale_round_quantize.  x·V
// has ONE order, the same at every launch geometry, M and co-tenant rows:
// K is cut into chunks of bk = min(512, the largest power of two <=
// max(K, 8)) values (rowops.project_rows_tiled's default tile); each chunk
// into eight sub-chunks of bk/8 consecutive k, each one fmaf chain in
// ascending k from 0.f; the eight chains added in sub-chunk order
// (__fadd_rn), the chunk sums added in ascending K.  k past K adds nothing
// (fmaf(0, 0, acc) is acc), so a chain of a ragged last chunk may run over
// zero padding.  Only that order differs from the plain version's sums
// (bench.common.xv_tolerance covers it).
//
// Bound on an H100 SXM: at decode, memory: V (2·K·R bytes in bf16) dominates,
// 5 MB and 1.5 us at K 8192, R 307.  At large M, the f32 operations
// 2·M·K·R over 67 TFLOP/s (466 us at M 2048, K 8192, R 922).
//
// Design.  Two regimes, chosen from shapes alone (prologue.prologue_plan
// mirrors the plan, fused_prologue_plan exports it):
// * stream (M <= 16, K < 256, or fewer (128 x 64 tile, chunk) pairs than
//   SMs, the tiled regime's units of work): a block is one chunk of K by 32
//   columns of R by a tile of 4 rows (M <= 4; 16 columns, two rows a lane,
//   where 32-column blocks would be fewer than the SMs), 8 (M <= 16, so
//   that a 16-row chunk spreads over twice the SMs) or 16 (by 64 columns,
//   two a lane, so that each x load serves two chains); warp w runs
//   sub-chunk w, each lane a column (and the one 32 on) of its rows.  Each
//   warp copies its x rows and its V rows by 16-byte cp.async (the aligned words
//   that cover each row's segment: V rows are R values long and need no
//   alignment), V in four groups, and runs its chains as the groups land,
//   eight k a step: eight V values a column, then a row's eight x values
//   from one 16-byte broadcast load (x stays bf16 in shared memory and is
//   converted in registers: as f32 it took twice the broadcast loads, which
//   are what this loop waits on).  The warps' chains are added in warp order
//   into the chunk's partial; the last block of each (row tile, column
//   tile) to take its ticket adds the nk partials in ascending K, writes xv
//   and resets the ticket, so no memset precedes a launch.  The tiles'
//   quantizer blocks (one a row, reading it 16 bytes a load) run first in
//   the same grid: an unrotated call is one device operation.
// * tiled (the other shapes): a block owns a 128 x 64 output tile and a
//   range of whole chunks; x and V stages of 32 k stream through a ring of
//   three by cp.async and are converted to f32 compute layouts (x
//   transposed, V as it is); each thread keeps an 8 x 8 micro-tile (64
//   FMAs for four float4 loads a k) with its chains and chunk sums in
//   registers, folded at every sub-chunk end; at every chunk end the sums
//   go into xv (the running total) or,
//   where K is split over blocks (only where the output tiles are fewer
//   than the SMs: about WAVES blocks an SM), to scratch, and the tile's
//   last block adds them in ascending K, as in the stream regime.
// * rotate: the rotation mixes all of K, so a first launch rotates each row
//   once (fwht_rows.cuh, bitwise rowops.fwht_rows, a block a row), quantizes
//   it and writes the f32 rotated row to scratch; the projection launch
//   reads those rows.  Two device operations with V, one without.
// Scratch (the partials, the rotated rows) and the tickets live in buffers
// the wrapper caches; every launch leaves the tickets zero.
//
// Later work: a tensor-core x·V (an accuracy standard of its own); at
// decode, the ticket's and the finishing block's round trips to L2 (PERF.md
// gives the per-block timelines) and the quantizer blocks' second read of x.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stddef.h>
#include <stdint.h>

#include "fwht_rows.cuh"
#include "quant_rows.cuh"

namespace {

using quant_rows::to_f32;

constexpr int MAX_BK = 512;       // the reference's largest projection chunk
constexpr int SUBS = 8;           // sub-chunk chains a chunk
constexpr int STREAM_M = 16;      // M up to this takes the stream regime, and so does
constexpr int TILED_MIN_K = 256;  // every M below this K (sub-chunks under T_BK)
// stream regime: a block = a chunk x S_COLS columns (or half) x a row tile; warp w =
// sub-chunk w
constexpr int S_THREADS = 32 * SUBS;
constexpr int S_COLS = 32;
constexpr int S_PARTS = 4;        // cp.async groups of a warp's V rows
// tiled regime: T_BM x T_BN outputs, T_TM x T_TN a thread, stages of T_BK k
constexpr int T_BM = 128, T_BN = 64, T_BK = 32, T_STAGES = 3, T_TM = 8, T_TN = 8;
constexpr int T_THREADS = (T_BM / T_TM) * (T_BN / T_TN);
constexpr int WAVES = 2;          // tiled blocks an SM the K-split aims at
// rotation launch: a block a row
constexpr int Q_THREADS = 256;
constexpr int MAX_ROTATE_K = 32768;  // a whole f32 row in shared memory

__host__ __device__ inline int chunk_k(int K) {
  int p = 8;
  while (p * 2 <= K && p * 2 <= MAX_BK) p *= 2;
  return p;
}

__host__ __device__ inline int tiles(int a, int b) { return (a + b - 1) / b; }

// shared bytes of a row segment of n elements of es bytes, copied as the
// 16-byte words aligned in memory that it touches
__host__ __device__ constexpr int seg_words(int n, int es) { return (n * es + 15) / 16 + 1; }
__host__ __device__ constexpr int seg_bytes(int n, int es) { return 16 * seg_words(n, es); }

// the first n bytes (0..16) of the aligned 16-byte word at gmem into smem,
// the rest of the 16 zero
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int n) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s), "l"(gmem), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Word j of the copy of the segment of n elements of es bytes at device
// address s0 (n > 0) into shared memory at dst, the segment copied as the
// aligned 16-byte words it touches (seg_words(n, es) at most) by cp.async.
// Bytes past the segment are not read; its first word may begin up to 15
// bytes before it, inside the same aligned word of the allocation.  The
// segment's first element then sits (s0 & 15) bytes into dst.
__device__ __forceinline__ void copy_word(unsigned char* dst, uintptr_t s0, int n, int es,
                                          int j) {
  const uintptr_t s1 = s0 + (uintptr_t)n * es;
  const uintptr_t w = (s0 & ~(uintptr_t)15) + 16 * (uintptr_t)j;
  if (w < s1)
    cp_async16(dst + 16 * j, reinterpret_cast<const void*>(w), s1 - w < 16 ? (int)(s1 - w) : 16);
}

// an element of a copied segment, as f32
template <typename T>
__device__ __forceinline__ float load_elem(const unsigned char* p);

template <>
__device__ __forceinline__ float load_elem<float>(const unsigned char* p) {
  return *reinterpret_cast<const float*>(p);
}

template <>
__device__ __forceinline__ float load_elem<__nv_bfloat16>(const unsigned char* p) {
  return __uint_as_float((uint32_t)*reinterpret_cast<const unsigned short*>(p) << 16);
}

struct Args {
  const void* x;   // (M, K): the rows projected (with rotate the f32 rotated rows)
  const void* v;   // (K, R)
  int8_t* xq;
  float* sx;
  float* xv;
  int* tickets;    // zeroed scratch: a ticket per output tile where K is split
  float* part;     // scratch: [tiles][nk][rows][cols] chunk partials where K is split
  int M, K, R, group, qmax;
  float clip_ratio;
  int quant;       // quantizer blocks in this launch (unrotated calls)
  int bk, nk, sub, tiles_m, tiles_r, cps, splits;
};

// The quantizer's work for one row of x with the whole block.
template <int NT, typename TX>
__device__ __forceinline__ void quantize(const Args& a, const TX* x, int row, float* red) {
  const size_t r = (size_t)row;
  float* srow = a.sx + r * (a.group > 0 ? a.K / a.group : 1);
  if (a.group > 0)
    quant_rows::quantize_row_grouped<NT>(x + r * a.K, a.K, a.group, a.xq + r * a.K, srow,
                                         a.qmax, a.clip_ratio);
  else
    quant_rows::quantize_row<NT>(x + r * a.K, a.K, a.xq + r * a.K, srow, a.qmax,
                                 a.clip_ratio, red);
}

// Take the ticket of output tile `tile` once `total` blocks write into it:
// true for the last of them, which resets the ticket for the next launch.
// Called by every thread of the block.
// The block's partials, stored before the barrier, are released to the
// device by the ticket's acq_rel atomic, which also acquires the others'.
__device__ __forceinline__ bool take_ticket(int* tickets, int tile, int total, int* last) {
  __syncthreads();
  if (threadIdx.x == 0) {
    int old;
    asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;"
                 : "=r"(old) : "l"(tickets + tile) : "memory");
    const bool l = old == total - 1;
    if (l) tickets[tile] = 0;
    *last = l;
  }
  __syncthreads();
  return *last;
}

__device__ __forceinline__ float fadd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float4 fadd(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), __fadd_rn(a.z, b.z),
                     __fadd_rn(a.w, b.w));
}

// For each of Q outputs q (where on[q]), the sum of its n partials p[q][0],
// p[q][stride], ... added in ascending order from the first; the loads of
// every output go out B chunks at a time ahead of the adds.
template <int Q, int B = 8 / Q, typename T>
__device__ __forceinline__ void fold_chunks(const T* const (&p)[Q], const bool (&on)[Q], int n,
                                            size_t stride, T (&sum)[Q]) {
#pragma unroll
  for (int q = 0; q < Q; ++q)
    if (on[q]) sum[q] = __ldcg(p[q]);
  for (int c = 1; c < n; c += B) {
    T t[Q][B];
#pragma unroll
    for (int q = 0; q < Q; ++q)
#pragma unroll
      for (int e = 0; e < B; ++e)
        if (on[q] && c + e < n) t[q][e] = __ldcg(p[q] + (size_t)(c + e) * stride);
#pragma unroll
    for (int q = 0; q < Q; ++q)
#pragma unroll
      for (int e = 0; e < B; ++e)
        if (on[q] && c + e < n) sum[q] = fadd(sum[q], t[q][e]);
  }
}

// ---------------------------------------------------------------------------
// stream regime: grid (nk · tiles_r + quantizer blocks, tiles_m)
// ---------------------------------------------------------------------------

// columns of a lane: two at 16-row tiles, so that each x load serves two
// chains; one at decode, where more blocks matter more
__host__ __device__ constexpr int stream_cpl(int MR) { return MR == STREAM_M ? 2 : 1; }
// lanes a column set (LC): 32, or 16 at 4-row tiles whose 32-column
// blocks would be fewer than the SMs (a decode call at K 3072: twice the
// blocks, each lane two of the tile's rows)

// dynamic shared memory: [SUBS][sub] V row slots of a block's columns
// (reused for the warps' chains [SUBS][MR][cols]), then [SUBS][MR] x row
// slots of a sub-chunk
__host__ __device__ inline int stream_region(int MR, int cols, int bk, int ve) {
  const int vrows = bk * seg_bytes(cols, ve), chains = 4 * SUBS * MR * cols;
  return vrows > chains ? vrows : chains;
}
__host__ __device__ inline int stream_smem(int MR, int cols, int bk, int xe, int ve) {
  return stream_region(MR, cols, bk, ve) + SUBS * MR * seg_bytes(bk / SUBS, xe);
}

template <int MR, int LC, typename TX, typename TF>
__global__ void __launch_bounds__(S_THREADS) stream_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int last;
  constexpr int XE = sizeof(TX), VE = sizeof(TF);
  constexpr int CPL = stream_cpl(MR), COLS = LC * CPL;  // columns a lane, a block
  constexpr int MRL = MR * LC / 32;  // rows a lane: lane group g = lane / LC takes rows g·MRL..
  constexpr int SB = seg_bytes(COLS, VE), NWV = seg_words(COLS, VE);  // a V row's slot
  constexpr int XV = quant_rows::Vec16<TX>::N;  // x values a 16-byte load
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.y * MR, mv = min(MR, a.M - m0);
  const int nq = a.quant ? MR : 0;  // quantizer blocks first: none waits behind the tiles

  if ((int)blockIdx.x < nq) {  // quantizer block: row m0 + blockIdx.x
    if ((int)blockIdx.x < mv)
      quantize<S_THREADS>(a, static_cast<const TX*>(a.x), m0 + (int)blockIdx.x,
                          reinterpret_cast<float*>(smem));
    return;
  }
  const int b = (int)blockIdx.x - nq, kc = b % a.nk, rt = b / a.nk;
  const int bk = a.bk, sub = a.sub;
  const int kb = kc * bk + warp * sub;             // the warp's sub-chunk
  const int n = max(0, min(sub, a.K - kb));        // its k inside K
  const int r0 = rt * COLS, rv = min(COLS, a.R - r0);
  const int xsb = seg_bytes(sub, XE);              // an x row's slot
  unsigned char* vs = smem + (size_t)warp * sub * SB;
  unsigned char* xw = smem + stream_region(MR, COLS, bk, VE) + (size_t)warp * MR * xsb;
  const uintptr_t xbase = reinterpret_cast<uintptr_t>(a.x);
  const uintptr_t vbase = reinterpret_cast<uintptr_t>(a.v);

  // 1. by cp.async: the warp's x rows (with the first group) and its V
  //    rows, columns r0.., in S_PARTS groups of rows; nothing past M or K
  const int parts = sub >= 4 * S_PARTS ? S_PARTS : 1;
  const int rows_part = sub / parts;
  if (n > 0) {
    const int nwx = seg_words(n, XE);
    for (int it = lane; it < mv * nwx; it += 32) {
      const int m = it / nwx;
      copy_word(xw + m * xsb, xbase + ((size_t)(m0 + m) * a.K + kb) * XE, n, XE, it % nwx);
    }
  }
  for (int p = 0; p < parts; ++p) {
    const int j0 = p * rows_part, nj = min(j0 + rows_part, n) - j0;
    for (int it = lane; it < nj * NWV; it += 32) {
      const int j = j0 + it / NWV;
      copy_word(vs + j * SB, vbase + ((size_t)(kb + j) * a.R + r0) * VE, rv, VE, it % NWV);
    }
    cp_async_commit();
  }

  // 2. the chains: columns r0 + c (+ LC), c = lane % LC, rows g·MRL.. of
  //    the tile, g = lane / LC, k ascending.
  //    Row j of V starts (off + j·rb) & 15 bytes into its slot, which
  //    repeats every 8 rows; x rows are read 16 bytes at a time where they
  //    start on a 16-byte word (the rows past M hold no data and are not
  //    written out).
  const int lc = lane % LC, mg = lane / LC * MRL;
  float acc[CPL][MRL];
#pragma unroll
  for (int h = 0; h < CPL; ++h)
#pragma unroll
    for (int m = 0; m < MRL; ++m) acc[h][m] = 0.f;
  const int rb = (int)(((size_t)a.R * VE) & 15);
  const int off = (int)((vbase + ((size_t)kb * a.R + r0) * VE) & 15);
  int vo[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) vo[q] = ((off + q * rb) & 15) + lc * VE;
  const bool xvec =
      ((xbase | (size_t)a.K * XE | (size_t)kb * XE) & 15) == 0 && !(rows_part & 7);
  for (int p = 0; p < parts; ++p) {
    if (parts == 1 || p == S_PARTS - 1) cp_async_wait<0>();
    else if (p == 0) cp_async_wait<S_PARTS - 1>();
    else if (p == 1) cp_async_wait<S_PARTS - 2>();
    else cp_async_wait<S_PARTS - 3>();
    __syncwarp();
    int j = p * rows_part;
    const int j1 = min(j + rows_part, n);
    if (xvec)
      for (; j + 8 <= j1; j += 8) {
        float vk[CPL][8];
#pragma unroll
        for (int h = 0; h < CPL; ++h)
#pragma unroll
          for (int q = 0; q < 8; ++q)
            vk[h][q] = load_elem<TF>(vs + (j + q) * SB + vo[q] + LC * h * VE);
#pragma unroll
        for (int m = 0; m < MRL; ++m) {
          float xk[8];
#pragma unroll
          for (int e = 0; e < 8 / XV; ++e)
            quant_rows::Vec16<TX>::load(
                reinterpret_cast<const TX*>(xw + (mg + m) * xsb + (j + e * XV) * XE), xk + e * XV);
#pragma unroll
          for (int h = 0; h < CPL; ++h)
#pragma unroll
            for (int q = 0; q < 8; ++q) acc[h][m] = fmaf(xk[q], vk[h][q], acc[h][m]);
        }
      }
    for (; j < j1; ++j) {
      float vk[CPL];
#pragma unroll
      for (int h = 0; h < CPL; ++h)
        vk[h] = load_elem<TF>(vs + j * SB + ((off + j * rb) & 15) + (lc + LC * h) * VE);
#pragma unroll
      for (int m = 0; m < MRL; ++m) {
        const int xo = (int)((xbase + ((size_t)(m0 + mg + m) * a.K + kb) * XE) & 15);
        const float xk = load_elem<TX>(xw + (mg + m) * xsb + xo + j * XE);
#pragma unroll
        for (int h = 0; h < CPL; ++h) acc[h][m] = fmaf(xk, vk[h], acc[h][m]);
      }
    }
  }

  // 3. the chunk's partial: the warps' chains added in warp order
  __syncthreads();  // every warp is done with its V rows; its chains take their place
  float* chains = reinterpret_cast<float*>(smem);  // [SUBS][MR][COLS]
#pragma unroll
  for (int h = 0; h < CPL; ++h)
#pragma unroll
    for (int m = 0; m < MRL; ++m)
      chains[(warp * MR + mg + m) * COLS + LC * h + lc] = acc[h][m];
  __syncthreads();
  const int tile = (int)blockIdx.y * a.tiles_r + rt;
  float* mine = a.part + (size_t)tile * a.nk * MR * COLS;
  for (int i = tid; i < MR * COLS; i += S_THREADS) {
    float s = chains[i];
#pragma unroll
    for (int w = 1; w < SUBS; ++w) s = __fadd_rn(s, chains[w * MR * COLS + i]);
    const int m = i / COLS, c = i % COLS;
    if (a.nk == 1) {
      if (m < mv && c < rv) a.xv[(size_t)(m0 + m) * a.R + r0 + c] = s;
    } else {
      mine[(size_t)kc * MR * COLS + i] = s;
    }
  }
  if (a.nk == 1) return;

  // 4. the tile's last block adds the nk partials in ascending K
  if (!take_ticket(a.tickets, tile, a.nk, &last)) return;
  constexpr int Q = (MR * COLS + S_THREADS - 1) / S_THREADS;  // outputs a thread
  const float* p[Q];
  bool on[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int i = tid + q * S_THREADS, m = i / COLS, c = i % COLS;
    on[q] = i < MR * COLS && m < mv && c < rv;
    p[q] = mine + (on[q] ? i : 0);
  }
  float sum[Q];
  fold_chunks<Q>(p, on, a.nk, (size_t)MR * COLS, sum);
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int i = tid + q * S_THREADS;
    if (on[q]) a.xv[(size_t)(m0 + i / COLS) * a.R + r0 + i % COLS] = sum[q];
  }
}

// ---------------------------------------------------------------------------
// tiled regime: grid (tiles · splits + quantizer blocks)
// ---------------------------------------------------------------------------

// dynamic shared memory: T_STAGES raw stages [T_BM x-row segments][T_BK
// V-row segments], then the f32 compute layouts xs [T_BK][T_BM] and vs
// [T_BK][T_BN]
__host__ __device__ constexpr int tiled_stage(int xe, int ve) {
  return T_BM * seg_bytes(T_BK, xe) + T_BK * seg_bytes(T_BN, ve);
}
__host__ __device__ constexpr int tiled_smem(int xe, int ve) {
  return T_STAGES * tiled_stage(xe, ve) + 4 * T_BK * (T_BM + T_BN);
}

// n (<= 16) consecutive elements of a copied segment, as f32, from byte p
// on: 16-byte loads where p is 16-byte aligned (n a multiple of 16 / es)
template <typename T, int N>
__device__ __forceinline__ void load_run(const unsigned char* p, bool aligned, float (&out)[N]) {
  constexpr int ES = sizeof(T), PER = 16 / ES;
  if (aligned) {
#pragma unroll
    for (int w = 0; w < N / PER; ++w)
      quant_rows::Vec16<T>::load(reinterpret_cast<const T*>(p + 16 * w), out + PER * w);
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e) out[e] = load_elem<T>(p + e * ES);
  }
}

template <typename TX, typename TF>
__global__ void __launch_bounds__(T_THREADS, 2) tiled_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int last;
  constexpr int XE = sizeof(TX), VE = sizeof(TF);
  constexpr int XSB = seg_bytes(T_BK, XE), VSB = seg_bytes(T_BN, VE);
  constexpr int XRAW = T_BM * XSB, STAGE = tiled_stage(XE, VE);
  constexpr int VPARTS = T_THREADS / T_BK, VRUN = T_BN / VPARTS;  // V columns a thread
  float* xs = reinterpret_cast<float*>(smem + T_STAGES * STAGE);  // [T_BK][T_BM]
  float* vs = xs + T_BK * T_BM;                                    // [T_BK][T_BN]
  const int tid = threadIdx.x;
  const int ntiles = a.tiles_m * a.tiles_r, nproj = ntiles * a.splits;

  if ((int)blockIdx.x >= nproj) {  // quantizer block: one row, after the tiles (their tail)
    quantize<T_THREADS>(a, static_cast<const TX*>(a.x), (int)blockIdx.x - nproj,
                        reinterpret_cast<float*>(smem));
    return;
  }
  const int split = (int)blockIdx.x / ntiles, tile = (int)blockIdx.x % ntiles;
  const int m0 = tile / a.tiles_r * T_BM, r0 = tile % a.tiles_r * T_BN;
  const int c0 = split * a.cps, c1 = min(c0 + a.cps, a.nk);
  const int kbeg = c0 * a.bk, nst = (c1 - c0) * a.bk / T_BK;
  const int nv = min(T_BN, a.R - r0);

  // thread tid copies and converts x-row tid; thread (vj, vp) V-row vj,
  // columns vp·VRUN..  A row's segment starts at the same offset in its
  // first word at every stage (a stage is T_BK k, a split starts at a
  // multiple of 256).
  const bool xrow = m0 + tid < a.M;
  const uintptr_t xsrc =
      reinterpret_cast<uintptr_t>(a.x) + ((size_t)(m0 + tid) * a.K + kbeg) * XE;
  const int xoff = (int)(xsrc & 15);
  const int vj = tid / VPARTS, vp = tid % VPARTS;
  const uintptr_t vsrc =
      reinterpret_cast<uintptr_t>(a.v) + ((size_t)(kbeg + vj) * a.R + r0) * VE;
  const int voff = (int)(vsrc & 15);

  // copies of stage s into its ring slot (nothing past M or K)
  auto copy_stage = [&](int s) {
    unsigned char* st = smem + (s % T_STAGES) * STAGE;
    const int kn = min(T_BK, a.K - (kbeg + s * T_BK));
    if (kn <= 0) return;
    if (xrow)
      for (int j = 0; j < seg_words(kn, XE); ++j)
        copy_word(st + tid * XSB, xsrc + (size_t)s * T_BK * XE, kn, XE, j);
    if (vj < kn)
      for (int j = vp; j < seg_words(nv, VE); j += VPARTS)
        copy_word(st + XRAW + vj * VSB, vsrc + (size_t)s * T_BK * a.R * VE, nv, VE, j);
  };

  // conversion of a landed stage to f32, zero past M, K and R
  auto convert = [&](int s) {
    const unsigned char* st = smem + (s % T_STAGES) * STAGE;
    const int kn = a.K - (kbeg + s * T_BK);
#pragma unroll
    for (int h = 0; h < T_BK / 16; ++h) {
      float t[16];
      load_run<TX, 16>(st + tid * XSB + xoff + 16 * h * XE, xoff == 0, t);
#pragma unroll
      for (int q = 0; q < 16; ++q)
        xs[(16 * h + q) * T_BM + tid] = xrow && 16 * h + q < kn ? t[q] : 0.f;
    }
    float t[VRUN];
    load_run<TF, VRUN>(st + XRAW + vj * VSB + voff + vp * VRUN * VE, false, t);
#pragma unroll
    for (int q = 0; q < VRUN / 4; ++q) {
      float4 f;
      const int c = vp * VRUN + 4 * q;
      f.x = vj < kn && c < nv ? t[4 * q] : 0.f;
      f.y = vj < kn && c + 1 < nv ? t[4 * q + 1] : 0.f;
      f.z = vj < kn && c + 2 < nv ? t[4 * q + 2] : 0.f;
      f.w = vj < kn && c + 3 < nv ? t[4 * q + 3] : 0.f;
      *reinterpret_cast<float4*>(vs + vj * T_BN + c) = f;
    }
  };

  // thread (ty, tx): rows 4ty + i and T_BM/2 + 4ty + i, columns 4tx + j and
  // T_BN/2 + 4tx + j (i, j < 4)
  const int ty = tid / 8, tx = tid % 8;
  auto row_of = [&](int i) { return (i < 4 ? 4 * ty : T_BM / 2 + 4 * ty - 4) + i; };
  float acc[T_TM][T_TN], chunk[T_TM][T_TN];
#pragma unroll
  for (int i = 0; i < T_TM; ++i)
#pragma unroll
    for (int j = 0; j < T_TN; ++j) acc[i][j] = chunk[i][j] = 0.f;
  const int per_sub = a.sub / T_BK;  // stages a sub-chunk
  float* mine = a.part + (size_t)tile * a.nk * T_BM * T_BN;
  int w = 0, c = c0;

#pragma unroll
  for (int s = 0; s < T_STAGES - 1; ++s) {
    if (s < nst) copy_stage(s);
    cp_async_commit();
  }
  for (int s = 0; s < nst; ++s) {
    cp_async_wait<T_STAGES - 2>();
    __syncthreads();  // stage s landed; every thread is done with the last f32 stage
    convert(s);
    if (s + T_STAGES - 1 < nst) copy_stage(s + T_STAGES - 1);  // into stage s - 1's slot
    cp_async_commit();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < T_BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(xs + kk * T_BM + 4 * ty);
      const float4 a1 =
          *reinterpret_cast<const float4*>(xs + kk * T_BM + T_BM / 2 + 4 * ty);
      const float4 b0 = *reinterpret_cast<const float4*>(vs + kk * T_BN + 4 * tx);
      const float4 b1 =
          *reinterpret_cast<const float4*>(vs + kk * T_BN + T_BN / 2 + 4 * tx);
      const float xr[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float vr[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < T_TM; ++i)
#pragma unroll
        for (int j = 0; j < T_TN; ++j) acc[i][j] = fmaf(xr[i], vr[j], acc[i][j]);
    }
    if ((s + 1) % per_sub) continue;
    // a sub-chunk ends: its chains into the chunk sums
#pragma unroll
    for (int i = 0; i < T_TM; ++i)
#pragma unroll
      for (int j = 0; j < T_TN; ++j) {
        chunk[i][j] = w == 0 ? acc[i][j] : __fadd_rn(chunk[i][j], acc[i][j]);
        acc[i][j] = 0.f;
      }
    if (++w < SUBS) continue;
    // a chunk ends: its sums into the totals (held in xv), or to scratch
    // where K is split
    w = 0;
    if (a.splits == 1) {
#pragma unroll
      for (int i = 0; i < T_TM; ++i) {
        const int m = m0 + row_of(i);
        if (m >= a.M) continue;
        float* out = a.xv + (size_t)m * a.R + r0;
#pragma unroll
        for (int j = 0; j < T_TN; ++j) {
          const int col = (j < 4 ? 4 * tx : T_BN / 2 + 4 * tx - 4) + j;
          if (col < nv) out[col] = c == 0 ? chunk[i][j] : __fadd_rn(out[col], chunk[i][j]);
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < T_TM; ++i) {
        float* p = mine + ((size_t)c * T_BM + row_of(i)) * T_BN + 4 * tx;
        *reinterpret_cast<float4*>(p) =
            make_float4(chunk[i][0], chunk[i][1], chunk[i][2], chunk[i][3]);
        *reinterpret_cast<float4*>(p + T_BN / 2) =
            make_float4(chunk[i][4], chunk[i][5], chunk[i][6], chunk[i][7]);
      }
    }
    ++c;
  }
  cp_async_wait<0>();
  if (a.splits == 1) return;

  // K split: the tile's last block adds the chunk sums in ascending K
  if (!take_ticket(a.tickets, tile, a.splits, &last)) return;
#pragma unroll 1
  for (int i0 = 0; i0 < T_TM; i0 += 4) {  // four rows, both column halves, at a time
    const float4* p[8];
    bool on[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int i = i0 + q / 2, col = q % 2 * (T_BN / 2) + 4 * tx;
      on[q] = m0 + row_of(i) < a.M;
      p[q] = reinterpret_cast<const float4*>(mine + (size_t)row_of(i) * T_BN + col);
    }
    float4 t[8];
    fold_chunks<8, 4>(p, on, a.nk, (size_t)T_BM * T_BN / 4, t);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int col = q % 2 * (T_BN / 2) + 4 * tx;
      const float o[4] = {t[q].x, t[q].y, t[q].z, t[q].w};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (on[q] && col + j < nv)
          a.xv[(size_t)(m0 + row_of(i0 + q / 2)) * a.R + r0 + col + j] = o[j];
    }
  }
}

// ---------------------------------------------------------------------------
// rotation launch: grid (M); the rotated row quantized and, with V, written
// ---------------------------------------------------------------------------

// stages row `row` of x (K values) into buf as f32, 16 bytes a load where
// the row allows; all loads before stores
template <typename TX>
__device__ __forceinline__ void stage_row(const TX* __restrict__ row, int K, float* buf) {
  constexpr int N = quant_rows::Vec16<TX>::N;
  const int tid = threadIdx.x;
  if (K % N == 0 && !(reinterpret_cast<uintptr_t>(row) & 15)) {
    for (int i0 = 0; i0 < K / N; i0 += 4 * Q_THREADS) {
      float t[4][N];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = i0 + j * Q_THREADS + tid;
        if (i < K / N) quant_rows::Vec16<TX>::load(row + (size_t)i * N, t[j]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = i0 + j * Q_THREADS + tid;
        if (i < K / N)
#pragma unroll
          for (int e = 0; e < N; e += 4)
            *reinterpret_cast<float4*>(buf + i * N + e) =
                make_float4(t[j][e], t[j][e + 1], t[j][e + 2], t[j][e + 3]);
      }
    }
    return;
  }
  for (int i0 = 0; i0 < K; i0 += 16 * Q_THREADS) {
    float t[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int i = i0 + j * Q_THREADS + tid;
      t[j] = i < K ? to_f32(row[i]) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int i = i0 + j * Q_THREADS + tid;
      if (i < K) buf[i] = t[j];
    }
  }
}

template <typename TX>
__global__ void __launch_bounds__(Q_THREADS) rotate_kernel(Args a, const TX* __restrict__ x,
                                                           float* __restrict__ xr, float nrm) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* buf = reinterpret_cast<float*>(smem);  // [K] the row, then the reduction
  const size_t row = blockIdx.x;
  stage_row(x + row * a.K, a.K, buf);
  __syncthreads();
  fwht_rows::rotate<Q_THREADS>(buf, a.K, a.K, nrm);  // ends with a barrier
  if (xr && a.K % 4 == 0)
    for (int i = threadIdx.x; i < a.K / 4; i += Q_THREADS)
      reinterpret_cast<float4*>(xr + row * a.K)[i] = reinterpret_cast<const float4*>(buf)[i];
  else if (xr)
    for (int i = threadIdx.x; i < a.K; i += Q_THREADS) xr[row * a.K + i] = buf[i];
  float* srow = a.sx + row * (a.group > 0 ? a.K / a.group : 1);
  if (a.group > 0)
    quant_rows::quantize_row_grouped<Q_THREADS>(buf, a.K, a.group, a.xq + row * a.K, srow,
                                                a.qmax, a.clip_ratio);
  else
    quant_rows::quantize_row<Q_THREADS>(buf, a.K, a.xq + row * a.K, srow, a.qmax,
                                        a.clip_ratio, buf + a.K);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

inline int device_sms() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      sms = 132;
  }
  return sms;
}

// The launch plan of (M, K, R) from shapes, the operand widths and the SM count.
struct Plan {
  int tiled, rows, cols, tiles_m, tiles_r, bk, chunks, cps, splits, threads, smem,
      launches;
  size_t zeroed, scratch, part;  // bytes: tickets; partials + rotated rows; partials
};

Plan plan_of(int M, int K, int R, int rotate, int xe, int ve, int sms) {
  Plan p;
  if (rotate) xe = 4;  // the projection reads the f32 rotated rows
  p.bk = chunk_k(K);
  p.chunks = tiles(K, p.bk);
  p.tiled = M > STREAM_M && K >= TILED_MIN_K &&
            tiles(M, T_BM) * tiles(R, T_BN) * p.chunks >= sms;
  if (p.tiled) {
    p.rows = T_BM, p.cols = T_BN, p.threads = T_THREADS;
    p.smem = tiled_smem(xe, ve);
  } else {
    p.rows = M <= 4 ? 4 : M <= STREAM_M ? 8 : STREAM_M;
    const bool lc16 = p.rows == 4 && p.chunks * tiles(R, S_COLS) * tiles(M, 4) < sms;
    p.cols = (lc16 ? S_COLS / 2 : S_COLS) * stream_cpl(p.rows), p.threads = S_THREADS;
    p.smem = stream_smem(p.rows, p.cols, p.bk, xe, ve);
  }
  p.tiles_m = tiles(M, p.rows);
  p.tiles_r = tiles(R, p.cols);
  if (R == 0) p.smem = 4 * (S_THREADS / 32);  // quantizer blocks alone: their reduction
  p.cps = 1, p.splits = p.chunks;  // stream: a block a chunk
  const int ntiles = p.tiles_m * p.tiles_r;
  if (p.tiled && ntiles < sms) {  // under one tile an SM: whole chunks a split, ~WAVES blocks an SM
    p.cps = tiles(p.chunks, tiles(WAVES * sms, ntiles > 0 ? ntiles : 1));
    p.splits = tiles(p.chunks, p.cps);
  } else if (p.tiled) {
    p.cps = p.chunks, p.splits = 1;
  }
  p.launches = rotate && R > 0 ? 2 : 1;
  const bool split = R > 0 && p.splits > 1;
  p.zeroed = split ? 4 * (size_t)ntiles : 0;
  p.part = split ? 4 * (size_t)ntiles * p.chunks * p.rows * p.cols : 0;
  p.scratch = p.part + (rotate && R > 0 ? 4 * (size_t)M * K : 0);
  return p;
}

// Raise the kernel's dynamic shared memory limit to smem where it exceeds
// the last one set (the default 48 KB also holds the static shared bytes,
// so the first launch always sets it).
template <typename F>
int allow_smem(F kern, int smem, int& configured) {
  if (smem <= configured) return 0;
  const cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  configured = smem;
  return 0;
}

template <typename TX, typename TF>
int project(const Args& a, const Plan& p, cudaStream_t s) {
  if (p.tiled) {
    auto kern = tiled_kernel<TX, TF>;
    static int configured = 0;  // per instantiation
    if (const int e = allow_smem(kern, p.smem, configured)) return e;
    const int grid = p.tiles_m * p.tiles_r * p.splits + (a.quant ? a.M : 0);
    kern<<<grid, T_THREADS, p.smem, s>>>(a);
  } else if (p.rows == 4 && p.cols == S_COLS / 2) {
    auto kern = stream_kernel<4, S_COLS / 2, TX, TF>;
    static int configured = 0;
    if (const int e = allow_smem(kern, p.smem, configured)) return e;
    kern<<<dim3(p.chunks * p.tiles_r + (a.quant ? 4 : 0), p.tiles_m), S_THREADS, p.smem, s>>>(a);
  } else if (p.rows == 4) {
    auto kern = stream_kernel<4, S_COLS, TX, TF>;
    static int configured = 0;
    if (const int e = allow_smem(kern, p.smem, configured)) return e;
    kern<<<dim3(p.chunks * p.tiles_r + (a.quant ? 4 : 0), p.tiles_m), S_THREADS, p.smem, s>>>(a);
  } else if (p.rows == 8) {
    auto kern = stream_kernel<8, S_COLS, TX, TF>;
    static int configured = 0;
    if (const int e = allow_smem(kern, p.smem, configured)) return e;
    kern<<<dim3(p.chunks * p.tiles_r + (a.quant ? 8 : 0), p.tiles_m), S_THREADS, p.smem, s>>>(a);
  } else {
    auto kern = stream_kernel<STREAM_M, S_COLS, TX, TF>;
    static int configured = 0;
    if (const int e = allow_smem(kern, p.smem, configured)) return e;
    kern<<<dim3(p.chunks * p.tiles_r + (a.quant ? STREAM_M : 0), p.tiles_m), S_THREADS, p.smem,
           s>>>(a);
  }
  return (int)cudaGetLastError();
}

template <typename TF>
int project_v(int x_bf16, const Args& a, const Plan& p, cudaStream_t s) {
  return x_bf16 ? project<__nv_bfloat16, TF>(a, p, s) : project<float, TF>(a, p, s);
}

template <typename TX>
int rotate_rows(const Args& a, float* xr, cudaStream_t s) {
  auto kern = rotate_kernel<TX>;
  static int configured = 0;
  const int smem = 4 * a.K + 4 * (Q_THREADS / 32);
  if (const int e = allow_smem(kern, smem, configured)) return e;
  kern<<<a.M, Q_THREADS, smem, s>>>(a, static_cast<const TX*>(a.x), xr, fwht_rows::norm(a.K));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The widest K the rotated launch takes (a whole row in shared memory).
int fused_prologue_max_rotate_k() { return MAX_ROTATE_K; }

// The plan of a call at (M, K, R) on a card of `sms` SMs (0: the current
// device's), x and V bf16 (1) or f32 (0), as out[0..13] = tiled, rows and
// columns of an output tile, row tiles, column tiles, chunk size, chunks,
// chunks a split, splits, threads and dynamic shared bytes of the
// projection launch, device launches, zeroed scratch bytes, scratch bytes.
void fused_prologue_plan(int M, int K, int R, int rotate, int x_bf16, int v_bf16, int sms,
                         long long* out) {
  const Plan p = plan_of(M, K, R, rotate, x_bf16 ? 2 : 4, v_bf16 ? 2 : 4,
                         sms > 0 ? sms : device_sms());
  const long long v[14] = {p.tiled, p.rows, p.cols, p.tiles_m, p.tiles_r, p.bk, p.chunks,
                           p.cps, p.splits, p.threads, p.smem, p.launches,
                           (long long)p.zeroed, (long long)p.scratch};
  for (int i = 0; i < 14; ++i) out[i] = v[i];
}

// Launch on `stream`; returns the first CUDA error of the launches (0 =
// ok).  x_bf16 / f_bf16 select bf16 (1) or f32 (0) for x and for V; with R
// = 0, v and xv may be null and only xq and sx are written.  group 0 writes
// per-token scales sx (M, 1), group g > 0 (dividing K) the (M, K/g) plane.
// rotate (1) quantizes and projects x·H_K, K a power of two within
// fused_prologue_max_rotate_k().  `zeroed` holds the plan's zeroed bytes,
// all zero (every launch leaves them so), `scratch` its scratch bytes;
// either may be null where the plan asks for none.
int fused_prologue(const void* x, int x_bf16, const void* v, int f_bf16, void* xq, void* sx,
                   void* xv, void* zeroed, void* scratch, int M, int K, int R, int group,
                   int qmax, float clip_ratio, int rotate, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rotate && ((K & (K - 1)) || K > MAX_ROTATE_K)) return (int)cudaErrorInvalidValue;
  if (group < 0 || (group > 0 && K % group)) return (int)cudaErrorInvalidValue;
  if (M <= 0) return 0;
  const Plan p = plan_of(M, K, R, rotate, x_bf16 ? 2 : 4, f_bf16 ? 2 : 4, device_sms());
  if ((p.zeroed && !zeroed) || (p.scratch && !scratch)) return (int)cudaErrorInvalidValue;
  Args a;
  a.x = x, a.v = v;
  a.xq = static_cast<int8_t*>(xq), a.sx = static_cast<float*>(sx);
  a.xv = static_cast<float*>(xv);
  a.tickets = static_cast<int*>(zeroed), a.part = static_cast<float*>(scratch);
  a.M = M, a.K = K, a.R = R, a.group = group, a.qmax = qmax, a.clip_ratio = clip_ratio;
  a.quant = !rotate;
  a.bk = p.bk, a.nk = p.chunks, a.sub = p.bk / SUBS;
  a.tiles_m = p.tiles_m, a.tiles_r = p.tiles_r, a.cps = p.cps, a.splits = p.splits;
  if (rotate) {
    float* xr = R > 0 ? reinterpret_cast<float*>(static_cast<char*>(scratch) + p.part) : nullptr;
    const int e = x_bf16 ? rotate_rows<__nv_bfloat16>(a, xr, s) : rotate_rows<float>(a, xr, s);
    if (e || R == 0) return e;
    a.x = xr;
    return f_bf16 ? project<float, __nv_bfloat16>(a, p, s) : project<float, float>(a, p, s);
  }
  return f_bf16 ? project_v<__nv_bfloat16>(x_bf16, a, p, s) : project_v<float>(x_bf16, a, p, s);
}

}  // extern "C"
