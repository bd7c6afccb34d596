// W4A4 GEMM with the low-rank epilogue for Hopper (sm_90a):
//
//     out = (xq · unpack(W)) · sx · sw  +  xv · Uᵀ                 (M, N) f32
//
// from precomputed xq (M, K) int8, sx (M, 1) f32, W (K/2, N) uint8 (the even
// K row in the low nibble), sw (N,) f32, xv (M, R) f32 and U (N, R) bf16 or
// f32 (R may be 0).  With `group` g > 0 (g divides K), sx is the (M, K/g)
// scale plane of group-wise activation scales, and the GEMM dequantizes in
// the K loop:
//
//     out = (Σ_g fl(p_g · sx[:, g])) · sw  +  xv · Uᵀ
//
// p_g the exact int32 partial over group g.  Replaces the TPU kernel
// repro/kernels/w4a4.py::w4a4_lowrank_matmul_kernel, per-token and with its
// `group` branch: the GEMM of the chained (after fused_prologue.cu) and
// unfused (after act_quant.cu) paths.
//
// Numerics: the int32 accumulation is exact in any order; per-token the
// epilogue is __fmul_rn(__fmul_rn((float)acc, sx), sw); group-wise the f32
// sum over groups is the canonical order of rowops.gemm_grouped (ascending g
// from 0.f, __fmul_rn then __fadd_rn), then __fmul_rn(·, sw); then o =
// __fadd_rn(o, lr) with lr ONE fmaf chain per output over r ascending from
// 0.f.  So no tile, k-order, K-split, grid or M changes a bit of the result
// (with g = K it is bitwise the per-token result), and only the LR sum is
// ordered differently from the plain version (bench.common.gemm_tolerance).
//
// Bound on an H100 SXM: at decode, memory: K·N/2 (packed W) + 4N (sw) +
// 2·R·N (bf16 U) + the activations, 12.6 MB and 3.8 us at Phi-3-mini's K
// 8192, N 3072, R 307.  At M 2048: the int8 operations 2·M·K·N over 1,979
// TOPS (93 us at 11008 x 4096) and the LR term's 2·M·N·R f32 operations
// over 67 TFLOP/s (689 us at R 1024).
//
// Design.  The integer product runs on the tensor cores, mma.sync m16n8k32
// s32.s8.s8 with both operands 4-bit codes held as int8 in [-8, 7] (Hopper
// lists no int4 tensor-core rate).  Packed W tiles and xq tiles stream
// through a ring of shared-memory stages (64 codes of K at decode, 128 for
// the large tile) by 16-byte cp.async.  W stays packed there, half a byte
// a code; each thread expands its B fragments in registers: the 32-bit
// words of packed rows 4t..4t+3 at columns c..c+3 (one load each) are
// interleaved by byte permutes into, per column, the codes k = 8t..8t+7,
// and a borrow-free byte-wise (nib ^ 8) - 8 sign-extends them.  The mma's
// k positions 4t..4t+3 and 16+4t..16+4t+3 then hold the codes 8t..8t+3
// and 8t+4..8t+7: one permutation of k inside a k-step, the same for A,
// where it is one 8-byte load of a row (exact int32 sums do not care).
// Thread (g, t)'s four n8 tiles hold columns c + j with c = the warp's
// first + 4g, so its outputs are the eight consecutive columns the warp's
// first + 8t .. + 8t + 7.  Both stages are XOR-swizzled in 16-byte units
// so that those reads meet no bank conflict.
//
// Two tile regimes, chosen from shapes alone (w4a4.gemm_plan mirrors the
// plan):
// * M <= 16 (decode, the served 16-row chunk): a weight stream.  One 16-row
//   mma tile with the rows past M zero: the same fragment code as the large
//   tile, and at decode the tensor cores are far from the bound, where W in
//   the 16-row operand slot would need a second fragment layout.  4 warps
//   over 128 columns, 3 stages of 64 codes.  K is split across blocks
//   (whole stages, about WAVES blocks an SM over the N tiles); each split
//   writes its exact int32 partial tile, or group-wise adds its groups'
//   int32 partials into a (tile, group, row, column) plane with integer
//   atomics (a group may straddle two splits).  The LR term runs at the
//   same time in blocks of its own, one per 32 columns: each copies the
//   16-byte words of its U rows' segments by cp.async in LR_PARTS groups of
//   ascending ranks and runs its chains on each group as it lands (xv the
//   same way), then writes the chains' results.  Each 32-column sub-tile
//   has a ticket that its K-splits and its LR block take; the last of them,
//   whichever it is, finishes every sub-tile it was last for in one pass
//   (int4 loads of the partials, the f32 group sum over the plane in
//   ascending g, the epilogue, the LR term added) and resets the tickets
//   and the plane entries it read: no memset precedes a launch, one launch
//   is the call's one device operation.
// * M > 16: 128 x 128 tiles, 8 warps of 64 x 32 (four 16-row mma tiles by
//   four n8 tiles), 4 stages of 128 codes, no K-split; the epilogue is
//   written out, then the LR term added in the same block: U and xv copied
//   32 ranks at a time by cp.async (the next chunk's copies overlap the
//   FMAs), transposed to f32, each thread's 64 chains (its fragment's rows
//   and columns) fed eight values of U and eight of xv a rank.
// Group-wise, a group's partial is the accumulator fragment after g/32
// k-steps, flushed and zeroed at the group's end; a k-step that a group
// boundary cuts (32 does not divide g) runs once per piece, with the A
// fragment's bytes outside the piece masked to zero.
//
// Later work: wgmma with TMA loads (64-row warpgroup tiles read from shared
// memory, the way to the card's full int8 rate), and a tensor-core LR term,
// which needs an accuracy standard of its own.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int BN = 128;                  // output columns per tile
constexpr int DECODE_M = 16;             // M up to this takes the weight stream
constexpr int LR_COLS = 32;              // columns of one decode LR block
constexpr int LR_BLOCKS = BN / LR_COLS;  // decode LR blocks per tile
constexpr int LR_BYTES_D = 640;          // bytes of a U row per decode LR chunk (320 bf16 ranks)
constexpr int LR_RANKS_L = 32;           // ranks per LR chunk of a large tile
constexpr int WAVES = 3;                 // decode GEMM blocks per SM the K-split aims at
constexpr int LR_PARTS = 4;              // copy groups of a decode LR chunk

// shared bytes of a row segment of n elements of es bytes, copied as the
// 16-byte words aligned in memory that it touches
__host__ __device__ constexpr int seg_words(int n, int es) { return (n * es + 15) / 16 + 1; }
__host__ __device__ constexpr int seg_bytes(int n, int es) { return 16 * seg_words(n, es); }

template <bool DECODE>
struct Tile {
  static constexpr int WM = DECODE ? 1 : 4;  // 16-row mma tiles per warp
  static constexpr int WARPS_M = DECODE ? 1 : 2;
  static constexpr int WARPS_N = 4;          // 32 columns each
  static constexpr int STAGES = DECODE ? 3 : 4;
  static constexpr int BK = DECODE ? 64 : 128;  // K codes per stage
  static constexpr int BKP = BK / 2;             // packed W rows per stage
  static constexpr int BM = 16 * WM * WARPS_M;
  static constexpr int THREADS = 32 * WARPS_M * WARPS_N;
  static constexpr int W_BYTES = BKP * BN;   // a stage of packed W
  static constexpr int X_BYTES = BM * BK;    // a stage of xq
  static constexpr int RING = STAGES * (W_BYTES + X_BYTES);
  // LR staging, the row segments of a rank chunk as they lie in memory:
  // decode U [LR_COLS] rows and xv [16] rows of LR_BYTES_D / 2 bf16 (or
  // / 4 f32) ranks; large U [BN] and xv [BM] rows of LR_RANKS_L ranks, then
  // both transposed to f32 [LR_RANKS_L][128]
  static constexpr int LR = DECODE
      ? LR_COLS * seg_bytes(LR_BYTES_D, 1) + DECODE_M * seg_bytes(LR_BYTES_D / 2, 4)
      : (BN + BM) * seg_bytes(LR_RANKS_L, 4) + LR_RANKS_L * (BN + BM) * 4;
  static constexpr int SMEM = RING > LR ? RING : LR;
};

struct Args {
  const int8_t* xq;
  const float* sx;
  const uint8_t* w;
  const float* sw;
  const float* xv;
  const void* u;
  float* out;
  int* tickets;  // zeroed scratch: [tiles][LR_BLOCKS] tickets, then the group plane
  int* plane;    // [tiles][G][M][BN] int32 group partials of the splits
  int* part;     // scratch: [tiles][ks][M][BN] int32 per-token split partials
  float* lr;     // then [M][tiles · BN] f32 LR terms
  int M, K, N, R, group, G, u_bf16;
  int tiles_n, nst, sps, ks, lr_blocks, ticket_total;
  int vec_w, vec_x, vec_out;
};

// d += a · b on the tensor cores (m16n8k32, s8 in, s32 accumulate); the
// fragments in the PTX ISA's layout: with g = lane / 4 and t = lane % 4,
// a = A(g, 4t..4t+3), A(g + 8, 4t..), A(g, 16+4t..), A(g + 8, 16+4t..);
// b = B(4t..4t+3, g), B(16+4t..16+4t+3, g); d = D(g, 2t), D(g, 2t + 1),
// D(g + 8, 2t), D(g + 8, 2t + 1).
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

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

// The signed int4 codes of the low nibbles of z's four bytes, one int8 a
// byte: (nib ^ 8) - 8 byte-wise, with bit 7 set first so that no byte
// borrows from the next, and flipped back after.
__device__ __forceinline__ uint32_t low_nibble_codes(uint32_t z) {
  return (((z & 0x0F0F0F0Fu) ^ 0x88888888u) - 0x08080808u) ^ 0x80808080u;
}

// B fragments of one k-step for four n8 tiles from w[i], the packed word of
// row 4t + i at columns c..c+3: b[j][0] holds the codes k = 8t..8t+3 of
// column c + j (rows 4t, 4t+1: low, high, low, high nibble), b[j][1] the
// codes 8t+4..8t+7 (rows 4t+2, 4t+3).
__device__ __forceinline__ void b_fragments(const uint32_t (&w)[4], uint32_t (&b)[4][2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    // bytes (row 2h, row 2h+1) of columns c, c+1, then of c+2, c+3
    const uint32_t lo = __byte_perm(w[2 * h], w[2 * h + 1], 0x5140);
    const uint32_t hi = __byte_perm(w[2 * h], w[2 * h + 1], 0x7362);
    // each byte beside its own high nibble, shifted into a low one
    b[0][h] = low_nibble_codes(__byte_perm(lo, lo >> 4, 0x5140));
    b[1][h] = low_nibble_codes(__byte_perm(lo, lo >> 4, 0x7362));
    b[2][h] = low_nibble_codes(__byte_perm(hi, hi >> 4, 0x5140));
    b[3][h] = low_nibble_codes(__byte_perm(hi, hi >> 4, 0x7362));
  }
}

// bytes [b, e) of a word of four codes, b and e clamped to [0, 4]
__device__ __forceinline__ uint32_t byte_mask(int b, int e) {
  b = max(b, 0);
  e = min(e, 4);
  if (b >= e) return 0u;
  const uint32_t hi = e >= 4 ? 0xFFFFFFFFu : (1u << (8 * e)) - 1u;
  return hi & ~((1u << (8 * b)) - 1u);
}

// Byte offsets of 16-byte units in a stage: an xq row is BK / 16 units (the
// unit index XOR 2 on rows 2, 3 mod 4), a packed W row 8 units (XOR
// 2·((p / 4) mod 4)), so that a warp's fragment reads fall on distinct
// banks.
template <int BK>
__device__ __forceinline__ int x_off(int row, int unit) {
  return row * BK + ((unit ^ (((row >> 1) & 1) << 1)) << 4);
}

__device__ __forceinline__ int w_off(int prow, int unit) {
  return prow * BN + ((unit ^ (((prow >> 2) & 3) << 1)) << 4);
}

// Issue the copies of stage `st` (packed W rows st·BKP.., xq codes st·BK..)
// into one ring slot; zero past M, K and N.  cp.async where rows allow
// 16-byte units, byte loads otherwise (odd N, K % 16 != 0).
template <bool DECODE>
__device__ __forceinline__ void load_stage(unsigned char* ws, unsigned char* xs, const Args& a,
                                           int st, int m0, int n0, int tid) {
  using T = Tile<DECODE>;
  constexpr int BK = T::BK, BKP = T::BKP;
  const int kh = a.K >> 1, p0 = st * BKP, k0 = st * BK;
  if (a.vec_w) {
    for (int i = tid; i < BKP * (BN / 16); i += T::THREADS) {
      const int p = i / (BN / 16), c = i % (BN / 16), kp = p0 + p, n = n0 + 16 * c;
      const bool in = kp < kh && n < a.N;
      cp_async16(ws + w_off(p, c), in ? a.w + (size_t)kp * a.N + n : a.w, in ? 16 : 0);
    }
  } else {
    for (int i = tid; i < BKP * BN; i += T::THREADS) {
      const int p = i / BN, c = i % BN, kp = p0 + p, n = n0 + c;
      ws[w_off(p, c >> 4) + (c & 15)] = (kp < kh && n < a.N) ? a.w[(size_t)kp * a.N + n] : 0;
    }
  }
  if (a.vec_x) {
    for (int i = tid; i < T::BM * (BK / 16); i += T::THREADS) {
      const int r = i / (BK / 16), c = i % (BK / 16), m = m0 + r, k = k0 + 16 * c;
      const bool in = m < a.M && k < a.K;
      cp_async16(xs + x_off<BK>(r, c), in ? a.xq + (size_t)m * a.K + k : a.xq, in ? 16 : 0);
    }
  } else {
    for (int i = tid; i < T::BM * BK; i += T::THREADS) {
      const int r = i / BK, c = i % BK, m = m0 + r, k = k0 + c;
      xs[x_off<BK>(r, c >> 4) + (c & 15)] =
          (m < a.M && k < a.K) ? static_cast<unsigned char>(a.xq[(size_t)m * a.K + k]) : 0;
    }
  }
}

// Copy rows [row0, row0 + nrows) x elements [r0, r0 + rn) of a row-major
// (., R) array of ES-byte elements (bf16 or f32) into shared memory as they
// lie in device memory, by cp.async: row i's segment as the 16-byte words
// aligned in memory that it touches, at dst + i · stride (stride >=
// seg_bytes(rn, ES)), its element r then seg_offset(...) + r·ES bytes in.
// Bytes past a segment's end are not read; its first word may begin up to
// 15 bytes before it, inside the same aligned word of the allocation.
template <int THREADS, int ES>
__device__ __forceinline__ void copy_segments(unsigned char* dst, int stride, const void* src,
                                              size_t R, int row0, int nrows, int r0, int rn,
                                              int tid, int j0 = 0, int j1 = 1 << 30) {
  const uintptr_t base = reinterpret_cast<uintptr_t>(src);
  j1 = min(j1, seg_words(rn, ES));  // words [j0, j1) of each segment
  const int nw = j1 - j0;
  for (int it = tid; it < nrows * nw; it += THREADS) {
    const int i = it / nw, j = j0 + it % nw;
    const uintptr_t a0 = base + ((size_t)(row0 + i) * R + r0) * ES, a1 = a0 + (size_t)rn * ES;
    const uintptr_t w = (a0 & ~(uintptr_t)15) + 16 * (uintptr_t)j;
    if (w < a1)
      cp_async16(dst + (size_t)i * stride + 16 * j, reinterpret_cast<const void*>(w),
                 a1 - w < 16 ? (int)(a1 - w) : 16);
  }
}

// where element r0 of row `row` of such an array sits in its copied segment
// (the byte offset of the segment's first element in its first word)
template <int ES>
__device__ __forceinline__ int seg_offset(const void* src, size_t R, int row, int r0) {
  return (int)((reinterpret_cast<uintptr_t>(src) + ((size_t)row * R + r0) * ES) & 15);
}

__device__ __forceinline__ float bf16_bits_to_float(uint32_t bits) {
  return __uint_as_float(bits << 16);
}

// Each 32-column sub-tile of a decode tile has a ticket; a block takes
// those of sub-tiles [q0, q0 + nq) at once, and last[q] tells whether it
// was the sub-tile's last (every other block that writes into it has
// taken its ticket), that block resetting the ticket for the next launch.
// Called by every thread of the block.
__device__ __forceinline__ void take_tickets(int* tickets, int q0, int nq, int total,
                                             int* last) {
  __threadfence();  // this block's partials are visible before its tickets
  __syncthreads();
  if (threadIdx.x < nq) {
    int* ticket = tickets + q0 + threadIdx.x;
    const bool l = atomicAdd(ticket, 1) == total - 1;
    if (l) *ticket = 0;
    last[threadIdx.x] = l;
  }
  __syncthreads();
  __threadfence();
}

// The last block of decode sub-tiles (32 columns each, every row; bit q of
// `subs` for columns 32q.. of the tile), in one pass: the epilogue from the
// splits' exact int32 partials (per-token their sum; group-wise the f32 sum
// over the group plane in ascending g, the plane reset to zero as it is
// read), the LR term added, the outputs written.  With one split the GEMM
// block has already written its epilogue to `out`.
__device__ void finish_decode(const Args& a, int tile_n, int subs, int tid) {
  constexpr int TH = Tile<true>::THREADS;
  constexpr int QUADS = LR_COLS / 4;  // four consecutive columns a thread, one int4 load
  const int npad = a.tiles_n * BN, outs = a.M * BN, sub = a.M * QUADS;
  const int total = __popc(subs) * sub;
  // quad i of the pass: its row and first column in the tile
  auto pos = [&](int i, int& row, int& col) {
    int q = 0;
    for (int k = i / sub; ; ++q)
      if ((subs >> q) & 1 && k-- == 0) break;
    row = (i % sub) / QUADS;
    col = q * LR_COLS + 4 * (i % QUADS);
  };
  // the four outputs from their f32 epilogue values: the LR term added
  auto put = [&](int row, int col, const float (&o)[4]) {
    const size_t at = (size_t)row * a.N + tile_n * BN + col;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = tile_n * BN + col + j;
      if (n < a.N)
        a.out[at + j] = a.R > 0 ? __fadd_rn(o[j], __ldcg(a.lr + (size_t)row * npad + n)) : o[j];
    }
  };
  if (a.ks == 1) {  // the GEMM block wrote its epilogue
    for (int i = tid; i < total; i += TH) {
      int row, col;
      pos(i, row, col);
      float o[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = tile_n * BN + col + j;
        o[j] = n < a.N ? __ldcg(a.out + (size_t)row * a.N + n) : 0.f;
      }
      put(row, col, o);
    }
    return;
  }
  if (a.group == 0) {  // per-token: integer sums of the splits, exact in any order
    const int* part = a.part + (size_t)tile_n * a.ks * outs;
    for (int i = tid; i < total; i += TH) {
      int row, col;
      pos(i, row, col);
      int4 s = make_int4(0, 0, 0, 0);
#pragma unroll 8
      for (int z = 0; z < a.ks; ++z) {
        const int4 v =
            __ldcg(reinterpret_cast<const int4*>(part + (size_t)z * outs + row * BN + col));
        s.x += v.x, s.y += v.y, s.z += v.z, s.w += v.w;
      }
      const int sv[4] = {s.x, s.y, s.z, s.w};
      const float sxr = __ldg(a.sx + row);
      float o[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = tile_n * BN + col + j;
        o[j] = n < a.N ? __fmul_rn(__fmul_rn((float)sv[j], sxr), __ldg(a.sw + n)) : 0.f;
      }
      put(row, col, o);
    }
    return;
  }
  int* plane = a.plane + (size_t)tile_n * a.G * outs;
  constexpr int QS = 2, GC = 8;  // quads a thread at once, groups a load round
  for (int i0 = 0; i0 < total; i0 += TH * QS) {
    float gs[QS][4];
    int at[QS];  // plane offsets of the quads
#pragma unroll
    for (int j = 0; j < QS; ++j) {
      const int i = i0 + j * TH + tid;
#pragma unroll
      for (int e = 0; e < 4; ++e) gs[j][e] = 0.f;
      at[j] = -1;
      if (i < total) {
        int row, col;
        pos(i, row, col);
        at[j] = row * BN + col;
      }
    }
    for (int g0 = 0; g0 < a.G; g0 += GC) {
      int4 p[QS][GC];
#pragma unroll
      for (int j = 0; j < QS; ++j)
#pragma unroll
        for (int q = 0; q < GC; ++q)
          p[j][q] = (at[j] >= 0 && g0 + q < a.G)
              ? __ldcg(reinterpret_cast<const int4*>(plane + (size_t)(g0 + q) * outs + at[j]))
              : make_int4(0, 0, 0, 0);
#pragma unroll
      for (int j = 0; j < QS; ++j) {
        if (at[j] < 0) continue;
        const float* srow = a.sx + (size_t)(at[j] / BN) * a.G;
#pragma unroll
        for (int q = 0; q < GC; ++q) {
          if (g0 + q < a.G) {
            const float sg = __ldg(srow + g0 + q);
            const int pv[4] = {p[j][q].x, p[j][q].y, p[j][q].z, p[j][q].w};
#pragma unroll
            for (int e = 0; e < 4; ++e) gs[j][e] = __fadd_rn(gs[j][e], __fmul_rn((float)pv[e], sg));
            *reinterpret_cast<int4*>(plane + (size_t)(g0 + q) * outs + at[j]) =
                make_int4(0, 0, 0, 0);
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < QS; ++j) {
      if (at[j] < 0) continue;
      const int row = at[j] / BN, col = at[j] % BN;
      float o[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = tile_n * BN + col + e;
        o[e] = n < a.N ? __fmul_rn(gs[j][e], __ldg(a.sw + n)) : 0.f;
      }
      put(row, col, o);
    }
  }
}

// NACT chains of one column, ranks [rb, re): lr[i] = fmaf(x_i[r], u[r],
// lr[i]) in ascending r, eight ranks' operands loaded ahead of their FMAs.
template <int NACT, int ES>
__device__ __forceinline__ void lr_chain(const unsigned char* ur, const float* const (&xr)[4],
                                         int rb, int re, float (&lr)[4]) {
  auto u_at = [&](int r) {
    return ES == 2 ? bf16_bits_to_float(reinterpret_cast<const unsigned short*>(ur)[r])
                   : reinterpret_cast<const float*>(ur)[r];
  };
  int r = rb;
  for (; r + 8 <= re; r += 8) {
    float uv[8], xv[NACT][8];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      uv[q] = u_at(r + q);
#pragma unroll
      for (int i = 0; i < NACT; ++i) xv[i][q] = xr[i][r + q];
    }
#pragma unroll
    for (int q = 0; q < 8; ++q)
#pragma unroll
      for (int i = 0; i < NACT; ++i) lr[i] = fmaf(xv[i][q], uv[q], lr[i]);
  }
  for (; r < re; ++r) {
    const float uv = u_at(r);
#pragma unroll
    for (int i = 0; i < NACT; ++i) lr[i] = fmaf(xr[i][r], uv, lr[i]);
  }
}

// A decode LR block: columns n0..n0+31 of tile `tile_n`, every row, the
// chains lr = fmaf(xv[m][r], U[n][r], lr) over r ascending from 0.f.  Thread
// (rg, c) owns column n0 + c and rows rg, rg + 4, rg + 8, rg + 12 below M.
// A rank chunk of U and xv is copied in LR_PARTS commit groups of ascending
// ranks, and the chains run on each as soon as it has landed.
template <int ES>
__device__ __forceinline__ void lr_decode(const Args& a, int n0, unsigned char* smem, int tid) {
  constexpr int TH = Tile<true>::THREADS;
  constexpr int RCH = LR_BYTES_D / ES;  // ranks per chunk
  constexpr int SU = seg_bytes(RCH, ES), SX = seg_bytes(RCH, 4);
  const int cv = min(LR_COLS, a.N - n0);
  if (cv <= 0) return;
  unsigned char* us = smem;                 // [LR_COLS][SU]
  unsigned char* xs = smem + LR_COLS * SU;  // [16][SX]
  const int c = tid % LR_COLS, rg = tid / LR_COLS;
  const int nact = c < cv && rg < a.M ? (a.M - rg + 3) / 4 : 0;  // warp-uniform but past cv
  float lr[4] = {0.f, 0.f, 0.f, 0.f};
  for (int r0 = 0; r0 < a.R; r0 += RCH) {
    const int rn = min(RCH, a.R - r0);
    __syncthreads();  // the previous chunk is consumed
    for (int p = 0, ju = 0, jx = 0; p < LR_PARTS; ++p) {
      // words enough for ranks below rn·(p + 1)/LR_PARTS of every row
      const int re = rn * (p + 1) / LR_PARTS;
      const int ju1 = seg_words(re, ES), jx1 = seg_words(re, 4);
      copy_segments<TH, ES>(us, SU, a.u, a.R, n0, cv, r0, rn, tid, ju, ju1);
      copy_segments<TH, 4>(xs, SX, a.xv, a.R, 0, a.M, r0, rn, tid, jx, jx1);
      cp_async_commit();
      ju = ju1;
      jx = jx1;
    }
    const unsigned char* ur = us + c * SU + (c < cv ? seg_offset<ES>(a.u, a.R, n0 + c, r0) : 0);
    const float* xr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = min(rg + 4 * i, a.M - 1);
      xr[i] = reinterpret_cast<const float*>(xs + m * SX + seg_offset<4>(a.xv, a.R, m, r0));
    }
    for (int p = 0, rb = 0; p < LR_PARTS; ++p) {
      if (p == 0) cp_async_wait<LR_PARTS - 1>();
      else if (p == 1) cp_async_wait<LR_PARTS - 2>();
      else if (p == 2) cp_async_wait<LR_PARTS - 3>();
      else cp_async_wait<0>();
      __syncthreads();  // every thread's copies of parts 0..p have landed
      const int re = rn * (p + 1) / LR_PARTS;
      if (nact == 1) lr_chain<1, ES>(ur, xr, rb, re, lr);
      else if (nact == 2) lr_chain<2, ES>(ur, xr, rb, re, lr);
      else if (nact == 3) lr_chain<3, ES>(ur, xr, rb, re, lr);
      else if (nact == 4) lr_chain<4, ES>(ur, xr, rb, re, lr);
      rb = re;
    }
  }
  if (c < cv) {
    const size_t npad = (size_t)a.tiles_n * BN;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = rg + 4 * i;
      if (m < a.M) a.lr[m * npad + n0 + c] = lr[i];
    }
  }
}

// The large tile's LR term added to its outputs, which this thread has
// already written to `out` (so that they are not live here): U and xv
// copied LR_RANKS_L ranks at a time as they lie in memory, then transposed
// to f32 ([rank][column], [rank][row]); the next chunk's copies overlap the
// FMAs.  Thread (g, t) runs the 64 chains of its fragment's outputs.
template <int ES>
__device__ __forceinline__ void lr_large(const Args& a, int m0, int n0, int mv, int nv,
                                         int warp_m0, int warp_n0, int g, int t,
                                         unsigned char* smem, int tid) {
  using T = Tile<false>;
  constexpr int RCH = LR_RANKS_L, SU = seg_bytes(RCH, 4), SX = seg_bytes(RCH, 4);
  unsigned char* ru = smem;                                        // [BN][SU]
  unsigned char* rx = ru + BN * SU;                                // [BM][SX]
  float* ut = reinterpret_cast<float*>(rx + T::BM * SX);           // [RCH][BN]
  float* xt = ut + RCH * BN;                                       // [RCH][BM]
  float lr[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) lr[mi][j][e] = 0.f;
  auto copy = [&](int r0) {
    const int rn = min(RCH, a.R - r0);
    copy_segments<T::THREADS, ES>(ru, SU, a.u, a.R, n0, nv, r0, rn, tid);
    copy_segments<T::THREADS, 4>(rx, SX, a.xv, a.R, m0, mv, r0, rn, tid);
    cp_async_commit();
  };
  __syncthreads();  // every warp is done with the ring
  copy(0);
  // this thread's column and row of the transposes (BN = BM = 128, 256 threads)
  const int tc = tid % BN, tr0 = tid / BN;
  for (int r0 = 0; r0 < a.R; r0 += RCH) {
    const int rn = min(RCH, a.R - r0);
    cp_async_wait<0>();
    __syncthreads();  // the chunk has landed; the previous one's FMAs are done
    {
      const unsigned char* uc =
          ru + tc * SU + (tc < nv ? seg_offset<ES>(a.u, a.R, n0 + tc, r0) : 0);
      const unsigned char* xc =
          rx + tc * SX + (tc < mv ? seg_offset<4>(a.xv, a.R, m0 + tc, r0) : 0);
      for (int r = tr0; r < rn; r += T::THREADS / BN) {
        ut[r * BN + tc] = tc >= nv ? 0.f
            : ES == 2 ? bf16_bits_to_float(reinterpret_cast<const unsigned short*>(uc)[r])
                      : reinterpret_cast<const float*>(uc)[r];
        xt[r * T::BM + tc] = tc < mv ? reinterpret_cast<const float*>(xc)[r] : 0.f;
      }
    }
    __syncthreads();  // the copies are free again
    if (r0 + RCH < a.R) copy(r0 + RCH);
    for (int rr = 0; rr < rn; ++rr) {
      const float4 ua = *reinterpret_cast<const float4*>(ut + rr * BN + warp_n0 + 8 * t);
      const float4 ub = *reinterpret_cast<const float4*>(ut + rr * BN + warp_n0 + 8 * t + 4);
      const float uu[2][4] = {{ua.x, ua.y, ua.z, ua.w}, {ub.x, ub.y, ub.z, ub.w}};
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const float x0 = xt[rr * T::BM + warp_m0 + 16 * mi + g];
        const float x1 = xt[rr * T::BM + warp_m0 + 16 * mi + g + 8];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          lr[mi][j][0] = fmaf(x0, uu[0][j], lr[mi][j][0]);
          lr[mi][j][1] = fmaf(x0, uu[1][j], lr[mi][j][1]);
          lr[mi][j][2] = fmaf(x1, uu[0][j], lr[mi][j][2]);
          lr[mi][j][3] = fmaf(x1, uu[1][j], lr[mi][j][3]);
        }
      }
    }
  }
  // out = __fadd_rn(o, lr), o read back from this thread's own stores
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = warp_m0 + 16 * mi + g + 8 * h;
      if (row >= mv) continue;
      float* orow = a.out + (size_t)(m0 + row) * a.N + n0;
#pragma unroll
      for (int e1 = 0; e1 < 2; ++e1) {
        const int c = warp_n0 + 8 * t + 4 * e1;
        if (a.vec_out && c + 4 <= nv) {
          float4 v = *reinterpret_cast<const float4*>(orow + c);
          v.x = __fadd_rn(v.x, lr[mi][0][2 * h + e1]);
          v.y = __fadd_rn(v.y, lr[mi][1][2 * h + e1]);
          v.z = __fadd_rn(v.z, lr[mi][2][2 * h + e1]);
          v.w = __fadd_rn(v.w, lr[mi][3][2 * h + e1]);
          *reinterpret_cast<float4*>(orow + c) = v;
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (c + j < nv) orow[c + j] = __fadd_rn(orow[c + j], lr[mi][j][2 * h + e1]);
        }
      }
    }
}

template <bool DECODE, bool GROUPED>
__global__ void __launch_bounds__(Tile<DECODE>::THREADS, DECODE ? 4 : (GROUPED ? 1 : 2))
w4a4_lowrank_matmul_kernel(const Args a) {
  using T = Tile<DECODE>;
  constexpr int WM = T::WM, BK = T::BK;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int last[LR_BLOCKS];
  const int tid = threadIdx.x;

  int tile_n, tile_m = 0, z = 0;
  if constexpr (DECODE) {
    int b = blockIdx.x;
    if (b < a.lr_blocks) {  // an LR block
      tile_n = b / LR_BLOCKS;
      const int n0 = tile_n * BN + (b % LR_BLOCKS) * LR_COLS;
      if (a.u_bf16) lr_decode<2>(a, n0, smem, tid);
      else lr_decode<4>(a, n0, smem, tid);
      take_tickets(a.tickets, b, 1, a.ticket_total, last);
      if (last[0]) finish_decode(a, tile_n, 1 << (b % LR_BLOCKS), tid);
      return;
    }
    b -= a.lr_blocks;
    tile_n = b / a.ks;
    z = b % a.ks;
  } else {
    tile_n = blockIdx.x;
    tile_m = blockIdx.y;
  }

  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int warp_m0 = (warp / T::WARPS_N) * 16 * WM, warp_n0 = (warp % T::WARPS_N) * 32;
  const int m0 = tile_m * T::BM, n0 = tile_n * BN;
  const int mv = min(T::BM, a.M - m0), nv = min(BN, a.N - n0);
  const int sb = z * a.sps, se = min(a.nst, sb + a.sps), ns = se - sb;
  const int kb = sb * BK, ke = min(a.K, se * BK);
  auto wst = [&](int s) { return smem + s * (T::W_BYTES + T::X_BYTES); };

  int acc[WM][4][4];
  float gsum[WM][4][4];
#pragma unroll
  for (int mi = 0; mi < WM; ++mi)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[mi][j][e] = 0;
        gsum[mi][j][e] = 0.f;
      }
  // acc[mi][j][e] is output (row(mi, e >> 1), col(e & 1, j))
  auto row_of = [&](int mi, int h) { return warp_m0 + 16 * mi + g + 8 * h; };
  auto col_of = [&](int h, int j) { return warp_n0 + 8 * t + 4 * h + j; };

  int gcur = GROUPED ? kb / a.group : 0, gend = (gcur + 1) * a.group;
  // the current group ends: its exact partial into the f32 sum (one split)
  // or into the plane (decode, K split)
  auto flush = [&]() {
#pragma unroll
    for (int mi = 0; mi < WM; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row_of(mi, h);
        if (DECODE && a.ks > 1) {  // integer sums into the plane, any order
          if (row < mv) {
            int* dst = a.plane + ((size_t)(tile_n * a.G + gcur) * a.M + row) * BN;
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
              for (int e1 = 0; e1 < 2; ++e1)
                if (acc[mi][j][2 * h + e1]) atomicAdd(dst + col_of(e1, j), acc[mi][j][2 * h + e1]);
          }
        } else {
          const float s = row < mv ? __ldg(a.sx + (size_t)(m0 + row) * a.G + gcur) : 0.f;
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e1 = 0; e1 < 2; ++e1)
              gsum[mi][j][2 * h + e1] = __fadd_rn(gsum[mi][j][2 * h + e1],
                                                  __fmul_rn((float)acc[mi][j][2 * h + e1], s));
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e1 = 0; e1 < 2; ++e1) acc[mi][j][2 * h + e1] = 0;
      }
    ++gcur;
    gend += a.group;
  };

  // the ring: STAGES - 1 stages in flight ahead of the one multiplied
#pragma unroll
  for (int s = 0; s < T::STAGES - 1; ++s) {
    if (s < ns) load_stage<DECODE>(wst(s), wst(s) + T::W_BYTES, a, sb + s, m0, n0, tid);
    cp_async_commit();
  }
  for (int it = 0; it < ns; ++it) {
    cp_async_wait<T::STAGES - 2>();
    __syncthreads();  // stage `it` has landed; stage it - 1's slot is free
    const int nx = it + T::STAGES - 1;
    if (nx < ns) {
      unsigned char* slot = wst(nx % T::STAGES);
      load_stage<DECODE>(slot, slot + T::W_BYTES, a, sb + nx, m0, n0, tid);
    }
    cp_async_commit();
    const unsigned char* ws = wst(it % T::STAGES);
    const unsigned char* xs = ws + T::W_BYTES;
    const int k0 = (sb + it) * BK;
#pragma unroll
    for (int s = 0; s < BK / 32; ++s) {
      const int kk = k0 + 32 * s;
      if (kk >= ke) break;
      uint32_t af[WM][4];
#pragma unroll
      for (int mi = 0; mi < WM; ++mi) {
        const int r = warp_m0 + 16 * mi + g, unit = 2 * s + (t >> 1), off = 8 * (t & 1);
        const uint2 lo = *reinterpret_cast<const uint2*>(xs + x_off<BK>(r, unit) + off);
        const uint2 hi = *reinterpret_cast<const uint2*>(xs + x_off<BK>(r + 8, unit) + off);
        af[mi][0] = lo.x;
        af[mi][1] = hi.x;
        af[mi][2] = lo.y;
        af[mi][3] = hi.y;
      }
      uint32_t wr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wr[i] = *reinterpret_cast<const uint32_t*>(
            ws + w_off(16 * s + 4 * t + i, (warp_n0 >> 4) + (g >> 2)) + 4 * (g & 3));
      uint32_t bf[4][2];
      b_fragments(wr, bf);
      if constexpr (!GROUPED) {
#pragma unroll
        for (int mi = 0; mi < WM; ++mi)
#pragma unroll
          for (int j = 0; j < 4; ++j) mma_s8(acc[mi][j], af[mi], bf[j][0], bf[j][1]);
      } else {
        // the k-step's pieces, one per group it meets, in ascending k
        const int kstop = min(kk + 32, ke);
        for (int kp = kk; kp < kstop;) {
          const int e = min(gend, kk + 32);
          uint32_t lo_m = 0xFFFFFFFFu, hi_m = 0xFFFFFFFFu;
          if (kp != kk || e != kk + 32) {  // bytes of thread t's codes 8t..8t+7 in [kp, e)
            const int base = kk + 8 * t;
            lo_m = byte_mask(kp - base, e - base);
            hi_m = byte_mask(kp - base - 4, e - base - 4);
          }
#pragma unroll
          for (int mi = 0; mi < WM; ++mi) {
            const uint32_t am[4] = {af[mi][0] & lo_m, af[mi][1] & lo_m, af[mi][2] & hi_m,
                                    af[mi][3] & hi_m};
#pragma unroll
            for (int j = 0; j < 4; ++j) mma_s8(acc[mi][j], am, bf[j][0], bf[j][1]);
          }
          if (e == gend) flush();
          kp = e;
        }
      }
    }
  }
  cp_async_wait<0>();

  // the epilogue into o (this thread's fragment of the tile)
  auto epilogue = [&](float (&o)[WM][4][4]) {
    float swv[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        swv[h][j] = col_of(h, j) < nv ? __ldg(a.sw + n0 + col_of(h, j)) : 0.f;
#pragma unroll
    for (int mi = 0; mi < WM; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row_of(mi, h);
        const float sxv = (!GROUPED && row < mv) ? __ldg(a.sx + m0 + row) : 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e1 = 0; e1 < 2; ++e1) {
            const int e = 2 * h + e1;
            o[mi][j][e] = GROUPED ? __fmul_rn(gsum[mi][j][e], swv[e1][j])
                                  : __fmul_rn(__fmul_rn((float)acc[mi][j][e], sxv), swv[e1][j]);
          }
      }
  };
  auto store = [&](const float (&o)[WM][4][4]) {
#pragma unroll
    for (int mi = 0; mi < WM; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row_of(mi, h);
        if (row >= mv) continue;
        float* orow = a.out + (size_t)(m0 + row) * a.N + n0;
#pragma unroll
        for (int e1 = 0; e1 < 2; ++e1) {
          const int c = col_of(e1, 0);
          if (a.vec_out && c + 4 <= nv) {
            *reinterpret_cast<float4*>(orow + c) = make_float4(
                o[mi][0][2 * h + e1], o[mi][1][2 * h + e1], o[mi][2][2 * h + e1],
                o[mi][3][2 * h + e1]);
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (c + j < nv) orow[c + j] = o[mi][j][2 * h + e1];
          }
        }
      }
  };

  if constexpr (DECODE) {
    if (a.ks > 1) {
      if constexpr (GROUPED) {
        if (gcur < a.G) flush();  // a group that runs on into the next split
      } else {  // this split's exact int32 partial tile
        int* part = a.part + (size_t)(tile_n * a.ks + z) * a.M * BN;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = row_of(0, h);
          if (row >= mv) continue;
#pragma unroll
          for (int e1 = 0; e1 < 2; ++e1)
            *reinterpret_cast<int4*>(part + (size_t)row * BN + col_of(e1, 0)) =
                make_int4(acc[0][0][2 * h + e1], acc[0][1][2 * h + e1],
                          acc[0][2][2 * h + e1], acc[0][3][2 * h + e1]);
        }
      }
    } else {
      float o[WM][4][4];
      epilogue(o);
      store(o);
    }
    if (a.ks > 1 || a.R > 0) {
      take_tickets(a.tickets, tile_n * LR_BLOCKS, LR_BLOCKS, a.ticket_total, last);
      int subs = 0;
      for (int q = 0; q < LR_BLOCKS; ++q) subs |= last[q] << q;
      if (subs) finish_decode(a, tile_n, subs, tid);
    }
  } else {
    {
      float o[WM][4][4];
      epilogue(o);
      store(o);
    }
    if (a.R > 0) {
      if (a.u_bf16) lr_large<2>(a, m0, n0, mv, nv, warp_m0, warp_n0, g, t, smem, tid);
      else lr_large<4>(a, m0, n0, mv, nv, warp_m0, warp_n0, g, t, smem, tid);
    }
  }
}

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

// The launch plan of (M, K, N, group) on `sms` SMs, from shapes alone.
struct Plan {
  int decode, bm, tiles_n, tiles_m, nst, sps, ks, threads, smem;
  size_t zeroed, scratch;  // bytes of the two scratch buffers
};

Plan plan_of(int M, int K, int N, int group, int sms) {
  Plan p;
  p.decode = M <= DECODE_M;
  p.bm = p.decode ? Tile<true>::BM : Tile<false>::BM;
  p.tiles_n = (N + BN - 1) / BN;
  p.tiles_m = (M + p.bm - 1) / p.bm;
  const int bk = p.decode ? Tile<true>::BK : Tile<false>::BK;
  p.nst = (K + bk - 1) / bk;
  p.sps = p.nst;
  if (p.decode) {  // about WAVES GEMM blocks an SM, each split whole stages
    const int want = (WAVES * sms + p.tiles_n - 1) / p.tiles_n;
    p.sps = (p.nst + want - 1) / want;
  }
  if (p.sps < 1) p.sps = 1;
  p.ks = (p.nst + p.sps - 1) / p.sps;
  p.threads = p.decode ? Tile<true>::THREADS : Tile<false>::THREADS;
  p.smem = p.decode ? Tile<true>::SMEM : Tile<false>::SMEM;
  p.zeroed = p.scratch = 0;
  if (p.decode) {
    // zeroed: a ticket per 32-column sub-tile, then group-wise where K is
    // split the group plane [tiles][K/g][M][BN]; scratch: the per-token
    // partials [tiles][ks][M][BN] where K is split, then the LR terms
    // [M][tiles · BN]
    const size_t tiles = p.tiles_n, tick = tiles * LR_BLOCKS;
    const size_t plane = group > 0 && p.ks > 1 ? tiles * (K / group) * M * BN : 0;
    const size_t part = group == 0 && p.ks > 1 ? tiles * p.ks * M * BN : 0;
    p.zeroed = 4 * (tick + plane);
    p.scratch = 4 * (part + (size_t)M * tiles * BN);
  }
  return p;
}

template <bool DECODE, bool GROUPED>
int launch(const Args& a, const Plan& p, cudaStream_t stream) {
  auto kern = w4a4_lowrank_matmul_kernel<DECODE, GROUPED>;
  static bool configured = false;  // per instantiation
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Tile<DECODE>::SMEM);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const dim3 grid = DECODE ? dim3(a.lr_blocks + p.tiles_n * p.ks) : dim3(p.tiles_n, p.tiles_m);
  kern<<<grid, Tile<DECODE>::THREADS, Tile<DECODE>::SMEM, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The plan of a launch at (M, K, N, group) on a card of `sms` SMs (0: the
// current device's), as out[0..10] = decode, bm, tiles_n, tiles_m, stages,
// stages per split, K-splits, threads, dynamic shared bytes, zeroed
// scratch bytes, scratch bytes; out[11] = LR blocks per tile at decode.
void w4a4_lowrank_matmul_plan(int M, int K, int N, int group, int sms, long long* out) {
  const Plan p = plan_of(M, K, N, group, sms > 0 ? sms : device_sms());
  const long long v[12] = {p.decode, p.bm, p.tiles_n, p.tiles_m, p.nst, p.sps, p.ks,
                           p.threads, p.smem, (long long)p.zeroed, (long long)p.scratch,
                           LR_BLOCKS};
  for (int i = 0; i < 12; ++i) out[i] = v[i];
}

// Launch on `stream`; returns the first CUDA error of the launch (0 = ok).
// With R = 0, xv and u may be null; u_bf16 selects bf16 (1) or f32 (0) U;
// group 0 takes per-token sx (M, 1), group g > 0 (dividing K) the (M, K/g)
// plane.  `zeroed` holds the plan's zeroed bytes, all zero (every launch
// leaves them so), `scratch` its scratch bytes; either may be null where
// the plan asks for none.
int w4a4_lowrank_matmul(const void* xq, const void* sx, const void* w, const void* sw,
                        const void* xv, const void* u, int u_bf16, void* out, void* zeroed,
                        void* scratch, int M, int K, int N, int R, int group, void* stream) {
  if (group < 0 || (group > 0 && K % group)) return (int)cudaErrorInvalidValue;
  const Plan p = plan_of(M, K, N, group, device_sms());
  if (p.decode && ((p.zeroed && !zeroed) || (p.scratch && !scratch)))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.xq = static_cast<const int8_t*>(xq);
  a.sx = static_cast<const float*>(sx);
  a.w = static_cast<const uint8_t*>(w);
  a.sw = static_cast<const float*>(sw);
  a.xv = static_cast<const float*>(xv);
  a.u = u;
  a.out = static_cast<float*>(out);
  a.tickets = static_cast<int*>(zeroed);
  a.plane = a.tickets ? a.tickets + (size_t)p.tiles_n * LR_BLOCKS : nullptr;
  a.part = static_cast<int*>(scratch);
  const size_t part = group == 0 && p.ks > 1 ? (size_t)p.tiles_n * p.ks * M * BN : 0;
  a.lr = a.part ? reinterpret_cast<float*>(a.part + part) : nullptr;
  a.M = M, a.K = K, a.N = N, a.R = R, a.group = group, a.G = group > 0 ? K / group : 1;
  a.u_bf16 = u_bf16;
  a.tiles_n = p.tiles_n, a.nst = p.nst, a.sps = p.sps, a.ks = p.ks;
  a.lr_blocks = p.decode && R > 0 ? p.tiles_n * LR_BLOCKS : 0;
  a.ticket_total = p.ks + (R > 0 ? 1 : 0);  // the splits, and the sub-tile's LR block
  // 16-byte copies need rows of whole 16-byte units
  a.vec_w = N % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  a.vec_x = K % 16 == 0 && reinterpret_cast<uintptr_t>(xq) % 16 == 0;
  a.vec_out = N % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.decode)
    return group > 0 ? launch<true, true>(a, p, s) : launch<true, false>(a, p, s);
  return group > 0 ? launch<false, true>(a, p, s) : launch<false, false>(a, p, s);
}

}  // extern "C"
