// Fused activation prologue for Hopper (sm_90a): one launch computes
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
// follows the order of rowops.project_rows_tiled as far as a parallel
// design allows: K is cut into chunks of bk = min(512, the largest power of
// two <= max(K, 8)) values, exactly the reference's default projection
// tile, each chunk's dot is a partial, and the partials are added in
// ascending-K order.  Only the order inside a chunk's dot differs (eight
// warps each run an FMA chain over bk/8 values, then the eight sums are
// added in warp order), and a tolerance covers it.
//
// Bound on an H100 SXM: memory.  The bytes are x (M·K·2 or 4), V (K·R·2),
// and xq, sx, xv out; at decode V dominates (K=8192, R=307: 5 MB, 1.5 us
// at 3.35 TB/s).  The x·V flops are far below the f32 rate.
//
// Design.  A grid over rows alone would be one block at decode (M = 4) for
// 132 SMs, so the grid is (K-chunk x R-tile + quantizer blocks, M-tile):
//   * projection block (kc, rt): stages its rows' chunk of x in shared
//     memory as f32 and computes the chunk's partial x·V for RT = 32
//     columns; thread (warp w, lane c) owns column c over an eighth of the
//     chunk, so a warp reads 32 neighbouring V values of one row per step
//     (V rows are R values long and need no alignment: every load is one
//     element).  The partial goes to a scratch buffer; the last block of
//     each (M-tile, R-tile) to finish (an atomic ticket, the classic
//     threadfence reduction) adds the nk partials in ascending order and
//     writes xv.  The sums are floats but their order is fixed, so the
//     result is deterministic: no float atomics.
//   * quantizer block: one per row of the tile, the act_quant body (grouped:
//     quant_rows.cuh's group body, one warp per group in turn).
// Every row's result is computed by the same operations whatever M is and
// whichever rows share its tile, so a request's outputs do not depend on
// its co-tenants.  No tensor cores, TMA or cp.async yet.
//
// The rotation.  It mixes all of K, so a projection block cannot rotate
// its own chunk alone, and a 16-row tile of a K = 8192 row in f32 (512 KB)
// does not fit a block's shared memory.  So with `rotate` every block
// stages ONE row at a time whole (4·K bytes, 32 KB at K = 8192), rotates it
// with fwht_rows.cuh (the body of fwht.cu and of the fused kernel: bitwise
// rowops.fwht_rows) and keeps what it needs of it: a quantizer block the
// codes and scale of its row (quant_rows.cuh on the rotated row), a
// projection block its bk-chunk of every row of the tile.  The rotation is
// recomputed by every projection block of an M-tile, so those blocks take
// G R-tiles each instead of one: G is chosen from the shapes so that a
// launch has about two blocks per SM where the M-tiles allow it (G = 1..nr),
// which bounds the recomputation at nk·ceil(nr / G) rotations of each row
// (16 at M = 2048, K = 8192, R = 922: ~3.5e9 f32 adds).  The partial of a
// (chunk, R-tile) is computed by the same operations whatever G is, so xv
// does not depend on M here either.

#include <cuda_runtime.h>
#include <stddef.h>

#include "fwht_rows.cuh"
#include "quant_rows.cuh"

namespace {

using quant_rows::to_f32;

constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int RT = 32;          // R columns per projection block
constexpr int MAX_ROWS = 16;    // rows per M-tile at most
constexpr int MAX_BK = 512;     // the reference's largest projection chunk
constexpr int TARGET_BLOCKS = 2 * 132;  // two blocks per SM of an H100 SXM
constexpr int MAX_ROTATE_K = 32768;     // rotated: 4·K + 48 KB of shared memory

__host__ __device__ inline int chunk_k(int K) {
  int p = 8;
  while (p * 2 <= K && p * 2 <= MAX_BK) p *= 2;
  return p;
}

__host__ __device__ inline int tiles(int a, int b) { return (a + b - 1) / b; }

// scratch: [mtiles][nr][nk][ROWS][RT] f32 partials, then [mtiles][nr] ticket ints
__host__ inline size_t partial_floats(int rows, int M, int K, int R) {
  return (size_t)tiles(M, rows) * tiles(R, RT) * tiles(K, chunk_k(K)) * rows * RT;
}

// R-tiles per projection block: 1 unrotated; rotated, the fewest blocks
// that still give about TARGET_BLOCKS in all
__host__ inline int rtiles_per_block(int rows, int M, int K, int R, int rotate) {
  const int nr = tiles(R, RT);
  if (!rotate || nr == 0) return 1;
  const int per_tile = tiles(K, chunk_k(K)) * tiles(M, rows);
  const int groups = min(nr, max(1, tiles(TARGET_BLOCKS, per_tile)));
  return tiles(nr, groups);
}

// dynamic shared memory of one block, in floats: unrotated the chunk of the
// rows [ROWS][bk] (reused for the warp partials); rotated a whole row [K],
// then the chunks and the warp partials [NWARPS][ROWS][RT] apart
__host__ inline size_t smem_floats(int rows, int K, int rotate) {
  const size_t xs = (size_t)rows * chunk_k(K), wp = (size_t)NWARPS * rows * RT;
  if (rotate) return (size_t)K + xs + wp;
  return xs > wp ? xs : wp;
}

// stages row `row` of x (K values) into buf as f32; all loads before stores
template <typename TX>
__device__ __forceinline__ void stage_row(const TX* __restrict__ row, int K,
                                          float* buf) {
  const int tid = threadIdx.x;
  for (int i0 = 0; i0 < K; i0 += 16 * THREADS) {
    float t[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int i = i0 + j * THREADS + tid;
      t[j] = i < K ? to_f32(row[i]) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int i = i0 + j * THREADS + tid;
      if (i < K) buf[i] = t[j];
    }
  }
}

template <int ROWS, typename TX, typename TF>
__global__ void __launch_bounds__(THREADS)
fused_prologue_kernel(const TX* __restrict__ x, const TF* __restrict__ v,
                      int8_t* __restrict__ xq, float* __restrict__ sx,
                      float* __restrict__ xv, float* __restrict__ part,
                      int* __restrict__ tickets, int M, int K, int R, int group,
                      int qmax, float clip_ratio, int rotate, int G, float nrm) {
  extern __shared__ __align__(16) float buf[];
  __shared__ int last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bk = chunk_k(K), nk = tiles(K, bk), nr = tiles(R, RT);
  const int nproj = nk * tiles(nr, G);  // projection blocks per M-tile
  const int mt = blockIdx.y, m0 = mt * ROWS;
  const int mv = min(ROWS, M - m0);  // valid rows of this tile

  if ((int)blockIdx.x >= nproj) {  // quantizer block: one row
    const int m = (int)blockIdx.x - nproj;
    if (m >= mv) return;
    const size_t row = (size_t)(m0 + m);
    float* srow = sx + row * (group > 0 ? K / group : 1);
    if (!rotate) {
      if (group > 0)
        quant_rows::quantize_row_grouped<THREADS>(x + row * K, K, group, xq + row * K,
                                                  srow, qmax, clip_ratio);
      else
        quant_rows::quantize_row<THREADS>(x + row * K, K, xq + row * K, srow,
                                          qmax, clip_ratio, buf);
      return;
    }
    stage_row(x + row * K, K, buf);  // buf: [K] the row, then the reduction
    __syncthreads();
    fwht_rows::rotate<THREADS>(buf, K, K, nrm);  // ends with a barrier
    if (group > 0)
      quant_rows::quantize_row_grouped<THREADS>(buf, K, group, xq + row * K, srow,
                                                qmax, clip_ratio);
    else
      quant_rows::quantize_row<THREADS>(buf, K, xq + row * K, srow, qmax,
                                        clip_ratio, buf + K);
    return;
  }

  const int kc = (int)blockIdx.x % nk, rg = (int)blockIdx.x / nk;
  const int k0 = kc * bk, kv = min(bk, K - k0);  // valid K of this chunk

  // 1. the rows' chunk of x (rotated: of x·H) in f32, zero past M and past K
  float* rowbuf = buf;                     // [K], rotated only
  float* xs = rotate ? buf + K : buf;      // [ROWS][bk]
  float* wp = rotate ? xs + ROWS * bk : buf;  // [NWARPS][ROWS][RT] partials
  if (rotate) {
    for (int m = 0; m < ROWS; ++m) {
      if (m < mv) {
        stage_row(x + (size_t)(m0 + m) * K, K, rowbuf);
        __syncthreads();
        fwht_rows::rotate<THREADS>(rowbuf, K, K, nrm);
        for (int k = tid; k < bk; k += THREADS)
          xs[m * bk + k] = k < kv ? rowbuf[k0 + k] : 0.f;
        __syncthreads();  // rowbuf takes the next row
      } else {
        for (int k = tid; k < bk; k += THREADS) xs[m * bk + k] = 0.f;
      }
    }
  } else {
    for (int i0 = 0; i0 < ROWS * bk; i0 += 16 * THREADS) {
      float t[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int i = i0 + j * THREADS + tid, m = i / bk, k = i % bk;
        t[j] = (i < ROWS * bk && m < mv && k < kv)
                   ? to_f32(x[(size_t)(m0 + m) * K + k0 + k]) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int i = i0 + j * THREADS + tid;
        if (i < ROWS * bk) xs[i] = t[j];
      }
    }
    __syncthreads();
  }

  // the block's R-tiles: one unrotated, up to G rotated
  const int sub = bk / NWARPS;
  const int kb = warp * sub, ke = min(kb + sub, kv);
  for (int rt = rg * G; rt < min(nr, (rg + 1) * G); ++rt) {
    const int r0 = rt * RT;

    // 2. this warp's eighth of the chunk, column r0 + lane, every row
    const int r = r0 + lane;
    float acc[ROWS];
#pragma unroll
    for (int m = 0; m < ROWS; ++m) acc[m] = 0.f;
    if (r < R) {
      const TF* vp = v + (size_t)k0 * R + r;
#pragma unroll 16
      for (int k = kb; k < ke; ++k) {
        const float vk = to_f32(vp[(size_t)k * R]);
#pragma unroll
        for (int m = 0; m < ROWS; ++m) acc[m] = fmaf(xs[m * bk + k], vk, acc[m]);
      }
    }
    __syncthreads();  // unrotated, xs becomes the warp-partial buffer
#pragma unroll
    for (int m = 0; m < ROWS; ++m) wp[(warp * ROWS + m) * RT + lane] = acc[m];
    __syncthreads();

    // 3. the chunk's partial (warps added in order) to scratch
    float* mine = part + (((size_t)mt * nr + rt) * nk) * ROWS * RT;
    for (int i = tid; i < ROWS * RT; i += THREADS) {
      float s = wp[i];
#pragma unroll
      for (int w = 1; w < NWARPS; ++w) s = __fadd_rn(s, wp[w * ROWS * RT + i]);
      mine[(size_t)kc * ROWS * RT + i] = s;
    }
    __threadfence();  // the partial is visible before the ticket is taken
    __syncthreads();
    if (tid == 0) last = (atomicAdd(&tickets[mt * nr + rt], 1) == nk - 1);
    __syncthreads();
    if (!last) continue;
    __threadfence();

    // 4. the last block adds the nk partials in ascending-K order
    for (int i = tid; i < ROWS * RT; i += THREADS) {
      const int m = i / RT, c = i % RT;
      if (m >= mv || r0 + c >= R) continue;
      float s = __ldcg(mine + i);
      for (int c2 = 1; c2 < nk; ++c2)
        s = __fadd_rn(s, __ldcg(mine + (size_t)c2 * ROWS * RT + i));
      xv[(size_t)(m0 + m) * R + r0 + c] = s;
    }
  }
}

template <int ROWS, typename TX, typename TF>
int launch(const void* x, const void* v, void* xq, void* sx, void* xv,
           void* scratch, int M, int K, int R, int group, int qmax, float clip_ratio,
           int rotate, cudaStream_t stream) {
  auto kern = fused_prologue_kernel<ROWS, TX, TF>;
  const int bk = chunk_k(K);
  const int nk = R > 0 ? tiles(K, bk) : 0, nr = R > 0 ? tiles(R, RT) : 0;
  const int mtiles = tiles(M, ROWS);
  const int G = rtiles_per_block(ROWS, M, K, R, rotate);
  float* part = static_cast<float*>(scratch);
  int* tickets = reinterpret_cast<int*>(part + partial_floats(ROWS, M, K, R));
  if (R > 0) {
    cudaError_t e = cudaMemsetAsync(tickets, 0, sizeof(int) * mtiles * nr, stream);
    if (e != cudaSuccess) return (int)e;
  }
  const size_t smem = sizeof(float) * smem_floats(ROWS, K, rotate);
  static size_t configured = 48 * 1024;  // per instantiation
  if (smem > configured) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    configured = smem;
  }
  dim3 grid(nk * (nr > 0 ? tiles(nr, G) : 0) + ROWS, mtiles);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const TX*>(x), static_cast<const TF*>(v),
      static_cast<int8_t*>(xq), static_cast<float*>(sx),
      static_cast<float*>(xv), part, tickets, M, K, R, group, qmax, clip_ratio,
      rotate, G, fwht_rows::norm(K));
  return (int)cudaGetLastError();
}

template <typename TX, typename TF>
int launch_rows(const void* x, const void* v, void* xq, void* sx, void* xv,
                void* scratch, int M, int K, int R, int group, int qmax,
                float clip_ratio, int rotate, cudaStream_t stream) {
  // decode batches of up to 4 rows take the 4-row tile, larger M the 16-row one
  if (M <= 4)
    return launch<4, TX, TF>(x, v, xq, sx, xv, scratch, M, K, R, group, qmax,
                             clip_ratio, rotate, stream);
  return launch<MAX_ROWS, TX, TF>(x, v, xq, sx, xv, scratch, M, K, R, group, qmax,
                                  clip_ratio, rotate, stream);
}

}  // namespace

extern "C" {

// The widest K the rotated launch takes (a whole row in shared memory).
int fused_prologue_max_rotate_k() { return MAX_ROTATE_K; }

// Bytes of device scratch one launch at (M, K, R) needs (0 when R = 0).
size_t fused_prologue_scratch_bytes(int M, int K, int R) {
  if (R <= 0) return 0;
  const int rows = M <= 4 ? 4 : MAX_ROWS;
  return sizeof(float) * partial_floats(rows, M, K, R)
       + sizeof(int) * (size_t)tiles(M, rows) * tiles(R, RT);
}

// Launch on `stream`; returns the first CUDA error of the launch (0 = ok).
// x_bf16 / f_bf16 select bf16 (1) or f32 (0) for x and for V; with R = 0,
// v, xv and scratch may be null and only xq and sx are written.  group 0
// writes per-token scales sx (M, 1), group g > 0 (dividing K) the (M, K/g)
// plane.  rotate (1) quantizes and projects x·H_K, K a power of two within
// fused_prologue_max_rotate_k() (the wrapper checks).
int fused_prologue(const void* x, int x_bf16, const void* v, int f_bf16,
                   void* xq, void* sx, void* xv, void* scratch, int M, int K,
                   int R, int group, int qmax, float clip_ratio, int rotate,
                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rotate && ((K & (K - 1)) || K > MAX_ROTATE_K)) return (int)cudaErrorInvalidValue;
  if (group < 0 || (group > 0 && K % group)) return (int)cudaErrorInvalidValue;
  if (x_bf16 && f_bf16)
    return launch_rows<__nv_bfloat16, __nv_bfloat16>(x, v, xq, sx, xv, scratch, M, K, R, group, qmax, clip_ratio, rotate, s);
  if (x_bf16)
    return launch_rows<__nv_bfloat16, float>(x, v, xq, sx, xv, scratch, M, K, R, group, qmax, clip_ratio, rotate, s);
  if (f_bf16)
    return launch_rows<float, __nv_bfloat16>(x, v, xq, sx, xv, scratch, M, K, R, group, qmax, clip_ratio, rotate, s);
  return launch_rows<float, float>(x, v, xq, sx, xv, scratch, M, K, R, group, qmax, clip_ratio, rotate, s);
}

}  // extern "C"
