// Fused activation prologue for Hopper (sm_90a): one launch computes
//
//     xq (M, K) int8, sx (M, 1) f32  =  Q_a(x)        (per-token)
//     xv (M, R) f32                  =  x · V
//
// from x (M, K) f32 or bf16 and V (K, R) bf16 or f32.  Replaces the TPU
// kernel repro/kernels/prologue.py::fused_prologue_kernel for per-token
// scales and rotate=False; its output feeds w4a4_lowrank_matmul.cu (the
// chained path).
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
//   * quantizer block: one per row of the tile, the act_quant body.
// Every row's result is computed by the same operations whatever M is and
// whichever rows share its tile, so a request's outputs do not depend on
// its co-tenants.  No tensor cores, TMA or cp.async yet.

#include <cuda_runtime.h>
#include <stddef.h>

#include "quant_rows.cuh"

namespace {

using quant_rows::to_f32;

constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int RT = 32;          // R columns per projection block
constexpr int MAX_ROWS = 16;    // rows per M-tile at most
constexpr int MAX_BK = 512;     // the reference's largest projection chunk

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

template <int ROWS, typename TX, typename TF>
__global__ void __launch_bounds__(THREADS)
fused_prologue_kernel(const TX* __restrict__ x, const TF* __restrict__ v,
                      int8_t* __restrict__ xq, float* __restrict__ sx,
                      float* __restrict__ xv, float* __restrict__ part,
                      int* __restrict__ tickets, int M, int K, int R,
                      int qmax, float clip_ratio) {
  extern __shared__ __align__(16) float buf[];
  __shared__ int last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bk = chunk_k(K), nk = tiles(K, bk), nr = tiles(R, RT);
  const int mt = blockIdx.y, m0 = mt * ROWS;
  const int mv = min(ROWS, M - m0);  // valid rows of this tile

  if ((int)blockIdx.x >= nk * nr) {  // quantizer block: one row
    const int m = (int)blockIdx.x - nk * nr;
    if (m >= mv) return;
    const size_t row = (size_t)(m0 + m);
    quant_rows::quantize_row<THREADS>(x + row * K, K, xq + row * K, sx + row,
                                      qmax, clip_ratio, buf);
    return;
  }

  const int kc = (int)blockIdx.x % nk, rt = (int)blockIdx.x / nk;
  const int k0 = kc * bk, kv = min(bk, K - k0);  // valid K of this chunk
  const int r0 = rt * RT;

  // 1. the rows' chunk of x in f32 (zero past M and past K)
  float* xs = buf;  // [ROWS][bk]
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

  // 2. this warp's eighth of the chunk, column r0 + lane, every row
  const int sub = bk / NWARPS;
  const int kb = warp * sub, ke = min(kb + sub, kv);
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
  __syncthreads();  // xs becomes the warp-partial buffer [NWARPS][ROWS][RT]
  float* wp = buf;
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
  if (!last) return;
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

template <int ROWS, typename TX, typename TF>
int launch(const void* x, const void* v, void* xq, void* sx, void* xv,
           void* scratch, int M, int K, int R, int qmax, float clip_ratio,
           cudaStream_t stream) {
  const int bk = chunk_k(K);
  const int nk = R > 0 ? tiles(K, bk) : 0, nr = R > 0 ? tiles(R, RT) : 0;
  const int mtiles = tiles(M, ROWS);
  float* part = static_cast<float*>(scratch);
  int* tickets = reinterpret_cast<int*>(part + partial_floats(ROWS, M, K, R));
  if (R > 0) {
    cudaError_t e = cudaMemsetAsync(tickets, 0, sizeof(int) * mtiles * nr, stream);
    if (e != cudaSuccess) return (int)e;
  }
  const size_t smem = sizeof(float) * (size_t)(ROWS * bk > NWARPS * ROWS * RT
                                                   ? ROWS * bk : NWARPS * ROWS * RT);
  dim3 grid(nk * nr + ROWS, mtiles);
  fused_prologue_kernel<ROWS, TX, TF><<<grid, THREADS, smem, stream>>>(
      static_cast<const TX*>(x), static_cast<const TF*>(v),
      static_cast<int8_t*>(xq), static_cast<float*>(sx),
      static_cast<float*>(xv), part, tickets, M, K, R, qmax, clip_ratio);
  return (int)cudaGetLastError();
}

template <typename TX, typename TF>
int launch_rows(const void* x, const void* v, void* xq, void* sx, void* xv,
                void* scratch, int M, int K, int R, int qmax, float clip_ratio,
                cudaStream_t stream) {
  // decode batches of up to 4 rows take the 4-row tile, larger M the 16-row one
  if (M <= 4)
    return launch<4, TX, TF>(x, v, xq, sx, xv, scratch, M, K, R, qmax, clip_ratio, stream);
  return launch<MAX_ROWS, TX, TF>(x, v, xq, sx, xv, scratch, M, K, R, qmax, clip_ratio, stream);
}

}  // namespace

extern "C" {

// Bytes of device scratch one launch at (M, K, R) needs (0 when R = 0).
size_t fused_prologue_scratch_bytes(int M, int K, int R) {
  if (R <= 0) return 0;
  const int rows = M <= 4 ? 4 : MAX_ROWS;
  return sizeof(float) * partial_floats(rows, M, K, R)
       + sizeof(int) * (size_t)tiles(M, rows) * tiles(R, RT);
}

// Launch on `stream`; returns the first CUDA error of the launch (0 = ok).
// x_bf16 / f_bf16 select bf16 (1) or f32 (0) for x and for V; with R = 0,
// v, xv and scratch may be null and only xq and sx are written.
int fused_prologue(const void* x, int x_bf16, const void* v, int f_bf16,
                   void* xq, void* sx, void* xv, void* scratch, int M, int K,
                   int R, int qmax, float clip_ratio, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16 && f_bf16)
    return launch_rows<__nv_bfloat16, __nv_bfloat16>(x, v, xq, sx, xv, scratch, M, K, R, qmax, clip_ratio, s);
  if (x_bf16)
    return launch_rows<__nv_bfloat16, float>(x, v, xq, sx, xv, scratch, M, K, R, qmax, clip_ratio, s);
  if (f_bf16)
    return launch_rows<float, __nv_bfloat16>(x, v, xq, sx, xv, scratch, M, K, R, qmax, clip_ratio, s);
  return launch_rows<float, float>(x, v, xq, sx, xv, scratch, M, K, R, qmax, clip_ratio, s);
}

}  // extern "C"
