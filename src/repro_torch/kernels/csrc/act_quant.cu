// Activation quantizer for Hopper (sm_90a):
//
//     xq (M, K) int8, sx (M, 1) f32  =  Q_a(x),  x (M, K) f32 or bf16
//
// or, with `group` g > 0 (g divides K), the (M, K/g) scale plane, one scale
// per g contiguous values of a row.  Replaces the TPU kernel
// repro/kernels/actquant.py::act_quant_kernel, per-token and with its
// `group` branch (the unfused path's quantizer).  The numerics are
// quant_rows.cuh's scale_of and code_of, the formulas of the quantizer that
// fused_prologue.cu shares, so the two kernels' codes and scales are
// bitwise equal.
//
// Bound on an H100 SXM: memory.  x is read once and the codes and scales
// written once, (x_bytes + 1)·M·K + 4·M·(K/g, or 1) bytes at 3.35 TB/s
// (chip_smoke.py::_chain_bounds); its 3·M·K f32 operations (|x|, max,
// divide) are far below the card's rate.
//
// Design.  A group is quantized exactly as a row of g values with a scale
// of its own, and a row's groups lie one after another in x, xq and the
// scale plane, so the group branch is the per-token body over M·K/g rows of
// width g.  A row of `width` values is read in units of 16 bytes (8 bf16 or
// 4 f32) where width is a multiple of that and x and xq are aligned, of one
// value otherwise (the element-wise reader), and each thread holds its units
// in registers as loaded (quant_rows::quantize_held): x is read once, every
// load issued before the first is used.  tpr threads take a row:
//   * rows of up to WARP_MAX_K values: tpr = the row's units, at most 32
//     (16 lanes a g 128 group at bf16, 8 at g 64), 256 / tpr rows a block,
//     the amax a __shfl_xor_sync tree within the row's lanes;
//   * wider rows: a block a row, of the power of two of threads (up to
//     1,024) that gives each HELD_REGS registers of units (4 units of 16
//     bytes, or 16 single values), the warps' maxima through shared memory;
//   * rows that would need more than HELD_REGS registers of units a thread
//     at 1,024 threads (K > 32,768 at bf16, 16,384 at f32) are staged once in
//     shared memory as f32 (quant_rows::quantize_staged), up to MAX_K values.
// The plan depends on (K, g, x's width, alignment) alone, never on M
// (act_quant_plan exports it; actquant.act_quant_plan mirrors it), so a
// row's codes and scale never depend on M or on the other rows.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "quant_rows.cuh"

namespace {

constexpr int WARP_MAX_K = 2048;   // widest row a warp (or fewer lanes) takes
constexpr int WARP_BLOCK = 256;    // threads of a block of such rows
constexpr int MAX_THREADS = 1024;  // threads of a block-wide row at most
constexpr int HELD_REGS = 16;      // registers of units a block-wide row's thread holds
constexpr int MAX_K = 57344;       // a staged row: 224 KB of f32

// A 16-byte unit takes four registers as held, a single value one.
__host__ __device__ constexpr int unit_regs(bool vec) { return vec ? 4 : 1; }
// The units a thread of a block-wide row aims at.
__host__ __device__ constexpr int units_held(bool vec) { return HELD_REGS / unit_regs(vec); }

struct Plan {
  int vec;             // 16-byte units (1) or single values (0)
  int staged;          // the row staged in shared memory
  int width;           // values a row: K, or g
  int units;           // units a row
  int tpr;             // threads a row
  int loads;           // units of a row a thread at most
  int chunks;          // the held body's register units (loads to a power of two)
  int rows_per_block;
  int threads;         // a block
  int smem;            // dynamic shared bytes
  long long rows;      // M, or M·K/g
  long long blocks;
};

int pow2ceil(long long v) {
  int p = 1;
  while (p < v) p <<= 1;
  return p;
}

Plan plan_of(long long M, int K, int group, int x_bytes, int aligned) {
  Plan p{};
  p.width = group > 0 ? group : K;
  p.rows = group > 0 ? M * (K / group) : M;
  const int N = 16 / x_bytes;
  p.vec = aligned && p.width % N == 0;
  p.units = p.width / (p.vec ? N : 1);
  const bool warp = p.width <= WARP_MAX_K;
  const int per = units_held(p.vec);
  p.tpr = warp ? std::min(32, pow2ceil(p.units))
               : std::min(MAX_THREADS, pow2ceil((p.units + per - 1) / per));
  p.loads = (p.units + p.tpr - 1) / p.tpr;
  p.chunks = pow2ceil(p.loads);
  p.staged = !warp && p.chunks > per;
  if (p.staged) p.chunks = 0;
  p.threads = p.staged ? MAX_THREADS : warp ? WARP_BLOCK : p.tpr;
  p.rows_per_block = p.threads / p.tpr;
  p.smem = p.staged ? 4 * p.width : 0;
  p.blocks = (p.rows + p.rows_per_block - 1) / p.rows_per_block;
  return p;
}

template <typename TX, bool VEC, int C>
__global__ void __launch_bounds__(C * unit_regs(VEC) > HELD_REGS ? WARP_BLOCK : MAX_THREADS)
held_kernel(const TX* __restrict__ x, int8_t* __restrict__ xq, float* __restrict__ sx,
            long long rows, int width, int tpr, int qmax, float clip_ratio) {
  __shared__ float red[MAX_THREADS / 32];
  const long long row = (long long)blockIdx.x * (blockDim.x / tpr) + threadIdx.x / tpr;
  quant_rows::quantize_held<TX, VEC, C>(x + row * width, width, xq + row * width, sx + row,
                                        row < rows, tpr, qmax, clip_ratio, red);
}

template <typename TX, bool VEC>
__global__ void __launch_bounds__(MAX_THREADS)
staged_kernel(const TX* __restrict__ x, int8_t* __restrict__ xq, float* __restrict__ sx,
              int width, int qmax, float clip_ratio) {
  extern __shared__ __align__(16) float row_s[];
  __shared__ float red[MAX_THREADS / 32];
  const long long row = blockIdx.x;
  quant_rows::quantize_staged<TX, VEC>(x + row * width, width, xq + row * width, sx + row,
                                       qmax, clip_ratio, row_s, red);
}

// The held body with C register units a row, C = p.chunks (1, 2, 4, ... up
// to 16 units of 16 bytes, or 64 single values, a thread: rows of up to
// WARP_MAX_K values at 32 lanes).
template <typename TX, bool VEC, int C = 1>
int launch_held(const Plan& p, const TX* x, int8_t* xq, float* sx, int qmax, float clip_ratio,
                cudaStream_t s) {
  if constexpr (C <= (VEC ? 16 : 64)) {
    if (p.chunks != C) return launch_held<TX, VEC, 2 * C>(p, x, xq, sx, qmax, clip_ratio, s);
    held_kernel<TX, VEC, C><<<(unsigned)p.blocks, p.threads, 0, s>>>(
        x, xq, sx, p.rows, p.width, p.tpr, qmax, clip_ratio);
    return (int)cudaGetLastError();
  } else {
    return (int)cudaErrorInvalidValue;
  }
}

template <typename TX, bool VEC>
int launch_staged(const Plan& p, const TX* x, int8_t* xq, float* sx, int qmax,
                  float clip_ratio, cudaStream_t s) {
  static int configured = 48 * 1024;  // per instantiation
  if (p.smem > configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        staged_kernel<TX, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (e != cudaSuccess) return (int)e;
    configured = p.smem;
  }
  staged_kernel<TX, VEC><<<(unsigned)p.blocks, p.threads, p.smem, s>>>(x, xq, sx, p.width,
                                                                       qmax, clip_ratio);
  return (int)cudaGetLastError();
}

template <typename TX>
int launch(const Plan& p, const void* x, void* xq, void* sx, int qmax, float clip_ratio,
           cudaStream_t s) {
  const TX* xp = static_cast<const TX*>(x);
  int8_t* q = static_cast<int8_t*>(xq);
  float* sp = static_cast<float*>(sx);
  if (p.staged)
    return p.vec ? launch_staged<TX, true>(p, xp, q, sp, qmax, clip_ratio, s)
                 : launch_staged<TX, false>(p, xp, q, sp, qmax, clip_ratio, s);
  return p.vec ? launch_held<TX, true>(p, xp, q, sp, qmax, clip_ratio, s)
               : launch_held<TX, false>(p, xp, q, sp, qmax, clip_ratio, s);
}

}  // namespace

extern "C" {

// The widest row (K, or g) the kernel takes.
int act_quant_max_k() { return MAX_K; }

// The plan of a call at (M, K, group) with x bf16 (1) or f32 (0), x and xq
// aligned for 16-byte units (1) or not, as out[0..11] = vec, staged, width,
// units, threads a row, loads, chunks, rows a block, threads a block,
// dynamic shared bytes, rows, blocks.
void act_quant_plan(long long M, int K, int group, int x_bf16, int aligned, long long* out) {
  const Plan p = plan_of(M, K, group, x_bf16 ? 2 : 4, aligned);
  const long long v[12] = {p.vec,   p.staged,         p.width,   p.units,
                           p.tpr,   p.loads,          p.chunks,  p.rows_per_block,
                           p.threads, p.smem,         p.rows,    p.blocks};
  for (int i = 0; i < 12; ++i) out[i] = v[i];
}

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok).
// group 0 writes per-token scales sx (M, 1); group g > 0 (dividing K) the
// (M, K/g) plane.
int act_quant(const void* x, int x_bf16, void* xq, void* sx, int M, int K, int group, int qmax,
              float clip_ratio, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (group < 0 || (group > 0 && K % group)) return (int)cudaErrorInvalidValue;
  if ((group > 0 ? group : K) > MAX_K) return (int)cudaErrorInvalidValue;
  if (M <= 0) return 0;
  const int N = x_bf16 ? 8 : 4;
  const int aligned = ((reinterpret_cast<uintptr_t>(x) & 15) |
                       (reinterpret_cast<uintptr_t>(xq) & (N - 1))) == 0;
  const Plan p = plan_of(M, K, group, x_bf16 ? 2 : 4, aligned);
  return x_bf16 ? launch<__nv_bfloat16>(p, x, xq, sx, qmax, clip_ratio, s)
                : launch<float>(p, x, xq, sx, qmax, clip_ratio, s);
}

}  // extern "C"
