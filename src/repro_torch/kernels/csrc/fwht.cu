// Walsh-Hadamard transform of rows for Hopper (sm_90a):
//
//     out (M, D) = x · H_D     (H_D the normalized Walsh-Hadamard matrix)
//
// from x (M, D) f32 or bf16, D a power of two up to MAX_D, out in x's dtype.
// Replaces the TPU kernel repro/kernels/hadamard.py::fwht_kernel, the
// rotation of the unfused W4A4+LRC path.
//
// Numerics.  Each row is staged in f32, transformed by fwht_rows.cuh (the
// body the fused and prologue kernels share) and rounded to x's dtype once,
// as the TPU kernel does: the result is bitwise rowops.fwht_rows.
//
// Bound on an H100 SXM: memory.  x is read once and out written once,
// 2·M·D·elt bytes at 3.35 TB/s; the D·log2(D) f32 adds a row, most of them
// in registers, are far below the card's rate.
//
// Design.  A block of 256 threads takes max(1, 2048 / D) whole rows (so a
// short row still gives the block work), staged in dynamic shared memory
// (4·D bytes, 128 KB at D = 32768), rotated in place and written back.  A
// row's result never depends on M or on the other rows of its block.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stddef.h>

#include "fwht_rows.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_D = 32768;    // the row is staged whole: 128 KB
constexpr int MIN_TILE = 2048;  // values a block takes at least, in whole rows

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f32(float v, float* o) { *o = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* o) { *o = __float2bfloat16_rn(v); }

inline int rows_per_block(int D) { return D >= MIN_TILE ? 1 : MIN_TILE / D; }

template <typename TX>
__global__ void __launch_bounds__(THREADS)
fwht_kernel(const TX* __restrict__ x, TX* __restrict__ out, int M, int D,
            int rows, float nrm) {
  extern __shared__ __align__(16) float buf[];
  const int tid = threadIdx.x;
  const size_t r0 = (size_t)blockIdx.x * rows;
  const int n = min(rows, M - (int)r0) * D;  // valid values of this block
  const int total = rows * D;
  const TX* src = x + r0 * D;
  TX* dst = out + r0 * D;

  for (int i0 = 0; i0 < total; i0 += 8 * THREADS) {
    float t[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int i = i0 + j * THREADS + tid;
      t[j] = i < n ? to_f32(src[i]) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int i = i0 + j * THREADS + tid;
      if (i < total) buf[i] = t[j];
    }
  }
  __syncthreads();
  fwht_rows::rotate<THREADS>(buf, total, D, nrm);
  for (int i = tid; i < n; i += THREADS) from_f32(buf[i], dst + i);
}

template <typename TX>
int launch(const void* x, void* out, int M, int D, cudaStream_t stream) {
  auto kern = fwht_kernel<TX>;
  const int rows = rows_per_block(D);
  const size_t smem = sizeof(float) * (size_t)rows * D;
  static size_t configured = 48 * 1024;  // per instantiation
  if (smem > configured) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    configured = smem;
  }
  kern<<<(M + rows - 1) / rows, THREADS, smem, stream>>>(
      static_cast<const TX*>(x), static_cast<TX*>(out), M, D, rows,
      fwht_rows::norm(D));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The widest row the kernel takes.
int fwht_max_d() { return MAX_D; }

// The normalization constant the kernels multiply by at width D.
float fwht_norm(int D) { return fwht_rows::norm(D); }

// Launch on `stream`; returns the first CUDA error of the launch (0 = ok).
// x_bf16 selects bf16 (1) or f32 (0) for x and out.  D must be a power of
// two no larger than fwht_max_d() (the wrapper checks).
int fwht(const void* x, int x_bf16, void* out, int M, int D, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D < 1 || (D & (D - 1)) || D > MAX_D) return (int)cudaErrorInvalidValue;
  if (x_bf16) return launch<__nv_bfloat16>(x, out, M, D, s);
  return launch<float>(x, out, M, D, s);
}

}  // extern "C"
