// Activation quantizer for Hopper (sm_90a):
//
//     xq (M, K) int8, sx (M, 1) f32  =  Q_a(x),  x (M, K) f32 or bf16
//
// or, with `group` g > 0 (g divides K), the (M, K/g) scale plane, one scale
// per g contiguous values of a row.  Replaces the TPU kernel
// repro/kernels/actquant.py::act_quant_kernel, per-token and with its
// `group` branch (the unfused path's quantizer).  The numerics are those of
// quant_rows.cuh, which fused_prologue.cu shares, so the two kernels' codes
// and scales are bitwise equal.
//
// Bound on an H100 SXM: memory.  It reads x once (2 or 4 bytes a value) and
// writes one byte a value plus four a row, at 3.35 TB/s; the divisions are
// far below the card's rate.  Design: one block of 256 threads per row, so
// a row's result never depends on M or on the other rows; the row is read
// twice (amax, then quantize), the second time from L1/L2.  Group-wise, the
// block's eight warps take the row's groups in turn, each group's amax a
// warp reduction.

#include <cuda_runtime.h>

#include "quant_rows.cuh"

namespace {

constexpr int THREADS = 256;

template <typename TX>
__global__ void __launch_bounds__(THREADS)
act_quant_kernel(const TX* __restrict__ x, int8_t* __restrict__ xq,
                 float* __restrict__ sx, int K, int group, int qmax,
                 float clip_ratio) {
  __shared__ float red[THREADS / 32];
  const size_t row = blockIdx.x;
  if (group > 0)
    quant_rows::quantize_row_grouped<THREADS>(x + row * K, K, group, xq + row * K,
                                              sx + row * (K / group), qmax, clip_ratio);
  else
    quant_rows::quantize_row<THREADS>(x + row * K, K, xq + row * K, sx + row,
                                      qmax, clip_ratio, red);
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok).
// group 0 writes per-token scales sx (M, 1); group g > 0 (dividing K) the
// (M, K/g) plane.
int act_quant(const void* x, int x_bf16, void* xq, void* sx, int M, int K,
              int group, int qmax, float clip_ratio, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (group < 0 || (group > 0 && K % group)) return (int)cudaErrorInvalidValue;
  if (x_bf16)
    act_quant_kernel<__nv_bfloat16><<<M, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(xq),
        static_cast<float*>(sx), K, group, qmax, clip_ratio);
  else
    act_quant_kernel<float><<<M, THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<int8_t*>(xq),
        static_cast<float*>(sx), K, group, qmax, clip_ratio);
  return (int)cudaGetLastError();
}

}  // extern "C"
