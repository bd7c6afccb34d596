// The normalized Walsh-Hadamard transform of rows held in shared memory,
// shared by fwht.cu, fused_w4a4_lrc.cu and fused_prologue.cu, so that the
// three kernels' rotated rows are bitwise the same by construction (as
// quant_rows.cuh does for the quantizer).
//
// Numerics follow repro/kernels/rowops.py::fwht_rows exactly: sweeps
// h = 1, 2, ... d/2, each replacing the pair (a, b) = (y[i], y[i + h]) (i
// with bit h clear) by (a + b, a - b), then one multiply of every element by
// the f32 value of 1.0 / sqrt(d).  Each output is therefore a fixed tree of
// f32 adds and subtracts and one multiply, whatever thread computes it and
// however the sweeps are grouped: the result is bitwise the reference's.
//
// Design.  The sweeps run in groups of up to four (h0, 2h0, 4h0, 8h0): a
// thread loads a set of 16 values {base + j·h0}, applies the group's
// sweeps in registers in ascending h, and stores them back, so a row of d
// values makes ceil(log2(d) / 4) round trips through shared memory instead
// of log2(d).  A barrier separates the groups.  The first group's sets are
// 16 contiguous values, read and written as float4.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace fwht_rows {

// The normalization constant, computed on the host as the f32 value of the
// double 1.0 / sqrt(d).  The plain version multiplies by Python's
// 1.0 / d**0.5 rounded to f32; chip_smoke.py checks the two are the same
// number for every power of two the kernels take.
__host__ inline float norm(int d) { return (float)(1.0 / sqrt((double)d)); }

__host__ __device__ inline int log2_of(int d) {
  int l = 0;
  while ((1 << l) < d) ++l;
  return l;
}

// S sweeps at h0, 2·h0, ... 2^(S-1)·h0 over `total` values (whole rows),
// each thread taking sets of 2^S values {base + j·h0}; the last group also
// applies the normalization.
template <int S, int NTHREADS>
__device__ __forceinline__ void sweep_group(float* buf, int total, int h0,
                                            bool last, float nrm) {
  constexpr int E = 1 << S;
  const int sets = total >> S;
  for (int i = threadIdx.x; i < sets; i += NTHREADS) {
    const int off = i & (h0 - 1);
    const int base = (i - off) * E + off;  // (i / h0)·(h0·E) + i % h0
    float v[E];
    if (E == 16 && h0 == 1) {
      const float4* p = reinterpret_cast<const float4*>(buf + base);
#pragma unroll
      for (int j = 0; j < E / 4; ++j) {
        const float4 q = p[j];
        v[4 * j] = q.x; v[4 * j + 1] = q.y; v[4 * j + 2] = q.z; v[4 * j + 3] = q.w;
      }
    } else {
#pragma unroll
      for (int j = 0; j < E; ++j) v[j] = buf[base + j * h0];
    }
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int g = 1 << s;
#pragma unroll
      for (int j = 0; j < E; ++j) {
        if ((j & g) == 0) {
          const float a = v[j], b = v[j + g];
          v[j] = __fadd_rn(a, b);
          v[j + g] = __fsub_rn(a, b);
        }
      }
    }
    if (last) {
#pragma unroll
      for (int j = 0; j < E; ++j) v[j] = __fmul_rn(v[j], nrm);
    }
    if (E == 16 && h0 == 1) {
      float4* p = reinterpret_cast<float4*>(buf + base);
#pragma unroll
      for (int j = 0; j < E / 4; ++j)
        p[j] = make_float4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]);
    } else {
#pragma unroll
      for (int j = 0; j < E; ++j) buf[base + j * h0] = v[j];
    }
  }
}

// Rotates total / d rows of d values (a power of two) at buf, in place, with
// the whole block: buf = buf · H_d.  buf must be 16-byte aligned, the rows
// already staged (a barrier after the staging), and every thread of the
// block must call it; it ends with a barrier.
template <int NTHREADS>
__device__ void rotate(float* buf, int total, int d, float nrm) {
  const int L = log2_of(d);
  if (L == 0) {
    for (int i = threadIdx.x; i < total; i += NTHREADS) buf[i] = __fmul_rn(buf[i], nrm);
    __syncthreads();
    return;
  }
  for (int done = 0; done < L;) {
    const int S = min(4, L - done);
    const bool last = done + S == L;
    switch (S) {
      case 4: sweep_group<4, NTHREADS>(buf, total, 1 << done, last, nrm); break;
      case 3: sweep_group<3, NTHREADS>(buf, total, 1 << done, last, nrm); break;
      case 2: sweep_group<2, NTHREADS>(buf, total, 1 << done, last, nrm); break;
      default: sweep_group<1, NTHREADS>(buf, total, 1 << done, last, nrm); break;
    }
    done += S;
    __syncthreads();
  }
}

}  // namespace fwht_rows
