// Walsh-Hadamard transform of rows for Hopper (sm_90a):
//
//     out (M, D) = x · H_D     (H_D the normalized Walsh-Hadamard matrix)
//
// from x (M, D) f32 or bf16, D a power of two up to MAX_D, out in x's dtype.
// Replaces the TPU kernel repro/kernels/hadamard.py::fwht_kernel, the
// rotation of the unfused W4A4+LRC path.
//
// Numerics.  Sweeps h = 1, 2, ... D/2, in ascending order and each once,
// replace every pair (a, b) = (y[i], y[i + h]) (i with bit h clear) by
// (__fadd_rn(a, b), __fsub_rn(a, b)) in f32; then one __fmul_rn by
// fwht_rows::norm(D), and one rounding to x's dtype.  Each output is thus
// the fixed tree of rowops.fwht_rows (and of fwht_rows::rotate, which the
// fused kernels run), whichever thread computes which pair: the result is
// bitwise the plain version's.
//
// Bound on an H100 SXM: memory.  x is read once and out written once,
// 2·M·D·elt bytes at 3.35 TB/s; the M·D·log2(D) f32 adds and subtracts are
// far below the card's rate (chip_smoke.py::phase_rotate_kernels).
//
// Design.  The rows are one flat array of M·D values, cut into tiles of
// T·C·N values, whole rows each: N = 8 bf16 or 4 f32 (16 bytes), C such
// units a thread, T threads a block.  A value's index in its tile has the
// bits [e: log2 N][lane: 5][k: log2 C][warp: the rest], so thread (warp,
// lane) loads its unit k from N·(lane + 32·(k + C·warp)), 16 bytes, all C
// loads issued before the first sweep.  A sweep whose bit is an e or a k
// bit runs in registers; one whose bit is a lane bit takes one
// __shfl_xor_sync a value, the lower lane keeping a + b and the upper a - b
// (a the lower lane's value).  A row of up to 2^(log2 N + 5 + log2 C) =
// 1,024 values lies within one warp and needs nothing more: C = D / (32·N)
// between 1 and CMAX (4 bf16, 8 f32), eight warps a block.  A wider row (C =
// CMAX, 32 values a thread, D / 32 threads a row and at least 256 a block)
// has ω = log2(D) - 10 sweeps left, over its warp bits: the block writes its
// values to shared memory (4 bytes each) and reads them back once, so that
// the first hr = min(ω, log2 C) of those bits are k bits and the other hl =
// ω - hr are the top lane bits (the displaced lane and k bits become warp
// bits), then runs them in registers and lanes as before.  One exchange a
// row up to MAX_D = 32,768 (ω <= 5); at bf16 the two 16-byte halves of a
// unit swap places by a parity of its index bits 2 and 9, which leaves
// neither side's 16-byte accesses with a bank conflict.  The rotated values
// are stored 16 bytes a lane from where they lie.  Where x or out is not
// 16-byte aligned (or D < N at the array's end) the units are read and
// written value by value, in the same places.  fwht_plan exports the plan
// (threads, rows a block, C, exchanges, shared bytes, and for each sweep in
// the order it runs: its stage, registers or lanes, and which bit);
// hadamard.fwht_plan mirrors it.  A row's result never depends on M.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stddef.h>
#include <stdint.h>

#include <algorithm>

#include "fwht_rows.cuh"
#include "quant_rows.cuh"

namespace {

constexpr int MAX_D = 32768;     // one exchange: ω = log2 D - 10 <= 5
constexpr int MAX_THREADS = 1024;
constexpr int MIN_BLOCK = 256;   // threads of a block at least
constexpr int LANE_BITS = 5;

__host__ __device__ constexpr int log2c(int v) { return v <= 1 ? 0 : 1 + log2c(v / 2); }

struct Plan {
  int threads, rows_per_block, chunks, exchanges, smem, L, hr, hl;
  // each sweep in the order it runs: bit b of the row index (h = 2^b) << 8 |
  // stage (0 before the exchange, 1 after) << 6 | kind (0 registers, 1
  // lanes) << 5 | the register-array bit or lane bit
  int steps[16];
};

Plan plan_of(int D, int x_bytes) {
  Plan p{};
  const int N = 16 / x_bytes, NB = log2c(N), CMAX = 32 / N;
  p.L = fwht_rows::log2_of(D);
  const int warp_bits = NB + LANE_BITS + log2c(CMAX);  // a row within one warp
  if (p.L <= warp_bits) {
    p.chunks = std::min(CMAX, std::max(1, D / (32 * N)));
    p.threads = MIN_BLOCK;
  } else {
    p.chunks = CMAX;
    p.threads = std::max(MIN_BLOCK, D / (N * CMAX));
  }
  const int CB = log2c(p.chunks);
  p.rows_per_block = p.threads * p.chunks * N / D;
  const int omega = std::max(0, p.L - (NB + LANE_BITS + CB));
  p.exchanges = omega > 0;
  p.hr = std::min(omega, CB);
  p.hl = omega - p.hr;
  p.smem = p.exchanges ? 4 * p.threads * p.chunks * N : 0;
  for (int b = 0; b < p.L; ++b) {
    int stage = 0, kind, pos;
    if (b < NB) {
      kind = 0, pos = b;
    } else if (b < NB + LANE_BITS) {
      kind = 1, pos = b - NB;
    } else if (b < NB + LANE_BITS + CB) {
      kind = 0, pos = b - LANE_BITS;
    } else {
      const int i = b - (NB + LANE_BITS + CB);
      stage = 1;
      if (i < p.hr)
        kind = 0, pos = NB + i;
      else
        kind = 1, pos = LANE_BITS - p.hl + i - p.hr;
    }
    p.steps[b] = b << 8 | stage << 6 | kind << 5 | pos;
  }
  return p;
}

// One sweep over register-array bit AB: pairs (j, j + 2^AB), j with the bit clear.
template <int AB, int V>
__device__ __forceinline__ void reg_sweep(float (&v)[V]) {
  constexpr int G = 1 << AB;
#pragma unroll
  for (int j = 0; j < V; ++j)
    if ((j & G) == 0) {
      const float a = v[j], b = v[j + G];
      v[j] = __fadd_rn(a, b);
      v[j + G] = __fsub_rn(a, b);
    }
}

// The sweeps over register-array bits OFF + B, B from I to END - 1 in
// ascending order, each where B < live.
template <int I, int END, int OFF, int V>
__device__ __forceinline__ void reg_sweeps(float (&v)[V], int live) {
  if constexpr (I < END) {
    if (I < live) reg_sweep<OFF + I>(v);
    reg_sweeps<I + 1, END, OFF>(v, live);
  }
}

// One sweep over lane bit `m` (a mask): the lower lane keeps a + b, the upper
// a - b, a the lower lane's value.  Every lane of the warp must call it.
// The upper lane computes o + (-v), which is o - v bitwise.
template <int V>
__device__ __forceinline__ void lane_sweep(float (&v)[V], int m, int lane) {
  const unsigned sign = lane & m ? 0x80000000u : 0u;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const float o = __shfl_xor_sync(0xffffffffu, v[j], m);
    v[j] = __fadd_rn(o, __uint_as_float(__float_as_uint(v[j]) ^ sign));
  }
}

template <typename TX>
struct Unit;

template <>
struct Unit<float> {
  __device__ static __forceinline__ void store16(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
  __device__ static __forceinline__ void store1(float* p, float v) { *p = v; }
};

template <>
struct Unit<__nv_bfloat16> {
  __device__ static __forceinline__ uint32_t pack(float a, float b) {
    return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(a)) |
           (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(b)) << 16;
  }
  __device__ static __forceinline__ void store16(__nv_bfloat16* p, const float* v) {
    *reinterpret_cast<uint4*>(p) =
        make_uint4(pack(v[0], v[1]), pack(v[2], v[3]), pack(v[4], v[5]), pack(v[6], v[7]));
  }
  __device__ static __forceinline__ void store1(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
  }
};

// The N values of x at flat index i (a multiple of N) into v: one 16-byte
// load where `vec` and the unit lies inside the array, else value by value
// (0 past its end).
template <typename TX>
__device__ __forceinline__ void load_unit(const TX* __restrict__ x, long long i, long long total,
                                          bool vec, float* v) {
  constexpr int N = quant_rows::Vec16<TX>::N;
  if (vec && i + N <= total) {
    quant_rows::Vec16<TX>::load(x + i, v);
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e) v[e] = i + e < total ? quant_rows::to_f32(x[i + e]) : 0.f;
  }
}

template <typename TX>
__device__ __forceinline__ void store_unit(TX* __restrict__ out, long long i, long long total,
                                           bool vec, const float* v) {
  constexpr int N = quant_rows::Vec16<TX>::N;
  if (vec && i + N <= total) {
    Unit<TX>::store16(out + i, v);
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e)
      if (i + e < total) Unit<TX>::store1(out + i + e, v[e]);
  }
}

// The float4 slot in shared memory of half `j` of unit q (a unit is N / 4
// float4s): at bf16 the halves swap by the parity of q's bits 2 and 9.
template <int N>
__device__ __forceinline__ int slot(int q, int j) {
  if constexpr (N == 8)
    return 2 * q + (j ^ (((q >> 2) ^ (q >> 9)) & 1));
  else
    return q;
}

template <typename TX, int C>
__global__ void __launch_bounds__(MAX_THREADS)
fwht_kernel(const TX* __restrict__ x, TX* __restrict__ out, long long total, int L, int hr,
            int hl, int vec, float nrm) {
  extern __shared__ __align__(16) float4 xs[];  // the exchange (wide rows only)
  constexpr int N = quant_rows::Vec16<TX>::N, NB = log2c(N), CB = log2c(C), V = C * N;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long tile = (long long)blockIdx.x * blockDim.x * V;
  float v[V];
#pragma unroll
  for (int k = 0; k < C; ++k)
    load_unit(x, tile + (long long)N * (lane + 32 * (k + C * warp)), total, vec, v + k * N);

  // before the exchange: e bits in registers, lane bits, k bits in registers
  reg_sweeps<0, NB, 0>(v, L);
  for (int p = 0; p < LANE_BITS && NB + p < L; ++p) lane_sweep(v, 1 << p, lane);
  reg_sweeps<0, CB, NB>(v, L - NB - LANE_BITS);

  const int omega = L - (NB + LANE_BITS + CB);
  int q[C];  // each register unit's index (in units) in the tile
#pragma unroll
  for (int k = 0; k < C; ++k) q[k] = lane + 32 * (k + C * warp);
  if (omega > 0) {
#pragma unroll
    for (int k = 0; k < C; ++k)
#pragma unroll
      for (int j = 0; j < N / 4; ++j)
        xs[slot<N>(q[k], j)] = make_float4(v[k * N + 4 * j], v[k * N + 4 * j + 1],
                                           v[k * N + 4 * j + 2], v[k * N + 4 * j + 3]);
    __syncthreads();
    // after: k's low hr bits and the lane's top hl bits are the ω bits; the
    // displaced lane (P) and k (Q) bits are the warp's low hl + hr bits
    const int pl = LANE_BITS - hl;
    const int wp = warp & ((1 << hl) - 1), wq = (warp >> hl) & ((1 << hr) - 1);
    const int rest = warp >> (hl + hr);
    const int P = (lane & ((1 << pl) - 1)) | wp << pl;
    const int Hhi = lane >> pl;
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const int H = (k & ((1 << hr) - 1)) | Hhi << hr;
      const int Q = (k >> hr) | wq << (CB - hr);
      q[k] = P | Q << LANE_BITS | H << (LANE_BITS + CB) | rest << (LANE_BITS + CB + omega);
#pragma unroll
      for (int j = 0; j < N / 4; ++j) {
        const float4 u = xs[slot<N>(q[k], j)];
        v[k * N + 4 * j] = u.x, v[k * N + 4 * j + 1] = u.y;
        v[k * N + 4 * j + 2] = u.z, v[k * N + 4 * j + 3] = u.w;
      }
    }
    reg_sweeps<0, CB, NB>(v, hr);
    for (int p = pl; p < LANE_BITS; ++p) lane_sweep(v, 1 << p, lane);
  }
#pragma unroll
  for (int j = 0; j < V; ++j) v[j] = __fmul_rn(v[j], nrm);
#pragma unroll
  for (int k = 0; k < C; ++k) store_unit(out, tile + (long long)N * q[k], total, vec, v + k * N);
}

template <typename TX, int C>
int launch_c(const Plan& p, const void* x, void* out, long long M, int D, int vec,
             cudaStream_t stream) {
  auto kern = fwht_kernel<TX, C>;
  static int configured = 48 * 1024;  // per instantiation
  if (p.smem > configured) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (e != cudaSuccess) return (int)e;
    configured = p.smem;
  }
  const long long blocks = (M + p.rows_per_block - 1) / p.rows_per_block;
  kern<<<(unsigned)blocks, p.threads, p.smem, stream>>>(static_cast<const TX*>(x),
                                                        static_cast<TX*>(out), M * D, p.L,
                                                        p.hr, p.hl, vec, fwht_rows::norm(D));
  return (int)cudaGetLastError();
}

template <typename TX>
int launch(const void* x, void* out, long long M, int D, cudaStream_t stream) {
  const Plan p = plan_of(D, sizeof(TX));
  const int vec = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  switch (p.chunks) {
    case 1: return launch_c<TX, 1>(p, x, out, M, D, vec, stream);
    case 2: return launch_c<TX, 2>(p, x, out, M, D, vec, stream);
    case 4: return launch_c<TX, 4>(p, x, out, M, D, vec, stream);
    default:
      if constexpr (sizeof(TX) == 4) return launch_c<TX, 8>(p, x, out, M, D, vec, stream);
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// The widest row the kernel takes.
int fwht_max_d() { return MAX_D; }

// The normalization constant the kernels multiply by at width D.
float fwht_norm(int D) { return fwht_rows::norm(D); }

// The plan at width D with x bf16 (1) or f32 (0), as out[0..5] = threads a
// block, rows a block, C, exchanges, dynamic shared bytes, log2 D, then
// out[6 + i] for each of the log2 D sweeps in the order they run (Plan::steps).
void fwht_plan(int D, int x_bf16, long long* out) {
  const Plan p = plan_of(D, x_bf16 ? 2 : 4);
  const long long head[6] = {p.threads, p.rows_per_block, p.chunks, p.exchanges, p.smem, p.L};
  for (int i = 0; i < 6; ++i) out[i] = head[i];
  for (int i = 0; i < p.L; ++i) out[6 + i] = p.steps[i];
}

// Launch on `stream`; returns the first CUDA error of the launch (0 = ok).
// x_bf16 selects bf16 (1) or f32 (0) for x and out.  D must be a power of
// two no larger than fwht_max_d() (the wrapper checks).
int fwht(const void* x, int x_bf16, void* out, int M, int D, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D < 1 || (D & (D - 1)) || D > MAX_D) return (int)cudaErrorInvalidValue;
  if (M <= 0) return 0;
  if (x_bf16) return launch<__nv_bfloat16>(x, out, M, D, s);
  return launch<float>(x, out, M, D, s);
}

}  // extern "C"
