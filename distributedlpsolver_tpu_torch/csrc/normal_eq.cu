// Normal-equations assembly M = A·diag(d)·Aᵀ for the H100 (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel ops/normal_eq.py::_ne_kernel
// (driven by normal_eq_pallas). A is (m, n) row-major, d is (n,), M is
// (m, m) row-major. Built with nvcc into a shared library with a plain C
// interface and called through ctypes (ops/normal_eq.py).
//
// What bounds it on the H100: M is symmetric, so the function needs
// m·(m+1)·n flops (the lower triangle) against reading A once (m·n
// elements); at the IPM's shapes (m in the thousands) it is bound by
// arithmetic, not bytes. This design computes both triangles (2·m²·n
// flops, twice the need) with plain FMAs on the CUDA cores (FP64: 34
// TFLOP/s, half the 67 TFLOP/s of the DMMA tensor cores), so in f64 it
// takes at least about four times the bound.
//
// Design: one thread block owns one 64×64 output tile of M and loops over
// k in chunks of 16. That in-block loop takes the place of the TPU grid's
// sequential ("arbitrary") k axis; since each block owns its tile, no
// reduction crosses blocks. Each chunk stages A[i-tile, k-chunk]·d[k-chunk]
// and A[j-tile, k-chunk] in shared memory, k-major, with zero fill past the
// ragged edges of m and n, so no host-side padding exists (the TPU's
// pad_for_pallas/out_m are not carried over). 256 threads each hold a 4×4
// register micro-tile: rows ty + 16·r, columns tx + 16·c, so that a warp's
// shared loads of the j-tile are 16 consecutive elements and its stores to
// M are coalesced rows. Offsets are 64-bit: m·n reaches 5·10⁸ at the
// 10000×50000 reference shape.
//
// Element types (template In, Acc; M is written in Acc):
//   f64  in, f64 accumulate and out — the main path on the card;
//   f32  in, f32 accumulate and out — true fp32 FMAs, never TF32 (TF32's
//        ~1e-3 relative error is the trap normal_eq.py:64-67 names);
//   bf16 in, f32 accumulate and out — the scaled product A·d is rounded to
//        bf16 first, as normal_eq.py:58 does in bf16.
//
// Later work: DMMA (mma.sync f64) tensor-core tiles, a cp.async/TMA
// pipeline for the staging loads, and lower-triangle-only tiles mirrored
// into the upper half.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;     // output tile edge (rows of A per block side)
constexpr int KCHUNK = 16;   // k elements staged per loop trip
constexpr int THREADS = 256; // 16 × 16 threads, 4×4 outputs each
constexpr int MICRO = 4;
constexpr int PAD = 1;       // shared-memory row pad against bank conflicts

// Fused multiply-add with one rounding, in the accumulation type.
__device__ __forceinline__ double madd(double a, double b, double c) {
  return __fma_rn(a, b, c);
}
__device__ __forceinline__ float madd(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}

// Scaled element a·d in the accumulation type, rounded as the TPU kernel
// rounds it: in the input type.
template <typename In, typename Acc>
__device__ __forceinline__ Acc scaled(In a, In dk) {
  return static_cast<Acc>(a * dk);
}
template <>
__device__ __forceinline__ float scaled<__nv_bfloat16, float>(__nv_bfloat16 a,
                                                              __nv_bfloat16 dk) {
  return __bfloat162float(__float2bfloat16(__bfloat162float(a) * __bfloat162float(dk)));
}

template <typename In, typename Acc>
__device__ __forceinline__ Acc widen(In a) {
  return static_cast<Acc>(a);
}
template <>
__device__ __forceinline__ float widen<__nv_bfloat16, float>(__nv_bfloat16 a) {
  return __bfloat162float(a);
}

template <typename In, typename Acc>
__global__ void __launch_bounds__(THREADS)
normal_eq_kernel(const In* __restrict__ A, const In* __restrict__ d,
                 Acc* __restrict__ M, int64_t m, int64_t n) {
  __shared__ Acc Ai[KCHUNK][TILE + PAD];  // A[i-tile, k-chunk]·d, k-major
  __shared__ Acc Aj[KCHUNK][TILE + PAD];  // A[j-tile, k-chunk], k-major

  const int t = threadIdx.x;
  const int tx = t % 16;
  const int ty = t / 16;
  const int64_t i0 = static_cast<int64_t>(blockIdx.y) * TILE;
  const int64_t j0 = static_cast<int64_t>(blockIdx.x) * TILE;

  Acc acc[MICRO][MICRO];
#pragma unroll
  for (int r = 0; r < MICRO; ++r)
#pragma unroll
    for (int c = 0; c < MICRO; ++c) acc[r][c] = Acc(0);

  const In zero = In(0.0f);
  for (int64_t k0 = 0; k0 < n; k0 += KCHUNK) {
    // Stage both tiles: TILE·KCHUNK = 1024 elements each, 4 per thread.
    // Consecutive threads read consecutive k of one row (coalesced).
#pragma unroll
    for (int l = 0; l < (TILE * KCHUNK) / THREADS; ++l) {
      const int idx = t + l * THREADS;
      const int row = idx / KCHUNK;
      const int kk = idx % KCHUNK;
      const int64_t k = k0 + kk;
      const bool kin = k < n;
      const In dk = kin ? d[k] : zero;
      const int64_t gi = i0 + row;
      const int64_t gj = j0 + row;
      const In ai = (kin && gi < m) ? A[gi * n + k] : zero;
      const In aj = (kin && gj < m) ? A[gj * n + k] : zero;
      Ai[kk][row] = scaled<In, Acc>(ai, dk);
      Aj[kk][row] = widen<In, Acc>(aj);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KCHUNK; ++kk) {
      Acc a[MICRO], b[MICRO];
#pragma unroll
      for (int r = 0; r < MICRO; ++r) a[r] = Ai[kk][ty + 16 * r];
#pragma unroll
      for (int c = 0; c < MICRO; ++c) b[c] = Aj[kk][tx + 16 * c];
#pragma unroll
      for (int r = 0; r < MICRO; ++r)
#pragma unroll
        for (int c = 0; c < MICRO; ++c) acc[r][c] = madd(a[r], b[c], acc[r][c]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < MICRO; ++r) {
    const int64_t gi = i0 + ty + 16 * r;
    if (gi >= m) continue;
#pragma unroll
    for (int c = 0; c < MICRO; ++c) {
      const int64_t gj = j0 + tx + 16 * c;
      if (gj < m) M[gi * m + gj] = acc[r][c];
    }
  }
}

template <typename In, typename Acc>
int launch(const void* A, const void* d, void* M, int64_t m, int64_t n,
           void* stream) {
  const int64_t tiles = (m + TILE - 1) / TILE;
  if (m <= 0 || tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(tiles));
  normal_eq_kernel<In, Acc><<<grid, THREADS, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const In*>(A), static_cast<const In*>(d),
      static_cast<Acc*>(M), m, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (ctypes). Each launches on ``stream`` without
// synchronising or allocating and returns cudaGetLastError() (0 = launched).
extern "C" {

int dlps_normal_eq_f64(const void* A, const void* d, void* M, int64_t m,
                       int64_t n, void* stream) {
  return launch<double, double>(A, d, M, m, n, stream);
}

int dlps_normal_eq_f32(const void* A, const void* d, void* M, int64_t m,
                       int64_t n, void* stream) {
  return launch<float, float>(A, d, M, m, n, stream);
}

int dlps_normal_eq_bf16_f32(const void* A, const void* d, void* M, int64_t m,
                            int64_t n, void* stream) {
  return launch<__nv_bfloat16, float>(A, d, M, m, n, stream);
}

}  // extern "C"
