// Hybrid-ELL sparse matrix-vector product and normal-matrix diagonal for
// the H100 (sm_90a).
//
// Replaces the device routines the JAX package leaves to XLA in
// ops/sparse.py::SparseOperator.matvec / rmatvec / normal_diag (a row-ELL
// gather-reduce plus a COO-tail scatter-add, `.at[].add`). One source, two
// functions, each in f64 and f32:
//
//   ell_spmv:         out[i] = Σ_k vals[i,k]·v[cols[i,k]]
//                              + Σ_{tail entries e of row i} tvals[e]·v[tcols[e]]
//   ell_normal_diag:  out[i] = Σ_k vals[i,k]²·d[cols[i,k]]
//                              + Σ_{tail entries e of row i} tvals[e]²·d[tcols[e]] + reg
//
// matvec runs it on A's hybrid ELL, rmatvec on Aᵀ's. The tail is the COO
// spill of rows wider than the ELL width k, stored in CSR row order by
// the hybrid-ELL setup (ops/sparse.py); a row-pointer array over it
// (tail_ptr, m + 1 entries, built once at setup) gives each row its tail
// entries, so every output is summed by exactly one thread group in a
// fixed order: no atomics, and
// two launches on the same inputs give the same bits. (The eager form of
// the tail, `index_add_`, adds with atomics on a card, and CG amplifies
// the last-bit differences from run to run.)
//
// What bounds it on the H100: bytes. Each stored entry costs one
// multiply-add against 12 bytes (f64 value + int32 column) plus a gathered
// 8 bytes of v, so the function is three orders of magnitude below the
// card's operations-per-byte balance. The least time is the operand
// bytes (vals, cols, the tail and its pointers read once, v read once,
// out written once) over 3.35 TB/s.
//
// Design:
//   * Light rows: a group of G lanes (G a power of two ≤ 32, about the ELL
//     width) owns one row. Lane j reads ELL slots j, j + G, ... of the row,
//     so a group's loads of vals/cols are contiguous, then the row's tail
//     (at most heavy_min entries) strided by G; a xor-butterfly of warp
//     shuffles inside the group sums the lanes' partials.
//   * Heavy rows: a row whose tail holds more than heavy_min entries (the
//     bordered storm pattern's first-stage columns become transpose rows
//     with ~K·t entries, ~8,700 at stormG2_1000's shape) gets a block of
//     its own: 256 threads stride over the row, a warp-shuffle and shared-
//     memory tree sums them. The heavy rows are listed at setup (heavy[]);
//     their blocks come first in the grid so they start with the first
//     wave, and the light groups skip those rows. One thread a row would
//     serialise a heavy row's 8,700 products behind the rest of the grid.
//   * Every reduction has a fixed shape, so the result does not depend on
//     scheduling. It does differ in the last bits from the plain version's
//     summation order (the ELL sum first, then the tail in order).
//
// Plain C interface, built by nvcc into a shared library and called
// through ctypes (ops/ell_spmv.py). Each entry point returns the CUDA
// error of its launch (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T, bool SQUARE>
__device__ __forceinline__ T term(T a, T x) {
  return SQUARE ? a * a * x : a * x;
}

struct Args {
  const void* vals;
  const int* cols;
  int64_t m;
  int k;
  const int* tail_ptr;  // nullptr: no tail
  const void* tail_vals;
  const int* tail_cols;
  const int* heavy;
  int n_heavy;
  int heavy_min;
  const void* v;
  double reg;
  void* out;
};

template <typename T, bool SQUARE>
__device__ void heavy_row(const Args& a) {
  __shared__ T part[kThreads / 32];
  const T* vals = static_cast<const T*>(a.vals);
  const T* tv = static_cast<const T*>(a.tail_vals);
  const T* v = static_cast<const T*>(a.v);
  const int64_t row = a.heavy[blockIdx.x];
  const T* rv = vals + row * a.k;
  const int* rc = a.cols + row * a.k;
  T acc = T(0);
  for (int j = threadIdx.x; j < a.k; j += kThreads) acc += term<T, SQUARE>(rv[j], v[rc[j]]);
  const int lo = a.tail_ptr[row], hi = a.tail_ptr[row + 1];
  for (int e = lo + threadIdx.x; e < hi; e += kThreads)
    acc += term<T, SQUARE>(tv[e], v[a.tail_cols[e]]);
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) part[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    T s = lane < kThreads / 32 ? part[lane] : T(0);
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) static_cast<T*>(a.out)[row] = s + T(a.reg);
  }
}

template <typename T, bool SQUARE, int G>
__global__ void __launch_bounds__(kThreads) ell_kernel(const Args a) {
  if (static_cast<int>(blockIdx.x) < a.n_heavy) {
    heavy_row<T, SQUARE>(a);  // the whole block takes this branch
    return;
  }
  const T* vals = static_cast<const T*>(a.vals);
  const T* tv = static_cast<const T*>(a.tail_vals);
  const T* v = static_cast<const T*>(a.v);
  const int64_t row =
      static_cast<int64_t>(blockIdx.x - a.n_heavy) * (kThreads / G) + threadIdx.x / G;
  const int lane = threadIdx.x % G;
  bool write = row < a.m;
  T acc = T(0);
  if (write) {
    const T* rv = vals + row * a.k;
    const int* rc = a.cols + row * a.k;
    for (int j = lane; j < a.k; j += G) acc += term<T, SQUARE>(rv[j], v[rc[j]]);
    if (a.tail_ptr != nullptr) {
      const int lo = a.tail_ptr[row], hi = a.tail_ptr[row + 1];
      if (hi - lo > a.heavy_min) {
        write = false;  // a heavy row: its own block writes it
      } else {
        for (int e = lo + lane; e < hi; e += G) acc += term<T, SQUARE>(tv[e], v[a.tail_cols[e]]);
      }
    }
  }
  // Every lane of the warp reaches the shuffles (no early exit above).
  for (int off = G / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (write && lane == 0) static_cast<T*>(a.out)[row] = acc + T(a.reg);
}

template <typename T, bool SQUARE>
int launch_g(const Args& a, int group, cudaStream_t stream) {
  const int rows_per_block = kThreads / group;
  const int64_t light_blocks = (a.m + rows_per_block - 1) / rows_per_block;
  const dim3 grid(static_cast<unsigned>(light_blocks + a.n_heavy));
  switch (group) {
    case 1: ell_kernel<T, SQUARE, 1><<<grid, kThreads, 0, stream>>>(a); break;
    case 2: ell_kernel<T, SQUARE, 2><<<grid, kThreads, 0, stream>>>(a); break;
    case 4: ell_kernel<T, SQUARE, 4><<<grid, kThreads, 0, stream>>>(a); break;
    case 8: ell_kernel<T, SQUARE, 8><<<grid, kThreads, 0, stream>>>(a); break;
    case 16: ell_kernel<T, SQUARE, 16><<<grid, kThreads, 0, stream>>>(a); break;
    case 32: ell_kernel<T, SQUARE, 32><<<grid, kThreads, 0, stream>>>(a); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* vals, const int* cols, int64_t m, int k, const int* tail_ptr,
           const void* tail_vals, const int* tail_cols, const int* heavy, int n_heavy,
           int heavy_min, const void* v, double reg, int square, int group, void* out,
           void* stream) {
  if (m <= 0) return 0;
  if (k < 0 || n_heavy < 0 || (n_heavy > 0 && tail_ptr == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{vals, cols, m, k, tail_ptr, tail_vals, tail_cols, heavy, n_heavy, heavy_min,
               v, reg, out};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return square ? launch_g<T, true>(a, group, s) : launch_g<T, false>(a, group, s);
}

}  // namespace

extern "C" {

int dlps_ell_spmv_f64(const void* vals, const int* cols, int64_t m, int k, const int* tail_ptr,
                      const void* tail_vals, const int* tail_cols, const int* heavy,
                      int n_heavy, int heavy_min, const void* v, double reg, int square,
                      int group, void* out, void* stream) {
  return launch<double>(vals, cols, m, k, tail_ptr, tail_vals, tail_cols, heavy, n_heavy,
                        heavy_min, v, reg, square, group, out, stream);
}

int dlps_ell_spmv_f32(const void* vals, const int* cols, int64_t m, int k, const int* tail_ptr,
                      const void* tail_vals, const int* tail_cols, const int* heavy,
                      int n_heavy, int heavy_min, const void* v, double reg, int square,
                      int group, void* out, void* stream) {
  return launch<float>(vals, cols, m, k, tail_ptr, tail_vals, tail_cols, heavy, n_heavy,
                       heavy_min, v, reg, square, group, out, stream);
}

}  // extern "C"
