// Normal-equations assembly M = A·diag(d)·Aᵀ for the H100 (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel ops/normal_eq.py::_ne_kernel
// (driven by normal_eq_pallas). A is (m, n) row-major, d is (n,), M is
// (m, m) row-major and symmetric. Built with nvcc into a shared library
// with a plain C interface and called through ctypes (ops/normal_eq.py).
//
// What bounds it on the H100: M is symmetric, so the function needs
// m·(m+1)·n flops (its lower triangle) against reading A once (m·n
// elements); at the IPM's shapes (m in the thousands) that is arithmetic,
// not bytes. In f64 the arithmetic peak is the FP64 tensor cores (DMMA,
// 67 TFLOP/s); plain DFMAs on the CUDA cores reach half of that at best.
//
// The f64 design (the main path's instance), normal_eq_dmma_kernel:
//   * Lower-triangle tiles. The 1-D grid walks only the tile pairs
//     bi ≥ bj, T·(T+1)/2 blocks for T tiles a side. Each block writes its
//     tile's entries with i ≥ j and their mirror images, staged through
//     shared memory so that both stores are coalesced; a diagonal tile
//     mirrors its own lower half. Every pair M[i][j], M[j][i] is written
//     from one value, so M is symmetric bit for bit, and the work halves.
//   * DMMA. mma.sync m16n8k8 f64 (sm_90): each warp owns a WM×WN piece
//     of the tile as (WM/16)·(WN/8) accumulator fragments. Within each
//     8-deep k step the k slots are permuted (slot t ↔ k 2t, slot t+4 ↔
//     k 2t+1) for both operands, so every fragment load is one 16-byte
//     shared load; the sum over k is unchanged by the permutation.
//     A·d is rounded in f64 as the TPU kernel rounds it in its input
//     type: the i-side fragment is multiplied by d as it is loaded, and
//     A·diag(d) never exists in device memory.
//   * cp.async ring. STAGES k-chunks of KC columns (A rows of both tiles
//     and d) are in flight in dynamic shared memory while the tensor
//     cores work on the oldest; ragged rows and columns are zero-filled
//     by the copy itself (src-size 0), so no padded copy of A exists.
//     The copy width is 16 bytes where A's address and n allow it, else
//     8 bytes (odd n, or A not 16-byte aligned): two instances of the
//     same kernel, chosen per launch.
//   * Block order and waves. A 64×64 tile, four warps of 32×32 (2×4
//     fragments each, 64 accumulator registers), four stages of 16
//     columns (98,816 bytes of shared memory) and at most 255 registers
//     a thread fit two blocks on an SM: at m = 2048 the 528 triangle
//     tiles fill the 264 block slots twice over, exactly, and at
//     m = 10000 the 12403 tiles take 47 waves. Larger tiles spill at two
//     blocks an SM, or at one block leave the card half idle in the last
//     of two waves at m = 2048 (PERF.md). Blocks are numbered in groups of
//     GROUP block-rows, column-major inside a group, so that blocks in
//     flight together share their A panels in the 50 MB L2. No split
//     over k: each block owns its tile, and the result is the same from
//     run to run.
//
// The f32 and bf16→f32 instances (off the main path) keep true-fp32 FMAs
// on the CUDA cores (never TF32, whose ~1e-3 relative error is the trap
// the TPU kernel's module names) from a 64×64 tile with 4×4 register
// micro-tiles and synchronous staging, on the same lower-triangle grid
// and mirrored store. bf16 rounds the scaled product A·d to bf16 first,
// as the TPU kernel does in bf16.
//
// Offsets are 64-bit: m·n reaches 5·10⁸ at the 10000×50000 reference
// shape.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <atomic>

namespace {

// ---------------------------------------------------------------------------
// Shared by every instance: the lower-triangle block order and the
// mirrored store.

// Block rows per group of the block order (see tile_of_block).
constexpr int64_t GROUP = 8;

// Block b of the lower triangle of T×T tiles → (bi, bj), bj ≤ bi. Blocks
// come in groups of GROUP block-rows; inside a group, column by column
// (each column top to bottom), so that consecutive blocks share the
// j-panel and a group's blocks share its GROUP i-panels.
__device__ __forceinline__ void tile_of_block(int64_t b, int64_t T, int64_t& bi,
                                              int64_t& bj) {
  // Triangle row of b in row-major order: r·(r+1)/2 ≤ b < (r+1)·(r+2)/2.
  int64_t r = static_cast<int64_t>((sqrt(8.0 * static_cast<double>(b) + 1.0) - 1.0) * 0.5);
  while (r * (r + 1) / 2 > b) --r;
  while ((r + 1) * (r + 2) / 2 <= b) ++r;
  const int64_t r0 = (r / GROUP) * GROUP;  // first row of the group
  const int64_t h = (T < r0 + GROUP ? T : r0 + GROUP) - r0;  // rows in the group
  int64_t l = b - r0 * (r0 + 1) / 2;                        // index inside the group
  if (l < r0 * h) {  // columns left of the group's diagonal: full height h
    bj = l / h;
    bi = r0 + l % h;
    return;
  }
  l -= r0 * h;  // the group's own small triangle, column c holds h - c rows
  int64_t c = 0;
  while (l >= h - c) {
    l -= h - c;
    ++c;
  }
  bj = r0 + c;
  bi = r0 + c + l;
}

// Writes the BM×BM tile S (row stride lds, rows i0.., columns j0..) into
// M: entry (i, j) where i ≥ j, and its mirror (j, i) where i > j. Both
// loops walk M along a row, so the stores are coalesced; lds is odd so
// the column-wise shared reads of the second loop are free of bank
// conflicts.
template <typename Acc, int BM, int THREADS>
__device__ __forceinline__ void store_mirrored(const Acc* S, int lds, Acc* M, int64_t m,
                                               int64_t i0, int64_t j0) {
  for (int idx = threadIdx.x; idx < BM * BM; idx += THREADS) {
    const int r = idx / BM, c = idx % BM;
    const int64_t i = i0 + r, j = j0 + c;
    if (i < m && j <= i) M[i * m + j] = S[r * lds + c];
  }
  for (int idx = threadIdx.x; idx < BM * BM; idx += THREADS) {
    const int c = idx / BM, r = idx % BM;
    const int64_t i = i0 + r, j = j0 + c;
    if (i < m && j < i) M[j * m + i] = S[r * lds + c];
  }
}

__host__ __forceinline__ int64_t triangle_blocks(int64_t tiles) {
  return tiles * (tiles + 1) / 2;
}

// ---------------------------------------------------------------------------
// f64: DMMA tiles fed by a cp.async ring.

namespace dmma {

constexpr int BM = 64;                 // output tile edge (square)
constexpr int WARPS_M = 2, WARPS_N = 2;
constexpr int THREADS = 32 * WARPS_M * WARPS_N;
constexpr int MIN_BLOCKS = 2;          // blocks an SM must hold (registers ≤ 255)
constexpr int WM = BM / WARPS_M, WN = BM / WARPS_N;  // a warp's piece
constexpr int MI = WM / 16, NI = WN / 8;             // its m16n8 fragments
constexpr int KC = 16;                               // k columns per stage
constexpr int MK = 8;                                // k depth of one mma
// Row stride (doubles) such that the 8 lanes of a quarter warp, loading
// 16 bytes each at row g, k 2t, hit distinct banks.
constexpr int LDK = KC + 8;
constexpr int STAGES = 4;
constexpr int STAGE = 2 * BM * LDK + KC;  // doubles: i rows, j rows, d
constexpr int LDS_OUT = BM + 1;           // epilogue tile stride (odd)
constexpr int SMEM_DOUBLES =
    STAGES * STAGE > BM * LDS_OUT ? STAGES * STAGE : BM * LDS_OUT;
constexpr size_t SMEM_BYTES = sizeof(double) * SMEM_DOUBLES;

static_assert(WM % 16 == 0 && WN % 8 == 0, "warp piece must be whole m16n8 fragments");
static_assert(BM % WARPS_M == 0 && BM % WARPS_N == 0, "warps must tile the block");
static_assert(STAGE % 2 == 0, "stages must stay 16-byte aligned");
static_assert(KC % MK == 0, "k chunk must be whole mma steps");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Asynchronous copy of VEC bytes, zero-filling what src_bytes leaves out
// (src_bytes = 0 reads nothing).
template <int VEC>
__device__ __forceinline__ void cp_async(double* dst, const double* src, int src_bytes) {
  if constexpr (VEC == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(src_bytes));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(src_bytes));
  }
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// D += A·B on one m16n8k8 f64 fragment (FP64 tensor cores).
__device__ __forceinline__ void mma(double (&c)[4], const double (&a)[4],
                                    const double (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

// Stage k columns [k0, k0 + KC) of the i-panel, the j-panel and d.
template <int VEC>
__device__ __forceinline__ void load_stage(double* st, const double* __restrict__ A,
                                           const double* __restrict__ d, int64_t m,
                                           int64_t n, int64_t i0, int64_t j0, int64_t k0) {
  constexpr int PER = VEC / 8;      // doubles per copy
  constexpr int CPR = KC / PER;     // copies per row
  constexpr int TOTAL = 2 * BM * CPR;
#pragma unroll
  for (int c0 = 0; c0 < TOTAL; c0 += THREADS) {
    const int c = c0 + static_cast<int>(threadIdx.x);
    if (TOTAL % THREADS != 0 && c >= TOTAL) break;
    const int rr = c / CPR, q = c % CPR;
    const int r = rr < BM ? rr : rr - BM;
    const int64_t row = (rr < BM ? i0 : j0) + r;
    const int64_t k = k0 + q * PER;
    const bool ok = row < m && k < n;  // PER = 2 only when n is even
    cp_async<VEC>(st + rr * LDK + q * PER, ok ? A + row * n + k : A, ok ? VEC : 0);
  }
  if (threadIdx.x < KC) {
    const int64_t k = k0 + threadIdx.x;
    const bool ok = k < n;
    cp_async<8>(st + 2 * BM * LDK + threadIdx.x, ok ? d + k : d, ok ? 8 : 0);
  }
}

template <int VEC>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
normal_eq_dmma_kernel(const double* __restrict__ A, const double* __restrict__ d,
                      double* __restrict__ M, int64_t m, int64_t n, int64_t tiles) {
  extern __shared__ __align__(16) double smem[];
  int64_t bi, bj;
  tile_of_block(blockIdx.x, tiles, bi, bj);
  const int64_t i0 = bi * BM, j0 = bj * BM;
  const int64_t kchunks = (n + KC - 1) / KC;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;  // fragment row group, thread in group
  const int wi = (warp / WARPS_N) * WM, wj = (warp % WARPS_N) * WN;

  double acc[MI][NI][4];
#pragma unroll
  for (int a = 0; a < MI; ++a)
#pragma unroll
    for (int b = 0; b < NI; ++b)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][b][e] = 0.0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < kchunks) load_stage<VEC>(smem + s * STAGE, A, d, m, n, i0, j0, s * KC);
    cp_async_commit();
  }

  for (int64_t kt = 0; kt < kchunks; ++kt) {
    cp_async_wait<STAGES - 2>();  // chunk kt has landed (this thread's part)
    __syncthreads();              // ... everyone's; and slot kt-1 is free
    const int64_t next = kt + STAGES - 1;
    if (next < kchunks)
      load_stage<VEC>(smem + (next % STAGES) * STAGE, A, d, m, n, i0, j0, next * KC);
    cp_async_commit();

    const double* Ai = smem + (kt % STAGES) * STAGE;
    const double* Aj = Ai + BM * LDK;
    const double* ds = Aj + BM * LDK;
#pragma unroll
    for (int kb = 0; kb < KC; kb += MK) {
      // Lane (g, t) holds k slots t and t + 4, at k = kb + 2t and kb + 2t + 1.
      const double2 dv = *reinterpret_cast<const double2*>(ds + kb + 2 * t);
      double a[MI][4], b[NI][2];
#pragma unroll
      for (int x = 0; x < MI; ++x) {
        const double* p = Ai + (wi + x * 16 + g) * LDK + kb + 2 * t;
        const double2 lo = *reinterpret_cast<const double2*>(p);
        const double2 hi = *reinterpret_cast<const double2*>(p + 8 * LDK);
        a[x][0] = lo.x * dv.x;  // (row g,   slot t)
        a[x][1] = hi.x * dv.x;  // (row g+8, slot t)
        a[x][2] = lo.y * dv.y;  // (row g,   slot t + 4)
        a[x][3] = hi.y * dv.y;  // (row g+8, slot t + 4)
      }
#pragma unroll
      for (int y = 0; y < NI; ++y) {
        const double* p = Aj + (wj + y * 8 + g) * LDK + kb + 2 * t;
        const double2 v = *reinterpret_cast<const double2*>(p);
        b[y][0] = v.x;  // (slot t,     column g)
        b[y][1] = v.y;  // (slot t + 4, column g)
      }
#pragma unroll
      for (int x = 0; x < MI; ++x)
#pragma unroll
        for (int y = 0; y < NI; ++y) mma(acc[x][y], a[x], b[y]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: reuse it for the output tile

  double* S = smem;
#pragma unroll
  for (int x = 0; x < MI; ++x)
#pragma unroll
    for (int y = 0; y < NI; ++y) {
      const int r = wi + x * 16 + g, c = wj + y * 8 + 2 * t;
      S[r * LDS_OUT + c] = acc[x][y][0];
      S[r * LDS_OUT + c + 1] = acc[x][y][1];
      S[(r + 8) * LDS_OUT + c] = acc[x][y][2];
      S[(r + 8) * LDS_OUT + c + 1] = acc[x][y][3];
    }
  __syncthreads();
  store_mirrored<double, BM, THREADS>(S, LDS_OUT, M, m, i0, j0);
}

// Above 48 KB of dynamic shared memory a kernel must opt in. That is done
// once per instance on each device (one bit per device ordinal), not on
// every launch, so that a launch costs the host no other runtime call.
template <int VEC>
cudaError_t opt_in_shared_memory() {
  static std::atomic<uint64_t> done{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (bit != 0 && (done.load() & bit) != 0) return cudaSuccess;
  err = cudaFuncSetAttribute(normal_eq_dmma_kernel<VEC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(SMEM_BYTES));
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

template <int VEC>
int launch_vec(const double* A, const double* d, double* M, int64_t m, int64_t n,
               cudaStream_t stream) {
  const cudaError_t err = opt_in_shared_memory<VEC>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t tiles = (m + BM - 1) / BM;
  const int64_t blocks = triangle_blocks(tiles);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  normal_eq_dmma_kernel<VEC><<<static_cast<unsigned>(blocks), THREADS, SMEM_BYTES, stream>>>(
      A, d, M, m, n, tiles);
  return static_cast<int>(cudaGetLastError());
}

int launch(const void* A, const void* d, void* M, int64_t m, int64_t n, void* stream) {
  if (m <= 0 || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  const double* a = static_cast<const double*>(A);
  const double* dd = static_cast<const double*>(d);
  double* out = static_cast<double*>(M);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 16-byte copies need every row and chunk start 16-byte aligned.
  if (reinterpret_cast<uintptr_t>(A) % 16 == 0 && n % 2 == 0)
    return launch_vec<16>(a, dd, out, m, n, s);
  return launch_vec<8>(a, dd, out, m, n, s);
}

}  // namespace dmma

// ---------------------------------------------------------------------------
// f32 and bf16→f32: CUDA-core FMAs, lower-triangle tiles.

namespace fp32 {

constexpr int TILE = 64;     // output tile edge (rows of A per block side)
constexpr int KCHUNK = 16;   // k elements staged per loop trip
constexpr int THREADS = 256; // 16 × 16 threads, 4×4 outputs each
constexpr int MICRO = 4;
constexpr int PAD = 1;       // shared-memory row pad against bank conflicts

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

template <typename In>
__global__ void __launch_bounds__(THREADS)
normal_eq_fma_kernel(const In* __restrict__ A, const In* __restrict__ d,
                     float* __restrict__ M, int64_t m, int64_t n, int64_t tiles) {
  __shared__ float Ai[KCHUNK][TILE + PAD];  // A[i-tile, k-chunk]·d, k-major
  __shared__ float Aj[KCHUNK][TILE + PAD];  // A[j-tile, k-chunk], k-major
  __shared__ float S[TILE][TILE + 1];       // the output tile, for the store

  const int t = threadIdx.x;
  const int tx = t % 16;
  const int ty = t / 16;
  int64_t bi, bj;
  tile_of_block(blockIdx.x, tiles, bi, bj);
  const int64_t i0 = bi * TILE;
  const int64_t j0 = bj * TILE;

  float acc[MICRO][MICRO];
#pragma unroll
  for (int r = 0; r < MICRO; ++r)
#pragma unroll
    for (int c = 0; c < MICRO; ++c) acc[r][c] = 0.0f;

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
      Ai[kk][row] = scaled<In, float>(ai, dk);
      Aj[kk][row] = widen<In, float>(aj);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KCHUNK; ++kk) {
      float a[MICRO], b[MICRO];
#pragma unroll
      for (int r = 0; r < MICRO; ++r) a[r] = Ai[kk][ty + 16 * r];
#pragma unroll
      for (int c = 0; c < MICRO; ++c) b[c] = Aj[kk][tx + 16 * c];
#pragma unroll
      for (int r = 0; r < MICRO; ++r)
#pragma unroll
        for (int c = 0; c < MICRO; ++c) acc[r][c] = __fmaf_rn(a[r], b[c], acc[r][c]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < MICRO; ++r)
#pragma unroll
    for (int c = 0; c < MICRO; ++c) S[ty + 16 * r][tx + 16 * c] = acc[r][c];
  __syncthreads();
  store_mirrored<float, TILE, THREADS>(&S[0][0], TILE + 1, M, m, i0, j0);
}

template <typename In>
int launch(const void* A, const void* d, void* M, int64_t m, int64_t n, void* stream) {
  if (m <= 0 || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t tiles = (m + TILE - 1) / TILE;
  const int64_t blocks = triangle_blocks(tiles);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  normal_eq_fma_kernel<In><<<static_cast<unsigned>(blocks), THREADS, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const In*>(A), static_cast<const In*>(d), static_cast<float*>(M), m, n,
      tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fp32

}  // namespace

// Plain C entry points (ctypes). Each launches on ``stream`` without
// synchronising or allocating and returns the CUDA error code (0 =
// launched): of the shared-memory opt-in, or cudaGetLastError().
extern "C" {

int dlps_normal_eq_f64(const void* A, const void* d, void* M, int64_t m, int64_t n,
                       void* stream) {
  return dmma::launch(A, d, M, m, n, stream);
}

int dlps_normal_eq_f32(const void* A, const void* d, void* M, int64_t m, int64_t n,
                       void* stream) {
  return fp32::launch<float>(A, d, M, m, n, stream);
}

int dlps_normal_eq_bf16_f32(const void* A, const void* d, void* M, int64_t m, int64_t n,
                            void* stream) {
  return fp32::launch<__nv_bfloat16>(A, d, M, m, n, stream);
}

// Output tile edge of an instance (0: f64, 1: f32, 2: bf16→f32): the work
// it issues is T·(T+1)/2 tiles of edge² outputs, T = ceil(m / edge).
int dlps_normal_eq_tile(int which) { return which == 0 ? dmma::BM : fp32::TILE; }

}  // extern "C"
