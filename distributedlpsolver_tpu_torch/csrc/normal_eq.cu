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
// In f32 the CUDA cores' FMAs peak at 67 TFLOP/s too; the TF32 tensor
// cores at 495, and three TF32 passes a product (below) need 3·m·(m+1)·n
// flops there, a bound 2.5 times lower.
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
//     flight together share their A panels in the 50 MB L2.
//   * Split over k, where the triangle cannot fill the card. At 800 rows
//     (the block tier's linking rows) the triangle is 91 tiles against
//     264 block slots, each a reduction over ~46,000 columns. A launch of
//     S > 1 splits gives each tile S blocks, split s summing the s-th
//     contiguous run of k chunks into its own partial tile of a
//     workspace (lanes × S × tiles × 64 × 64 doubles, allocated by the
//     caller); a second kernel, normal_eq_split_sum, adds a tile's S
//     partials in split order and stores the sum mirrored. The order is
//     fixed, so two launches give the same bits; there are no atomics.
//     The caller picks S (ops/normal_eq.py::split_count: the fewest
//     waves for the columns, none under 2,048 columns a split); S = 1 is
//     the unsplit launch, with no workspace and no second kernel.
//
// The f32 design (the forced-PCG preconditioner, the two-phase schedule's
// f32 phases), normal_eq_tf32_kernel, puts f32 on the TF32 tensor cores
// without TF32's ~1e-3 relative error (the trap the TPU kernel's module
// names; the TPU kernel runs its MXU at Precision.HIGHEST, several passes):
//   * 3×TF32 products. Each operand x is split into hi = tf32(x) and
//     lo = tf32(x − hi) (to nearest); a·b is taken as lo_a·hi_b + hi_a·lo_b
//     + hi_a·hi_b, small terms first (mma.sync m16n8k8 tf32, f32
//     accumulate): what it drops, lo_a·lo_b and the residues of the
//     splits, is ~2⁻²² of a·b. The i-side operand is a·d rounded in f32
//     before its split, as the TPU kernel rounds it in its input type.
//   * Blocked sum. The tensor cores' f32 accumulate is not documented to
//     round to nearest, and on this card it leans toward zero: chained
//     over four k steps (twelve mma) it left M's diagonal, a sum of n
//     positive terms, 2.4e-7 low on average, enough to stall the forced
//     PCG at 60×180 (PERF.md). So each k step's three products are summed
//     in fresh fragments (one chain of three mma from zero), added on the
//     CUDA cores into an f32 partial (round to nearest), and the partial
//     is folded into an f64 total every FOLD chunks of KC columns (512
//     columns, the TPU kernel's k block); the total is rounded to f32
//     once, in the store. The diagonal's lean drops to 4.6e-8.
//   * Fed as the f64 design is: a cp.async ring with ragged rows and
//     columns zero-filled by the copy; 16-byte copies (4 floats) where
//     A's base, n and the lane stride allow, else 4-byte copies (two
//     instances, chosen per launch); the k slots permuted so that each
//     fragment load is one 8-byte shared load; the same 64×64 tiles,
//     four warps of 32×32 and two blocks an SM, so that at m = 2048 the
//     528 tiles fill the 264 block slots twice, and the same
//     lower-triangle grid and mirrored store.
//
// The bf16→f32 instance (on no path) keeps true-fp32 FMAs on the CUDA
// cores from a 64×64 tile with 4×4 register micro-tiles and synchronous
// staging, on the same lower-triangle grid and mirrored store; it rounds
// the scaled product A·d to bf16 first, as the TPU kernel does in bf16.
//
// Offsets are 64-bit: m·n reaches 5·10⁸ at the 10000×50000 reference
// shape.
//
// The batch axis (the batched solver: B independent lanes, each its own
// A (m, n), d (n,) and M (m, m)): every instance takes a lane count and
// the lane strides of A and d in elements (0 shares one A or one d
// across the lanes); M's lanes are dense, m·m apart. The lane is
// blockIdx.y, so one launch covers every lane, up to the grid's y-limit
// of 65,535 lanes (more are refused). A block computes one tile of one
// lane: it moves A, d and M to its lane and runs the unbatched kernel's
// code, so a one-lane launch gives the bits it always gave, and lane i of
// a batch gives the bits of a one-lane launch on lane i's inputs (in f64,
// a launch of the same split count). At the
// batched solver's shape (1024 lanes of 128×512) the grid is 3 triangle
// tiles × 1024 lanes: each lane's A (512 KB) is read by its three
// blocks, which are neighbours in the grid and meet in L2, and the
// function is bound by bytes (A read once, 0.54 GB, against 8.7 GFLOP),
// not by DMMA.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <atomic>

namespace {

// ---------------------------------------------------------------------------
// Shared by every instance: the lower-triangle block order, the mirrored
// store, the lane grid, and the asynchronous copies.

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

// Grid of a launch: the triangle tiles (times the k splits) on x, the
// lanes on y. dim3(0, 0, 0) when the blocks overflow x or the lanes y.
constexpr int64_t MAX_LANES = 65535;
__host__ __forceinline__ dim3 lane_grid(int64_t tiles, int64_t batch, int64_t splits = 1) {
  const int64_t tri = triangle_blocks(tiles);
  if (splits < 1 || tri > 0x7fffffffLL / splits || batch > MAX_LANES) return dim3(0, 0, 0);
  return dim3(static_cast<unsigned>(tri * splits), static_cast<unsigned>(batch));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Asynchronous copy of BYTES (4, 8 or 16) from global to shared memory,
// zero-filling what src_bytes leaves out (src_bytes = 0 reads nothing).
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, int src_bytes) {
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(src_bytes));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "n"(BYTES), "r"(src_bytes));
  }
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Above 48 KB of dynamic shared memory a kernel must opt in. That is done
// once per kernel on each device (one bit per device ordinal in `done`),
// not on every launch, so that a launch costs the host no other runtime
// call.
template <typename Kernel>
cudaError_t opt_in_shared_memory(Kernel kernel, size_t bytes, std::atomic<uint64_t>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (bit != 0 && (done.load() & bit) != 0) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

// ---------------------------------------------------------------------------
// f64: DMMA tiles fed by a cp.async ring, split over k where asked.

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
constexpr int SUM_THREADS = 256;          // normal_eq_split_sum's block

static_assert(WM % 16 == 0 && WN % 8 == 0, "warp piece must be whole m16n8 fragments");
static_assert(BM % WARPS_M == 0 && BM % WARPS_N == 0, "warps must tile the block");
static_assert(STAGE % 2 == 0, "stages must stay 16-byte aligned");
static_assert(KC % MK == 0, "k chunk must be whole mma steps");

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

// One block: one lower-triangle tile of one lane. Unsplit (SPLIT false:
// splits = 1, no workspace) over every k chunk, the tile stored mirrored
// into M; split, over split s's k chunks, the partial tile stored whole
// into the workspace. Two instances, so that the unsplit launch keeps its
// own code.
template <int VEC, bool SPLIT>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
normal_eq_dmma_kernel(const double* __restrict__ A, const double* __restrict__ d,
                      double* __restrict__ M, int64_t m, int64_t n, int64_t tiles,
                      int64_t a_stride, int64_t d_stride, int64_t splits,
                      double* __restrict__ work) {
  extern __shared__ __align__(16) double smem[];
  const int64_t member = blockIdx.y;
  A += member * a_stride;
  d += member * d_stride;
  M += member * m * m;
  const int64_t tri = SPLIT ? gridDim.x / splits : gridDim.x;
  const int64_t split = SPLIT ? blockIdx.x / tri : 0;
  const int64_t tb = SPLIT ? blockIdx.x % tri : blockIdx.x;
  int64_t bi, bj;
  tile_of_block(tb, tiles, bi, bj);
  const int64_t i0 = bi * BM, j0 = bj * BM;
  // Split s takes k chunks [first, first + kchunks): a contiguous run.
  int64_t kchunks = (n + KC - 1) / KC, kfirst = 0;
  if constexpr (SPLIT) {
    const int64_t per_split = (kchunks + splits - 1) / splits;
    const int64_t first = split * per_split;
    kchunks = first < kchunks ? (kchunks - first < per_split ? kchunks - first : per_split) : 0;
    kfirst = first * KC;
  }

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
    if (s < kchunks) load_stage<VEC>(smem + s * STAGE, A, d, m, n, i0, j0, kfirst + s * KC);
    cp_async_commit();
  }

  for (int64_t kt = 0; kt < kchunks; ++kt) {
    cp_async_wait<STAGES - 2>();  // chunk kt has landed (this thread's part)
    __syncthreads();              // ... everyone's; and slot kt-1 is free
    const int64_t next = kt + STAGES - 1;
    if (next < kchunks)
      load_stage<VEC>(smem + (next % STAGES) * STAGE, A, d, m, n, i0, j0, kfirst + next * KC);
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

  if constexpr (SPLIT) {  // a partial tile: lane, split, tile, row-major 64×64
    double* P = work + ((member * splits + split) * tri + tb) * (BM * BM);
#pragma unroll
    for (int x = 0; x < MI; ++x)
#pragma unroll
      for (int y = 0; y < NI; ++y) {
        const int r = wi + x * 16 + g, c = wj + y * 8 + 2 * t;
        *reinterpret_cast<double2*>(P + r * BM + c) = make_double2(acc[x][y][0], acc[x][y][1]);
        *reinterpret_cast<double2*>(P + (r + 8) * BM + c) =
            make_double2(acc[x][y][2], acc[x][y][3]);
      }
    return;
  }
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

// The split's second kernel: block (tile tb, lane) adds the tile's
// `splits` partials in split order, ((p₀ + p₁) + p₂) + …, and stores the
// sum mirrored into M.
__global__ void __launch_bounds__(SUM_THREADS)
normal_eq_split_sum(const double* __restrict__ work, double* __restrict__ M, int64_t m,
                    int64_t tiles, int64_t splits) {
  __shared__ double S[BM * LDS_OUT];
  const int64_t member = blockIdx.y, tri = gridDim.x, tb = blockIdx.x;
  int64_t bi, bj;
  tile_of_block(tb, tiles, bi, bj);
  const double* P = work + (member * splits * tri + tb) * (BM * BM);
  const int64_t step = tri * (BM * BM);
  for (int idx = threadIdx.x; idx < BM * BM; idx += SUM_THREADS) {
    double v = P[idx];
    for (int64_t s = 1; s < splits; ++s) v += P[s * step + idx];
    S[(idx / BM) * LDS_OUT + idx % BM] = v;
  }
  __syncthreads();
  store_mirrored<double, BM, SUM_THREADS>(S, LDS_OUT, M + member * m * m, m, bi * BM, bj * BM);
}

int launch_sum(const double* work, double* M, int64_t batch, int64_t m, int64_t splits,
               cudaStream_t stream) {
  const int64_t tiles = (m + BM - 1) / BM;
  const dim3 grid = lane_grid(tiles, batch);
  if (grid.x == 0) return static_cast<int>(cudaErrorInvalidValue);
  normal_eq_split_sum<<<grid, SUM_THREADS, 0, stream>>>(work, M, m, tiles, splits);
  return static_cast<int>(cudaGetLastError());
}

template <int VEC, bool SPLIT>
int launch_vec(const double* A, const double* d, double* M, int64_t batch, int64_t m,
               int64_t n, int64_t a_stride, int64_t d_stride, int64_t splits, double* work,
               cudaStream_t stream) {
  static std::atomic<uint64_t> done{0};
  const cudaError_t err =
      opt_in_shared_memory(normal_eq_dmma_kernel<VEC, SPLIT>, SMEM_BYTES, done);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t tiles = (m + BM - 1) / BM;
  const dim3 grid = lane_grid(tiles, batch, splits);
  if (grid.x == 0) return static_cast<int>(cudaErrorInvalidValue);
  normal_eq_dmma_kernel<VEC, SPLIT><<<grid, THREADS, SMEM_BYTES, stream>>>(
      A, d, M, m, n, tiles, a_stride, d_stride, splits, work);
  const int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0 || !SPLIT) return rc;
  return launch_sum(work, M, batch, m, splits, stream);
}

template <int VEC>
int launch_width(const double* A, const double* d, double* M, int64_t batch, int64_t m,
                 int64_t n, int64_t a_stride, int64_t d_stride, int64_t splits, double* work,
                 cudaStream_t stream) {
  if (splits == 1)
    return launch_vec<VEC, false>(A, d, M, batch, m, n, a_stride, d_stride, 1, nullptr, stream);
  return launch_vec<VEC, true>(A, d, M, batch, m, n, a_stride, d_stride, splits, work, stream);
}

int launch(const void* A, const void* d, void* M, int64_t batch, int64_t m, int64_t n,
           int64_t a_stride, int64_t d_stride, int64_t splits, void* work, void* stream) {
  if (batch <= 0 || m <= 0 || n < 0 || a_stride < 0 || d_stride < 0 || splits < 1 ||
      (splits > 1) != (work != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const double* a = static_cast<const double*>(A);
  const double* dd = static_cast<const double*>(d);
  double* out = static_cast<double*>(M);
  double* w = static_cast<double*>(work);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 16-byte copies need every row and chunk start of every lane 16-byte
  // aligned: the base, n and the lane stride (an odd m·n puts every odd
  // lane 8 bytes off) all even in doubles. One width for the whole launch.
  if (reinterpret_cast<uintptr_t>(A) % 16 == 0 && n % 2 == 0 && a_stride % 2 == 0)
    return launch_width<16>(a, dd, out, batch, m, n, a_stride, d_stride, splits, w, s);
  return launch_width<8>(a, dd, out, batch, m, n, a_stride, d_stride, splits, w, s);
}

}  // namespace dmma

// ---------------------------------------------------------------------------
// f32: 3×TF32 products on the tensor cores, a blocked sum.

namespace tf32 {

constexpr int BM = 64;                 // output tile edge (square)
constexpr int WARPS_M = 2, WARPS_N = 2;
constexpr int THREADS = 32 * WARPS_M * WARPS_N;
constexpr int MIN_BLOCKS = 2;          // blocks an SM must hold (registers ≤ 255)
constexpr int WM = BM / WARPS_M, WN = BM / WARPS_N;  // a warp's piece
constexpr int MI = WM / 16, NI = WN / 8;             // its m16n8 fragments
constexpr int KC = 32;                               // k columns per stage: one chunk
constexpr int MK = 8;                                // k depth of one mma
// Row stride (floats) such that the 16 lanes of a half warp, loading 8
// bytes each at row g, k 2t, hit distinct banks: 40·g mod 32 = 0, 8, 16, 24.
constexpr int LDK = KC + 8;
constexpr int STAGES = 4;
constexpr int STAGE = 2 * BM * LDK + KC;  // floats: i rows, j rows, d
constexpr int FOLD = 16;                  // chunks in an f32 partial: 512 columns
constexpr int LDS_OUT = BM + 1;           // epilogue tile stride (odd)
constexpr int SMEM_FLOATS =
    STAGES * STAGE > BM * LDS_OUT ? STAGES * STAGE : BM * LDS_OUT;
constexpr size_t SMEM_BYTES = sizeof(float) * SMEM_FLOATS;

static_assert(WM % 16 == 0 && WN % 8 == 0, "warp piece must be whole m16n8 fragments");
static_assert(BM % WARPS_M == 0 && BM % WARPS_N == 0, "warps must tile the block");
static_assert(STAGE % 4 == 0, "stages must stay 16-byte aligned");
static_assert(KC % MK == 0 && KC <= THREADS, "k chunk must be whole mma steps");

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from
// zero: cvt.rna.tf32.f32's value for every finite x, in two integer
// operations (half a TF32 unit added to the magnitude's bits, the low 13
// dropped), where cvt.rna lowers to a longer compare-and-select sequence
// on sm_90a (1.01 against 1.17 ms at 2048×10240, PERF.md).
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo + (a residue of ~2⁻²² x); x − hi is exact in f32.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(__fsub_rn(x, __uint_as_float(hi)));
}

// D += A·B on one m16n8k8 TF32 fragment, f32 accumulate.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Stage k columns [k0, k0 + KC) of the i-panel, the j-panel and d.
template <int VEC>
__device__ __forceinline__ void load_stage(float* st, const float* __restrict__ A,
                                           const float* __restrict__ d, int64_t m, int64_t n,
                                           int64_t i0, int64_t j0, int64_t k0) {
  constexpr int PER = VEC / 4;      // floats per copy
  constexpr int CPR = KC / PER;     // copies per row
  constexpr int TOTAL = 2 * BM * CPR;
  static_assert(TOTAL % THREADS == 0, "copies must split evenly over the threads");
#pragma unroll
  for (int c0 = 0; c0 < TOTAL; c0 += THREADS) {
    const int c = c0 + static_cast<int>(threadIdx.x);
    const int rr = c / CPR, q = c % CPR;
    const int r = rr < BM ? rr : rr - BM;
    const int64_t row = (rr < BM ? i0 : j0) + r;
    const int64_t k = k0 + q * PER;
    const bool ok = row < m && k < n;  // PER = 4 only when n is a multiple of 4
    cp_async<VEC>(st + rr * LDK + q * PER, ok ? A + row * n + k : A, ok ? VEC : 0);
  }
  if (threadIdx.x < KC) {
    const int64_t k = k0 + threadIdx.x;
    const bool ok = k < n;
    cp_async<4>(st + 2 * BM * LDK + threadIdx.x, ok ? d + k : d, ok ? 4 : 0);
  }
}

template <int VEC>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
normal_eq_tf32_kernel(const float* __restrict__ A, const float* __restrict__ d,
                      float* __restrict__ M, int64_t m, int64_t n, int64_t tiles,
                      int64_t a_stride, int64_t d_stride) {
  extern __shared__ __align__(16) float smem_f[];
  const int64_t member = blockIdx.y;
  A += member * a_stride;
  d += member * d_stride;
  M += member * m * m;
  int64_t bi, bj;
  tile_of_block(blockIdx.x, tiles, bi, bj);
  const int64_t i0 = bi * BM, j0 = bj * BM;
  const int64_t kchunks = (n + KC - 1) / KC;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;  // fragment row group, thread in group
  const int wi = (warp / WARPS_N) * WM, wj = (warp % WARPS_N) * WN;

  float acc[MI][NI][4];    // one k step, on the tensor cores
  float part[MI][NI][4];   // up to FOLD chunks' k steps, f32 round to nearest
  double total[MI][NI][4]; // the folded partials
#pragma unroll
  for (int a = 0; a < MI; ++a)
#pragma unroll
    for (int b = 0; b < NI; ++b)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[a][b][e] = 0.0f;
        part[a][b][e] = 0.0f;
        total[a][b][e] = 0.0;
      }

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < kchunks) load_stage<VEC>(smem_f + s * STAGE, A, d, m, n, i0, j0, s * KC);
    cp_async_commit();
  }

  for (int64_t kt = 0; kt < kchunks; ++kt) {
    cp_async_wait<STAGES - 2>();  // chunk kt has landed (this thread's part)
    __syncthreads();              // ... everyone's; and slot kt-1 is free
    const int64_t next = kt + STAGES - 1;
    if (next < kchunks)
      load_stage<VEC>(smem_f + (next % STAGES) * STAGE, A, d, m, n, i0, j0, next * KC);
    cp_async_commit();

    const float* Ai = smem_f + (kt % STAGES) * STAGE;
    const float* Aj = Ai + BM * LDK;
    const float* ds = Aj + BM * LDK;
#pragma unroll
    for (int kb = 0; kb < KC; kb += MK) {
      // Lane (g, t) holds k slots t and t + 4, at k = kb + 2t and kb + 2t + 1.
      const float2 dv = *reinterpret_cast<const float2*>(ds + kb + 2 * t);
      uint32_t ah[MI][4], al[MI][4], bh[NI][2], bl[NI][2];
#pragma unroll
      for (int x = 0; x < MI; ++x) {
        const float* p = Ai + (wi + x * 16 + g) * LDK + kb + 2 * t;
        const float2 r0 = *reinterpret_cast<const float2*>(p);
        const float2 r8 = *reinterpret_cast<const float2*>(p + 8 * LDK);
        split(__fmul_rn(r0.x, dv.x), ah[x][0], al[x][0]);  // (row g,   slot t)
        split(__fmul_rn(r8.x, dv.x), ah[x][1], al[x][1]);  // (row g+8, slot t)
        split(__fmul_rn(r0.y, dv.y), ah[x][2], al[x][2]);  // (row g,   slot t + 4)
        split(__fmul_rn(r8.y, dv.y), ah[x][3], al[x][3]);  // (row g+8, slot t + 4)
      }
#pragma unroll
      for (int y = 0; y < NI; ++y) {
        const float2 v =
            *reinterpret_cast<const float2*>(Aj + (wj + y * 8 + g) * LDK + kb + 2 * t);
        split(v.x, bh[y][0], bl[y][0]);  // (slot t,     column g)
        split(v.y, bh[y][1], bl[y][1]);  // (slot t + 4, column g)
      }
#pragma unroll
      for (int x = 0; x < MI; ++x)
#pragma unroll
        for (int y = 0; y < NI; ++y) {
          mma(acc[x][y], al[x], bh[y]);
          mma(acc[x][y], ah[x], bl[y]);
          mma(acc[x][y], ah[x], bh[y]);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            part[x][y][e] = __fadd_rn(part[x][y][e], acc[x][y][e]);
            acc[x][y][e] = 0.0f;
          }
        }
    }
    // The partial into the f64 total.
    const bool fold = (kt + 1) % FOLD == 0 || kt + 1 == kchunks;
#pragma unroll
    for (int x = 0; x < MI; ++x)
#pragma unroll
      for (int y = 0; y < NI; ++y)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (fold) {
            total[x][y][e] += static_cast<double>(part[x][y][e]);
            part[x][y][e] = 0.0f;
          }
        }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: reuse it for the output tile

  float* S = smem_f;
#pragma unroll
  for (int x = 0; x < MI; ++x)
#pragma unroll
    for (int y = 0; y < NI; ++y) {
      const int r = wi + x * 16 + g, c = wj + y * 8 + 2 * t;
      S[r * LDS_OUT + c] = __double2float_rn(total[x][y][0]);
      S[r * LDS_OUT + c + 1] = __double2float_rn(total[x][y][1]);
      S[(r + 8) * LDS_OUT + c] = __double2float_rn(total[x][y][2]);
      S[(r + 8) * LDS_OUT + c + 1] = __double2float_rn(total[x][y][3]);
    }
  __syncthreads();
  store_mirrored<float, BM, THREADS>(S, LDS_OUT, M, m, i0, j0);
}

template <int VEC>
int launch_vec(const float* A, const float* d, float* M, int64_t batch, int64_t m, int64_t n,
               int64_t a_stride, int64_t d_stride, cudaStream_t stream) {
  static std::atomic<uint64_t> done{0};
  const cudaError_t err = opt_in_shared_memory(normal_eq_tf32_kernel<VEC>, SMEM_BYTES, done);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t tiles = (m + BM - 1) / BM;
  const dim3 grid = lane_grid(tiles, batch);
  if (grid.x == 0) return static_cast<int>(cudaErrorInvalidValue);
  normal_eq_tf32_kernel<VEC><<<grid, THREADS, SMEM_BYTES, stream>>>(A, d, M, m, n, tiles,
                                                                  a_stride, d_stride);
  return static_cast<int>(cudaGetLastError());
}

int launch(const void* A, const void* d, void* M, int64_t batch, int64_t m, int64_t n,
           int64_t a_stride, int64_t d_stride, void* stream) {
  if (batch <= 0 || m <= 0 || n < 0 || a_stride < 0 || d_stride < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* a = static_cast<const float*>(A);
  const float* dd = static_cast<const float*>(d);
  float* out = static_cast<float*>(M);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 16-byte copies need every row and chunk start of every lane 16-byte
  // aligned: the base, n and the lane stride all multiples of 4 floats.
  if (reinterpret_cast<uintptr_t>(A) % 16 == 0 && n % 4 == 0 && a_stride % 4 == 0)
    return launch_vec<16>(a, dd, out, batch, m, n, a_stride, d_stride, s);
  return launch_vec<4>(a, dd, out, batch, m, n, a_stride, d_stride, s);
}

}  // namespace tf32

// ---------------------------------------------------------------------------
// bf16→f32: CUDA-core FMAs, lower-triangle tiles.

namespace fp32 {

constexpr int TILE = 64;     // output tile edge (rows of A per block side)
constexpr int KCHUNK = 16;   // k elements staged per loop trip
constexpr int THREADS = 256; // 16 × 16 threads, 4×4 outputs each
constexpr int MICRO = 4;
constexpr int PAD = 1;       // shared-memory row pad against bank conflicts

// Scaled element a·d in f32, rounded as the TPU kernel rounds it: in bf16.
__device__ __forceinline__ float scaled(__nv_bfloat16 a, __nv_bfloat16 dk) {
  return __bfloat162float(__float2bfloat16(__bfloat162float(a) * __bfloat162float(dk)));
}

__global__ void __launch_bounds__(THREADS)
normal_eq_fma_kernel(const __nv_bfloat16* __restrict__ A, const __nv_bfloat16* __restrict__ d,
                     float* __restrict__ M, int64_t m, int64_t n, int64_t tiles,
                     int64_t a_stride, int64_t d_stride) {
  __shared__ float Ai[KCHUNK][TILE + PAD];  // A[i-tile, k-chunk]·d, k-major
  __shared__ float Aj[KCHUNK][TILE + PAD];  // A[j-tile, k-chunk], k-major
  __shared__ float S[TILE][TILE + 1];       // the output tile, for the store

  const int64_t member = blockIdx.y;
  A += member * a_stride;
  d += member * d_stride;
  M += member * m * m;

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

  const __nv_bfloat16 zero = __float2bfloat16(0.0f);
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
      const __nv_bfloat16 dk = kin ? d[k] : zero;
      const int64_t gi = i0 + row;
      const int64_t gj = j0 + row;
      const __nv_bfloat16 ai = (kin && gi < m) ? A[gi * n + k] : zero;
      const __nv_bfloat16 aj = (kin && gj < m) ? A[gj * n + k] : zero;
      Ai[kk][row] = scaled(ai, dk);
      Aj[kk][row] = __bfloat162float(aj);
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

int launch(const void* A, const void* d, void* M, int64_t batch, int64_t m, int64_t n,
           int64_t a_stride, int64_t d_stride, void* stream) {
  if (batch <= 0 || m <= 0 || n < 0 || a_stride < 0 || d_stride < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t tiles = (m + TILE - 1) / TILE;
  const dim3 grid = lane_grid(tiles, batch);
  if (grid.x == 0) return static_cast<int>(cudaErrorInvalidValue);
  normal_eq_fma_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(A), static_cast<const __nv_bfloat16*>(d),
      static_cast<float*>(M), m, n, tiles, a_stride, d_stride);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fp32

}  // namespace

// Plain C entry points (ctypes). Each computes ``batch`` lanes, lane i
// from A + i·a_stride and d + i·d_stride (strides in elements, 0 = shared)
// into M + i·m·m, in one launch on ``stream`` (in f64 with splits > 1,
// two: the partial tiles into ``work``, then their sum into M), without
// synchronising or allocating, and returns the CUDA error code (0 =
// launched): of the shared-memory opt-in, or cudaGetLastError();
// cudaErrorInvalidValue for more than MAX_LANES lanes, splits < 1, or a
// workspace given with splits = 1 or missing with splits > 1.
extern "C" {

// ``work``: batch · splits · T·(T+1)/2 · 64 · 64 doubles (T = ceil(m/64))
// when splits > 1, else null.
int dlps_normal_eq_f64(const void* A, const void* d, void* M, int64_t batch, int64_t m,
                       int64_t n, int64_t a_stride, int64_t d_stride, int64_t splits,
                       void* work, void* stream) {
  return dmma::launch(A, d, M, batch, m, n, a_stride, d_stride, splits, work, stream);
}

// The split's second kernel alone, on partial tiles already in ``work``.
int dlps_normal_eq_f64_split_sum(const void* work, void* M, int64_t batch, int64_t m,
                                 int64_t splits, void* stream) {
  if (batch <= 0 || m <= 0 || splits < 1 || work == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return dmma::launch_sum(static_cast<const double*>(work), static_cast<double*>(M), batch, m,
                          splits, static_cast<cudaStream_t>(stream));
}

int dlps_normal_eq_f32(const void* A, const void* d, void* M, int64_t batch, int64_t m,
                       int64_t n, int64_t a_stride, int64_t d_stride, void* stream) {
  return tf32::launch(A, d, M, batch, m, n, a_stride, d_stride, stream);
}

int dlps_normal_eq_bf16_f32(const void* A, const void* d, void* M, int64_t batch, int64_t m,
                            int64_t n, int64_t a_stride, int64_t d_stride, void* stream) {
  return fp32::launch(A, d, M, batch, m, n, a_stride, d_stride, stream);
}

// Output tile edge of an instance (0: f64, 1: f32, 2: bf16→f32): the work
// it issues is T·(T+1)/2 tiles of edge² outputs, T = ceil(m / edge).
int dlps_normal_eq_tile(int which) {
  return which == 0 ? dmma::BM : which == 1 ? tf32::BM : fp32::TILE;
}

// Blocks an SM must hold of an instance (its __launch_bounds__ minimum;
// 0: f64, 1: f32, 2: bf16→f32): the split chooser plans with f64's.
int dlps_normal_eq_min_blocks(int which) {
  return which == 0 ? dmma::MIN_BLOCKS : which == 1 ? tf32::MIN_BLOCKS : 1;
}

}  // extern "C"
