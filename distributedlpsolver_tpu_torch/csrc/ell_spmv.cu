// Sliced-ELL sparse matrix-vector product and normal-matrix diagonal for
// the H100 (sm_90a).
//
// Replaces the device routines the JAX package leaves to XLA in
// ops/sparse.py::SparseOperator.matvec / rmatvec / normal_diag (a row-ELL
// gather-reduce plus a COO-tail scatter-add, `.at[].add`). One source, two
// functions, each in f64 and f32:
//
//   ell_spmv:         out[i] = Σ_{entries e of row i} val[e]·v[col[e]]
//   ell_normal_diag:  out[i] = Σ_{entries e of row i} val[e]²·d[col[e]] + reg
//
// matvec runs it on A's layout, rmatvec on Aᵀ's. The layout is the
// kernel's own, built once at setup from the CSR (ops/ell_spmv.py::
// sell_layout); the JAX package's hybrid row-ELL arrays stay beside it for
// the plain version.
//
// What bounds it on the H100: bytes. Each stored entry costs one
// multiply-add against 12 bytes (f64 value + int32 column) plus a gathered
// 8 bytes of v, three orders of magnitude below the card's operations-per-
// byte balance. The least time is the live entries' bytes, one int32 a row
// for the index, v read once and out written once, over 3.35 TB/s. The
// hybrid layout this replaces read 2.4× that on Aᵀ at stormG2_1000's shape
// (one ELL width of 8 over rows holding ~2.1 live entries), and gave each
// of Aᵀ's ~8,700-entry heavy rows a single block.
//
// Design (SELL-C-σ, C = 32, plus chunked heavy rows):
//   * Light rows (at most HEAVY_MIN live entries) are sorted by their live
//     count within windows of σ rows and cut into slices of 32 rows, one
//     warp a slice and one thread a row, with no shuffles. A slice is padded
//     only to its own widest row and stored slot-major, so a warp's loads of
//     one slot are contiguous (256 B of f64 values, 128 B of int32 columns).
//     perm gives the output row of each lane (-1: a pad lane of the last
//     slice). With σ-sorting the pads cost ~1–2% of the entries' bytes.
//   * Heavy rows are cut into chunks of consecutive entries (CHUNK, 32 a
//     lane); a warp sums a chunk (each lane in entry order, then a fixed
//     xor-butterfly) to one partial. A row of one chunk is written at once;
//     for a longer row, the warp that finds (by an integer atomic counter)
//     that it finished the row's chunks last sums the row's partials in
//     chunk order and resets the counter for the next launch. The values
//     are never added with atomics, so every output is summed in one fixed
//     order and two launches give the same bits. (Partials and counters are
//     the layout's scratch: launches on one layout run in stream order.)
//   * The streamed arrays (values, columns, slice offsets, perm, chunk
//     offsets) are read once with cache-streaming loads (__ldcs, evict-
//     first), the gathered vector through the read-only path (__ldg), so v
//     stays resident in the 50 MB L2 (A·v gathers from 10.1 MB, Aᵀ·v from
//     4.2 MB at stormG2_1000's shape) while the ~45 MB stream passes
//     through.
//   * Occupancy over loads in flight a thread: a light slice's warp does
//     little work behind a chain of dependent loads (slice offsets, the
//     slots, the gather, the write), so what hides the latency is many
//     resident warps. The kernel is bounded to 40 registers (six blocks of
//     256 an SM) with up to kSlots slots (kPerLane entries a heavy lane) in
//     flight a round. At stormG2_1000's shape on the H100, both directions
//     were slower without the bound (more registers, more loads in flight
//     a thread), and no faster at 32 registers with 2 in flight.
//   * The heavy chunks' warps come first in the grid, so their chains
//     start in the first wave, beside the first slices. Spreading them
//     evenly over the grid needed 64-bit index arithmetic in every warp and
//     more registers, and was slower. Light rows differ in the last bits
//     from the plain version's order only by the fused multiply-add; heavy
//     rows by the chunked order.
//
// Plain C interface, built by nvcc into a shared library and called
// through ctypes (ops/ell_spmv.py). Each entry point returns the CUDA
// error of its launch (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // warps a block
constexpr int kThreads = 32 * kWarps;
constexpr int kMinBlocks = 6;  // __launch_bounds__'s blocks an SM: ≤ 40 registers
constexpr int kSlots = 4;  // a light row's slots a thread has in flight
constexpr int kPerLane = 4;  // a heavy chunk's entries a lane has in flight
constexpr unsigned kFull = 0xffffffffu;

struct Layout {
  const void* vals;         // slices (slot-major), then the heavy rows' entries
  const int* cols;
  const int* slice_ptr;     // n_slices + 1 entry offsets (32·width apart)
  const int* perm;          // 32·n_slices output rows, -1 for a pad lane
  const int* chunk_ptr;     // n_chunks + 1 entry offsets
  const int* chunk_row;     // n_chunks: the heavy row h of each chunk
  const int* heavy_rows;    // n_heavy: the output row of heavy row h
  const int* heavy_first;   // n_heavy + 1: the first chunk of heavy row h
  int n_slices;
  int n_chunks;
  void* partials;           // n_chunks
  int* counters;            // n_heavy, 0 between launches
  const void* v;
  double reg;
  void* out;
};

template <typename T, bool SQUARE>
__device__ __forceinline__ T term(T a, T x) {
  return SQUARE ? a * a * x : a * x;
}

template <typename T, bool SQUARE>
__device__ __forceinline__ void light_slice(const Layout& L, int s, int lane) {
  const T* vals = static_cast<const T*>(L.vals);
  const T* v = static_cast<const T*>(L.v);
  const int row = __ldcs(L.perm + static_cast<int64_t>(s) * 32 + lane);
  const int lo = __ldcs(L.slice_ptr + s);
  const int w = (__ldcs(L.slice_ptr + s + 1) - lo) >> 5;  // warp-uniform
  const T* pv = vals + lo + lane;
  const int* pc = L.cols + lo + lane;
  T acc = T(0);
  for (int j0 = 0; j0 < w; j0 += kSlots) {
    T a[kSlots], x[kSlots];
    int c[kSlots];
#pragma unroll
    for (int u = 0; u < kSlots; ++u) {
      a[u] = T(0);
      c[u] = 0;
      if (j0 + u < w) {
        a[u] = __ldcs(pv + (j0 + u) * 32);
        c[u] = __ldcs(pc + (j0 + u) * 32);
      }
    }
#pragma unroll
    for (int u = 0; u < kSlots; ++u) x[u] = j0 + u < w ? __ldg(v + c[u]) : T(0);
#pragma unroll
    for (int u = 0; u < kSlots; ++u) {
      if (j0 + u < w) acc += term<T, SQUARE>(a[u], x[u]);
    }
  }
  if (row >= 0) static_cast<T*>(L.out)[row] = acc + T(L.reg);
}

template <typename T, bool SQUARE>
__device__ __forceinline__ void heavy_chunk(const Layout& L, int c, int lane) {
  const T* vals = static_cast<const T*>(L.vals);
  const T* v = static_cast<const T*>(L.v);
  const int lo = __ldcs(L.chunk_ptr + c), hi = __ldcs(L.chunk_ptr + c + 1);
  T acc = T(0);
  for (int b = lo; b < hi; b += 32 * kPerLane) {  // warp-uniform
    T a[kPerLane], x[kPerLane];
    int k[kPerLane];
#pragma unroll
    for (int u = 0; u < kPerLane; ++u) {
      const int e = b + u * 32 + lane;
      a[u] = T(0);
      k[u] = 0;
      if (e < hi) {
        a[u] = __ldcs(vals + e);
        k[u] = __ldcs(L.cols + e);
      }
    }
#pragma unroll
    for (int u = 0; u < kPerLane; ++u) x[u] = b + u * 32 + lane < hi ? __ldg(v + k[u]) : T(0);
#pragma unroll
    for (int u = 0; u < kPerLane; ++u) {
      if (b + u * 32 + lane < hi) acc += term<T, SQUARE>(a[u], x[u]);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(kFull, acc, off);

  const int h = __ldcs(L.chunk_row + c);
  const int first = L.heavy_first[h];
  const int count = L.heavy_first[h + 1] - first;
  const int row = L.heavy_rows[h];
  T* out = static_cast<T*>(L.out);
  if (count == 1) {
    if (lane == 0) out[row] = acc + T(L.reg);
    return;
  }
  T* partials = static_cast<T*>(L.partials);
  int last = 0;
  if (lane == 0) {
    partials[c] = acc;
    __threadfence();  // the partial is visible before the count says so
    last = atomicAdd(L.counters + h, 1) == count - 1;
  }
  if (!__shfl_sync(kFull, last, 0)) return;
  __threadfence();
  // The last warp of the row: its partials in chunk order, read past L1.
  T s = T(0);
  for (int k0 = 0; k0 < count; k0 += 32) {
    const T p = k0 + lane < count ? __ldcg(partials + first + k0 + lane) : T(0);
    const int n = min(32, count - k0);
    for (int j = 0; j < n; ++j) s += __shfl_sync(kFull, p, j);
  }
  if (lane == 0) {
    out[row] = s + T(L.reg);
    L.counters[h] = 0;
  }
}

template <typename T, bool SQUARE>
__global__ void __launch_bounds__(kThreads, kMinBlocks) sell_kernel(const Layout L) {
  const int warp = static_cast<int>(blockIdx.x) * kWarps + static_cast<int>(threadIdx.x) / 32;
  const int lane = static_cast<int>(threadIdx.x) & 31;
  if (warp < L.n_chunks) {
    heavy_chunk<T, SQUARE>(L, warp, lane);
  } else if (warp - L.n_chunks < L.n_slices) {
    light_slice<T, SQUARE>(L, warp - L.n_chunks, lane);
  }
}

// index = [slice_ptr (n_slices + 1) | perm (32·n_slices) | chunk_ptr
// (n_chunks + 1) | chunk_row (n_chunks) | heavy_rows (n_heavy) |
// heavy_first (n_heavy + 1)], int32, as ops/ell_spmv.py::sell_layout packs it.
template <typename T>
int launch(const void* vals, const int* cols, const int* index, int n_slices, int n_chunks,
           int n_heavy, void* partials, int* counters, const void* v, double reg, int square,
           void* out, void* stream) {
  if (n_slices < 0 || n_chunks < 0 || n_heavy < 0 || (n_chunks > 0 && n_heavy == 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t warps = static_cast<int64_t>(n_slices) + n_chunks;
  if (warps == 0) return 0;
  if (warps > (int64_t(1) << 31) - 1 - kWarps) return static_cast<int>(cudaErrorInvalidValue);
  Layout L;
  L.vals = vals;
  L.cols = cols;
  L.slice_ptr = index;
  L.perm = index + (n_slices + 1);
  L.chunk_ptr = L.perm + static_cast<int64_t>(n_slices) * 32;
  L.chunk_row = L.chunk_ptr + (n_chunks + 1);
  L.heavy_rows = L.chunk_row + n_chunks;
  L.heavy_first = L.heavy_rows + n_heavy;
  L.n_slices = n_slices;
  L.n_chunks = n_chunks;
  L.partials = partials;
  L.counters = counters;
  L.v = v;
  L.reg = reg;
  L.out = out;
  const dim3 grid(static_cast<unsigned>((warps + kWarps - 1) / kWarps));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (square) {
    sell_kernel<T, true><<<grid, kThreads, 0, s>>>(L);
  } else {
    sell_kernel<T, false><<<grid, kThreads, 0, s>>>(L);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int dlps_ell_spmv_f64(const void* vals, const int* cols, const int* index, int n_slices,
                      int n_chunks, int n_heavy, void* partials, int* counters, const void* v,
                      double reg, int square, void* out, void* stream) {
  return launch<double>(vals, cols, index, n_slices, n_chunks, n_heavy, partials, counters, v,
                        reg, square, out, stream);
}

int dlps_ell_spmv_f32(const void* vals, const int* cols, const int* index, int n_slices,
                      int n_chunks, int n_heavy, void* partials, int* counters, const void* v,
                      double reg, int square, void* out, void* stream) {
  return launch<float>(vals, cols, index, n_slices, n_chunks, n_heavy, partials, counters, v,
                       reg, square, out, stream);
}

}  // extern "C"
