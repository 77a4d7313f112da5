// Native CPU kernels for the LP solver's hot path:
//   normal-equations assembly  M = A·diag(d)·Aᵀ  (+ relative diag reg),
//   blocked dense Cholesky, and triangular solves.
//
// The reference's CPU baseline sits on native (LAPACK-class) kernels under
// its linear-algebra layer (SURVEY.md §2.1); this file is the rebuild's
// honest analogue so the measured CPU baseline is real native code, not a
// NumPy stand-in. OpenMP threads play the role of the reference's
// 8 CPU ranks for the embarrassingly parallel assembly (BASELINE.json:5).
//
// Build: distributedlpsolver_tpu_torch/native/build.py (g++ -O3 -fopenmp).
// ABI: plain C, consumed via ctypes (no pybind11 in this image).

#include <cmath>
#include <cstring>
#include <algorithm>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {
constexpr int kBlock = 64;  // Cholesky panel width / GEMM tile
}

extern "C" {

// M (m×m, row-major) = A·diag(d)·Aᵀ with M[i,i] *= (1+relreg).
// A is m×n row-major; scratch must hold m*n doubles (holds A·diag(d)).
void dlps_normal_eq(const double* A, const double* d, int m, int n,
                    double relreg, double* scratch, double* M) {
  // B = A·diag(d)
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int i = 0; i < m; ++i) {
    const double* ai = A + (size_t)i * n;
    double* bi = scratch + (size_t)i * n;
    for (int k = 0; k < n; ++k) bi[k] = ai[k] * d[k];
  }
  // M = B·Aᵀ, upper triangle, tiled over (i, j) blocks.
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic)
#endif
  for (int ib = 0; ib < m; ib += kBlock) {
    const int iend = std::min(ib + kBlock, m);
    for (int jb = ib; jb < m; jb += kBlock) {
      const int jend = std::min(jb + kBlock, m);
      for (int i = ib; i < iend; ++i) {
        const double* bi = scratch + (size_t)i * n;
        for (int j = std::max(jb, i); j < jend; ++j) {
          const double* aj = A + (size_t)j * n;
          double acc = 0.0;
          for (int k = 0; k < n; ++k) acc += bi[k] * aj[k];
          M[(size_t)i * m + j] = acc;
        }
      }
    }
  }
  // mirror + relative diagonal regularization
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int i = 0; i < m; ++i) {
    M[(size_t)i * m + i] *= (1.0 + relreg);
    for (int j = i + 1; j < m; ++j) M[(size_t)j * m + i] = M[(size_t)i * m + j];
  }
}

// In-place lower Cholesky of the m×m row-major SPD matrix M (the strict
// upper triangle is left untouched). Returns 0 on success, or 1-based
// index of the first non-positive pivot.
int dlps_cholesky(double* M, int m) {
  for (int kb = 0; kb < m; kb += kBlock) {
    const int kend = std::min(kb + kBlock, m);
    // Factor the diagonal block (unblocked).
    for (int k = kb; k < kend; ++k) {
      double pivot = M[(size_t)k * m + k];
      for (int p = kb; p < k; ++p) {
        const double v = M[(size_t)k * m + p];
        pivot -= v * v;
      }
      if (pivot <= 0.0 || !std::isfinite(pivot)) return k + 1;
      pivot = std::sqrt(pivot);
      M[(size_t)k * m + k] = pivot;
      const double inv = 1.0 / pivot;
#ifdef _OPENMP
#pragma omp parallel for schedule(static) if (m - kend > 256)
#endif
      for (int i = k + 1; i < m; ++i) {
        double v = M[(size_t)i * m + k];
        for (int p = kb; p < k; ++p)
          v -= M[(size_t)i * m + p] * M[(size_t)k * m + p];
        M[(size_t)i * m + k] = v * inv;
      }
    }
    // Trailing update: M[i,j] -= Σ_{p∈panel} L[i,p]·L[j,p] for j ≥ kend.
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic)
#endif
    for (int ib = kend; ib < m; ib += kBlock) {
      const int iend2 = std::min(ib + kBlock, m);
      for (int i = ib; i < iend2; ++i) {
        for (int j = kend; j <= i; ++j) {
          double acc = 0.0;
          const double* li = M + (size_t)i * m;
          const double* lj = M + (size_t)j * m;
          for (int p = kb; p < kend; ++p) acc += li[p] * lj[p];
          M[(size_t)i * m + j] -= acc;
        }
      }
    }
    // Keep lower-triangular convention for the trailing block: values were
    // written at [i, j] with j ≤ i — already lower. Nothing to mirror.
  }
  return 0;
}

// Solve L·Lᵀ·out = rhs with the lower factor produced by dlps_cholesky.
void dlps_cho_solve(const double* L, const double* rhs, int m, double* out) {
  // forward: L y = rhs
  for (int i = 0; i < m; ++i) {
    double v = rhs[i];
    const double* li = L + (size_t)i * m;
    for (int j = 0; j < i; ++j) v -= li[j] * out[j];
    out[i] = v / li[i];
  }
  // backward: Lᵀ x = y
  for (int i = m - 1; i >= 0; --i) {
    double v = out[i];
    for (int j = i + 1; j < m; ++j) v -= L[(size_t)j * m + i] * out[j];
    out[i] = v / L[(size_t)i * m + i];
  }
}

int dlps_num_threads() {
#ifdef _OPENMP
  return omp_get_max_threads();
#else
  return 1;
#endif
}

}  // extern "C"
