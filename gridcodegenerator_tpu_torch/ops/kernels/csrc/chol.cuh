// Dense Cholesky device functions for one state per thread, templated on the
// value type T and the array size M (a run-time size m ≤ M may be given).
//
// The CUDA counterparts of the (1, B)-entry factor helpers of
// gridcodegenerator_tpu/ops/kernels/contact_fused.py (ported as
// gridcodegenerator_tpu_torch/ops/kernels/contact_fused.py), in their
// summation order:
//   chol_factor    _chol_factor_act: the left-looking column factor in the
//                  lower triangle, L[i][j] = c_i / sqrt(c_j)
//   chol_inverse   _chol_minv_sym: Y = L⁻¹ column by column, then
//                  M⁻¹[i][j] = Σ_{p ≥ j} Y[p][i]·Y[p][j] (i ≤ j)
//   chol_apply     _chol_apply_e: one right-hand side, forward and back
//                  substitution entry by entry
//   chol_solve     _chol_solve_act: a wide right-hand side, column-oriented
//                  forward and back substitution
// Used by the staged K2′ (staged.cuh, M = n) and the multi-dof kernels
// (md.cuh: the k×k joint blocks of ABA, k ≤ 6, and the nv×nv mass matrix).
#pragma once

#ifndef GRID_ROLLED
#define GRID_ROLLED _Pragma("unroll 1")
#endif

namespace grid {

// Factor the lower triangle of A (m×m) in place: A = L·Lᵀ.
template <typename T, int M>
__device__ __forceinline__ void chol_factor(T A[M][M], int m = M) {
GRID_ROLLED
  for (int j = 0; j < m; ++j) {
GRID_ROLLED
    for (int i = j; i < m; ++i) {
      T c = A[i][j];
GRID_ROLLED
      for (int p = 0; p < j; ++p) c = c - A[i][p] * A[j][p];
      A[i][j] = c;
    }
    const T s = sqrt(A[j][j]);
GRID_ROLLED
    for (int i = j; i < m; ++i) A[i][j] = A[i][j] / s;
  }
}

// A's lower triangle holds L: overwrite all of A with (L·Lᵀ)⁻¹.
template <typename T, int M>
__device__ __forceinline__ void chol_inverse(T A[M][M]) {
  T Y[M][M];  // lower triangle of L⁻¹
GRID_ROLLED
  for (int r = 0; r < M; ++r)
GRID_ROLLED
    for (int k = 0; k <= r; ++k) Y[r][k] = (k == r) ? T(1) : T(0);
GRID_ROLLED
  for (int j = 0; j < M; ++j) {
    const T dj = A[j][j];
GRID_ROLLED
    for (int k = 0; k <= j; ++k) Y[j][k] = Y[j][k] / dj;
GRID_ROLLED
    for (int r = j + 1; r < M; ++r) {
      const T Lrj = A[r][j];
GRID_ROLLED
      for (int k = 0; k <= j; ++k) Y[r][k] = Y[r][k] - Lrj * Y[j][k];
    }
  }
GRID_ROLLED
  for (int j = 0; j < M; ++j)
GRID_ROLLED
    for (int i = 0; i <= j; ++i) {
      T acc = Y[j][i] * Y[j][j];
GRID_ROLLED
      for (int p = j + 1; p < M; ++p) acc += Y[p][i] * Y[p][j];
      A[i][j] = acc;
      A[j][i] = acc;
    }
}

// M⁻¹ from the lower triangle of A (destroyed) into the full matrix A.
template <typename T, int M>
__device__ __forceinline__ void chol_minv(T A[M][M]) {
  chol_factor<T, M>(A);
  chol_inverse<T, M>(A);
}

// Solve (L·Lᵀ)·x = r in place (x holds r on entry), L in A's lower
// triangle; each row's terms are summed in ascending order.
template <typename T, int M>
__device__ __forceinline__ void chol_apply(const T L[M][M], T* x,
                                           int m = M) {
GRID_ROLLED
  for (int i = 0; i < m; ++i) {
    T s = x[i];
GRID_ROLLED
    for (int p = 0; p < i; ++p) s = s + (-L[i][p]) * x[p];
    x[i] = s / L[i][i];
  }
GRID_ROLLED
  for (int i = m - 1; i >= 0; --i) {
    T s = x[i];
GRID_ROLLED
    for (int p = i + 1; p < m; ++p) s = s + (-L[p][i]) * x[p];
    x[i] = s / L[i][i];
  }
}

// Solve (L·Lᵀ)·X = B in place for K right-hand sides (X holds B on entry).
template <typename T, int M, int K>
__device__ __forceinline__ void chol_solve(const T L[M][M], T X[M][K]) {
GRID_ROLLED
  for (int j = 0; j < M; ++j) {
    const T dj = L[j][j];
GRID_ROLLED
    for (int k = 0; k < K; ++k) X[j][k] = X[j][k] / dj;
GRID_ROLLED
    for (int r = j + 1; r < M; ++r) {
      const T Lrj = L[r][j];
GRID_ROLLED
      for (int k = 0; k < K; ++k) X[r][k] = X[r][k] - Lrj * X[j][k];
    }
  }
GRID_ROLLED
  for (int j = M - 1; j >= 0; --j) {
    const T dj = L[j][j];
GRID_ROLLED
    for (int k = 0; k < K; ++k) {
      if (j + 1 < M) {
        T corr = L[j + 1][j] * X[j + 1][k];
GRID_ROLLED
        for (int r = j + 2; r < M; ++r) corr += L[r][j] * X[r][k];
        X[j][k] = (X[j][k] - corr) / dj;
      } else {
        X[j][k] = X[j][k] / dj;
      }
    }
  }
}

}  // namespace grid
