// Device functions of the staged large-robot pipeline, one state per thread.
//
// The CUDA counterpart of the stage bodies of
// gridcodegenerator_tpu/ops/kernels/staged.py (ported as
// gridcodegenerator_tpu_torch/ops/kernels/staged.py):
//   vaf_state<kBiasV>   K1, bias_and_v_staged (staged.py:172): c and v
//   vaf_state<kAF>      K4, fd_grad_staged's body_af (staged.py:453): a, f
//                       at the true q̈ with v reused
//   vaf_state<kVAF>     id_grad_staged's body_vaf (staged.py:341): v, a, f
//   minv_dense_state    K2′, minv_qdd_dense_staged (staged.py:218): CRBA,
//                       the active-region column Cholesky, L⁻ᵀL⁻¹
//                       (chol.cuh) and,
//                       with a right-hand side, q̈ = M⁻¹·rhs
//   grad_cols_state     K5, body_grad of id_grad_staged / fd_grad_staged
//                       (staged.py:356, :470): rnea_grad_cols_bl for one
//                       column block, both sides, with or without the fused
//                       −M⁻¹·∂c finish over the block's nonzero rows
// Staged tensors are batch-last: v, a, f are (6, n, B), element (r, i) of
// state b at (r·n + i)·B + b; M⁻¹ and the gradients are (n, n, B).
//
// Every sum runs in the order of the plain PyTorch version (blops.crba_bl,
// blops.rnea_grad_cols_bl, contact_fused._chol_*); nvcc's FMA contraction
// is the only difference in rounding. Joint and column loops stay rolled
// (rbd.cuh), and the ∂-tensors of one column block are the only arrays
// that grow with the block width GRID_CB.
#pragma once

#include <cuda_bf16.h>

#include "rbd.cuh"
#include "chol.cuh"

#ifndef GRID_CB
#error "compile with -DGRID_CB=<the K5 column-block width>"
#endif
#ifndef GRID_MINV_CB
#error "compile with -DGRID_MINV_CB=<the K3 column-block width>"
#endif

namespace grid {

constexpr int CB = GRID_CB;
constexpr int MINV_CB = GRID_MINV_CB;

// A staged input read in the compute type T: of T, or of bf16 where s16
// (stage_dtype=torch.bfloat16), upcast exactly in registers. One kernel
// serves both storage types: the flag is uniform across a launch.
template <typename T>
__device__ __forceinline__ T load_stage(const void* x, bool s16,
                                        long long k) {
  return s16 ? static_cast<T>(
                   __bfloat162float(static_cast<const __nv_bfloat16*>(x)[k]))
             : static_cast<const T*>(x)[k];
}

// a staged (6, n, B) tensor (load_vec6's layout) into T
template <typename T>
__device__ __forceinline__ void load_stage6(const void* x, bool s16,
                                            long long B, long long b,
                                            T out[N][6]) {
GRID_ROLLED
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int r = 0; r < 6; ++r)
      out[i][r] = load_stage<T>(x, s16, (r * N + i) * B + b);
}

// ------------------------------------------------------------ K1, K4, vaf
enum VafMode { kBiasV = 0, kAF = 1, kVAF = 2 };

// kBiasV: q, q̇ → c (n,B), v (6,n,B)          (bias RNEA, damping in c)
// kAF:    q, q̇, q̈, v → a, f (6,n,B)         (v reused; f summed to root)
// kVAF:   q, q̇, q̈ → v, a, f (6,n,B)         (f summed to root)
template <typename T, int kMode>
__device__ __forceinline__ void vaf_state(const Robot<T>& R, const T* q,
                                          const T* qd, const T* qdd,
                                          const void* v_in, bool s16,
                                          T* c_out, T* v_out,
                                          T* a_out, T* f_out, long long B,
                                          long long b, T minus_g) {
  T qs[N], qds[N], qdds[N];
  load_col(q, B, b, qs);
  load_col(qd, B, b, qds);
  if (kMode != kBiasV) load_col(qdd, B, b, qdds);
  T X[N][36];
  joint_transforms(R, qs, X);
  T v[N][6], a[N][6], f[N][6];
  if (kMode == kAF) load_stage6(v_in, s16, B, b, v);
  rnea_fwd<T, kMode != kBiasV, kMode == kAF>(R, X, qds, qdds, minus_g, v, a,
                                             f);
  if (kMode == kBiasV) {
    T c[N];
    rnea_bwd<T, true, false>(R, X, f, qds, nullptr, c);
GRID_ROLLED
    for (int i = 0; i < N; ++i) c_out[i * B + b] = c[i];
    store_vec6(v, B, b, v_out);
  } else {
    rnea_bwd<T, false, false>(R, X, f, qds, nullptr, nullptr);
    if (kMode == kVAF) store_vec6(v, B, b, v_out);
    store_vec6(a, B, b, a_out);
    store_vec6(f, B, b, f_out);
  }
}

// ------------------------------------------------------------------- K2′
// CRBA (blops.crba_bl): M + diag(armature) into the lower triangle of A,
// zero where two joints share no root path (other trees of a forest too).
template <typename T>
__device__ __forceinline__ void crba(const Robot<base_t<T>>& R,
                                     const T X[N][36], T A[N][N]) {
  T IC[N][36];
GRID_ROLLED
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int e = 0; e < 36; ++e) IC[i][e] = R.I[36 * i + e];
GRID_ROLLED
    for (int j = 0; j <= i; ++j) A[i][j] = T(0);
  }
  // IC_p += X_iᵀ·(IC_i·X_i), leaves to root
GRID_ROLLED
  for (int i = N - 1; i >= 0; --i) {
    const int p = parent(i);
    if (p < 0) continue;
    T ICX[36];
#pragma unroll
    for (int r = 0; r < 6; ++r)
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        T acc = IC[i][r * 6] * X[i][k];
#pragma unroll
        for (int c = 1; c < 6; ++c) acc += IC[i][r * 6 + c] * X[i][c * 6 + k];
        ICX[r * 6 + k] = acc;
      }
#pragma unroll
    for (int r = 0; r < 6; ++r)
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        T acc = X[i][r] * ICX[k];
#pragma unroll
        for (int c = 1; c < 6; ++c) acc += X[i][c * 6 + r] * ICX[c * 6 + k];
        IC[p][r * 6 + k] = IC[p][r * 6 + k] + acc;
      }
  }
GRID_ROLLED
  for (int i = 0; i < N; ++i) {
    const auto* S = R.S + 6 * i;
    T F[6];
#pragma unroll
    for (int r = 0; r < 6; ++r) {
      T acc = IC[i][r * 6] * S[0];
#pragma unroll
      for (int c = 1; c < 6; ++c) acc += IC[i][r * 6 + c] * S[c];
      F[r] = acc;
    }
    T d = S[0] * F[0];
#pragma unroll
    for (int c = 1; c < 6; ++c) d += S[c] * F[c];
    A[i][i] = d + R.armature[i];
    // walk up the root path: F ← X_jᵀ·F, M[i][parent] = S_parentᵀ·F
    int j = i;
    while (parent(j) >= 0) {
      T t[6];
      matvec6_T(X[j], F, t);
#pragma unroll
      for (int r = 0; r < 6; ++r) F[r] = t[r];
      j = parent(j);
      const auto* Sj = R.S + 6 * j;
      T val = Sj[0] * F[0];
#pragma unroll
      for (int c = 1; c < 6; ++c) val += Sj[c] * F[c];
      A[i][j] = val;
    }
  }
}

// dense M⁻¹(q) (n,n,B) and, with kRhs, q̈ = M⁻¹·rhs (n,B)
template <typename T, bool kRhs>
__device__ __forceinline__ void minv_dense_state(const Robot<T>& R,
                                                 const T* q, const T* rhs,
                                                 T* M_out, T* qdd_out,
                                                 long long B, long long b) {
  T qs[N];
  load_col(q, B, b, qs);
  T A[N][N];
  {
    T X[N][36];
    joint_transforms(R, qs, X);
    crba(R, X, A);
  }
  chol_minv<T, N>(A);
  store_mat(A, B, b, M_out);
  if (kRhs) {
    T r[N];
    load_col(rhs, B, b, r);
GRID_ROLLED
    for (int i = 0; i < N; ++i) {
      T acc = A[i][0] * r[0];
GRID_ROLLED
      for (int j = 1; j < N; ++j) acc += A[i][j] * r[j];
      qdd_out[i * B + b] = acc;
    }
  }
}

// CRBA + Cholesky M⁻¹ into the full matrix M — fused.py's _dense_minv_bl,
// the M⁻¹ stage of fd_grad_state<T, true> (declared in rbd.cuh)
template <typename T>
__device__ __forceinline__ void dense_minv(const Robot<base_t<T>>& R,
                                           const T X[N][36], T M[N][N]) {
  crba(R, X, M);
  chol_minv<T, N>(M);
}

// q̈ by factor and solve — fd_dense_staged: bias RNEA, CRBA, the column
// Cholesky, one forward and back substitution; M⁻¹ is never formed
template <typename T>
__device__ __forceinline__ void fd_dense_state(const Robot<T>& R, const T* q,
                                               const T* qd, const T* u,
                                               T* qdd_out, long long B,
                                               long long b, T minus_g) {
  T qs[N], qds[N], us[N], c[N];
  load_col(q, B, b, qs);
  load_col(qd, B, b, qds);
  load_col(u, B, b, us);
  T X[N][36];
  joint_transforms(R, qs, X);
  {
    T v[N][6], a[N][6], f[N][6];
    rnea_fwd<T, false, false>(R, X, qds, nullptr, minus_g, v, a, f);
    rnea_bwd<T, true, false>(R, X, f, qds, nullptr, c);
  }
  T A[N][N];
  crba(R, X, A);
  chol_factor<T, N>(A);
  T x[N][1];
GRID_ROLLED
  for (int i = 0; i < N; ++i) x[i][0] = us[i] - c[i];
  chol_solve<T, N, 1>(A, x);
GRID_ROLLED
  for (int i = 0; i < N; ++i) qdd_out[i * B + b] = x[i][0];
}

// K2″ — minv_qdd_af_dense_staged: K2′ with q̈ = M⁻¹·(u − c) kept in
// registers, then K4's sweep (a, f at that q̈, the staged v reused)
template <typename T>
__device__ __forceinline__ void minv_af_state(const Robot<T>& R, const T* q,
                                              const T* qd, const T* umc,
                                              const T* v_in, T* M_out,
                                              T* a_out, T* f_out,
                                              long long B, long long b,
                                              T minus_g) {
  T qs[N], qds[N], r[N], qdd[N];
  load_col(q, B, b, qs);
  load_col(qd, B, b, qds);
  load_col(umc, B, b, r);
  T X[N][36];
  joint_transforms(R, qs, X);
  {
    T A[N][N];
    dense_minv(R, X, A);
    store_mat(A, B, b, M_out);
GRID_ROLLED
    for (int i = 0; i < N; ++i) {
      T acc = A[i][0] * r[0];
GRID_ROLLED
      for (int j = 1; j < N; ++j) acc += A[i][j] * r[j];
      qdd[i] = acc;
    }
  }
  T v[N][6], a[N][6], f[N][6];
  load_vec6(v_in, B, b, v);
  rnea_fwd<T, true, true>(R, X, qds, qdd, minus_g, v, a, f);
  rnea_bwd<T, false, false>(R, X, f, qds, nullptr, nullptr);
  store_vec6(a, B, b, a_out);
  store_vec6(f, B, b, f_out);
}

// ------------------------------------------------------------------ K2, K3
// K2 — minv_staged's body_ud (blops.minv_UD_bl): the backward IA sweep of
// minv() alone; U (6, n, B), D⁻¹ (n, B)
template <typename T>
__device__ __forceinline__ void minv_ud_state(const Robot<T>& R, const T* q,
                                              T* U_out, T* Dinv_out,
                                              long long B, long long b) {
  T qs[N];
  load_col(q, B, b, qs);
  T X[N][36];
  joint_transforms(R, qs, X);
  T IA[N][36], U[N][6];
GRID_ROLLED
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 36; ++e) IA[i][e] = R.I[36 * i + e];
GRID_ROLLED
  for (int i = N - 1; i >= 0; --i) {
    const int p = parent(i);
    const auto* S = R.S + 6 * i;
#pragma unroll
    for (int r = 0; r < 6; ++r) {
      T acc = IA[i][r * 6] * S[0];
#pragma unroll
      for (int c = 1; c < 6; ++c) acc += IA[i][r * 6 + c] * S[c];
      U[i][r] = acc;
    }
    T d = S[0] * U[i][0];
#pragma unroll
    for (int c = 1; c < 6; ++c) d += S[c] * U[i][c];
    const T Di = T(1) / (d + R.armature[i]);
    Dinv_out[i * B + b] = Di;
    if (p < 0) continue;
    // IA_p += Xᵀ·(IA_i − U·D⁻¹·Uᵀ)·X
    T Ia[36], IaX[36];
#pragma unroll
    for (int r = 0; r < 6; ++r)
#pragma unroll
      for (int c = 0; c < 6; ++c)
        Ia[r * 6 + c] = IA[i][r * 6 + c] - U[i][r] * (Di * U[i][c]);
#pragma unroll
    for (int r = 0; r < 6; ++r)
#pragma unroll
      for (int c = 0; c < 6; ++c) {
        T acc = Ia[r * 6] * X[i][c];
#pragma unroll
        for (int k = 1; k < 6; ++k) acc += Ia[r * 6 + k] * X[i][k * 6 + c];
        IaX[r * 6 + c] = acc;
      }
#pragma unroll
    for (int r = 0; r < 6; ++r)
#pragma unroll
      for (int c = 0; c < 6; ++c) {
        T acc = X[i][r] * IaX[c];
#pragma unroll
        for (int k = 1; k < 6; ++k) acc += X[i][k * 6 + r] * IaX[k * 6 + c];
        IA[p][r * 6 + c] += acc;
      }
  }
  store_vec6(U, B, b, U_out);
}

// K3 — minv_staged's body_cols (blops.minv_cols_bl): columns [c0, c0 + w)
// of the upper-triangular M⁻¹ rows from K2's U and D⁻¹, w ≤ MINV_CB; F
// holds 6·n·MINV_CB values and the rows n·MINV_CB. Writes M[i][c0 + k]
// of the (n, n, B) output for every row i (entries below the diagonal as
// the first sweep leaves them: densify_rows drops them).
template <typename T>
__device__ __forceinline__ void minv_cols_state(const Robot<T>& R,
                                                const T* q, const T* U_in,
                                                const T* Dinv_in, T* M_out,
                                                long long B, long long b,
                                                int c0, int w) {
  T qs[N], Dinv[N];
  load_col(q, B, b, qs);
  load_col(Dinv_in, B, b, Dinv);
  T X[N][36];
  joint_transforms(R, qs, X);
  T U[N][6];
  load_vec6(U_in, B, b, U);
  T F[N][6][MINV_CB], rows[N][MINV_CB];
GRID_ROLLED
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int r = 0; r < 6; ++r)
GRID_ROLLED
      for (int k = 0; k < w; ++k) F[i][r][k] = T(0);
  // row = e_i·D⁻¹ − D⁻¹·SᵀF; F_i += U·row; F_p += X_iᵀ·F_i (leaves to root)
GRID_ROLLED
  for (int i = N - 1; i >= 0; --i) {
    const int p = parent(i);
    const auto* S = R.S + 6 * i;
    const T Di = Dinv[i];
GRID_ROLLED
    for (int k = 0; k < w; ++k) {
      T sf = S[0] * F[i][0][k];
#pragma unroll
      for (int c = 1; c < 6; ++c) sf += S[c] * F[i][c][k];
      rows[i][k] = (c0 + k == i ? Di : T(0)) - Di * sf;
    }
    if (p < 0) continue;
GRID_ROLLED
    for (int k = 0; k < w; ++k) {
      T Fi[6];
#pragma unroll
      for (int r = 0; r < 6; ++r) {
        Fi[r] = F[i][r][k] + U[i][r] * rows[i][k];
        F[i][r][k] = Fi[r];
      }
      T t[6];
      matvec6_T(X[i], Fi, t);
#pragma unroll
      for (int r = 0; r < 6; ++r) F[p][r][k] = F[p][r][k] + t[r];
    }
  }
  // root to leaves, the columns at or right of the diagonal only
GRID_ROLLED
  for (int i = 0; i < N; ++i) {
    const int p = parent(i);
    const auto* S = R.S + 6 * i;
    T UX[6];
    if (p >= 0) matvec6_T(X[i], U[i], UX);
GRID_ROLLED
    for (int k = 0; k < w; ++k) {
      if (c0 + k < i) continue;
      T Fp[6];
      if (p >= 0) {
#pragma unroll
        for (int c = 0; c < 6; ++c) Fp[c] = F[p][c][k];
        T corr = UX[0] * Fp[0];
#pragma unroll
        for (int c = 1; c < 6; ++c) corr += UX[c] * Fp[c];
        rows[i][k] = rows[i][k] - Dinv[i] * corr;
      }
      const T row = rows[i][k];
      T XF[6];
      if (p >= 0) matvec6(X[i], Fp, XF);
#pragma unroll
      for (int r = 0; r < 6; ++r)
        F[i][r][k] = p >= 0 ? S[r] * row + XF[r] : S[r] * row;
    }
  }
GRID_ROLLED
  for (int i = 0; i < N; ++i)
GRID_ROLLED
    for (int k = 0; k < w; ++k) M_out[(i * N + c0 + k) * B + b] = rows[i][k];
}

// ------------------------------------------------------------------- K5
// One side of rnea_grad_cols_bl for the columns [c0, c0 + w), w ≤ W (the
// arrays' width: CB for K5, SO_CB for the dual-number T5 of so.cuh):
// kQ → ∂c/∂q, else ∂c/∂q̇ (damping on the diagonal). Writes the rows
// dc[i][k] and has_df[i] (false where the row is structurally zero: joint
// i outside ancestors ∪ subtree of the block). dv, da, df are scratch.
template <typename T, bool kQ, int W = CB>
__device__ __forceinline__ void grad_cols_side(
    const Robot<base_t<T>>& R, const T X[N][36], const T* qd,
    const T v[N][6], const T a[N][6], const T f[N][6], T minus_g, int c0,
    int w, const bool in_sub[N], T dv[N][6][W], T da[N][6][W],
    T df[N][6][W], bool has_df[N], T dc[N][W]) {
GRID_ROLLED
  for (int i = 0; i < N; ++i) {
    has_df[i] = in_sub[i];
    if (!in_sub[i]) continue;
    const int p = parent(i);
    const auto* S = R.S + 6 * i;
    const auto* I = R.I + 36 * i;
    const bool has_p = p >= 0 && in_sub[p];
    const int ki = i - c0;  // direction i's column; in the block if < w
    const bool in_block = ki >= 0 && ki < w;  // the seeds enter only there
    // ---- ∂v_i = X_i·∂v_p, + seed into column i
    T seed[6];
    if (in_block && kQ) {
      T Xv[6];
      if (p >= 0) {
        matvec6(X[i], v[p], Xv);
      } else {
#pragma unroll
        for (int r = 0; r < 6; ++r) Xv[r] = T(0);
      }
      T t[6];
      crm_apply(S, Xv, t);
#pragma unroll
      for (int r = 0; r < 6; ++r) seed[r] = -t[r];
    } else if (in_block) {
#pragma unroll
      for (int r = 0; r < 6; ++r) seed[r] = S[r];
    }
GRID_ROLLED
    for (int k = 0; k < w; ++k)
#pragma unroll
      for (int r = 0; r < 6; ++r) {
        T val = T(0);
        if (has_p) {
          val = X[i][r * 6] * dv[p][0][k];
#pragma unroll
          for (int c = 1; c < 6; ++c) val += X[i][r * 6 + c] * dv[p][c][k];
        }
        if (k == ki) val = val + seed[r];
        dv[i][r][k] = val;
      }
    // ---- ∂a_i = X_i·∂a_p − q̇_i·(S×∂v_i), + seed into column i
    T seed2[6];
    if (in_block) {
      T base[6], t[6];
      if (kQ) {
        if (p >= 0) {
          matvec6(X[i], a[p], base);
        } else {
#pragma unroll
          for (int r = 0; r < 6; ++r) base[r] = X[i][r * 6 + 5] * minus_g;
        }
        crm_apply(S, base, t);
      } else {
        crm_apply(S, v[i], t);
      }
#pragma unroll
      for (int r = 0; r < 6; ++r) seed2[r] = -t[r];
    }
GRID_ROLLED
    for (int k = 0; k < w; ++k) {
      T col[6], t[6];
#pragma unroll
      for (int r = 0; r < 6; ++r) col[r] = dv[i][r][k];
      crm_apply(S, col, t);
#pragma unroll
      for (int r = 0; r < 6; ++r) {
        T val = T(0);
        if (has_p) {
          val = X[i][r * 6] * da[p][0][k];
#pragma unroll
          for (int c = 1; c < 6; ++c) val += X[i][r * 6 + c] * da[p][c][k];
        }
        val = val - qd[i] * t[r];
        if (k == ki) val = val + seed2[r];
        da[i][r][k] = val;
      }
    }
    // ---- ∂f_i = crf(∂v)·Iv + crf(v)·(I·∂v) + I·∂a
    T Iv[6];
    matvec6(I, v[i], Iv);
GRID_ROLLED
    for (int k = 0; k < w; ++k) {
      T dvc[6], dac[6], A1[6], Idv[6], A2[6], A3[6];
#pragma unroll
      for (int r = 0; r < 6; ++r) {
        dvc[r] = dv[i][r][k];
        dac[r] = da[i][r][k];
      }
      crf_apply(dvc, Iv, A1);
      matvec6(I, dvc, Idv);
      crf_apply(v[i], Idv, A2);
      matvec6(I, dac, A3);
#pragma unroll
      for (int r = 0; r < 6; ++r) df[i][r][k] = (A1[r] + A2[r]) + A3[r];
    }
  }
  // ---- backward: ∂f_p += X_iᵀ·∂f_i (+ X_iᵀ·(S ×* f_i) into column i, q side)
GRID_ROLLED
  for (int i = N - 1; i >= 0; --i) {
    const int p = parent(i);
    if (p < 0) continue;
    const int ki = i - c0;
    const bool sow = kQ && ki >= 0 && ki < w;
    if (!has_df[i] && !sow) continue;
    if (has_df[i]) {
GRID_ROLLED
      for (int k = 0; k < w; ++k)
#pragma unroll
        for (int r = 0; r < 6; ++r) {
          T acc = X[i][r] * df[i][0][k];
#pragma unroll
          for (int c = 1; c < 6; ++c) acc += X[i][c * 6 + r] * df[i][c][k];
          df[p][r][k] = has_df[p] ? df[p][r][k] + acc : acc;
        }
    } else if (!has_df[p]) {
GRID_ROLLED
      for (int k = 0; k < w; ++k)
#pragma unroll
        for (int r = 0; r < 6; ++r) df[p][r][k] = T(0);
    }
    has_df[p] = true;
    if (sow) {
      T sxf[6], t[6];
      crf_apply(R.S + 6 * i, f[i], sxf);
      matvec6_T(X[i], sxf, t);
#pragma unroll
      for (int r = 0; r < 6; ++r) df[p][r][ki] = df[p][r][ki] + t[r];
    }
  }
  // ---- rows dc_i = S_iᵀ·∂f_i (+ damping_i at column i, q̇ side)
GRID_ROLLED
  for (int i = 0; i < N; ++i) {
    if (!has_df[i]) continue;
    const auto* S = R.S + 6 * i;
GRID_ROLLED
    for (int k = 0; k < w; ++k) {
      T acc = S[0] * df[i][0][k];
#pragma unroll
      for (int r = 1; r < 6; ++r) acc += S[r] * df[i][r][k];
      if (!kQ && k == i - c0) acc = acc + R.damping[i];
      dc[i][k] = acc;
    }
  }
}

// Column block [c0, c0 + w) of both sides. kFinish: out = −M⁻¹·∂c over the
// block's nonzero rows only (ascending, as staged.py:484-490), M⁻¹ read
// from the staged (n,n,B) tensor once for both sides; else out = ∂c, zero
// rows included. Outputs are (n,n,B); this block writes its w columns.
template <typename T, bool kFinish>
__device__ __forceinline__ void grad_cols_state(
    const Robot<T>& R, const T* q, const T* qd, const void* v_in,
    const void* a_in, const void* f_in, const void* Minv, bool s16,
    T* dq_out, T* dqd_out, long long B, long long b, int c0, int w,
    int sides, T minus_g) {
  T qs[N], qds[N];
  load_col(q, B, b, qs);
  load_col(qd, B, b, qds);
  T X[N][36];
  joint_transforms(R, qs, X);
  T v[N][6], a[N][6], f[N][6];
  load_stage6(v_in, s16, B, b, v);
  load_stage6(a_in, s16, B, b, a);
  load_stage6(f_in, s16, B, b, f);
  bool in_sub[N];
GRID_ROLLED
  for (int i = 0; i < N; ++i) {
    const int p = parent(i);
    in_sub[i] = (i >= c0 && i < c0 + w) || (p >= 0 && in_sub[p]);
  }
  T dv[N][6][CB], da[N][6][CB], df[N][6][CB];
  bool has_row[N], has_qd[N];
  T dcq[N][CB], dcqd[N][CB];
  // sides: bit 0 ∂c/∂q, bit 1 ∂c/∂q̇ (merge_sides=False launches one each)
  const bool sq = sides & 1, sqd = sides & 2;
  if (sq)
    grad_cols_side<T, true>(R, X, qds, v, a, f, minus_g, c0, w, in_sub, dv,
                            da, df, has_row, dcq);
  if (sqd)
    grad_cols_side<T, false>(R, X, qds, v, a, f, minus_g, c0, w, in_sub, dv,
                             da, df, has_qd, dcqd);
  if (kFinish) {
    // both sides share one nonzero row set (ancestors ∪ subtree)
    const bool* has = sq ? has_row : has_qd;
GRID_ROLLED
    for (int r = 0; r < N; ++r) {
      T accq[CB], accqd[CB];
      bool first = true;
GRID_ROLLED
      for (int i = 0; i < N; ++i) {
        if (!has[i]) continue;
        const T m = load_stage<T>(Minv, s16, (r * N + i) * B + b);
GRID_ROLLED
        for (int k = 0; k < w; ++k) {
          if (sq) accq[k] = first ? m * dcq[i][k] : accq[k] + m * dcq[i][k];
          if (sqd)
            accqd[k] = first ? m * dcqd[i][k] : accqd[k] + m * dcqd[i][k];
        }
        first = false;
      }
GRID_ROLLED
      for (int k = 0; k < w; ++k) {
        if (sq) dq_out[(r * N + c0 + k) * B + b] = -accq[k];
        if (sqd) dqd_out[(r * N + c0 + k) * B + b] = -accqd[k];
      }
    }
  } else {
GRID_ROLLED
    for (int i = 0; i < N; ++i)
GRID_ROLLED
      for (int k = 0; k < w; ++k) {
        if (sq) dq_out[(i * N + c0 + k) * B + b] = has_row[i] ? dcq[i][k] : T(0);
        if (sqd)
          dqd_out[(i * N + c0 + k) * B + b] = has_qd[i] ? dcqd[i][k] : T(0);
      }
  }
}

}  // namespace grid
