// Device functions of the staged multi-dof pipeline, one state per thread.
//
// The CUDA counterpart of the stage bodies of
// gridcodegenerator_tpu/ops/kernels/multidof_staged.py (ported as
// gridcodegenerator_tpu_torch/ops/kernels/multidof_staged.py):
//   md_vaf_state        K1md, md_vaf_staged (:109): v, a, f at (q̇[, q̈]),
//                       f summed to the root
//   md_minv_state       K2md, md_minv_fused (:127): CRBA, the active-region
//                       column Cholesky and L⁻ᵀL⁻¹ (chol.cuh); with kRhs also
//                       the bias force and q̈ = Σⱼ M⁻¹[:, j]·(u − c)[j],
//                       md_minv_qdd_fused (:149)
//   md_grad_cols_state  K5md, _grad_blocks (:184): the column block
//                       [c0, c0 + w) of _md_id_grad_cols_wide
//                       (multidof_fused.py:576) for both sides, with or
//                       without the fused −M⁻¹·∂c finish
// Staged tensors are batch-last: v, a, f are (6, n, B), element (r, i) of
// state b at (r·n + i)·B + b; M⁻¹ and the gradients are (nv, nv, B).
//
// A block may cut a ball or free joint: joint i owns the block's directions
// [max(vs_i, c0), min(vs_i + k_i, c0 + w)), maybe none. The forward sweep
// runs only over the owners and their subtrees (∂v = ∂a = 0 elsewhere);
// the backward sweep still carries ∂f into every ancestor, which starts
// from zero. Where the plain version (md_blops.md_id_grad_bl) adds a
// structural zero or skips a term, this code skips it or adds the zero,
// which changes no value; every other sum runs in the plain version's
// order, and nvcc's FMA contraction is the only difference in rounding.
// The ∂-tensors of one column block (18·n·MD_CB values) are the only arrays
// that grow with the block width GRID_MD_CB.
#pragma once

#include "md.cuh"

#ifndef GRID_MD_CB
#error "compile with -DGRID_MD_CB=<the K5md column-block width>"
#endif

namespace grid {

constexpr int MD_CB = GRID_MD_CB;

// ------------------------------------------------------------------ K1md
template <typename T, bool kQdd>
__device__ __forceinline__ void md_vaf_state(const MdRobot<T>& R, const T* q,
                                             const T* qd, const T* qdd,
                                             T* v_out, T* a_out, T* f_out,
                                             long long B, long long b,
                                             T minus_g) {
  T qs[NQ], qds[NV], qdds[NV];
  load_rows<T, NQ>(q, B, b, qs);
  load_rows<T, NV>(qd, B, b, qds);
  if (kQdd) load_rows<T, NV>(qdd, B, b, qdds);
  T X[N][36];
  md_transforms(R, qs, X);
  T v[N][6], a[N][6], f[N][6];
  md_rnea<T, kQdd, false>(R, X, qds, qdds, minus_g, v, a, f, nullptr);
  store_vec6(v, B, b, v_out);
  store_vec6(a, B, b, a_out);
  store_vec6(f, B, b, f_out);
}

// ------------------------------------------------------------------ K2md
// dense M⁻¹(q) (nv, nv, B) and, with kRhs, q̈ = M⁻¹·(u − c(q, q̇)) (nv, B)
template <typename T, bool kRhs>
__device__ __forceinline__ void md_minv_state(const MdRobot<T>& R, const T* q,
                                              const T* qd, const T* u,
                                              T* M_out, T* qdd_out,
                                              long long B, long long b,
                                              T minus_g) {
  T qs[NQ], rhs[NV];
  load_rows<T, NQ>(q, B, b, qs);
  T A[NV][NV];
  {
    T X[N][36];
    md_transforms(R, qs, X);
    if (kRhs) {
      T qds[NV], c[NV], v[N][6], a[N][6], f[N][6];
      load_rows<T, NV>(qd, B, b, qds);
      load_rows<T, NV>(u, B, b, rhs);
      md_rnea<T, false, true>(R, X, qds, nullptr, minus_g, v, a, f, c);
GRID_ROLLED
      for (int j = 0; j < NV; ++j) rhs[j] = rhs[j] - c[j];
    }
    md_crba(R, X, A);
  }
  chol_factor<T, NV>(A);
  chol_inverse<T, NV>(A);
  store_square(A, T(1), B, b, M_out);
  if (kRhs) {
GRID_ROLLED
    for (int i = 0; i < NV; ++i) {
      T acc = A[i][0] * rhs[0];
GRID_ROLLED
      for (int j = 1; j < NV; ++j) acc += A[i][j] * rhs[j];
      qdd_out[i * B + b] = acc;
    }
  }
}

// ------------------------------------------------------------------ K5md
// One side of md_id_grad_bl for the directions [c0, c0 + w), w ≤ MD_CB:
// kQ → ∂τ/∂δq, else ∂τ/∂q̇ (damping on the block's diagonal entries).
// Writes the rows dc[r][k] and has_df[i] (false where joint i's rows are
// structurally zero: outside the owners' subtrees and their ancestors).
// dv, da, df are scratch.
template <typename T, bool kQ>
__device__ __forceinline__ void md_grad_cols_side(
    const MdRobot<T>& R, const T X[N][36], const T* qd, const T v[N][6],
    const T a[N][6], const T f[N][6], T minus_g, int c0, int w,
    const bool in_sub[N], T dv[N][6][MD_CB], T da[N][6][MD_CB],
    T df[N][6][MD_CB], bool has_df[N], T dc[NV][MD_CB]) {
GRID_ROLLED
  for (int i = 0; i < N; ++i) {
    has_df[i] = in_sub[i];
    if (!in_sub[i]) continue;
    const int p = md_parent(i);
    const int t = jtype(i);
    const int sv = vstart(i);
    const int js = sv > c0 ? sv : c0;  // the block's directions joint i owns
    const int je = sv + dof_of_type(t) < c0 + w ? sv + dof_of_type(t)
                                                : c0 + w;
    const bool has_p = p >= 0 && in_sub[p];
    const T* I = R.I + 36 * i;
    T vJ[6], Iv[6];
    s_times(R, i, t, qd + sv, vJ);
    matvec6(I, v[i], Iv);
    // the seeds' bases: crm(X·v_p)·S and crm(X·a_p)·S on the q side (a
    // root's a_p is −g, and a root has no ∂v seed); S and crm(v_i)·S on
    // the q̇ side
    T Xv[6], Xa[6];
    if (kQ && js < je) {
      if (p >= 0) {
        matvec6(X[i], v[p], Xv);
        matvec6(X[i], a[p], Xa);
      } else {
#pragma unroll
        for (int r = 0; r < 6; ++r) Xa[r] = X[i][r * 6 + 5] * minus_g;
      }
    }
GRID_ROLLED
    for (int k = 0; k < w; ++k) {
      T dvc[6], dac[6], tmp[6];
      if (has_p) {
#pragma unroll
        for (int r = 0; r < 6; ++r) {
          T accv = X[i][r * 6] * dv[p][0][k];
          T acca = X[i][r * 6] * da[p][0][k];
#pragma unroll
          for (int c = 1; c < 6; ++c) {
            accv += X[i][r * 6 + c] * dv[p][c][k];
            acca += X[i][r * 6 + c] * da[p][c][k];
          }
          dvc[r] = accv;
          dac[r] = acca;
        }
      } else {
#pragma unroll
        for (int r = 0; r < 6; ++r) {
          dvc[r] = T(0);
          dac[r] = T(0);
        }
      }
      const int j = c0 + k;
      if (j >= js && j < je) {
        T col[6];
        s_col(R, i, t, j - sv, col);
        if (kQ) {
          if (p >= 0) {
            crm_apply(Xv, col, tmp);
#pragma unroll
            for (int r = 0; r < 6; ++r) dvc[r] = dvc[r] + tmp[r];
          }
          crm_apply(Xa, col, tmp);
        } else {
#pragma unroll
          for (int r = 0; r < 6; ++r) dvc[r] = dvc[r] + col[r];
          crm_apply(v[i], col, tmp);
        }
#pragma unroll
        for (int r = 0; r < 6; ++r) dac[r] = dac[r] + tmp[r];
      }
      crm_apply(vJ, dvc, tmp);
#pragma unroll
      for (int r = 0; r < 6; ++r) dac[r] = dac[r] + (-tmp[r]);
      // ∂f = I·∂a + (crf(∂v)·Iv + crf(v)·(I·∂v))
      T Ida[6], A1[6], Idv[6], A2[6];
      matvec6(I, dac, Ida);
      crf_apply(dvc, Iv, A1);
      matvec6(I, dvc, Idv);
      crf_apply(v[i], Idv, A2);
#pragma unroll
      for (int r = 0; r < 6; ++r) {
        dv[i][r][k] = dvc[r];
        da[i][r][k] = dac[r];
        df[i][r][k] = Ida[r] + (A1[r] + A2[r]);
      }
    }
  }
  // backward: ∂f_p += X_iᵀ·(∂f_i + crf(S_i)·f_i in i's own columns, q side);
  // an ancestor outside the subtrees starts from its first child's term
GRID_ROLLED
  for (int i = N - 1; i >= 0; --i) {
    const int p = md_parent(i);
    if (p < 0 || !has_df[i]) continue;
    const int t = jtype(i);
    const int sv = vstart(i);
    const int js = sv > c0 ? sv : c0;
    const int je = sv + dof_of_type(t) < c0 + w ? sv + dof_of_type(t)
                                                : c0 + w;
GRID_ROLLED
    for (int k = 0; k < w; ++k) {
      T acc[6], up[6];
#pragma unroll
      for (int r = 0; r < 6; ++r) acc[r] = df[i][r][k];
      const int j = c0 + k;
      if (kQ && j >= js && j < je) {
        T col[6], corr[6];
        s_col(R, i, t, j - sv, col);
        crf_apply(col, f[i], corr);
#pragma unroll
        for (int r = 0; r < 6; ++r) acc[r] = acc[r] + corr[r];
      }
      matvec6_T(X[i], acc, up);
#pragma unroll
      for (int r = 0; r < 6; ++r)
        df[p][r][k] = has_df[p] ? df[p][r][k] + up[r] : up[r];
    }
    has_df[p] = true;
  }
  // rows ∂τ_(i,c) = S_{i,c}ᵀ·∂f_i (+ damping on the diagonal, q̇ side)
GRID_ROLLED
  for (int i = 0; i < N; ++i) {
    if (!has_df[i]) continue;
    const int t = jtype(i);
    const int sv = vstart(i);
GRID_ROLLED
    for (int c = 0; c < dof_of_type(t); ++c)
GRID_ROLLED
      for (int k = 0; k < w; ++k) {
        T col[6];
#pragma unroll
        for (int r = 0; r < 6; ++r) col[r] = df[i][r][k];
        T acc = s_dot(R, i, t, c, col);
        if (!kQ && sv + c == c0 + k) acc = acc + R.damping[sv + c];
        dc[sv + c][k] = acc;
      }
  }
}

// Column block [c0, c0 + w) of both sides. kFinish: out = −M⁻¹·∂c over the
// block's nonzero rows only, in ascending order (md_id_grad_bl's finish),
// M⁻¹ read from the staged (nv, nv, B) tensor once for both sides; else
// out = ∂c, zero rows included. Outputs are (nv, nv, B); this block writes
// its w columns.
template <typename T, bool kFinish>
__device__ __forceinline__ void md_grad_cols_state(
    const MdRobot<T>& R, const T* q, const T* qd, const T* v_in,
    const T* a_in, const T* f_in, const T* Minv, T* dq_out, T* dqd_out,
    long long B, long long b, int c0, int w, T minus_g) {
  T qs[NQ], qds[NV];
  load_rows<T, NQ>(q, B, b, qs);
  load_rows<T, NV>(qd, B, b, qds);
  T X[N][36];
  md_transforms(R, qs, X);
  T v[N][6], a[N][6], f[N][6];
  load_vec6(v_in, B, b, v);
  load_vec6(a_in, B, b, a);
  load_vec6(f_in, B, b, f);
  // the block's owners and their subtrees
  bool in_sub[N];
GRID_ROLLED
  for (int i = 0; i < N; ++i) {
    const int p = md_parent(i);
    const int sv = vstart(i);
    const int se = sv + dof_of_type(jtype(i));
    const bool owns = (sv > c0 ? sv : c0) < (se < c0 + w ? se : c0 + w);
    in_sub[i] = owns || (p >= 0 && in_sub[p]);
  }
  T dv[N][6][MD_CB], da[N][6][MD_CB], df[N][6][MD_CB];
  bool has_q[N], has_qd[N];
  T dcq[NV][MD_CB], dcqd[NV][MD_CB];
  md_grad_cols_side<T, true>(R, X, qds, v, a, f, minus_g, c0, w, in_sub, dv,
                             da, df, has_q, dcq);
  md_grad_cols_side<T, false>(R, X, qds, v, a, f, minus_g, c0, w, in_sub, dv,
                              da, df, has_qd, dcqd);
  // which rows of each side are structurally nonzero, by coordinate (read
  // in the loops below, which would otherwise look the layout up per row)
  bool row_q[NV], row_qd[NV];
GRID_ROLLED
  for (int i = 0; i < N; ++i) {
    const int sv = vstart(i);
GRID_ROLLED
    for (int c = 0; c < dof_of_type(jtype(i)); ++c) {
      row_q[sv + c] = has_q[i];
      row_qd[sv + c] = has_qd[i];
    }
  }
  if (kFinish) {
    // both sides have the same nonzero rows; the union is taken all the
    // same (a zero row adds exact zeros). The block's columns unroll, so
    // the sums stay in registers.
GRID_ROLLED
    for (int r = 0; r < NV; ++r) {
      T accq[MD_CB], accqd[MD_CB];
      bool first = true;
GRID_ROLLED
      for (int row = 0; row < NV; ++row) {
        if (!row_q[row] && !row_qd[row]) continue;
        const T m = Minv[(row * NV + r) * B + b];
#pragma unroll
        for (int k = 0; k < MD_CB; ++k) {
          if (k >= w) break;
          const T tq = row_q[row] ? m * dcq[row][k] : T(0);
          const T tqd = row_qd[row] ? m * dcqd[row][k] : T(0);
          accq[k] = first ? tq : accq[k] + tq;
          accqd[k] = first ? tqd : accqd[k] + tqd;
        }
        first = false;
      }
#pragma unroll
      for (int k = 0; k < MD_CB; ++k) {
        if (k >= w) break;
        dq_out[(r * NV + c0 + k) * B + b] = -accq[k];
        dqd_out[(r * NV + c0 + k) * B + b] = -accqd[k];
      }
    }
  } else {
GRID_ROLLED
    for (int row = 0; row < NV; ++row)
GRID_ROLLED
      for (int k = 0; k < w; ++k) {
        dq_out[(row * NV + c0 + k) * B + b] = row_q[row] ? dcq[row][k] : T(0);
        dqd_out[(row * NV + c0 + k) * B + b] =
            row_qd[row] ? dcqd[row][k] : T(0);
      }
  }
}

}  // namespace grid
