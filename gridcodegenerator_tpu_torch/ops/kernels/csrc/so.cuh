// Device functions of the second-order kernels, one (state, direction) pair
// per thread: the first-order bodies of rbd.cuh and staged.cuh run on the
// dual numbers of dual.cuh, seeded with one coordinate direction.
//
//   hessian_state   so_fused.py:84 _hess_row: the ∇FD pipeline and M⁻¹ in
//                   Dual<T> → one column k of H (n·3n values) or of λᵀ·H (3n)
//   t1_state        so_staged.py:264 T1: jvp of K1 → dc (n), dv (6, n)
//   t2_state        so_staged.py:277 T2: CRBA jvp (root-path entries only),
//                   then dlamM = −M⁻¹·(dM·lamM), dq̈ = −M⁻¹·(dM·q̈ + dc)
//   t4_state        so_staged.py:289 T4: jvp of K4 → da, df (6, n)
//   t5_state        so_staged.py:304 T5: jvp of K5's rows over one column
//                   block of one side, contracted with lamM → −lamMᵀ·d∂c (w)
//
// Layouts, batch last: a direction-major staged tangent (n_dirs, …, B) has
// element (d, …) of state b at ((d·… ) + …)·B + b, as the plain versions
// (ops/kernels/so_staged.py) return them. H is (n, 3n, 3n, B) and λᵀ·H
// (3n, 3n, B), the direction last among the structure axes (so_fused.py:
// 215-217, 237-239). Only tangents leave a thread; every sum runs in the
// plain version's order.
#pragma once

#include "dual.cuh"
#include "staged.cuh"

#ifndef GRID_SO_CB
#error "compile with -DGRID_SO_CB=<the T5 column-block width>"
#endif

namespace grid {

constexpr int SO_CB = GRID_SO_CB;

// x[i] + tangent (i == k ? 1 : 0) for the perturbed argument
template <typename T>
__device__ __forceinline__ void load_seeded(const T* __restrict__ x,
                                            long long B, long long b,
                                            bool seeded, int k,
                                            Dual<T>* out) {
GRID_ROLLED
  for (int i = 0; i < N; ++i)
    out[i] = Dual<T>(x[i * B + b], (seeded && i == k) ? T(1) : T(0));
}

// value from x (…, B), tangent from direction d of dx (n_dirs, …, B); len
// values of stride B each
template <typename T>
__device__ __forceinline__ void load_dual(const T* __restrict__ x,
                                          const T* __restrict__ dx, int len,
                                          long long B, long long b, int d,
                                          Dual<T>* out) {
  const T* dd = dx + static_cast<long long>(d) * len * B;
GRID_ROLLED
  for (int e = 0; e < len; ++e) out[e] = Dual<T>(x[e * B + b], dd[e * B + b]);
}

// whether joint a is on the root path of joint d (a == d included)
__device__ __forceinline__ bool on_root_path(int a, int d) {
  while (d > a) d = parent(d);
  return d == a;
}

// --------------------------------------------------- single-thread Hessian
// Column dir (0..3n) of H, or of λᵀ·H with kLam: the tangent of
// J = [−M⁻¹·∂c/∂q | −M⁻¹·∂c/∂q̇ | M⁻¹] along coordinate dir % n of argument
// dir / n (q, q̇, u).
template <typename T, bool kLam>
__device__ __forceinline__ void hessian_state(const Robot<T>& R, const T* q,
                                              const T* qd, const T* u,
                                              const T* lam, T* out,
                                              long long B, long long b,
                                              int dir, T minus_g) {
  using D = Dual<T>;
  constexpr int N3 = 3 * N;
  const int which = dir / N, k = dir - which * N;
  D qs[N], qds[N], us[N], c[N];
  load_seeded(q, B, b, which == 0, k, qs);
  load_seeded(qd, B, b, which == 1, k, qds);
  load_seeded(u, B, b, which == 2, k, us);
  T ls[N];
  if (kLam) load_col(lam, B, b, ls);
  const D mg(minus_g);
  D X[N][36];
  joint_transforms(R, qs, X);
  D v[N][6], a[N][6], f[N][6];
  rnea_fwd<D, false, false>(R, X, qds, nullptr, mg, v, a, f);
  rnea_bwd<D, true, false>(R, X, f, qds, nullptr, c);
  D M[N][N];
  minv(R, X, M);
  D x[N], qdd[N];
GRID_ROLLED
  for (int i = 0; i < N; ++i) x[i] = us[i] - c[i];
GRID_ROLLED
  for (int r = 0; r < N; ++r) {
    D acc = M[r][0] * x[0];
GRID_ROLLED
    for (int i = 1; i < N; ++i) acc += M[r][i] * x[i];
    qdd[r] = acc;
  }
  rnea_fwd<D, true, true>(R, X, qds, qdd, mg, v, a, f);
  rnea_bwd<D, false, false>(R, X, f, qds, nullptr, nullptr);
  // J's column j's tangent for row r: out[r][j][dir] (full) or
  // Σ_r λ_r·(that) into out[j][dir]
  auto emit_col = [&](int j, const T* tr) {
    if (kLam) {
      T s = ls[0] * tr[0];
GRID_ROLLED
      for (int r = 1; r < N; ++r) s += ls[r] * tr[r];
      out[(static_cast<long long>(j) * N3 + dir) * B + b] = s;
    } else {
GRID_ROLLED
      for (int r = 0; r < N; ++r)
        out[((static_cast<long long>(r) * N3 + j) * N3 + dir) * B + b] = tr[r];
    }
  };
  D dc[N][N];
GRID_ROLLED
  for (int side = 0; side < 2; ++side) {
    if (side == 0)
      id_grad_side<D, true>(R, X, qds, v, a, f, mg, dc);
    else
      id_grad_side<D, false>(R, X, qds, v, a, f, mg, dc);
GRID_ROLLED
    for (int col = 0; col < N; ++col) {
      T tr[N];
GRID_ROLLED
      for (int r = 0; r < N; ++r) {
        D acc = M[r][0] * dc[0][col];
GRID_ROLLED
        for (int i = 1; i < N; ++i) acc += M[r][i] * dc[i][col];
        tr[r] = -acc.t;
      }
      emit_col(side * N + col, tr);
    }
  }
GRID_ROLLED
  for (int col = 0; col < N; ++col) {
    T tr[N];
GRID_ROLLED
    for (int r = 0; r < N; ++r) tr[r] = M[r][col].t;
    emit_col(2 * N + col, tr);
  }
}

// ------------------------------------------------------------------ T1
template <typename T>
__device__ __forceinline__ void t1_state(const Robot<T>& R, const T* q,
                                         const T* qd, T* dc_out, T* dv_out,
                                         long long B, long long b, int d,
                                         int which, T minus_g) {
  using D = Dual<T>;
  D qs[N], qds[N], c[N];
  load_seeded(q, B, b, which == 0, d, qs);
  load_seeded(qd, B, b, which == 1, d, qds);
  D X[N][36];
  joint_transforms(R, qs, X);
  D v[N][6], a[N][6], f[N][6];
  rnea_fwd<D, false, false>(R, X, qds, nullptr, D(minus_g), v, a, f);
  rnea_bwd<D, true, false>(R, X, f, qds, nullptr, c);
  T* dcd = dc_out + static_cast<long long>(d) * N * B;
  T* dvd = dv_out + static_cast<long long>(d) * 6 * N * B;
GRID_ROLLED
  for (int i = 0; i < N; ++i) {
    dcd[i * B + b] = c[i].t;
#pragma unroll
    for (int r = 0; r < 6; ++r) dvd[(r * N + i) * B + b] = v[i][r].t;
  }
}

// ------------------------------------------------------------------ T2
template <typename T>
__device__ __forceinline__ void t2_state(const Robot<T>& R, const T* q,
                                         const T* lamM, const T* qdd,
                                         const T* Minv, const T* dc,
                                         T* dlamM_out, T* dqdd_out,
                                         long long B, long long b, int d) {
  using D = Dual<T>;
  T wl[N], wq[N];
  {
    D qs[N];
    load_seeded(q, B, b, true, d, qs);
    D A[N][N];
    {
      D X[N][36];
      joint_transforms(R, qs, X);
      crba(R, X, A);
    }
    T lm[N], qa[N];
    load_col(lamM, B, b, lm);
    load_col(qdd, B, b, qa);
    // (dM·lamM)_i, (dM·q̈)_i over the root-path entries M[i][j] ≠ 0
GRID_ROLLED
    for (int i = 0; i < N; ++i) {
      bool first = true;
      T sl = T(0), sq = T(0);
GRID_ROLLED
      for (int j = 0; j < N; ++j) {
        T mt;
        if (j <= i) {
          if (!on_root_path(j, i)) continue;
          mt = A[i][j].t;
        } else {
          if (!on_root_path(i, j)) continue;
          mt = A[j][i].t;
        }
        sl = first ? mt * lm[j] : sl + mt * lm[j];
        sq = first ? mt * qa[j] : sq + mt * qa[j];
        first = false;
      }
      wl[i] = sl;
      wq[i] = sq;
    }
  }
  const T* dcd = dc + static_cast<long long>(d) * N * B;
GRID_ROLLED
  for (int i = 0; i < N; ++i) wq[i] = wq[i] + dcd[i * B + b];
  T* dl = dlamM_out + static_cast<long long>(d) * N * B;
  T* dq = dqdd_out + static_cast<long long>(d) * N * B;
GRID_ROLLED
  for (int r = 0; r < N; ++r) {
    T m = Minv[(r * N) * B + b];
    T al = m * wl[0], aq = m * wq[0];
GRID_ROLLED
    for (int c = 1; c < N; ++c) {
      m = Minv[(r * N + c) * B + b];
      al += m * wl[c];
      aq += m * wq[c];
    }
    dl[r * B + b] = -al;
    dq[r * B + b] = -aq;
  }
}

// ------------------------------------------------------------------ T4
template <typename T>
__device__ __forceinline__ void t4_state(const Robot<T>& R, const T* q,
                                         const T* qd, const T* qdd,
                                         const T* v_in, const T* dv,
                                         const T* dqdd, T* da_out, T* df_out,
                                         long long B, long long b, int d,
                                         int which, T minus_g) {
  using D = Dual<T>;
  D qs[N], qds[N], qdds[N];
  load_seeded(q, B, b, which == 0, d, qs);
  load_seeded(qd, B, b, which == 1, d, qds);
  load_dual(qdd, dqdd, N, B, b, d, qdds);
  D v[N][6], a[N][6], f[N][6];
  {
    D vt[6 * N];  // (6, n) order of the staged layout
    load_dual(v_in, dv, 6 * N, B, b, d, vt);
GRID_ROLLED
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int r = 0; r < 6; ++r) v[i][r] = vt[r * N + i];
  }
  D X[N][36];
  joint_transforms(R, qs, X);
  rnea_fwd<D, true, true>(R, X, qds, qdds, D(minus_g), v, a, f);
  rnea_bwd<D, false, false>(R, X, f, qds, nullptr, nullptr);
  T* dad = da_out + static_cast<long long>(d) * 6 * N * B;
  T* dfd = df_out + static_cast<long long>(d) * 6 * N * B;
GRID_ROLLED
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int r = 0; r < 6; ++r) {
      dad[(r * N + i) * B + b] = a[i][r].t;
      dfd[(r * N + i) * B + b] = f[i][r].t;
    }
}

// ------------------------------------------------------------------ T5
// One side (kQ: ∂c/∂q, else ∂c/∂q̇) over the columns [c0, c0 + w), w ≤
// SO_CB: out[d][c0 + k] = −Σ_i lamM_i·tangent(∂c_i/∂x_{c0+k}) over the
// block's nonzero rows.
template <typename T, bool kQ>
__device__ __forceinline__ void t5_state(const Robot<T>& R, const T* q,
                                         const T* qd, const T* v_in,
                                         const T* a_in, const T* f_in,
                                         const T* lamM, const T* dv,
                                         const T* da, const T* df, T* out,
                                         long long B, long long b, int d,
                                         int which, int c0, int w,
                                         T minus_g) {
  using D = Dual<T>;
  D qs[N], qds[N];
  load_seeded(q, B, b, which == 0, d, qs);
  load_seeded(qd, B, b, which == 1, d, qds);
  D X[N][36];
  joint_transforms(R, qs, X);
  D v[N][6], a[N][6], f[N][6];
  {
    D t[6 * N];
    const T* ins[3] = {v_in, a_in, f_in};
    const T* dins[3] = {dv, da, df};
    D (*outs[3])[6] = {v, a, f};
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      load_dual(ins[s], dins[s], 6 * N, B, b, d, t);
GRID_ROLLED
      for (int i = 0; i < N; ++i)
#pragma unroll
        for (int r = 0; r < 6; ++r) outs[s][i][r] = t[r * N + i];
    }
  }
  bool in_sub[N];
GRID_ROLLED
  for (int i = 0; i < N; ++i) {
    const int p = parent(i);
    in_sub[i] = (i >= c0 && i < c0 + w) || (p >= 0 && in_sub[p]);
  }
  D ddv[N][6][SO_CB], dda[N][6][SO_CB], ddf[N][6][SO_CB], dc[N][SO_CB];
  bool has_row[N];
  grad_cols_side<D, kQ, SO_CB>(R, X, qds, v, a, f, D(minus_g), c0, w, in_sub,
                               ddv, dda, ddf, has_row, dc);
  T lm[N];
  load_col(lamM, B, b, lm);
  T* od = out + static_cast<long long>(d) * N * B;
GRID_ROLLED
  for (int k = 0; k < w; ++k) {
    T s = T(0);
    bool first = true;
GRID_ROLLED
    for (int i = 0; i < N; ++i) {
      if (!has_row[i]) continue;
      s = first ? lm[i] * dc[i][k].t : s + lm[i] * dc[i][k].t;
      first = false;
    }
    od[(c0 + k) * B + b] = -s;
  }
}

}  // namespace grid
