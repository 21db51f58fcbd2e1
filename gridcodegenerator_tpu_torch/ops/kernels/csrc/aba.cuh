// Forward dynamics by the articulated-body algorithm, one state per thread.
//
// The CUDA counterpart of aba_bl (gridcodegenerator_tpu/ops/aba.py:158-223,
// ported as gridcodegenerator_tpu_torch/ops/aba.py), which the Pallas kernel
// forward_dynamics_aba_fused (gridcodegenerator_tpu/ops/kernels/fused.py:357)
// runs on VMEM tiles. Every sum runs in the plain version's order; nvcc's
// FMA contraction is the only difference in rounding.
//
// ABA is O(n) a state: X (36n), the articulated inertias IA (36n) and the
// 6-vectors v, ζ, pA, U, a (30n) stay live, ≈ 100n values — local memory at
// n = 28, like the other one-thread-per-state bodies (rbd.cuh).
#pragma once

#include "rbd.cuh"

namespace grid {

template <typename T>
__device__ __forceinline__ void aba(const Robot<T>& R, const T X[N][36],
                                    const T* qd, const T* u, T minus_g,
                                    T* qdd) {
  T v[N][6], zeta[N][6], IA[N][36], pA[N][6], U[N][6], Dinv[N], ubar[N];
  // pass 1: velocities, bias accelerations, bias forces
GRID_ROLLED
  for (int i = 0; i < N; ++i) {
    const int p = parent(i);
    const T* S = R.S + 6 * i;
    const T* I = R.I + 36 * i;
    T Sqd[6], t[6];
#pragma unroll
    for (int r = 0; r < 6; ++r) Sqd[r] = S[r] * qd[i];
    if (p < 0) {
#pragma unroll
      for (int r = 0; r < 6; ++r) v[i][r] = Sqd[r];
    } else {
      matvec6(X[i], v[p], t);
#pragma unroll
      for (int r = 0; r < 6; ++r) v[i][r] = t[r] + Sqd[r];
    }
    crm_apply(v[i], Sqd, zeta[i]);
    T Iv[6];
    matvec6(I, v[i], Iv);
    crf_apply(v[i], Iv, pA[i]);
#pragma unroll
    for (int e = 0; e < 36; ++e) IA[i][e] = I[e];
  }
  // pass 2: articulated inertias and bias forces, leaves to root
GRID_ROLLED
  for (int i = N - 1; i >= 0; --i) {
    const int p = parent(i);
    const T* S = R.S + 6 * i;
    T Ui[6];
#pragma unroll
    for (int r = 0; r < 6; ++r) {
      T acc = IA[i][r * 6] * S[0];
#pragma unroll
      for (int c = 1; c < 6; ++c) acc += IA[i][r * 6 + c] * S[c];
      Ui[r] = acc;
    }
    T d = S[0] * Ui[0];
#pragma unroll
    for (int c = 1; c < 6; ++c) d += S[c] * Ui[c];
    const T Di = T(1) / (d + R.armature[i]);
    T SpA = S[0] * pA[i][0];
#pragma unroll
    for (int c = 1; c < 6; ++c) SpA += S[c] * pA[i][c];
    const T ui = (u[i] - R.damping[i] * qd[i]) - SpA;
#pragma unroll
    for (int r = 0; r < 6; ++r) U[i][r] = Ui[r];
    Dinv[i] = Di;
    ubar[i] = ui;
    if (p >= 0) {
      T UDi[6], Ia[36], pa[6], t[6];
#pragma unroll
      for (int r = 0; r < 6; ++r) UDi[r] = Ui[r] * Di;
#pragma unroll
      for (int r = 0; r < 6; ++r)
#pragma unroll
        for (int c = 0; c < 6; ++c)
          Ia[r * 6 + c] = IA[i][r * 6 + c] - UDi[r] * Ui[c];
      matvec6(Ia, zeta[i], t);
#pragma unroll
      for (int r = 0; r < 6; ++r) pa[r] = (pA[i][r] + t[r]) + UDi[r] * ui;
      // IA_p += Xᵀ·(Iᵃ·X)
      T IaX[36];
#pragma unroll
      for (int r = 0; r < 6; ++r)
#pragma unroll
        for (int k = 0; k < 6; ++k) {
          T acc = Ia[r * 6] * X[i][k];
#pragma unroll
          for (int c = 1; c < 6; ++c) acc += Ia[r * 6 + c] * X[i][c * 6 + k];
          IaX[r * 6 + k] = acc;
        }
#pragma unroll
      for (int r = 0; r < 6; ++r)
#pragma unroll
        for (int k = 0; k < 6; ++k) {
          T acc = X[i][r] * IaX[k];
#pragma unroll
          for (int c = 1; c < 6; ++c) acc += X[i][c * 6 + r] * IaX[c * 6 + k];
          IA[p][r * 6 + k] += acc;
        }
      matvec6_T(X[i], pa, t);
#pragma unroll
      for (int r = 0; r < 6; ++r) pA[p][r] += t[r];
    }
  }
  // pass 3: accelerations, root to leaves (a reuses the v storage)
  T (*a)[6] = v;
GRID_ROLLED
  for (int i = 0; i < N; ++i) {
    const int p = parent(i);
    const T* S = R.S + 6 * i;
    T ap[6];
    if (p < 0) {
#pragma unroll
      for (int r = 0; r < 6; ++r) ap[r] = X[i][r * 6 + 5] * minus_g + zeta[i][r];
    } else {
      T t[6];
      matvec6(X[i], a[p], t);
#pragma unroll
      for (int r = 0; r < 6; ++r) ap[r] = t[r] + zeta[i][r];
    }
    T Ua = U[i][0] * ap[0];
#pragma unroll
    for (int c = 1; c < 6; ++c) Ua += U[i][c] * ap[c];
    const T qi = Dinv[i] * (ubar[i] - Ua);
    qdd[i] = qi;
#pragma unroll
    for (int r = 0; r < 6; ++r) a[i][r] = ap[r] + S[r] * qi;
  }
}

// q̈(q, q̇, u) — forward_dynamics_aba_fused
template <typename T>
__device__ __forceinline__ void aba_state(const Robot<T>& R, const T* q,
                                          const T* qd, const T* u,
                                          T* qdd_out, long long B, long long b,
                                          T minus_g) {
  T qs[N], qds[N], us[N], qdd[N];
  load_col(q, B, b, qs);
  load_col(qd, B, b, qds);
  load_col(u, B, b, us);
  T X[N][36];
  joint_transforms(R, qs, X);
  aba(R, X, qds, us, minus_g, qdd);
GRID_ROLLED
  for (int i = 0; i < N; ++i) qdd_out[i * B + b] = qdd[i];
}

}  // namespace grid
