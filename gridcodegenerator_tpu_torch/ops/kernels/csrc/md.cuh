// Multi-dof (ball and free joint) dynamics, one state per thread.
//
// The CUDA counterparts of the kernel bodies of
// gridcodegenerator_tpu/ops/kernels/multidof_fused.py (ported as the plain
// versions of gridcodegenerator_tpu_torch/ops/md_blops.py):
//   md_transforms    _md_transforms_s + _apply66 (:50-138): X_i(q) by type
//   md_rnea          _md_rnea_s (:165-212)
//   md_crba          _md_crba_s (:215-258), lower triangle
//   md_aba           _md_aba_body (:285-368), k×k Cholesky joint blocks
//   md_id_grad_side  one side of _md_id_grad_cols_wide (:576-740) over all
//                    nv directions
// and the per-state bodies of the five kernels of md.cu (md_fd_state is
// _md_fd_body, :272: the CRBA forward dynamics).
//
// The robot is a compile-time constant: the build passes
//   -DGRID_N=<joints> -DGRID_PARENTS=G(p0)G(p1)... -DGRID_PRISMATIC=G(..)...
//   -DGRID_JTYPES=G(t0)G(t1)...   (0 revolute, 1 prismatic, 2 spherical,
//                                  3 floating)
// from which every joint's coordinate slices follow: a floating joint takes
// 7 position and 6 velocity slots (quaternion w, x, y, z and position in
// the parent frame; twist [ω; v]), a spherical joint 4 and 3, the others 1
// and 1. The numeric constants arrive in one packed buffer
// (MultiDofModel.packed), staged in shared memory by md.cu:
//   XT (36N), inertia (36N), K (9N), K·K (9N), S (6N), damping (NV),
//   armature (NV)
// with K = skew(axis) of a revolute or prismatic joint and S its motion
// subspace; a spherical joint's S is [I₃; 0] and a floating joint's I₆,
// folded here as the identity.
//
// Every sum runs in the order of the plain version. The JAX bodies (and
// md_blops) skip the structural zeros of S and of a joint's X_J; here a
// few of those zeros are multiplied and added instead, which changes no
// value (x + 0·y = x), so float64 agrees at round-off and nvcc's FMA
// contraction is the only difference in rounding. Joint and column loops
// stay rolled (rbd.cuh).
#pragma once

#include "chol.cuh"
#include "rbd.cuh"

#ifndef GRID_JTYPES
#error "compile with -DGRID_JTYPES=G(t0)G(t1)... (0 revolute, 1 prismatic, 2 spherical, 3 floating)"
#endif

namespace grid {

enum JointType { kRevolute = 0, kPrismatic = 1, kSpherical = 2, kFloating = 3 };

__host__ __device__ constexpr int dof_of_type(int t) {
  return t == kFloating ? 6 : (t == kSpherical ? 3 : 1);
}
__host__ __device__ constexpr int nq_of_type(int t) {
  return t == kFloating ? 7 : (t == kSpherical ? 4 : 1);
}

struct Layout {
  int type[N];
  int vs[N + 1];  // velocity slice starts; vs[N] = nv
  int qs[N + 1];  // position slice starts; qs[N] = nq
};

#define G(x) x,
__host__ __device__ constexpr Layout make_layout() {
  constexpr int t[N] = {GRID_JTYPES};
  Layout l{};
  l.vs[0] = 0;
  l.qs[0] = 0;
  for (int i = 0; i < N; ++i) {
    l.type[i] = t[i];
    l.vs[i + 1] = l.vs[i] + dof_of_type(t[i]);
    l.qs[i + 1] = l.qs[i] + nq_of_type(t[i]);
  }
  return l;
}
#undef G

constexpr int NV = make_layout().vs[N];
constexpr int NQ = make_layout().qs[N];
constexpr int kMdConstCount = 96 * N + 2 * NV;

// The layout and the parents as constant-memory tables, for the joint loops'
// run-time indices: a constexpr local table indexed at run time is rebuilt
// in local memory on every call, which took more than half of K5md's time
// at free Atlas (and of K1md's) on an H100.
__constant__ Layout c_layout = make_layout();
#define G(x) x,
__constant__ int c_parent[N] = {GRID_PARENTS};
#undef G

__device__ __forceinline__ int jtype(int i) { return c_layout.type[i]; }
__device__ __forceinline__ int vstart(int i) { return c_layout.vs[i]; }
__device__ __forceinline__ int qstart(int i) { return c_layout.qs[i]; }
__device__ __forceinline__ int md_parent(int i) { return c_parent[i]; }

// Views into the packed constants (shared memory in the kernels).
template <typename T>
struct MdRobot {
  const T* XT;
  const T* I;
  const T* K;
  const T* KK;
  const T* S;
  const T* damping;
  const T* armature;
  __host__ __device__ explicit MdRobot(const T* base)
      : XT(base), I(base + 36 * N), K(base + 72 * N), KK(base + 81 * N),
        S(base + 90 * N), damping(base + 96 * N), armature(base + 96 * N + NV) {}
};

// vJ = S_i·x for joint i's velocity coordinates x (w values)
template <typename T>
__device__ __forceinline__ void s_times(const MdRobot<T>& R, int i, int t,
                                        const T* x, T* out) {
  if (t == kFloating) {
#pragma unroll
    for (int r = 0; r < 6; ++r) out[r] = x[r];
  } else if (t == kSpherical) {
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      out[r] = x[r];
      out[3 + r] = T(0);
    }
  } else {
    const T* S = R.S + 6 * i;
#pragma unroll
    for (int r = 0; r < 6; ++r) out[r] = S[r] * x[0];
  }
}

// column c of joint i's S (a unit vector for ball and free joints)
template <typename T>
__device__ __forceinline__ void s_col(const MdRobot<T>& R, int i, int t, int c,
                                      T* out) {
  if (t == kFloating || t == kSpherical) {
#pragma unroll
    for (int r = 0; r < 6; ++r) out[r] = (r == c) ? T(1) : T(0);
  } else {
#pragma unroll
    for (int r = 0; r < 6; ++r) out[r] = R.S[6 * i + r];
  }
}

// S_{i,c}ᵀ·x
template <typename T>
__device__ __forceinline__ T s_dot(const MdRobot<T>& R, int i, int t, int c,
                                   const T* x) {
  if (t == kFloating || t == kSpherical) return x[c];
  const T* S = R.S + 6 * i;
  T acc = S[0] * x[0];
#pragma unroll
  for (int r = 1; r < 6; ++r) acc += S[r] * x[r];
  return acc;
}

// -------------------------------------------------------- joint transforms
// X_i = X_J(q_i)·XT_i, with X_J's rows summed in ascending column order.
template <typename T>
__device__ __forceinline__ void md_transforms(const MdRobot<T>& R, const T* q,
                                              T X[N][36]) {
GRID_ROLLED
  for (int i = 0; i < N; ++i) {
    const int t = jtype(i);
    const T* qi = q + qstart(i);
    T J[36];
#pragma unroll
    for (int e = 0; e < 36; ++e) J[e] = T(0);
    if (t == kSpherical || t == kFloating) {
      const T w = qi[0], x = qi[1], y = qi[2], z = qi[3];
      // R(quat), parent ← child; the motion transform's block is E = Rᵀ
      T Rm[9];
      Rm[0] = T(1) - T(2) * (y * y + z * z);
      Rm[1] = T(2) * (x * y - w * z);
      Rm[2] = T(2) * (x * z + w * y);
      Rm[3] = T(2) * (x * y + w * z);
      Rm[4] = T(1) - T(2) * (x * x + z * z);
      Rm[5] = T(2) * (y * z - w * x);
      Rm[6] = T(2) * (x * z - w * y);
      Rm[7] = T(2) * (y * z + w * x);
      Rm[8] = T(1) - T(2) * (x * x + y * y);
#pragma unroll
      for (int r = 0; r < 3; ++r)
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          J[r * 6 + c] = Rm[c * 3 + r];
          J[(3 + r) * 6 + 3 + c] = Rm[c * 3 + r];
        }
      if (t == kFloating) {
        // lower-left block −E·p̂ with p = q[s+4 : s+7]
        const T px = qi[4], py = qi[5], pz = qi[6];
        const T P[9] = {T(0), -pz, py, pz, T(0), -px, -py, px, T(0)};
#pragma unroll
        for (int r = 0; r < 3; ++r)
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            T acc = T(0);
            bool first = true;
#pragma unroll
            for (int k = 0; k < 3; ++k) {
              if (k == c) continue;  // p̂'s diagonal is a structural zero
              const T term = (-Rm[k * 3 + r]) * P[k * 3 + c];
              acc = first ? term : acc + term;
              first = false;
            }
            J[(3 + r) * 6 + c] = acc;
          }
      }
    } else if (t == kPrismatic) {
      // X_J = I + q·[[0, 0], [−K, 0]]
#pragma unroll
      for (int r = 0; r < 6; ++r) J[r * 6 + r] = T(1);
#pragma unroll
      for (int r = 0; r < 3; ++r)
#pragma unroll
        for (int c = 0; c < 3; ++c)
          J[(3 + r) * 6 + c] = (-R.K[9 * i + 3 * r + c]) * qi[0];
    } else {
      // E = I − sin q·K + (1 − cos q)·K·K on both diagonal blocks
      T sn, cs;
      sincos_t(qi[0], &sn, &cs);
      const T omc = T(1) - cs;
#pragma unroll
      for (int r = 0; r < 3; ++r)
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const T e = ((r == c ? T(1) : T(0)) + (-R.K[9 * i + 3 * r + c]) * sn) +
                      R.KK[9 * i + 3 * r + c] * omc;
          J[r * 6 + c] = e;
          J[(3 + r) * 6 + 3 + c] = e;
        }
    }
    const T* XT = R.XT + 36 * i;
#pragma unroll
    for (int r = 0; r < 6; ++r)
#pragma unroll
      for (int c = 0; c < 6; ++c) {
        T acc = J[r * 6] * XT[c];
#pragma unroll
        for (int k = 1; k < 6; ++k) acc += J[r * 6 + k] * XT[k * 6 + c];
        X[i][r * 6 + c] = acc;
      }
  }
}

// -------------------------------------------------------------------- RNEA
// v, a, f at (q̇[, q̈]) with f summed to the root; with kTorque also
// c = Sᵀf + damping·q̇ (+ armature·q̈ with kQdd).
template <typename T, bool kQdd, bool kTorque>
__device__ __forceinline__ void md_rnea(const MdRobot<T>& R, const T X[N][36],
                                        const T* qd, const T* qdd, T minus_g,
                                        T v[N][6], T a[N][6], T f[N][6],
                                        T* c) {
GRID_ROLLED
  for (int i = 0; i < N; ++i) {
    const int p = md_parent(i);
    const int t = jtype(i);
    const int sv = vstart(i);
    T vJ[6], tmp[6], ai[6];
    s_times(R, i, t, qd + sv, vJ);
    if (p < 0) {
#pragma unroll
      for (int r = 0; r < 6; ++r) v[i][r] = vJ[r];
#pragma unroll
      for (int r = 0; r < 6; ++r) ai[r] = X[i][r * 6 + 5] * minus_g;
    } else {
      matvec6(X[i], v[p], tmp);
#pragma unroll
      for (int r = 0; r < 6; ++r) v[i][r] = tmp[r] + vJ[r];
      matvec6(X[i], a[p], ai);
    }
    crm_apply(v[i], vJ, tmp);
#pragma unroll
    for (int r = 0; r < 6; ++r) ai[r] += tmp[r];
    if (kQdd) {
      s_times(R, i, t, qdd + sv, tmp);
#pragma unroll
      for (int r = 0; r < 6; ++r) ai[r] += tmp[r];
    }
    const T* I = R.I + 36 * i;
    T Iv[6], Ia[6];
    matvec6(I, v[i], Iv);
    matvec6(I, ai, Ia);
    crf_apply(v[i], Iv, tmp);
#pragma unroll
    for (int r = 0; r < 6; ++r) {
      a[i][r] = ai[r];
      f[i][r] = Ia[r] + tmp[r];
    }
  }
GRID_ROLLED
  for (int i = N - 1; i >= 0; --i) {
    const int p = md_parent(i);
    if (p >= 0) {
      T tmp[6];
      matvec6_T(X[i], f[i], tmp);
#pragma unroll
      for (int r = 0; r < 6; ++r) f[p][r] += tmp[r];
    }
  }
  if (kTorque) {
GRID_ROLLED
    for (int i = 0; i < N; ++i) {
      const int t = jtype(i);
      const int sv = vstart(i);
GRID_ROLLED
      for (int k = 0; k < dof_of_type(t); ++k) {
        const int j = sv + k;
        T acc = s_dot(R, i, t, k, f[i]) + R.damping[j] * qd[j];
        if (kQdd) acc = acc + R.armature[j] * qdd[j];
        c[j] = acc;
      }
    }
  }
}

// -------------------------------------------------------------------- CRBA
// M + diag(armature) into the lower triangle of A (zero where two joints
// share no root path).
template <typename T>
__device__ __forceinline__ void md_crba(const MdRobot<T>& R, const T X[N][36],
                                        T A[NV][NV]) {
  T IC[N][36];
GRID_ROLLED
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 36; ++e) IC[i][e] = R.I[36 * i + e];
GRID_ROLLED
  for (int r = 0; r < NV; ++r)
GRID_ROLLED
    for (int c = 0; c <= r; ++c) A[r][c] = T(0);
  // IC_p += X_iᵀ·(IC_i·X_i), leaves to root
GRID_ROLLED
  for (int i = N - 1; i >= 0; --i) {
    const int p = md_parent(i);
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
    const int t = jtype(i);
    const int si = vstart(i);
    const int wi = dof_of_type(t);
    T F[6][6];  // F[c] = IC_i·S_{i,c}
GRID_ROLLED
    for (int c = 0; c < wi; ++c) {
      T col[6];
      s_col(R, i, t, c, col);
#pragma unroll
      for (int r = 0; r < 6; ++r) {
        T acc = col[0] * IC[i][r * 6];
#pragma unroll
        for (int k = 1; k < 6; ++k) acc += col[k] * IC[i][r * 6 + k];
        F[c][r] = acc;
      }
    }
GRID_ROLLED
    for (int ci = 0; ci < wi; ++ci)
GRID_ROLLED
      for (int cj = 0; cj <= ci; ++cj) {
        T val = s_dot(R, i, t, cj, F[ci]);
        if (ci == cj) val = val + R.armature[si + ci];
        A[si + ci][si + cj] = val;
      }
    int j = i;
    while (md_parent(j) >= 0) {
GRID_ROLLED
      for (int c = 0; c < wi; ++c) {
        T tmp[6];
        matvec6_T(X[j], F[c], tmp);
#pragma unroll
        for (int r = 0; r < 6; ++r) F[c][r] = tmp[r];
      }
      j = md_parent(j);
      const int tj = jtype(j);
      const int sj = vstart(j);
GRID_ROLLED
      for (int ci = 0; ci < wi; ++ci)
GRID_ROLLED
        for (int cj = 0; cj < dof_of_type(tj); ++cj)
          A[si + ci][sj + cj] = s_dot(R, j, tj, cj, F[ci]);
    }
  }
}

// --------------------------------------------------------------------- ABA
template <typename T>
__device__ __forceinline__ void md_aba(const MdRobot<T>& R, const T X[N][36],
                                       const T* qd, const T* u, T minus_g,
                                       T* qdd) {
  T v[N][6], zeta[N][6], IA[N][36], pA[N][6];
  T U[NV][6];   // U for each velocity coordinate: IA_i·S_{i,c}
  T L[NV][6];   // joint i's k×k factor in rows vs_i.., columns 0..k-1
  T ub[NV];
  // pass 1: velocities, bias accelerations, bias forces
GRID_ROLLED
  for (int i = 0; i < N; ++i) {
    const int p = md_parent(i);
    T vJ[6], tmp[6];
    s_times(R, i, jtype(i), qd + vstart(i), vJ);
    if (p < 0) {
#pragma unroll
      for (int r = 0; r < 6; ++r) v[i][r] = vJ[r];
    } else {
      matvec6(X[i], v[p], tmp);
#pragma unroll
      for (int r = 0; r < 6; ++r) v[i][r] = tmp[r] + vJ[r];
    }
    crm_apply(v[i], vJ, zeta[i]);
  }
GRID_ROLLED
  for (int i = 0; i < N; ++i) {
    const T* I = R.I + 36 * i;
    T Iv[6];
    matvec6(I, v[i], Iv);
    crf_apply(v[i], Iv, pA[i]);
#pragma unroll
    for (int e = 0; e < 36; ++e) IA[i][e] = I[e];
  }
  // pass 2: articulated inertias and bias forces, leaves to root
GRID_ROLLED
  for (int i = N - 1; i >= 0; --i) {
    const int t = jtype(i);
    const int sv = vstart(i);
    const int w = dof_of_type(t);
    T D[6][6];
GRID_ROLLED
    for (int c = 0; c < w; ++c) {
      T col[6];
      s_col(R, i, t, c, col);
#pragma unroll
      for (int r = 0; r < 6; ++r) {
        T acc = col[0] * IA[i][r * 6];
#pragma unroll
        for (int k = 1; k < 6; ++k) acc += col[k] * IA[i][r * 6 + k];
        U[sv + c][r] = acc;
      }
    }
GRID_ROLLED
    for (int ci = 0; ci < w; ++ci)
GRID_ROLLED
      for (int cj = 0; cj <= ci; ++cj) {
        T d = s_dot(R, i, t, cj, U[sv + ci]);
        if (ci == cj) d = d + R.armature[sv + ci];
        D[ci][cj] = d;
      }
    chol_factor<T, 6>(D, w);
GRID_ROLLED
    for (int ci = 0; ci < w; ++ci)
GRID_ROLLED
      for (int cj = 0; cj <= ci; ++cj) L[sv + ci][cj] = D[ci][cj];
GRID_ROLLED
    for (int c = 0; c < w; ++c)
      ub[sv + c] = (u[sv + c] - R.damping[sv + c] * qd[sv + c]) -
                   s_dot(R, i, t, c, pA[i]);
    // W[r] = D⁻¹·Uᵀ[:, r]; Ia = IA − Σ_c U[:, c]·W[·][c]
    T W[6][6];
#pragma unroll
    for (int r = 0; r < 6; ++r) {
GRID_ROLLED
      for (int c = 0; c < w; ++c) W[r][c] = U[sv + c][r];
      chol_apply<T, 6>(D, W[r], w);
    }
    T Ia[36];
#pragma unroll
    for (int r = 0; r < 6; ++r)
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        T acc = U[sv][r] * W[k][0];
GRID_ROLLED
        for (int c = 1; c < w; ++c) acc += U[sv + c][r] * W[k][c];
        Ia[r * 6 + k] = IA[i][r * 6 + k] - acc;
      }
    T du[6];
GRID_ROLLED
    for (int c = 0; c < w; ++c) du[c] = ub[sv + c];
    chol_apply<T, 6>(D, du, w);
    T pa[6], tmp[6];
    matvec6(Ia, zeta[i], tmp);
#pragma unroll
    for (int r = 0; r < 6; ++r) {
      T s = U[sv][r] * du[0];
GRID_ROLLED
      for (int c = 1; c < w; ++c) s += U[sv + c][r] * du[c];
      pa[r] = (pA[i][r] + tmp[r]) + s;
    }
    const int p = md_parent(i);
    if (p >= 0) {
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
          IA[p][r * 6 + k] = IA[p][r * 6 + k] + acc;
        }
      matvec6_T(X[i], pa, tmp);
#pragma unroll
      for (int r = 0; r < 6; ++r) pA[p][r] = pA[p][r] + tmp[r];
    }
  }
  // pass 3: accelerations, root to leaves (a reuses v's storage)
  T (*a)[6] = v;
GRID_ROLLED
  for (int i = 0; i < N; ++i) {
    const int p = md_parent(i);
    const int t = jtype(i);
    const int sv = vstart(i);
    const int w = dof_of_type(t);
    T ap[6];
    if (p < 0) {
#pragma unroll
      for (int r = 0; r < 6; ++r) ap[r] = X[i][r * 6 + 5] * minus_g + zeta[i][r];
    } else {
      T tmp[6];
      matvec6(X[i], a[p], tmp);
#pragma unroll
      for (int r = 0; r < 6; ++r) ap[r] = tmp[r] + zeta[i][r];
    }
    T D[6][6], x[6];
GRID_ROLLED
    for (int ci = 0; ci < w; ++ci)
GRID_ROLLED
      for (int cj = 0; cj <= ci; ++cj) D[ci][cj] = L[sv + ci][cj];
GRID_ROLLED
    for (int c = 0; c < w; ++c) {
      T acc = U[sv + c][0] * ap[0];
#pragma unroll
      for (int r = 1; r < 6; ++r) acc += U[sv + c][r] * ap[r];
      x[c] = ub[sv + c] - acc;
    }
    chol_apply<T, 6>(D, x, w);
    T sq[6];
    s_times(R, i, t, x, sq);
#pragma unroll
    for (int r = 0; r < 6; ++r) a[i][r] = ap[r] + sq[r];
GRID_ROLLED
    for (int c = 0; c < w; ++c) qdd[sv + c] = x[c];
  }
}

// --------------------------------------------------------------- ∂ID side
// One side of the tangent-space ∂ID over all NV directions: kQ → ∂τ/∂δq,
// else ∂τ/∂q̇ (damping on the diagonal). v, a, f are the sweep at the q̈
// the gradient is taken at, f summed to the root. ∂v_i and ∂a_i are
// nonzero only in the columns of joint i and its ancestors, which precede
// joint i's own: columns past those are neither computed nor read, and
// ∂f_i is kept at full width for the backward sweep.
template <typename T, bool kQ>
__device__ __forceinline__ void md_id_grad_side(
    const MdRobot<T>& R, const T X[N][36], const T* qd, const T v[N][6],
    const T a[N][6], const T f[N][6], T minus_g, T dv[N][6][NV],
    T da[N][6][NV], T df[N][6][NV], T dc[NV][NV]) {
GRID_ROLLED
  for (int i = 0; i < N; ++i) {
    const int p = md_parent(i);
    const int t = jtype(i);
    const int sv = vstart(i);
    const int w = dof_of_type(t);
    const int ve_p = p < 0 ? 0 : vstart(p) + dof_of_type(jtype(p));
    const T* I = R.I + 36 * i;
    T vJ[6], Iv[6];
    s_times(R, i, t, qd + sv, vJ);
    matvec6(I, v[i], Iv);
    // the seeds' bases: crm(X·v_p)·S and crm(X·a_p)·S on the q side (a
    // root's a_p is −g, and a root has no ∂v seed); S and crm(v_i)·S on
    // the q̇ side
    T Xv[6], Xa[6];
    if (kQ) {
      if (p >= 0) {
        matvec6(X[i], v[p], Xv);
        matvec6(X[i], a[p], Xa);
      } else {
#pragma unroll
        for (int r = 0; r < 6; ++r) Xa[r] = X[i][r * 6 + 5] * minus_g;
      }
    }
GRID_ROLLED
    for (int j = 0; j < sv + w; ++j) {
      T dvc[6], dac[6], tmp[6];
      if (j < ve_p) {
#pragma unroll
        for (int r = 0; r < 6; ++r) {
          T accv = X[i][r * 6] * dv[p][0][j];
          T acca = X[i][r * 6] * da[p][0][j];
#pragma unroll
          for (int c = 1; c < 6; ++c) {
            accv += X[i][r * 6 + c] * dv[p][c][j];
            acca += X[i][r * 6 + c] * da[p][c][j];
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
      if (j >= sv) {
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
        dv[i][r][j] = dvc[r];
        da[i][r][j] = dac[r];
        df[i][r][j] = Ida[r] + (A1[r] + A2[r]);
      }
    }
GRID_ROLLED
    for (int j = sv + w; j < NV; ++j)
#pragma unroll
      for (int r = 0; r < 6; ++r) df[i][r][j] = T(0);
  }
  // backward: ∂f_p += X_iᵀ·(∂f_i + crf(S_i)·f_i in i's own columns, q side)
GRID_ROLLED
  for (int i = N - 1; i >= 0; --i) {
    const int p = md_parent(i);
    if (p < 0) continue;
    const int t = jtype(i);
    const int sv = vstart(i);
    const int w = dof_of_type(t);
GRID_ROLLED
    for (int j = 0; j < NV; ++j) {
      T acc[6], up[6];
#pragma unroll
      for (int r = 0; r < 6; ++r) acc[r] = df[i][r][j];
      if (kQ && j >= sv && j < sv + w) {
        T col[6], corr[6];
        s_col(R, i, t, j - sv, col);
        crf_apply(col, f[i], corr);
#pragma unroll
        for (int r = 0; r < 6; ++r) acc[r] = acc[r] + corr[r];
      }
      matvec6_T(X[i], acc, up);
#pragma unroll
      for (int r = 0; r < 6; ++r) df[p][r][j] = df[p][r][j] + up[r];
    }
  }
  // rows ∂τ_(i,c) = S_{i,c}ᵀ·∂f_i (+ damping on the diagonal, q̇ side)
GRID_ROLLED
  for (int i = 0; i < N; ++i) {
    const int t = jtype(i);
    const int sv = vstart(i);
GRID_ROLLED
    for (int c = 0; c < dof_of_type(t); ++c)
GRID_ROLLED
      for (int j = 0; j < NV; ++j) {
        T col[6];
#pragma unroll
        for (int r = 0; r < 6; ++r) col[r] = df[i][r][j];
        T acc = s_dot(R, i, t, c, col);
        if (!kQ && j == sv + c) acc = acc + R.damping[j];
        dc[sv + c][j] = acc;
      }
  }
}

// ------------------------------------------------------ per-state bodies
// Each reads its state column b of q (nq, B) and q̇, q̈, u (nv, B) and
// writes column b of (nv[, nv], B) outputs: element (r, c) of state b lives
// at (r·nv + c)·B + b.
template <typename T, int K>
__device__ __forceinline__ void load_rows(const T* __restrict__ x,
                                          long long B, long long b, T* out) {
GRID_ROLLED
  for (int i = 0; i < K; ++i) out[i] = x[i * B + b];
}

template <typename T>
__device__ __forceinline__ void store_square(const T D[NV][NV], T sign,
                                             long long B, long long b,
                                             T* __restrict__ out) {
GRID_ROLLED
  for (int r = 0; r < NV; ++r)
GRID_ROLLED
    for (int c = 0; c < NV; ++c) out[(r * NV + c) * B + b] = sign * D[r][c];
}

// c(q, q̇[, q̈]) — md_id_fused
template <typename T, bool kQdd>
__device__ __forceinline__ void md_rnea_state(const MdRobot<T>& R, const T* q,
                                              const T* qd, const T* qdd,
                                              T* c_out, long long B,
                                              long long b, T minus_g) {
  T qs[NQ], qds[NV], qdds[NV], c[NV];
  load_rows<T, NQ>(q, B, b, qs);
  load_rows<T, NV>(qd, B, b, qds);
  if (kQdd) load_rows<T, NV>(qdd, B, b, qdds);
  T X[N][36];
  md_transforms(R, qs, X);
  T v[N][6], a[N][6], f[N][6];
  md_rnea<T, kQdd, true>(R, X, qds, qdds, minus_g, v, a, f, c);
GRID_ROLLED
  for (int j = 0; j < NV; ++j) c_out[j * B + b] = c[j];
}

// q̈(q, q̇, u) — md_aba_fused
template <typename T>
__device__ __forceinline__ void md_aba_state(const MdRobot<T>& R, const T* q,
                                             const T* qd, const T* u,
                                             T* qdd_out, long long B,
                                             long long b, T minus_g) {
  T qs[NQ], qds[NV], us[NV], qdd[NV];
  load_rows<T, NQ>(q, B, b, qs);
  load_rows<T, NV>(qd, B, b, qds);
  load_rows<T, NV>(u, B, b, us);
  T X[N][36];
  md_transforms(R, qs, X);
  md_aba(R, X, qds, us, minus_g, qdd);
GRID_ROLLED
  for (int j = 0; j < NV; ++j) qdd_out[j * B + b] = qdd[j];
}

// q̈(q, q̇, u) by the mass matrix — md_fd_fused: X → bias RNEA → CRBA →
// Cholesky → one solve (the head of md_fd_grad_state)
template <typename T>
__device__ __forceinline__ void md_fd_state(const MdRobot<T>& R, const T* q,
                                            const T* qd, const T* u,
                                            T* qdd_out, long long B,
                                            long long b, T minus_g) {
  T qs[NQ], qds[NV], x[NV];
  load_rows<T, NQ>(q, B, b, qs);
  load_rows<T, NV>(qd, B, b, qds);
  load_rows<T, NV>(u, B, b, x);
  T X[N][36];
  md_transforms(R, qs, X);
  {
    T v[N][6], a[N][6], f[N][6], c[NV];
    md_rnea<T, false, true>(R, X, qds, nullptr, minus_g, v, a, f, c);
GRID_ROLLED
    for (int j = 0; j < NV; ++j) x[j] = x[j] - c[j];
  }
  T A[NV][NV];
  md_crba(R, X, A);
  chol_factor<T, NV>(A);
  chol_apply<T, NV>(A, x);
GRID_ROLLED
  for (int j = 0; j < NV; ++j) qdd_out[j * B + b] = x[j];
}

// (∂τ/∂δq, ∂τ/∂q̇) at (q, q̇[, q̈]) — md_id_grad_fused
template <typename T, bool kQdd>
__device__ __forceinline__ void md_id_grad_state(const MdRobot<T>& R,
                                                 const T* q, const T* qd,
                                                 const T* qdd, T* dq_out,
                                                 T* dqd_out, long long B,
                                                 long long b, T minus_g) {
  T qs[NQ], qds[NV], qdds[NV];
  load_rows<T, NQ>(q, B, b, qs);
  load_rows<T, NV>(qd, B, b, qds);
  if (kQdd) load_rows<T, NV>(qdd, B, b, qdds);
  T X[N][36];
  md_transforms(R, qs, X);
  T v[N][6], a[N][6], f[N][6];
  md_rnea<T, kQdd, false>(R, X, qds, qdds, minus_g, v, a, f, nullptr);
  T dv[N][6][NV], da[N][6][NV], df[N][6][NV], dc[NV][NV];
  md_id_grad_side<T, true>(R, X, qds, v, a, f, minus_g, dv, da, df, dc);
  store_square(dc, T(1), B, b, dq_out);
  md_id_grad_side<T, false>(R, X, qds, v, a, f, minus_g, dv, da, df, dc);
  store_square(dc, T(1), B, b, dqd_out);
}

// (∂q̈/∂δq, ∂q̈/∂q̇, ∂q̈/∂u) — md_fd_grad_fused: X → bias RNEA → CRBA →
// Cholesky → q̈ → v/a/f at q̈ → ∂ID one side at a time → −M⁻¹·∂c by the
// factor, then M⁻¹ = L⁻ᵀL⁻¹
template <typename T>
__device__ __forceinline__ void md_fd_grad_state(const MdRobot<T>& R,
                                                 const T* q, const T* qd,
                                                 const T* u, T* dq_out,
                                                 T* dqd_out, T* du_out,
                                                 long long B, long long b,
                                                 T minus_g) {
  T qs[NQ], qds[NV], x[NV];
  load_rows<T, NQ>(q, B, b, qs);
  load_rows<T, NV>(qd, B, b, qds);
  load_rows<T, NV>(u, B, b, x);
  T X[N][36];
  md_transforms(R, qs, X);
  T v[N][6], a[N][6], f[N][6];
  {
    T c[NV];
    md_rnea<T, false, true>(R, X, qds, nullptr, minus_g, v, a, f, c);
GRID_ROLLED
    for (int j = 0; j < NV; ++j) x[j] = x[j] - c[j];
  }
  T A[NV][NV];
  md_crba(R, X, A);
  chol_factor<T, NV>(A);
  chol_apply<T, NV>(A, x);  // x = q̈
  md_rnea<T, true, false>(R, X, qds, x, minus_g, v, a, f, nullptr);
  T dv[N][6][NV], da[N][6][NV], df[N][6][NV], dc[NV][NV];
  md_id_grad_side<T, true>(R, X, qds, v, a, f, minus_g, dv, da, df, dc);
  chol_solve<T, NV, NV>(A, dc);
  store_square(dc, T(-1), B, b, dq_out);
  md_id_grad_side<T, false>(R, X, qds, v, a, f, minus_g, dv, da, df, dc);
  chol_solve<T, NV, NV>(A, dc);
  store_square(dc, T(-1), B, b, dqd_out);
  chol_inverse<T, NV>(A);
  store_square(A, T(1), B, b, du_out);
}

}  // namespace grid
