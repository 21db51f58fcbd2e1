// Rigid-body dynamics device functions for one state per thread.
//
// The CUDA counterpart of the batch-last bodies in
// gridcodegenerator_tpu/ops/blops.py (joint_transforms_bl, rnea_fwd_bl,
// rnea_bwd_bl, minv_bl + densify_rows, rnea_grad_inner_bl, matmatN), which
// the Pallas kernels of gridcodegenerator_tpu/ops/kernels/fused.py run on
// VMEM tiles. Here each thread owns one state and runs the whole recursion
// on it; the per-state arrays live in local memory (see fused.cu for what
// that costs), the 6-wide temporaries in registers.
//
// The robot is a compile-time constant: the build passes
//   -DGRID_N=<joints> -DGRID_PARENTS=G(p0)G(p1)... -DGRID_PRISMATIC=G(0)G(1)...
// (nvcc splits -D values at commas, hence the G() list form) so every joint
// loop unrolls and every parent index folds. The numeric
// constants arrive at run time in one packed buffer (RobotModel.packed):
//   Xb, Xs, Xc (N·36 each), S (N·6), inertia (N·36), damping (N), armature (N)
// which the kernels stage into shared memory.
//
// Every sum runs in the order of the plain PyTorch version
// (gridcodegenerator_tpu_torch/ops/blops.py); nvcc's FMA contraction is the
// only difference in rounding.
//
// The recursions are templates on the value type T, and the robot's
// constants are of its base type base_t<T>: T itself for float and double,
// and the underlying float or double for the dual numbers of dual.cuh,
// whose instances of the same bodies are their forward-mode derivatives
// (the second-order kernels, so.cu). The 6-vector helpers take each operand
// in its own type, so a constant times a dual number costs two products,
// not four.
#pragma once

#ifndef GRID_N
#error "compile with -DGRID_N=<joints> -DGRID_PARENTS=G(..)... -DGRID_PRISMATIC=G(..)..."
#endif

// Loops over joints and over the n gradient columns stay rolled: the arrays
// they index live in local memory either way, and unrolling them made
// ptxas take minutes per topology. The loops over the 6 (or 36) spatial
// components unroll, so those temporaries stay in registers.
#define GRID_ROLLED _Pragma("unroll 1")

namespace grid {

constexpr int N = GRID_N;
#define G(x) x,
constexpr int kConstCount = 152 * N;  // length of the packed constant buffer

__host__ __device__ constexpr int parent(int i) {
  constexpr int p[N] = {GRID_PARENTS};
  return p[i];
}

__host__ __device__ constexpr bool prismatic(int i) {
  constexpr int t[N] = {GRID_PRISMATIC};
  return t[i] != 0;
}
#undef G

// The type of the robot's constants for values of type T (dual.cuh
// specialises it for its dual numbers).
template <typename T>
struct Base {
  using type = T;
};
template <typename T>
using base_t = typename Base<T>::type;

// Views into the packed constants (shared memory in the kernels).
template <typename T>
struct Robot {
  const T* Xb;
  const T* Xs;
  const T* Xc;
  const T* S;
  const T* I;
  const T* damping;
  const T* armature;
  __host__ __device__ explicit Robot(const T* base)
      : Xb(base), Xs(base + 36 * N), Xc(base + 72 * N), S(base + 108 * N),
        I(base + 114 * N), damping(base + 150 * N),
        armature(base + 151 * N) {}
};

__device__ __forceinline__ void sincos_t(float x, float* s, float* c) {
  sincosf(x, s, c);
}
__device__ __forceinline__ void sincos_t(double x, double* s, double* c) {
  sincos(x, s, c);
}

// ---------------------------------------------------------------- 6-vectors
// out[r] = Σ_c X[r][c]·v[c]
template <typename A, typename V, typename T>
__device__ __forceinline__ void matvec6(const A* X, const V* v, T* out) {
#pragma unroll
  for (int r = 0; r < 6; ++r) {
    T acc = X[r * 6] * v[0];
#pragma unroll
    for (int c = 1; c < 6; ++c) acc += X[r * 6 + c] * v[c];
    out[r] = acc;
  }
}

// out[r] = Σ_c X[c][r]·v[c]  (Xᵀ·v)
template <typename A, typename V, typename T>
__device__ __forceinline__ void matvec6_T(const A* X, const V* v, T* out) {
#pragma unroll
  for (int r = 0; r < 6; ++r) {
    T acc = X[r] * v[0];
#pragma unroll
    for (int c = 1; c < 6; ++c) acc += X[c * 6 + r] * v[c];
    out[r] = acc;
  }
}

template <typename A, typename V, typename T>
__device__ __forceinline__ void cross3(const A* a, const V* b, T* out) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

// m × x = [ω_m×x_ω ; ω_m×x_v + v_m×x_ω]
template <typename A, typename V, typename T>
__device__ __forceinline__ void crm_apply(const A* m, const V* x, T* out) {
  T t1[3], t2[3];
  cross3(m, x, out);
  cross3(m, x + 3, t1);
  cross3(m + 3, x, t2);
#pragma unroll
  for (int k = 0; k < 3; ++k) out[3 + k] = t1[k] + t2[k];
}

// m ×* x = [ω_m×x_ω + v_m×x_v ; ω_m×x_v]
template <typename A, typename V, typename T>
__device__ __forceinline__ void crf_apply(const A* m, const V* x, T* out) {
  T t1[3], t2[3];
  cross3(m, x, t1);
  cross3(m + 3, x + 3, t2);
#pragma unroll
  for (int k = 0; k < 3; ++k) out[k] = t1[k] + t2[k];
  cross3(m, x + 3, out + 3);
}

// -------------------------------------------------------- joint transforms
// X_i = Xb_i + f1·Xs_i (+ f2·Xc_i): (sin, cos) for revolute, q for prismatic
template <typename T>
__device__ __forceinline__ void joint_transforms(const Robot<base_t<T>>& R,
                                                 const T* q, T X[N][36]) {
GRID_ROLLED
  for (int i = 0; i < N; ++i) {
    if (prismatic(i)) {
#pragma unroll
      for (int e = 0; e < 36; ++e)
        X[i][e] = R.Xb[i * 36 + e] + R.Xs[i * 36 + e] * q[i];
    } else {
      T s, c;
      sincos_t(q[i], &s, &c);
#pragma unroll
      for (int e = 0; e < 36; ++e)
        X[i][e] = R.Xb[i * 36 + e] + R.Xs[i * 36 + e] * s +
                  R.Xc[i * 36 + e] * c;
    }
  }
}

// -------------------------------------------------------------------- RNEA
// Forward sweep (rnea_fwd_bl). kQdd adds S·q̈; kVKnown reuses v.
template <typename T, bool kQdd, bool kVKnown>
__device__ __forceinline__ void rnea_fwd(const Robot<base_t<T>>& R,
                                         const T X[N][36], const T* qd,
                                         const T* qdd, T minus_g,
                                         T v[N][6], T a[N][6], T f[N][6]) {
GRID_ROLLED
  for (int i = 0; i < N; ++i) {
    const int p = parent(i);
    const auto* S = R.S + 6 * i;
    T Sqd[6], t[6];
#pragma unroll
    for (int r = 0; r < 6; ++r) Sqd[r] = S[r] * qd[i];
    if (!kVKnown) {
      if (p < 0) {
#pragma unroll
        for (int r = 0; r < 6; ++r) v[i][r] = Sqd[r];
      } else {
        matvec6(X[i], v[p], t);
#pragma unroll
        for (int r = 0; r < 6; ++r) v[i][r] = t[r] + Sqd[r];
      }
    }
    T ai[6];
    if (p < 0) {
      // X·a_base with a_base = [0,…,0,−gravity]: column 5 of X scaled
#pragma unroll
      for (int r = 0; r < 6; ++r) ai[r] = X[i][r * 6 + 5] * minus_g;
    } else {
      matvec6(X[i], a[p], ai);
    }
    crm_apply(v[i], Sqd, t);
#pragma unroll
    for (int r = 0; r < 6; ++r) ai[r] += t[r];
    if (kQdd) {
#pragma unroll
      for (int r = 0; r < 6; ++r) ai[r] += S[r] * qdd[i];
    }
#pragma unroll
    for (int r = 0; r < 6; ++r) a[i][r] = ai[r];
  }
GRID_ROLLED
  for (int i = 0; i < N; ++i) {
    const auto* I = R.I + 36 * i;
    T Iv[6], Ia[6], t[6];
    matvec6(I, v[i], Iv);
    matvec6(I, a[i], Ia);
    crf_apply(v[i], Iv, t);
#pragma unroll
    for (int r = 0; r < 6; ++r) f[i][r] = Ia[r] + t[r];
  }
}

// Backward sweep (rnea_bwd_bl): wrenches to the root; with kTorque also
// c_i = S_iᵀf_i + damping_i·q̇_i (+ armature_i·q̈_i with kQdd).
template <typename T, bool kTorque, bool kQdd>
__device__ __forceinline__ void rnea_bwd(const Robot<base_t<T>>& R,
                                         const T X[N][36], T f[N][6],
                                         const T* qd, const T* qdd, T* c) {
GRID_ROLLED
  for (int i = N - 1; i >= 0; --i) {
    const int p = parent(i);
    if (p >= 0) {
      T t[6];
      matvec6_T(X[i], f[i], t);
#pragma unroll
      for (int r = 0; r < 6; ++r) f[p][r] += t[r];
    }
  }
  if (kTorque) {
GRID_ROLLED
    for (int i = 0; i < N; ++i) {
      const auto* S = R.S + 6 * i;
      T acc = S[0] * f[i][0];
#pragma unroll
      for (int r = 1; r < 6; ++r) acc += S[r] * f[i][r];
      acc = acc + R.damping[i] * qd[i];
      if (kQdd) acc = acc + R.armature[i] * qdd[i];
      c[i] = acc;
    }
  }
}

// -------------------------------------------------------------- direct M⁻¹
// The articulated recursion (minv_bl), then densify_rows: M is the dense
// symmetric M⁻¹ on return.
template <typename T>
__device__ __forceinline__ void minv(const Robot<base_t<T>>& R,
                                     const T X[N][36],
                                     T M[N][N]) {
  T IA[N][36];
  T F[N][6][N];
  T U[N][6];
  T Dinv[N];
GRID_ROLLED
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int e = 0; e < 36; ++e) IA[i][e] = R.I[36 * i + e];
#pragma unroll
    for (int r = 0; r < 6; ++r)
GRID_ROLLED
      for (int j = 0; j < N; ++j) F[i][r][j] = T(0);
  }
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
    Dinv[i] = Di;
    // row = e_i·D⁻¹ − D⁻¹·SᵀF
GRID_ROLLED
    for (int j = 0; j < N; ++j) {
      T sf = S[0] * F[i][0][j];
#pragma unroll
      for (int c = 1; c < 6; ++c) sf += S[c] * F[i][c][j];
      M[i][j] = (j == i ? Di : T(0)) - Di * sf;
    }
    if (p >= 0) {
#pragma unroll
      for (int r = 0; r < 6; ++r)
GRID_ROLLED
        for (int j = 0; j < N; ++j) F[i][r][j] += U[i][r] * M[i][j];
      // F_p += Xᵀ·F_i
#pragma unroll
      for (int r = 0; r < 6; ++r)
GRID_ROLLED
        for (int j = 0; j < N; ++j) {
          T acc = X[i][r] * F[i][0][j];
#pragma unroll
          for (int c = 1; c < 6; ++c) acc += X[i][c * 6 + r] * F[i][c][j];
          F[p][r][j] += acc;
        }
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
  }
  // serial forward sweep over the columns j ≥ i
GRID_ROLLED
  for (int i = 0; i < N; ++i) {
    const int p = parent(i);
    const auto* S = R.S + 6 * i;
    if (p >= 0) {
      T UX[6];
      matvec6_T(X[i], U[i], UX);
GRID_ROLLED
      for (int j = i; j < N; ++j) {
        T corr = UX[0] * F[p][0][j];
#pragma unroll
        for (int c = 1; c < 6; ++c) corr += UX[c] * F[p][c][j];
        M[i][j] = M[i][j] - Dinv[i] * corr;
      }
    }
GRID_ROLLED
    for (int j = i; j < N; ++j)
#pragma unroll
      for (int r = 0; r < 6; ++r) {
        T val = S[r] * M[i][j];
        if (p >= 0) {
          T acc = X[i][r * 6] * F[p][0][j];
#pragma unroll
          for (int c = 1; c < 6; ++c) acc += X[i][r * 6 + c] * F[p][c][j];
          val = val + acc;
        }
        F[i][r][j] = val;
      }
  }
GRID_ROLLED
  for (int r = 1; r < N; ++r)
GRID_ROLLED
    for (int c = 0; c < r; ++c) M[r][c] = M[c][r];
}

// --------------------------------------------------------------- ∂ID side
// One differentiation side of rnea_grad_inner_bl: kQ → ∂c/∂q, else ∂c/∂q̇
// (with damping on the diagonal). v, a, f are the RNEA sweep at the q̈ the
// gradient is taken at, f already summed to the root.
template <typename T, bool kQ>
__device__ __forceinline__ void id_grad_side(const Robot<base_t<T>>& R,
                                             const T X[N][36], const T* qd,
                                             const T v[N][6],
                                             const T a[N][6],
                                             const T f[N][6], T minus_g,
                                             T dc[N][N]) {
  // ∂v_i, ∂a_i are nonzero only in columns [0, i] (ancestor sparsity);
  // ∂f_i is kept at full width for the backward sweep.
  T dv[N][6][N];
  T da[N][6][N];
  T df[N][6][N];
GRID_ROLLED
  for (int i = 0; i < N; ++i) {
    const int p = parent(i);
    const auto* S = R.S + 6 * i;
    const auto* I = R.I + 36 * i;
    // ---- ∂v_i = X_i·∂v_p, plus the seed column i
    T seed[6];
    if (kQ) {
      if (p >= 0) {
        T Xv[6], t[6];
        matvec6(X[i], v[p], Xv);
        crm_apply(S, Xv, t);
#pragma unroll
        for (int r = 0; r < 6; ++r) seed[r] = -t[r];
      } else {
#pragma unroll
        for (int r = 0; r < 6; ++r) seed[r] = T(0);
      }
    } else {
#pragma unroll
      for (int r = 0; r < 6; ++r) seed[r] = S[r];
    }
GRID_ROLLED
    for (int j = 0; j < i; ++j)
#pragma unroll
      for (int r = 0; r < 6; ++r) {
        if (j <= p) {
          T acc = X[i][r * 6] * dv[p][0][j];
#pragma unroll
          for (int c = 1; c < 6; ++c) acc += X[i][r * 6 + c] * dv[p][c][j];
          dv[i][r][j] = acc;
        } else {
          dv[i][r][j] = T(0);
        }
      }
#pragma unroll
    for (int r = 0; r < 6; ++r) dv[i][r][i] = seed[r];
    // ---- ∂a_i = −q̇_i·(S×∂v_i) + seed column i, then + X_i·∂a_p
    T seed2[6];
    {
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
    const T nqd = -qd[i];
GRID_ROLLED
    for (int j = 0; j <= i; ++j) {
      T col[6], t[6];
#pragma unroll
      for (int r = 0; r < 6; ++r) col[r] = dv[i][r][j];
      crm_apply(S, col, t);
#pragma unroll
      for (int r = 0; r < 6; ++r) {
        T val = nqd * t[r];
        if (j == i) val = val + seed2[r];
        da[i][r][j] = val;
      }
    }
    if (p >= 0) {
GRID_ROLLED
      for (int j = 0; j <= p; ++j)
#pragma unroll
        for (int r = 0; r < 6; ++r) {
          T acc = X[i][r * 6] * da[p][0][j];
#pragma unroll
          for (int c = 1; c < 6; ++c) acc += X[i][r * 6 + c] * da[p][c][j];
          da[i][r][j] = da[i][r][j] + acc;
        }
    }
    // ---- ∂f_i = crf(∂v)·Iv + I·∂a + crf(v)·(I·∂v), columns [0, i]
    T Iv[6];
    matvec6(I, v[i], Iv);
GRID_ROLLED
    for (int j = 0; j <= i; ++j) {
      T dvc[6], dac[6], A[6], Bv[6], Idv[6], C[6];
#pragma unroll
      for (int r = 0; r < 6; ++r) {
        dvc[r] = dv[i][r][j];
        dac[r] = da[i][r][j];
      }
      crf_apply(dvc, Iv, A);
      matvec6(I, dac, Bv);
      matvec6(I, dvc, Idv);
      crf_apply(v[i], Idv, C);
#pragma unroll
      for (int r = 0; r < 6; ++r) df[i][r][j] = (A[r] + Bv[r]) + C[r];
    }
GRID_ROLLED
    for (int j = i + 1; j < N; ++j)
#pragma unroll
      for (int r = 0; r < 6; ++r) df[i][r][j] = T(0);
  }
  // ---- backward: ∂f_p += X_iᵀ·∂f_i (+ X_iᵀ·(S×*f_i) into column i, q side)
GRID_ROLLED
  for (int i = N - 1; i >= 0; --i) {
    const int p = parent(i);
    if (p < 0) continue;
GRID_ROLLED
    for (int j = 0; j < N; ++j)
#pragma unroll
      for (int r = 0; r < 6; ++r) {
        T acc = X[i][r] * df[i][0][j];
#pragma unroll
        for (int c = 1; c < 6; ++c) acc += X[i][c * 6 + r] * df[i][c][j];
        df[p][r][j] = df[p][r][j] + acc;
      }
    if (kQ) {
      T sxf[6], t[6];
      crf_apply(R.S + 6 * i, f[i], sxf);
      matvec6_T(X[i], sxf, t);
#pragma unroll
      for (int r = 0; r < 6; ++r) df[p][r][i] = df[p][r][i] + t[r];
    }
  }
  // ---- dc_i = S_iᵀ·∂f_i
GRID_ROLLED
  for (int i = 0; i < N; ++i) {
    const auto* S = R.S + 6 * i;
GRID_ROLLED
    for (int j = 0; j < N; ++j) {
      T acc = S[0] * df[i][0][j];
#pragma unroll
      for (int r = 1; r < 6; ++r) acc += S[r] * df[i][r][j];
      if (!kQ && j == i) acc = acc + R.damping[i];
      dc[i][j] = acc;
    }
  }
}

// CRBA + Cholesky dense M⁻¹ (staged.cuh): the alternative M⁻¹ stage of
// fd_grad_state<T, true>
template <typename T>
__device__ __forceinline__ void dense_minv(const Robot<base_t<T>>& R,
                                           const T X[N][36], T M[N][N]);

// ------------------------------------------------------ per-state bodies
// Each reads its state column b of (n, B) inputs and writes column b of
// (n[, n], B) outputs: element (r, c) of state b lives at (r·n + c)·B + b.

template <typename T>
__device__ __forceinline__ void load_col(const T* __restrict__ x, long long B,
                                         long long b, T* out) {
GRID_ROLLED
  for (int i = 0; i < N; ++i) out[i] = x[i * B + b];
}

template <typename T>
__device__ __forceinline__ void store_mat(const T D[N][N], long long B,
                                          long long b, T* __restrict__ out) {
GRID_ROLLED
  for (int r = 0; r < N; ++r)
GRID_ROLLED
    for (int c = 0; c < N; ++c) out[(r * N + c) * B + b] = D[r][c];
}

// the staged (6, n, B) per-joint vectors (v, a, f): element (r, i) of state
// b at (r·n + i)·B + b
template <typename T>
__device__ __forceinline__ void load_vec6(const T* __restrict__ x, long long B,
                                          long long b, T out[N][6]) {
GRID_ROLLED
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int r = 0; r < 6; ++r) out[i][r] = x[(r * N + i) * B + b];
}

template <typename T>
__device__ __forceinline__ void store_vec6(const T in[N][6], long long B,
                                           long long b, T* __restrict__ x) {
GRID_ROLLED
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int r = 0; r < 6; ++r) x[(r * N + i) * B + b] = in[i][r];
}

// out = −M⁻¹·D (matmatN with negate)
template <typename T>
__device__ __forceinline__ void store_neg_minv_times(const T M[N][N],
                                                     const T D[N][N],
                                                     long long B, long long b,
                                                     T* __restrict__ out) {
GRID_ROLLED
  for (int r = 0; r < N; ++r)
GRID_ROLLED
    for (int c = 0; c < N; ++c) {
      T acc = M[r][0] * D[0][c];
GRID_ROLLED
      for (int k = 1; k < N; ++k) acc += M[r][k] * D[k][c];
      out[(r * N + c) * B + b] = -acc;
    }
}

// c(q, q̇[, q̈]) — inverse_dynamics_fused
template <typename T, bool kQdd>
__device__ __forceinline__ void rnea_state(const Robot<T>& R, const T* q,
                                           const T* qd, const T* qdd,
                                           T* c_out, long long B, long long b,
                                           T minus_g) {
  T qs[N], qds[N], qdds[N], c[N];
  load_col(q, B, b, qs);
  load_col(qd, B, b, qds);
  if (kQdd) load_col(qdd, B, b, qdds);
  T X[N][36];
  joint_transforms(R, qs, X);
  T v[N][6], a[N][6], f[N][6];
  rnea_fwd<T, kQdd, false>(R, X, qds, qdds, minus_g, v, a, f);
  rnea_bwd<T, true, kQdd>(R, X, f, qds, qdds, c);
GRID_ROLLED
  for (int i = 0; i < N; ++i) c_out[i * B + b] = c[i];
}

// dense M⁻¹(q) — minv_fused
template <typename T>
__device__ __forceinline__ void minv_state(const Robot<T>& R, const T* q,
                                           T* M_out, long long B,
                                           long long b) {
  T qs[N];
  load_col(q, B, b, qs);
  T X[N][36];
  joint_transforms(R, qs, X);
  T M[N][N];
  minv(R, X, M);
  store_mat(M, B, b, M_out);
}

// (∂c/∂q, ∂c/∂q̇) at (q, q̇, q̈) — id_grad_fused
template <typename T>
__device__ __forceinline__ void id_grad_state(const Robot<T>& R, const T* q,
                                              const T* qd, const T* qdd,
                                              T* dq_out, T* dqd_out,
                                              long long B, long long b,
                                              T minus_g) {
  T qs[N], qds[N], qdds[N];
  load_col(q, B, b, qs);
  load_col(qd, B, b, qds);
  load_col(qdd, B, b, qdds);
  T X[N][36];
  joint_transforms(R, qs, X);
  T v[N][6], a[N][6], f[N][6];
  rnea_fwd<T, true, false>(R, X, qds, qdds, minus_g, v, a, f);
  rnea_bwd<T, false, false>(R, X, f, qds, qdds, nullptr);
  T dc[N][N];
  id_grad_side<T, true>(R, X, qds, v, a, f, minus_g, dc);
  store_mat(dc, B, b, dq_out);
  id_grad_side<T, false>(R, X, qds, v, a, f, minus_g, dc);
  store_mat(dc, B, b, dqd_out);
}

// q̈ = M⁻¹(u − c) — forward_dynamics_fused, the composition form: bias
// RNEA, the articulated M⁻¹, one matvec
template <typename T>
__device__ __forceinline__ void fd_state(const Robot<T>& R, const T* q,
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
  T M[N][N];
  minv(R, X, M);
  T x[N];
GRID_ROLLED
  for (int k = 0; k < N; ++k) x[k] = us[k] - c[k];
GRID_ROLLED
  for (int r = 0; r < N; ++r) {
    T acc = M[r][0] * x[0];
GRID_ROLLED
    for (int k = 1; k < N; ++k) acc += M[r][k] * x[k];
    qdd_out[r * B + b] = acc;
  }
}

// (∂q̈/∂q, ∂q̈/∂q̇) — fd_grad_fused: X → bias RNEA → M⁻¹ → q̈ → second
// RNEA sweep (v reused) → ∂ID one side at a time → −M⁻¹·∂c. kDense takes
// M⁻¹ from CRBA + Cholesky (minv_impl="dense") instead of the articulated
// recursion.
template <typename T, bool kDense = false>
__device__ __forceinline__ void fd_grad_state(const Robot<T>& R, const T* q,
                                              const T* qd, const T* u,
                                              T* ddq_out, T* ddqd_out,
                                              long long B, long long b,
                                              T minus_g) {
  T qs[N], qds[N], us[N], c[N];
  load_col(q, B, b, qs);
  load_col(qd, B, b, qds);
  load_col(u, B, b, us);
  T X[N][36];
  joint_transforms(R, qs, X);
  T v[N][6], a[N][6], f[N][6];
  rnea_fwd<T, false, false>(R, X, qds, nullptr, minus_g, v, a, f);
  rnea_bwd<T, true, false>(R, X, f, qds, nullptr, c);
  T M[N][N];
  if constexpr (kDense) {
    dense_minv(R, X, M);
  } else {
    minv(R, X, M);
  }
  T x[N], qdd[N];
GRID_ROLLED
  for (int k = 0; k < N; ++k) x[k] = us[k] - c[k];
GRID_ROLLED
  for (int r = 0; r < N; ++r) {
    T acc = M[r][0] * x[0];
GRID_ROLLED
    for (int k = 1; k < N; ++k) acc += M[r][k] * x[k];
    qdd[r] = acc;
  }
  rnea_fwd<T, true, true>(R, X, qds, qdd, minus_g, v, a, f);
  rnea_bwd<T, false, false>(R, X, f, qds, nullptr, nullptr);
  T dc[N][N];
  id_grad_side<T, true>(R, X, qds, v, a, f, minus_g, dc);
  store_neg_minv_times(M, dc, B, b, ddq_out);
  id_grad_side<T, false>(R, X, qds, v, a, f, minus_g, dc);
  store_neg_minv_times(M, dc, B, b, ddqd_out);
}

}  // namespace grid
