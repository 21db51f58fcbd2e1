// The robot-independent pieces of the frictional ground steps, one state per
// thread: shared by the free-flyer kernels (ff.cuh: the stance FD and the
// ground step of step_ground_fused / step_ground_terrain_fused) and the
// multi-dof ground step (md_step.cuh: md_step_ground_fused).
//
// The CUDA counterparts of helpers of
// gridcodegenerator_tpu/ops/kernels/contact_fused.py (ported in
// gridcodegenerator_tpu_torch/ops/kernels/contact_fused.py):
//   ptri_factor      _chol_factor_act (:39) on a packed lower triangle, with
//                    the Delassus reg
//   ptri_apply       _chol_apply_e: K right-hand sides entry by entry
//   ptri_solve       _chol_solve_act: one right-hand side, column-oriented
//   quat_rot, mv3    _quat_rot_s, _mv3s
//   quat_mul4        _quat_mul_s; quat_exp: _quat_exp_s (:104)
//   terrain_frame    _terrain_surface_s (:735): a bilinear heightfield's
//                    height and contact frame
//   pgs              _pgs_rows (:1128): projected Gauss–Seidel on the
//                    friction cones (and EQ trailing bilateral rows)
//   seg_seg_closest  _seg_seg_closest_s (:497): the clamped closest points
//                    of two segments
//   pair_geometry    _pair_geometry_s (:514): two capsules' gap, normal and
//                    contact point
//   contact_frame3   _frame_rows_s (:526): the branchless frame of a normal
// (the plain versions of the last three: ops/collision.py's _bl helpers).
// Every sum runs in the order of the plain versions.
#pragma once

#include "rbd.cuh"

#ifndef GRID_ROLLED
#define GRID_ROLLED _Pragma("unroll 1")
#endif

namespace grid {

// packed lower triangle, row i ≥ column j
__host__ __device__ constexpr int tri(int i, int j) {
  return i * (i + 1) / 2 + j;
}

// ------------------------------------------------------ packed Cholesky
// The left-looking column factor of chol.cuh (_chol_factor_act) on a packed
// lower triangle, in place; reg is added to each diagonal entry before its
// column update.
template <typename T, int M>
__device__ __forceinline__ void ptri_factor(T* A, T reg) {
GRID_ROLLED
  for (int j = 0; j < M; ++j) {
GRID_ROLLED
    for (int i = j; i < M; ++i) {
      T c = A[tri(i, j)];
      if (i == j && reg != T(0)) c = c + reg;
GRID_ROLLED
      for (int p = 0; p < j; ++p) c = c - A[tri(i, p)] * A[tri(j, p)];
      A[tri(i, j)] = c;
    }
    const T s = sqrt(A[tri(j, j)]);
GRID_ROLLED
    for (int i = j; i < M; ++i) A[tri(i, j)] = A[tri(i, j)] / s;
  }
}

// (L·Lᵀ)·x = r in place for K right-hand sides, entry by entry with each
// row's terms in ascending order (_chol_apply_e); x(i, k) is a reference to
// right-hand side k's row i (each caller indexes its own array, so no
// pointer walks past the row it was taken from).
template <typename T, int M, int K, typename Rhs>
__device__ __forceinline__ void ptri_apply(const T* L, Rhs x) {
GRID_ROLLED
  for (int i = 0; i < M; ++i)
GRID_ROLLED
    for (int k = 0; k < K; ++k) {
      T s = x(i, k);
GRID_ROLLED
      for (int p = 0; p < i; ++p) s = s + (-L[tri(i, p)]) * x(p, k);
      x(i, k) = s / L[tri(i, i)];
    }
GRID_ROLLED
  for (int i = M - 1; i >= 0; --i)
GRID_ROLLED
    for (int k = 0; k < K; ++k) {
      T s = x(i, k);
GRID_ROLLED
      for (int p = i + 1; p < M; ++p) s = s + (-L[tri(p, i)]) * x(p, k);
      x(i, k) = s / L[tri(i, i)];
    }
}

// (L·Lᵀ)·x = r in place, one right-hand side, column-oriented: the back
// substitution subtracts Σ_{r>j} L[r][j]·x[r] at once (_chol_solve_act).
template <typename T, int M>
__device__ __forceinline__ void ptri_solve(const T* L, T* x) {
GRID_ROLLED
  for (int j = 0; j < M; ++j) {
    x[j] = x[j] / L[tri(j, j)];
GRID_ROLLED
    for (int r = j + 1; r < M; ++r) x[r] = x[r] - L[tri(r, j)] * x[j];
  }
GRID_ROLLED
  for (int j = M - 1; j >= 0; --j) {
    if (j + 1 < M) {
      T corr = L[tri(j + 1, j)] * x[j + 1];
GRID_ROLLED
      for (int r = j + 2; r < M; ++r) corr += L[tri(r, j)] * x[r];
      x[j] = (x[j] - corr) / L[tri(j, j)];
    } else {
      x[j] = x[j] / L[tri(j, j)];
    }
  }
}

// R(quat), world ← base, row-major (_quat_rot_s)
template <typename TT>
__device__ __forceinline__ void quat_rot(const TT* qt, TT* Rm) {
  using B = base_t<TT>;
  const B one(1), two(2);
  const TT w = qt[0], x = qt[1], y = qt[2], z = qt[3];
  Rm[0] = one - two * (y * y + z * z);
  Rm[1] = two * (x * y - w * z);
  Rm[2] = two * (x * z + w * y);
  Rm[3] = two * (x * y + w * z);
  Rm[4] = one - two * (x * x + z * z);
  Rm[5] = two * (y * z - w * x);
  Rm[6] = two * (x * z - w * y);
  Rm[7] = two * (y * z + w * x);
  Rm[8] = one - two * (x * x + y * y);
}

// out[r] = Σ_k A[r][k]·x[k], 3×3 row-major (_mv3s)
template <typename A, typename V, typename TT>
__device__ __forceinline__ void mv3(const A* M, const V* x, TT* out) {
#pragma unroll
  for (int r = 0; r < 3; ++r)
    out[r] = M[r * 3] * x[0] + M[r * 3 + 1] * x[1] + M[r * 3 + 2] * x[2];
}

// read-only loads of the height grid (a plain load where this compiles as
// host C++)
#ifdef __CUDA_ARCH__
#define GRID_LDG(p) __ldg(p)
#else
#define GRID_LDG(p) (*(p))
#endif

// The run-time scalars of the frictional ground step, in T (the plain
// version's Python floats meet its tensors in their dtype). inv_dt is 1/dt
// formed in double: torch divides a tensor by a Python float as a product
// with that reciprocal.
template <typename T>
struct StepParams {
  T dt, inv_dt, ground_z, minus_g, neg_erp, margin, restitution;
  int iters;
};

// A bilinear heightfield: node (i, j) at (x0 + i·cell, y0 + j·cell) is
// h[i·W + j], read from device memory (no grid size is too large);
// inv_cell is 1/cell formed in double (as StepParams' inv_dt).
template <typename T>
struct Heightfield {
  const T* __restrict__ h;
  int H, W;
  T cell, inv_cell, x0, y0;
};

// Height and contact frame rows C = [t1; t2; n] at world (px, py)
// (terrain_height_grad, terrain_surface and contact_frame of
// ops/terrain.py): the cell index clipped to the grid, so outside it the
// edge cell's surface continues. t1 = (n_z, 0, −n_x)/‖·‖ has a structural
// zero, whose products the rows skip (x + 0·y = x).
template <typename T>
__device__ __forceinline__ void terrain_frame(const Heightfield<T>& hf, T px,
                                              T py, T* h, T C[3][3]) {
  const T one(1);
  // ÷ cell as the plain version's division by a Python float
  const T u = (px - hf.x0) * hf.inv_cell;
  const T v = (py - hf.y0) * hf.inv_cell;
  T iu = floor(u), iv = floor(v);
  iu = iu < T(0) ? T(0) : (iu > T(hf.H - 2) ? T(hf.H - 2) : iu);
  iv = iv < T(0) ? T(0) : (iv > T(hf.W - 2) ? T(hf.W - 2) : iv);
  const T fu = u - iu, fv = v - iv;
  const int idx = static_cast<int>(iu) * hf.W + static_cast<int>(iv);
  const T h00 = GRID_LDG(hf.h + idx), h10 = GRID_LDG(hf.h + idx + hf.W);
  const T h01 = GRID_LDG(hf.h + idx + 1);
  const T h11 = GRID_LDG(hf.h + idx + hf.W + 1);
  *h = (one - fu) * (one - fv) * h00 + fu * (one - fv) * h10 +
       (one - fu) * fv * h01 + fu * fv * h11;
  const T hx = ((one - fv) * (h10 - h00) + fv * (h11 - h01)) * hf.inv_cell;
  const T hy = ((one - fu) * (h01 - h00) + fu * (h11 - h10)) * hf.inv_cell;
  const T inv = one / sqrt(hx * hx + hy * hy + one);
  const T nx = -hx * inv, ny = -hy * inv, nz = inv;
  const T it = one / sqrt(nz * nz + nx * nx);
  C[0][0] = nz * it;
  C[0][1] = T(0);
  C[0][2] = -nx * it;
  C[1][0] = ny * C[0][2];                   // − n_z·0
  C[1][1] = nz * C[0][0] - nx * C[0][2];
  C[1][2] = -(ny * C[0][0]);                // n_x·0 − n_y·t1_x
  C[2][0] = nx;
  C[2][1] = ny;
  C[2][2] = nz;
}

// a ⊗ b, (w, x, y, z) (_quat_mul_s)
template <typename T>
__device__ __forceinline__ void quat_mul4(const T* a, const T* b, T* out) {
  out[0] = a[0] * b[0] - a[1] * b[1] - a[2] * b[2] - a[3] * b[3];
  out[1] = a[0] * b[1] + a[1] * b[0] + a[2] * b[3] - a[3] * b[2];
  out[2] = a[0] * b[2] + a[2] * b[0] + a[3] * b[1] - a[1] * b[3];
  out[3] = a[0] * b[3] + a[3] * b[0] + a[1] * b[2] - a[2] * b[1];
}

// Entry (r, j) of the symmetric Delassus G from its packed lower triangle;
// r and j are compile-time constants in the unrolled sweep.
template <typename T>
__device__ __forceinline__ T g_at(const T* Gm, int r, int j) {
  return r >= j ? Gm[tri(r, j)] : Gm[tri(j, r)];
}

// exp(½·w) for a rotation vector w (w_dt: ω·dt) as a unit quaternion
// (_quat_exp_s): [cos a, sin a / a · ½w], a = ‖½w‖ (+ 1e-30 under the root)
template <typename T>
__device__ __forceinline__ void quat_exp(const T* w_dt, T* e) {
  T half[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) half[c] = T(0.5) * w_dt[c];
  const T ang =
      sqrt(half[0] * half[0] + half[1] * half[1] + half[2] * half[2] +
           T(1e-30));
  T sa, ca;
  sincos_t(ang, &sa, &ca);
  const T sr = sa / ang;
  e[0] = ca;
#pragma unroll
  for (int c = 0; c < 3; ++c) e[1 + c] = sr * half[c];
}

// q ⊗ exp(½·w), renormalised (the attitude update of both steppers)
template <typename T>
__device__ __forceinline__ void quat_step(const T* qt, const T* w_dt,
                                          T* out) {
  T e[4];
  quat_exp(w_dt, e);
  quat_mul4(qt, e, out);
  const T qn =
      sqrt(out[0] * out[0] + out[1] * out[1] + out[2] * out[2] +
           out[3] * out[3]);
#pragma unroll
  for (int c = 0; c < 4; ++c) out[c] = out[c] / qn;
}

// ------------------------------------------------------------- collision
// x·y of two 3-vectors, left to right (collision._dot)
template <typename T>
__device__ __forceinline__ T dot3(const T* x, const T* y) {
  return x[0] * y[0] + x[1] * y[1] + x[2] * y[2];
}

template <typename T>
__device__ __forceinline__ T clamp01(T x) {
  x = x > T(0) ? x : T(0);
  return x < T(1) ? x : T(1);
}

// The closest points w1, w2 of the segments p1 + s·d1 and p2 + t·d2, s, t ∈
// [0, 1]: Ericson's clamped algebra, both denominators regularised by 1e-12
// (a sphere is a segment of length 0)
template <typename T>
__device__ __forceinline__ void seg_seg_closest(const T* p1, const T* d1,
                                                const T* p2, const T* d2,
                                                T* w1, T* w2) {
  const T eps(1e-12);
  T rv[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) rv[c] = p1[c] - p2[c];
  const T a = dot3(d1, d1), e = dot3(d2, d2), b = dot3(d1, d2);
  const T c = dot3(d1, rv), f = dot3(d2, rv);
  const T denom = a * e - b * b;
  T s = denom > eps ? (b * f - c * e) / denom : T(0);
  s = clamp01(s);
  const T t = clamp01((b * s + f) / (e > eps ? e : eps));
  s = clamp01((b * t - c) / (a > eps ? a : eps));
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    w1[k] = p1[k] + s * d1[k];
    w2[k] = p2[k] + t * d2[k];
  }
}

// Two capsules (start, vector, radius) → the gap, the unit normal from B to
// A and the contact point, the midpoint of the two surface points
template <typename T>
__device__ __forceinline__ T pair_geometry(const T* cA, const T* dA, T rA,
                                           const T* cB, const T* dB, T rB,
                                           T* nrm, T* point) {
  T wA[3], wB[3], diff[3];
  seg_seg_closest(cA, dA, cB, dB, wA, wB);
#pragma unroll
  for (int k = 0; k < 3; ++k) diff[k] = wA[k] - wB[k];
  const T dist = sqrt(dot3(diff, diff) + T(1e-12));
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    nrm[k] = diff[k] / dist;
    point[k] = T(0.5) * ((wA[k] - rA * nrm[k]) + (wB[k] + rB * nrm[k]));
  }
  return (dist - rA) - rB;
}

// The frame rows F = [t1; t2; n] of a unit normal n, branchless: sign = ±1
// by n_z ≥ 0, so at n_z = 0 one ulp of n_z flips the tangents (the cone is
// isotropic: the physics does not flip)
template <typename T>
__device__ __forceinline__ void contact_frame3(const T* n, T F[3][3]) {
  const bool up = n[2] >= T(0);
  const T sign = up ? T(1) : T(-1);
  const T aa = T(-1) / ((sign + n[2]) + (up ? T(1e-12) : T(-1e-12)));
  const T bb = n[0] * n[1] * aa;
  F[0][0] = T(1) + sign * n[0] * n[0] * aa;
  F[0][1] = sign * bb;
  F[0][2] = -sign * n[0];
  F[1][0] = bb;
  F[1][1] = sign + n[1] * n[1] * aa;
  F[1][2] = -n[1];
#pragma unroll
  for (int k = 0; k < 3; ++k) F[2][k] = n[k];
}

// The PGS sweeps of _pgs_rows on K cone triplets and EQ trailing bilateral
// rows: Gm the packed lower triangle of the Delassus G (3K + EQ rows,
// without the ridge), bb the right-hand side, muv (K) the friction
// coefficients, active (K) the gap masks, reg (3K + EQ) the per-row ridge,
// applied algebraically — (G + reg·I)·p = G·p + reg·p — and in the clipped
// diagonal; p (3K + EQ) ← the impulses. Each sweep visits the contacts in
// order: a contact's three candidates use the impulses before its own
// update, the normal one clipped at 0 (and to 0 where inactive), the
// tangential pair scaled into the cone ‖pt‖ ≤ μ·pn; then each bilateral row
// takes its Gauss–Seidel update unprojected. The sweeps are a run-time loop
// and the rows unroll; up to kPgsUnrolledRows rows the columns unroll too
// (G, p, b in registers), past it the column loop rolls over G's packed
// rows (j < r along row r, j > r down column r).
constexpr int kPgsUnrolledRows = 24;

template <typename T, int R>
__device__ __forceinline__ T pgs_residual(const T* Gm, const T* p, int r) {
  if constexpr (R <= kPgsUnrolledRows) {
    T acc = g_at(Gm, r, 0) * p[0];
#pragma unroll
    for (int j = 1; j < R; ++j) acc += g_at(Gm, r, j) * p[j];
    return acc;
  } else {
    const T* row = Gm + tri(r, 0);
    T acc = row[0] * p[0];
GRID_ROLLED
    for (int j = 1; j <= r; ++j) acc += row[j] * p[j];
GRID_ROLLED
    for (int j = r + 1; j < R; ++j) acc += Gm[tri(j, r)] * p[j];
    return acc;
  }
}

template <typename T, int K, int EQ>
__device__ __forceinline__ void pgs(const T* Gm, const T* bb, const T* muv,
                                    const bool* active, const T* reg,
                                    int iters, T* p) {
  constexpr int R = 3 * K + EQ;
  T diag[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const T d = Gm[tri(r, r)] + reg[r];
    diag[r] = d > T(1e-9) ? d : T(1e-9);
    p[r] = T(0);
  }
GRID_ROLLED
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int ci = 0; ci < K; ++ci) {
      T cand[3];
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        const int r = 3 * ci + d;
        const T res = (pgs_residual<T, R>(Gm, p, r) + reg[r] * p[r]) + bb[r];
        cand[d] = p[r] - res / diag[r];
      }
      const T pn = active[ci] ? (cand[2] > T(0) ? cand[2] : T(0)) : T(0);
      const T norm_t = sqrt(cand[0] * cand[0] + cand[1] * cand[1] + T(1e-30));
      const T ratio = muv[ci] * pn / norm_t;
      const T scale = ratio < T(1) ? ratio : T(1);
      p[3 * ci] = cand[0] * scale;
      p[3 * ci + 1] = cand[1] * scale;
      p[3 * ci + 2] = pn;
    }
#pragma unroll
    for (int e = 0; e < EQ; ++e) {
      const int r = 3 * K + e;
      const T res = (pgs_residual<T, R>(Gm, p, r) + reg[r] * p[r]) + bb[r];
      p[r] = p[r] - res / diag[r];
    }
  }
}

}  // namespace grid
