// The multi-dof frictional ground step, one state per thread.
//
// The CUDA counterpart of _md_step_ground_body of
// gridcodegenerator_tpu/ops/kernels/md_contact_fused.py (:71; ported as
// md_step_ground_plain in gridcodegenerator_tpu_torch/ops/kernels/
// md_contact_fused.py): a fleet of ball-hip / free-joint robots (q with
// quaternions, nq ≠ nv) on the flat ground,
//   md_transforms → md_rnea at q̈ = 0 (the bias c) → md_crba into a packed
//   lower triangle → ptri_factor → world FK of the contact links along
//   their chains (_fk_s) → each contact's point, gap and rows over the
//   chain's tangent columns (_md_point_cols_s :48: a joint's w motion
//   columns a_ω × (x − p_j) + a_v) → one merged solve M⁻¹[Jᵀ | τ − c] →
//   v_free = q̇ + dt·M⁻¹(τ − c) → the Delassus G = J·M⁻¹Jᵀ (packed) and b →
//   pgs (contact.cuh) → v⁺ = v_free + M⁻¹Jᵀ·p → the retraction of
//   md_tangent_apply (a free joint's position with the PRE-update attitude,
//   then its quaternion; a ball joint's quaternion; a hinge or slide adds
//   dt·v).
// The first kf contacts are feet (the points off (kf, 3) of their links,
// gap = x_z − ground_z); the others the endpoint spheres of ground geoms
// (geo (MD_K − kf, 4): the centre in its link's frame, then the radius r;
// gap = x_z − ground_z − r, and the rows at the material point x − r·e_z).
// There is no base link: a floating robot's torso is its first joint's
// link, so every contact link is a joint (0 ≤ link < N).
//
// The robot is md.cuh's compile-time topology (-DGRID_JTYPES, ...) and the
// contact links are compile-time too (-DGRID_MD_K=<contacts>
// -DGRID_MD_LINKS=G(l0)G(l1)...), so each contact's chain and its live
// columns are __constant__ tables (c_md_chains), as ff.cuh's c_chains: a
// ball-ant foot has 10 live columns of 22, the torso sphere 6. Every sum
// runs in the order of the plain version; products with the structural
// zeros of a unit motion column are formed (x + 0·y = x).
#pragma once

#include "contact.cuh"
#include "md.cuh"

#ifndef GRID_MD_K
#error "compile with -DGRID_MD_K=<contacts> -DGRID_MD_LINKS=G(l0)G(l1)..."
#endif

namespace grid {

constexpr int MD_K = GRID_MD_K;
constexpr int MD_K3 = 3 * MD_K;
constexpr int MD_TRI = NV * (NV + 1) / 2;

// each contact's chain (its link and the link's ancestors, ascending) and
// the chain's tangent columns (each joint's velocity slots, ascending)
struct MdChains {
  int len[MD_K];
  int joint[MD_K][N];
  int cols[MD_K];
  int col[MD_K][NV];
};

#define G(x) x,
__host__ __device__ constexpr MdChains make_md_chains() {
  constexpr int links[MD_K] = {GRID_MD_LINKS};
  constexpr int par[N] = {GRID_PARENTS};
  constexpr Layout lay = make_layout();
  MdChains c{};
  for (int ci = 0; ci < MD_K; ++ci) {
    int d = 0;
    for (int j = links[ci]; j >= 0; j = par[j]) ++d;
    c.len[ci] = d;
    int t = d - 1;
    for (int j = links[ci]; j >= 0; j = par[j]) c.joint[ci][t--] = j;
    int w = 0;
    for (int u = 0; u < d; ++u)
      for (int k = lay.vs[c.joint[ci][u]]; k < lay.vs[c.joint[ci][u] + 1];
           ++k)
        c.col[ci][w++] = k;
    c.cols[ci] = w;
  }
  return c;
}
#undef G

__host__ __device__ constexpr int md_max_chain(bool cols) {
  int d = 1;
  for (int ci = 0; ci < MD_K; ++ci) {
    const int v = cols ? make_md_chains().cols[ci] : make_md_chains().len[ci];
    d = v > d ? v : d;
  }
  return d;
}
constexpr int MD_D = md_max_chain(false);  // the longest chain
constexpr int MD_C = md_max_chain(true);   // the most live columns

__constant__ MdChains c_md_chains = make_md_chains();

// The three world-frame rows of contact ci over its chain's columns, its
// gap and its point. FK runs along the chain from the transforms X (_fk_s:
// Rs world ← link, ps; a root joint's Rs is Eᵀ, its ps the joint origin);
// the point is p_l + R_l·e with e = off (a foot) or the geom sphere's
// centre, moved to the material point x − r·e_z for a geom.
template <typename T>
__device__ __forceinline__ void md_contact_rows(const MdRobot<T>& R,
                                                const T X[N][36], int ci,
                                                const T* e, bool geom, T r,
                                                T ground_z, T rows[3][MD_C],
                                                T* gap) {
  T Rs[MD_D][9], ps[MD_D][3];
  const int len = c_md_chains.len[ci];
GRID_ROLLED
  for (int t = 0; t < len; ++t) {
    const int i = c_md_chains.joint[ci][t];
    const T* Xi = X[i];
    // the joint origin in parent coordinates: r = unskew(−Eᵀ·Xl)
    T rv[3];
    const int mr[3] = {2, 0, 1}, mc[3] = {1, 2, 0};
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int a = mr[k], b = mc[k];
      rv[k] = -(Xi[a] * Xi[18 + b] + Xi[6 + a] * Xi[24 + b] +
                Xi[12 + a] * Xi[30 + b]);
    }
    if (t == 0) {  // a root joint: world ← link is Eᵀ
#pragma unroll
      for (int rr = 0; rr < 3; ++rr) {
#pragma unroll
        for (int c = 0; c < 3; ++c) Rs[0][rr * 3 + c] = Xi[c * 6 + rr];
        ps[0][rr] = rv[rr];
      }
    } else {
      const T* Rp = Rs[t - 1];
#pragma unroll
      for (int rr = 0; rr < 3; ++rr)
#pragma unroll
        for (int c = 0; c < 3; ++c)
          Rs[t][rr * 3 + c] = Rp[rr * 3] * Xi[c * 6] +
                              Rp[rr * 3 + 1] * Xi[c * 6 + 1] +
                              Rp[rr * 3 + 2] * Xi[c * 6 + 2];
      T t3[3];
      mv3(Rp, rv, t3);
#pragma unroll
      for (int rr = 0; rr < 3; ++rr) ps[t][rr] = ps[t - 1][rr] + t3[rr];
    }
  }
  const int l = len - 1;
  T x[3];
#pragma unroll
  for (int rr = 0; rr < 3; ++rr)
    x[rr] = ps[l][rr] + (Rs[l][rr * 3] * e[0] + Rs[l][rr * 3 + 1] * e[1] +
                         Rs[l][rr * 3 + 2] * e[2]);
  *gap = x[2] - ground_z;
  if (geom) {
    *gap = *gap - r;
    x[2] = x[2] - r;  // the material point: the world normal is e_z
  }
  // the columns: joint j's motion column c, a_ω × (x − p_j) + a_v
  int w = 0;
GRID_ROLLED
  for (int t = 0; t < len; ++t) {
    const int i = c_md_chains.joint[ci][t];
    const int ty = jtype(i);
    T d[3];
#pragma unroll
    for (int rr = 0; rr < 3; ++rr) d[rr] = x[rr] - ps[t][rr];
    const T* Rt = Rs[t];
    if (ty == kFloating || ty == kSpherical) {
      // angular unit columns: R_j·e_c × d
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const T a[3] = {Rt[c], Rt[3 + c], Rt[6 + c]};
        T cr[3];
        cross3(a, d, cr);
#pragma unroll
        for (int rr = 0; rr < 3; ++rr) rows[rr][w + c] = cr[rr];
      }
      if (ty == kFloating) {
        // linear unit columns: R_j·e_c
#pragma unroll
        for (int c = 0; c < 3; ++c)
#pragma unroll
          for (int rr = 0; rr < 3; ++rr) rows[rr][w + 3 + c] = Rt[rr * 3 + c];
      }
    } else {
      const T* S = R.S + 6 * i;
      T col[3];
      if (ty == kPrismatic) {
        mv3(Rt, S + 3, col);
      } else {
        T a[3];
        mv3(Rt, S, a);
        cross3(a, d, col);
      }
#pragma unroll
      for (int rr = 0; rr < 3; ++rr) rows[rr][w] = col[rr];
    }
    w += dof_of_type(ty);
  }
}

// One multi-dof ground step of MD_K contacts — md_step_ground_fused. q (NQ,
// B), q̇, τ (NV, B); mu (MD_K, B), the feet's then the geoms'; off (kf, 3);
// geo (MD_K − kf, 4); ridge (3·MD_K) the Delassus ridge of each cone row.
// Outputs q⁺ (NQ, B), v⁺ (NV, B) and the impulses (3·MD_K, B).
template <typename T>
__device__ __forceinline__ void md_step_state(
    const MdRobot<T>& R, const T* q, const T* qd, const T* tau, const T* mu,
    const T* __restrict__ off, const T* __restrict__ geo, int kf,
    const T* __restrict__ ridge, const StepParams<T>& sp, T* q_out,
    T* v_out, T* imp_out, long long B, long long b) {
  T qs[NQ], v[NV], sol[NV][MD_K3 + 1];
  load_rows<T, NQ>(q, B, b, qs);
  load_rows<T, NV>(qd, B, b, v);
  T X[N][36];
  md_transforms(R, qs, X);
  {
    // the free right-hand side τ − c (c: RNEA at q̈ = 0)
    T va[N][6], aa[N][6], fa[N][6], c[NV];
    md_rnea<T, false, true>(R, X, v, nullptr, sp.minus_g, va, aa, fa, c);
GRID_ROLLED
    for (int j = 0; j < NV; ++j) sol[j][MD_K3] = tau[j * B + b] - c[j];
  }
  T A[MD_TRI];
  {
    T Asq[NV][NV];
    md_crba(R, X, Asq);
GRID_ROLLED
    for (int r = 0; r < NV; ++r)
GRID_ROLLED
      for (int c = 0; c <= r; ++c) A[tri(r, c)] = Asq[r][c];
  }
  ptri_factor<T, NV>(A, T(0));

  // the contacts' rows, gaps and active masks
  T J[MD_K][3][MD_C], gap[MD_K];
  bool active[MD_K];
GRID_ROLLED
  for (int ci = 0; ci < MD_K; ++ci) {
    const bool geom = ci >= kf;
    const T* e = geom ? geo + 4 * (ci - kf) : off + 3 * ci;
    md_contact_rows(R, X, ci, e, geom, geom ? e[3] : T(0), sp.ground_z,
                    J[ci], &gap[ci]);
    active[ci] = gap[ci] < sp.margin;
  }

  // one merged solve: sol[c][s < 3k] = (M⁻¹Jᵀ)[c][s], sol[c][3k] = the
  // free acceleration
GRID_ROLLED
  for (int c = 0; c < NV; ++c)
GRID_ROLLED
    for (int s = 0; s < MD_K3; ++s) sol[c][s] = T(0);
GRID_ROLLED
  for (int ci = 0; ci < MD_K; ++ci)
#pragma unroll
    for (int r = 0; r < 3; ++r)
GRID_ROLLED
      for (int t = 0; t < c_md_chains.cols[ci]; ++t)
        sol[c_md_chains.col[ci][t]][3 * ci + r] = J[ci][r][t];
  ptri_apply<T, NV, MD_K3 + 1>(
      A, [&](int i, int k) -> T& { return sol[i][k]; });
  T vfree[NV];
GRID_ROLLED
  for (int c = 0; c < NV; ++c) vfree[c] = v[c] + sp.dt * sol[c][MD_K3];

  // the Delassus G = J·M⁻¹Jᵀ (lower triangle) and b = J·v_free − v* (v* on
  // the normal rows)
  T Gm[MD_K3 * (MD_K3 + 1) / 2], bb[MD_K3];
GRID_ROLLED
  for (int ci = 0; ci < MD_K; ++ci) {
    const int cols = c_md_chains.cols[ci];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const int row = 3 * ci + r;
GRID_ROLLED
      for (int s = 0; s <= row; ++s) {
        T acc = J[ci][r][0] * sol[c_md_chains.col[ci][0]][s];
GRID_ROLLED
        for (int t = 1; t < cols; ++t)
          acc += J[ci][r][t] * sol[c_md_chains.col[ci][t]][s];
        Gm[tri(row, s)] = acc;
      }
      T acc = J[ci][r][0] * vfree[c_md_chains.col[ci][0]];
GRID_ROLLED
      for (int t = 1; t < cols; ++t)
        acc += J[ci][r][t] * vfree[c_md_chains.col[ci][t]];
      bb[row] = acc;
    }
    const T gmin = gap[ci] < T(0) ? gap[ci] : T(0);
    // ÷ dt as the plain version's division by a Python float
    T v_star = sp.neg_erp * gmin * sp.inv_dt;
    if (sp.restitution != T(0)) {
      T vn = J[ci][2][0] * v[c_md_chains.col[ci][0]];
GRID_ROLLED
      for (int t = 1; t < cols; ++t)
        vn += J[ci][2][t] * v[c_md_chains.col[ci][t]];
      v_star = v_star - sp.restitution * (vn < T(0) ? vn : T(0));
    }
    bb[3 * ci + 2] = bb[3 * ci + 2] - v_star;
  }

  // projected Gauss–Seidel (pgs, contact.cuh)
  T reg[MD_K3], p[MD_K3], muv[MD_K];
#pragma unroll
  for (int r = 0; r < MD_K3; ++r) reg[r] = ridge[r];
#pragma unroll
  for (int ci = 0; ci < MD_K; ++ci) muv[ci] = mu[ci * B + b];
  pgs<T, MD_K, 0>(Gm, bb, muv, active, reg, sp.iters, p);

  // v⁺ = v_free + M⁻¹Jᵀ·p
GRID_ROLLED
  for (int c = 0; c < NV; ++c) {
    T acc = sol[c][0] * p[0];
#pragma unroll
    for (int s = 1; s < MD_K3; ++s) acc += sol[c][s] * p[s];
    v[c] = vfree[c] + acc;
  }
  // the retraction q⁺ = q ⊕ dt·v⁺ (md_tangent_apply)
GRID_ROLLED
  for (int i = 0; i < N; ++i) {
    const int ty = jtype(i);
    const int s = qstart(i), sv = vstart(i);
    if (ty == kFloating || ty == kSpherical) {
      T dphi[3], quat[4];
#pragma unroll
      for (int c = 0; c < 3; ++c) dphi[c] = sp.dt * v[sv + c];
#pragma unroll
      for (int c = 0; c < 4; ++c) quat[c] = qs[s + c];
      if (ty == kFloating) {
        // the position by the pre-update attitude
        T dpos[3], Rq[9], t3[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) dpos[c] = sp.dt * v[sv + 3 + c];
        quat_rot(quat, Rq);
        mv3(Rq, dpos, t3);
#pragma unroll
        for (int c = 0; c < 3; ++c) qs[s + 4 + c] = qs[s + 4 + c] + t3[c];
      }
      quat_step(quat, dphi, qs + s);
    } else {
      qs[s] = qs[s] + sp.dt * v[sv];
    }
  }
GRID_ROLLED
  for (int j = 0; j < NQ; ++j) q_out[j * B + b] = qs[j];
GRID_ROLLED
  for (int j = 0; j < NV; ++j) v_out[j * B + b] = v[j];
#pragma unroll
  for (int r = 0; r < MD_K3; ++r) imp_out[r * B + b] = p[r];
}

}  // namespace grid
