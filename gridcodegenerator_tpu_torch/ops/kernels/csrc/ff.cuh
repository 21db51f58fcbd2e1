// Floating-base (free-flyer) dynamics, one state per thread.
//
// The CUDA counterparts of the kernel bodies of
// gridcodegenerator_tpu/ops/kernels/contact_fused.py (ported as the plain
// versions of gridcodegenerator_tpu_torch/ops/kernels/contact_fused.py):
//   fb_bias         _fb_bias_s (:153): the bias wrench of the base and the
//                   joint torques, with a₀' = [0; −g·R[2, :]] entering
//                   structurally
//   fb_mass         _fb_mass_s (:197): the (6+n)² mass matrix by composite
//                   inertias, lower triangle
//   contact_rows    _fk_s (:113) and _ff_contact_rows_s (:426) along one
//                   contact's chain (ancestors(link) ∪ {link}, ascending)
// and the per-state bodies of the three kernels of ff.cu:
//   fb_aba_state    _fb_aba_body (:1344): floating-base ABA, a 6×6 base
//                   Cholesky
//   fb_fd_state     _fb_fd_body (:1310): bias, mass matrix, its Cholesky
//                   factor and one solve
//   stance_state    _stance_body (:891): + contact rows, one merged solve
//                   M⁻¹[Jᵀ | rhs], the Delassus G with reg, λ; the bias
//                   J̇·[vb; q̇] is contact_rows instantiated on Dual<T>,
//                   seeded with (quat, ½ quat ⊗ [0, ω_b]) and (q, q̇), its
//                   tangent rows contracted with [vb; q̇]
//   slot_rows       one row triplet of the step, any kind: a foot
//                   (_ff_contact_rows_s), a ground geom's sphere
//                   (_ground_geom_rows_s :800), a self-collision or
//                   obstacle pair (_collision_rows_s :577), a loop closure
//                   or world pin (_loop_rows_s :671)
//   step_state      _step_ground_body (:977) whole: the free velocity, the
//                   triplets' rows and gaps (on a heightfield along the
//                   normal, the ground rows in the contact frame:
//                   terrain_frame, _terrain_surface_s :735), G and b (the
//                   closures' + erp·gap/dt), PGS on the friction cones and
//                   the closures' bilateral rows (pgs, _pgs_rows :1128) and
//                   the manifold integration (quat_step, _quat_exp_s :104)
// The robot-independent pieces (the packed triangle and its factor and
// solves, the quaternion helpers, the heightfield, the collision geometry,
// the PGS sweeps) live in contact.cuh, which the multi-dof step
// (md_step.cuh) shares.
//
// The arm is a compile-time constant as in rbd.cuh (-DGRID_N, -DGRID_PARENTS,
// -DGRID_PRISMATIC), and the stance and step kernels' contact links too
// (-DGRID_FF_K=<k> -DGRID_FF_LINKS=G(l0)G(l1)...), the step's collision
// contacts' two links (-DGRID_FF_KC=<c> -DGRID_FF_CA=... -DGRID_FF_CB=...,
// −2 for an obstacle) and its closures' (-DGRID_FF_L=<l> -DGRID_FF_LA=...
// -DGRID_FF_LB=..., −1 for a world pin): they fix which columns of each
// row are nonzero. The numeric constants arrive in one packed
// buffer (FreeFlyerModel.packed), staged in shared memory by ff.cu:
//   Xb, Xs, Xc (36N each), S (6N), inertia (36N), damping (N), armature (N),
//   I_base (36)
// The foot offsets and anchors, gravity, the Baumgarte (α, β), reg and the
// step's dt, ground_z, μ, push, ridge, sweeps, erp, margin, restitution,
// height grid and geom, collision and closure geometry are run-time
// arguments, and the kernels take the same branches
// as the plain versions (α = 0, β = 0 or no anchors, reg = 0, restitution = 0
// skip their terms) uniformly across the batch. Joint parents, types and the contact chains are read from
// __constant__ tables (a constexpr local table indexed at run time is rebuilt
// in local memory on every call).
//
// Every sum runs in the order of the plain version; the structural zeros the
// plain versions form (x·0 terms of the contact rows) are formed here too,
// and the zero columns outside a contact's chain are skipped, which changes
// no value (x + 0 = x). A division by dt or the grid's cell size is a
// product with its reciprocal formed in double, as torch divides a tensor
// by a Python float, and ff.cu builds without FMA contraction
// (_build.UNIT_FLAGS): the float32 step with ground geoms reads its plain
// version bit for bit, also on the states whose near-singular Delassus G
// turns one rounding into an error of 1e-4 in q̇.
// Joint and column loops stay rolled (rbd.cuh).
#pragma once

#include "chol.cuh"
#include "contact.cuh"
#include "dual.cuh"

#ifndef GRID_FF_K
#error "compile with -DGRID_FF_K=<contacts> [-DGRID_FF_LINKS=G(l0)G(l1)...]"
#endif

namespace grid {

constexpr int FF_M = 6 + N;                     // free-flyer velocity dof
constexpr int FF_TRI = FF_M * (FF_M + 1) / 2;   // lower triangle of M
constexpr int kFfConstCount = 152 * N + 36;

#define G(x) x,
__constant__ int c_ff_parent[N] = {GRID_PARENTS};
__constant__ int c_ff_prism[N] = {GRID_PRISMATIC};
#undef G

__device__ __forceinline__ int ff_parent(int i) { return c_ff_parent[i]; }

// ----------------------------------------------------------- kinematics
// joint i's transform entry e from (sin, cos) or q, as joint_transforms_bl
template <typename TT>
__device__ __forceinline__ TT xform_entry(const Robot<base_t<TT>>& R, int i,
                                          int e, bool prism, TT f1, TT f2) {
  if (prism) return R.Xb[i * 36 + e] + R.Xs[i * 36 + e] * f1;
  return R.Xb[i * 36 + e] + R.Xs[i * 36 + e] * f1 + R.Xc[i * 36 + e] * f2;
}

template <typename TT>
__device__ __forceinline__ void joint_args(int i, TT qi, bool* prism, TT* f1,
                                           TT* f2) {
  *prism = c_ff_prism[i] != 0;
  if (*prism) {
    *f1 = qi;
    *f2 = qi;  // unused
  } else {
    sincos_t(qi, f1, f2);
  }
}

template <typename T>
__device__ __forceinline__ void ff_transforms(const Robot<T>& R, const T* q,
                                              T X[N][36]) {
GRID_ROLLED
  for (int i = 0; i < N; ++i) {
    bool prism;
    T f1, f2;
    joint_args(i, q[i], &prism, &f1, &f2);
#pragma unroll
    for (int e = 0; e < 36; ++e) X[i][e] = xform_entry(R, i, e, prism, f1, f2);
  }
}

// ---------------------------------------------------------- the contacts
#ifndef GRID_FF_KC
#define GRID_FF_KC 0
#endif
#ifndef GRID_FF_L
#define GRID_FF_L 0
#endif

#if GRID_FF_K > 0
constexpr int FF_K = GRID_FF_K;     // feet and ground-geom spheres (the links)
constexpr int FF_K3 = 3 * FF_K;
constexpr int FF_KC = GRID_FF_KC;   // collision contacts (self, obstacle)
constexpr int FF_L = GRID_FF_L;     // loop closures
constexpr int FF_KT = FF_K + FF_KC; // the step's cone contacts
constexpr int FF_T = FF_KT + FF_L;  // the step's row triplets

// what a step's row triplet is (the chain's kind; a foot or a geom sphere
// by the run-time feet count)
enum RowKind : int { kFoot, kGeom, kSelf, kObstacle, kLoop, kPin };
constexpr int kObstacleLink = -2;   // the build key's second link of an
                                    // obstacle pair

// Each row triplet's chain: the joints its rows read, ascending (closed
// under ancestors: a foot's or geom's link and its ancestors; a pair's two
// links' supports together), with each joint's parent's position in the
// chain (−1 at a root), which side's support it is in (1: A, 2: B, 3:
// both), the positions of links A and B (−1: the base, the world or an
// obstacle) and the kind of a pair's chain. Chains 0..FF_K−1 are the
// links', then the FF_KC collision contacts', then the FF_L closures'.
struct Chains {
  int link[FF_T];
  int len[FF_T];
  int joint[FF_T][N];
  int ppos[FF_T][N];
  int side[FF_T][N];
  int posA[FF_T];
  int posB[FF_T];
  int kind[FF_T];
};

#define G(x) x,
__host__ __device__ constexpr Chains make_chains() {
  constexpr int links[FF_K] = {GRID_FF_LINKS};
  constexpr int par[N] = {GRID_PARENTS};
  int la[FF_T] = {}, lb[FF_T] = {}, kind[FF_T] = {};
  for (int ci = 0; ci < FF_K; ++ci) {
    la[ci] = links[ci];
    lb[ci] = -1;
    kind[ci] = kFoot;
  }
#if GRID_FF_KC > 0
  constexpr int ca[FF_KC] = {GRID_FF_CA};
  constexpr int cb[FF_KC] = {GRID_FF_CB};
  for (int c = 0; c < FF_KC; ++c) {
    la[FF_K + c] = ca[c];
    lb[FF_K + c] = cb[c] == kObstacleLink ? -1 : cb[c];
    kind[FF_K + c] = cb[c] == kObstacleLink ? kObstacle : kSelf;
  }
#endif
#if GRID_FF_L > 0
  constexpr int pa[FF_L] = {GRID_FF_LA};
  constexpr int pb[FF_L] = {GRID_FF_LB};
  for (int l = 0; l < FF_L; ++l) {
    la[FF_KT + l] = pa[l];
    lb[FF_KT + l] = pb[l];
    kind[FF_KT + l] = pb[l] < 0 ? kPin : kLoop;
  }
#endif
  Chains c{};
  for (int ch = 0; ch < FF_T; ++ch) {
    int in[N] = {};
    for (int j = la[ch]; j >= 0; j = par[j]) in[j] |= 1;
    for (int j = lb[ch]; j >= 0; j = par[j]) in[j] |= 2;
    int pos[N] = {};
    int d = 0;
    for (int j = 0; j < N; ++j) {
      pos[j] = -1;
      if (!in[j]) continue;
      pos[j] = d;
      c.joint[ch][d] = j;
      c.ppos[ch][d] = par[j] >= 0 ? pos[par[j]] : -1;
      c.side[ch][d] = in[j];
      ++d;
    }
    c.link[ch] = la[ch];
    c.len[ch] = d;
    c.posA[ch] = la[ch] >= 0 ? pos[la[ch]] : -1;
    c.posB[ch] = lb[ch] >= 0 ? pos[lb[ch]] : -1;
    c.kind[ch] = kind[ch];
  }
  return c;
}
#undef G

constexpr Chains kChains = make_chains();

__host__ __device__ constexpr int max_chain() {
  int d = 1;                        // (a base geom's chain, link −1, is empty)
  for (int ci = 0; ci < FF_T; ++ci) d = kChains.len[ci] > d ? kChains.len[ci] : d;
  return d;
}
constexpr int FF_D = max_chain();   // the longest chain
constexpr int FF_C = 6 + FF_D;      // stored columns of a contact's rows

__constant__ Chains c_chains = kChains;

// The poses of chain ch's links from q (_fk_s): Rs (world ← link) and ps,
// in base coordinates, by chain position — a root joint's Rs is Eᵀ, a
// child's its parent's Rs·Eᵀ. Runs on T (the rows) and on Dual<T> (their
// time derivative).
template <typename TT>
__device__ __forceinline__ void chain_fk(const Robot<base_t<TT>>& R, int ch,
                                         const TT* q, TT Rs[FF_D][9],
                                         TT ps[FF_D][3]) {
  const int len = c_chains.len[ch];
GRID_ROLLED
  for (int t = 0; t < len; ++t) {
    const int i = c_chains.joint[ch][t];
    bool prism;
    TT f1, f2;
    joint_args(i, q[i], &prism, &f1, &f2);
    TT E[9], Xl[9];  // X[0:3, 0:3] (child ← parent) and X[3:6, 0:3]
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        E[r * 3 + c] = xform_entry(R, i, r * 6 + c, prism, f1, f2);
        Xl[r * 3 + c] = xform_entry(R, i, (3 + r) * 6 + c, prism, f1, f2);
      }
    // the joint origin in parent coordinates: r = unskew(−Eᵀ·Xl)
    TT rv[3];
    const int mr[3] = {2, 0, 1}, mc[3] = {1, 2, 0};
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int a = mr[k], b = mc[k];
      rv[k] = -(E[a] * Xl[b] + E[3 + a] * Xl[3 + b] + E[6 + a] * Xl[6 + b]);
    }
    const int pt = c_chains.ppos[ch][t];
    if (pt < 0) {
#pragma unroll
      for (int r = 0; r < 3; ++r) {
#pragma unroll
        for (int c = 0; c < 3; ++c) Rs[t][r * 3 + c] = E[c * 3 + r];
        ps[t][r] = rv[r];
      }
    } else {
#pragma unroll
      for (int r = 0; r < 3; ++r)
#pragma unroll
        for (int c = 0; c < 3; ++c)
          Rs[t][r * 3 + c] = Rs[pt][r * 3] * E[c * 3] +
                             Rs[pt][r * 3 + 1] * E[c * 3 + 1] +
                             Rs[pt][r * 3 + 2] * E[c * 3 + 2];
      TT t3[3];
      mv3(Rs[pt], rv, t3);
#pragma unroll
      for (int r = 0; r < 3; ++r) ps[t][r] = ps[pt][r] + t3[r];
    }
  }
}

// The three world-frame rows of stance contact ci (_ff_contact_rows_s):
// columns [ω_b (3); v_b (3); the chain's joints, ascending], at the point
// x_b ← ps + Rs·off of the contact's link (its chain's last), base
// coordinates.
template <typename TT>
__device__ __forceinline__ void contact_rows(const Robot<base_t<TT>>& R,
                                             int ci, const TT* q,
                                             const TT* Rw,
                                             const base_t<TT>* off,
                                             TT rows[3][FF_C], TT* x_b) {
  TT Rs[FF_D][9], ps[FF_D][3];
  chain_fk(R, ci, q, Rs, ps);
  const int len = c_chains.len[ci];
  const int l = len - 1;
#pragma unroll
  for (int r = 0; r < 3; ++r)
    x_b[r] = ps[l][r] + (Rs[l][r * 3] * off[0] + Rs[l][r * 3 + 1] * off[1] +
                         Rs[l][r * 3 + 2] * off[2]);
  // ω_b columns R·(e_j × x): e_0 × x = (0, −x2, x1), e_1 × x = (x2, 0,
  // −x0), e_2 × x = (−x1, x0, 0)
  const TT z = x_b[0] * base_t<TT>(0);
  const TT ex[3][3] = {{z, -x_b[2], x_b[1]},
                       {x_b[2], z, -x_b[0]},
                       {-x_b[1], x_b[0], z}};
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    TT col[3];
    mv3(Rw, ex[j], col);
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      rows[r][j] = col[r];
      rows[r][3 + j] = Rw[r * 3 + j];
    }
  }
  // joint columns R·(a_ang × (x − p_j) + a_lin)
GRID_ROLLED
  for (int t = 0; t < len; ++t) {
    const int i = c_chains.joint[ci][t];
    const base_t<TT>* S = R.S + 6 * i;
    TT a_ang[3], a_lin[3], d[3], cr[3], w[3], col[3];
    mv3(Rs[t], S, a_ang);
    mv3(Rs[t], S + 3, a_lin);
#pragma unroll
    for (int r = 0; r < 3; ++r) d[r] = x_b[r] - ps[t][r];
    cross3(a_ang, d, cr);
#pragma unroll
    for (int r = 0; r < 3; ++r) w[r] = cr[r] + a_lin[r];
    mv3(Rw, w, col);
#pragma unroll
    for (int r = 0; r < 3; ++r) rows[r][6 + t] = col[r];
  }
}

// The step's row triplet ci → its chain: the feet keep theirs, the
// collision contacts follow them in the JAX order (feet, collision, ground
// geoms, loops), the ground geoms' chains sit after the feet's
__device__ __forceinline__ int chain_of(int ci, int kf) {
  if (FF_KC == 0 || ci < kf) return ci;
  if (ci < kf + FF_KC) return FF_K + (ci - kf);
  if (ci < FF_KT) return ci - FF_KC;
  return ci;
}

// The three rows and the gap(s) of one row triplet of the step, of kind
// ``kind`` over chain ch (_ff_contact_rows_s, _ground_geom_rows_s,
// _collision_rows_s, _loop_rows_s). Columns [ω_b (3); v_b (3); the chain's
// joints]. e is the triplet's run-time geometry: a foot's offset (3); a
// geom sphere's centre and radius (4); a collision pair's side A (start,
// vector, radius) and side B (the same of the second geom in its link's
// frame, or of the obstacle in the world's) (14); a closure's offset on a
// and b's offset or a pin's anchor (6). Out: rows (a foot's and a geom's in
// the contact frame on a heightfield, a collision contact's always in its
// frame, a closure's in the world's) and g3 (a cone contact's gap in g3[0],
// a closure's three world gap components). One call per triplet, and not
// inlined: inlined into the step, the four-bar's and the 3-link chain's
// steps came out wrong in every state under nvcc 12.9, also with -Xptxas
// -O0, and right with -G and on the host (as separate inlined row calls
// for feet and geoms did before).
template <typename T, bool kTerrain>
__device__ __noinline__ void slot_rows(
    const Robot<T>& R, int kind, int ch, const T* q, const T* Rw,
    const T* pos, const T* __restrict__ e, const StepParams<T>& sp,
    const Heightfield<T>& hf, T rows[3][FF_C], T* g3) {
  // the chain's poses (_fk_s)
  T Rs[FF_D][9], ps[FF_D][3];
  chain_fk(R, ch, q, Rs, ps);
  const int len = c_chains.len[ch];
  // a point rigid with the link at chain position tp (−1: the base), of
  // body-frame offset o: ps + Rs·o
  auto attach = [&](int tp, const T* o, T* x) {
#pragma unroll
    for (int r = 0; r < 3; ++r)
      x[r] = tp < 0 ? o[r]
                    : ps[tp][r] + (Rs[tp][r * 3] * o[0] +
                                   Rs[tp][r * 3 + 1] * o[1] +
                                   Rs[tp][r * 3 + 2] * o[2]);
  };
  // a segment's start and vector in base coordinates
  auto segment = [&](int tp, const T* g, T* a, T* d) {
    attach(tp, g, a);
#pragma unroll
    for (int r = 0; r < 3; ++r)
      d[r] = tp < 0 ? g[3 + r]
                    : Rs[tp][r * 3] * g[3] + Rs[tp][r * 3 + 1] * g[4] +
                          Rs[tp][r * 3 + 2] * g[5];
  };
  // joint t's column at the point x, base coordinates: a_ang × (x − p) +
  // a_lin
  auto jcol = [&](int t, const T* x, T* w) {
    const T* S = R.S + 6 * c_chains.joint[ch][t];
    T a_ang[3], a_lin[3], d[3], cr[3];
    mv3(Rs[t], S, a_ang);
    mv3(Rs[t], S + 3, a_lin);
#pragma unroll
    for (int r = 0; r < 3; ++r) d[r] = x[r] - ps[t][r];
    cross3(a_ang, d, cr);
#pragma unroll
    for (int r = 0; r < 3; ++r) w[r] = cr[r] + a_lin[r];
  };
  // the ω_b columns R·(e_j × x) into rows[r][j] (ω_b rows of F·R·(e_j × x)
  // with a frame F)
  auto omega = [&](const T* x, T wc[3][3]) {
    const T z = x[0] * T(0);
    const T ex[3][3] = {{z, -x[2], x[1]}, {x[2], z, -x[0]},
                        {-x[1], x[0], z}};
#pragma unroll
    for (int j = 0; j < 3; ++j) mv3(Rw, ex[j], wc[j]);
  };

  T x[3], xb2[3] = {T(0), T(0), T(0)}, nrm[3], F[3][3], wc[3][3];
  const bool pair = kind == kSelf || kind == kObstacle;
  const bool closure = kind == kLoop || kind == kPin;
  const int tA = c_chains.posA[ch], tB = c_chains.posB[ch];
  if (pair) {
    // the two capsules in base coordinates; the obstacle's as Rᵀ(a_w −
    // pos), Rᵀd_w
    T cA[3], dA[3], cB[3], dB[3];
    segment(tA, e, cA, dA);
    if (kind == kSelf) {
      segment(tB, e + 7, cB, dB);
    } else {
      T rel[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) rel[k] = e[7 + k] - pos[k];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        cB[i] = Rw[i] * rel[0] + Rw[3 + i] * rel[1] + Rw[6 + i] * rel[2];
        dB[i] = Rw[i] * e[10] + Rw[3 + i] * e[11] + Rw[6 + i] * e[12];
      }
    }
    T nb[3];
    g3[0] = pair_geometry(cA, dA, e[6], cB, dB, e[13], nb, x);
    mv3(Rw, nb, nrm);
    contact_frame3(nrm, F);
  } else {
    attach(tA, e, x);
  }
  if (closure && kind == kLoop) attach(tB, e + 3, xb2);
  if (kind == kFoot || kind == kGeom) {
    // a foot's point x_b; a geom sphere's material point x_b − r·Rᵀn, its
    // gap along the normal less r
    const T r = kind == kGeom ? e[3] : T(0);
    T pw[3], t3[3], h = T(0), C[3][3];
    mv3(Rw, x, t3);
#pragma unroll
    for (int d = 0; d < 3; ++d) pw[d] = pos[d] + t3[d];
    if constexpr (kTerrain) terrain_frame(hf, pw[0], pw[1], &h, C);
    T nb[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      if constexpr (kTerrain) {
        nb[j] = Rw[j] * C[2][0] + Rw[3 + j] * C[2][1] + Rw[6 + j] * C[2][2];
      } else {
        nb[j] = Rw[6 + j];
      }
    }
    if (kind == kGeom) {
#pragma unroll
      for (int d = 0; d < 3; ++d) x[d] = x[d] - r * nb[d];
    }
    if constexpr (kTerrain) {
      g3[0] = (pw[2] - h) * C[2][2];
      if (kind == kGeom) g3[0] = g3[0] - r;
#pragma unroll
      for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int b = 0; b < 3; ++b) F[a][b] = C[a][b];
    } else {
      g3[0] = kind == kGeom ? (pw[2] - r) - sp.ground_z : pw[2] - sp.ground_z;
    }
  }

  // the world columns: ω_b (about the point, or the closure's x_a − x_b),
  // v_b (R's columns, absent where the base cancels), the joints'
  T rel[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) rel[k] = kind == kLoop ? x[k] - xb2[k] : x[k];
  const bool base_w = kind != kSelf;
  const bool base_v = kind != kSelf && kind != kLoop;
  omega(rel, wc);
  T W[3][FF_C];
#pragma unroll
  for (int j = 0; j < 3; ++j)
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      W[r][j] = base_w ? wc[j][r] : T(0);
      W[r][3 + j] = base_v ? Rw[r * 3 + j] : T(0);
    }
GRID_ROLLED
  for (int t = 0; t < len; ++t) {
    const int side = c_chains.side[ch][t];
    T w[3], wa[3], wb[3];
    if (kind == kLoop) {
      jcol(t, x, wa);
      jcol(t, xb2, wb);
#pragma unroll
      for (int r = 0; r < 3; ++r)
        w[r] = side == 3 ? wa[r] - wb[r] : (side == 1 ? wa[r] : -wb[r]);
    } else {
      jcol(t, x, wa);
#pragma unroll
      for (int r = 0; r < 3; ++r)
        w[r] = side == 3 ? wa[r] - wa[r] : (side == 1 ? wa[r] : -wa[r]);
    }
    T col[3];
    mv3(Rw, w, col);
#pragma unroll
    for (int r = 0; r < 3; ++r) W[r][6 + t] = col[r];
  }
  if (closure) {
    // world rows; the gap R·(x_a − x_b), or pos + R·x_a − anchor
    T gw[3];
    mv3(Rw, rel, gw);
#pragma unroll
    for (int d = 0; d < 3; ++d)
      g3[d] = kind == kLoop ? gw[d] : (pos[d] + gw[d]) - e[3 + d];
  }
  const int cols = 6 + len;
  const bool framed = pair || (kTerrain && !closure);
GRID_ROLLED
  for (int c = 0; c < cols; ++c) {
    const T o0 = W[0][c], o1 = W[1][c], o2 = W[2][c];
    if (!framed) {
      rows[0][c] = o0;
      rows[1][c] = o1;
      rows[2][c] = o2;
    } else if (pair) {
      // F·col: the collision frame, each row a full dot product
      rows[0][c] = F[0][0] * o0 + F[0][1] * o1 + F[0][2] * o2;
      rows[1][c] = F[1][0] * o0 + F[1][1] * o1 + F[1][2] * o2;
      rows[2][c] = F[2][0] * o0 + F[2][1] * o1 + F[2][2] * o2;
    } else {
      // the heightfield's frame: t1 has a structural zero
      rows[0][c] = F[0][0] * o0 + F[0][2] * o2;
      rows[1][c] = F[1][0] * o0 + F[1][1] * o1 + F[1][2] * o2;
      rows[2][c] = F[2][0] * o0 + F[2][1] * o1 + F[2][2] * o2;
    }
  }
}
#endif  // GRID_FF_K > 0

// --------------------------------------------------- bias and mass matrix
// f_b (6) and c_j (N): the bias at q̈ = 0 with a₀' = [0; a0] (_fb_bias_s)
template <typename T>
__device__ __forceinline__ void fb_bias(const Robot<T>& R, const T* Ib,
                                        const T X[N][36], const T* a0,
                                        const T* vb, const T* qd, T* f_b,
                                        T* c_j) {
  T v[N][6], a[N][6], f[N][6];
GRID_ROLLED
  for (int i = 0; i < N; ++i) {
    const int p = ff_parent(i);
    const T* S = R.S + 6 * i;
    const T* I = R.I + 36 * i;
    T Sqd[6], t[6], ai[6];
#pragma unroll
    for (int r = 0; r < 6; ++r) Sqd[r] = S[r] * qd[i];
    matvec6(X[i], p < 0 ? vb : v[p], t);
#pragma unroll
    for (int r = 0; r < 6; ++r) v[i][r] = t[r] + Sqd[r];
    if (p < 0) {
#pragma unroll
      for (int r = 0; r < 6; ++r)
        ai[r] = X[i][r * 6 + 3] * a0[0] + X[i][r * 6 + 4] * a0[1] +
                X[i][r * 6 + 5] * a0[2];
    } else {
      matvec6(X[i], a[p], ai);
    }
    crm_apply(v[i], Sqd, t);
#pragma unroll
    for (int r = 0; r < 6; ++r) a[i][r] = ai[r] + t[r];
    T Iv[6], Ia[6];
    matvec6(I, v[i], Iv);
    matvec6(I, a[i], Ia);
    crf_apply(v[i], Iv, t);
#pragma unroll
    for (int r = 0; r < 6; ++r) f[i][r] = Ia[r] + t[r];
  }
  {
    T Ivb[6], t[6];
    matvec6(Ib, vb, Ivb);
    crf_apply(vb, Ivb, t);
#pragma unroll
    for (int r = 0; r < 6; ++r)
      f_b[r] = (Ib[r * 6 + 3] * a0[0] + Ib[r * 6 + 4] * a0[1] +
                Ib[r * 6 + 5] * a0[2]) + t[r];
  }
GRID_ROLLED
  for (int i = N - 1; i >= 0; --i) {
    const int p = ff_parent(i);
    T t[6];
    matvec6_T(X[i], f[i], t);
    T* dst = p < 0 ? f_b : f[p];
#pragma unroll
    for (int r = 0; r < 6; ++r) dst[r] = dst[r] + t[r];
  }
GRID_ROLLED
  for (int i = 0; i < N; ++i) {
    const T* S = R.S + 6 * i;
    T acc = S[0] * f[i][0];
#pragma unroll
    for (int r = 1; r < 6; ++r) acc += S[r] * f[i][r];
    c_j[i] = acc + R.damping[i] * qd[i];
  }
}

// The lower triangle of the (6+N)² mass matrix into A (FF_TRI values,
// structural zeros included) (_fb_mass_s)
template <typename T>
__device__ __forceinline__ void fb_mass(const Robot<T>& R, const T* Ib,
                                        const T X[N][36], T* A) {
  T IC[N][36], ICb[36];
GRID_ROLLED
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 36; ++e) IC[i][e] = R.I[36 * i + e];
#pragma unroll
  for (int e = 0; e < 36; ++e) ICb[e] = Ib[e];
GRID_ROLLED
  for (int i = N - 1; i >= 0; --i) {
    const int p = ff_parent(i);
    T Y[36];
    // Y = IC·X, then the parent's (or the base's) IC += Xᵀ·Y
#pragma unroll
    for (int r = 0; r < 6; ++r)
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        T acc = IC[i][r * 6] * X[i][k];
#pragma unroll
        for (int c = 1; c < 6; ++c) acc += IC[i][r * 6 + c] * X[i][c * 6 + k];
        Y[r * 6 + k] = acc;
      }
    T* dst = p < 0 ? ICb : IC[p];
#pragma unroll
    for (int r = 0; r < 6; ++r)
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        T acc = X[i][r] * Y[k];
#pragma unroll
        for (int c = 1; c < 6; ++c) acc += X[i][c * 6 + r] * Y[c * 6 + k];
        dst[r * 6 + k] = dst[r * 6 + k] + acc;
      }
  }
GRID_ROLLED
  for (int e = 0; e < FF_TRI; ++e) A[e] = T(0);
#pragma unroll
  for (int r = 0; r < 6; ++r)
#pragma unroll
    for (int c = 0; c <= r; ++c) A[tri(r, c)] = ICb[r * 6 + c];
GRID_ROLLED
  for (int i = 0; i < N; ++i) {
    const T* Si = R.S + 6 * i;
    T F[6], t[6];
    matvec6(IC[i], Si, F);
    T d = Si[0] * F[0];
#pragma unroll
    for (int c = 1; c < 6; ++c) d += Si[c] * F[c];
    A[tri(6 + i, 6 + i)] = d + R.armature[i];
    int j = i;
GRID_ROLLED
    while (ff_parent(j) >= 0) {
      matvec6_T(X[j], F, t);
#pragma unroll
      for (int r = 0; r < 6; ++r) F[r] = t[r];
      j = ff_parent(j);
      const T* Sj = R.S + 6 * j;
      T val = F[0] * Sj[0];
#pragma unroll
      for (int c = 1; c < 6; ++c) val += F[c] * Sj[c];
      A[tri(6 + i, 6 + j)] = val;
    }
    matvec6_T(X[j], F, t);  // into base coordinates
#pragma unroll
    for (int c = 0; c < 6; ++c) A[tri(6 + i, c)] = t[c];
  }
}

// ------------------------------------------------------ per-state bodies
// Inputs are batch-last: quat (4, B), pos (3, B), q, q̇, τ (N, B), vb (6, B);
// element r of state b at r·B + b. The row loops unroll: rolled, nvcc 12.9
// returned NaN for every state of the mass-matrix kernel at 12 and 28 joints
// (not at 3), which the same body computes right when they unroll.

template <typename T, int K>
__device__ __forceinline__ void load_rows(const T* __restrict__ x,
                                          long long B, long long b, T* out) {
#pragma unroll
  for (int r = 0; r < K; ++r) out[r] = x[r * B + b];
}

template <typename T, int K>
__device__ __forceinline__ void store_rows(const T* in, long long B,
                                           long long b, T* __restrict__ x) {
#pragma unroll
  for (int r = 0; r < K; ++r) x[r * B + b] = in[r];
}

// a₀'s linear part −g·R[2, :] (minus_g = −gravity)
template <typename T>
__device__ __forceinline__ void base_gravity(const T* Rw, T minus_g, T* a0) {
#pragma unroll
  for (int c = 0; c < 3; ++c) a0[c] = minus_g * Rw[6 + c];
}

// (v̇b, q̈) by floating-base ABA — fb_aba_fused
template <typename T>
__device__ __forceinline__ void fb_aba_state(
    const Robot<T>& R, const T* Ib, const T* quat, const T* q, const T* vb,
    const T* qd, const T* tau, T* dvb_out, T* qdd_out, long long B,
    long long b, T minus_g) {
  T qt[4], qs[N], vbs[6], qds[N], taus[N];
  load_rows<T, 4>(quat, B, b, qt);
  load_rows<T, N>(q, B, b, qs);
  load_rows<T, 6>(vb, B, b, vbs);
  load_rows<T, N>(qd, B, b, qds);
  load_rows<T, N>(tau, B, b, taus);
  T X[N][36], Rw[9], a0[3];
  ff_transforms(R, qs, X);
  quat_rot(qt, Rw);
  base_gravity(Rw, minus_g, a0);

  T v[N][6], zeta[N][6], IA[N][36], pA[N][6], U[N][6], Dinv[N], ubar[N];
GRID_ROLLED
  for (int i = 0; i < N; ++i) {
    const int p = ff_parent(i);
    const T* S = R.S + 6 * i;
    const T* I = R.I + 36 * i;
    T Sqd[6], t[6];
#pragma unroll
    for (int r = 0; r < 6; ++r) Sqd[r] = S[r] * qds[i];
    matvec6(X[i], p < 0 ? vbs : v[p], t);
#pragma unroll
    for (int r = 0; r < 6; ++r) v[i][r] = t[r] + Sqd[r];
    crm_apply(v[i], Sqd, zeta[i]);
    T Iv[6];
    matvec6(I, v[i], Iv);
    crf_apply(v[i], Iv, pA[i]);
#pragma unroll
    for (int e = 0; e < 36; ++e) IA[i][e] = I[e];
  }
  T IAb[36], pAb[6];
  {
    T Iv[6];
    matvec6(Ib, vbs, Iv);
    crf_apply(vbs, Iv, pAb);
#pragma unroll
    for (int e = 0; e < 36; ++e) IAb[e] = Ib[e];
  }
GRID_ROLLED
  for (int i = N - 1; i >= 0; --i) {
    const int p = ff_parent(i);
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
    const T ui = (taus[i] - R.damping[i] * qds[i]) - SpA;
#pragma unroll
    for (int r = 0; r < 6; ++r) U[i][r] = Ui[r];
    Dinv[i] = Di;
    ubar[i] = ui;
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
    // the parent's (or the base's) IA += Xᵀ·(Iᵃ·X)
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
    T* IAp = p < 0 ? IAb : IA[p];
    T* pAp = p < 0 ? pAb : pA[p];
#pragma unroll
    for (int r = 0; r < 6; ++r)
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        T acc = X[i][r] * IaX[k];
#pragma unroll
        for (int c = 1; c < 6; ++c) acc += X[i][c * 6 + r] * IaX[c * 6 + k];
        IAp[r * 6 + k] = IAp[r * 6 + k] + acc;
      }
    matvec6_T(X[i], pa, t);
#pragma unroll
    for (int r = 0; r < 6; ++r) pAp[r] = pAp[r] + t[r];
  }
  // the base: ā_b = −(Iᴬ_b)⁻¹·pᴬ_b
  T ab[6], E[6][6];
#pragma unroll
  for (int r = 0; r < 6; ++r) {
    ab[r] = -pAb[r];
#pragma unroll
    for (int c = 0; c < 6; ++c) E[r][c] = IAb[r * 6 + c];
  }
  chol_factor<T, 6>(E);
  chol_apply<T, 6>(E, ab);
  T qdd[N];
  T (*a)[6] = v;  // a reuses v's storage
GRID_ROLLED
  for (int i = 0; i < N; ++i) {
    const int p = ff_parent(i);
    const T* S = R.S + 6 * i;
    T ap[6], t[6];
    matvec6(X[i], p < 0 ? ab : a[p], t);
#pragma unroll
    for (int r = 0; r < 6; ++r) ap[r] = t[r] + zeta[i][r];
    T Ua = U[i][0] * ap[0];
#pragma unroll
    for (int c = 1; c < 6; ++c) Ua += U[i][c] * ap[c];
    const T qi = Dinv[i] * (ubar[i] - Ua);
    qdd[i] = qi;
#pragma unroll
    for (int r = 0; r < 6; ++r) a[i][r] = ap[r] + S[r] * qi;
  }
  // v̇b = ā_b − a₀'
#pragma unroll
  for (int c = 0; c < 3; ++c) ab[3 + c] = ab[3 + c] - a0[c];
  store_rows<T, 6>(ab, B, b, dvb_out);
  store_rows<T, N>(qdd, B, b, qdd_out);
}

// the shared front half: X, R(quat), the bias and the factored mass matrix;
// x ← [−f_b; τ − c_j]
template <typename T>
__device__ __forceinline__ void fb_front(const Robot<T>& R, const T* Ib,
                                         const T* qt, const T* qs,
                                         const T* vbs, const T* qds,
                                         const T* taus, T minus_g,
                                         T X[N][36], T* Rw, T* A, T* x) {
  T a0[3], f_b[6], c_j[N];
  ff_transforms(R, qs, X);
  quat_rot(qt, Rw);
  base_gravity(Rw, minus_g, a0);
  fb_bias(R, Ib, X, a0, vbs, qds, f_b, c_j);
  fb_mass(R, Ib, X, A);
  ptri_factor<T, FF_M>(A, T(0));
#pragma unroll
  for (int c = 0; c < 6; ++c) x[c] = -f_b[c];
GRID_ROLLED
  for (int i = 0; i < N; ++i) x[6 + i] = taus[i] - c_j[i];
}

// (v̇b, q̈) by the mass matrix — fb_fd_fused
template <typename T>
__device__ __forceinline__ void fb_fd_state(
    const Robot<T>& R, const T* Ib, const T* quat, const T* q, const T* vb,
    const T* qd, const T* tau, T* dvb_out, T* qdd_out, long long B,
    long long b, T minus_g) {
  T qt[4], qs[N], vbs[6], qds[N], taus[N];
  load_rows<T, 4>(quat, B, b, qt);
  load_rows<T, N>(q, B, b, qs);
  load_rows<T, 6>(vb, B, b, vbs);
  load_rows<T, N>(qd, B, b, qds);
  load_rows<T, N>(tau, B, b, taus);
  T X[N][36], Rw[9], A[FF_TRI], x[FF_M];
  fb_front(R, Ib, qt, qs, vbs, qds, taus, minus_g, X, Rw, A, x);
  ptri_apply<T, FF_M, 1>(A, [&](int i, int) -> T& { return x[i]; });
  store_rows<T, 6>(x, B, b, dvb_out);
  store_rows<T, N>(x + 6, B, b, qdd_out);
}

#if GRID_FF_K > 0
// (v̇b, q̈, λ) with the FF_K contacts pinned — stance_fd_fused. off and anc
// are (FF_K, 3) (anc may be null); alpha, beta, reg as in the plain version.
template <typename T>
__device__ __forceinline__ void stance_state(
    const Robot<T>& R, const T* Ib, const T* quat, const T* pos, const T* q,
    const T* vb, const T* qd, const T* tau, const T* __restrict__ off,
    const T* __restrict__ anc, T* dvb_out, T* qdd_out, T* lam_out,
    long long B, long long b, T minus_g, double alpha, double beta,
    double reg) {
  T qt[4], qs[N], vbs[6], qds[N], taus[N];
  load_rows<T, 4>(quat, B, b, qt);
  load_rows<T, N>(q, B, b, qs);
  load_rows<T, 6>(vb, B, b, vbs);
  load_rows<T, N>(qd, B, b, qds);
  load_rows<T, N>(tau, B, b, taus);
  T X[N][36], Rw[9], A[FF_TRI];
  // sol's column s < 3k: row s of J (→ M⁻¹Jᵀ); column 3k: the free rhs
  // (→ y_free)
  T sol[FF_M][FF_K3 + 1];
  T rhs_free[FF_M];
  fb_front(R, Ib, qt, qs, vbs, qds, taus, minus_g, X, Rw, A, rhs_free);

  T J[FF_K][3][FF_C], xb[FF_K][3];
GRID_ROLLED
  for (int ci = 0; ci < FF_K; ++ci)
    contact_rows<T>(R, ci, qs, Rw, off + 3 * ci, J[ci], xb[ci]);
GRID_ROLLED
  for (int c = 0; c < FF_M; ++c) {
GRID_ROLLED
    for (int s = 0; s < FF_K3; ++s) sol[c][s] = T(0);
    sol[c][FF_K3] = rhs_free[c];
  }
GRID_ROLLED
  for (int ci = 0; ci < FF_K; ++ci)
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const int s = 3 * ci + r;
#pragma unroll
      for (int c = 0; c < 6; ++c) sol[c][s] = J[ci][r][c];
GRID_ROLLED
      for (int t = 0; t < c_chains.len[ci]; ++t)
        sol[6 + c_chains.joint[ci][t]][s] = J[ci][r][6 + t];
    }
  ptri_apply<T, FF_M, FF_K3 + 1>(
      A, [&](int i, int k) -> T& { return sol[i][k]; });

  // the bias J̇·[vb; q̇]: the rows on dual numbers along (quaṫ, q̇)
  T bias[FF_K3];
  {
    using D = Dual<T>;
    const T z = T(0);
    // quaṫ = ½ quat ⊗ [0, ω_b]
    const T aw = qt[0], ax = qt[1], ay = qt[2], az = qt[3];
    const T bx = vbs[0], by = vbs[1], bz = vbs[2];
    const T dq[4] = {
        T(0.5) * (aw * z - ax * bx - ay * by - az * bz),
        T(0.5) * (aw * bx + ax * z + ay * bz - az * by),
        T(0.5) * (aw * by + ay * z + az * bx - ax * bz),
        T(0.5) * (aw * bz + az * z + ax * by - ay * bx)};
    D qtd[4], qsd[N], Rwd[9];
#pragma unroll
    for (int k = 0; k < 4; ++k) qtd[k] = D(qt[k], dq[k]);
GRID_ROLLED
    for (int i = 0; i < N; ++i) qsd[i] = D(qs[i], qds[i]);
    quat_rot(qtd, Rwd);
GRID_ROLLED
    for (int ci = 0; ci < FF_K; ++ci) {
      D Jd[3][FF_C], xd[3];
      contact_rows<D>(R, ci, qsd, Rwd, off + 3 * ci, Jd, xd);
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        T acc = Jd[r][0].t * vbs[0];
#pragma unroll
        for (int c = 1; c < 6; ++c) acc += Jd[r][c].t * vbs[c];
GRID_ROLLED
        for (int t = 0; t < c_chains.len[ci]; ++t)
          acc += Jd[r][6 + t].t * qds[c_chains.joint[ci][t]];
        bias[3 * ci + r] = acc;
      }
    }
  }

  // rhs = −(J·y_free + bias − a*), a* = −2α·J·[vb; q̇] − β²·(x_w − anchor)
  T rhs[FF_K3];
GRID_ROLLED
  for (int ci = 0; ci < FF_K; ++ci) {
    T drift[3];
    const bool pinned = beta != 0.0 && anc != nullptr;
    if (pinned) {
      T Rx[3];
      mv3(Rw, xb[ci], Rx);
#pragma unroll
      for (int d = 0; d < 3; ++d)
        drift[d] = (pos[d * B + b] + Rx[d]) - anc[3 * ci + d];
    }
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const int s = 3 * ci + r;
      const int len = c_chains.len[ci];
      T Jyf = J[ci][r][0] * sol[0][FF_K3];
#pragma unroll
      for (int c = 1; c < 6; ++c) Jyf += J[ci][r][c] * sol[c][FF_K3];
GRID_ROLLED
      for (int t = 0; t < len; ++t)
        Jyf += J[ci][r][6 + t] * sol[6 + c_chains.joint[ci][t]][FF_K3];
      T e = Jyf + bias[s];
      bool has_star = false;
      T a_star = T(0);
      if (alpha != 0.0) {
        T Jv = J[ci][r][0] * vbs[0];
#pragma unroll
        for (int c = 1; c < 6; ++c) Jv += J[ci][r][c] * vbs[c];
GRID_ROLLED
        for (int t = 0; t < len; ++t)
          Jv += J[ci][r][6 + t] * qds[c_chains.joint[ci][t]];
        a_star = T(-2.0 * alpha) * Jv;
        has_star = true;
      }
      if (pinned) {
        const T db = T(-beta * beta) * drift[r];
        a_star = has_star ? a_star + db : db;
        has_star = true;
      }
      rhs[s] = -(e - (has_star ? a_star : T(0)));
    }
  }

  // the Delassus G = J·M⁻¹Jᵀ (lower triangle), its factor with reg, λ
  T Gm[FF_K3 * (FF_K3 + 1) / 2];
GRID_ROLLED
  for (int ci = 0; ci < FF_K; ++ci)
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const int row = 3 * ci + r;
GRID_ROLLED
      for (int s = 0; s <= row; ++s) {
        T acc = J[ci][r][0] * sol[0][s];
#pragma unroll
        for (int c = 1; c < 6; ++c) acc += J[ci][r][c] * sol[c][s];
GRID_ROLLED
        for (int t = 0; t < c_chains.len[ci]; ++t)
          acc += J[ci][r][6 + t] * sol[6 + c_chains.joint[ci][t]][s];
        Gm[tri(row, s)] = acc;
      }
    }
  ptri_factor<T, FF_K3>(Gm, T(reg));
  ptri_solve<T, FF_K3>(Gm, rhs);

  // y = y_free + M⁻¹Jᵀ·λ
  T y[FF_M];
GRID_ROLLED
  for (int c = 0; c < FF_M; ++c) {
    T acc = sol[c][0] * rhs[0];
GRID_ROLLED
    for (int s = 1; s < FF_K3; ++s) acc += sol[c][s] * rhs[s];
    y[c] = sol[c][FF_K3] + acc;
  }
  store_rows<T, 6>(y, B, b, dvb_out);
  store_rows<T, N>(y + 6, B, b, qdd_out);
  store_rows<T, FF_K3>(rhs, B, b, lam_out);
}

// One frictional ground step — step_ground_fused (kTerrain false: the plane
// z = ground_z) and step_ground_terrain_fused (true: the heightfield hf) —
// of FF_KT cone contacts and FF_L loop closures, in the JAX order: the kf
// feet (the points off (kf, 3)), the FF_KC collision contacts (col (FF_KC,
// 14), slot_rows), the endpoint spheres of ground geoms (geo (FF_K − kf,
// 4): the centre in its link's frame, then the radius), their links in
// GRID_FF_LINKS after the feet's (−1: the base), then the closures (lp
// (FF_L, 6)). mu (FF_KT, B) the cone contacts'; push (6, B) or null; ridge
// (3·FF_T) the Delassus ridge of each row. Outputs quat⁺, pos⁺, q⁺, vb⁺,
// q̇⁺ and the cone impulses (3·FF_KT, B).
template <typename T, bool kTerrain>
__device__ __forceinline__ void step_state(
    const Robot<T>& R, const T* Ib, const T* quat, const T* pos, const T* q,
    const T* vb, const T* qd, const T* tau, const T* mu, const T* push,
    const T* __restrict__ off, const T* __restrict__ geo,
    const T* __restrict__ col, const T* __restrict__ lp, int kf,
    const T* __restrict__ ridge, const StepParams<T>& sp,
    const Heightfield<T>& hf, T* quat_out, T* pos_out, T* q_out, T* vb_out,
    T* qd_out, T* imp_out, long long B, long long b) {
  constexpr int RT = 3 * FF_T;       // rows
  constexpr int RC = 3 * FF_KT;      // cone rows
  T qt[4], ps[3], qs[N], vbs[6], qds[N], taus[N];
  load_rows<T, 4>(quat, B, b, qt);
  load_rows<T, 3>(pos, B, b, ps);
  load_rows<T, N>(q, B, b, qs);
  load_rows<T, 6>(vb, B, b, vbs);
  load_rows<T, N>(qd, B, b, qds);
  load_rows<T, N>(tau, B, b, taus);
  T X[N][36], Rw[9], A[FF_TRI], rhs_free[FF_M];
  fb_front(R, Ib, qt, qs, vbs, qds, taus, sp.minus_g, X, Rw, A, rhs_free);
  if (push != nullptr) {
    // push − f_b (fb_front left −f_b)
#pragma unroll
    for (int c = 0; c < 6; ++c) rhs_free[c] = push[c * B + b] + rhs_free[c];
  }

  // every triplet's rows, the cone contacts' gaps and active masks, the
  // closures' gaps: one slot_rows call per triplet
  T J[FF_T][3][FF_C], gap[FF_KT], lgap[FF_L > 0 ? 3 * FF_L : 1];
  bool active[FF_KT];
GRID_ROLLED
  for (int ci = 0; ci < FF_T; ++ci) {
    const int ch = chain_of(ci, kf);
    int kind = c_chains.kind[ch];
    const T* e;
    if (ci < kf) {
      e = off + 3 * ci;
    } else if (ci < kf + FF_KC) {
      e = col + 14 * (ci - kf);
    } else if (ci < FF_KT) {
      kind = kGeom;
      e = geo + 4 * (ci - kf - FF_KC);
    } else {
      e = lp + 6 * (ci - FF_KT);
    }
    T g3[3];
    slot_rows<T, kTerrain>(R, kind, ch, qs, Rw, ps, e, sp, hf, J[ci], g3);
    if (ci < FF_KT) {
      gap[ci] = g3[0];
      active[ci] = g3[0] < sp.margin;
    } else {
#pragma unroll
      for (int d = 0; d < 3; ++d) lgap[3 * (ci - FF_KT) + d] = g3[d];
    }
  }

  // one merged solve: sol[c][s < RT] = (M⁻¹Jᵀ)[c][s], sol[c][RT] = the
  // free acceleration
  T sol[FF_M][RT + 1];
GRID_ROLLED
  for (int c = 0; c < FF_M; ++c) {
GRID_ROLLED
    for (int s = 0; s < RT; ++s) sol[c][s] = T(0);
    sol[c][RT] = rhs_free[c];
  }
GRID_ROLLED
  for (int ci = 0; ci < FF_T; ++ci) {
    const int ch = chain_of(ci, kf);
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const int s = 3 * ci + r;
#pragma unroll
      for (int c = 0; c < 6; ++c) sol[c][s] = J[ci][r][c];
GRID_ROLLED
      for (int t = 0; t < c_chains.len[ch]; ++t)
        sol[6 + c_chains.joint[ch][t]][s] = J[ci][r][6 + t];
    }
  }
  ptri_apply<T, FF_M, RT + 1>(A,
                              [&](int i, int k) -> T& { return sol[i][k]; });
  T v[FF_M], vfree[FF_M];
#pragma unroll
  for (int c = 0; c < 6; ++c) v[c] = vbs[c];
GRID_ROLLED
  for (int i = 0; i < N; ++i) v[6 + i] = qds[i];
GRID_ROLLED
  for (int c = 0; c < FF_M; ++c) vfree[c] = v[c] + sp.dt * sol[c][RT];

  // the Delassus G = J·M⁻¹Jᵀ (lower triangle) and b = J·v_free, less v* on
  // the cone normals (−erp·min(gap, 0)/dt − restitution·min(vn, 0)), plus
  // erp·gap/dt on the closures; ÷ dt as the plain version's division by a
  // Python float (a product with sp.inv_dt)
  T Gm[RT * (RT + 1) / 2], bb[RT];
GRID_ROLLED
  for (int ci = 0; ci < FF_T; ++ci) {
    const int ch = chain_of(ci, kf);
    const int len = c_chains.len[ch];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const int row = 3 * ci + r;
GRID_ROLLED
      for (int s = 0; s <= row; ++s) {
        T acc = J[ci][r][0] * sol[0][s];
#pragma unroll
        for (int c = 1; c < 6; ++c) acc += J[ci][r][c] * sol[c][s];
GRID_ROLLED
        for (int t = 0; t < len; ++t)
          acc += J[ci][r][6 + t] * sol[6 + c_chains.joint[ch][t]][s];
        Gm[tri(row, s)] = acc;
      }
      T acc = J[ci][r][0] * vfree[0];
#pragma unroll
      for (int c = 1; c < 6; ++c) acc += J[ci][r][c] * vfree[c];
GRID_ROLLED
      for (int t = 0; t < len; ++t)
        acc += J[ci][r][6 + t] * vfree[6 + c_chains.joint[ch][t]];
      bb[row] = acc;
    }
    if (ci >= FF_KT) {
      const T erp = -sp.neg_erp;
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        const int row = 3 * ci + r;
        bb[row] = bb[row] + erp * lgap[row - RC] * sp.inv_dt;
      }
      continue;
    }
    const T gmin = gap[ci] < T(0) ? gap[ci] : T(0);
    T v_star = sp.neg_erp * gmin * sp.inv_dt;
    if (sp.restitution != T(0)) {
      T vn = J[ci][2][0] * v[0];
#pragma unroll
      for (int c = 1; c < 6; ++c) vn += J[ci][2][c] * v[c];
GRID_ROLLED
      for (int t = 0; t < len; ++t)
        vn += J[ci][2][6 + t] * v[6 + c_chains.joint[ch][t]];
      v_star = v_star - sp.restitution * (vn < T(0) ? vn : T(0));
    }
    bb[3 * ci + 2] = bb[3 * ci + 2] - v_star;
  }

  // projected Gauss–Seidel (pgs, contact.cuh): the cones, then the
  // closures' bilateral rows
  T reg[RT], p[RT], muv[FF_KT];
#pragma unroll
  for (int r = 0; r < RT; ++r) reg[r] = ridge[r];
#pragma unroll
  for (int ci = 0; ci < FF_KT; ++ci) muv[ci] = mu[ci * B + b];
  pgs<T, FF_KT, 3 * FF_L>(Gm, bb, muv, active, reg, sp.iters, p);

  // v⁺ = v_free + M⁻¹Jᵀ·p; the attitude by quat ⊗ exp(½·ω⁺·dt),
  // renormalised; pos by the new rotation; q by q̇⁺
  T vn[FF_M];
GRID_ROLLED
  for (int c = 0; c < FF_M; ++c) {
    T acc = sol[c][0] * p[0];
#pragma unroll
    for (int s = 1; s < RT; ++s) acc += sol[c][s] * p[s];
    vn[c] = vfree[c] + acc;
  }
  T w_dt[3], q2[4], R2[9], t3[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) w_dt[c] = vn[c] * sp.dt;
  quat_step(qt, w_dt, q2);
  quat_rot(q2, R2);
  mv3(R2, vn + 3, t3);
#pragma unroll
  for (int d = 0; d < 3; ++d) ps[d] = ps[d] + sp.dt * t3[d];
GRID_ROLLED
  for (int i = 0; i < N; ++i) qs[i] = qs[i] + sp.dt * vn[6 + i];
  store_rows<T, 4>(q2, B, b, quat_out);
  store_rows<T, 3>(ps, B, b, pos_out);
  store_rows<T, N>(qs, B, b, q_out);
  store_rows<T, 6>(vn, B, b, vb_out);
  store_rows<T, N>(vn + 6, B, b, qd_out);
  store_rows<T, RC>(p, B, b, imp_out);
}
#endif  // GRID_FF_K > 0

}  // namespace grid
