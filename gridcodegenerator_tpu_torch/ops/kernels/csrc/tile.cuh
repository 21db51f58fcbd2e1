// The staged K5, K2′, K1, K4 and ∂ID's vaf, and the single-kernel
// recursion ∇FD, as CTA tiles: S states a CTA, each state's working set in
// shared memory.
//
//   grad_cols_tile    K5, body_grad of id_grad_staged / fd_grad_staged
//                     (gridcodegenerator_tpu/ops/kernels/staged.py:356,
//                     :470): rnea_grad_cols_bl for every column at once,
//                     the sides asked for, with or without the fused
//                     −M⁻¹·∂c finish; the CTA's threads over the work items
//                     of each phase, a barrier between phases
//   minv_dense_tile   K2′, minv_qdd_dense_staged (staged.py:218): CRBA,
//                     the column Cholesky, L⁻ᵀL⁻¹ and, with a right-hand
//                     side, q̈ = M⁻¹·rhs; one warp a state, warp barriers
//                     between its phases
//   vaf_tile          K1 (bias_and_v_staged, staged.py:172), K4
//                     (fd_grad_staged's body_af, staged.py:453; bf16 v where
//                     s16) and ∂ID's vaf (id_grad_staged's body_vaf,
//                     staged.py:341): rnea_fwd_bl / rnea_bwd_bl, one item a
//                     joint of a state, the joints of a wave side by side
//   fd_grad_tile      fd_grad_fused (fused.py:394; body blops.fd_grad_bl)
//                     up to MAX_KERNEL_JOINTS: X, the bias RNEA, minv_bl,
//                     q̈, the second sweep, rnea_grad_inner_bl on K5's
//                     packed columns and waves, −M⁻¹·∂c, every phase in
//                     shared memory; the bias sweep's backward runs in the
//                     M⁻¹ recursion's backward waves and the second sweep's
//                     beside K5's forward waves (neither reads what the
//                     other writes), so the barriers are fewer
//
// What they replace: the one-thread-per-state bodies of staged.cuh
// (grad_cols_state, minv_dense_state), whose per-thread frames (15.4 KB and
// 14.4 KB a state in f32 at Atlas) live in local memory: K5's seven column
// blocks each rebuilt X(q) and reloaded v, a, f, and its finish re-read
// M⁻¹ once a block. Here a state's X, v, a, f and its ∂-tensors are loaded
// or built once, in shared memory, and only the nonzero columns are kept:
// ∂v_i and ∂a_i in the columns of i's ancestors and i, ∂f_i in those and
// i's subtree, packed joint by joint (the reference's layout, SURVEY.md).
// The joint recursions run in BFS waves — forward from the roots, backward
// from the deepest parents, each parent gathering its children in
// descending order — so every sum keeps the plain version's order
// (blops.rnea_grad_cols_bl, blops.crba_bl, contact_fused._chol_*); nvcc's
// FMA contraction is the only difference in rounding. Loads and stores go
// with consecutive threads on consecutive states of one element of the
// batch-last (…, B) tensors, several loads in flight a thread.
//
// X_i is kept as its two 3×3 blocks (18 values, not 36). What bounds them:
// one CTA fills an SM's shared memory (7 states of K5 or 23 of K2′ in f32
// at Atlas), so each SM holds few independent chains; the recursions'
// waves, the factor's columns and the shared-memory traffic of the sums
// set the time, not the device memory (the bound is 4–8 % of it). The
// sweep tile and the ∇FD tile are sized for two CTAs an SM
// (_build.TILE_CTAS), so one CTA's loads and barriers overlap the other's
// work; each phase costs about a thousand cycles of dependent shared-memory
// loads and sums whatever its items, so their time follows the number of
// waves and phases (the ∇FD's ≈ 60 at iiwa-14), and the device memory
// bounds neither (K4 at Atlas moves ≈ 2.3 KB a state).
//
// The topology is compile-time data: ops/kernels/_build.py
// (grad_cols_tile_plan, minv_tile_plan) passes the item tables and the
// tile sizes as -D lists; the tables sit in __constant__ memory and each
// CTA copies them to shared memory, where its threads index them at run
// time. A state's values and the states a CTA (at most 227 KB with the
// constants and the tables) come from the same plan.
#pragma once

#include "staged.cuh"

#if !defined(GRID_K5_TABLE) || !defined(GRID_K2_TABLE) || \
    !defined(GRID_RN_TABLE) || !defined(GRID_FD_PLAN)
#error "compile with -DGRID_K5_TABLE=… -DGRID_K2_TABLE=… -DGRID_RN_TABLE=… -DGRID_FD_PLAN=… (_build.py)"
#endif

namespace grid {

#define G(x) x,
__constant__ short c_k5_table[] = {GRID_K5_TABLE};
__constant__ short c_k2_table[] = {GRID_K2_TABLE};
__constant__ short c_rn_table[] = {GRID_RN_TABLE};
// offsets into the tables, in _build.py's order
constexpr int kK5Offs[] = {GRID_K5_OFFS};
constexpr int kK2Offs[] = {GRID_K2_OFFS};
constexpr int kRnOffs[] = {GRID_RN_OFFS};
// K5: packed ∂v/∂a columns, packed ∂f columns, forward waves, region A,
// stride, states a CTA in f32 and in f64
constexpr int kK5Plan[] = {GRID_K5_PLAN};
// K2′: sweep waves, IC / L⁻¹ values, M values, stride, states f32 / f64
constexpr int kK2Plan[] = {GRID_K2_PLAN};
// the sweeps (K1, K4, vaf): waves, stride, states f32 / f64, threads f32 /
// f64
constexpr int kRnPlan[] = {GRID_RN_PLAN};
// the ∇FD tile: region B's values, stride, states f32 / f64, threads f32 /
// f64
constexpr int kFdPlan[] = {GRID_FD_PLAN};
#undef G

constexpr int kK5Table = sizeof(c_k5_table) / sizeof(short);
constexpr int kK2Table = sizeof(c_k2_table) / sizeof(short);
constexpr int DVA = kK5Plan[0];
constexpr int DF = kK5Plan[1];
constexpr int kK5Waves = kK5Plan[2];
constexpr int kK5Region = kK5Plan[3];
constexpr int kK5Stride = kK5Plan[4];
constexpr int kK5Side = 12 * DVA + 6 * DF;  // ∂v, ∂a, ∂f of one side
constexpr int kK2Waves = kK2Plan[0];
constexpr int kK2IC = kK2Plan[1];
constexpr int kK2Stride = kK2Plan[3];

constexpr int kK5States32 = kK5Plan[5], kK5States64 = kK5Plan[6];
constexpr int kK2States32 = kK2Plan[4], kK2States64 = kK2Plan[5];
constexpr int kRnTable = sizeof(c_rn_table) / sizeof(short);
constexpr int kRnWaves = kRnPlan[0];
constexpr int kVafStride = kRnPlan[1];
constexpr int kFdB = kFdPlan[0];
constexpr int kFdStride = kFdPlan[1];
constexpr int kVafStates32 = kRnPlan[2], kVafStates64 = kRnPlan[3],
              kVafThreads32 = kRnPlan[4], kVafThreads64 = kRnPlan[5];
constexpr int kFdStates32 = kFdPlan[2], kFdStates64 = kFdPlan[3],
              kFdThreads32 = kFdPlan[4], kFdThreads64 = kFdPlan[5];

// states a CTA and threads a CTA of the sweep tile and the ∇FD tile
template <typename T>
__host__ __device__ constexpr int vaf_states() {
  return sizeof(T) == 4 ? kVafStates32 : kVafStates64;
}
template <typename T>
__host__ __device__ constexpr int vaf_threads() {
  return sizeof(T) == 4 ? kVafThreads32 : kVafThreads64;
}
template <typename T>
__host__ __device__ constexpr int fd_states() {
  return sizeof(T) == 4 ? kFdStates32 : kFdStates64;
}
template <typename T>
__host__ __device__ constexpr int fd_threads() {
  return sizeof(T) == 4 ? kFdThreads32 : kFdThreads64;
}

template <typename T>
__host__ __device__ constexpr int k5_states() {
  return sizeof(T) == 4 ? kK5States32 : kK5States64;
}
template <typename T>
__host__ __device__ constexpr int k2_states() {
  return sizeof(T) == 4 ? kK2States32 : kK2States64;
}

// dynamic shared memory of one CTA: constants, tile, tables (16 B aligned)
template <typename T>
constexpr size_t tile_smem(int states, int stride, int table) {
  return (kConstCount + static_cast<size_t>(states) * stride) * sizeof(T) +
         (2 * static_cast<size_t>(table) + 15) / 16 * 16;
}

// the offsets as scalars: device code may read constexpr scalars, not
// constexpr arrays
constexpr int kO5Par = kK5Offs[0], kO5Prism = kK5Offs[1], kO5Fw = kK5Offs[2],
              kO5FwWaves = kK5Offs[3], kO5Bw = kK5Offs[4],
              kO5BwWaves = kK5Offs[5], kO5ChStart = kK5Offs[6],
              kO5ChList = kK5Offs[7], kO5DfSlot = kK5Offs[8],
              kO5DfIk = kK5Offs[9], kO5ColStart = kK5Offs[10],
              kO5ColI = kK5Offs[11], kO5ColD = kK5Offs[12];
constexpr int kO2Par = kK2Offs[0], kO2Prism = kK2Offs[1], kO2Cw = kK2Offs[2],
              kO2C = kK2Offs[3], kO2Pw = kK2Offs[4], kO2P = kK2Offs[5],
              kO2Pos = kK2Offs[6], kO2ChStart = kK2Offs[7],
              kO2ChList = kK2Offs[8];
constexpr int kORPar = kRnOffs[0], kORPrism = kRnOffs[1], kORFw = kRnOffs[2],
              kORFwWaves = kRnOffs[3], kORBw = kRnOffs[4],
              kORBwWaves = kRnOffs[5], kORChStart = kRnOffs[6],
              kORChList = kRnOffs[7];

struct K5Tables {
  const short *par, *prism, *fw, *fw_waves, *bw, *bw_waves, *ch_start,
      *ch_list, *df_slot, *df_ik, *col_start, *col_i, *col_d;
  __host__ __device__ explicit K5Tables(const short* t)
      : par(t + kO5Par), prism(t + kO5Prism), fw(t + kO5Fw),
        fw_waves(t + kO5FwWaves), bw(t + kO5Bw), bw_waves(t + kO5BwWaves),
        ch_start(t + kO5ChStart), ch_list(t + kO5ChList),
        df_slot(t + kO5DfSlot), df_ik(t + kO5DfIk),
        col_start(t + kO5ColStart), col_i(t + kO5ColI), col_d(t + kO5ColD) {}
};

struct K2Tables {
  const short *par, *prism, *cw, *c, *pw, *p, *pos, *ch_start, *ch_list;
  __host__ __device__ explicit K2Tables(const short* t)
      : par(t + kO2Par), prism(t + kO2Prism), cw(t + kO2Cw), c(t + kO2C),
        pw(t + kO2Pw), p(t + kO2P), pos(t + kO2Pos),
        ch_start(t + kO2ChStart), ch_list(t + kO2ChList) {}
};

// the sweeps' tables: the joints wave by wave from the roots (fw), the
// parents wave by wave from the deepest (bw), each parent's children in
// descending order
struct RnTables {
  const short *par, *prism, *fw, *fw_waves, *bw, *bw_waves, *ch_start,
      *ch_list;
  __host__ __device__ explicit RnTables(const short* t)
      : par(t + kORPar), prism(t + kORPrism), fw(t + kORFw),
        fw_waves(t + kORFwWaves), bw(t + kORBw), bw_waves(t + kORBwWaves),
        ch_start(t + kORChStart), ch_list(t + kORChList) {}
};

// load(idx) → store(idx, value) for idx in [0, kCount), thread tid of NT:
// kBatch loads in flight a thread before their stores, so a phase that
// reads device memory waits for its latency once a batch, not once a value
template <typename T, int NT, int kCount, int kBatch = 8, typename Load,
          typename Store>
__device__ __forceinline__ void copy_batched(int tid, Load load, Store store) {
  for (int base = tid; base < kCount; base += NT * kBatch) {
    T val[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int idx = base + u * NT;
      if (idx < kCount) val[u] = load(idx);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int idx = base + u * NT;
      if (idx < kCount) store(idx, val[u]);
    }
  }
}

// X_i as its two 3×3 blocks, 18 values: E (row-major; X's top-left and
// bottom-right block) then B (bottom-left): X = [[E, 0], [B, E]], the
// form of every spatial transform (its top-right block is zero by
// construction). The products skip only the zero block: every sum keeps
// the order of the 6×6 product (rbd.cuh's matvec6, matvec6_T).
constexpr int kXs = 18;

// X·v
template <typename A, typename V, typename T>
__device__ __forceinline__ void x_mul(const A* X, const V* v, T* out) {
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    T top = X[3 * a] * v[0];
    top += X[3 * a + 1] * v[1];
    top += X[3 * a + 2] * v[2];
    T bot = X[9 + 3 * a] * v[0];
    bot += X[9 + 3 * a + 1] * v[1];
    bot += X[9 + 3 * a + 2] * v[2];
    bot += X[3 * a] * v[3];
    bot += X[3 * a + 1] * v[4];
    bot += X[3 * a + 2] * v[5];
    out[a] = top;
    out[3 + a] = bot;
  }
}

// Xᵀ·v
template <typename A, typename V, typename T>
__device__ __forceinline__ void xt_mul(const A* X, const V* v, T* out) {
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    T top = X[a] * v[0];
    top += X[3 + a] * v[1];
    top += X[6 + a] * v[2];
    top += X[9 + a] * v[3];
    top += X[12 + a] * v[4];
    top += X[15 + a] * v[5];
    T bot = X[a] * v[3];
    bot += X[3 + a] * v[4];
    bot += X[6 + a] * v[5];
    out[a] = top;
    out[3 + a] = bot;
  }
}

// sin and cos of q_i (q_i itself for a prismatic joint) of S states into
// sc[2i], sc[2i + 1] of each state's slice; consecutive threads read
// consecutive states of q
template <typename T, int S, int NT>
__device__ __forceinline__ void load_sincos(int tid, const short* prism,
                                            const T* __restrict__ q,
                                            long long B, long long b0,
                                            T* tile, int stride, int sc_off) {
  copy_batched<T, NT, N * S>(
      tid,
      [&](int idx) {
        const long long b = b0 + idx % S;
        return b < B ? q[(idx / S) * B + b] : T(0);
      },
      [&](int idx, T qi) {
        const int s = idx % S, i = idx / S;
        T* sc = tile + s * stride + sc_off + 2 * i;
        if (prism[i]) {
          sc[0] = qi;
        } else {
          sincos_t(qi, &sc[0], &sc[1]);
        }
      });
}

// X_i's blocks of every joint of one state (rbd.cuh's joint_transforms)
// from sc, into X at 0 of st, threads lane of L; with inertia_at ≥ 0 also
// IC_i = I_i there
template <typename T, int L>
__device__ __forceinline__ void build_X(int lane, const Robot<T>& R,
                                        const short* prism, T* st,
                                        int sc_off, int inertia_at) {
#pragma unroll 4
  for (int e = lane; e < kXs * N; e += L) {
    const int i = e / kXs, x = e % kXs;
    const int g = 36 * i + (x < 9 ? 6 * (x / 3) + x % 3
                                  : 6 * (3 + (x - 9) / 3) + (x - 9) % 3);
    const T* sc = st + sc_off + 2 * i;
    st[e] = prism[i] ? R.Xb[g] + R.Xs[g] * sc[0]
                     : R.Xb[g] + R.Xs[g] * sc[0] + R.Xc[g] * sc[1];
  }
  if (inertia_at >= 0)
    for (int e = lane; e < 36 * N; e += L) st[inertia_at + e] = R.I[e];
}

// X_i's blocks of S states (build_X's sums), one item a joint of a state,
// state-fastest: a warp's lanes read one joint's constants (a broadcast)
// and sin/cos of consecutive states
template <typename T, int S, int NT>
__device__ __forceinline__ void build_X_states(int tid, const Robot<T>& R,
                                               const short* prism, T* tile,
                                               int stride, int sc_off) {
  for (int idx = tid; idx < N * S; idx += NT) {
    const int i = idx / S;
    T* st = tile + (idx % S) * stride;
    const bool pr = prism[i];
    const T s0 = st[sc_off + 2 * i];
    const T c0 = pr ? T(0) : st[sc_off + 2 * i + 1];
    T* X = st + kXs * i;
#pragma unroll
    for (int x = 0; x < kXs; ++x) {
      const int g = 36 * i + (x < 9 ? 6 * (x / 3) + x % 3
                                    : 6 * (3 + (x - 9) / 3) + (x - 9) % 3);
      X[x] = pr ? R.Xb[g] + R.Xs[g] * s0
                : R.Xb[g] + R.Xs[g] * s0 + R.Xc[g] * c0;
    }
  }
}

// ------------------------------------------------------------------- K5
// One state's slice: region A — X (18n), v, a, f, I·v, X_iᵀ·(S_i ×* f_i)
// (6n each), M⁻¹ (n²) in the staged K5's finish — then each side's ∂v, ∂a
// (6 rows of DVA packed columns) and ∂f (6 rows of DF). The rows of a
// packed tensor are DVA (or DF) apart, so consecutive items touch
// consecutive words. In the staged K5, side 1's ∂f rows hold q̇ and side
// 0's the q side's ∂v seeds until the forward sweep is done, side 0's ∂a
// rows sin/cos of q until X is built; the rows ∂c of both sides (2·DF) and
// then the outputs (2n²) reuse the space of the ∂-tensors.
constexpr int kV = 18 * N, kA = 24 * N, kF = 30 * N, kIv = 36 * N,
              kSow = 42 * N;
constexpr int kSc = kK5Region + 6 * DVA;
constexpr int kOut = kK5Region + 2 * DF;  // the finish's outputs, 2n²
constexpr int kSeedV = kK5Region + 12 * DVA;  // the q side's ∂v seeds, 6n

// Where a tile keeps what differs between its users: its stride, q̇ (and
// q̈), and M⁻¹ for K5's finish (row-major). The staged K5's layout:
struct K5Layout {
  static constexpr int kStride = kK5Stride;
  static constexpr int kQd = kK5Region + kK5Side + 12 * DVA;
  static constexpr int kM = 0;  // over X, v, a, f once the rows are formed
  static constexpr int kSeedA = kF;  // the q side's ∂a seeds, over f
};

// one forward item: column k of joint i's ∂v and ∂a, one side
// (grad_cols_side's forward loop for one column); the q side's seeds of
// column i wait in kSeedV and kSeedAt (k5_prologue); qdi is q̇_i
template <typename T, int kSeedAt>
__device__ __forceinline__ void k5_forward(const Robot<T>& R, T* st, T* dv,
                                           T* da, bool kq, int i, int k,
                                           int dst, int src, T qdi) {
  const T* X = st + kXs * i;
  const T* S = R.S + 6 * i;
  // each row of X once for both products, X_i·∂v_p and X_i·∂a_p: row a of
  // E against components 0–2, row a of B against 0–2 then of E against 3–5
  T dvc[6], dac[6], t[6];
#pragma unroll
  for (int r = 0; r < 6; ++r) {
    dvc[r] = T(0);
    dac[r] = T(0);
  }
  if (src >= 0) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const T* E = X + 3 * a;
      const T* Bm = X + 9 + 3 * a;
      T v1 = E[0] * dv[src], a1 = E[0] * da[src];
      T v2 = Bm[0] * dv[src], a2 = Bm[0] * da[src];
#pragma unroll
      for (int c = 1; c < 3; ++c) {
        v1 += E[c] * dv[c * DVA + src];
        a1 += E[c] * da[c * DVA + src];
        v2 += Bm[c] * dv[c * DVA + src];
        a2 += Bm[c] * da[c * DVA + src];
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        v2 += E[c] * dv[(3 + c) * DVA + src];
        a2 += E[c] * da[(3 + c) * DVA + src];
      }
      dvc[a] = v1;
      dac[a] = a1;
      dvc[3 + a] = v2;
      dac[3 + a] = a2;
    }
  }
  if (k == i) {
#pragma unroll
    for (int r = 0; r < 6; ++r)
      dvc[r] = dvc[r] + (kq ? st[kSeedV + 6 * i + r] : S[r]);
  }
#pragma unroll
  for (int r = 0; r < 6; ++r) dv[r * DVA + dst] = dvc[r];
  crm_apply(S, dvc, t);
#pragma unroll
  for (int r = 0; r < 6; ++r) dac[r] = dac[r] - qdi * t[r];
  if (k == i) {
    T t2[6];
    if (kq) {
#pragma unroll
      for (int r = 0; r < 6; ++r) t2[r] = st[kSeedAt + 6 * i + r];
    } else {
      crm_apply(S, st + kV + 6 * i, t2);
#pragma unroll
      for (int r = 0; r < 6; ++r) t2[r] = -t2[r];
    }
#pragma unroll
    for (int r = 0; r < 6; ++r) dac[r] = dac[r] + t2[r];
  }
#pragma unroll
  for (int r = 0; r < 6; ++r) da[r * DVA + dst] = dac[r];
}

// ∂f_i = crf(∂v)·I·v + crf(v)·(I·∂v) + I·∂a for one packed column, summed
// in rnea_grad_cols_bl's order, or with kInner in rnea_grad_inner_bl's:
// crf(∂v)·I·v + I·∂a + crf(v)·(I·∂v)
template <typename T, bool kInner = false>
__device__ __forceinline__ void k5_force(const Robot<T>& R, const T* st,
                                         const T* dv, const T* da, T* df,
                                         int i, int src, int dfd) {
  const T* I = R.I + 36 * i;
  T dvc[6], dac[6];
#pragma unroll
  for (int r = 0; r < 6; ++r) {
    dvc[r] = dv[r * DVA + src];
    dac[r] = da[r * DVA + src];
  }
  T A1[6], Idv[6], A2[6], A3[6];
  crf_apply(dvc, st + kIv + 6 * i, A1);
  matvec6(I, dvc, Idv);
  crf_apply(st + kV + 6 * i, Idv, A2);
  matvec6(I, dac, A3);
#pragma unroll
  for (int r = 0; r < 6; ++r)
    df[r * DF + dfd] = kInner ? (A1[r] + A3[r]) + A2[r]
                              : (A1[r] + A2[r]) + A3[r];
}

// one backward item: column k of joint p's ∂f, its own forward value (if
// any) plus X_cᵀ·∂f_c of each child c in descending order, and on the q
// side X_cᵀ·(S_c ×* f_c) into column c right after child c's term
template <typename T>
__device__ __forceinline__ void k5_backward(const K5Tables& tb, const T* st,
                                            T* df, bool kq, int p, int k,
                                            int dst, bool own) {
  T acc[6];
#pragma unroll
  for (int r = 0; r < 6; ++r) acc[r] = own ? df[r * DF + dst] : T(0);
  for (int j = tb.ch_start[p]; j < tb.ch_start[p + 1]; ++j) {
    const int c = tb.ch_list[j];
    const int sl = tb.df_slot[c * N + k];
    if (sl >= 0) {
      T col[6], t[6];
#pragma unroll
      for (int r = 0; r < 6; ++r) col[r] = df[r * DF + sl];
      xt_mul(st + kXs * c, col, t);
#pragma unroll
      for (int r = 0; r < 6; ++r) acc[r] = acc[r] + t[r];
    }
    if (kq && k == c) {
#pragma unroll
      for (int r = 0; r < 6; ++r) acc[r] = acc[r] + st[kSow + 6 * c + r];
    }
  }
#pragma unroll
  for (int r = 0; r < 6; ++r) df[r * DF + dst] = acc[r];
}

// the side of item group g of nsides
__device__ __forceinline__ int side_of(int sides, int g) {
  return sides == 3 ? g : sides - 1;
}

// K5's prologue for joint i of one state of layout L: I·v, with kWithSow
// the q side's backward seed X_iᵀ·(S_i ×* f_i) (f summed to the root), the
// q side's forward seeds −S_i×(X_i·v_p) (∂v, into kSeedV) and −S_i×(X_i·a_p)
// (∂a, into L::kSeedA; −S_i×(X_i·a_g) at a root). The staged K5 keeps the
// latter over f_i, which only this item reads.
template <typename T, typename L, bool kWithSow>
__device__ __forceinline__ void k5_prologue(const Robot<T>& R,
                                            const K5Tables& tb, T* st, int i,
                                            T minus_g) {
  const int p = tb.par[i];
  const T* X = st + kXs * i;
  const T* Si = R.S + 6 * i;
  matvec6(R.I + 36 * i, st + kV + 6 * i, st + kIv + 6 * i);
  T base[6], t[6];
  if (p >= 0) {
    if (kWithSow) {
      crf_apply(Si, st + kF + 6 * i, t);
      xt_mul(X, t, st + kSow + 6 * i);
    }
    x_mul(X, st + kV + 6 * p, base);
  } else {
#pragma unroll
    for (int r = 0; r < 6; ++r) base[r] = T(0);
  }
  crm_apply(Si, base, t);
#pragma unroll
  for (int r = 0; r < 6; ++r) st[kSeedV + 6 * i + r] = -t[r];
  if (p >= 0) {
    x_mul(X, st + kA + 6 * p, base);
  } else {
    // X·a_g, a_g = [0, …, 0, −gravity]: X's last column, (0; E[:, 2])
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      base[r] = T(0) * minus_g;
      base[3 + r] = X[3 * r + 2] * minus_g;
    }
  }
  crm_apply(Si, base, t);
#pragma unroll
  for (int r = 0; r < 6; ++r) st[L::kSeedA + 6 * i + r] = -t[r];
}

// the q side's backward seed alone, X_iᵀ·(S_i ×* f_i) (joints with a
// parent)
template <typename T>
__device__ __forceinline__ void k5_sow(const Robot<T>& R, const K5Tables& tb,
                                       T* st, int i) {
  if (tb.par[i] < 0) return;
  T t[6];
  crf_apply(R.S + 6 * i, st + kF + 6 * i, t);
  xt_mul(st + kXs * i, t, st + kSow + 6 * i);
}

// K5's forward items of wave w (∂v, ∂a column by column), no barrier
template <typename T, int S, int NT, typename L>
__device__ __forceinline__ void k5_fwd_wave(int tid, const Robot<T>& R,
                                            const K5Tables& tb, T* tile,
                                            int sides, int w) {
  const int nsides = sides == 3 ? 2 : 1;
  const int w0 = tb.fw_waves[w], nw = tb.fw_waves[w + 1] - w0;
  for (int idx = tid; idx < nw * nsides * S; idx += NT) {
    const int e = idx % nw, rest = idx / nw;
    const int side = side_of(sides, rest % nsides);
    const short* it = tb.fw + 5 * (w0 + e);
    const int i = it[0];
    T* st = tile + (rest / nsides) * L::kStride;
    T* dv = st + kK5Region + side * kK5Side;
    k5_forward<T, L::kSeedA>(R, st, dv, dv + 6 * DVA, side == 0, i, it[1],
                             it[2], it[3], st[L::kQd + i]);
  }
}

// ∂f of every packed column from ∂v and ∂a, all at once, no barrier
template <typename T, int S, int NT, typename L, bool kInner>
__device__ __forceinline__ void k5_force_items(int tid, const Robot<T>& R,
                                               const K5Tables& tb, T* tile,
                                               int sides) {
  const int nsides = sides == 3 ? 2 : 1;
  for (int idx = tid; idx < DVA * nsides * S; idx += NT) {
    const int e = idx % DVA, rest = idx / DVA;
    const int side = side_of(sides, rest % nsides);
    const short* it = tb.fw + 5 * e;
    T* st = tile + (rest / nsides) * L::kStride;
    T* dv = st + kK5Region + side * kK5Side;
    k5_force<T, kInner>(R, st, dv, dv + 6 * DVA, dv + 12 * DVA, it[0], it[2],
                        it[4]);
  }
}

// backward: ∂f to the root, from the deepest parents, a barrier a wave
template <typename T, int S, int NT, typename L>
__device__ __forceinline__ void k5_bwd_waves(int tid, const K5Tables& tb,
                                             T* tile, int sides) {
  const int nsides = sides == 3 ? 2 : 1;
  for (int w = 0; w + 1 < kK5Waves; ++w) {
    const int w0 = tb.bw_waves[w], nw = tb.bw_waves[w + 1] - w0;
    for (int idx = tid; idx < nw * nsides * S; idx += NT) {
      const int e = idx % nw, rest = idx / nw;
      const int side = side_of(sides, rest % nsides);
      const short* it = tb.bw + 4 * (w0 + e);
      T* st = tile + (rest / nsides) * L::kStride;
      k5_backward<T>(tb, st, st + kK5Region + side * kK5Side + 12 * DVA,
                     side == 0, it[0], it[1], it[2], it[3] != 0);
    }
    __syncthreads();
  }
}

// K5's sweeps for S states of layout L whose X, v, a, f (f summed to the
// root) and q̇ are in the tile, thread tid of NT: the prologue (I·v, the
// q side's seeds), ∂v and ∂a wave by wave from the roots, ∂f of every
// packed column, ∂f to the root from the deepest parents; sides: bit 0
// ∂c/∂q, bit 1 ∂c/∂q̇. kInner sums ∂f in rnea_grad_inner_bl's order.
template <typename T, int S, int NT, typename L, bool kInner>
__device__ __forceinline__ void k5_sweeps(int tid, const Robot<T>& R,
                                          const K5Tables& tb, T* tile,
                                          int sides, T minus_g) {
  for (int idx = tid; idx < N * S; idx += NT)
    k5_prologue<T, L, true>(R, tb, tile + (idx / N) * L::kStride, idx % N,
                            minus_g);
  __syncthreads();
  for (int w = 0; w < kK5Waves; ++w) {
    k5_fwd_wave<T, S, NT, L>(tid, R, tb, tile, sides, w);
    __syncthreads();
  }
  k5_force_items<T, S, NT, L, kInner>(tid, R, tb, tile, sides);
  __syncthreads();
  k5_bwd_waves<T, S, NT, L>(tid, tb, tile, sides);
}

// the rows ∂c_i = S_iᵀ·∂f_i (+ damping_i at column i, q̇ side), both sides
// into side 0's ∂v rows (no barrier after)
template <typename T, int S, int NT, typename L>
__device__ __forceinline__ void k5_rows(int tid, const Robot<T>& R,
                                        const K5Tables& tb, T* tile,
                                        int sides) {
  const int nsides = sides == 3 ? 2 : 1;
  for (int idx = tid; idx < DF * nsides * S; idx += NT) {
    const int d = idx % DF, rest = idx / DF;
    const int side = side_of(sides, rest % nsides);
    T* st = tile + (rest / nsides) * L::kStride;
    const T* df = st + kK5Region + side * kK5Side + 12 * DVA;
    const int i = tb.df_ik[2 * d], k = tb.df_ik[2 * d + 1];
    const T* Si = R.S + 6 * i;
    T acc = Si[0] * df[d];
#pragma unroll
    for (int r = 1; r < 6; ++r) acc += Si[r] * df[r * DF + d];
    if (side == 1 && k == i) acc = acc + R.damping[i];
    st[kK5Region + side * DF + d] = acc;
  }
}

// the finish −M⁻¹·∂c, M⁻¹ at L::kM: one thread a column c of a side and a
// state, and a block of up to 8 output rows r summed side by side (each in
// ascending row order): the column's rows of ∂c are read once a block; the
// results wait in region B past the rows ∂c for the state-consecutive
// store (a barrier after)
template <typename T, int S, int NT, typename L>
__device__ __forceinline__ void k5_finish(int tid, const K5Tables& tb,
                                          T* tile, int sides) {
  const int nsides = sides == 3 ? 2 : 1;
  constexpr int kR = N < 8 ? N : 8, kRB = (N + kR - 1) / kR;
  for (int idx = tid; idx < kRB * N * nsides * S; idx += NT) {
    const int s = idx % S, rest = idx / S;
    const int c = rest % N, rest2 = rest / N;
    const int side = side_of(sides, rest2 % nsides);
    const int r0 = kR * (rest2 / nsides);
    const T* st = tile + s * L::kStride;
    const T* dc = st + kK5Region + side * DF;
    T* out = tile + s * L::kStride + kOut + side * N * N + c;
    const int j0 = tb.col_start[c], j1 = tb.col_start[c + 1];
    T acc[kR];
    {
      const T x = dc[tb.col_d[j0]];
      const T* Mi = st + L::kM + r0 * N + tb.col_i[j0];
#pragma unroll
      for (int rr = 0; rr < kR; ++rr)
        if (r0 + rr < N) acc[rr] = Mi[rr * N] * x;
    }
    for (int j = j0 + 1; j < j1; ++j) {
      const T x = dc[tb.col_d[j]];
      const T* Mi = st + L::kM + r0 * N + tb.col_i[j];
#pragma unroll
      for (int rr = 0; rr < kR; ++rr)
        if (r0 + rr < N) acc[rr] = acc[rr] + Mi[rr * N] * x;
    }
#pragma unroll
    for (int rr = 0; rr < kR; ++rr)
      if (r0 + rr < N) out[(r0 + rr) * N] = -acc[rr];
  }
  __syncthreads();
}

// the store, consecutive threads on consecutive states: the finish's
// results, or the rows ∂c themselves (zero off the packed columns)
template <typename T, int S, int NT, typename L>
__device__ __forceinline__ void k5_store(int tid, const K5Tables& tb,
                                         const T* tile, bool finish,
                                         T* __restrict__ dq,
                                         T* __restrict__ dqd, long long B,
                                         long long b0, int sides) {
  const int nsides = sides == 3 ? 2 : 1;
  for (int idx = tid; idx < N * N * nsides * S; idx += NT) {
    const int s = idx % S, rest = idx / S;
    const int e = rest % (N * N);
    const int side = side_of(sides, rest / (N * N));
    const long long b = b0 + s;
    if (b >= B) continue;
    const T* st = tile + s * L::kStride;
    T out;
    if (finish) {
      out = st[kOut + side * N * N + e];
    } else {
      const int sl = tb.df_slot[e];
      out = sl >= 0 ? st[kK5Region + side * DF + sl] : T(0);
    }
    (side == 0 ? dq : dqd)[e * B + b] = out;
  }
}

// K5 for the S states b0 … b0 + S − 1 (those < B), thread tid of NT: out =
// ∂c (Minv null) or −M⁻¹·∂c over each column's nonzero rows, ascending;
// sides: bit 0 ∂c/∂q, bit 1 ∂c/∂q̇. Stage inputs are of T, or of bf16
// where s16.
template <typename T, int S, int NT>
__device__ __forceinline__ void grad_cols_tile(
    int tid, const Robot<T>& R, const K5Tables& tb, T* tile,
    const T* __restrict__ q, const T* __restrict__ qd, const void* v_in,
    const void* a_in, const void* f_in, const void* Minv, bool s16,
    T* __restrict__ dq, T* __restrict__ dqd, long long B, long long b0,
    int sides, T minus_g) {
  using L = K5Layout;
  constexpr int st_ = L::kStride;
  load_sincos<T, S, NT>(tid, tb.prism, q, B, b0, tile, st_, kSc);
  copy_batched<T, NT, 19 * N * S>(
      tid,
      [&](int idx) {
        const int e = idx / S, which = e / (6 * N), rem = e % (6 * N);
        const long long b = b0 + idx % S;
        if (b >= B) return T(0);
        if (which == 3) return qd[rem * B + b];
        const void* x = which == 0 ? v_in : which == 1 ? a_in : f_in;
        return load_stage<T>(x, s16, rem * B + b);
      },
      [&](int idx, T val) {
        const int s = idx % S, e = idx / S;
        const int which = e / (6 * N), rem = e % (6 * N);
        tile[s * st_ + (which == 3 ? L::kQd + rem
                                   : kV + which * 6 * N + 6 * (rem % N) +
                                         rem / N)] = val;
      });
  __syncthreads();
  for (int idx = tid; idx < S * 32; idx += NT) {
    const int s = idx / 32;
    build_X<T, 32>(idx % 32, R, tb.prism, tile + s * st_, kSc, -1);
  }
  __syncthreads();
  k5_sweeps<T, S, NT, L, false>(tid, R, tb, tile, sides, minus_g);
  // M⁻¹ into region A, its loads issued before the rows and stored after
  // them, so their latency overlaps them
  constexpr int kM = (N * N * S + NT - 1) / NT;
  T mval[kM <= 8 ? kM : 1];
  if (kM <= 8 && Minv != nullptr) {
#pragma unroll
    for (int u = 0; u < (kM <= 8 ? kM : 1); ++u) {
      const int idx = tid + u * NT;
      const long long b = b0 + idx % S;
      if (idx < N * N * S)
        mval[u] = b < B ? load_stage<T>(Minv, s16, (idx / S) * B + b) : T(0);
    }
  }
  k5_rows<T, S, NT, L>(tid, R, tb, tile, sides);
  if (Minv != nullptr) {
    if (kM <= 8) {
#pragma unroll
      for (int u = 0; u < (kM <= 8 ? kM : 1); ++u) {
        const int idx = tid + u * NT;
        if (idx < N * N * S) tile[(idx % S) * st_ + L::kM + idx / S] = mval[u];
      }
    } else {
      copy_batched<T, NT, N * N * S>(
          tid,
          [&](int idx) {
            const long long b = b0 + idx % S;
            return b < B ? load_stage<T>(Minv, s16, (idx / S) * B + b)
                         : T(0);
          },
          [&](int idx, T val) {
            tile[(idx % S) * st_ + L::kM + idx / S] = val;
          });
    }
  }
  __syncthreads();
  if (Minv != nullptr) k5_finish<T, S, NT, L>(tid, tb, tile, sides);
  k5_store<T, S, NT, L>(tid, tb, tile, Minv != nullptr, dq, dqd, B, b0,
                        sides);
}

// lane 0's value in every lane of the warp (one lane on the host)
template <typename T>
__device__ __forceinline__ T shfl0(T x) {
#ifdef __CUDA_ARCH__
  return __shfl_sync(0xffffffffu, x, 0);
#else
  return x;
#endif
}

// ------------------------------------------------------------------ K2′
// One state's slice: X (18n), its first n values the factor's diagonal
// once M is built; IC (36n), then L⁻¹ (n²); M (n²) — first sin/cos of q
// and IC_c·X_c of one wave's children, then L (below the diagonal), then
// M⁻¹.
constexpr int kIC = kXs * N;
constexpr int kK2M = kIC + kK2IC;

// One warp a state, lane of L (32 on the card): the CTA loads q and
// builds sin/cos for its S states, then each warp runs CRBA, the factor,
// L⁻¹ and M⁻¹ of its state with warp barriers only, then the CTA stores
// M⁻¹ and q̈ = M⁻¹·rhs (kRhs) with consecutive threads on consecutive
// states.
template <typename T, bool kRhs, int S, int L>
__device__ __forceinline__ void minv_dense_tile(
    int tid, const Robot<T>& R, const K2Tables& tb, T* tile,
    const T* __restrict__ q, const T* __restrict__ rhs, T* __restrict__ M_out,
    T* __restrict__ qdd_out, long long B, long long b0) {
  constexpr int NT = S * L;
  constexpr int st_ = kK2Stride;
  load_sincos<T, S, NT>(tid, tb.prism, q, B, b0, tile, st_, kK2M);
  __syncthreads();
  const int lane = tid % L;
  T* st = tile + (tid / L) * st_;
  T* A = st + kK2M;
  T* diag = st;
  build_X<T, L>(lane, R, tb.prism, st, kK2M, kIC);
  __syncwarp();
  // CRBA: IC_p += X_cᵀ·(IC_c·X_c), wave by wave from the deepest joints
  for (int w = 0; w < kK2Waves; ++w) {
    const int c0 = tb.cw[w], nc = tb.cw[w + 1] - c0;
    for (int idx = lane; idx < 36 * nc; idx += L) {
      const int rk = idx % 36, j = idx / 36;
      const int c = tb.c[c0 + j], r = rk / 6, k = rk % 6;
      const T* IC = st + kIC + 36 * c + r * 6;
      const T* X = st + kXs * c;
      // (IC·X)[r][k]: column k of X is (E; B)[:, k] for k < 3, (0; E)[:, k − 3]
      T acc;
      if (k < 3) {
        acc = IC[0] * X[k];
        acc += IC[1] * X[3 + k];
        acc += IC[2] * X[6 + k];
        acc += IC[3] * X[9 + k];
        acc += IC[4] * X[12 + k];
        acc += IC[5] * X[15 + k];
      } else {
        acc = IC[3] * X[k - 3];
        acc += IC[4] * X[k];
        acc += IC[5] * X[k + 3];
      }
      A[36 * j + rk] = acc;
    }
    __syncwarp();
    const int p0 = tb.pw[w], np = tb.pw[w + 1] - p0;
    for (int idx = lane; idx < 36 * np; idx += L) {
      const int rk = idx % 36, p = tb.p[p0 + idx / 36];
      const int r = rk / 6, k = rk % 6;
      T acc = st[kIC + 36 * p + rk];
      for (int j = tb.ch_start[p]; j < tb.ch_start[p + 1]; ++j) {
        const int c = tb.ch_list[j];
        const T* X = st + kXs * c;
        const T* ICX = A + 36 * tb.pos[c] + k;
        // (Xᵀ·ICX)[r][k]: row r of Xᵀ is (E; B)[:, r]ᵀ for r < 3, else
        // (0; E)[:, r − 3]ᵀ
        T t;
        if (r < 3) {
          t = X[r] * ICX[0];
          t += X[3 + r] * ICX[6];
          t += X[6 + r] * ICX[12];
          t += X[9 + r] * ICX[18];
          t += X[12 + r] * ICX[24];
          t += X[15 + r] * ICX[30];
        } else {
          t = X[r - 3] * ICX[18];
          t += X[r] * ICX[24];
          t += X[r + 3] * ICX[30];
        }
        acc = acc + t;
      }
      st[kIC + 36 * p + rk] = acc;
    }
    __syncwarp();
  }
  // M's lower triangle, row by row: the diagonal, then up the root path
  // (F ← X_jᵀ·F, M[i][parent] = S_parentᵀ·F); zero off the root path
  for (int i = lane; i < N; i += L) {
    T* Ai = A + i * N;
    for (int j = 0; j < i; ++j) Ai[j] = T(0);
    const T* IC = st + kIC + 36 * i;
    const T* Si = R.S + 6 * i;
    T F[6];
#pragma unroll
    for (int r = 0; r < 6; ++r) {
      T acc = IC[r * 6] * Si[0];
#pragma unroll
      for (int c = 1; c < 6; ++c) acc += IC[r * 6 + c] * Si[c];
      F[r] = acc;
    }
    T d = Si[0] * F[0];
#pragma unroll
    for (int c = 1; c < 6; ++c) d += Si[c] * F[c];
    Ai[i] = d + R.armature[i];
    for (int j = i; tb.par[j] >= 0;) {
      T t[6];
      xt_mul(st + kXs * j, F, t);
#pragma unroll
      for (int r = 0; r < 6; ++r) F[r] = t[r];
      j = tb.par[j];
      const T* Sj = R.S + 6 * j;
      T val = Sj[0] * F[0];
#pragma unroll
      for (int c = 1; c < 6; ++c) val += Sj[c] * F[c];
      Ai[j] = val;
    }
  }
  __syncwarp();
  // the left-looking column Cholesky (chol_factor), lanes over rows i ≥ j;
  // the pivot c_j (lane 0's row) reaches the other lanes by a shuffle, so
  // M[j][j] stays unwritten and L's diagonal goes to diag
  for (int j = 0; j < N; ++j) {
    const T* Aj = A + j * N;
    T cj = T(0);
    for (int i0 = j; i0 < N; i0 += L) {
      const int i = i0 + lane;
      T c = T(0);
      if (i < N) {
        const T* Ai = A + i * N;
        c = Ai[j];
        for (int p = 0; p < j; ++p) c = c - Ai[p] * Aj[p];
      }
      if (i0 == j) cj = shfl0(c);
      if (i == j) {
        diag[j] = c / sqrt(cj);
      } else if (i < N) {
        A[i * N + j] = c / sqrt(cj);
      }
    }
    __syncwarp();
  }
  // L⁻¹ (chol_inverse's sums, per entry in its order), one lane a column
  T* Y = st + kIC;
  for (int k = lane; k < N; k += L) {
    for (int r = k; r < N; ++r) {
      T acc = r == k ? T(1) : T(0);
      for (int p = k; p < r; ++p) acc = acc - A[r * N + p] * Y[p * N + k];
      Y[r * N + k] = acc / diag[r];
    }
  }
  __syncwarp();
  // M⁻¹[i][j] = M⁻¹[j][i] = Σ_{p ≥ j} Y[p][i]·Y[p][j] (i ≤ j), lanes over
  // the upper triangle, row by row
  for (int t = lane; t < N * (N + 1) / 2; t += L) {
    int i = 0, rest = t;
    while (rest >= N - i) rest -= N - i++;
    const int j = i + rest;
    T acc = Y[j * N + i] * Y[j * N + j];
    for (int p = j + 1; p < N; ++p) acc += Y[p * N + i] * Y[p * N + j];
    A[i * N + j] = acc;
    A[j * N + i] = acc;
  }
  __syncthreads();
  for (int idx = tid; idx < N * N * S; idx += NT) {
    const int s = idx % S, e = idx / S;
    const long long b = b0 + s;
    if (b < B) M_out[e * B + b] = tile[s * st_ + kK2M + e];
  }
  if (kRhs) {
    for (int idx = tid; idx < N * S; idx += NT) {
      const int s = idx % S, i = idx / S;
      const long long b = b0 + s;
      if (b >= B) continue;
      const T* Mi = tile + s * st_ + kK2M + i * N;
      T acc = Mi[0] * rhs[b];
      for (int j = 1; j < N; ++j) acc += Mi[j] * rhs[j * B + b];
      qdd_out[i * B + b] = acc;
    }
  }
}

// ------------------------------------------------------ the RNEA sweeps
// K1 (bias_and_v_staged), K4 (fd_grad_staged's body_af, with bf16 v where
// s16) and ∂ID's vaf (id_grad_staged's body_vaf) as one CTA tile of S
// states, and the ∇FD tile's two sweeps. A state's values: X (18n), v, a,
// f (6n each) at kV, kA, kF as in K5's region A, then q̇ and q̈ where the
// layout L puts them. One item is a joint of a state: its 6 components in
// registers, the parent's from shared memory. Items run state-fastest, so
// a warp's lanes read one joint's robot constants (a broadcast) and, the
// stride being odd, different banks of the tile.

// one forward item (rnea_fwd_bl's body for joint i): v_i = X_i·v_p + S_i·q̇_i
// (kept where kVKnown), a_i = X_i·a_p (X_i·a_g at a root) + v_i × S_i·q̇_i
// (+ S_i·q̈_i with kQdd)
template <typename T, bool kQdd, bool kVKnown>
__device__ __forceinline__ void rnea_fwd_item(const Robot<T>& R, T* st,
                                              int i, int p, T qdi, T qddi,
                                              T minus_g) {
  const T* X = st + kXs * i;
  const T* S = R.S + 6 * i;
  T Sqd[6], vi[6], ai[6], t[6];
#pragma unroll
  for (int r = 0; r < 6; ++r) Sqd[r] = S[r] * qdi;
  if (kVKnown) {
#pragma unroll
    for (int r = 0; r < 6; ++r) vi[r] = st[kV + 6 * i + r];
  } else {
    if (p < 0) {
#pragma unroll
      for (int r = 0; r < 6; ++r) vi[r] = Sqd[r];
    } else {
      x_mul(X, st + kV + 6 * p, t);
#pragma unroll
      for (int r = 0; r < 6; ++r) vi[r] = t[r] + Sqd[r];
    }
#pragma unroll
    for (int r = 0; r < 6; ++r) st[kV + 6 * i + r] = vi[r];
  }
  if (p < 0) {
    // X·a_base, a_base = [0, …, 0, −gravity]: X's last column, (0; E[:, 2])
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      ai[r] = T(0) * minus_g;
      ai[3 + r] = X[3 * r + 2] * minus_g;
    }
  } else {
    x_mul(X, st + kA + 6 * p, ai);
  }
  crm_apply(vi, Sqd, t);
#pragma unroll
  for (int r = 0; r < 6; ++r) ai[r] += t[r];
  if (kQdd) {
#pragma unroll
    for (int r = 0; r < 6; ++r) ai[r] += S[r] * qddi;
  }
#pragma unroll
  for (int r = 0; r < 6; ++r) st[kA + 6 * i + r] = ai[r];
}

// f_i = I_i·a_i + v_i ×* (I_i·v_i) of every joint of S states, no barrier
template <typename T, int S, int NT, typename L>
__device__ __forceinline__ void rnea_force_items(int tid, const Robot<T>& R,
                                                 T* tile) {
  for (int idx = tid; idx < N * S; idx += NT) {
    const int i = idx / S;
    T* st = tile + (idx % S) * L::kStride;
    const T* I = R.I + 36 * i;
    const T* v = st + kV + 6 * i;
    T Iv[6], Ia[6], t[6];
    matvec6(I, v, Iv);
    matvec6(I, st + kA + 6 * i, Ia);
    crf_apply(v, Iv, t);
#pragma unroll
    for (int r = 0; r < 6; ++r) st[kF + 6 * i + r] = Ia[r] + t[r];
  }
}

// rnea_fwd_bl's waves for S states: v (unless kVKnown) and a wave by wave
// from the roots, a barrier a wave
template <typename T, int S, int NT, typename L, bool kQdd, bool kVKnown>
__device__ __forceinline__ void rnea_fwd_waves(int tid, const Robot<T>& R,
                                               const RnTables& tb, T* tile,
                                               T minus_g) {
  for (int w = 0; w < kRnWaves; ++w) {
    const int w0 = tb.fw_waves[w], nw = tb.fw_waves[w + 1] - w0;
    for (int idx = tid; idx < nw * S; idx += NT) {
      const int i = tb.fw[w0 + idx / S];
      T* st = tile + (idx % S) * L::kStride;
      T qddi = T(0);
      if constexpr (kQdd) qddi = st[L::kQdd + i];
      rnea_fwd_item<T, kQdd, kVKnown>(R, st, i, tb.par[i], st[L::kQd + i],
                                      qddi, minus_g);
    }
    __syncthreads();
  }
}

// rnea_fwd_bl for S states: the waves, then f of every joint at once
template <typename T, int S, int NT, typename L, bool kQdd, bool kVKnown>
__device__ __forceinline__ void rnea_fwd_tile(int tid, const Robot<T>& R,
                                              const RnTables& tb, T* tile,
                                              T minus_g) {
  rnea_fwd_waves<T, S, NT, L, kQdd, kVKnown>(tid, R, tb, tile, minus_g);
  rnea_force_items<T, S, NT, L>(tid, R, tile);
  __syncthreads();
}

// wave w of rnea_bwd_bl's sweep for S states: f_p += X_cᵀ·f_c for the
// parents of that wave (from the deepest), each gathering its children in
// descending order; no barrier
template <typename T, int S, int NT, typename L>
__device__ __forceinline__ void rnea_bwd_wave(int tid, const RnTables& tb,
                                              T* tile, int w) {
  const int w0 = tb.bw_waves[w], nw = tb.bw_waves[w + 1] - w0;
  for (int idx = tid; idx < nw * S; idx += NT) {
    const int p = tb.bw[w0 + idx / S];
    T* st = tile + (idx % S) * L::kStride;
    T acc[6], t[6];
#pragma unroll
    for (int r = 0; r < 6; ++r) acc[r] = st[kF + 6 * p + r];
    for (int j = tb.ch_start[p]; j < tb.ch_start[p + 1]; ++j) {
      const int c = tb.ch_list[j];
      xt_mul(st + kXs * c, st + kF + 6 * c, t);
#pragma unroll
      for (int r = 0; r < 6; ++r) acc[r] = acc[r] + t[r];
    }
#pragma unroll
    for (int r = 0; r < 6; ++r) st[kF + 6 * p + r] = acc[r];
  }
}

// rnea_bwd_bl's sweep for S states, a barrier a wave
template <typename T, int S, int NT, typename L>
__device__ __forceinline__ void rnea_bwd_tile(int tid, const RnTables& tb,
                                              T* tile) {
  for (int w = 0; w + 1 < kRnWaves; ++w) {
    rnea_bwd_wave<T, S, NT, L>(tid, tb, tile, w);
    __syncthreads();
  }
}

// c_i = S_iᵀ·f_i + damping_i·q̇_i (rnea_bwd_bl's torques, no q̈ term)
template <typename T>
__device__ __forceinline__ T bias_torque(const Robot<T>& R, const T* st,
                                         int i, T qdi) {
  const T* S = R.S + 6 * i;
  const T* f = st + kF + 6 * i;
  T acc = S[0] * f[0];
#pragma unroll
  for (int r = 1; r < 6; ++r) acc += S[r] * f[r];
  return acc + R.damping[i] * qdi;
}

// the sweep tile's layout: q̇, q̈ after f; sin/cos of q in f's rows until
// X is built
struct VafLayout {
  static constexpr int kStride = kVafStride;
  static constexpr int kQd = 36 * N, kQdd = 37 * N;
};

// K1 (kBiasV: c, v), K4 (kAF: a, f at q̈, v read — as bf16 where s16) and
// ∂ID's vaf (kVAF: v, a, f) for the S states b0 … b0 + S − 1 (those < B),
// thread tid of NT; the stage tensors are (6, n, B), loaded and stored
// with consecutive threads on consecutive states
template <typename T, int kMode, int S, int NT>
__device__ __forceinline__ void vaf_tile(
    int tid, const Robot<T>& R, const RnTables& tb, T* tile,
    const T* __restrict__ q, const T* __restrict__ qd,
    const T* __restrict__ qdd, const void* v_in, bool s16,
    T* __restrict__ c_out, T* __restrict__ v_out, T* __restrict__ a_out,
    T* __restrict__ f_out, long long B, long long b0, T minus_g) {
  using L = VafLayout;
  constexpr int st_ = L::kStride;
  // q̇, then q̈ (kAF, kVAF), then v (kAF)
  constexpr int kRows = (kMode == kBiasV ? 1 : 2) + (kMode == kAF ? 6 : 0);
  load_sincos<T, S, NT>(tid, tb.prism, q, B, b0, tile, st_, kF);
  copy_batched<T, NT, kRows * N * S, 32>(
      tid,
      [&](int idx) {
        const int e = idx / S;
        const long long b = b0 + idx % S;
        if (b >= B) return T(0);
        if (e < N) return qd[e * B + b];
        if (e < 2 * N) return qdd[(e - N) * B + b];
        return load_stage<T>(v_in, s16, (e - 2 * N) * B + b);
      },
      [&](int idx, T val) {
        const int e = idx / S;
        T* st = tile + (idx % S) * st_;
        if (e < 2 * N) {
          st[L::kQd + e] = val;  // q̈ follows q̇
        } else {
          const int rem = e - 2 * N;  // element (r, i) of v: r·n + i
          st[kV + 6 * (rem % N) + rem / N] = val;
        }
      });
  __syncthreads();
  build_X_states<T, S, NT>(tid, R, tb.prism, tile, st_, kF);
  __syncthreads();
  rnea_fwd_tile<T, S, NT, L, kMode != kBiasV, kMode == kAF>(tid, R, tb, tile,
                                                            minus_g);
  rnea_bwd_tile<T, S, NT, L>(tid, tb, tile);
  if (kMode == kBiasV) {
    for (int idx = tid; idx < N * S; idx += NT) {
      const int s = idx % S, i = idx / S;
      const long long b = b0 + s;
      const T* st = tile + s * st_;
      if (b < B) c_out[i * B + b] = bias_torque(R, st, i, st[L::kQd + i]);
    }
  }
  // the outputs: v (kBiasV, kVAF), a and f (kAF, kVAF)
  constexpr int first = kMode == kAF ? 1 : 0;
  constexpr int last = kMode == kBiasV ? 1 : 3;
  for (int idx = tid; idx < (last - first) * 6 * N * S; idx += NT) {
    const int s = idx % S, e = idx / S;
    const long long b = b0 + s;
    if (b >= B) continue;
    const int which = first + e / (6 * N), rem = e % (6 * N);
    T* out = which == 0 ? v_out : which == 1 ? a_out : f_out;
    out[rem * B + b] =
        tile[s * st_ + kV + 6 * N * which + 6 * (rem % N) + rem / N];
  }
}

// ------------------------------------------------ the recursion ∇FD tile
// fd_grad_fused (gridcodegenerator_tpu/ops/kernels/fused.py:394; body
// blops.fd_grad_bl) for robots of at most MAX_KERNEL_JOINTS joints, S
// states a CTA, each state's working set in shared memory for the whole
// body: X; the bias RNEA (c, v); the articulated M⁻¹ recursion (minv_bl,
// densified); q̈ = M⁻¹(u − c); the second sweep at q̈ with v reused; ∂ID of
// both sides on K5's packed columns and waves (∂f in
// rnea_grad_inner_bl's order); −M⁻¹·∂c by column. The slice: K5's region
// A and region B (the M⁻¹ recursion's scratch first), then M⁻¹ (n²), q̇,
// u and q̈ (n each) and the q side's ∂a seeds (6n).
constexpr int kFdM = kK5Region + kFdB;
constexpr int kFdQd = kFdM + N * N;
constexpr int kFdU = kFdQd + N;
constexpr int kFdQdd = kFdU + N;
struct FdLayout {
  static constexpr int kStride = kFdStride;
  static constexpr int kQd = kFdQd, kQdd = kFdQdd, kM = kFdM;
  // the q side's ∂a seeds: f is summed while K5's forward sweep runs
  static constexpr int kSeedA = kFdQdd + N;
};
static_assert(FdLayout::kSeedA + 6 * N <= kFdStride, "the ∇FD slice");
// the M⁻¹ recursion's scratch in region B: IA (36n), F (6 rows of n
// columns a joint: F_i[r][j] at kMiF + (6i + r)·n + j), U, D⁻¹, Ia·X (36n,
// row-major), Xᵀ·U. A leaf's IA is its inertia and its F zero until its
// own step: neither is kept for it.
constexpr int kMiIA = kK5Region, kMiF = kMiIA + 36 * N,
              kMiU = kMiF + 6 * N * N, kMiD = kMiU + 6 * N,
              kMiIaX = kMiD + N, kMiUX = kMiIaX + 36 * N;
static_assert(kMiUX + 6 * N <= kFdM, "region B holds the M⁻¹ scratch");

// minv_bl for S states of layout L (X in the tile): the rows of M⁻¹
// (upper triangle; row-major at L::kM). Backward from the deepest joints,
// one wave at a time: with U_j = IA_j·S_j and D_j, row j of M⁻¹
// (e_j·D⁻¹ − D⁻¹·S_jᵀF_j) and F_j += U_j·row, (IA_j − U_j·D⁻¹·U_jᵀ)·X_j and
// X_jᵀ·U_j; then each parent adds X_cᵀ·F_c and X_cᵀ·(Ia·X)_c of its
// children in descending order — and, with kBiasBwd, gathers their
// wrenches as rnea_bwd_tile does (the bias sweep's backward, in the same
// waves). Forward from the roots: the columns j ≥ i of row i
// (− D⁻¹·(X_iᵀU_i)·F_p) and of F_i.
template <typename T, int S, int NT, typename L, bool kBiasBwd>
__device__ __forceinline__ void minv_tile(int tid, const Robot<T>& R,
                                          const RnTables& tb, T* tile) {
  constexpr int st_ = L::kStride;
  constexpr int kW = N + 6;  // a joint's items: n columns, 6 rows of Ia·X
  for (int w = kRnWaves - 1; w >= 0; --w) {
    const int w0 = tb.fw_waves[w], nw = tb.fw_waves[w + 1] - w0;
    for (int idx = tid; idx < nw * kW * S; idx += NT) {
      const int rest = idx / S, e = rest % kW, j = tb.fw[w0 + rest / kW];
      T* st = tile + (idx % S) * st_;
      const int p = tb.par[j];
      const bool leaf = tb.ch_start[j + 1] == tb.ch_start[j];
      // U_j = IA_j·S_j and D_j⁻¹, formed alike by every item of joint j
      // (the first one keeps them, and X_jᵀ·U_j, for the forward sweep)
      const T* IA_j = leaf ? R.I + 36 * j : st + kMiIA + 36 * j;
      const T* Sj = R.S + 6 * j;
      T U[6];
#pragma unroll
      for (int r = 0; r < 6; ++r) {
        T acc = IA_j[r * 6] * Sj[0];
#pragma unroll
        for (int c = 1; c < 6; ++c) acc += IA_j[r * 6 + c] * Sj[c];
        U[r] = acc;
      }
      T d = Sj[0] * U[0];
#pragma unroll
      for (int c = 1; c < 6; ++c) d += Sj[c] * U[c];
      const T Di = T(1) / (d + R.armature[j]);
      if (e == 0) {
#pragma unroll
        for (int r = 0; r < 6; ++r) st[kMiU + 6 * j + r] = U[r];
        st[kMiD + j] = Di;
        if (p >= 0) xt_mul(st + kXs * j, U, st + kMiUX + 6 * j);
      }
      if (e < N) {
        // row = e_j·D⁻¹ − D⁻¹·SᵀF; then F_j += U·row (a joint with a
        // parent); a leaf's F is zero
        T* F = st + kMiF + 6 * N * j + e;
        T sf = T(0);
        if (!leaf) {
          sf = Sj[0] * F[0];
#pragma unroll
          for (int c = 1; c < 6; ++c) sf += Sj[c] * F[c * N];
        }
        const T row = (e == j ? Di : T(0)) - Di * sf;
        st[L::kM + j * N + e] = row;
        if (p >= 0) {
#pragma unroll
          for (int r = 0; r < 6; ++r)
            F[r * N] = leaf ? U[r] * row : F[r * N] + U[r] * row;
        }
      } else if (p >= 0) {
        // row r of (IA_j − U·D⁻¹·Uᵀ)·X_j: column k of X is (E; B)[:, k]
        // for k < 3, (0; E)[:, k − 3]
        const int r = e - N;
        const T* IA = IA_j + 6 * r;
        const T* X = st + kXs * j;
        T ia[6];
#pragma unroll
        for (int c = 0; c < 6; ++c) ia[c] = IA[c] - U[r] * (Di * U[c]);
        T* out = st + kMiIaX + 36 * j + 6 * r;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          T acc = ia[0] * X[k];
          acc += ia[1] * X[3 + k];
          acc += ia[2] * X[6 + k];
          acc += ia[3] * X[9 + k];
          acc += ia[4] * X[12 + k];
          acc += ia[5] * X[15 + k];
          out[k] = acc;
          T acc2 = ia[3] * X[k];
          acc2 += ia[4] * X[3 + k];
          acc2 += ia[5] * X[6 + k];
          out[3 + k] = acc2;
        }
      }
    }
    __syncthreads();
    if (w == 0) break;
    // the parents at depth w − 1: the backward table's wave from the top.
    // Item e < n: column e of F_p; n ≤ e < n + 6: column e − n of IA_p (its
    // inertia plus the children's terms); e = n + 6: the bias sweep's f_p
    const int pw = kRnWaves - 1 - w;
    const int p0 = tb.bw_waves[pw], np = tb.bw_waves[pw + 1] - p0;
    constexpr int kWb = kW + (kBiasBwd ? 1 : 0);
    for (int idx = tid; idx < np * kWb * S; idx += NT) {
      const int rest = idx / S, e = rest % kWb, p = tb.bw[p0 + rest / kWb];
      T* st = tile + (idx % S) * st_;
      T* dst = e < N ? st + kMiF + 6 * N * p + e
               : e < kW ? st + kMiIA + 36 * p + (e - N)
                        : st + kF + 6 * p;
      const int ld = e < N ? N : e < kW ? 6 : 1;
      T acc[6], col[6], t[6];
      const int c0 = tb.ch_start[p], c1 = tb.ch_start[p + 1];
#pragma unroll
      for (int r = 0; r < 6; ++r)
        acc[r] = e < N ? T(0)
                 : e < kW ? R.I[36 * p + 6 * r + (e - N)] : dst[r];
      for (int jc = c0; jc < c1; ++jc) {
        const int c = tb.ch_list[jc];
        const T* src = e < N ? st + kMiF + 6 * N * c + e
                       : e < kW ? st + kMiIaX + 36 * c + (e - N)
                                : st + kF + 6 * c;
#pragma unroll
        for (int r = 0; r < 6; ++r) col[r] = src[r * ld];
        xt_mul(st + kXs * c, col, t);
        // F_p starts from zero: its first child's term is exact
#pragma unroll
        for (int r = 0; r < 6; ++r)
          acc[r] = e < N && jc == c0 ? t[r] : acc[r] + t[r];
      }
#pragma unroll
      for (int r = 0; r < 6; ++r) dst[r * ld] = acc[r];
    }
    __syncthreads();
  }
  for (int w = 0; w < kRnWaves; ++w) {
    const int w0 = tb.fw_waves[w], nw = tb.fw_waves[w + 1] - w0;
    for (int idx = tid; idx < nw * N * S; idx += NT) {
      const int rest = idx / S, j = rest % N, i = tb.fw[w0 + rest / N];
      if (j < i) continue;
      T* st = tile + (idx % S) * st_;
      const int p = tb.par[i];
      T row = st[L::kM + i * N + j];
      T Fp[6];
      if (p >= 0) {
        const T* UX = st + kMiUX + 6 * i;
#pragma unroll
        for (int c = 0; c < 6; ++c) Fp[c] = st[kMiF + (6 * p + c) * N + j];
        T corr = UX[0] * Fp[0];
#pragma unroll
        for (int c = 1; c < 6; ++c) corr += UX[c] * Fp[c];
        row = row - st[kMiD + i] * corr;
        st[L::kM + i * N + j] = row;
      }
      const T* Si = R.S + 6 * i;
      T* F = st + kMiF + 6 * N * i + j;
      if (p >= 0) {
        T XF[6];
        x_mul(st + kXs * i, Fp, XF);
#pragma unroll
        for (int r = 0; r < 6; ++r) F[r * N] = Si[r] * row + XF[r];
      } else {
#pragma unroll
        for (int r = 0; r < 6; ++r) F[r * N] = Si[r] * row;
      }
    }
    __syncthreads();
  }
}

// the ∇FD tile for the S states b0 … b0 + S − 1 (those < B), thread tid of
// NT: ∂q̈/∂q and ∂q̈/∂q̇ (n, n, B) each
template <typename T, int S, int NT>
__device__ __forceinline__ void fd_grad_tile(
    int tid, const Robot<T>& R, const K5Tables& t5, const RnTables& tr,
    T* tile, const T* __restrict__ q, const T* __restrict__ qd,
    const T* __restrict__ u, T* __restrict__ dq, T* __restrict__ dqd,
    long long B, long long b0, T minus_g) {
  using L = FdLayout;
  constexpr int st_ = L::kStride;
  load_sincos<T, S, NT>(tid, tr.prism, q, B, b0, tile, st_, kSc);
  copy_batched<T, NT, 2 * N * S, 16>(
      tid,
      [&](int idx) {
        const int e = idx / S;
        const long long b = b0 + idx % S;
        if (b >= B) return T(0);
        return e < N ? qd[e * B + b] : u[(e - N) * B + b];
      },
      [&](int idx, T val) {
        tile[(idx % S) * st_ + L::kQd + idx / S] = val;  // u follows q̇
      });
  __syncthreads();
  build_X_states<T, S, NT>(tid, R, tr.prism, tile, st_, kSc);
  __syncthreads();
  // the bias RNEA: v, a, f at q̈ = 0; its backward sweep runs in the M⁻¹
  // recursion's backward waves, c = S·f + damping·q̇ in q̈'s phase
  rnea_fwd_tile<T, S, NT, L, false, false>(tid, R, tr, tile, minus_g);
  minv_tile<T, S, NT, L, true>(tid, R, tr, tile);
  // q̈ = M⁻¹·(u − c) (densify_rows then matvecN), each item forming u − c
  // itself and reading M⁻¹ from its upper triangle; beside it, the lower
  // triangle from the upper
  for (int idx = tid; idx < N * S; idx += NT) {
    const int r = idx / S;
    T* st = tile + (idx % S) * st_;
    const T* M = st + L::kM;
    const T* qdv = st + L::kQd;
    T acc = M[r] * (st[kFdU] - bias_torque(R, st, 0, qdv[0]));
    for (int c = 1; c < N; ++c)
      acc += M[c < r ? c * N + r : r * N + c] *
             (st[kFdU + c] - bias_torque(R, st, c, qdv[c]));
    st[kFdQdd + r] = acc;
  }
  for (int idx = tid; idx < N * N * S; idx += NT) {
    const int e = idx / S, i = e / N, j = e % N;
    T* M = tile + (idx % S) * st_ + L::kM;
    if (j < i) M[e] = M[j * N + i];
  }
  __syncthreads();
  // the second sweep at q̈, v reused; beside its f, K5's forward seeds and
  // I·v (they read v and a only)
  rnea_fwd_waves<T, S, NT, L, true, true>(tid, R, tr, tile, minus_g);
  rnea_force_items<T, S, NT, L>(tid, R, tile);
  for (int idx = tid; idx < N * S; idx += NT)
    k5_prologue<T, L, false>(R, t5, tile + (idx % S) * st_, idx / S,
                             minus_g);
  __syncthreads();
  // K5's forward waves (∂v, ∂a) beside the second sweep's backward (f
  // summed to the root): neither reads what the other writes
  for (int w = 0; w < kK5Waves; ++w) {
    k5_fwd_wave<T, S, NT, L>(tid, R, t5, tile, 3, w);
    if (w + 1 < kRnWaves) rnea_bwd_wave<T, S, NT, L>(tid, tr, tile, w);
    __syncthreads();
  }
  // the q side's backward seeds from the summed f, beside ∂f
  for (int idx = tid; idx < N * S; idx += NT)
    k5_sow<T>(R, t5, tile + (idx % S) * st_, idx / S);
  k5_force_items<T, S, NT, L, true>(tid, R, t5, tile, 3);
  __syncthreads();
  k5_bwd_waves<T, S, NT, L>(tid, t5, tile, 3);
  k5_rows<T, S, NT, L>(tid, R, t5, tile, 3);
  __syncthreads();
  k5_finish<T, S, NT, L>(tid, t5, tile, 3);
  k5_store<T, S, NT, L>(tid, t5, tile, true, dq, dqd, B, b0, 3);
}

}  // namespace grid
