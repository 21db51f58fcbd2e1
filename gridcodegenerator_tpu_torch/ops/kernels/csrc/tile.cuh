// The staged K5 and K2′ as CTA tiles: S states a CTA, each state's working
// set in shared memory.
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
// set the time, not the device memory (the bound is 4–8 % of it).
//
// The topology is compile-time data: ops/kernels/_build.py
// (grad_cols_tile_plan, minv_tile_plan) passes the item tables and the
// tile sizes as -D lists; the tables sit in __constant__ memory and each
// CTA copies them to shared memory, where its threads index them at run
// time. A state's values and the states a CTA (at most 227 KB with the
// constants and the tables) come from the same plan.
#pragma once

#include "staged.cuh"

#if !defined(GRID_K5_TABLE) || !defined(GRID_K2_TABLE)
#error "compile with -DGRID_K5_TABLE=… -DGRID_K2_TABLE=… (_build.py)"
#endif

namespace grid {

#define G(x) x,
__constant__ short c_k5_table[] = {GRID_K5_TABLE};
__constant__ short c_k2_table[] = {GRID_K2_TABLE};
// offsets into the tables, in _build.py's order
constexpr int kK5Offs[] = {GRID_K5_OFFS};
constexpr int kK2Offs[] = {GRID_K2_OFFS};
// K5: packed ∂v/∂a columns, packed ∂f columns, forward waves, region A,
// stride, states a CTA in f32 and in f64
constexpr int kK5Plan[] = {GRID_K5_PLAN};
// K2′: sweep waves, IC / L⁻¹ values, M values, stride, states f32 / f64
constexpr int kK2Plan[] = {GRID_K2_PLAN};
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

// load(idx) → store(idx, value) for idx in [0, kCount), thread tid of NT:
// eight loads in flight a thread before their stores, so a phase that
// reads device memory waits for its latency once a batch, not once a value
template <typename T, int NT, int kCount, typename Load, typename Store>
__device__ __forceinline__ void copy_batched(int tid, Load load, Store store) {
  constexpr int kBatch = 8;
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

// ------------------------------------------------------------------- K5
// One state's slice: region A — X (18n), v, a, f, I·v, X_iᵀ·(S_i ×* f_i)
// (6n each), M⁻¹ (n²) in the finish — then each side's ∂v, ∂a (6 rows of
// DVA packed columns) and ∂f (6 rows of DF). The rows of a packed tensor
// are DVA (or DF) apart, so consecutive items touch consecutive words.
// Side 1's ∂f rows hold q̇ and side 0's the q side's ∂v seeds until the
// forward sweep is done, side 0's ∂a rows sin/cos of q until X is built;
// the rows ∂c of both sides (2·DF) and then the outputs (2n²) reuse the
// space of the ∂-tensors.
constexpr int kV = 18 * N, kA = 24 * N, kF = 30 * N, kIv = 36 * N,
              kSow = 42 * N;
constexpr int kQd = kK5Region + kK5Side + 12 * DVA;
constexpr int kSc = kK5Region + 6 * DVA;
constexpr int kOut = kK5Region + 2 * DF;  // the finish's outputs, 2n²
constexpr int kSeedV = kK5Region + 12 * DVA;  // the q side's ∂v seeds, 6n

// one forward item: column k of joint i's ∂v and ∂a, one side
// (grad_cols_side's forward loop for one column); the q side's seeds of
// column i wait in kSeedV and f's rows (k5 prologue)
template <typename T>
__device__ __forceinline__ void k5_forward(const Robot<T>& R, T* st, T* dv,
                                           T* da, bool kq, int i, int k,
                                           int dst, int src) {
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
  const T qdi = st[kQd + i];
#pragma unroll
  for (int r = 0; r < 6; ++r) dac[r] = dac[r] - qdi * t[r];
  if (k == i) {
    T t2[6];
    if (kq) {
#pragma unroll
      for (int r = 0; r < 6; ++r) t2[r] = st[kF + 6 * i + r];
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

// ∂f_i = crf(∂v)·I·v + crf(v)·(I·∂v) + I·∂a for one packed column
template <typename T>
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
  for (int r = 0; r < 6; ++r) df[r * DF + dfd] = (A1[r] + A2[r]) + A3[r];
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
  constexpr int st_ = kK5Stride;
  const int nsides = sides == 3 ? 2 : 1;
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
        tile[s * st_ + (which == 3 ? kQd + rem
                                   : kV + which * 6 * N + 6 * (rem % N) +
                                         rem / N)] = val;
      });
  __syncthreads();
  for (int idx = tid; idx < S * 32; idx += NT) {
    const int s = idx / 32;
    build_X<T, 32>(idx % 32, R, tb.prism, tile + s * st_, kSc, -1);
  }
  __syncthreads();
  // per joint: I·v, the q side's backward seed X_iᵀ·(S_i ×* f_i), and its
  // forward seeds −S_i×(X_i·v_p) (∂v, into kSeedV) and −S_i×(X_i·a_p)
  // (∂a; −S_i×(X_i·a_g) at a root), the latter over f_i, which only this
  // item reads
  for (int idx = tid; idx < N * S; idx += NT) {
    const int i = idx % N, s = idx / N;
    T* st = tile + s * st_;
    const int p = tb.par[i];
    const T* X = st + kXs * i;
    const T* Si = R.S + 6 * i;
    matvec6(R.I + 36 * i, st + kV + 6 * i, st + kIv + 6 * i);
    T base[6], t[6];
    if (p >= 0) {
      crf_apply(Si, st + kF + 6 * i, t);
      xt_mul(X, t, st + kSow + 6 * i);
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
    for (int r = 0; r < 6; ++r) st[kF + 6 * i + r] = -t[r];
  }
  __syncthreads();
  // forward: ∂v, ∂a column by column, wave by wave from the roots
  for (int w = 0; w < kK5Waves; ++w) {
    const int w0 = tb.fw_waves[w], nw = tb.fw_waves[w + 1] - w0;
    for (int idx = tid; idx < nw * nsides * S; idx += NT) {
      const int e = idx % nw, rest = idx / nw;
      const int side = side_of(sides, rest % nsides);
      const short* it = tb.fw + 5 * (w0 + e);
      const int i = it[0];
      T* st = tile + (rest / nsides) * st_;
      T* dv = st + kK5Region + side * kK5Side;
      k5_forward<T>(R, st, dv, dv + 6 * DVA, side == 0, i, it[1], it[2],
                    it[3]);
    }
    __syncthreads();
  }
  // ∂f of every packed column from ∂v and ∂a, all at once
  for (int idx = tid; idx < DVA * nsides * S; idx += NT) {
    const int e = idx % DVA, rest = idx / DVA;
    const int side = side_of(sides, rest % nsides);
    const short* it = tb.fw + 5 * e;
    T* st = tile + (rest / nsides) * st_;
    T* dv = st + kK5Region + side * kK5Side;
    k5_force<T>(R, st, dv, dv + 6 * DVA, dv + 12 * DVA, it[0], it[2], it[4]);
  }
  __syncthreads();
  // backward: ∂f to the root, from the deepest parents
  for (int w = 0; w + 1 < kK5Waves; ++w) {
    const int w0 = tb.bw_waves[w], nw = tb.bw_waves[w + 1] - w0;
    for (int idx = tid; idx < nw * nsides * S; idx += NT) {
      const int e = idx % nw, rest = idx / nw;
      const int side = side_of(sides, rest % nsides);
      const short* it = tb.bw + 4 * (w0 + e);
      T* st = tile + (rest / nsides) * st_;
      k5_backward<T>(tb, st, st + kK5Region + side * kK5Side + 12 * DVA,
                     side == 0, it[0], it[1], it[2], it[3] != 0);
    }
    __syncthreads();
  }
  // the rows ∂c_i = S_iᵀ·∂f_i (+ damping_i at column i, q̇ side), both
  // sides into side 0's ∂v rows; M⁻¹ into region A, its loads issued
  // first and stored after the rows, so their latency overlaps them
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
  for (int idx = tid; idx < DF * nsides * S; idx += NT) {
    const int d = idx % DF, rest = idx / DF;
    const int side = side_of(sides, rest % nsides);
    T* st = tile + (rest / nsides) * st_;
    const T* df = st + kK5Region + side * kK5Side + 12 * DVA;
    const int i = tb.df_ik[2 * d], k = tb.df_ik[2 * d + 1];
    const T* Si = R.S + 6 * i;
    T acc = Si[0] * df[d];
#pragma unroll
    for (int r = 1; r < 6; ++r) acc += Si[r] * df[r * DF + d];
    if (side == 1 && k == i) acc = acc + R.damping[i];
    st[kK5Region + side * DF + d] = acc;
  }
  if (Minv != nullptr) {
    if (kM <= 8) {
#pragma unroll
      for (int u = 0; u < (kM <= 8 ? kM : 1); ++u) {
        const int idx = tid + u * NT;
        if (idx < N * N * S) tile[(idx % S) * st_ + idx / S] = mval[u];
      }
    } else {
      copy_batched<T, NT, N * N * S>(
          tid,
          [&](int idx) {
            const long long b = b0 + idx % S;
            return b < B ? load_stage<T>(Minv, s16, (idx / S) * B + b)
                         : T(0);
          },
          [&](int idx, T val) { tile[(idx % S) * st_ + idx / S] = val; });
    }
  }
  __syncthreads();
  // the finish: one thread a column c of a side and a state, and a block
  // of up to 8 output rows r summed side by side (each in ascending row
  // order): the column's rows of ∂c are read once a block; the results
  // wait in region B past the rows ∂c for the state-consecutive store
  constexpr int kR = N < 8 ? N : 8, kRB = (N + kR - 1) / kR;
  if (Minv != nullptr) {
    for (int idx = tid; idx < kRB * N * nsides * S; idx += NT) {
      const int s = idx % S, rest = idx / S;
      const int c = rest % N, rest2 = rest / N;
      const int side = side_of(sides, rest2 % nsides);
      const int r0 = kR * (rest2 / nsides);
      const T* st = tile + s * st_;
      const T* dc = st + kK5Region + side * DF;
      T* out = tile + s * st_ + kOut + side * N * N + c;
      const int j0 = tb.col_start[c], j1 = tb.col_start[c + 1];
      T acc[kR];
      {
        const T x = dc[tb.col_d[j0]];
        const T* Mi = st + r0 * N + tb.col_i[j0];
#pragma unroll
        for (int rr = 0; rr < kR; ++rr)
          if (r0 + rr < N) acc[rr] = Mi[rr * N] * x;
      }
      for (int j = j0 + 1; j < j1; ++j) {
        const T x = dc[tb.col_d[j]];
        const T* Mi = st + r0 * N + tb.col_i[j];
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
  for (int idx = tid; idx < N * N * nsides * S; idx += NT) {
    const int s = idx % S, rest = idx / S;
    const int e = rest % (N * N);
    const int side = side_of(sides, rest / (N * N));
    const long long b = b0 + s;
    if (b >= B) continue;
    const T* st = tile + s * st_;
    T out;
    if (Minv != nullptr) {
      out = st[kOut + side * N * N + e];
    } else {
      const int sl = tb.df_slot[e];
      out = sl >= 0 ? st[kK5Region + side * DF + sl] : T(0);
    }
    (side == 0 ? dq : dqd)[e * B + b] = out;
  }
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

}  // namespace grid
