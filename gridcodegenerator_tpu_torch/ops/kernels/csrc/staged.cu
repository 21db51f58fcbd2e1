// The staged large-robot pipeline's kernels: one thread per state, and K1,
// K4, ∂ID's vaf, K2′ and K5 as CTA tiles of states.
//
// Replaces (gridcodegenerator_tpu/ops/kernels/staged.py):
//   bias_and_v_staged, K1          (staged.py:172) -> grid_bias_v_{f32,f64}
//                                     (K1, K4 and vaf: the sweep tile,
//                                     tile.cuh; the one-thread kernel:
//                                     grid_{bias_v,af,vaf}_thread)
//   minv_qdd_dense_staged, K2′     (staged.py:218) -> grid_minv_dense_{f32,f64}
//                                     (a CTA tile, tile.cuh; the one-thread
//                                     kernel it replaced: grid_minv_dense_thread)
//   fd_grad_staged body_af, K4     (staged.py:453) -> grid_af_{f32,f64}
//   id_grad_staged body_vaf        (staged.py:341) -> grid_vaf_{f32,f64}
//   fd_grad_staged body_grad, K5 with the fused −M⁻¹·∂c finish
//                                  (staged.py:470) -> grid_grad_cols_{..}
//                                     (a CTA tile, tile.cuh; the one-thread
//                                     kernel it replaced: grid_grad_cols_thread)
//   id_grad_staged body_grad, K5   (staged.py:356)    with Minv == NULL
//   K4 and K5 reading bf16 stage tensors (stage_dtype, staged.py:319, :373)
//                                  -> grid_af_* / grid_grad_cols_* with s16
//   K5 one side a launch (merge_sides=False)  -> grid_grad_cols_*, sides
//   minv_staged body_ud, K2        (staged.py:201) -> grid_minv_ud_{f32,f64}
//   minv_staged body_cols, K3      (staged.py:207) -> grid_minv_cols_{..}
//   minv_qdd_af_dense_staged, K2″  (staged.py:257) -> grid_minv_af_{..}
//   fd_dense_staged                (staged.py:294) -> grid_fd_dense_{..}
// On the TPU a working set that outgrew VMEM was cut into several Pallas
// kernels with HBM-staged v, a, f, M⁻¹ between them, and the ∂ID into
// column blocks, one pallas_call each. Here the same cut bounds the
// per-thread local-memory frame: the single-thread ∇FD body holds ≈ 28·n²
// values a state, the K5 body 18·n·CB + O(n).
// All column blocks of K5 are one launch on a 2-D grid (⌈B/128⌉, ⌈n/cb⌉):
// blockIdx.y is the column block, c0 = blockIdx.y·cb is a runtime value and
// cb ≤ GRID_CB (the compile-time width of the ∂-tensor arrays). K3 does the
// same with its column blocks (cb ≤ GRID_MINV_CB): one launch where the
// TPU made ⌈n/cb⌉.
// The bf16 stage tensors are cast between launches (torch, round to
// nearest even from the compute type); K4 and K5 take a flag, s16, and
// read them as bf16, upcast in registers (staged.cuh, load_stage): one
// instance a kernel for both storage types.
//
// What bounds the one-thread kernels on an H100 is, as for fused.cu, the
// per-state working set in local memory (L1/L2 traffic), not DRAM: K5
// reads ≈ 21n values a state and writes 2n·cb; the finish re-reads the
// block's rows of M⁻¹. The robot constants are staged in shared memory once
// per block. K5, K2′ and the sweeps K1, K4 and vaf run as CTA tiles instead
// (tile.cuh): a tile of states a CTA, each state's working set in shared
// memory, K5 every column block at once (cb is checked as for the
// one-thread kernel and changes no result); the one-thread kernels stay as
// their `_thread` entries (grid_bias_v_thread, grid_af_thread,
// grid_vaf_thread, grid_minv_dense_thread, grid_grad_cols_thread). The
// sweeps are bound by bytes (K4 at Atlas: ≈ 2.3 KB a state): their tile
// loads and stores the (6, n, B) stage tensors with consecutive threads on
// consecutive states and keeps X, v, a, f in shared memory, so the stage
// writes, not a local-memory frame, set their time.
#include <cuda_runtime.h>

#include "tile.cuh"

namespace {

constexpr int kThreads = 128;

// 152·n constants a robot (Atlas's fit in float64). Above the 48 KB a block
// gets without opting in, the build fails here rather than at launch.
static_assert(grid::kConstCount * sizeof(double) <= 48 * 1024,
              "robot constants exceed 48 KB of shared memory");

template <typename T>
__device__ __forceinline__ const T* stage_constants(const T* __restrict__ g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  for (int k = threadIdx.x; k < grid::kConstCount; k += blockDim.x)
    sm[k] = g[k];
  __syncthreads();
  return sm;
}

__device__ __forceinline__ long long state_index() {
  return static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
}

template <typename T, int kMode>
__global__ void __launch_bounds__(kThreads)
vaf_kernel(const T* __restrict__ consts, const T* __restrict__ q,
           const T* __restrict__ qd, const T* __restrict__ qdd,
           const void* __restrict__ v_in, bool s16, T* __restrict__ c,
           T* __restrict__ v, T* __restrict__ a, T* __restrict__ f,
           long long B, T minus_g) {
  const grid::Robot<T> R(stage_constants(consts));
  const long long b = state_index();
  if (b >= B) return;
  grid::vaf_state<T, kMode>(R, q, qd, qdd, v_in, s16, c, v, a, f, B, b,
                            minus_g);
}

template <typename T, bool kRhs>
__global__ void __launch_bounds__(kThreads)
minv_dense_kernel(const T* __restrict__ consts, const T* __restrict__ q,
                  const T* __restrict__ rhs, T* __restrict__ M,
                  T* __restrict__ qdd, long long B) {
  const grid::Robot<T> R(stage_constants(consts));
  const long long b = state_index();
  if (b >= B) return;
  grid::minv_dense_state<T, kRhs>(R, q, rhs, M, qdd, B, b);
}

template <typename T, bool kFinish>
__global__ void __launch_bounds__(kThreads)
grad_cols_kernel(const T* __restrict__ consts, const T* __restrict__ q,
                 const T* __restrict__ qd, const void* __restrict__ v,
                 const void* __restrict__ a, const void* __restrict__ f,
                 const void* __restrict__ Minv, bool s16,
                 T* __restrict__ dq, T* __restrict__ dqd, long long B,
                 int cb, int sides, T minus_g) {
  const grid::Robot<T> R(stage_constants(consts));
  const long long b = state_index();
  if (b >= B) return;
  const int c0 = static_cast<int>(blockIdx.y) * cb;
  const int w = grid::N - c0 < cb ? grid::N - c0 : cb;
  grid::grad_cols_state<T, kFinish>(R, q, qd, v, a, f, Minv, s16, dq, dqd, B,
                                    b, c0, w, sides, minus_g);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fd_dense_kernel(const T* __restrict__ consts, const T* __restrict__ q,
                const T* __restrict__ qd, const T* __restrict__ u,
                T* __restrict__ qdd, long long B, T minus_g) {
  const grid::Robot<T> R(stage_constants(consts));
  const long long b = state_index();
  if (b >= B) return;
  grid::fd_dense_state(R, q, qd, u, qdd, B, b, minus_g);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
minv_af_kernel(const T* __restrict__ consts, const T* __restrict__ q,
               const T* __restrict__ qd, const T* __restrict__ umc,
               const T* __restrict__ v, T* __restrict__ M,
               T* __restrict__ a, T* __restrict__ f, long long B,
               T minus_g) {
  const grid::Robot<T> R(stage_constants(consts));
  const long long b = state_index();
  if (b >= B) return;
  grid::minv_af_state(R, q, qd, umc, v, M, a, f, B, b, minus_g);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
minv_ud_kernel(const T* __restrict__ consts, const T* __restrict__ q,
               T* __restrict__ U, T* __restrict__ Dinv, long long B) {
  const grid::Robot<T> R(stage_constants(consts));
  const long long b = state_index();
  if (b >= B) return;
  grid::minv_ud_state(R, q, U, Dinv, B, b);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
minv_cols_kernel(const T* __restrict__ consts, const T* __restrict__ q,
                 const T* __restrict__ U, const T* __restrict__ Dinv,
                 T* __restrict__ M, long long B, int cb) {
  const grid::Robot<T> R(stage_constants(consts));
  const long long b = state_index();
  if (b >= B) return;
  const int c0 = static_cast<int>(blockIdx.y) * cb;
  const int w = grid::N - c0 < cb ? grid::N - c0 : cb;
  grid::minv_cols_state(R, q, U, Dinv, M, B, b, c0, w);
}

// ------------------------------------------------------ the CTA tiles
// K5's threads a CTA: f32 1024 (≤ 64 registers a thread), f64 512 (≤ 128);
// K2′ runs one warp a state
template <typename T>
__host__ __device__ constexpr int k5_threads() {
  return sizeof(T) == 4 ? 1024 : 512;
}
template <typename T>
__host__ __device__ constexpr int k2_threads() {
  return 32 * grid::k2_states<T>();
}

// the CTA's shared memory: the robot constants, the tile, the tables
template <typename T, int kStates, int kStride>
__device__ __forceinline__ T* tile_shared(const T* __restrict__ consts,
                                          const short* table, int count,
                                          short** tb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  T* tile = sm + grid::kConstCount;
  *tb = reinterpret_cast<short*>(tile + kStates * kStride);
  for (int k = threadIdx.x; k < grid::kConstCount; k += blockDim.x)
    sm[k] = consts[k];
  for (int k = threadIdx.x; k < count; k += blockDim.x) (*tb)[k] = table[k];
  __syncthreads();
  return sm;
}

template <typename T>
__global__ void __launch_bounds__(k5_threads<T>())
grad_cols_tile_kernel(const T* __restrict__ consts, const T* __restrict__ q,
                      const T* __restrict__ qd, const void* __restrict__ v,
                      const void* __restrict__ a, const void* __restrict__ f,
                      const void* __restrict__ Minv, bool s16,
                      T* __restrict__ dq, T* __restrict__ dqd, long long B,
                      int sides, T minus_g) {
  constexpr int S = grid::k5_states<T>();
  short* tb;
  T* sm = tile_shared<T, S, grid::kK5Stride>(consts, grid::c_k5_table,
                                             grid::kK5Table, &tb);
  const grid::Robot<T> R(sm);
  grid::grad_cols_tile<T, S, k5_threads<T>()>(
      static_cast<int>(threadIdx.x), R, grid::K5Tables(tb),
      sm + grid::kConstCount, q, qd, v, a, f, Minv, s16, dq, dqd, B,
      static_cast<long long>(blockIdx.x) * S, sides, minus_g);
}

template <typename T, int kMode>
__global__ void __launch_bounds__(grid::vaf_threads<T>(), GRID_TILE_CTAS)
vaf_tile_kernel(const T* __restrict__ consts, const T* __restrict__ q,
                const T* __restrict__ qd, const T* __restrict__ qdd,
                const void* __restrict__ v_in, bool s16, T* __restrict__ c,
                T* __restrict__ v, T* __restrict__ a, T* __restrict__ f,
                long long B, T minus_g) {
  constexpr int S = grid::vaf_states<T>();
  short* tb;
  T* sm = tile_shared<T, S, grid::kVafStride>(consts, grid::c_rn_table,
                                              grid::kRnTable, &tb);
  const grid::Robot<T> R(sm);
  grid::vaf_tile<T, kMode, S, grid::vaf_threads<T>()>(
      static_cast<int>(threadIdx.x), R, grid::RnTables(tb),
      sm + grid::kConstCount, q, qd, qdd, v_in, s16, c, v, a, f, B,
      static_cast<long long>(blockIdx.x) * S, minus_g);
}

template <typename T, bool kRhs>
__global__ void __launch_bounds__(k2_threads<T>())
minv_dense_tile_kernel(const T* __restrict__ consts, const T* __restrict__ q,
                       const T* __restrict__ rhs, T* __restrict__ M,
                       T* __restrict__ qdd, long long B) {
  constexpr int S = grid::k2_states<T>();
  short* tb;
  T* sm = tile_shared<T, S, grid::kK2Stride>(consts, grid::c_k2_table,
                                             grid::kK2Table, &tb);
  const grid::Robot<T> R(sm);
  grid::minv_dense_tile<T, kRhs, S, 32>(
      static_cast<int>(threadIdx.x), R, grid::K2Tables(tb),
      sm + grid::kConstCount, q, rhs, M, qdd, B,
      static_cast<long long>(blockIdx.x) * S);
}

// opt a tile kernel into its dynamic shared memory (above 48 KB a launch
// without it is refused) and launch it on ⌈B / states⌉ CTAs of threads
template <typename K, typename... Args>
int launch_tile(K kernel, size_t smem, long long B, int states, int threads,
                cudaStream_t s, Args... args) {
  cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const unsigned blocks = static_cast<unsigned>((B + states - 1) / states);
  kernel<<<blocks, threads, smem, s>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

unsigned blocks_for(long long B) {
  return static_cast<unsigned>((B + kThreads - 1) / kThreads);
}

template <typename T>
size_t smem_bytes() {
  return grid::kConstCount * sizeof(T);
}

// the one-thread K1, K4, vaf (the sweep tile's timed arm); s16: v_in is
// bf16 (K4 under stage_dtype)
template <typename T>
int launch_vaf_thread(int mode, const void* consts, const void* q,
                      const void* qd, const void* qdd, const void* v_in,
                      bool s16, void* c, void* v, void* a, void* f,
                      long long B, double gravity, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto k = static_cast<const T*>(consts);
  auto tq = static_cast<const T*>(q);
  auto tqd = static_cast<const T*>(qd);
  auto tqdd = static_cast<const T*>(qdd);
  const T mg = static_cast<T>(-gravity);
  const dim3 grid_dim(blocks_for(B));
  if (mode == grid::kBiasV) {
    vaf_kernel<T, grid::kBiasV><<<grid_dim, kThreads, smem_bytes<T>(), s>>>(
        k, tq, tqd, nullptr, nullptr, false, static_cast<T*>(c),
        static_cast<T*>(v), nullptr, nullptr, B, mg);
  } else if (mode == grid::kAF) {
    vaf_kernel<T, grid::kAF><<<grid_dim, kThreads, smem_bytes<T>(), s>>>(
        k, tq, tqd, tqdd, v_in, s16, nullptr, nullptr, static_cast<T*>(a),
        static_cast<T*>(f), B, mg);
  } else if (mode == grid::kVAF) {
    vaf_kernel<T, grid::kVAF><<<grid_dim, kThreads, smem_bytes<T>(), s>>>(
        k, tq, tqd, tqdd, nullptr, false, nullptr, static_cast<T*>(v),
        static_cast<T*>(a), static_cast<T*>(f), B, mg);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// the sweep tile (K1, K4, ∂ID's vaf); a dtype whose tile does not fit a
// CTA's shared memory (states 0 in the plan) is refused
template <typename T>
int launch_vaf(int mode, const void* consts, const void* q, const void* qd,
               const void* qdd, const void* v_in, bool s16, void* c, void* v,
               void* a, void* f, long long B, double gravity, void* stream) {
  constexpr int S = grid::vaf_states<T>();
  if constexpr (S > 0) {
    const size_t smem = grid::tile_smem<T>(S, grid::kVafStride,
                                           grid::kRnTable);
    auto s = static_cast<cudaStream_t>(stream);
    auto k = static_cast<const T*>(consts);
    auto tq = static_cast<const T*>(q);
    auto tqd = static_cast<const T*>(qd);
    auto tqdd = static_cast<const T*>(qdd);
    const T mg = static_cast<T>(-gravity);
    constexpr int NT = grid::vaf_threads<T>();
    if (mode == grid::kBiasV)
      return launch_tile(vaf_tile_kernel<T, grid::kBiasV>, smem, B, S, NT, s,
                         k, tq, tqd, static_cast<const T*>(nullptr),
                         static_cast<const void*>(nullptr), false,
                         static_cast<T*>(c), static_cast<T*>(v),
                         static_cast<T*>(nullptr), static_cast<T*>(nullptr),
                         B, mg);
    if (mode == grid::kAF)
      return launch_tile(vaf_tile_kernel<T, grid::kAF>, smem, B, S, NT, s, k,
                         tq, tqd, tqdd, v_in, s16, static_cast<T*>(nullptr),
                         static_cast<T*>(nullptr), static_cast<T*>(a),
                         static_cast<T*>(f), B, mg);
    if (mode == grid::kVAF)
      return launch_tile(vaf_tile_kernel<T, grid::kVAF>, smem, B, S, NT, s,
                         k, tq, tqd, tqdd, static_cast<const void*>(nullptr),
                         false, static_cast<T*>(nullptr), static_cast<T*>(v),
                         static_cast<T*>(a), static_cast<T*>(f), B, mg);
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
}

// rhs == nullptr: M⁻¹ only (direct_minv); else also q̈ = M⁻¹·rhs
template <typename T>
int launch_minv_dense_thread(const void* consts, const void* q,
                             const void* rhs, void* M, void* qdd, long long B,
                             void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto k = static_cast<const T*>(consts);
  if (rhs != nullptr) {
    minv_dense_kernel<T, true><<<blocks_for(B), kThreads, smem_bytes<T>(),
                                 s>>>(k, static_cast<const T*>(q),
                                      static_cast<const T*>(rhs),
                                      static_cast<T*>(M),
                                      static_cast<T*>(qdd), B);
  } else {
    minv_dense_kernel<T, false><<<blocks_for(B), kThreads, smem_bytes<T>(),
                                  s>>>(k, static_cast<const T*>(q), nullptr,
                                       static_cast<T*>(M), nullptr, B);
  }
  return static_cast<int>(cudaGetLastError());
}

// Minv == nullptr: the ∂ID blocks (∂c); else the fused finish (−M⁻¹·∂c).
// sides: 1 ∂c/∂q only, 2 ∂c/∂q̇ only, 3 both; s16: v, a, f, Minv in bf16.
template <typename T>
int launch_grad_cols_thread(const void* consts, const void* q, const void* qd,
                            const void* v, const void* a, const void* f,
                            const void* Minv, void* dq, void* dqd,
                            long long B, int cb, int sides, int s16,
                            double gravity, void* stream) {
  if (cb < 1 || cb > grid::CB || sides < 1 || sides > 3)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const dim3 grid_dim(blocks_for(B), (grid::N + cb - 1) / cb);
  auto k = static_cast<const T*>(consts);
  auto tq = static_cast<const T*>(q);
  auto tqd = static_cast<const T*>(qd);
  auto tdq = static_cast<T*>(dq);
  auto tdqd = static_cast<T*>(dqd);
  const T mg = static_cast<T>(-gravity);
  if (Minv != nullptr) {
    grad_cols_kernel<T, true><<<grid_dim, kThreads, smem_bytes<T>(), s>>>(
        k, tq, tqd, v, a, f, Minv, s16 != 0, tdq, tdqd, B, cb, sides, mg);
  } else {
    grad_cols_kernel<T, false><<<grid_dim, kThreads, smem_bytes<T>(), s>>>(
        k, tq, tqd, v, a, f, nullptr, s16 != 0, tdq, tdqd, B, cb, sides,
        mg);
  }
  return static_cast<int>(cudaGetLastError());
}

// The tile launchers. A dtype whose tile does not fit one CTA's shared
// memory (states 0 in the plan) launches the one-thread kernel.
template <typename T>
int launch_minv_dense(const void* consts, const void* q, const void* rhs,
                      void* M, void* qdd, long long B, void* stream) {
  constexpr int S = grid::k2_states<T>();
  if constexpr (S > 0) {
    const size_t smem = grid::tile_smem<T>(S, grid::kK2Stride, grid::kK2Table);
    auto s = static_cast<cudaStream_t>(stream);
    auto k = static_cast<const T*>(consts);
    auto tq = static_cast<const T*>(q);
    auto tM = static_cast<T*>(M);
    if (rhs != nullptr)
      return launch_tile(minv_dense_tile_kernel<T, true>, smem, B, S,
                         k2_threads<T>(), s, k, tq,
                         static_cast<const T*>(rhs), tM,
                         static_cast<T*>(qdd), B);
    return launch_tile(minv_dense_tile_kernel<T, false>, smem, B, S,
                       k2_threads<T>(), s, k, tq,
                       static_cast<const T*>(nullptr), tM,
                       static_cast<T*>(nullptr), B);
  } else {
    return launch_minv_dense_thread<T>(consts, q, rhs, M, qdd, B, stream);
  }
}

template <typename T>
int launch_grad_cols(const void* consts, const void* q, const void* qd,
                     const void* v, const void* a, const void* f,
                     const void* Minv, void* dq, void* dqd, long long B,
                     int cb, int sides, int s16, double gravity,
                     void* stream) {
  constexpr int S = grid::k5_states<T>();
  if constexpr (S > 0) {
    if (cb < 1 || cb > grid::CB || sides < 1 || sides > 3)
      return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = grid::tile_smem<T>(S, grid::kK5Stride, grid::kK5Table);
    return launch_tile(grad_cols_tile_kernel<T>, smem, B, S,
                       k5_threads<T>(), static_cast<cudaStream_t>(stream),
                       static_cast<const T*>(consts),
                       static_cast<const T*>(q), static_cast<const T*>(qd), v,
                       a, f, Minv, s16 != 0, static_cast<T*>(dq),
                       static_cast<T*>(dqd), B, sides,
                       static_cast<T>(-gravity));
  } else {
    return launch_grad_cols_thread<T>(consts, q, qd, v, a, f, Minv, dq, dqd,
                                      B, cb, sides, s16, gravity, stream);
  }
}

template <typename T>
int launch_fd_dense(const void* consts, const void* q, const void* qd,
                    const void* u, void* qdd, long long B, double gravity,
                    void* stream) {
  fd_dense_kernel<T><<<blocks_for(B), kThreads, smem_bytes<T>(),
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(consts), static_cast<const T*>(q),
      static_cast<const T*>(qd), static_cast<const T*>(u),
      static_cast<T*>(qdd), B, static_cast<T>(-gravity));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_minv_af(const void* consts, const void* q, const void* qd,
                   const void* umc, const void* v, void* M, void* a, void* f,
                   long long B, double gravity, void* stream) {
  minv_af_kernel<T><<<blocks_for(B), kThreads, smem_bytes<T>(),
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(consts), static_cast<const T*>(q),
      static_cast<const T*>(qd), static_cast<const T*>(umc),
      static_cast<const T*>(v), static_cast<T*>(M), static_cast<T*>(a),
      static_cast<T*>(f), B, static_cast<T>(-gravity));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_minv_ud(const void* consts, const void* q, void* U, void* Dinv,
                   long long B, void* stream) {
  minv_ud_kernel<T><<<blocks_for(B), kThreads, smem_bytes<T>(),
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(consts), static_cast<const T*>(q),
      static_cast<T*>(U), static_cast<T*>(Dinv), B);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_minv_cols(const void* consts, const void* q, const void* U,
                     const void* Dinv, void* M, long long B, int cb,
                     void* stream) {
  if (cb < 1 || cb > grid::MINV_CB)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid_dim(blocks_for(B), (grid::N + cb - 1) / cb);
  minv_cols_kernel<T><<<grid_dim, kThreads, smem_bytes<T>(),
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(consts), static_cast<const T*>(q),
      static_cast<const T*>(U), static_cast<const T*>(Dinv),
      static_cast<T*>(M), B, cb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface for ctypes (ops/kernels/_build.py declares the argtypes).
// Every entry launches on the given stream, does not synchronise, and
// returns cudaGetLastError() of the launch.
extern "C" {

int grid_num_joints() { return grid::N; }

const char* grid_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

#define GRID_STAGED_ENTRIES(T, tag)                                          \
  int grid_bias_v_##tag(const void* consts, const void* q, const void* qd,   \
                        void* c, void* v, long long B, double gravity,       \
                        void* stream) {                                      \
    return launch_vaf<T>(grid::kBiasV, consts, q, qd, nullptr, nullptr,      \
                         false, c, v, nullptr, nullptr, B, gravity, stream); \
  }                                                                          \
  int grid_af_##tag(const void* consts, const void* q, const void* qd,       \
                    const void* qdd, const void* v, void* a, void* f,        \
                    long long B, int s16, double gravity, void* stream) {    \
    return launch_vaf<T>(grid::kAF, consts, q, qd, qdd, v, s16 != 0,         \
                         nullptr, nullptr, a, f, B, gravity, stream);        \
  }                                                                          \
  int grid_vaf_##tag(const void* consts, const void* q, const void* qd,      \
                     const void* qdd, void* v, void* a, void* f,             \
                     long long B, double gravity, void* stream) {            \
    return launch_vaf<T>(grid::kVAF, consts, q, qd, qdd, nullptr, false,     \
                         nullptr, v, a, f, B, gravity, stream);              \
  }                                                                          \
  int grid_bias_v_thread_##tag(const void* consts, const void* q,            \
                               const void* qd, void* c, void* v, long long B, \
                               double gravity, void* stream) {                \
    return launch_vaf_thread<T>(grid::kBiasV, consts, q, qd, nullptr,        \
                                nullptr, false, c, v, nullptr, nullptr, B,   \
                                gravity, stream);                            \
  }                                                                          \
  int grid_af_thread_##tag(const void* consts, const void* q, const void* qd, \
                           const void* qdd, const void* v, void* a, void* f,  \
                           long long B, int s16, double gravity,              \
                           void* stream) {                                    \
    return launch_vaf_thread<T>(grid::kAF, consts, q, qd, qdd, v, s16 != 0,  \
                                nullptr, nullptr, a, f, B, gravity, stream); \
  }                                                                          \
  int grid_vaf_thread_##tag(const void* consts, const void* q,               \
                            const void* qd, const void* qdd, void* v,        \
                            void* a, void* f, long long B, double gravity,   \
                            void* stream) {                                  \
    return launch_vaf_thread<T>(grid::kVAF, consts, q, qd, qdd, nullptr,     \
                                false, nullptr, v, a, f, B, gravity, stream); \
  }                                                                          \
  int grid_minv_dense_##tag(const void* consts, const void* q,               \
                            const void* rhs, void* M, void* qdd,             \
                            long long B, void* stream) {                     \
    return launch_minv_dense<T>(consts, q, rhs, M, qdd, B, stream);          \
  }                                                                          \
  int grid_grad_cols_##tag(const void* consts, const void* q,                \
                           const void* qd, const void* v, const void* a,     \
                           const void* f, const void* Minv, void* dq,        \
                           void* dqd, long long B, int cb, int sides,        \
                           int s16, double gravity, void* stream) {          \
    return launch_grad_cols<T>(consts, q, qd, v, a, f, Minv, dq, dqd, B, cb, \
                               sides, s16, gravity, stream);                 \
  }                                                                          \
  int grid_grad_cols_thread_##tag(                                           \
      const void* consts, const void* q, const void* qd, const void* v,      \
      const void* a, const void* f, const void* Minv, void* dq, void* dqd,   \
      long long B, int cb, int sides, int s16, double gravity,               \
      void* stream) {                                                        \
    return launch_grad_cols_thread<T>(consts, q, qd, v, a, f, Minv, dq, dqd, \
                                      B, cb, sides, s16, gravity, stream);   \
  }                                                                          \
  int grid_minv_dense_thread_##tag(const void* consts, const void* q,        \
                                   const void* rhs, void* M, void* qdd,      \
                                   long long B, void* stream) {              \
    return launch_minv_dense_thread<T>(consts, q, rhs, M, qdd, B, stream);   \
  }                                                                          \
  int grid_fd_dense_##tag(const void* consts, const void* q, const void* qd, \
                          const void* u, void* qdd, long long B,             \
                          double gravity, void* stream) {                    \
    return launch_fd_dense<T>(consts, q, qd, u, qdd, B, gravity, stream);    \
  }                                                                          \
  int grid_minv_af_##tag(const void* consts, const void* q, const void* qd,  \
                         const void* umc, const void* v, void* M, void* a,   \
                         void* f, long long B, double gravity,               \
                         void* stream) {                                     \
    return launch_minv_af<T>(consts, q, qd, umc, v, M, a, f, B, gravity,     \
                             stream);                                        \
  }                                                                          \
  int grid_minv_ud_##tag(const void* consts, const void* q, void* U,         \
                         void* Dinv, long long B, void* stream) {            \
    return launch_minv_ud<T>(consts, q, U, Dinv, B, stream);                 \
  }                                                                          \
  int grid_minv_cols_##tag(const void* consts, const void* q, const void* U, \
                           const void* Dinv, void* M, long long B, int cb,   \
                           void* stream) {                                   \
    return launch_minv_cols<T>(consts, q, U, Dinv, M, B, cb, stream);        \
  }

GRID_STAGED_ENTRIES(float, f32)
GRID_STAGED_ENTRIES(double, f64)

#undef GRID_STAGED_ENTRIES

}  // extern "C"
