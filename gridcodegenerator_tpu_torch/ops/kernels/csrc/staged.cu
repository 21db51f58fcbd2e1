// The staged large-robot pipeline's kernels, one thread per state.
//
// Replaces (gridcodegenerator_tpu/ops/kernels/staged.py):
//   bias_and_v_staged, K1          (staged.py:172) -> grid_bias_v_{f32,f64}
//   minv_qdd_dense_staged, K2′     (staged.py:218) -> grid_minv_dense_{f32,f64}
//   fd_grad_staged body_af, K4     (staged.py:453) -> grid_af_{f32,f64}
//   id_grad_staged body_vaf        (staged.py:341) -> grid_vaf_{f32,f64}
//   fd_grad_staged body_grad, K5 with the fused −M⁻¹·∂c finish
//                                  (staged.py:470) -> grid_grad_cols_{..}
//   id_grad_staged body_grad, K5   (staged.py:356)    with Minv == NULL
// On the TPU a working set that outgrew VMEM was cut into several Pallas
// kernels with HBM-staged v, a, f, M⁻¹ between them, and the ∂ID into
// column blocks, one pallas_call each. Here the same cut bounds the
// per-thread local-memory frame: the single-thread ∇FD body holds ≈ 28·n²
// values a state, the K5 body 18·n·CB + O(n).
// All column blocks of K5 are one launch on a 2-D grid (⌈B/128⌉, ⌈n/cb⌉):
// blockIdx.y is the column block, c0 = blockIdx.y·cb is a runtime value and
// cb ≤ GRID_CB (the compile-time width of the ∂-tensor arrays).
//
// What bounds them on an H100 is, as for fused.cu, the per-state working
// set in local memory (L1/L2 traffic), not DRAM: K5 reads ≈ 21n values a
// state and writes 2n·cb; the finish re-reads the block's rows of M⁻¹.
// The robot constants are staged in shared memory once per block.
#include <cuda_runtime.h>

#include "staged.cuh"

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
           const T* __restrict__ v_in, T* __restrict__ c, T* __restrict__ v,
           T* __restrict__ a, T* __restrict__ f, long long B, T minus_g) {
  const grid::Robot<T> R(stage_constants(consts));
  const long long b = state_index();
  if (b >= B) return;
  grid::vaf_state<T, kMode>(R, q, qd, qdd, v_in, c, v, a, f, B, b, minus_g);
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
                 const T* __restrict__ qd, const T* __restrict__ v,
                 const T* __restrict__ a, const T* __restrict__ f,
                 const T* __restrict__ Minv, T* __restrict__ dq,
                 T* __restrict__ dqd, long long B, int cb, T minus_g) {
  const grid::Robot<T> R(stage_constants(consts));
  const long long b = state_index();
  if (b >= B) return;
  const int c0 = static_cast<int>(blockIdx.y) * cb;
  const int w = grid::N - c0 < cb ? grid::N - c0 : cb;
  grid::grad_cols_state<T, kFinish>(R, q, qd, v, a, f, Minv, dq, dqd, B, b,
                                    c0, w, minus_g);
}

unsigned blocks_for(long long B) {
  return static_cast<unsigned>((B + kThreads - 1) / kThreads);
}

template <typename T>
size_t smem_bytes() {
  return grid::kConstCount * sizeof(T);
}

template <typename T>
int launch_vaf(int mode, const void* consts, const void* q, const void* qd,
               const void* qdd, const void* v_in, void* c, void* v, void* a,
               void* f, long long B, double gravity, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto k = static_cast<const T*>(consts);
  auto tq = static_cast<const T*>(q);
  auto tqd = static_cast<const T*>(qd);
  auto tqdd = static_cast<const T*>(qdd);
  auto tv_in = static_cast<const T*>(v_in);
  const T mg = static_cast<T>(-gravity);
  const dim3 grid_dim(blocks_for(B));
  if (mode == grid::kBiasV) {
    vaf_kernel<T, grid::kBiasV><<<grid_dim, kThreads, smem_bytes<T>(), s>>>(
        k, tq, tqd, nullptr, nullptr, static_cast<T*>(c), static_cast<T*>(v),
        nullptr, nullptr, B, mg);
  } else if (mode == grid::kAF) {
    vaf_kernel<T, grid::kAF><<<grid_dim, kThreads, smem_bytes<T>(), s>>>(
        k, tq, tqd, tqdd, tv_in, nullptr, nullptr, static_cast<T*>(a),
        static_cast<T*>(f), B, mg);
  } else if (mode == grid::kVAF) {
    vaf_kernel<T, grid::kVAF><<<grid_dim, kThreads, smem_bytes<T>(), s>>>(
        k, tq, tqd, tqdd, nullptr, nullptr, static_cast<T*>(v),
        static_cast<T*>(a), static_cast<T*>(f), B, mg);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// rhs == nullptr: M⁻¹ only (direct_minv); else also q̈ = M⁻¹·rhs
template <typename T>
int launch_minv_dense(const void* consts, const void* q, const void* rhs,
                      void* M, void* qdd, long long B, void* stream) {
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

// Minv == nullptr: the ∂ID blocks (∂c); else the fused finish (−M⁻¹·∂c)
template <typename T>
int launch_grad_cols(const void* consts, const void* q, const void* qd,
                     const void* v, const void* a, const void* f,
                     const void* Minv, void* dq, void* dqd, long long B,
                     int cb, double gravity, void* stream) {
  if (cb < 1 || cb > grid::CB) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const dim3 grid_dim(blocks_for(B), (grid::N + cb - 1) / cb);
  auto k = static_cast<const T*>(consts);
  auto tq = static_cast<const T*>(q);
  auto tqd = static_cast<const T*>(qd);
  auto tv = static_cast<const T*>(v);
  auto ta = static_cast<const T*>(a);
  auto tf = static_cast<const T*>(f);
  auto tM = static_cast<const T*>(Minv);
  auto tdq = static_cast<T*>(dq);
  auto tdqd = static_cast<T*>(dqd);
  const T mg = static_cast<T>(-gravity);
  if (Minv != nullptr) {
    grad_cols_kernel<T, true><<<grid_dim, kThreads, smem_bytes<T>(), s>>>(
        k, tq, tqd, tv, ta, tf, tM, tdq, tdqd, B, cb, mg);
  } else {
    grad_cols_kernel<T, false><<<grid_dim, kThreads, smem_bytes<T>(), s>>>(
        k, tq, tqd, tv, ta, tf, nullptr, tdq, tdqd, B, cb, mg);
  }
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
    return launch_vaf<T>(grid::kBiasV, consts, q, qd, nullptr, nullptr, c,   \
                         v, nullptr, nullptr, B, gravity, stream);           \
  }                                                                          \
  int grid_af_##tag(const void* consts, const void* q, const void* qd,       \
                    const void* qdd, const void* v, void* a, void* f,        \
                    long long B, double gravity, void* stream) {             \
    return launch_vaf<T>(grid::kAF, consts, q, qd, qdd, v, nullptr, nullptr, \
                         a, f, B, gravity, stream);                          \
  }                                                                          \
  int grid_vaf_##tag(const void* consts, const void* q, const void* qd,      \
                     const void* qdd, void* v, void* a, void* f,             \
                     long long B, double gravity, void* stream) {            \
    return launch_vaf<T>(grid::kVAF, consts, q, qd, qdd, nullptr, nullptr,   \
                         v, a, f, B, gravity, stream);                       \
  }                                                                          \
  int grid_minv_dense_##tag(const void* consts, const void* q,               \
                            const void* rhs, void* M, void* qdd,             \
                            long long B, void* stream) {                     \
    return launch_minv_dense<T>(consts, q, rhs, M, qdd, B, stream);          \
  }                                                                          \
  int grid_grad_cols_##tag(const void* consts, const void* q,                \
                           const void* qd, const void* v, const void* a,     \
                           const void* f, const void* Minv, void* dq,        \
                           void* dqd, long long B, int cb, double gravity,   \
                           void* stream) {                                   \
    return launch_grad_cols<T>(consts, q, qd, v, a, f, Minv, dq, dqd, B, cb, \
                               gravity, stream);                             \
  }

GRID_STAGED_ENTRIES(float, f32)
GRID_STAGED_ENTRIES(double, f64)

#undef GRID_STAGED_ENTRIES

}  // extern "C"
