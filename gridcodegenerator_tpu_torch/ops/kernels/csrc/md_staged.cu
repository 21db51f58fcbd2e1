// The staged multi-dof pipeline's kernels, one thread per state.
//
// Replaces (gridcodegenerator_tpu/ops/kernels/multidof_staged.py):
//   md_vaf_staged, K1md       (:109) -> grid_md_vaf_{f32,f64}
//   md_minv_fused, K2md       (:127) -> grid_md_minv_{f32,f64}, qd == NULL
//   md_minv_qdd_fused, K2md+q̈ (:149) -> grid_md_minv_{f32,f64}
//   _grad_blocks, K5md        (:184) -> grid_md_grad_cols_{f32,f64}, for
//     md_id_grad_staged (:240, Minv == NULL) and md_fd_grad_staged (:262,
//     the fused −M⁻¹·∂c finish)
// On the TPU the staged pipeline kept each Pallas kernel's live set inside
// VMEM past the single-tile gate (md_grad_workset_ok). Here the same cut
// bounds the per-thread local-memory frame: the single-thread ∇FD of
// md.cu holds 18·n·nv ∂-values and four nv×nv matrices a state (92 KB in
// float32 at free Atlas, n 29, nv 34); K5md holds 18·n·MD_CB, K2md X, the
// CRBA's composite inertias and two nv×nv matrices.
// All column blocks of K5md are one launch on a 2-D grid (⌈B/128⌉,
// ⌈nv/cb⌉): blockIdx.y is the column block, c0 = blockIdx.y·cb is a runtime
// value and cb ≤ GRID_MD_CB (the compile-time width of the ∂-tensor
// arrays); the ragged last block is masked by its width. Each thread does
// both sides of its block, sharing X(q), the staged v, a, f and the reads
// of M⁻¹.
//
// What bounds them on an H100 is the per-state working set in local memory
// (L1/L2 traffic), not DRAM: K5md reads 3·6·n + nq + nv values a state
// (+ nv² for the finish) and writes 2·nv·cb. The robot constants are
// staged in shared memory once per block. Topology, joint types and the
// block width come in as -D macros (md.cuh, md_staged.cuh); the kernels
// are templated on float and double.
#include <cuda_runtime.h>

#include "md_staged.cuh"

namespace {

constexpr int kThreads = 128;

static_assert(grid::kMdConstCount * sizeof(double) <= 48 * 1024,
              "robot constants exceed 48 KB of shared memory");

template <typename T>
__device__ __forceinline__ const T* stage_constants(const T* __restrict__ g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  for (int k = threadIdx.x; k < grid::kMdConstCount; k += blockDim.x)
    sm[k] = g[k];
  __syncthreads();
  return sm;
}

__device__ __forceinline__ long long state_index() {
  return static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
}

template <typename T, bool kQdd>
__global__ void __launch_bounds__(kThreads)
md_vaf_kernel(const T* __restrict__ consts, const T* __restrict__ q,
              const T* __restrict__ qd, const T* __restrict__ qdd,
              T* __restrict__ v, T* __restrict__ a, T* __restrict__ f,
              long long B, T minus_g) {
  const grid::MdRobot<T> R(stage_constants(consts));
  const long long b = state_index();
  if (b >= B) return;
  grid::md_vaf_state<T, kQdd>(R, q, qd, qdd, v, a, f, B, b, minus_g);
}

template <typename T, bool kRhs>
__global__ void __launch_bounds__(kThreads)
md_minv_kernel(const T* __restrict__ consts, const T* __restrict__ q,
               const T* __restrict__ qd, const T* __restrict__ u,
               T* __restrict__ M, T* __restrict__ qdd, long long B,
               T minus_g) {
  const grid::MdRobot<T> R(stage_constants(consts));
  const long long b = state_index();
  if (b >= B) return;
  grid::md_minv_state<T, kRhs>(R, q, qd, u, M, qdd, B, b, minus_g);
}

template <typename T, bool kFinish>
__global__ void __launch_bounds__(kThreads)
md_grad_cols_kernel(const T* __restrict__ consts, const T* __restrict__ q,
                    const T* __restrict__ qd, const T* __restrict__ v,
                    const T* __restrict__ a, const T* __restrict__ f,
                    const T* __restrict__ Minv, T* __restrict__ dq,
                    T* __restrict__ dqd, long long B, int cb, T minus_g) {
  const grid::MdRobot<T> R(stage_constants(consts));
  const long long b = state_index();
  if (b >= B) return;
  const int c0 = static_cast<int>(blockIdx.y) * cb;
  const int w = grid::NV - c0 < cb ? grid::NV - c0 : cb;
  grid::md_grad_cols_state<T, kFinish>(R, q, qd, v, a, f, Minv, dq, dqd, B,
                                       b, c0, w, minus_g);
}

unsigned blocks_for(long long B) {
  return static_cast<unsigned>((B + kThreads - 1) / kThreads);
}

template <typename T>
size_t smem_bytes() {
  return grid::kMdConstCount * sizeof(T);
}

template <typename T>
const T* in(const void* p) {
  return static_cast<const T*>(p);
}

// qdd == nullptr: the sweep at q̈ = 0 (no S·q̈)
template <typename T>
int vaf(const void* consts, const void* q, const void* qd, const void* qdd,
        void* v, void* a, void* f, long long B, double gravity,
        void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const T mg = static_cast<T>(-gravity);
  if (qdd != nullptr) {
    md_vaf_kernel<T, true><<<blocks_for(B), kThreads, smem_bytes<T>(), s>>>(
        in<T>(consts), in<T>(q), in<T>(qd), in<T>(qdd), static_cast<T*>(v),
        static_cast<T*>(a), static_cast<T*>(f), B, mg);
  } else {
    md_vaf_kernel<T, false><<<blocks_for(B), kThreads, smem_bytes<T>(), s>>>(
        in<T>(consts), in<T>(q), in<T>(qd), nullptr, static_cast<T*>(v),
        static_cast<T*>(a), static_cast<T*>(f), B, mg);
  }
  return static_cast<int>(cudaGetLastError());
}

// qd == nullptr: M⁻¹ only (md_minv_fused); else also q̈ = M⁻¹·(u − c)
template <typename T>
int minv(const void* consts, const void* q, const void* qd, const void* u,
         void* M, void* qdd, long long B, double gravity, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const T mg = static_cast<T>(-gravity);
  if (qd != nullptr) {
    if (u == nullptr || qdd == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    md_minv_kernel<T, true><<<blocks_for(B), kThreads, smem_bytes<T>(), s>>>(
        in<T>(consts), in<T>(q), in<T>(qd), in<T>(u), static_cast<T*>(M),
        static_cast<T*>(qdd), B, mg);
  } else {
    md_minv_kernel<T, false><<<blocks_for(B), kThreads, smem_bytes<T>(),
                               s>>>(in<T>(consts), in<T>(q), nullptr, nullptr,
                                    static_cast<T*>(M), nullptr, B, mg);
  }
  return static_cast<int>(cudaGetLastError());
}

// Minv == nullptr: the ∂ID blocks (∂c); else the fused finish (−M⁻¹·∂c)
template <typename T>
int grad_cols(const void* consts, const void* q, const void* qd,
              const void* v, const void* a, const void* f, const void* Minv,
              void* dq, void* dqd, long long B, int cb, double gravity,
              void* stream) {
  if (cb < 1 || cb > grid::MD_CB)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const dim3 grid_dim(blocks_for(B), (grid::NV + cb - 1) / cb);
  const T mg = static_cast<T>(-gravity);
  if (Minv != nullptr) {
    md_grad_cols_kernel<T, true><<<grid_dim, kThreads, smem_bytes<T>(), s>>>(
        in<T>(consts), in<T>(q), in<T>(qd), in<T>(v), in<T>(a), in<T>(f),
        in<T>(Minv), static_cast<T*>(dq), static_cast<T*>(dqd), B, cb, mg);
  } else {
    md_grad_cols_kernel<T, false><<<grid_dim, kThreads, smem_bytes<T>(),
                                    s>>>(
        in<T>(consts), in<T>(q), in<T>(qd), in<T>(v), in<T>(a), in<T>(f),
        nullptr, static_cast<T*>(dq), static_cast<T*>(dqd), B, cb, mg);
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

#define GRID_MD_STAGED_ENTRIES(T, tag)                                       \
  int grid_md_vaf_##tag(const void* consts, const void* q, const void* qd,   \
                        const void* qdd, void* v, void* a, void* f,          \
                        long long B, double gravity, void* stream) {         \
    return vaf<T>(consts, q, qd, qdd, v, a, f, B, gravity, stream);          \
  }                                                                          \
  int grid_md_minv_##tag(const void* consts, const void* q, const void* qd,  \
                         const void* u, void* M, void* qdd, long long B,     \
                         double gravity, void* stream) {                     \
    return minv<T>(consts, q, qd, u, M, qdd, B, gravity, stream);            \
  }                                                                          \
  int grid_md_grad_cols_##tag(const void* consts, const void* q,             \
                              const void* qd, const void* v, const void* a,  \
                              const void* f, const void* Minv, void* dq,     \
                              void* dqd, long long B, int cb,                \
                              double gravity, void* stream) {                \
    return grad_cols<T>(consts, q, qd, v, a, f, Minv, dq, dqd, B, cb,        \
                        gravity, stream);                                    \
  }

GRID_MD_STAGED_ENTRIES(float, f32)
GRID_MD_STAGED_ENTRIES(double, f64)

#undef GRID_MD_STAGED_ENTRIES

}  // extern "C"
