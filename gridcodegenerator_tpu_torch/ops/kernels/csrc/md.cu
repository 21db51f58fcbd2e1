// The multi-dof (ball and free joint) families, one thread per state.
//
// Replaces (gridcodegenerator_tpu/ops/kernels/multidof_fused.py):
//   md_id_fused      (multidof_fused.py:879) -> grid_md_rnea_{f32,f64}
//   md_aba_fused     (multidof_fused.py:377) -> grid_md_aba_{f32,f64}
//   md_id_grad_fused (multidof_fused.py:771) -> grid_md_id_grad_{f32,f64}
//   md_fd_grad_fused (multidof_fused.py:791) -> grid_md_fd_grad_{f32,f64}
//   md_fd_fused      (multidof_fused.py:894) -> grid_md_fd_{f32,f64}
// Each Pallas kernel ran its body on a VMEM tile of 128 states; here the
// same body (md.cuh) runs per thread on the batch-last layout at the
// boundary — q (nq, B), q̇, q̈, u (nv, B), outputs (nv[, nv], B) — so a
// warp's loads and stores are 32 consecutive addresses, and the ragged tail
// is masked with b < B instead of padded.
//
// The two gradient kernels hold the ∂v/∂a/∂f column tensors of every joint
// (18·n·nv values) and the (nv, nv) factor, ∂c and M⁻¹ per thread, in local
// memory; they are built only up to MAX_MD_GRAD_NV velocity coordinates
// (GRID_MD_GRADS=1, _build.py). RNEA and ABA are O(n) a state and are built
// for every robot, and so is the CRBA forward dynamics (md_fd: the nv×nv
// factor, no gradient frame). The robot constants (96·n + 2·nv values) are staged in
// shared memory once per block. Topology and joint types come in as -D
// macros (md.cuh); the kernels are templated on float and double so the
// card can hold them to the plain version at float64 round-off.
#include <cuda_runtime.h>

#include "md.cuh"

#ifndef GRID_MD_GRADS
#error "compile with -DGRID_MD_GRADS=0|1"
#endif

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
md_rnea_kernel(const T* __restrict__ consts, const T* __restrict__ q,
               const T* __restrict__ qd, const T* __restrict__ qdd,
               T* __restrict__ c, long long B, T minus_g) {
  const grid::MdRobot<T> R(stage_constants(consts));
  const long long b = state_index();
  if (b >= B) return;
  grid::md_rnea_state<T, kQdd>(R, q, qd, qdd, c, B, b, minus_g);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
md_aba_kernel(const T* __restrict__ consts, const T* __restrict__ q,
              const T* __restrict__ qd, const T* __restrict__ u,
              T* __restrict__ qdd, long long B, T minus_g) {
  const grid::MdRobot<T> R(stage_constants(consts));
  const long long b = state_index();
  if (b >= B) return;
  grid::md_aba_state(R, q, qd, u, qdd, B, b, minus_g);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
md_fd_kernel(const T* __restrict__ consts, const T* __restrict__ q,
             const T* __restrict__ qd, const T* __restrict__ u,
             T* __restrict__ qdd, long long B, T minus_g) {
  const grid::MdRobot<T> R(stage_constants(consts));
  const long long b = state_index();
  if (b >= B) return;
  grid::md_fd_state(R, q, qd, u, qdd, B, b, minus_g);
}

#if GRID_MD_GRADS
template <typename T, bool kQdd>
__global__ void __launch_bounds__(kThreads)
md_id_grad_kernel(const T* __restrict__ consts, const T* __restrict__ q,
                  const T* __restrict__ qd, const T* __restrict__ qdd,
                  T* __restrict__ dq, T* __restrict__ dqd, long long B,
                  T minus_g) {
  const grid::MdRobot<T> R(stage_constants(consts));
  const long long b = state_index();
  if (b >= B) return;
  grid::md_id_grad_state<T, kQdd>(R, q, qd, qdd, dq, dqd, B, b, minus_g);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
md_fd_grad_kernel(const T* __restrict__ consts, const T* __restrict__ q,
                  const T* __restrict__ qd, const T* __restrict__ u,
                  T* __restrict__ dq, T* __restrict__ dqd,
                  T* __restrict__ du, long long B, T minus_g) {
  const grid::MdRobot<T> R(stage_constants(consts));
  const long long b = state_index();
  if (b >= B) return;
  grid::md_fd_grad_state(R, q, qd, u, dq, dqd, du, B, b, minus_g);
}
#endif  // GRID_MD_GRADS

dim3 blocks_for(long long B) {
  return dim3(static_cast<unsigned>((B + kThreads - 1) / kThreads));
}

template <typename T>
size_t smem_bytes() {
  return grid::kMdConstCount * sizeof(T);
}

template <typename T>
const T* in(const void* p) {
  return static_cast<const T*>(p);
}

// qdd == nullptr is the bias-force variant (no S·q̈, no armature term)
template <typename T>
int rnea(const void* consts, const void* q, const void* qd, const void* qdd,
         void* c, long long B, double gravity, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (qdd != nullptr) {
    md_rnea_kernel<T, true><<<blocks_for(B), kThreads, smem_bytes<T>(), s>>>(
        in<T>(consts), in<T>(q), in<T>(qd), in<T>(qdd), static_cast<T*>(c),
        B, static_cast<T>(-gravity));
  } else {
    md_rnea_kernel<T, false><<<blocks_for(B), kThreads, smem_bytes<T>(), s>>>(
        in<T>(consts), in<T>(q), in<T>(qd), nullptr, static_cast<T*>(c), B,
        static_cast<T>(-gravity));
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int aba(const void* consts, const void* q, const void* qd, const void* u,
        void* qdd, long long B, double gravity, void* stream) {
  md_aba_kernel<T><<<blocks_for(B), kThreads, smem_bytes<T>(),
                     static_cast<cudaStream_t>(stream)>>>(
      in<T>(consts), in<T>(q), in<T>(qd), in<T>(u), static_cast<T*>(qdd), B,
      static_cast<T>(-gravity));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int fd(const void* consts, const void* q, const void* qd, const void* u,
       void* qdd, long long B, double gravity, void* stream) {
  md_fd_kernel<T><<<blocks_for(B), kThreads, smem_bytes<T>(),
                    static_cast<cudaStream_t>(stream)>>>(
      in<T>(consts), in<T>(q), in<T>(qd), in<T>(u), static_cast<T*>(qdd), B,
      static_cast<T>(-gravity));
  return static_cast<int>(cudaGetLastError());
}

#if GRID_MD_GRADS
// qdd == nullptr takes the gradient at q̈ = 0 (no S·q̈ in the sweep)
template <typename T>
int id_grad(const void* consts, const void* q, const void* qd,
            const void* qdd, void* dq, void* dqd, long long B, double gravity,
            void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (qdd != nullptr) {
    md_id_grad_kernel<T, true><<<blocks_for(B), kThreads, smem_bytes<T>(),
                                 s>>>(
        in<T>(consts), in<T>(q), in<T>(qd), in<T>(qdd), static_cast<T*>(dq),
        static_cast<T*>(dqd), B, static_cast<T>(-gravity));
  } else {
    md_id_grad_kernel<T, false><<<blocks_for(B), kThreads, smem_bytes<T>(),
                                  s>>>(
        in<T>(consts), in<T>(q), in<T>(qd), nullptr, static_cast<T*>(dq),
        static_cast<T*>(dqd), B, static_cast<T>(-gravity));
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int fd_grad(const void* consts, const void* q, const void* qd, const void* u,
            void* dq, void* dqd, void* du, long long B, double gravity,
            void* stream) {
  md_fd_grad_kernel<T><<<blocks_for(B), kThreads, smem_bytes<T>(),
                         static_cast<cudaStream_t>(stream)>>>(
      in<T>(consts), in<T>(q), in<T>(qd), in<T>(u), static_cast<T*>(dq),
      static_cast<T*>(dqd), static_cast<T*>(du), B,
      static_cast<T>(-gravity));
  return static_cast<int>(cudaGetLastError());
}
#endif  // GRID_MD_GRADS

}  // namespace

// Plain C interface for ctypes (ops/kernels/_build.py declares the argtypes).
// Every entry launches on the given stream, does not synchronise, and
// returns cudaGetLastError() of the launch.
extern "C" {

int grid_num_joints() { return grid::N; }

const char* grid_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int grid_md_rnea_f32(const void* consts, const void* q, const void* qd,
                     const void* qdd, void* c, long long B, double gravity,
                     void* stream) {
  return rnea<float>(consts, q, qd, qdd, c, B, gravity, stream);
}
int grid_md_rnea_f64(const void* consts, const void* q, const void* qd,
                     const void* qdd, void* c, long long B, double gravity,
                     void* stream) {
  return rnea<double>(consts, q, qd, qdd, c, B, gravity, stream);
}

int grid_md_aba_f32(const void* consts, const void* q, const void* qd,
                    const void* u, void* qdd, long long B, double gravity,
                    void* stream) {
  return aba<float>(consts, q, qd, u, qdd, B, gravity, stream);
}
int grid_md_aba_f64(const void* consts, const void* q, const void* qd,
                    const void* u, void* qdd, long long B, double gravity,
                    void* stream) {
  return aba<double>(consts, q, qd, u, qdd, B, gravity, stream);
}

int grid_md_fd_f32(const void* consts, const void* q, const void* qd,
                   const void* u, void* qdd, long long B, double gravity,
                   void* stream) {
  return fd<float>(consts, q, qd, u, qdd, B, gravity, stream);
}
int grid_md_fd_f64(const void* consts, const void* q, const void* qd,
                   const void* u, void* qdd, long long B, double gravity,
                   void* stream) {
  return fd<double>(consts, q, qd, u, qdd, B, gravity, stream);
}

#if GRID_MD_GRADS
int grid_md_id_grad_f32(const void* consts, const void* q, const void* qd,
                        const void* qdd, void* dq, void* dqd, long long B,
                        double gravity, void* stream) {
  return id_grad<float>(consts, q, qd, qdd, dq, dqd, B, gravity, stream);
}
int grid_md_id_grad_f64(const void* consts, const void* q, const void* qd,
                        const void* qdd, void* dq, void* dqd, long long B,
                        double gravity, void* stream) {
  return id_grad<double>(consts, q, qd, qdd, dq, dqd, B, gravity, stream);
}

int grid_md_fd_grad_f32(const void* consts, const void* q, const void* qd,
                        const void* u, void* dq, void* dqd, void* du,
                        long long B, double gravity, void* stream) {
  return fd_grad<float>(consts, q, qd, u, dq, dqd, du, B, gravity, stream);
}
int grid_md_fd_grad_f64(const void* consts, const void* q, const void* qd,
                        const void* u, void* dq, void* dqd, void* du,
                        long long B, double gravity, void* stream) {
  return fd_grad<double>(consts, q, qd, u, dq, dqd, du, B, gravity, stream);
}
#endif  // GRID_MD_GRADS

}  // extern "C"
