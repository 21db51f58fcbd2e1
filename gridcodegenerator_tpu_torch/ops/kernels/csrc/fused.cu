// The single-kernel first-order families of the port, one thread per state.
//
// Replaces (gridcodegenerator_tpu/ops/kernels/fused.py):
//   fd_grad_fused          (fused.py:394)  -> grid_fd_grad_{f32,f64}
//                                     (a CTA tile, tile.cuh fd_grad_tile;
//                                     the one-thread kernel it replaced:
//                                     grid_fd_grad_thread_{f32,f64})
//   id_grad_fused          (fused.py:433)  -> grid_id_grad_{f32,f64}
//   minv_fused, one tile   (fused.py:290)  -> grid_minv_{f32,f64}
//   inverse_dynamics_fused (fused.py:270)  -> grid_rnea_{f32,f64}
//   forward_dynamics_aba_fused (fused.py:357) -> grid_aba_{f32,f64}
//   fd_grad_fused, minv_impl="dense" (fused.py:394, :387)
//                                        -> grid_fd_grad_dense_{f32,f64}
//   forward_dynamics_fused, one tile (fused.py:326) -> grid_fd_{f32,f64}
// The two ∇FD kernels and ∂ID hold O(n²) values a state and are built only
// for robots of at most MAX_KERNEL_JOINTS joints (GRID_DENSE_GRADS=1,
// _build.py); larger robots take the staged kernels of staged.cu. M⁻¹ and
// the composition FD (≈ 7n² values) are built for every robot, though the
// routing sends robots past that limit to the staged K2′ and factor-solve
// kernels (the one-thread versions stay timeable there, as the JAX
// benchmarks time the lane-tile ones); RNEA and ABA are O(n) a state.
// Each Pallas kernel ran its blops body on a VMEM tile of (8·k, 128) states;
// here the same body (rbd.cuh) runs per thread, one state per thread, on
// the (n, B) batch-last layout at the boundary: a warp's loads of q[i·B + b]
// and stores of out[(r·n + c)·B + b] are 32 consecutive addresses, and the
// ragged tail is masked with b < B instead of padded.
//
// What bounds it on an H100: not DRAM (≈ 3n inputs and 2n² outputs per
// state) but the per-state working set. ∇FD keeps X (36n), v/a/f (18n), the
// M⁻¹ recursion's IA/F (36n + 6n²) and one side's ∂v/∂a/∂f (18n²) live:
// ptxas gives it a 5.7 KB (float32) stack frame a thread at n = 7, far
// beyond 255 registers, so the per-state arrays sit in local memory
// (L1/L2-cached) and the kernel is bound by that traffic. This first
// version accepts it and keeps the traffic down where that is simple: the
// q and q̇ sides run one after the other (only one side's ∂-tensors live),
// the structurally zero columns of ∂v/∂a are skipped (ancestor sparsity),
// and the robot constants (152·n values) are staged in shared memory once
// per block, where every thread of a warp reads the same address. Joint
// and column loops stay rolled (rbd.cuh), which keeps nvcc to seconds and
// ptxas free of spills; ptxas's report is printed at build time
// (_build.py). The recursion ∇FD runs as a CTA tile instead (tile.cuh,
// fd_grad_tile): a tile of states a CTA, each state's X, v, a, f, the M⁻¹
// recursion's IA, F, U, D⁻¹ and both sides' packed ∂-tensors in shared
// memory for the whole body, the CTA's threads over each phase's items.
//
// Robot topology comes in as -D macros (see rbd.cuh); the kernels are
// templated on float and double so the card can hold them to the plain
// version at float64 round-off. No fast-math: sincos/sincosf are the
// accurate library calls.
#include <cuda_runtime.h>

#include "aba.cuh"
#include "rbd.cuh"
// crba, chol_minv (staged.cuh): the dense M⁻¹ of minv_impl="dense"; the
// recursion ∇FD's CTA tile
#include "tile.cuh"

#ifndef GRID_DENSE_GRADS
#error "compile with -DGRID_DENSE_GRADS=0|1"
#endif

namespace {

constexpr int kThreads = 128;

// 152·n constants a robot; above the 48 KB a block gets without opting in,
// the build fails here rather than at launch.
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

#if GRID_DENSE_GRADS
// the recursion ∇FD as a CTA tile (tile.cuh, fd_grad_tile): the robot
// constants, the tile, then K5's and the sweeps' tables in shared memory
template <typename T>
__global__ void __launch_bounds__(grid::fd_threads<T>(), GRID_TILE_CTAS)
fd_grad_tile_kernel(const T* __restrict__ consts, const T* __restrict__ q,
                    const T* __restrict__ qd, const T* __restrict__ u,
                    T* __restrict__ ddq, T* __restrict__ ddqd, long long B,
                    T minus_g) {
  constexpr int S = grid::fd_states<T>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  short* t5 = reinterpret_cast<short*>(sm + grid::kConstCount +
                                       S * grid::kFdStride);
  short* tr = t5 + (grid::kK5Table + 7) / 8 * 8;
  for (int k = threadIdx.x; k < grid::kConstCount; k += blockDim.x)
    sm[k] = consts[k];
  for (int k = threadIdx.x; k < grid::kK5Table; k += blockDim.x)
    t5[k] = grid::c_k5_table[k];
  for (int k = threadIdx.x; k < grid::kRnTable; k += blockDim.x)
    tr[k] = grid::c_rn_table[k];
  __syncthreads();
  const grid::Robot<T> R(sm);
  grid::fd_grad_tile<T, S, grid::fd_threads<T>()>(
      static_cast<int>(threadIdx.x), R, grid::K5Tables(t5),
      grid::RnTables(tr), sm + grid::kConstCount, q, qd, u, ddq, ddqd, B,
      static_cast<long long>(blockIdx.x) * S, minus_g);
}

template <typename T, bool kDense>
__global__ void __launch_bounds__(kThreads)
fd_grad_kernel(const T* __restrict__ consts, const T* __restrict__ q,
               const T* __restrict__ qd, const T* __restrict__ u,
               T* __restrict__ ddq, T* __restrict__ ddqd, long long B,
               T minus_g) {
  const grid::Robot<T> R(stage_constants(consts));
  const long long b = state_index();
  if (b >= B) return;
  grid::fd_grad_state<T, kDense>(R, q, qd, u, ddq, ddqd, B, b, minus_g);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
id_grad_kernel(const T* __restrict__ consts, const T* __restrict__ q,
               const T* __restrict__ qd, const T* __restrict__ qdd,
               T* __restrict__ dq, T* __restrict__ dqd, long long B,
               T minus_g) {
  const grid::Robot<T> R(stage_constants(consts));
  const long long b = state_index();
  if (b >= B) return;
  grid::id_grad_state(R, q, qd, qdd, dq, dqd, B, b, minus_g);
}

#endif  // GRID_DENSE_GRADS

template <typename T>
__global__ void __launch_bounds__(kThreads)
minv_kernel(const T* __restrict__ consts, const T* __restrict__ q,
            T* __restrict__ M, long long B) {
  const grid::Robot<T> R(stage_constants(consts));
  const long long b = state_index();
  if (b >= B) return;
  grid::minv_state(R, q, M, B, b);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fd_kernel(const T* __restrict__ consts, const T* __restrict__ q,
          const T* __restrict__ qd, const T* __restrict__ u,
          T* __restrict__ qdd, long long B, T minus_g) {
  const grid::Robot<T> R(stage_constants(consts));
  const long long b = state_index();
  if (b >= B) return;
  grid::fd_state(R, q, qd, u, qdd, B, b, minus_g);
}

template <typename T, bool kQdd>
__global__ void __launch_bounds__(kThreads)
rnea_kernel(const T* __restrict__ consts, const T* __restrict__ q,
            const T* __restrict__ qd, const T* __restrict__ qdd,
            T* __restrict__ c, long long B, T minus_g) {
  const grid::Robot<T> R(stage_constants(consts));
  const long long b = state_index();
  if (b >= B) return;
  grid::rnea_state<T, kQdd>(R, q, qd, qdd, c, B, b, minus_g);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
aba_kernel(const T* __restrict__ consts, const T* __restrict__ q,
           const T* __restrict__ qd, const T* __restrict__ u,
           T* __restrict__ qdd, long long B, T minus_g) {
  const grid::Robot<T> R(stage_constants(consts));
  const long long b = state_index();
  if (b >= B) return;
  grid::aba_state(R, q, qd, u, qdd, B, b, minus_g);
}

dim3 blocks_for(long long B) {
  return dim3(static_cast<unsigned>((B + kThreads - 1) / kThreads));
}

template <typename T>
size_t smem_bytes() {
  return grid::kConstCount * sizeof(T);
}

#if GRID_DENSE_GRADS
// the recursion ∇FD tile; a dtype whose tile does not fit a CTA's shared
// memory (states 0 in the plan) is refused
template <typename T>
int fd_grad_tile(const void* consts, const void* q, const void* qd,
                 const void* u, void* ddq, void* ddqd, long long B,
                 double gravity, void* stream) {
  constexpr int S = grid::fd_states<T>();
  if constexpr (S > 0) {
    const size_t smem =
        grid::tile_smem<T>(S, grid::kFdStride, grid::kK5Table) +
        (2 * static_cast<size_t>(grid::kRnTable) + 15) / 16 * 16;
    auto kernel = fd_grad_tile_kernel<T>;
    cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
    const unsigned blocks = static_cast<unsigned>((B + S - 1) / S);
    kernel<<<blocks, grid::fd_threads<T>(), smem,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(consts), static_cast<const T*>(q),
        static_cast<const T*>(qd), static_cast<const T*>(u),
        static_cast<T*>(ddq), static_cast<T*>(ddqd), B,
        static_cast<T>(-gravity));
    return static_cast<int>(cudaGetLastError());
  } else {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
}

template <typename T, bool kDense>
int fd_grad(const void* consts, const void* q, const void* qd, const void* u,
            void* ddq, void* ddqd, long long B, double gravity,
            void* stream) {
  fd_grad_kernel<T, kDense><<<blocks_for(B), kThreads, smem_bytes<T>(),
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(consts), static_cast<const T*>(q),
      static_cast<const T*>(qd), static_cast<const T*>(u),
      static_cast<T*>(ddq), static_cast<T*>(ddqd), B,
      static_cast<T>(-gravity));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int id_grad(const void* consts, const void* q, const void* qd,
            const void* qdd, void* dq, void* dqd, long long B, double gravity,
            void* stream) {
  id_grad_kernel<T><<<blocks_for(B), kThreads, smem_bytes<T>(),
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(consts), static_cast<const T*>(q),
      static_cast<const T*>(qd), static_cast<const T*>(qdd),
      static_cast<T*>(dq), static_cast<T*>(dqd), B,
      static_cast<T>(-gravity));
  return static_cast<int>(cudaGetLastError());
}

#endif  // GRID_DENSE_GRADS

template <typename T>
int minv(const void* consts, const void* q, void* M, long long B,
         void* stream) {
  minv_kernel<T><<<blocks_for(B), kThreads, smem_bytes<T>(),
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(consts), static_cast<const T*>(q),
      static_cast<T*>(M), B);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_fd(const void* consts, const void* q, const void* qd,
              const void* u, void* qdd, long long B, double gravity,
              void* stream) {
  fd_kernel<T><<<blocks_for(B), kThreads, smem_bytes<T>(),
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(consts), static_cast<const T*>(q),
      static_cast<const T*>(qd), static_cast<const T*>(u),
      static_cast<T*>(qdd), B, static_cast<T>(-gravity));
  return static_cast<int>(cudaGetLastError());
}

// qdd == nullptr is the bias-force variant (no S·q̈, no armature term)
template <typename T>
int rnea(const void* consts, const void* q, const void* qd, const void* qdd,
         void* c, long long B, double gravity, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const T* k = static_cast<const T*>(consts);
  if (qdd != nullptr) {
    rnea_kernel<T, true><<<blocks_for(B), kThreads, smem_bytes<T>(), s>>>(
        k, static_cast<const T*>(q), static_cast<const T*>(qd),
        static_cast<const T*>(qdd), static_cast<T*>(c), B,
        static_cast<T>(-gravity));
  } else {
    rnea_kernel<T, false><<<blocks_for(B), kThreads, smem_bytes<T>(), s>>>(
        k, static_cast<const T*>(q), static_cast<const T*>(qd), nullptr,
        static_cast<T*>(c), B, static_cast<T>(-gravity));
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_aba(const void* consts, const void* q, const void* qd,
               const void* u, void* qdd, long long B, double gravity,
               void* stream) {
  aba_kernel<T><<<blocks_for(B), kThreads, smem_bytes<T>(),
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(consts), static_cast<const T*>(q),
      static_cast<const T*>(qd), static_cast<const T*>(u),
      static_cast<T*>(qdd), B, static_cast<T>(-gravity));
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

#if GRID_DENSE_GRADS
int grid_fd_grad_f32(const void* consts, const void* q, const void* qd,
                     const void* u, void* ddq, void* ddqd, long long B,
                     double gravity, void* stream) {
  return fd_grad_tile<float>(consts, q, qd, u, ddq, ddqd, B, gravity,
                             stream);
}
int grid_fd_grad_f64(const void* consts, const void* q, const void* qd,
                     const void* u, void* ddq, void* ddqd, long long B,
                     double gravity, void* stream) {
  return fd_grad_tile<double>(consts, q, qd, u, ddq, ddqd, B, gravity,
                              stream);
}
// the one-thread recursion ∇FD the tile replaced (a timed arm)
int grid_fd_grad_thread_f32(const void* consts, const void* q,
                            const void* qd, const void* u, void* ddq,
                            void* ddqd, long long B, double gravity,
                            void* stream) {
  return fd_grad<float, false>(consts, q, qd, u, ddq, ddqd, B, gravity,
                               stream);
}
int grid_fd_grad_thread_f64(const void* consts, const void* q,
                            const void* qd, const void* u, void* ddq,
                            void* ddqd, long long B, double gravity,
                            void* stream) {
  return fd_grad<double, false>(consts, q, qd, u, ddq, ddqd, B, gravity,
                                stream);
}
int grid_fd_grad_dense_f32(const void* consts, const void* q, const void* qd,
                           const void* u, void* ddq, void* ddqd, long long B,
                           double gravity, void* stream) {
  return fd_grad<float, true>(consts, q, qd, u, ddq, ddqd, B, gravity,
                              stream);
}
int grid_fd_grad_dense_f64(const void* consts, const void* q, const void* qd,
                           const void* u, void* ddq, void* ddqd, long long B,
                           double gravity, void* stream) {
  return fd_grad<double, true>(consts, q, qd, u, ddq, ddqd, B, gravity,
                               stream);
}

int grid_id_grad_f32(const void* consts, const void* q, const void* qd,
                     const void* qdd, void* dq, void* dqd, long long B,
                     double gravity, void* stream) {
  return id_grad<float>(consts, q, qd, qdd, dq, dqd, B, gravity, stream);
}
int grid_id_grad_f64(const void* consts, const void* q, const void* qd,
                     const void* qdd, void* dq, void* dqd, long long B,
                     double gravity, void* stream) {
  return id_grad<double>(consts, q, qd, qdd, dq, dqd, B, gravity, stream);
}

#endif  // GRID_DENSE_GRADS

int grid_minv_f32(const void* consts, const void* q, void* M, long long B,
                  void* stream) {
  return minv<float>(consts, q, M, B, stream);
}
int grid_minv_f64(const void* consts, const void* q, void* M, long long B,
                  void* stream) {
  return minv<double>(consts, q, M, B, stream);
}

int grid_fd_f32(const void* consts, const void* q, const void* qd,
                const void* u, void* qdd, long long B, double gravity,
                void* stream) {
  return launch_fd<float>(consts, q, qd, u, qdd, B, gravity, stream);
}
int grid_fd_f64(const void* consts, const void* q, const void* qd,
                const void* u, void* qdd, long long B, double gravity,
                void* stream) {
  return launch_fd<double>(consts, q, qd, u, qdd, B, gravity, stream);
}

int grid_rnea_f32(const void* consts, const void* q, const void* qd,
                  const void* qdd, void* c, long long B, double gravity,
                  void* stream) {
  return rnea<float>(consts, q, qd, qdd, c, B, gravity, stream);
}
int grid_rnea_f64(const void* consts, const void* q, const void* qd,
                  const void* qdd, void* c, long long B, double gravity,
                  void* stream) {
  return rnea<double>(consts, q, qd, qdd, c, B, gravity, stream);
}

int grid_aba_f32(const void* consts, const void* q, const void* qd,
                 const void* u, void* qdd, long long B, double gravity,
                 void* stream) {
  return launch_aba<float>(consts, q, qd, u, qdd, B, gravity, stream);
}
int grid_aba_f64(const void* consts, const void* q, const void* qd,
                 const void* u, void* qdd, long long B, double gravity,
                 void* stream) {
  return launch_aba<double>(consts, q, qd, u, qdd, B, gravity, stream);
}

}  // extern "C"
