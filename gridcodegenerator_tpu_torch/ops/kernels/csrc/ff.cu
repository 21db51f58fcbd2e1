// The floating-base (free-flyer) families, one thread per state.
//
// Replaces (gridcodegenerator_tpu/ops/kernels/contact_fused.py):
//   fb_aba_fused    (contact_fused.py:1413) -> grid_fb_aba_{f32,f64}
//   fb_fd_fused     (contact_fused.py:1329) -> grid_fb_fd_{f32,f64}
//   stance_fd_fused (contact_fused.py:1431) -> grid_stance_fd_{f32,f64}
// Each Pallas kernel ran its body on a VMEM tile of 128 states, and robots
// past the tile's budget fell back to plain XLA (_xla_fallback,
// ff_workset_ok). Here the same bodies (ff.cuh) run per thread on the
// batch-last layout at the boundary — quat (4, B), pos (3, B), q, q̇, τ
// (n, B), vb (6, B); outputs v̇b (6, B), q̈ (n, B), λ (3k, B) — for every
// robot, so a warp's loads and stores are 32 consecutive addresses, and the
// ragged tail is masked with b < B instead of padded.
//
// What bounds them: the per-state arrays in local memory. ABA keeps ≈ 100n
// values (X, the articulated inertias, six 6-vectors a joint); the mass-matrix
// FD X, the composite inertias (72n) and the lower triangle of the (6+n)²
// matrix (595 values at free Atlas); the stance FD adds the contact rows
// (3 rows a contact over its chain's 6 + depth columns only), the merged
// solve's (6+n) × (3k+1) right-hand sides and the Delassus triangle, and
// recomputes the chains' rows on dual numbers for the bias. The robot
// constants (152n + 36 values) are staged in shared memory once per block.
//
// A library is built per topology: with -DGRID_FF_K=0 it holds the ABA and
// mass-matrix kernels, with the contact links (-DGRID_FF_K=k
// -DGRID_FF_LINKS=...) the stance kernel of those links alone.
#include <cuda_runtime.h>

#include "ff.cuh"

namespace {

constexpr int kThreads = 128;

static_assert(grid::kFfConstCount * sizeof(double) <= 48 * 1024,
              "robot constants exceed 48 KB of shared memory");

template <typename T>
__device__ __forceinline__ const T* stage_constants(const T* __restrict__ g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  for (int k = threadIdx.x; k < grid::kFfConstCount; k += blockDim.x)
    sm[k] = g[k];
  __syncthreads();
  return sm;
}

__device__ __forceinline__ long long state_index() {
  return static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
}

dim3 blocks_for(long long B) {
  return dim3(static_cast<unsigned>((B + kThreads - 1) / kThreads));
}

template <typename T>
size_t smem_bytes() {
  return grid::kFfConstCount * sizeof(T);
}

template <typename T>
const T* in(const void* p) {
  return static_cast<const T*>(p);
}

#if GRID_FF_K == 0
template <typename T>
__global__ void __launch_bounds__(kThreads)
fb_aba_kernel(const T* __restrict__ consts, const T* __restrict__ quat,
              const T* __restrict__ q, const T* __restrict__ vb,
              const T* __restrict__ qd, const T* __restrict__ tau,
              T* __restrict__ dvb, T* __restrict__ qdd, long long B,
              T minus_g) {
  const T* sm = stage_constants(consts);
  const grid::Robot<T> R(sm);
  const long long b = state_index();
  if (b >= B) return;
  grid::fb_aba_state(R, sm + 152 * grid::N, quat, q, vb, qd, tau, dvb, qdd,
                     B, b, minus_g);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fb_fd_kernel(const T* __restrict__ consts, const T* __restrict__ quat,
             const T* __restrict__ q, const T* __restrict__ vb,
             const T* __restrict__ qd, const T* __restrict__ tau,
             T* __restrict__ dvb, T* __restrict__ qdd, long long B,
             T minus_g) {
  const T* sm = stage_constants(consts);
  const grid::Robot<T> R(sm);
  const long long b = state_index();
  if (b >= B) return;
  grid::fb_fd_state(R, sm + 152 * grid::N, quat, q, vb, qd, tau, dvb, qdd, B,
                    b, minus_g);
}

template <typename T, bool kAba>
int fb(const void* consts, const void* quat, const void* q, const void* vb,
       const void* qd, const void* tau, void* dvb, void* qdd, long long B,
       double gravity, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (kAba) {
    fb_aba_kernel<T><<<blocks_for(B), kThreads, smem_bytes<T>(), s>>>(
        in<T>(consts), in<T>(quat), in<T>(q), in<T>(vb), in<T>(qd),
        in<T>(tau), static_cast<T*>(dvb), static_cast<T*>(qdd), B,
        static_cast<T>(-gravity));
  } else {
    fb_fd_kernel<T><<<blocks_for(B), kThreads, smem_bytes<T>(), s>>>(
        in<T>(consts), in<T>(quat), in<T>(q), in<T>(vb), in<T>(qd),
        in<T>(tau), static_cast<T*>(dvb), static_cast<T*>(qdd), B,
        static_cast<T>(-gravity));
  }
  return static_cast<int>(cudaGetLastError());
}
#else
template <typename T>
__global__ void __launch_bounds__(kThreads)
stance_fd_kernel(const T* __restrict__ consts, const T* __restrict__ quat,
                 const T* __restrict__ pos, const T* __restrict__ q,
                 const T* __restrict__ vb, const T* __restrict__ qd,
                 const T* __restrict__ tau, const T* __restrict__ off,
                 const T* __restrict__ anc, T* __restrict__ dvb,
                 T* __restrict__ qdd, T* __restrict__ lam, long long B,
                 T minus_g, double alpha, double beta, double reg) {
  const T* sm = stage_constants(consts);
  const grid::Robot<T> R(sm);
  const long long b = state_index();
  if (b >= B) return;
  grid::stance_state(R, sm + 152 * grid::N, quat, pos, q, vb, qd, tau, off,
                     anc, dvb, qdd, lam, B, b, minus_g, alpha, beta, reg);
}

// anchors == nullptr pins each point where it is (no β term)
template <typename T>
int stance(const void* consts, const void* quat, const void* pos,
           const void* q, const void* vb, const void* qd, const void* tau,
           const void* off, const void* anc, void* dvb, void* qdd, void* lam,
           long long B, double gravity, double alpha, double beta,
           double reg, void* stream) {
  stance_fd_kernel<T><<<blocks_for(B), kThreads, smem_bytes<T>(),
                        static_cast<cudaStream_t>(stream)>>>(
      in<T>(consts), in<T>(quat), in<T>(pos), in<T>(q), in<T>(vb),
      in<T>(qd), in<T>(tau), in<T>(off), in<T>(anc), static_cast<T*>(dvb),
      static_cast<T*>(qdd), static_cast<T*>(lam), B,
      static_cast<T>(-gravity), alpha, beta, reg);
  return static_cast<int>(cudaGetLastError());
}
#endif  // GRID_FF_K

}  // namespace

// Plain C interface for ctypes (ops/kernels/_build.py declares the argtypes).
// Every entry launches on the given stream, does not synchronise, and
// returns cudaGetLastError() of the launch.
extern "C" {

int grid_num_joints() { return grid::N; }

const char* grid_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

#if GRID_FF_K == 0
int grid_fb_aba_f32(const void* consts, const void* quat, const void* q,
                    const void* vb, const void* qd, const void* tau,
                    void* dvb, void* qdd, long long B, double gravity,
                    void* stream) {
  return fb<float, true>(consts, quat, q, vb, qd, tau, dvb, qdd, B, gravity,
                         stream);
}
int grid_fb_aba_f64(const void* consts, const void* quat, const void* q,
                    const void* vb, const void* qd, const void* tau,
                    void* dvb, void* qdd, long long B, double gravity,
                    void* stream) {
  return fb<double, true>(consts, quat, q, vb, qd, tau, dvb, qdd, B, gravity,
                          stream);
}

int grid_fb_fd_f32(const void* consts, const void* quat, const void* q,
                   const void* vb, const void* qd, const void* tau,
                   void* dvb, void* qdd, long long B, double gravity,
                   void* stream) {
  return fb<float, false>(consts, quat, q, vb, qd, tau, dvb, qdd, B, gravity,
                          stream);
}
int grid_fb_fd_f64(const void* consts, const void* quat, const void* q,
                   const void* vb, const void* qd, const void* tau,
                   void* dvb, void* qdd, long long B, double gravity,
                   void* stream) {
  return fb<double, false>(consts, quat, q, vb, qd, tau, dvb, qdd, B,
                           gravity, stream);
}
#else
int grid_stance_fd_f32(const void* consts, const void* quat, const void* pos,
                       const void* q, const void* vb, const void* qd,
                       const void* tau, const void* off, const void* anc,
                       void* dvb, void* qdd, void* lam, long long B,
                       double gravity, double alpha, double beta, double reg,
                       void* stream) {
  return stance<float>(consts, quat, pos, q, vb, qd, tau, off, anc, dvb, qdd,
                       lam, B, gravity, alpha, beta, reg, stream);
}
int grid_stance_fd_f64(const void* consts, const void* quat, const void* pos,
                       const void* q, const void* vb, const void* qd,
                       const void* tau, const void* off, const void* anc,
                       void* dvb, void* qdd, void* lam, long long B,
                       double gravity, double alpha, double beta, double reg,
                       void* stream) {
  return stance<double>(consts, quat, pos, q, vb, qd, tau, off, anc, dvb,
                        qdd, lam, B, gravity, alpha, beta, reg, stream);
}
#endif  // GRID_FF_K

}  // extern "C"
