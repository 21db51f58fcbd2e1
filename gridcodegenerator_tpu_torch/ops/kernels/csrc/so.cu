// The second-order kernels of the port: one thread per (state, direction).
//
// Replaces (gridcodegenerator_tpu/ops/kernels/):
//   so_fused.py:195 fd_hessian_vp_fused -> grid_hessian_{f32,f64}, lam given
//   so_fused.py:220 fd_hessian_fused    -> grid_hessian_{f32,f64}, lam NULL
//   so_staged.py:212 fd_hessian_vp_staged, its tangent stages
//                                       -> grid_t1/_t2/_t4/_t5_{f32,f64}
// On the TPU each direction of a Pallas grid axis ran the primal ∇FD
// pipeline plus one jax.jvp sweep on a VMEM tile. Here the direction is
// blockIdx.y: a thread seeds one coordinate tangent and runs the same
// bodies (rbd.cuh, staged.cuh) on dual numbers (dual.cuh), so the primal is
// recomputed per direction exactly as the TPU kernel chose to (so_fused.py:
// 23-34), and only tangents are written. Blocks of one direction are
// consecutive states, so a warp's stores are 32 consecutive addresses.
//
// What bounds them on an H100: as for fused.cu, the per-state working set
// in local memory, now doubled (a value and a tangent for each of the ∇FD
// body's ≈ 28·n² values), not DRAM: the full tensor writes 3n² values a
// state for each of 3n directions, λᵀ·H 3n. The staged T-stages hold O(n)
// dual values (T5: 36·n·SO_CB + O(n)), read their primal inputs once a
// direction (re-read from L2 across directions) and write O(n) values.
// The u-directions of the single-thread kernel carry zero tangents through
// X, v, c and M⁻¹; skipping that arithmetic is later work.
#include <cuda_runtime.h>

#include "so.cuh"

#ifndef GRID_DENSE_HESSIAN
#error "compile with -DGRID_DENSE_HESSIAN=0|1"
#endif

namespace {

constexpr int kThreads = 128;

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

#if GRID_DENSE_HESSIAN
template <typename T, bool kLam>
__global__ void __launch_bounds__(kThreads)
hessian_kernel(const T* __restrict__ consts, const T* __restrict__ q,
               const T* __restrict__ qd, const T* __restrict__ u,
               const T* __restrict__ lam, T* __restrict__ out, long long B,
               T minus_g) {
  const grid::Robot<T> R(stage_constants(consts));
  const long long b = state_index();
  if (b >= B) return;
  grid::hessian_state<T, kLam>(R, q, qd, u, lam, out, B, b,
                               static_cast<int>(blockIdx.y), minus_g);
}
#endif  // GRID_DENSE_HESSIAN

template <typename T>
__global__ void __launch_bounds__(kThreads)
t1_kernel(const T* __restrict__ consts, const T* __restrict__ q,
          const T* __restrict__ qd, T* __restrict__ dc, T* __restrict__ dv,
          long long B, int which, T minus_g) {
  const grid::Robot<T> R(stage_constants(consts));
  const long long b = state_index();
  if (b >= B) return;
  grid::t1_state(R, q, qd, dc, dv, B, b, static_cast<int>(blockIdx.y), which,
                 minus_g);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
t2_kernel(const T* __restrict__ consts, const T* __restrict__ q,
          const T* __restrict__ lamM, const T* __restrict__ qdd,
          const T* __restrict__ Minv, const T* __restrict__ dc,
          T* __restrict__ dlamM, T* __restrict__ dqdd, long long B) {
  const grid::Robot<T> R(stage_constants(consts));
  const long long b = state_index();
  if (b >= B) return;
  grid::t2_state(R, q, lamM, qdd, Minv, dc, dlamM, dqdd, B, b,
                 static_cast<int>(blockIdx.y));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
t4_kernel(const T* __restrict__ consts, const T* __restrict__ q,
          const T* __restrict__ qd, const T* __restrict__ qdd,
          const T* __restrict__ v, const T* __restrict__ dv,
          const T* __restrict__ dqdd, T* __restrict__ da,
          T* __restrict__ df, long long B, int which, T minus_g) {
  const grid::Robot<T> R(stage_constants(consts));
  const long long b = state_index();
  if (b >= B) return;
  grid::t4_state(R, q, qd, qdd, v, dv, dqdd, da, df, B, b,
                 static_cast<int>(blockIdx.y), which, minus_g);
}

template <typename T, bool kQ>
__global__ void __launch_bounds__(kThreads)
t5_kernel(const T* __restrict__ consts, const T* __restrict__ q,
          const T* __restrict__ qd, const T* __restrict__ v,
          const T* __restrict__ a, const T* __restrict__ f,
          const T* __restrict__ lamM, const T* __restrict__ dv,
          const T* __restrict__ da, const T* __restrict__ df,
          T* __restrict__ out, long long B, int which, int cb, T minus_g) {
  const grid::Robot<T> R(stage_constants(consts));
  const long long b = state_index();
  if (b >= B) return;
  const int c0 = static_cast<int>(blockIdx.z) * cb;
  const int w = grid::N - c0 < cb ? grid::N - c0 : cb;
  grid::t5_state<T, kQ>(R, q, qd, v, a, f, lamM, dv, da, df, out, B, b,
                        static_cast<int>(blockIdx.y), which, c0, w, minus_g);
}

unsigned blocks_for(long long B) {
  return static_cast<unsigned>((B + kThreads - 1) / kThreads);
}

template <typename T>
size_t smem_bytes() {
  return grid::kConstCount * sizeof(T);
}

template <typename T>
const T* in(const void* p) {
  return static_cast<const T*>(p);
}

template <typename T>
T* out(void* p) {
  return static_cast<T*>(p);
}

#if GRID_DENSE_HESSIAN
// lam == nullptr: the full tensor (n, 3n, 3n, B); else λᵀ·H (3n, 3n, B)
template <typename T>
int launch_hessian(const void* consts, const void* q, const void* qd,
                   const void* u, const void* lam, void* o, long long B,
                   double gravity, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const dim3 grid_dim(blocks_for(B), 3 * grid::N);
  const T mg = static_cast<T>(-gravity);
  if (lam != nullptr) {
    hessian_kernel<T, true><<<grid_dim, kThreads, smem_bytes<T>(), s>>>(
        in<T>(consts), in<T>(q), in<T>(qd), in<T>(u), in<T>(lam), out<T>(o),
        B, mg);
  } else {
    hessian_kernel<T, false><<<grid_dim, kThreads, smem_bytes<T>(), s>>>(
        in<T>(consts), in<T>(q), in<T>(qd), in<T>(u), nullptr, out<T>(o), B,
        mg);
  }
  return static_cast<int>(cudaGetLastError());
}
#endif  // GRID_DENSE_HESSIAN

template <typename T>
int launch_t1(const void* consts, const void* q, const void* qd, void* dc,
              void* dv, long long B, int which, double gravity,
              void* stream) {
  t1_kernel<T><<<dim3(blocks_for(B), grid::N), kThreads, smem_bytes<T>(),
                 static_cast<cudaStream_t>(stream)>>>(
      in<T>(consts), in<T>(q), in<T>(qd), out<T>(dc), out<T>(dv), B, which,
      static_cast<T>(-gravity));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_t2(const void* consts, const void* q, const void* lamM,
              const void* qdd, const void* Minv, const void* dc, void* dlamM,
              void* dqdd, long long B, void* stream) {
  t2_kernel<T><<<dim3(blocks_for(B), grid::N), kThreads, smem_bytes<T>(),
                 static_cast<cudaStream_t>(stream)>>>(
      in<T>(consts), in<T>(q), in<T>(lamM), in<T>(qdd), in<T>(Minv),
      in<T>(dc), out<T>(dlamM), out<T>(dqdd), B);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_t4(const void* consts, const void* q, const void* qd,
              const void* qdd, const void* v, const void* dv,
              const void* dqdd, void* da, void* df, long long B, int which,
              double gravity, void* stream) {
  t4_kernel<T><<<dim3(blocks_for(B), grid::N), kThreads, smem_bytes<T>(),
                 static_cast<cudaStream_t>(stream)>>>(
      in<T>(consts), in<T>(q), in<T>(qd), in<T>(qdd), in<T>(v), in<T>(dv),
      in<T>(dqdd), out<T>(da), out<T>(df), B, which,
      static_cast<T>(-gravity));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_t5(const void* consts, const void* q, const void* qd,
              const void* v, const void* a, const void* f, const void* lamM,
              const void* dv, const void* da, const void* df, void* o,
              long long B, int which, int side_q, int cb, double gravity,
              void* stream) {
  if (cb < 1 || cb > grid::SO_CB)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const dim3 grid_dim(blocks_for(B), grid::N, (grid::N + cb - 1) / cb);
  const T mg = static_cast<T>(-gravity);
  if (side_q) {
    t5_kernel<T, true><<<grid_dim, kThreads, smem_bytes<T>(), s>>>(
        in<T>(consts), in<T>(q), in<T>(qd), in<T>(v), in<T>(a), in<T>(f),
        in<T>(lamM), in<T>(dv), in<T>(da), in<T>(df), out<T>(o), B, which, cb,
        mg);
  } else {
    t5_kernel<T, false><<<grid_dim, kThreads, smem_bytes<T>(), s>>>(
        in<T>(consts), in<T>(q), in<T>(qd), in<T>(v), in<T>(a), in<T>(f),
        in<T>(lamM), in<T>(dv), in<T>(da), in<T>(df), out<T>(o), B, which, cb,
        mg);
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

#if GRID_DENSE_HESSIAN
#define GRID_HESSIAN_ENTRY(T, tag)                                          \
  int grid_hessian_##tag(const void* consts, const void* q, const void* qd, \
                         const void* u, const void* lam, void* o,           \
                         long long B, double gravity, void* stream) {       \
    return launch_hessian<T>(consts, q, qd, u, lam, o, B, gravity, stream); \
  }
GRID_HESSIAN_ENTRY(float, f32)
GRID_HESSIAN_ENTRY(double, f64)
#undef GRID_HESSIAN_ENTRY
#endif  // GRID_DENSE_HESSIAN

#define GRID_SO_STAGED_ENTRIES(T, tag)                                       \
  int grid_t1_##tag(const void* consts, const void* q, const void* qd,       \
                    void* dc, void* dv, long long B, int which,              \
                    double gravity, void* stream) {                          \
    return launch_t1<T>(consts, q, qd, dc, dv, B, which, gravity, stream);   \
  }                                                                          \
  int grid_t2_##tag(const void* consts, const void* q, const void* lamM,     \
                    const void* qdd, const void* Minv, const void* dc,       \
                    void* dlamM, void* dqdd, long long B, void* stream) {    \
    return launch_t2<T>(consts, q, lamM, qdd, Minv, dc, dlamM, dqdd, B,      \
                        stream);                                             \
  }                                                                          \
  int grid_t4_##tag(const void* consts, const void* q, const void* qd,       \
                    const void* qdd, const void* v, const void* dv,          \
                    const void* dqdd, void* da, void* df, long long B,       \
                    int which, double gravity, void* stream) {               \
    return launch_t4<T>(consts, q, qd, qdd, v, dv, dqdd, da, df, B, which,   \
                        gravity, stream);                                    \
  }                                                                          \
  int grid_t5_##tag(const void* consts, const void* q, const void* qd,       \
                    const void* v, const void* a, const void* f,             \
                    const void* lamM, const void* dv, const void* da,        \
                    const void* df, void* o, long long B, int which,         \
                    int side_q, int cb, double gravity, void* stream) {      \
    return launch_t5<T>(consts, q, qd, v, a, f, lamM, dv, da, df, o, B,      \
                        which, side_q, cb, gravity, stream);                 \
  }

GRID_SO_STAGED_ENTRIES(float, f32)
GRID_SO_STAGED_ENTRIES(double, f64)

#undef GRID_SO_STAGED_ENTRIES

}  // extern "C"
