// The multi-dof frictional ground step, one thread per state.
//
// Replaces (gridcodegenerator_tpu/ops/kernels/md_contact_fused.py):
//   md_step_ground_fused (md_contact_fused.py:185)
//                   -> grid_md_step_ground_{f32,f64}
// The Pallas kernel ran its body (_md_step_ground_body) on a VMEM tile of
// 128 states, and robots past the tile's budget (md_step_workset_ok) ran the
// same body as plain XLA. Here the body (md_step.cuh) runs per thread on the
// batch-last layout at the boundary — q (nq, B), q̇, τ (nv, B), μ (k, B);
// outputs q⁺ (nq, B), v⁺ (nv, B), impulses (3k, B) — for every robot: there
// is no gate.
//
// What bounds it: the per-state arrays in local memory, as in the
// free-flyer step (ff.cu): the transforms (36n), the RNEA's v, a, f (18n),
// the mass matrix (nv², then its packed factor), the contacts' rows over
// their chains, the merged solve's nv × (3k + 1) right-hand sides and G's
// triangle; the PGS sweeps are a run-time loop whose rows unroll (and, up to
// 24 rows, whose columns unroll: the ball ant's 15 rows keep G, p and b in
// registers). The robot constants (96·n + 2·nv values) are staged in shared
// memory once per block.
//
// A library is built per topology and set of contact links (feet, then each
// geom contact's link: -DGRID_MD_K, -DGRID_MD_LINKS); dt, ground_z, gravity,
// μ, the sweeps, erp, margin, restitution, the foot offsets, the geom
// spheres, the split between the two (kf) and the ridge are run-time
// arguments.
#include <cuda_runtime.h>

#include "md_step.cuh"

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
md_step_ground_kernel(const T* __restrict__ consts, const T* __restrict__ q,
                      const T* __restrict__ qd, const T* __restrict__ tau,
                      const T* __restrict__ mu, const T* __restrict__ off,
                      const T* __restrict__ geo, int kf,
                      const T* __restrict__ ridge, T* __restrict__ q2,
                      T* __restrict__ v2, T* __restrict__ imp, long long B,
                      grid::StepParams<T> sp) {
  const grid::MdRobot<T> R(stage_constants(consts));
  const long long b = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (b >= B) return;
  grid::md_step_state(R, q, qd, tau, mu, off, geo, kf, ridge, sp, q2, v2,
                      imp, B, b);
}

template <typename T>
int md_step(const void* consts, const void* q, const void* qd,
            const void* tau, const void* mu, const void* off,
            const void* geo, const void* ridge, void* q2, void* v2,
            void* imp, long long B, int kf, double dt, double ground_z,
            double gravity, int iters, double erp, double margin,
            double restitution, void* stream) {
  const grid::StepParams<T> sp{
      static_cast<T>(dt),       static_cast<T>(1.0 / dt),
      static_cast<T>(ground_z), static_cast<T>(-gravity),
      static_cast<T>(-erp),     static_cast<T>(margin),
      static_cast<T>(restitution), iters};
  const dim3 blocks(static_cast<unsigned>((B + kThreads - 1) / kThreads));
  md_step_ground_kernel<T>
      <<<blocks, kThreads, grid::kMdConstCount * sizeof(T),
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(consts), static_cast<const T*>(q),
          static_cast<const T*>(qd), static_cast<const T*>(tau),
          static_cast<const T*>(mu), static_cast<const T*>(off),
          static_cast<const T*>(geo), kf, static_cast<const T*>(ridge),
          static_cast<T*>(q2), static_cast<T*>(v2), static_cast<T*>(imp), B,
          sp);
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

// consts, q, qd, tau, mu, off, geo (or NULL), ridge, q2, v2, imp, B, kf, dt,
// ground_z, gravity, iters, erp, margin, restitution, stream
int grid_md_step_ground_f32(const void* consts, const void* q,
                            const void* qd, const void* tau, const void* mu,
                            const void* off, const void* geo,
                            const void* ridge, void* q2, void* v2, void* imp,
                            long long B, int kf, double dt, double ground_z,
                            double gravity, int iters, double erp,
                            double margin, double restitution, void* stream) {
  return md_step<float>(consts, q, qd, tau, mu, off, geo, ridge, q2, v2, imp,
                        B, kf, dt, ground_z, gravity, iters, erp, margin,
                        restitution, stream);
}
int grid_md_step_ground_f64(const void* consts, const void* q,
                            const void* qd, const void* tau, const void* mu,
                            const void* off, const void* geo,
                            const void* ridge, void* q2, void* v2, void* imp,
                            long long B, int kf, double dt, double ground_z,
                            double gravity, int iters, double erp,
                            double margin, double restitution, void* stream) {
  return md_step<double>(consts, q, qd, tau, mu, off, geo, ridge, q2, v2,
                         imp, B, kf, dt, ground_z, gravity, iters, erp,
                         margin, restitution, stream);
}

}  // extern "C"
