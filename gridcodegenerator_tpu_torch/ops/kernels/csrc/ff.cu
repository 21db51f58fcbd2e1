// The floating-base (free-flyer) families, one thread per state.
//
// Replaces (gridcodegenerator_tpu/ops/kernels/contact_fused.py):
//   fb_aba_fused    (contact_fused.py:1413) -> grid_fb_aba_{f32,f64}
//   fb_fd_fused     (contact_fused.py:1329) -> grid_fb_fd_{f32,f64}
//   stance_fd_fused (contact_fused.py:1431) -> grid_stance_fd_{f32,f64}
//   step_ground_fused (contact_fused.py:1458) -> grid_step_ground_{f32,f64}
//   step_ground_terrain_fused (contact_fused.py:1531)
//                   -> grid_step_ground_terrain_{f32,f64}
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
// The ground step (step_ground_kernel<T, kTerrain>, flat or on a
// heightfield) reuses the stance's front half, and builds every row
// triplet — the feet, the collision contacts (self pairs, obstacle pairs),
// the ground geoms' endpoint spheres (their links in the build's contact
// list, −1 for the base; the feet count kf is a run-time argument) and the
// loop closures — through one non-inlined call a triplet (slot_rows), then
// the full Delassus rows, b, the PGS sweeps (the closures' bilateral rows
// after the cones) and the integration: its per-state arrays are X, the packed M and its factor, the
// contacts' rows, the merged solve's (6+n) × (3k+1) right-hand sides and
// G's triangle. The sweeps are a run-time loop (iters) whose rows unroll;
// up to 24 rows the columns unroll too, so G, the impulses, b and the
// diagonal live in registers at HyQ's 3k = 12 in f32; past it (HyQ with its
// geoms: 42 rows, G's triangle 903 values) the column loop rolls and G
// stays in local memory. The height grid is read from device memory (four
// read-only loads a contact), which lifts the TPU kernel's VMEM gate
// (terrain_fused_ok): every grid size runs the kernel.
//
// A library is built per topology: with -DGRID_FF_K=0 it holds the ABA and
// mass-matrix kernels, with the contact links (-DGRID_FF_K=k
// -DGRID_FF_LINKS=..., and a step's collision and closure links) the stance
// and ground-step kernels of those links.
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

template <typename T, bool kTerrain>
__global__ void __launch_bounds__(kThreads)
step_ground_kernel(const T* __restrict__ consts, const T* __restrict__ quat,
                   const T* __restrict__ pos, const T* __restrict__ q,
                   const T* __restrict__ vb, const T* __restrict__ qd,
                   const T* __restrict__ tau, const T* __restrict__ mu,
                   const T* __restrict__ push, const T* __restrict__ off,
                   const T* __restrict__ geo, const T* __restrict__ col,
                   const T* __restrict__ lp, int kf,
                   const T* __restrict__ ridge, T* __restrict__ quat2,
                   T* __restrict__ pos2, T* __restrict__ q2,
                   T* __restrict__ vb2, T* __restrict__ qd2,
                   T* __restrict__ imp, long long B, grid::StepParams<T> sp,
                   grid::Heightfield<T> hf) {
  const T* sm = stage_constants(consts);
  const grid::Robot<T> R(sm);
  const long long b = state_index();
  if (b >= B) return;
  grid::step_state<T, kTerrain>(R, sm + 152 * grid::N, quat, pos, q, vb, qd,
                                tau, mu, push, off, geo, col, lp, kf, ridge,
                                sp, hf,
                                quat2, pos2, q2, vb2, qd2, imp, B, b);
}

// push == nullptr: no external base wrench; heights == nullptr: the plane
// z = ground_z, else the H × W heightfield (ground_z unused); the first kf
// of the build's contact links are feet, the rest ground-geom spheres (geo,
// null without any); col and lp the collision contacts' and the closures'
// geometry (null without any)
template <typename T>
int step(const void* consts, const void* quat, const void* pos,
         const void* q, const void* vb, const void* qd, const void* tau,
         const void* mu, const void* push, const void* off, const void* geo,
         const void* col, const void* lp, const void* ridge, void* quat2, void* pos2, void* q2, void* vb2,
         void* qd2, void* imp, const void* heights, long long B, int kf,
         double dt,
         double ground_z, double gravity, int iters, double erp,
         double margin, double restitution, int H, int W, double cell,
         double x0, double y0, void* stream) {
  const grid::StepParams<T> sp{
      static_cast<T>(dt),       static_cast<T>(1.0 / dt),
      static_cast<T>(ground_z), static_cast<T>(-gravity),
      static_cast<T>(-erp),     static_cast<T>(margin),
      static_cast<T>(restitution), iters};
  const grid::Heightfield<T> hf{in<T>(heights), H, W, static_cast<T>(cell),
                                static_cast<T>(1.0 / cell),
                                static_cast<T>(x0), static_cast<T>(y0)};
  auto s = static_cast<cudaStream_t>(stream);
  if (heights == nullptr) {
    step_ground_kernel<T, false><<<blocks_for(B), kThreads, smem_bytes<T>(),
                                   s>>>(
        in<T>(consts), in<T>(quat), in<T>(pos), in<T>(q), in<T>(vb),
        in<T>(qd), in<T>(tau), in<T>(mu), in<T>(push), in<T>(off),
        in<T>(geo), in<T>(col), in<T>(lp), kf, in<T>(ridge),
        static_cast<T*>(quat2),
        static_cast<T*>(pos2),
        static_cast<T*>(q2), static_cast<T*>(vb2), static_cast<T*>(qd2),
        static_cast<T*>(imp), B, sp, hf);
  } else {
    step_ground_kernel<T, true><<<blocks_for(B), kThreads, smem_bytes<T>(),
                                  s>>>(
        in<T>(consts), in<T>(quat), in<T>(pos), in<T>(q), in<T>(vb),
        in<T>(qd), in<T>(tau), in<T>(mu), in<T>(push), in<T>(off),
        in<T>(geo), in<T>(col), in<T>(lp), kf, in<T>(ridge),
        static_cast<T*>(quat2),
        static_cast<T*>(pos2),
        static_cast<T*>(q2), static_cast<T*>(vb2), static_cast<T*>(qd2),
        static_cast<T*>(imp), B, sp, hf);
  }
  return static_cast<int>(cudaGetLastError());
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

// the flat ground: consts, quat, pos, q, vb, qd, tau, mu, push, off, geo,
// col, lp, ridge, quat2, pos2, q2, vb2, qd2, imp, B, kf, dt, ground_z, gravity, iters,
// erp, margin, restitution, stream
int grid_step_ground_f32(const void* consts, const void* quat,
                         const void* pos, const void* q, const void* vb,
                         const void* qd, const void* tau, const void* mu,
                         const void* push, const void* off, const void* geo,
                         const void* col, const void* lp,
                         const void* ridge, void* quat2, void* pos2, void* q2,
                         void* vb2, void* qd2, void* imp, long long B, int kf,
                         double dt,
                         double ground_z, double gravity, int iters,
                         double erp, double margin, double restitution,
                         void* stream) {
  return step<float>(consts, quat, pos, q, vb, qd, tau, mu, push, off, geo,
                     col, lp, ridge, quat2, pos2, q2, vb2, qd2, imp, nullptr, B, kf, dt,
                     ground_z,
                     gravity, iters, erp, margin, restitution, 0, 0, 0.0, 0.0,
                     0.0, stream);
}
int grid_step_ground_f64(const void* consts, const void* quat,
                         const void* pos, const void* q, const void* vb,
                         const void* qd, const void* tau, const void* mu,
                         const void* push, const void* off, const void* geo,
                         const void* col, const void* lp,
                         const void* ridge, void* quat2, void* pos2, void* q2,
                         void* vb2, void* qd2, void* imp, long long B, int kf,
                         double dt,
                         double ground_z, double gravity, int iters,
                         double erp, double margin, double restitution,
                         void* stream) {
  return step<double>(consts, quat, pos, q, vb, qd, tau, mu, push, off, geo,
                      col, lp, ridge, quat2, pos2, q2, vb2, qd2, imp, nullptr, B, kf,
                      dt, ground_z, gravity, iters, erp, margin, restitution, 0,
                      0, 0.0, 0.0, 0.0, stream);
}

// the heightfield: ..., imp, heights, B, kf, dt, gravity, iters, erp,
// margin, restitution, H, W, cell, x0, y0, stream
int grid_step_ground_terrain_f32(
    const void* consts, const void* quat, const void* pos, const void* q,
    const void* vb, const void* qd, const void* tau, const void* mu,
    const void* push, const void* off, const void* geo, const void* col,
    const void* lp, const void* ridge,
    void* quat2, void* pos2, void* q2, void* vb2, void* qd2, void* imp,
    const void* heights, long long B, int kf, double dt, double gravity,
    int iters,
    double erp, double margin, double restitution, int H, int W, double cell,
    double x0, double y0, void* stream) {
  return step<float>(consts, quat, pos, q, vb, qd, tau, mu, push, off, geo,
                     col, lp, ridge, quat2, pos2, q2, vb2, qd2, imp, heights, B, kf, dt,
                     0.0,
                     gravity, iters, erp, margin, restitution, H, W, cell, x0,
                     y0, stream);
}
int grid_step_ground_terrain_f64(
    const void* consts, const void* quat, const void* pos, const void* q,
    const void* vb, const void* qd, const void* tau, const void* mu,
    const void* push, const void* off, const void* geo, const void* col,
    const void* lp, const void* ridge,
    void* quat2, void* pos2, void* q2, void* vb2, void* qd2, void* imp,
    const void* heights, long long B, int kf, double dt, double gravity,
    int iters,
    double erp, double margin, double restitution, int H, int W, double cell,
    double x0, double y0, void* stream) {
  return step<double>(consts, quat, pos, q, vb, qd, tau, mu, push, off, geo,
                      col, lp, ridge, quat2, pos2, q2, vb2, qd2, imp, heights, B, kf,
                      dt, 0.0, gravity, iters, erp, margin, restitution, H, W,
                      cell, x0, y0, stream);
}
#endif  // GRID_FF_K

}  // extern "C"
