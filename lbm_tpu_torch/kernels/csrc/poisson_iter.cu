// Warm-started iterative Poisson solve, the whole sweep loop in one launch:
// red-black Gauss-Seidel, SOR, or the 4-colour 9-point stencil (NPS).
//
// Replaces lbm_tpu/kernels/poisson_iter.py:solve_iter_tpu, whose body is
// lbm_tpu/kernels/fused_multistep.py:solve_iter_val (neumann=None). Like
// that kernel it runs the do-while loop on the device, stopping when
// maxErr < tol or after max_iter sweeps, and returns phi (E is the
// caller's). The TPU kernel keeps phi in VMEM on one core; here one
// persistent cooperative grid, sized to the co-resident maximum, walks the
// sites with grid-stride loops and meets at grid.sync() after every colour
// pass. Nothing goes back to the host between sweeps.
//
// The loop itself, and what makes it bitwise equal to the plain sweeps of
// lbm_tpu_torch/ops/poisson.py, is poisson_sweep.cuh's sweep_loop.
//
// Bound: what the inputs need is one read of phi0 and rho and one write of
// phi, plus 8-14 flop a site per sweep run, so the least time is set by the
// operations. This version reads phi and rho and writes a whole plane at
// every colour pass; up to ~1024^2 in f32 those planes stay in the 50 MB
// L2, and at small grids the grid barriers (2 or 4 a sweep) set the pace.
// In-place red-black updates and shared-memory tiling are left to later
// work.

#include "poisson_sweep.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
struct Args {
  SweepArgs<T> sweep;
  int* sweeps;     // sweeps run
};

template <typename T, int KIND, bool INTERIOR>
__global__ void __launch_bounds__(kThreads) solve_iter_kernel(const Args<T> a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ SweepShared<T, kThreads> sh;
  const int it = sweep_loop<T, KIND, INTERIOR, kThreads>(a.sweep, sh, grid);
  if (blockIdx.x == 0 && threadIdx.x == 0) *a.sweeps = it;
}

template <typename T, int KIND, bool INTERIOR>
cudaError_t launch(const Args<T>& a, cudaStream_t stream) {
  auto kernel = solve_iter_kernel<T, KIND, INTERIOR>;
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  if (e != cudaSuccess) return e;
  if (!coop || per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  const int64_t sites = static_cast<int64_t>(a.sweep.NY) * a.sweep.NX;
  const int64_t needed = (sites + kThreads - 1) / kThreads;
  const int64_t resident = static_cast<int64_t>(per_sm) * sms;
  const unsigned blocks = static_cast<unsigned>(needed < resident ? needed : resident);
  Args<T> args = a;
  void* params[] = {&args};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(blocks),
                                  dim3(kThreads), params, 0, stream);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int kind, int interior, const Args<T>& a, cudaStream_t stream) {
  switch (kind * 2 + (interior ? 1 : 0)) {
    case 0: return launch<T, kGS, false>(a, stream);
    case 1: return launch<T, kGS, true>(a, stream);
    case 2: return launch<T, kSOR, false>(a, stream);
    case 3: return launch<T, kSOR, true>(a, stream);
    case 4: return launch<T, kNPS, false>(a, stream);
    case 5: return launch<T, kNPS, true>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t solve(int kind, int interior, double omega, int max_iter, double tol,
                  const void* phi0, const void* rho, void* scratch, void* out,
                  void* err_ring, void* sweeps, int NY, int NX, cudaStream_t stream) {
  Args<T> a;
  SweepArgs<T>& s = a.sweep;
  s.phi0 = static_cast<const T*>(phi0);
  s.rho = static_cast<const T*>(rho);
  s.scratch = static_cast<T*>(scratch);
  s.out = static_cast<T*>(out);
  s.err_ring = static_cast<typename Bits<T>::U*>(err_ring);
  s.NY = NY;
  s.NX = NX;
  s.max_iter = max_iter;
  s.tol = static_cast<T>(tol);
  s.omega = static_cast<T>(omega);
  s.one_minus_omega = static_cast<T>(1.0 - omega);
  a.sweeps = static_cast<int*>(sweeps);
  return dispatch<T>(kind, interior, a, stream);
}

}  // namespace

// dtype: 0 = double, 1 = float. kind: 0 = GS, 1 = SOR (omega), 2 = NPS.
// phi0, rho: (NY, NX) inputs; scratch, out: (NY, NX) buffers of the same
// type; err_ring: 3 zero-or-garbage 8-byte slots; sweeps: one int. Returns
// the cudaError_t of the launch (0 on success); asynchronous on `stream`.
extern "C" int lbm_solve_iter(int dtype, int kind, int interior_only, double omega,
                              int max_iter, double tol, const void* phi0, const void* rho,
                              void* scratch, void* out, void* err_ring, void* sweeps, int NY,
                              int NX, void* stream) {
  if (NY <= 0 || NX <= 0 || static_cast<int64_t>(NY) * NX > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return solve<double>(kind, interior_only, omega, max_iter, tol, phi0, rho, scratch, out,
                           err_ring, sweeps, NY, NX, st);
    case 1:
      return solve<float>(kind, interior_only, omega, max_iter, tol, phi0, rho, scratch, out,
                          err_ring, sweeps, NY, NX, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
