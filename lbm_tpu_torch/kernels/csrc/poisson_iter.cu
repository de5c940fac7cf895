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
// Bitwise equal to the plain sweeps of lbm_tpu_torch/ops/poisson.py:
//   * each colour updates out of place, from the phi before it (ping-pong
//     buffers: jnp.where semantics; under periodic walls with an odd NX or
//     NY the wrap gives a site a neighbour of its own colour);
//   * the same expression order, built with -fmad=false:
//       nb5  = ((p[y,x-1] + p[y,x+1]) + p[y-1,x]) + p[y+1,x]
//       GS   = 0.25 * (nb5 + rho)
//       SOR  = (1-w) * p + w * GS, 1-w folded in double on the host
//       NPS  = ((4*nb5 + nb_diag) + 6*rho) / 20, a true division;
//   * red is (x+y)%2 == 0, the NPS colour 2*(x%2)+(y%2) swept 0..3, and
//     interior-only restricts to 1 <= x < NX-1, 1 <= y < NY-1;
//   * the error is max |new - p| over the updated sites, taken on the bit
//     patterns of |x| (ordered for non-negative floats, NaN above +inf), so
//     a NaN ends the loop after that sweep, as jnp.max does; the stop test
//     err >= tol runs in T with tol cast to T, as JAX's weak-typed float.
//
// Bound: what the inputs need is one read of phi0 and rho and one write of
// phi, plus 8-14 flop a site per sweep run, so the least time is set by the
// operations. This version reads phi and rho and writes a whole plane at
// every colour pass; up to ~1024^2 in f32 those planes stay in the 50 MB
// L2, and at small grids the grid barriers (2 or 4 a sweep) set the pace.
// In-place red-black updates and shared-memory tiling are left to later
// work.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kRing = 3;   // per-sweep error slots, cleared two sweeps ahead

template <typename T>
struct Bits;
template <>
struct Bits<float> {
  using U = unsigned int;
  static constexpr U kInf = 0x7f800000u;
  static __device__ __forceinline__ U of(float v) { return __float_as_uint(v); }
  static __device__ __forceinline__ float val(U u) { return __uint_as_float(u); }
  static __device__ __forceinline__ float abs(float v) { return fabsf(v); }
};
template <>
struct Bits<double> {
  using U = unsigned long long;
  static constexpr U kInf = 0x7ff0000000000000ull;
  static __device__ __forceinline__ U of(double v) {
    return static_cast<U>(__double_as_longlong(v));
  }
  static __device__ __forceinline__ double val(U u) {
    return __longlong_as_double(static_cast<long long>(u));
  }
  static __device__ __forceinline__ double abs(double v) { return fabs(v); }
};

enum Kind { kGS = 0, kSOR = 1, kNPS = 2 };

template <typename T>
struct Args {
  const T* phi0;   // warm start, read-only
  const T* rho;    // rho_q, read-only
  T* scratch;      // ping-pong buffer: even passes write here
  T* out;          // odd passes write here; every sweep ends on an odd pass
  typename Bits<T>::U* err_ring;  // kRing slots
  int* sweeps;     // sweeps run
  int NY, NX, max_iter;
  T tol, omega, one_minus_omega;
};

template <typename T, int KIND, bool INTERIOR>
__global__ void __launch_bounds__(kThreads) solve_iter_kernel(const Args<T> a) {
  using U = typename Bits<T>::U;
  constexpr int kColours = KIND == kNPS ? 4 : 2;
  cg::grid_group grid = cg::this_grid();
  __shared__ U warp_max[kThreads / 32];
  __shared__ U block_err;
  const int NX = a.NX, NY = a.NY;
  // 32-bit site indices: the entry point refuses planes of 2^31 sites
  const int plane = NY * NX;
  const int stride = gridDim.x * blockDim.x;
  const int first = blockIdx.x * blockDim.x + threadIdx.x;

  if (blockIdx.x == 0 && threadIdx.x < kRing) a.err_ring[threadIdx.x] = 0;
  grid.sync();

  int it = 0, pass = 0, slot = 0;
  T err = Bits<T>::val(Bits<T>::kInf);
  // every block reads the same slot after the same barrier, so the
  // condition is uniform across the grid (no divergence around grid.sync)
  while (it < a.max_iter && err >= a.tol) {
    for (int c = 0; c < kColours; ++c, ++pass) {
      // plain loads: these buffers are written inside this launch
      const T* src = pass == 0 ? a.phi0 : ((pass & 1) ? a.scratch : a.out);
      T* dst = (pass & 1) ? a.out : a.scratch;
      U local = 0;
      for (int site = first; site < plane; site += stride) {
        const int y = site / NX;
        const int x = site - y * NX;
        const T p = src[site];
        const int colour = KIND == kNPS ? 2 * (x & 1) + (y & 1) : ((x + y) & 1);
        bool on = colour == c;
        if (INTERIOR) on = on && x >= 1 && x < NX - 1 && y >= 1 && y < NY - 1;
        if (!on) {
          dst[site] = p;
          continue;
        }
        const int xm = x == 0 ? NX - 1 : x - 1, xp = x == NX - 1 ? 0 : x + 1;
        const int rm = (y == 0 ? NY - 1 : y - 1) * NX;
        const int r0 = y * NX;
        const int rp = (y == NY - 1 ? 0 : y + 1) * NX;
        const T nb5 = ((src[r0 + xm] + src[r0 + xp]) + src[rm + x]) + src[rp + x];
        const T rho = a.rho[site];
        T v;
        if (KIND == kNPS) {
          const T nbd = ((src[rm + xm] + src[rm + xp]) + src[rp + xm]) + src[rp + xp];
          v = ((T(4.0) * nb5 + nbd) + T(6.0) * rho) / T(20.0);
        } else {
          v = T(0.25) * (nb5 + rho);
          if (KIND == kSOR) v = a.one_minus_omega * p + a.omega * v;
        }
        dst[site] = v;
        const U d = Bits<T>::of(Bits<T>::abs(v - p));
        local = d > local ? d : local;
      }
      // block max, then one atomic a block into this sweep's slot
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const U o = __shfl_down_sync(0xffffffffu, local, off);
        local = o > local ? o : local;
      }
      if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = local;
      __syncthreads();
      if (threadIdx.x == 0) {
        U m = warp_max[0];
        for (int w = 1; w < kThreads / 32; ++w) m = warp_max[w] > m ? warp_max[w] : m;
        if (m != 0) atomicMax(&a.err_ring[slot], m);
      }
      grid.sync();
    }
    ++it;
    if (threadIdx.x == 0) {
      block_err = __ldcg(&a.err_ring[slot]);   // L2: the atomics' home
      // slot+2 was last read before this sweep's first barrier and is next
      // written two sweeps on, after more barriers
      if (blockIdx.x == 0) a.err_ring[(slot + 2) % kRing] = 0;
    }
    __syncthreads();
    err = Bits<T>::val(block_err);
    __syncthreads();   // block_err is rewritten next sweep
    slot = (slot + 1) % kRing;
  }
  if (pass == 0) {   // no sweep ran: phi is the warm start
    for (int site = first; site < plane; site += stride) a.out[site] = a.phi0[site];
  }
  if (first == 0) *a.sweeps = it;
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
  const int64_t sites = static_cast<int64_t>(a.NY) * a.NX;
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
  a.phi0 = static_cast<const T*>(phi0);
  a.rho = static_cast<const T*>(rho);
  a.scratch = static_cast<T*>(scratch);
  a.out = static_cast<T*>(out);
  a.err_ring = static_cast<typename Bits<T>::U*>(err_ring);
  a.sweeps = static_cast<int*>(sweeps);
  a.NY = NY;
  a.NX = NX;
  a.max_iter = max_iter;
  a.tol = static_cast<T>(tol);
  a.omega = static_cast<T>(omega);
  a.one_minus_omega = static_cast<T>(1.0 - omega);
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
