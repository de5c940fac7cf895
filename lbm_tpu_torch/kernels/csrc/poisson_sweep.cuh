// The warm-started iterative Poisson sweep loop as a device function of a
// persistent cooperative grid, shared by the solve kernel (poisson_iter.cu)
// and the K-step window kernel (fused_multistep.cu).
//
// It is lbm_tpu/kernels/fused_multistep.py:solve_iter_val's loop: red-black
// Gauss-Seidel, SOR, or the 4-colour 9-point stencil (NPS), swept until
// maxErr < tol or max_iter sweeps. The grid walks the sites with
// grid-stride loops and meets at grid.sync() after every colour pass.
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
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

namespace cg = cooperative_groups;

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
struct SweepArgs {
  const T* phi0;   // warm start, read-only until the first pass ends; may be out
  const T* rho;    // rho_q, read-only
  T* scratch;      // ping-pong buffer: even passes write here
  T* out;          // odd passes write here; every sweep ends on an odd pass
  typename Bits<T>::U* err_ring;  // kRing slots
  int NY, NX, max_iter;
  T tol, omega, one_minus_omega;
};

// Block-level scratch of the error reduction, in shared memory.
template <typename T, int THREADS>
struct SweepShared {
  typename Bits<T>::U warp_max[THREADS / 32];
  typename Bits<T>::U block_err;
};

// The whole do-while loop; every thread of the grid calls it. Returns the
// number of sweeps run. phi ends in a.out. 32-bit site indices: callers
// refuse planes of 2^31 sites.
template <typename T, int KIND, bool INTERIOR, int THREADS>
__device__ int sweep_loop(const SweepArgs<T>& a, SweepShared<T, THREADS>& sh,
                          cg::grid_group& grid) {
  using U = typename Bits<T>::U;
  constexpr int kColours = KIND == kNPS ? 4 : 2;
  const int NX = a.NX, NY = a.NY;
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
      if ((threadIdx.x & 31) == 0) sh.warp_max[threadIdx.x >> 5] = local;
      __syncthreads();
      if (threadIdx.x == 0) {
        U m = sh.warp_max[0];
        for (int w = 1; w < THREADS / 32; ++w) m = sh.warp_max[w] > m ? sh.warp_max[w] : m;
        if (m != 0) atomicMax(&a.err_ring[slot], m);
      }
      grid.sync();
    }
    ++it;
    if (threadIdx.x == 0) {
      sh.block_err = __ldcg(&a.err_ring[slot]);   // L2: the atomics' home
      // slot+2 was last read before this sweep's first barrier and is next
      // written two sweeps on, after more barriers
      if (blockIdx.x == 0) a.err_ring[(slot + 2) % kRing] = 0;
    }
    __syncthreads();
    err = Bits<T>::val(sh.block_err);
    __syncthreads();   // block_err is rewritten next sweep
    slot = (slot + 1) % kRing;
  }
  if (pass == 0) {   // no sweep ran: phi is the warm start
    for (int site = first; site < plane; site += stride) a.out[site] = a.phi0[site];
  }
  return it;
}

}  // namespace
