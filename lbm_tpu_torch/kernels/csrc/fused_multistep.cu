// K whole plasma steps in one launch: the temporally blocked window.
//
// Replaces lbm_tpu/kernels/fused_multistep.py:collide_stream_multistep (the
// Pallas kernels of _make_kernel: the constant-E march, the in-kernel
// spectral solve, the in-kernel iterative sweeps, and the bounce-back wall
// fixups) and :collide_stream_multistep_gated (the bounce-back march with
// its wall rows given at run time, on a shard extended by K ghost rows).
// The TPU kernel keeps the whole (f, g) state in VMEM, which ends near
// 256^2-304^2, and bands the grid past that; here the state stays in
// device memory and one persistent cooperative grid, sized to the
// co-resident maximum, walks the sites with grid-stride loops and meets at
// grid.sync() between the stages of a step. Any grid that fits the card
// runs, so the banded wrapper has no counterpart.
//
// A step, as the per-step path runs it (src/plasma.cpp:476-523):
//   1. collide + push-stream: the tile program of plasma_tile.cuh (the
//      per-step kernel's, so the two cannot drift apart), a persistent
//      block walking runs of a row staged in shared memory by TMA, a
//      thread a site. The
//      steps ping-pong two work buffers in the compute type; with native
//      storage the first step reads the input and the last one writes the
//      output, and bf16 storage is decoded into a work buffer in a pass
//      before the first step and encoded in a pass after the last, so it
//      rounds once a window. In the solve modes the stage also writes
//      rho_q.
//      Bounce-back is written by the same stage, on a band whose y walls sit
//      at the rows wall_b and wall_t (-1: none): (0, NY - 1) for the whole
//      grid, the global walls' rows on an extended shard. A value whose
//      push crosses a wall goes where JAX's gated fixups put it (the
//      reference's serial push loop, src/streaming.cpp:70-105, on the
//      whole grid), a push into a wall row from beyond it is dropped, and
//      of the values that land on one slot only the winner is stored, so
//      every slot is written exactly once and no second pass has to read
//      and rewrite edge values in place (multistep_site.cuh's pushes). The
//      8 corner holes keep stale values: the site's own pre-collision f for
//      the f pass and its post-collision f for the g pass, plus
//      neutral_ref * w_i for species 2 under delta storage.
//      The stage reads by TMA what the step before wrote with ordinary
//      stores, so the grid barriers between them fence the proxies.
//   2. the field:
//      * constant E (the NONE solver, or FFT under bounce-back, the
//        reference's no-op solve): no stage; with kill_field every step
//        after the first collides with E = 0;
//      * FFT + periodic: the half-spectrum DFT chain of the TPU kernel's
//        solve_field on this step's rho_q, in four passes of plain
//        multiply-add loops over the host-built matrices of dft_solve_mats
//        (A, B = rho cxh, rho sxh; P = ((cy - i sy)(A - i B)) invh;
//        U, V = (cy + i sy) P; phi = U gcx - V gsx), then periodic central
//        differences for E. No cuBLAS and no cuFFT;
//      * GS / SOR / NPS: poisson_sweep.cuh's sweep loop, warm-started from
//        the previous step's phi, then the periodic or the Neumann
//        (copy-to-edge, rows before columns) closure for E.
//
// Numbers: as plasma_site.cuh (exact reciprocal in the bf16 thermal form,
// constants folded in double on the host, -fmad=false). The iterative
// sweeps are bitwise those of the plain sweeps; the DFT sums run in another
// order than torch.matmul's.
//
// Bound: a window must read f and g once and write them once (432 B/site
// in f32, 216 in bf16); its operations are K times the collide stage's,
// an issue floor of the compiled body's instructions a site
// (scripts/trace_plasma2d_torch.py counts them), plus ~12 max(NY, NX) a
// site and step for the DFT as its loops count it. This version sends every
// step's state through device memory (432 B/site and step in the compute
// type, f32 for bf16 storage) and multiplies the DFT matrices with untiled
// loops; temporal blocking in shared memory and tensor-core DFTs are left
// to later work.

#include <cstdint>
#include <type_traits>

#include "plasma_tile.cuh"
#include "poisson_sweep.cuh"

// Host-side description of a window. The ctypes Structure in
// lbm_tpu_torch/kernels/fused_multistep.py mirrors this layout field for
// field. Pointers that a mode does not use may be null.
struct MultistepHost {
  const void* f_in;      // (3, 9, NY, NX) storage type
  const void* g_in;
  void* f_out;
  void* g_out;
  void* work_f[2];       // (3, 9, NY, NX) compute type: K >= 2 uses [0], K >= 3 and
                         // bf16 storage both
  void* work_g[2];
  const void* Ex_in;     // (NY, NX) compute type: the window's starting field
  const void* Ey_in;
  void* Ex_out;          // solve modes: the field, potential and rho_q after each step
  void* Ey_out;
  void* phi;
  void* rho_q;
  const void* phi_in;    // iterative solve: the warm start
  void* scratch;         // iterative solve: the sweeps' second plane
  void* err_ring;        // iterative solve: 3 slots of 8 bytes
  const void* mats[7];   // FFT: cy, sy (NY, NY); cxh, sxh (NX, Hp); invh (NY, Hp);
                         // gcx, gsx (Hp, NX)
  void* dft[4];          // FFT: four (NY, NX/2 + 1) planes
  int NY, NX, Hp, K;
  int bounce, kill, iter_kind, interior, neumann, max_iter;
  int wall_b, wall_t;    // bounce: the bottom and top wall rows (-1: none)
  double tol, omega;
};

namespace {

enum SolveKind { kConstE = 0, kFFT = 1, kIter = 2 };

template <typename S, typename T>
struct Window {
  const S* f_in;
  const S* g_in;
  S* f_out;
  S* g_out;
  T* wf[2];
  T* wg[2];
  const T* Ex_in;
  const T* Ey_in;
  T* Ex_out;
  T* Ey_out;
  T* phi;
  T* rho_q;
  const T* phi_in;
  T* scratch;
  typename Bits<T>::U* err_ring;
  const T *cy, *sy, *cxh, *sxh, *invh, *gcx, *gsx;
  T *dA, *dB, *dC, *dD;
  int NY, NX, H, Hp, K;
  window::Band band;
  int solve, kill, iter_kind, interior, neumann, max_iter;
  T tol, omega, one_minus_omega;
  T hole_bg[kQ];   // neutral_ref * w_i, added to species 2's g holes (delta)
};

// Stage 1 of step k: collide + push-stream from the step's input to its
// output, through the tile program (sm: its shared memory; seq: the runs
// this block has issued). Input, output and work buffers by position in
// the window (two work buffers alternate between the steps). Under bf16
// storage the input was decoded into the second work buffer before the
// first step and the last step's buffer is encoded after it, so every step
// runs the one collide body of the compute type.
template <typename S, typename T, bool DELTA, bool FAST, bool WALLS>
__device__ __forceinline__ void step_stage(const Window<S, T>& w, const Params<T>& p, int k,
                                           const T* Ex, const T* Ey, bool zero_E, T* rho_q,
                                           unsigned char* sm, uint32_t& seq) {
  Tile2Args<T, T> a;
  a.f = w.wf[(k + 1) & 1];   // written by step k - 1
  a.g = w.wg[(k + 1) & 1];
  a.f_out = w.wf[k & 1];
  a.g_out = w.wg[k & 1];
  if constexpr (std::is_same<S, T>::value) {
    if (k == 0) {
      a.f = w.f_in;
      a.g = w.g_in;
    }
    if (k == w.K - 1) {
      a.f_out = w.f_out;
      a.g_out = w.g_out;
    }
  }
  a.ex = Ex;
  a.ey = Ey;
  a.rho_q = rho_q;
  a.band = w.band;
  a.stream = 1;
  a.zero_E = zero_E;
  a.aligned = tile2_aligned(a);
  tile2_block<T, T, DELTA, FAST, WALLS>(a, p, sm, seq);
}

// A grid barrier between a stage that writes with ordinary stores and one
// that may read the writes by TMA.
__device__ __forceinline__ void tma_sync(cg::grid_group& grid) {
  proxy_fence();
  grid.sync();
  proxy_fence();
}

// 8 bf16 in 16 bytes to 8 floats (exact), and back (round to nearest
// even, as Io's store).
__device__ __forceinline__ void widen(const uint4& v, float4* out) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  const float2 c = __bfloat1622float2(h[2]), d = __bfloat1622float2(h[3]);
  out[0] = make_float4(a.x, a.y, b.x, b.y);
  out[1] = make_float4(c.x, c.y, d.x, d.y);
}

__device__ __forceinline__ uint4 narrow(const float4& lo, const float4& hi) {
  uint4 v;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
  h[0] = __floats2bfloat162_rn(lo.x, lo.y);
  h[1] = __floats2bfloat162_rn(lo.z, lo.w);
  h[2] = __floats2bfloat162_rn(hi.x, hi.y);
  h[3] = __floats2bfloat162_rn(hi.z, hi.w);
  return v;
}

// The bf16 decode before the first step (DECODE) and the encode after the
// last, for the two (3, 9, NY, NX) arrays of n elements, grid-stride. Each
// thread moves vectors of 8 elements, two at a time with every load before the
// stores; element by element where a pointer is not 16-byte aligned, and
// for the tail.
template <bool DECODE>
__device__ void convert_bf16(const void* f, const void* g, void* f_to, void* g_to, int64_t n) {
  using Bf = __nv_bfloat16;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const uintptr_t bits = reinterpret_cast<uintptr_t>(f) | reinterpret_cast<uintptr_t>(g) |
                         reinterpret_cast<uintptr_t>(f_to) | reinterpret_cast<uintptr_t>(g_to);
  const int64_t nv = (bits & 15) == 0 ? n / 8 : 0;
  for (int64_t v = first; v < nv; v += 2 * stride) {
    const int64_t v2 = v + stride;
    const bool two = v2 < nv;
    if constexpr (DECODE) {
      const uint4* fs = static_cast<const uint4*>(f);
      const uint4* gs = static_cast<const uint4*>(g);
      float4* fd = static_cast<float4*>(f_to);
      float4* gd = static_cast<float4*>(g_to);
      const uint4 a = fs[v], b = gs[v];
      uint4 c = a, d = b;
      if (two) {
        c = fs[v2];
        d = gs[v2];
      }
      widen(a, fd + 2 * v);
      widen(b, gd + 2 * v);
      if (two) {
        widen(c, fd + 2 * v2);
        widen(d, gd + 2 * v2);
      }
    } else {
      const float4* fs = static_cast<const float4*>(f);
      const float4* gs = static_cast<const float4*>(g);
      uint4* fd = static_cast<uint4*>(f_to);
      uint4* gd = static_cast<uint4*>(g_to);
      const float4 a0 = fs[2 * v], a1 = fs[2 * v + 1], b0 = gs[2 * v], b1 = gs[2 * v + 1];
      float4 c0 = a0, c1 = a1, d0 = b0, d1 = b1;
      if (two) {
        c0 = fs[2 * v2];
        c1 = fs[2 * v2 + 1];
        d0 = gs[2 * v2];
        d1 = gs[2 * v2 + 1];
      }
      fd[v] = narrow(a0, a1);
      gd[v] = narrow(b0, b1);
      if (two) {
        fd[v2] = narrow(c0, c1);
        gd[v2] = narrow(d0, d1);
      }
    }
  }
  for (int64_t e = nv * 8 + first; e < n; e += stride) {
    if constexpr (DECODE) {
      static_cast<float*>(f_to)[e] = Io<Bf, float>::load(static_cast<const Bf*>(f) + e);
      static_cast<float*>(g_to)[e] = Io<Bf, float>::load(static_cast<const Bf*>(g) + e);
    } else {
      Io<Bf, float>::store(static_cast<Bf*>(f_to) + e, static_cast<const float*>(f)[e]);
      Io<Bf, float>::store(static_cast<Bf*>(g_to) + e, static_cast<const float*>(g)[e]);
    }
  }
}

// The half-spectrum DFT solve of rho_q into phi (dft_solve_mats' chain),
// four passes with a grid barrier after each.
template <typename S, typename T>
__device__ void dft_solve(const Window<S, T>& w, cg::grid_group& grid) {
  const int NY = w.NY, NX = w.NX, H = w.H, Hp = w.Hp;
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  const int stride = gridDim.x * blockDim.x;
  const int half = NY * H;
  // A = rho cxh, B = rho sxh
  for (int e = first; e < half; e += stride) {
    const int y = e / H, k = e - y * H;
    const T* r = w.rho_q + y * NX;
    T a = T(0.0), b = T(0.0);
    for (int x = 0; x < NX; ++x) {
      a = a + r[x] * w.cxh[x * Hp + k];
      b = b + r[x] * w.sxh[x * Hp + k];
    }
    w.dA[e] = a;
    w.dB[e] = b;
  }
  grid.sync();
  // forward y and the eigenvalue: P = ((cy - i sy)(A - i B)) invh
  for (int e = first; e < half; e += stride) {
    const int y = e / H, k = e - y * H;
    T s1 = T(0.0), s2 = T(0.0), s3 = T(0.0), s4 = T(0.0);
    for (int j = 0; j < NY; ++j) {
      const T c = w.cy[y * NY + j], s = w.sy[y * NY + j];
      const T a = w.dA[j * H + k], b = w.dB[j * H + k];
      s1 = s1 + c * a;
      s2 = s2 + s * b;
      s3 = s3 + c * b;
      s4 = s4 + s * a;
    }
    const T inv = w.invh[y * Hp + k];
    w.dC[e] = (s1 - s2) * inv;
    w.dD[e] = (-(s3 + s4)) * inv;
  }
  grid.sync();
  // inverse y: U + i V = (cy + i sy) P, into the A and B planes
  for (int e = first; e < half; e += stride) {
    const int y = e / H, k = e - y * H;
    T s1 = T(0.0), s2 = T(0.0), s3 = T(0.0), s4 = T(0.0);
    for (int j = 0; j < NY; ++j) {
      const T c = w.cy[y * NY + j], s = w.sy[y * NY + j];
      const T pr = w.dC[j * H + k], pi = w.dD[j * H + k];
      s1 = s1 + c * pr;
      s2 = s2 + s * pi;
      s3 = s3 + s * pr;
      s4 = s4 + c * pi;
    }
    w.dA[e] = s1 - s2;
    w.dB[e] = s3 + s4;
  }
  grid.sync();
  // real inverse x: phi = U gcx - V gsx
  for (int e = first; e < NY * NX; e += stride) {
    const int y = e / NX, x = e - y * NX;
    T s1 = T(0.0), s2 = T(0.0);
    for (int k = 0; k < H; ++k) {
      s1 = s1 + w.dA[y * H + k] * w.gcx[k * NX + x];
      s2 = s2 + w.dB[y * H + k] * w.gsx[k * NX + x];
    }
    w.phi[e] = s1 - s2;
  }
  grid.sync();
}

template <typename S, typename T>
__device__ void iter_solve(const Window<S, T>& w, int k, SweepShared<T, kThreads2<T>>& sh,
                           cg::grid_group& grid) {
  SweepArgs<T> a;
  a.phi0 = k == 0 ? w.phi_in : w.phi;   // sweeps in place from the second step
  a.rho = w.rho_q;
  a.scratch = w.scratch;
  a.out = w.phi;
  a.err_ring = w.err_ring;
  a.NY = w.NY;
  a.NX = w.NX;
  a.max_iter = w.max_iter;
  a.tol = w.tol;
  a.omega = w.omega;
  a.one_minus_omega = w.one_minus_omega;
  switch (w.iter_kind * 2 + w.interior) {   // uniform across the grid
    case 0: sweep_loop<T, kGS, false, kThreads2<T>>(a, sh, grid); break;
    case 1: sweep_loop<T, kGS, true, kThreads2<T>>(a, sh, grid); break;
    case 2: sweep_loop<T, kSOR, false, kThreads2<T>>(a, sh, grid); break;
    case 3: sweep_loop<T, kSOR, true, kThreads2<T>>(a, sh, grid); break;
    case 4: sweep_loop<T, kNPS, false, kThreads2<T>>(a, sh, grid); break;
    default: sweep_loop<T, kNPS, true, kThreads2<T>>(a, sh, grid); break;
  }
  grid.sync();
}

// E = -grad phi by central differences with periodic wrap; with neumann,
// the copy-to-edge closure (rows first, then columns, corners included),
// which is the central difference at the nearest interior site.
template <typename S, typename T>
__device__ void efield(const Window<S, T>& w) {
  const int NY = w.NY, NX = w.NX;
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  const int stride = gridDim.x * blockDim.x;
  for (int e = first; e < NY * NX; e += stride) {
    int y = e / NX, x = e - y * NX;
    if (w.neumann) {
      y = y == 0 ? 1 : (y == NY - 1 ? NY - 2 : y);
      x = x == 0 ? 1 : (x == NX - 1 ? NX - 2 : x);
    }
    const int xm = x == 0 ? NX - 1 : x - 1, xp = x == NX - 1 ? 0 : x + 1;
    const int ym = y == 0 ? NY - 1 : y - 1, yp = y == NY - 1 ? 0 : y + 1;
    const T* phi = w.phi;
    w.Ex_out[e] = T(-0.5) * (phi[y * NX + xp] - phi[y * NX + xm]);
    w.Ey_out[e] = T(-0.5) * (phi[yp * NX + x] - phi[ym * NX + x]);
  }
}

// WALLS: a bounce-back window (the whole grid's walls or a gated band's);
// the periodic window compiles no wall code.
template <typename S, typename T, bool DELTA, bool FAST, bool WALLS>
__global__ void __launch_bounds__(kThreads2<T>, 3)
    multistep_kernel(const __grid_constant__ Window<S, T> w,
                     const __grid_constant__ Params<T> p) {
  cg::grid_group grid = cg::this_grid();
  __shared__ SweepShared<T, kThreads2<T>> sh;
  extern __shared__ __align__(128) unsigned char sm[];
  tile2_setup<T, T>(sm, w.hole_bg);
  uint32_t seq = 0;
  constexpr bool kDecode = !std::is_same<S, T>::value;   // bf16 storage
  const int64_t n = static_cast<int64_t>(kS) * kQ * w.NY * w.NX;
  if constexpr (kDecode) {
    convert_bf16<true>(w.f_in, w.g_in, w.wf[1], w.wg[1], n);
    tma_sync(grid);
  }
  for (int k = 0; k < w.K; ++k) {
    if (w.solve == kConstE) {
      step_stage<S, T, DELTA, FAST, WALLS>(w, p, k, w.Ex_in, w.Ey_in, w.kill && k > 0, nullptr,
                                           sm, seq);
    } else {
      // step 1 collides with the window's starting field, later steps with
      // the field the previous step solved for
      step_stage<S, T, DELTA, FAST, WALLS>(w, p, k, k == 0 ? w.Ex_in : w.Ex_out,
                                           k == 0 ? w.Ey_in : w.Ey_out, false, w.rho_q, sm,
                                           seq);
      grid.sync();
      if (w.solve == kFFT) {
        dft_solve(w, grid);
      } else {
        iter_solve(w, k, sh, grid);
      }
      efield(w);
    }
    if (k + 1 < w.K) tma_sync(grid);
  }
  if constexpr (kDecode) {
    grid.sync();
    const int last = (w.K - 1) & 1;
    convert_bf16<false>(w.wf[last], w.wg[last], w.f_out, w.g_out, n);
  }
}

template <typename S, typename T, bool DELTA, bool FAST, bool WALLS>
cudaError_t launch(int solve, const MultistepHost& h, const HostParams& hp,
                   cudaStream_t stream) {
  using L = Tile2Smem<T, T>;
  constexpr int threads = kThreads2<T>;
  const auto kernel = multistep_kernel<S, T, DELTA, FAST, WALLS>;
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(L::kBytes));
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, L::kBytes);
  if (e != cudaSuccess) return e;
  if (!coop || per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  // every block resident: as few as the collide stage's rounds of runs
  // allow (tile2_blocks), but a thread a site for the stages that walk the
  // sites (the DFT passes) where the card holds them
  const window::Band band{h.NY, h.NX, h.bounce, h.bounce ? h.wall_b : -1,
                          h.bounce ? h.wall_t : -1};
  const int64_t resident = static_cast<int64_t>(per_sm) * sms;
  const int64_t by_runs = tile2_blocks(tile2_runs<T>(band), resident);
  const int64_t by_sites = (static_cast<int64_t>(h.NY) * h.NX + threads - 1) / threads;
  const int64_t needed = by_runs > by_sites ? by_runs : by_sites;
  const unsigned blocks = static_cast<unsigned>(needed < resident ? needed : resident);

  Window<S, T> w;
  w.f_in = static_cast<const S*>(h.f_in);
  w.g_in = static_cast<const S*>(h.g_in);
  w.f_out = static_cast<S*>(h.f_out);
  w.g_out = static_cast<S*>(h.g_out);
  for (int b = 0; b < 2; ++b) {
    w.wf[b] = static_cast<T*>(h.work_f[b]);
    w.wg[b] = static_cast<T*>(h.work_g[b]);
  }
  w.Ex_in = static_cast<const T*>(h.Ex_in);
  w.Ey_in = static_cast<const T*>(h.Ey_in);
  w.Ex_out = static_cast<T*>(h.Ex_out);
  w.Ey_out = static_cast<T*>(h.Ey_out);
  w.phi = static_cast<T*>(h.phi);
  w.rho_q = static_cast<T*>(h.rho_q);
  w.phi_in = static_cast<const T*>(h.phi_in);
  w.scratch = static_cast<T*>(h.scratch);
  w.err_ring = static_cast<typename Bits<T>::U*>(h.err_ring);
  const T** mats[7] = {&w.cy, &w.sy, &w.cxh, &w.sxh, &w.invh, &w.gcx, &w.gsx};
  for (int m = 0; m < 7; ++m) *mats[m] = static_cast<const T*>(h.mats[m]);
  w.dA = static_cast<T*>(h.dft[0]);
  w.dB = static_cast<T*>(h.dft[1]);
  w.dC = static_cast<T*>(h.dft[2]);
  w.dD = static_cast<T*>(h.dft[3]);
  w.NY = h.NY;
  w.NX = h.NX;
  w.H = h.NX / 2 + 1;
  w.Hp = h.Hp;
  w.K = h.K;
  w.band = band;
  w.solve = solve;
  w.kill = h.kill;
  w.iter_kind = h.iter_kind;
  w.interior = h.interior;
  w.neumann = h.neumann;
  w.max_iter = h.max_iter;
  w.tol = static_cast<T>(h.tol);
  w.omega = static_cast<T>(h.omega);
  w.one_minus_omega = static_cast<T>(1.0 - h.omega);
  for (int i = 0; i < kQ; ++i) w.hole_bg[i] = static_cast<T>(hp.neutral_ref * w_of(i));
  Params<T> p = cast_params<T>(hp);
  void* params[] = {&w, &p};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(blocks),
                                  dim3(threads), params, L::kBytes, stream);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <typename S, typename T, bool FAST>
cudaError_t launch_delta(int delta, int solve, const MultistepHost& h, const HostParams& hp,
                         cudaStream_t stream) {
  if (h.bounce)
    return delta ? launch<S, T, true, FAST, true>(solve, h, hp, stream)
                 : launch<S, T, false, FAST, true>(solve, h, hp, stream);
  return delta ? launch<S, T, true, FAST, false>(solve, h, hp, stream)
               : launch<S, T, false, FAST, false>(solve, h, hp, stream);
}

}  // namespace

// mode: 0 = f64 storage and compute, 1 = f32, 2 = bf16 storage with f32
// compute. delta: nonzero when the neutral's f is delta-stored. solve_kind:
// 0 = constant E (kill zeroes it after the first step), 1 = the FFT solve
// (periodic), 2 = the iterative solve (iter_kind 0 = GS, 1 = SOR, 2 = NPS).
// Returns the cudaError_t of the launch (0 on success); the launch is
// asynchronous on `stream` and the caller owns every buffer.
extern "C" int lbm_plasma_multistep(int mode, int delta, int solve_kind,
                                    const MultistepHost* h, const HostParams* hp,
                                    void* stream) {
  if (h == nullptr || hp == nullptr || h->K < 1 || h->NY < 2 || h->NX < 2 ||
      static_cast<int64_t>(h->NY) * h->NX > INT32_MAX || solve_kind < 0 || solve_kind > 2 ||
      h->iter_kind < 0 || h->iter_kind > 2 ||
      ((h->bounce || h->neumann) && (h->NY < 3 || h->NX < 3)) ||
      (h->bounce && (h->wall_b < -1 || h->wall_b >= h->NY || h->wall_t < -1 ||
                     h->wall_t >= h->NY)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0:
      return launch_delta<double, double, false>(delta, solve_kind, *h, *hp, st);
    case 1:
      return launch_delta<float, float, false>(delta, solve_kind, *h, *hp, st);
    case 2:
      return launch_delta<__nv_bfloat16, float, true>(delta, solve_kind, *h, *hp, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// sizeof(MultistepHost), so the wrapper can check that its ctypes mirror
// matches.
extern "C" int lbm_multistep_host_size() { return static_cast<int>(sizeof(MultistepHost)); }
