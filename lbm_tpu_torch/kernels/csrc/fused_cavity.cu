// Lid-driven cavity steps: BGK collide, pull stream, the bounce-back
// walls, the moving lid and (stored mode) the guarded macros. Two entry
// points, for six TPU kernels of lbm_tpu/kernels/fused_cavity.py:
//
//   lbm_cavity_collide_stream  one step; replaces collide_stream_cavity
//                              (stored macros in and out) and
//                              collide_stream_cavity_lean (lean = 1: the
//                              macros recomputed from f, f only in and
//                              out), and, with strips, their y-shard
//                              variants collide_stream_cavity_halo and
//                              collide_stream_cavity_halo_lean;
//   lbm_cavity_multistep       K lean steps in one launch; replaces
//                              collide_stream_cavity_multistep (the walls
//                              at the grid's edge rows) and
//                              collide_stream_cavity_multistep_gated (on a
//                              shard extended by ghost rows: periodic in y
//                              within the block, the bottom wall and the
//                              lid at the rows the caller names).
//
// They compute what those kernels compute, which is lbm_tpu/ops/cavity.py
// (collide_dirs, macros_guarded, lid_deltas) around the streaming of
// ops/stream.py (stream_cavity; the gated kernel's step_planes). The TPU
// kernels collide a row band in VMEM, x-roll it and stitch band k-1 from
// carried rows, and the halo kernels take 8-row strips for sublane
// alignment; none of that is carried over. Both entries run the block
// programs of cavity_tile.cuh:
//   * a step is the step program: a persistent grid of blocks walks
//     strips of W x-sites by spans of rows, collides each row once
//     into a ring of four rows in shared memory and pulls the row below it;
//   * a window takes one of two routes, by size (lbm_cavity_multistep_route
//     says which): the resident route, where the grid fits the co-resident
//     blocks' shared memory and K >= 2, holds each block's band of rows in
//     shared memory for all K steps, exchanging two edge rows a step
//     through device memory with a grid barrier; the streaming route runs
//     the step program once a step over two work buffers in T, with a grid
//     barrier between steps (72 B a site a step in f32).
// Output buffers are always fresh (A/B): an in-place pull would race. The
// halo kernels read only the strip rows next to the shard, so strips of
// any depth >= 1 go in unchanged.
//
// Numbers: (double, double), (float, float) and (bf16, float) storage /
// compute pairs; the expression trees are cavity_site.cuh's. Built with
// -fmad=false and no fast math, the kernels equal the plain version bit for
// bit, and every shard of a cut equals the single-device step at its rows.
// A window reads (and decodes) f once and writes (and encodes) f_out once,
// so bf16 rounds once per window, as _make_multistep_kernel does; the lid
// speed of step t0 + k is computed in the kernel (cavity_site.cuh:
// lid_ramp). K is a runtime argument and the grid may be any size: the TPU
// kernel's whole-grid VMEM limit has no counterpart. Buffers written inside
// a launch are read after its grid barrier, the work buffers with plain
// loads, the resident route's exchange rows past L1.
//
// Bound: the stored step must read f, rho, ux, uy once and write them
// once, 96 B/site in f32 (60 with bf16 f); the lean step 72 B/site in f32
// (36 in bf16), the halo variants plus the two strip rows. The window reads
// and writes f once for K steps, so its bound is ~170 flop a site and step;
// the streaming route's floor is its work traffic, 72 B a site a step.
// A failed attribute, occupancy query or launch returns its error: there
// is no other route.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "cavity_tile.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace cavity;

// the step program's threads a block: a thread a site of the strip and one
// more warp, whose first two threads collide the strip's edge columns, so
// that no thread collides two sites a row (5-12% faster at 2048^2 than W
// threads: scripts/trace_cavity_torch.py)
template <typename T>
constexpr int kStepThreads = kRunC<T> + 32;

template <typename S, typename T, bool LEAN>
__global__ void __launch_bounds__(kStepThreads<T>)
    cavity_step_kernel(const __grid_constant__ StepTask<S, S, T, LEAN> a, const Geom g,
                       const StepPlan p, T tau, T u) {
  __shared__ T ring[kRingC<T>];
  for (int task = blockIdx.x; task < p.tasks; task += gridDim.x)
    step_task(a, g, p, task, tau, u, ring);
}

// every task of one lean step of the window's streaming route
template <typename In, typename Out, typename T>
__device__ __forceinline__ void window_pass(const In* src, Out* dst, const Geom& g,
                                            const StepPlan& p, T tau, T u, T* ring) {
  const StepTask<In, Out, T, true> a{
      {src, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr},
      dst, nullptr, nullptr, nullptr};
  for (int task = blockIdx.x; task < p.tasks; task += gridDim.x)
    step_task(a, g, p, task, tau, u, ring);
}

// The streaming route: K passes of the step program, ping-ponging between
// the work buffers in T, a grid barrier between passes.
template <typename S, typename T>
__global__ void __launch_bounds__(kStepThreads<T>)
    cavity_stream_window_kernel(const S* f, T* work_a, T* work_b, S* f_out, const Geom g,
                                const StepPlan p, const Window<T> w) {
  __shared__ T ring[kRingC<T>];
  cg::grid_group grid = cg::this_grid();
  for (int k = 0; k < w.K; ++k) {
    const T u = lid_ramp(w, k);
    T* prev = (k & 1) ? work_a : work_b;   // written by step k - 1
    T* next = (k & 1) ? work_b : work_a;
    if (w.K == 1) {
      window_pass<S, S, T>(f, f_out, g, p, w.tau, u, ring);
    } else if (k == 0) {
      window_pass<S, T, T>(f, next, g, p, w.tau, u, ring);
    } else if (k == w.K - 1) {
      window_pass<T, S, T>(prev, f_out, g, p, w.tau, u, ring);
    } else {
      window_pass<T, T, T>(prev, next, g, p, w.tau, u, ring);
    }
    if (k + 1 < w.K) grid.sync();
  }
}

// The resident route: each block's band in shared memory for the window,
// a grid barrier between a step's two phases.
template <typename S, typename T>
__global__ void __launch_bounds__(kResThreads<T>, 1)
    cavity_resident_kernel(const __grid_constant__ ResArgs<S, T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* sm = reinterpret_cast<T*>(smem);
  cg::grid_group grid = cg::this_grid();
  const int b = static_cast<int>(blockIdx.x);
  for (int k = 0; k < a.w.K; ++k) {
    res_collide(a, b, k, sm);
    grid.sync();
    res_stream(a, b, k, sm, lid_ramp(a.w, k));
  }
}

constexpr int kMaxDevices = 64;

// What a launch needs to know of the current device and of its kernel: the
// SMs, cooperative launch, and the kernel's co-resident blocks (with
// DYNAMIC, at the device's whole shared-memory opt-in, which the kernel's
// attribute is raised to, so that any smaller plan launches). Queried once
// a device and kernel: a step launches often.
struct Facts {
  int sms, coop;
  int64_t smem_optin, resident;
};

template <auto kernel, int kThreads, bool DYNAMIC>
cudaError_t facts_of(Facts& out) {
  static Facts on[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kMaxDevices && on[dev].sms > 0) {
    out = on[dev];
    return cudaSuccess;
  }
  Facts f{};
  int smem = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(&f.sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&f.coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  f.smem_optin = smem;
  if (e == cudaSuccess && DYNAMIC)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, reinterpret_cast<const void*>(kernel), kThreads, DYNAMIC ? smem : 0);
  if (e != cudaSuccess) return e;
  f.resident = static_cast<int64_t>(per_sm) * f.sms;
  if (f.resident < 1 && !DYNAMIC) return cudaErrorInvalidConfiguration;
  if (dev < kMaxDevices) on[dev] = f;
  out = f;
  return cudaSuccess;
}

template <typename S, typename T, bool LEAN>
cudaError_t launch_step(const void* const* in, void* const* out, double u, double tau,
                        const Geom& g, cudaStream_t stream) {
  Facts d{};
  const cudaError_t e = facts_of<cavity_step_kernel<S, T, LEAN>, kStepThreads<T>, false>(d);
  if (e != cudaSuccess) return e;
  const StepPlan p = step_plan<T>(g.NY, g.NX, d.resident);
  const StepTask<S, S, T, LEAN> a{
      {static_cast<const S*>(in[0]), static_cast<const T*>(in[1]),
       static_cast<const T*>(in[2]), static_cast<const T*>(in[3]),
       static_cast<const S*>(in[4]), static_cast<const T*>(in[5]),
       static_cast<const S*>(in[6]), static_cast<const T*>(in[7])},
      static_cast<S*>(out[0]), static_cast<T*>(out[1]), static_cast<T*>(out[2]),
      static_cast<T*>(out[3])};
  const int64_t blocks = p.tasks < d.resident ? p.tasks : d.resident;
  cavity_step_kernel<S, T, LEAN><<<static_cast<unsigned>(blocks), kStepThreads<T>, 0, stream>>>(
      a, g, p, static_cast<T>(tau), static_cast<T>(u));
  return cudaGetLastError();
}

// The resident route's plan on this device (blocks == 0: the streaming
// route).
template <typename S, typename T>
cudaError_t resident_plan(const Geom& g, int K, ResPlan& p) {
  Facts d{};
  const cudaError_t e = facts_of<cavity_resident_kernel<S, T>, kResThreads<T>, true>(d);
  if (e != cudaSuccess) return e;
  const int fit = d.resident < d.sms ? static_cast<int>(d.resident) : d.sms;
  p = res_plan<T>(g.NY, g.NX, K, fit, d.smem_optin);
  if (!d.coop) p.blocks = 0;
  return cudaSuccess;
}

template <typename S, typename T>
cudaError_t launch_multistep(const void* f, void* work_a, void* work_b, void* f_out, int t0,
                             int K, double u_lid, double sigma, double tau, Geom g,
                             cudaStream_t stream) {
  const Window<T> w = make_window<T>(t0, K, u_lid, sigma, tau);
  ResPlan rp{};
  cudaError_t e = resident_plan<S, T>(g, K, rp);
  if (e != cudaSuccess) return e;
  if (rp.blocks > 0) {
    const ResArgs<S, T> a{static_cast<const S*>(f), static_cast<S*>(f_out),
                          static_cast<T*>(work_a), g, w, rp};
    void* params[] = {const_cast<ResArgs<S, T>*>(&a)};
    e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(cavity_resident_kernel<S, T>),
                                    dim3(rp.blocks), dim3(kResThreads<T>), params,
                                    static_cast<size_t>(rp.smem), stream);
    return e != cudaSuccess ? e : cudaGetLastError();
  }
  const auto kernel = cavity_stream_window_kernel<S, T>;
  Facts d{};
  e = facts_of<cavity_stream_window_kernel<S, T>, kStepThreads<T>, false>(d);
  if (e != cudaSuccess) return e;
  if (!d.coop) return cudaErrorCooperativeLaunchTooLarge;
  StepPlan p = step_plan<T>(g.NY, g.NX, d.resident);
  const unsigned blocks = static_cast<unsigned>(p.tasks < d.resident ? p.tasks : d.resident);
  const S* f_in = static_cast<const S*>(f);
  T* wa = static_cast<T*>(work_a);
  T* wb = static_cast<T*>(work_b);
  S* fo = static_cast<S*>(f_out);
  Window<T> wv = w;
  void* params[] = {&f_in, &wa, &wb, &fo, &g, &p, &wv};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(blocks),
                                  dim3(kStepThreads<T>), params, 0, stream);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <typename S, typename T>
int route_of(const Geom& g, int K) {
  ResPlan p{};
  const cudaError_t e = resident_plan<S, T>(g, K, p);
  return e != cudaSuccess ? -static_cast<int>(e) : p.blocks;
}

bool bad_geom(const Geom& g) {
  return g.NY <= 0 || g.NX <= 0 || static_cast<int64_t>(g.NY) * g.NX > INT32_MAX || g.du < 0 ||
         g.dd < 0 || g.b_row < -1 || g.b_row >= g.NY || g.l_row < -1 || g.l_row >= g.NY;
}

}  // namespace

// One step. mode: 0 = f64 storage and compute, 1 = f32, 2 = bf16 f with f32
// compute and f32 macros; lean: 1 recomputes the macros from f (rho, ux,
// uy, mac_up, mac_dn and the macro outputs unused, may be null). f, f_out:
// (9, NY, NX); rho, ux, uy and their outputs: (NY, NX) in the compute type;
// f_up, mac_up: (9, du, NX), (3, du, NX), the strips of lower y, whose last
// row is read; f_dn, mac_dn: (9, dd, NX), (3, dd, NX), of higher y, whose
// first row is read (du = dd = 0: no strips, all null); b_row, l_row: the
// rows of the bottom wall and the lid, -1 for none (the single-device step
// passes 0 and NY - 1; a row without a wall beyond it needs a strip);
// u_lid_dyn: the lid speed of this step (a value of the compute type).
// Returns the cudaError_t of the launch (0 on success); asynchronous on
// `stream`; the caller owns every buffer.
extern "C" int lbm_cavity_collide_stream(int mode, int lean, const void* f, const void* rho,
                                         const void* ux, const void* uy, const void* f_up,
                                         const void* mac_up, const void* f_dn,
                                         const void* mac_dn, void* f_out, void* rho_out,
                                         void* ux_out, void* uy_out, double u_lid_dyn,
                                         double tau, int NY, int NX, int du, int dd, int b_row,
                                         int l_row, void* stream) {
  const Geom g{NY, NX, du, dd, b_row, l_row};
  if (bad_geom(g) || (b_row != 0 && du < 1) || (l_row != NY - 1 && dd < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const void* const in[] = {f, rho, ux, uy, f_up, mac_up, f_dn, mac_dn};
  void* const out[] = {f_out, rho_out, ux_out, uy_out};
  switch (mode * 2 + (lean ? 1 : 0)) {
    case 0: return launch_step<double, double, false>(in, out, u_lid_dyn, tau, g, st);
    case 1: return launch_step<double, double, true>(in, out, u_lid_dyn, tau, g, st);
    case 2: return launch_step<float, float, false>(in, out, u_lid_dyn, tau, g, st);
    case 3: return launch_step<float, float, true>(in, out, u_lid_dyn, tau, g, st);
    case 4: return launch_step<__nv_bfloat16, float, false>(in, out, u_lid_dyn, tau, g, st);
    case 5: return launch_step<__nv_bfloat16, float, true>(in, out, u_lid_dyn, tau, g, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K lean steps from step t0 in one cooperative launch; modes as above.
// work_a, work_b: buffers of the compute type. On the streaming route
// (lbm_cavity_multistep_route returns 0) both are (9, NY, NX) (unused when
// K == 1; work_b unused when K == 2); on the resident route work_a holds
// the bands' edge-row exchange, 12 x blocks x NX values (blocks: what
// lbm_cavity_multistep_route returns), and work_b is unused. b_row, l_row:
// the rows of the bottom wall and the lid, -1 for none; halo rows without a
// wall beyond them wrap within the block (the single-device window passes 0
// and NY - 1).
extern "C" int lbm_cavity_multistep(int mode, const void* f, void* work_a, void* work_b,
                                    void* f_out, int t0, int k_steps, double u_lid, double sigma,
                                    double tau, int NY, int NX, int b_row, int l_row,
                                    void* stream) {
  const Geom g{NY, NX, 0, 0, b_row, l_row};
  if (bad_geom(g) || k_steps < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0:
      return launch_multistep<double, double>(f, work_a, work_b, f_out, t0, k_steps, u_lid,
                                              sigma, tau, g, st);
    case 1:
      return launch_multistep<float, float>(f, work_a, work_b, f_out, t0, k_steps, u_lid,
                                            sigma, tau, g, st);
    case 2:
      return launch_multistep<__nv_bfloat16, float>(f, work_a, work_b, f_out, t0, k_steps,
                                                    u_lid, sigma, tau, g, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Which route lbm_cavity_multistep takes for K steps of an NY x NX grid in
// `mode` on the current device: the resident route's blocks (> 0), 0 the
// streaming route, a negative cudaError_t if a query failed.
extern "C" int lbm_cavity_multistep_route(int mode, int k_steps, int NY, int NX) {
  const Geom g{NY, NX, 0, 0, 0, NY - 1};
  if (bad_geom(g) || k_steps < 1) return -static_cast<int>(cudaErrorInvalidValue);
  switch (mode) {
    case 0: return route_of<double, double>(g, k_steps);
    case 1: return route_of<float, float>(g, k_steps);
    case 2: return route_of<__nv_bfloat16, float>(g, k_steps);
    default: return -static_cast<int>(cudaErrorInvalidValue);
  }
}
