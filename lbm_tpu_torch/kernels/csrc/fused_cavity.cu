// Lid-driven cavity steps, one pass over device memory: BGK collide, pull
// stream, the bounce-back walls, the moving lid and (stored mode) the
// guarded macros. Two entry points, for six TPU kernels of
// lbm_tpu/kernels/fused_cavity.py:
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
// alignment; none of that is carried over. Here a block of 32 x 8 threads
// owns a 32 x 8 tile of sites:
//   1. its threads collide the tile and its y-halo, 10 x 32 sites (and the
//      x neighbours inside the grid), into shared memory, each site once:
//      post-collision value P_i(y, x). A halo row comes from a strip, from
//      the block's other end, or from nowhere behind a wall
//      (cavity_site.cuh: collide_source_site);
//   2. after __syncthreads(), each thread assembles its own site: the pull,
//      the walls, the lid (cavity_site.cuh: pull_site);
//   3. stored mode computes macros_guarded of the nine new values in the
//      thread and writes rho, ux, uy; every mode writes f.
// Output buffers are always fresh (A/B): an in-place pull would race. The
// halo kernels read only the strip rows next to the shard, so strips of
// any depth >= 1 go in unchanged.
//
// Numbers: (double, double), (float, float) and (bf16, float) storage /
// compute pairs; the expression trees are cavity_site.cuh's. Built with
// -fmad=false and no fast math, the kernels equal the plain version bit for
// bit, and every shard of a cut equals the single-device step at its rows.
//
// The multistep kernel is persistent and cooperative (the pattern of
// poisson_iter.cu): a grid of at most the co-resident blocks walks the
// tiles, and grid.sync() separates the steps. Step 0 reads (and decodes)
// f, the last step writes (and encodes) f_out, the steps between ping-pong
// between two work buffers in T, so bf16 rounds once per window, as
// _make_multistep_kernel does. The lid speed of step t0 + k is computed in
// the kernel (cavity_site.cuh: lid_ramp). K is a runtime argument and the
// grid may be any size: the TPU kernel's whole-grid VMEM limit has no
// counterpart. Buffers written inside the launch are read with plain loads.
//
// Bound: the stored step must read f, rho, ux, uy once and write them
// once, 96 B/site in f32 (60 with bf16 f); the lean step 72 B/site in f32
// (36 in bf16), the halo variants plus the two strip rows; ~170 flop a site
// is far below the bytes at the f32 peak. The window reads and writes f
// once for K steps, so its bound is ~170 flop a site and step. This first
// version re-reads the halo rows (10 x 32 sites collided for 8 x 32, 1.25x
// the collisions and loads of the interior) and keeps every step's state
// in device memory (L2 at small grids); wider tiles and a register-
// resident window are later work.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "cavity_site.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace cavity;

constexpr int kTX = 32;              // tile width: one warp a row
constexpr int kTY = 8;               // tile height
constexpr int kThreads = kTX * kTY;
constexpr int kHX = kTX + 2;         // tile plus a 1-site halo
constexpr int kHY = kTY + 2;
constexpr int kHalo = kHX * kHY;

template <typename T>
struct Tile {
  T p[kQ][kHalo];   // post-collision populations of the tile and its halo
};

// One step of one tile. In / Out are the storage types read and written
// (S or T); LEAN recomputes the macros from f, else they are read from
// in.rho, in.ux, in.uy and the new ones written to rho_out, ux_out, uy_out.
template <typename In, typename Out, typename T, bool LEAN>
__device__ __forceinline__ void tile_step(const StepIn<In, T>& in, Out* f_out, T* rho_out,
                                          T* ux_out, T* uy_out, Tile<T>& sh, int tile,
                                          int tiles_x, const Geom& g, T tau, T u) {
  const int y0 = (tile / tiles_x) * kTY;
  const int x0 = (tile % tiles_x) * kTX;

  // 1. collide the tile and its halo, each site once
  for (int k = threadIdx.x; k < kHalo; k += kThreads) {
    const int hy = k / kHX;
    const int y = y0 + hy - 1, x = x0 + (k - hy * kHX) - 1;
    if (x < 0 || x >= g.NX) continue;
    T post[kQ];
    if (!collide_source_site<In, T, LEAN>(in, g, y, x, tau, post)) continue;
#pragma unroll
    for (int i = 0; i < kQ; ++i) sh.p[i][k] = post[i];
  }
  __syncthreads();

  // 2. assemble this thread's site: pull, walls, lid
  const int lx = threadIdx.x % kTX, ly = threadIdx.x / kTX;
  const int x = x0 + lx, y = y0 + ly;
  if (x < g.NX && y < g.NY) {
    const int c = (ly + 1) * kHX + (lx + 1);
    T out[kQ];
    pull_site<T>([&](int i, int dy, int dx) { return sh.p[i][c + dy * kHX + dx]; }, g, y, x, u,
                 out);
    store_site<Out, T, LEAN>(out, f_out, rho_out, ux_out, uy_out,
                             static_cast<int64_t>(g.NY) * g.NX,
                             static_cast<int64_t>(y) * g.NX + x);
  }
  __syncthreads();   // the shared tile is refilled by the next call
}

template <typename S, typename T, bool LEAN>
__global__ void __launch_bounds__(kThreads)
    cavity_step_kernel(const StepIn<S, T> in, S* f_out, T* rho_out, T* ux_out, T* uy_out,
                       int tiles_x, const Geom g, T tau, T u) {
  __shared__ Tile<T> sh;
  tile_step<S, S, T, LEAN>(in, f_out, rho_out, ux_out, uy_out, sh, blockIdx.x, tiles_x, g, tau,
                           u);
}

// every tile of one lean step, grid-stride over tiles
template <typename In, typename Out, typename T>
__device__ __forceinline__ void all_tiles(const In* src, Out* dst, Tile<T>& sh, int ntiles,
                                          int tiles_x, const Geom& g, T tau, T u) {
  const StepIn<In, T> in{src, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr};
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x)
    tile_step<In, Out, T, true>(in, dst, nullptr, nullptr, nullptr, sh, tile, tiles_x, g, tau, u);
}

template <typename S, typename T>
__global__ void __launch_bounds__(kThreads)
    cavity_multistep_kernel(const S* f, T* work_a, T* work_b, S* f_out, int tiles_x,
                            const Geom g, const Window<T> w) {
  __shared__ Tile<T> sh;
  cg::grid_group grid = cg::this_grid();
  const int ntiles = tiles_x * ((g.NY + kTY - 1) / kTY);
  for (int k = 0; k < w.K; ++k) {
    const T u = lid_ramp(w, k);
    T* prev = (k & 1) ? work_a : work_b;   // written by step k - 1
    T* next = (k & 1) ? work_b : work_a;
    if (w.K == 1) {
      all_tiles<S, S, T>(f, f_out, sh, ntiles, tiles_x, g, w.tau, u);
    } else if (k == 0) {
      all_tiles<S, T, T>(f, next, sh, ntiles, tiles_x, g, w.tau, u);
    } else if (k == w.K - 1) {
      all_tiles<T, S, T>(prev, f_out, sh, ntiles, tiles_x, g, w.tau, u);
    } else {
      all_tiles<T, T, T>(prev, next, sh, ntiles, tiles_x, g, w.tau, u);
    }
    if (k + 1 < w.K) grid.sync();
  }
}

int tiles_x_of(int NX) { return (NX + kTX - 1) / kTX; }
int64_t tiles_of(int NY, int NX) {
  return static_cast<int64_t>(tiles_x_of(NX)) * ((NY + kTY - 1) / kTY);
}

template <typename S, typename T, bool LEAN>
cudaError_t launch_step(const void* const* in, void* const* out, double u, double tau,
                        const Geom& g, cudaStream_t stream) {
  const int64_t tiles = tiles_of(g.NY, g.NX);
  if (tiles > INT32_MAX) return cudaErrorInvalidValue;
  const StepIn<S, T> si{static_cast<const S*>(in[0]), static_cast<const T*>(in[1]),
                        static_cast<const T*>(in[2]), static_cast<const T*>(in[3]),
                        static_cast<const S*>(in[4]), static_cast<const T*>(in[5]),
                        static_cast<const S*>(in[6]), static_cast<const T*>(in[7])};
  cavity_step_kernel<S, T, LEAN><<<static_cast<unsigned>(tiles), kThreads, 0, stream>>>(
      si, static_cast<S*>(out[0]), static_cast<T*>(out[1]), static_cast<T*>(out[2]),
      static_cast<T*>(out[3]), tiles_x_of(g.NX), g, static_cast<T>(tau), static_cast<T>(u));
  return cudaGetLastError();
}

template <typename S, typename T>
cudaError_t launch_multistep(const void* f, void* work_a, void* work_b, void* f_out, int t0,
                             int K, double u_lid, double sigma, double tau, Geom g,
                             cudaStream_t stream) {
  auto kernel = cavity_multistep_kernel<S, T>;
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  if (e != cudaSuccess) return e;
  if (!coop || per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  const int64_t tiles = tiles_of(g.NY, g.NX);
  const int64_t resident = static_cast<int64_t>(per_sm) * sms;
  const unsigned blocks = static_cast<unsigned>(tiles < resident ? tiles : resident);
  const S* f_in = static_cast<const S*>(f);
  T* wa = static_cast<T*>(work_a);
  T* wb = static_cast<T*>(work_b);
  S* fo = static_cast<S*>(f_out);
  int tiles_x = tiles_x_of(g.NX);
  Window<T> w = make_window<T>(t0, K, u_lid, sigma, tau);
  void* params[] = {&f_in, &wa, &wb, &fo, &tiles_x, &g, &w};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(blocks),
                                  dim3(kThreads), params, 0, stream);
  return e != cudaSuccess ? e : cudaGetLastError();
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
// work_a, work_b: (9, NY, NX) buffers of the compute type (unused when
// K == 1; work_b unused when K == 2). b_row, l_row: the rows of the bottom
// wall and the lid, -1 for none; halo rows without a wall beyond them wrap
// within the block (the single-device window passes 0 and NY - 1).
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
