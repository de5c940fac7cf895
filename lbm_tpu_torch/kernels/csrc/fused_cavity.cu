// Lid-driven cavity step, one pass over device memory: BGK collide, pull
// stream, three bounce-back walls, the moving lid and (stored mode) the
// guarded macros. Three entry points:
//
//   lbm_cavity_collide_stream       replaces lbm_tpu/kernels/fused_cavity.py:
//                                   collide_stream_cavity (stored macros in
//                                   and out);
//   lbm_cavity_collide_stream_lean  replaces collide_stream_cavity_lean (the
//                                   macros recomputed from f, f only in and
//                                   out);
//   lbm_cavity_multistep            replaces collide_stream_cavity_multistep
//                                   (K lean steps in one launch).
//
// They compute what those kernels compute, which is lbm_tpu/ops/cavity.py
// (collide_dirs, macros_guarded, lid_deltas) around ops/stream.py:
// stream_cavity. The TPU kernels collide a row band in VMEM, x-roll it and
// stitch band k-1 from carried rows; none of that is carried over. Here a
// block of 32 x 8 threads owns a 32 x 8 tile of sites:
//   1. its threads collide the tile and a 1-site halo (34 x 10 sites) into
//      shared memory, each site once: post-collision value P_i(y, x);
//   2. after __syncthreads(), each thread assembles its own site: the pull
//      f_i(y, x) = P_i(y - cy_i, x - cx_i), except where that source lies
//      outside the grid. Those are exactly the directions the walls
//      overwrite, and every wall rule of stream_cavity (left 1<-3, 8<-6,
//      5<-7; right 3<-1, 7<-5, 6<-8; bottom 2<-4, 5<-7, 6<-8; lid 4<-2,
//      7<-5 + d5, 8<-6 + d6) reflects the opposite direction of the same
//      site. So a blocked direction takes P_opp(i)(y, x), whichever wall
//      blocks it, and the lid, written last, adds d5 and d6 to 7 and 8 on
//      the top row, corners included. Nothing outside the grid is read.
//      d_k = (T(-6 w_k) * rho_top) * (cx_k * u) with rho_top the 0..8 sum
//      of the site's own P.
//   3. stored mode computes macros_guarded of the nine new values in the
//      thread and writes rho, ux, uy; every mode writes f.
// Output buffers are always fresh (A/B): an in-place pull would race.
//
// Numbers: (double, double), (float, float) and (bf16, float) storage /
// compute pairs. bf16 holds f as deviations from the background w_i
// (models/cavity.decode_f): decode float(b) + float(w_i), encode
// __float2bfloat16_rn(x - float(w_i)), the JAX _decode_dir / _encode_dir.
// Every expression keeps the order of the JAX code and of the port's plain
// version; constants are folded in double and cast once to T; (f - feq) /
// tau is an IEEE division by T(tau); the dead-cell guard compares with
// T(1e-10). Built with -fmad=false and no fast math, the kernels equal the
// plain version bit for bit.
//
// The multistep kernel is persistent and cooperative (the pattern of
// poisson_iter.cu): a grid of at most the co-resident blocks walks the
// tiles, and grid.sync() separates the steps. Step 0 reads (and decodes)
// f, the last step writes (and encodes) f_out, the steps between ping-pong
// between two work buffers in T, so bf16 rounds once per window, as
// _make_multistep_kernel does. The lid speed of step t0 + k is computed in
// the kernel as t < T(sigma) ? T(u_lid / sigma) * t : T(u_lid), with
// t = T(t0) + T(k). K is a runtime argument and the grid may be any size:
// the TPU kernel's whole-grid VMEM limit has no counterpart. Buffers
// written inside the launch are read with plain loads.
//
// Bound: the stored kernel must read f, rho, ux, uy once and write them
// once, 96 B/site in f32 (60 with bf16 f); the lean kernel 72 B/site in
// f32 (36 in bf16); ~170 flop a site is far below the bytes at the f32
// peak. The multistep window reads and writes f once for K steps, so its
// bound is ~170 flop a site and step. This first version re-reads the
// halo ring (10 x 34 for 8 x 32 sites, 1.33x the collisions and loads of
// the interior) and keeps every step's state in device memory (L2 at
// small grids); wider tiles and a register-resident window are later work.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kQ = 9;
constexpr int kTX = 32;              // tile width: one warp a row
constexpr int kTY = 8;               // tile height
constexpr int kThreads = kTX * kTY;
constexpr int kHX = kTX + 2;         // tile plus a 1-site halo
constexpr int kHY = kTY + 2;
constexpr int kHalo = kHX * kHY;

__host__ __device__ constexpr int cx_of(int i) {
  return (i == 1 || i == 5 || i == 8) ? 1 : ((i == 3 || i == 6 || i == 7) ? -1 : 0);
}
__host__ __device__ constexpr int cy_of(int i) {
  return (i == 2 || i == 5 || i == 6) ? 1 : ((i == 4 || i == 7 || i == 8) ? -1 : 0);
}
// 0 3 4 1 2 7 8 5 6
__host__ __device__ constexpr int opp_of(int i) {
  return i == 0 ? 0 : (i < 5 ? (i + 1) % 4 + 1 : (i + 1) % 4 + 5);
}
__host__ __device__ constexpr double w_of(int i) {
  return i == 0 ? 4.0 / 9.0 : (i < 5 ? 1.0 / 9.0 : 1.0 / 36.0);
}

// storage <-> compute: identity for native storage, the background-delta
// code for bf16
template <typename S, typename T>
struct Io {
  static __device__ __forceinline__ T load(const S* p, int) { return *p; }
  static __device__ __forceinline__ void store(S* p, int, T v) { *p = v; }
};
template <>
struct Io<__nv_bfloat16, float> {
  static __device__ __forceinline__ float load(const __nv_bfloat16* p, int i) {
    return __bfloat162float(*p) + static_cast<float>(w_of(i));
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, int i, float v) {
    *p = __float2bfloat16_rn(v - static_cast<float>(w_of(i)));
  }
};

// ops/cavity.macros_guarded
template <typename T>
__device__ __forceinline__ void macros_guarded(const T f[kQ], T& rho, T& ux, T& uy) {
  T r = f[0];
#pragma unroll
  for (int i = 1; i < kQ; ++i) r = r + f[i];
  const T px = ((((f[1] + (-f[3])) + f[5]) + (-f[6])) + (-f[7])) + f[8];
  const T py = ((((f[2] + (-f[4])) + f[5]) + f[6]) + (-f[7])) + (-f[8]);
  const bool alive = r >= T(1e-10);
  rho = alive ? r : T(0.0);
  ux = alive ? px / r : T(0.0);
  uy = alive ? py / r : T(0.0);
}

// ops/cavity.feq_dir, zero-velocity terms elided as there
template <typename T>
__device__ __forceinline__ T feq_dir(int i, T rho, T ux, T uy, T u2) {
  const int cx = cx_of(i), cy = cy_of(i);
  if (cx == 0 && cy == 0) return (T(w_of(0)) * rho) * (T(1.0) - T(1.5) * u2);
  T cu;
  if (cx != 0 && cy != 0) {
    cu = T(cx) * ux + T(cy) * uy;
  } else if (cx != 0) {
    cu = T(cx) * ux;
  } else {
    cu = T(cy) * uy;
  }
  return (T(w_of(i)) * rho) * (((T(1.0) + T(3.0) * cu) + (T(4.5) * cu) * cu) - T(1.5) * u2);
}

// ops/cavity.collide_dirs
template <typename T>
__device__ __forceinline__ void collide(const T f[kQ], T rho, T ux, T uy, T tau, T out[kQ]) {
  const T u2 = ux * ux + uy * uy;
#pragma unroll
  for (int i = 0; i < kQ; ++i) out[i] = f[i] - (f[i] - feq_dir(i, rho, ux, uy, u2)) / tau;
}

template <typename T>
struct Tile {
  T p[kQ][kHalo];   // post-collision populations of the tile and its halo
};

// One step of one tile. In / Out are the storage types read and written
// (S or T); LEAN recomputes the macros from f, else they are read from
// rho_in, ux_in, uy_in and the new ones written to rho_out, ux_out, uy_out.
template <typename In, typename Out, typename T, bool LEAN>
__device__ __forceinline__ void tile_step(const In* f_in, const T* rho_in, const T* ux_in,
                                          const T* uy_in, Out* f_out, T* rho_out, T* ux_out,
                                          T* uy_out, Tile<T>& sh, int tile, int tiles_x, int NY,
                                          int NX, T tau, T u) {
  const int64_t plane = static_cast<int64_t>(NY) * NX;
  const int y0 = (tile / tiles_x) * kTY;
  const int x0 = (tile % tiles_x) * kTX;

  // 1. collide the tile and its halo, each site once
  for (int k = threadIdx.x; k < kHalo; k += kThreads) {
    const int hy = k / kHX;
    const int y = y0 + hy - 1, x = x0 + (k - hy * kHX) - 1;
    if (y < 0 || y >= NY || x < 0 || x >= NX) continue;
    const int64_t s = static_cast<int64_t>(y) * NX + x;
    T fv[kQ];
#pragma unroll
    for (int i = 0; i < kQ; ++i) fv[i] = Io<In, T>::load(f_in + i * plane + s, i);
    T rho, ux, uy;
    if constexpr (LEAN) {
      macros_guarded(fv, rho, ux, uy);
    } else {
      rho = rho_in[s];
      ux = ux_in[s];
      uy = uy_in[s];
    }
    T post[kQ];
    collide(fv, rho, ux, uy, tau, post);
#pragma unroll
    for (int i = 0; i < kQ; ++i) sh.p[i][k] = post[i];
  }
  __syncthreads();

  // 2. assemble this thread's site: pull, walls, lid
  const int lx = threadIdx.x % kTX, ly = threadIdx.x / kTX;
  const int x = x0 + lx, y = y0 + ly;
  if (x < NX && y < NY) {
    const int c = (ly + 1) * kHX + (lx + 1);
    const bool left = x == 0, right = x == NX - 1, bottom = y == 0, top = y == NY - 1;
    T out[kQ];
#pragma unroll
    for (int i = 0; i < kQ; ++i) {
      const int cx = cx_of(i), cy = cy_of(i);
      const bool blocked = (cx == 1 && left) || (cx == -1 && right) || (cy == 1 && bottom) ||
                           (cy == -1 && top);
      out[i] = blocked ? sh.p[opp_of(i)][c] : sh.p[i][c - cy * kHX - cx];
    }
    if (top) {
      T rho_top = sh.p[0][c];
#pragma unroll
      for (int j = 1; j < kQ; ++j) rho_top = rho_top + sh.p[j][c];
      const T k6 = T(-6.0 * w_of(5));   // -6 w_5 == -6 w_6
      out[7] = out[7] + (k6 * rho_top) * (T(cx_of(5)) * u);
      out[8] = out[8] + (k6 * rho_top) * (T(cx_of(6)) * u);
    }
    const int64_t s = static_cast<int64_t>(y) * NX + x;
#pragma unroll
    for (int i = 0; i < kQ; ++i) Io<Out, T>::store(f_out + i * plane + s, i, out[i]);
    if constexpr (!LEAN) {
      T rho, ux, uy;
      macros_guarded(out, rho, ux, uy);
      rho_out[s] = rho;
      ux_out[s] = ux;
      uy_out[s] = uy;
    }
  }
  __syncthreads();   // the shared tile is refilled by the next call
}

template <typename S, typename T, bool LEAN>
__global__ void __launch_bounds__(kThreads)
    cavity_step_kernel(const S* f, const T* rho, const T* ux, const T* uy, S* f_out, T* rho_out,
                       T* ux_out, T* uy_out, int tiles_x, int NY, int NX, T tau, T u) {
  __shared__ Tile<T> sh;
  tile_step<S, S, T, LEAN>(f, rho, ux, uy, f_out, rho_out, ux_out, uy_out, sh, blockIdx.x,
                           tiles_x, NY, NX, tau, u);
}

template <typename T>
struct Window {
  T tau, u_over_sigma, u_lid, sigma;
  int t0, K;
};

// every tile of one lean step, grid-stride over tiles
template <typename In, typename Out, typename T>
__device__ __forceinline__ void all_tiles(const In* src, Out* dst, Tile<T>& sh, int ntiles,
                                          int tiles_x, int NY, int NX, T tau, T u) {
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x)
    tile_step<In, Out, T, true>(src, nullptr, nullptr, nullptr, dst, nullptr, nullptr, nullptr,
                                sh, tile, tiles_x, NY, NX, tau, u);
}

template <typename S, typename T>
__global__ void __launch_bounds__(kThreads)
    cavity_multistep_kernel(const S* f, T* work_a, T* work_b, S* f_out, int tiles_x, int NY,
                            int NX, const Window<T> w) {
  __shared__ Tile<T> sh;
  cg::grid_group grid = cg::this_grid();
  const int ntiles = tiles_x * ((NY + kTY - 1) / kTY);
  for (int k = 0; k < w.K; ++k) {
    // lid ramp (old codes/LBM_classic/LBM.cpp:180), in T as the TPU kernel
    const T t = T(w.t0) + T(k);
    const T u = t < w.sigma ? w.u_over_sigma * t : w.u_lid;
    T* prev = (k & 1) ? work_a : work_b;   // written by step k - 1
    T* next = (k & 1) ? work_b : work_a;
    if (w.K == 1) {
      all_tiles<S, S, T>(f, f_out, sh, ntiles, tiles_x, NY, NX, w.tau, u);
    } else if (k == 0) {
      all_tiles<S, T, T>(f, next, sh, ntiles, tiles_x, NY, NX, w.tau, u);
    } else if (k == w.K - 1) {
      all_tiles<T, S, T>(prev, f_out, sh, ntiles, tiles_x, NY, NX, w.tau, u);
    } else {
      all_tiles<T, T, T>(prev, next, sh, ntiles, tiles_x, NY, NX, w.tau, u);
    }
    if (k + 1 < w.K) grid.sync();
  }
}

int tiles_x_of(int NX) { return (NX + kTX - 1) / kTX; }
int64_t tiles_of(int NY, int NX) {
  return static_cast<int64_t>(tiles_x_of(NX)) * ((NY + kTY - 1) / kTY);
}

template <typename S, typename T, bool LEAN>
cudaError_t launch_step(const void* f, const void* rho, const void* ux, const void* uy,
                        void* f_out, void* rho_out, void* ux_out, void* uy_out, double u,
                        double tau, int NY, int NX, cudaStream_t stream) {
  const int64_t tiles = tiles_of(NY, NX);
  if (tiles > INT32_MAX) return cudaErrorInvalidValue;
  cavity_step_kernel<S, T, LEAN><<<static_cast<unsigned>(tiles), kThreads, 0, stream>>>(
      static_cast<const S*>(f), static_cast<const T*>(rho), static_cast<const T*>(ux),
      static_cast<const T*>(uy), static_cast<S*>(f_out), static_cast<T*>(rho_out),
      static_cast<T*>(ux_out), static_cast<T*>(uy_out), tiles_x_of(NX), NY, NX,
      static_cast<T>(tau), static_cast<T>(u));
  return cudaGetLastError();
}

template <typename S, typename T>
cudaError_t launch_multistep(const void* f, void* work_a, void* work_b, void* f_out, int t0,
                             int K, double u_lid, double sigma, double tau, int NY, int NX,
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
  const int64_t tiles = tiles_of(NY, NX);
  const int64_t resident = static_cast<int64_t>(per_sm) * sms;
  const unsigned blocks = static_cast<unsigned>(tiles < resident ? tiles : resident);
  const S* f_in = static_cast<const S*>(f);
  T* wa = static_cast<T*>(work_a);
  T* wb = static_cast<T*>(work_b);
  S* fo = static_cast<S*>(f_out);
  int tiles_x = tiles_x_of(NX);
  Window<T> w;
  w.tau = static_cast<T>(tau);
  w.u_over_sigma = static_cast<T>(u_lid / sigma);
  w.u_lid = static_cast<T>(u_lid);
  w.sigma = static_cast<T>(sigma);
  w.t0 = t0;
  w.K = K;
  void* params[] = {&f_in, &wa, &wb, &fo, &tiles_x, &NY, &NX, &w};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(blocks),
                                  dim3(kThreads), params, 0, stream);
  return e != cudaSuccess ? e : cudaGetLastError();
}

bool bad_grid(int NY, int NX) {
  return NY <= 0 || NX <= 0 || static_cast<int64_t>(NY) * NX > INT32_MAX;
}

}  // namespace

// mode: 0 = f64 storage and compute, 1 = f32, 2 = bf16 f with f32 compute
// and f32 macros. f, f_out: (9, NY, NX); rho, ux, uy and their outputs:
// (NY, NX) in the compute type; u_lid_dyn: the lid speed of this step (a
// value of the compute type). Returns the cudaError_t of the launch (0 on
// success); asynchronous on `stream`; the caller owns every buffer.
extern "C" int lbm_cavity_collide_stream(int mode, const void* f, const void* rho,
                                         const void* ux, const void* uy, void* f_out,
                                         void* rho_out, void* ux_out, void* uy_out,
                                         double u_lid_dyn, double tau, int NY, int NX,
                                         void* stream) {
  if (bad_grid(NY, NX)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0:
      return launch_step<double, double, false>(f, rho, ux, uy, f_out, rho_out, ux_out, uy_out,
                                                u_lid_dyn, tau, NY, NX, st);
    case 1:
      return launch_step<float, float, false>(f, rho, ux, uy, f_out, rho_out, ux_out, uy_out,
                                              u_lid_dyn, tau, NY, NX, st);
    case 2:
      return launch_step<__nv_bfloat16, float, false>(f, rho, ux, uy, f_out, rho_out, ux_out,
                                                      uy_out, u_lid_dyn, tau, NY, NX, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Lean step: f in, f out; modes as above.
extern "C" int lbm_cavity_collide_stream_lean(int mode, const void* f, void* f_out,
                                              double u_lid_dyn, double tau, int NY, int NX,
                                              void* stream) {
  if (bad_grid(NY, NX)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0:
      return launch_step<double, double, true>(f, nullptr, nullptr, nullptr, f_out, nullptr,
                                               nullptr, nullptr, u_lid_dyn, tau, NY, NX, st);
    case 1:
      return launch_step<float, float, true>(f, nullptr, nullptr, nullptr, f_out, nullptr,
                                             nullptr, nullptr, u_lid_dyn, tau, NY, NX, st);
    case 2:
      return launch_step<__nv_bfloat16, float, true>(f, nullptr, nullptr, nullptr, f_out,
                                                     nullptr, nullptr, nullptr, u_lid_dyn, tau,
                                                     NY, NX, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K lean steps from step t0 in one cooperative launch; modes as above.
// work_a, work_b: (9, NY, NX) buffers of the compute type (unused when
// K == 1; work_b unused when K == 2).
extern "C" int lbm_cavity_multistep(int mode, const void* f, void* work_a, void* work_b,
                                    void* f_out, int t0, int k_steps, double u_lid, double sigma,
                                    double tau, int NY, int NX, void* stream) {
  if (bad_grid(NY, NX) || k_steps < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0:
      return launch_multistep<double, double>(f, work_a, work_b, f_out, t0, k_steps, u_lid,
                                              sigma, tau, NY, NX, st);
    case 1:
      return launch_multistep<float, float>(f, work_a, work_b, f_out, t0, k_steps, u_lid,
                                            sigma, tau, NY, NX, st);
    case 2:
      return launch_multistep<__nv_bfloat16, float>(f, work_a, work_b, f_out, t0, k_steps,
                                                    u_lid, sigma, tau, NY, NX, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
