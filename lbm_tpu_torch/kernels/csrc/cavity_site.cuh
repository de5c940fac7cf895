// The per-site work of the cavity kernels (fused_cavity.cu, through the
// tile program of cavity_tile.cuh): the collision of one pre-collision
// site, wherever it lies, and the pull, walls and lid of one site of the
// block a launch steps.
//
// A launch steps a block of NY x NX sites (Geom). Its y-halo rows, y = -1
// and y = NY, come from one of three places:
//   * nowhere, where a wall at the block's edge row blocks every direction
//     that would pull from them (b_row == 0 below, l_row == NY - 1 above):
//     the single-device steps, and the wall shards of a sharded step, whose
//     ring-wrapped strip beyond the wall is ignored;
//   * a strip (du, dd > 0): the last row of f_up (the rows of lower y, the
//     previous shard's) or the first row of f_dn, with the strips' stored
//     macros in stored mode (lbm_tpu/kernels/fused_cavity.py:
//     collide_stream_cavity_halo and _halo_lean);
//   * the block's other end (no strip): periodic in y within the block, the
//     _roll_y of the gated window (collide_stream_cavity_multistep_gated),
//     which runs on a shard extended by ghost rows.
// A site is collided by collide_source_site (or, in the window's resident
// route, from shared memory by collide_site). The pull then takes
// f_i(y, x) = P_i(y - cy_i, x - cx_i), except where a wall blocks that
// source: the side walls at x = 0 and x = NX - 1 on every row, the bottom
// wall on row b_row and the lid on row l_row (-1: none). Every wall rule of
// stream_cavity reflects the opposite direction of the same site, so a
// blocked direction takes P_opp(i)(y, x) whichever wall blocks it, and the
// lid adds d5 and d6 to 7 and 8 on its row (pull_site). Nothing beyond a
// wall is read, and no x halo exists.
//
// Numbers: every expression keeps the order of the JAX code and of the
// port's plain version (ops/cavity.py, ops/stream.stream_cavity_gated);
// constants are folded in double and cast once to T; px / r, py / r and
// (f - feq) / tau are IEEE divisions (div_pos: a zero dividend is its own
// quotient and skips the division, but in the window's resident route);
// the dead-cell guard compares with T(1e-10). bf16 holds f as deviations
// from the background w_i: decode float(b) + float(w_i), encode to bf16
// (nearest even) of x - float(w_i).
//
// The functions are __device__ for the kernels; with host stand-ins for
// cuda_bf16.h they build with the host's C++ compiler, and the CPU tests
// hold them bitwise against the plain versions
// (tests/test_torch_kernel_host.py).
#pragma once

#include <cuda_bf16.h>

#include <cstdint>

namespace {
namespace cavity {

constexpr int kQ = 9;

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
    *p = __float2bfloat16(v - static_cast<float>(w_of(i)));
  }
};

// x / d for d > 0 (a live density, tau): the IEEE quotient, where (ZERO)
// x = +-0 is its own (0 / d keeps x's sign) and skips the division, whose
// sequence on the card sends a zero dividend down its slow path
// (plasma_site.cuh's div_cs2). A cavity started from rest holds exact zeros
// ahead of its disturbance: the test takes the streaming kernels' time from
// rest to the seeded state's. The window's resident route, latency-bound
// on small grids where few zeros last, divides without it (7-10% faster
// at 129^2: PERF.md §6).
template <typename T, bool ZERO = true>
__device__ __forceinline__ T div_pos(T x, T d) {
  if constexpr (ZERO) return x == T(0) ? x : x / d;
  return x / d;
}

// ops/cavity.macros_guarded
template <typename T, bool ZERO = true>
__device__ __forceinline__ void macros_guarded(const T f[kQ], T& rho, T& ux, T& uy) {
  T r = f[0];
#pragma unroll
  for (int i = 1; i < kQ; ++i) r = r + f[i];
  const T px = ((((f[1] + (-f[3])) + f[5]) + (-f[6])) + (-f[7])) + f[8];
  const T py = ((((f[2] + (-f[4])) + f[5]) + f[6]) + (-f[7])) + (-f[8]);
  const bool alive = r >= T(1e-10);
  rho = alive ? r : T(0.0);
  ux = alive ? div_pos<T, ZERO>(px, r) : T(0.0);
  uy = alive ? div_pos<T, ZERO>(py, r) : T(0.0);
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
template <typename T, bool ZERO = true>
__device__ __forceinline__ void collide(const T f[kQ], T rho, T ux, T uy, T tau, T out[kQ]) {
  const T u2 = ux * ux + uy * uy;
#pragma unroll
  for (int i = 0; i < kQ; ++i)
    out[i] = f[i] - div_pos<T, ZERO>(f[i] - feq_dir(i, rho, ux, uy, u2), tau);
}

// the lean collision of one site from its populations
template <typename T, bool ZERO = true>
__device__ __forceinline__ void collide_site(const T f[kQ], T tau, T post[kQ]) {
  T rho, ux, uy;
  macros_guarded<T, ZERO>(f, rho, ux, uy);
  collide<T, ZERO>(f, rho, ux, uy, tau, post);
}

// The block a launch steps: NY x NX sites; du, dd: the depths of the
// strips below and above it (0: none, the block wraps in y); b_row, l_row:
// the rows of the bottom wall and of the lid (-1: none).
struct Geom {
  int NY, NX;
  int du, dd;
  int b_row, l_row;
};

// What a step reads: the block's populations (9, NY, NX) and, in stored
// mode, its macros rho, ux, uy (NY, NX) (null in lean mode); the strips
// f_up (9, du, NX) and mac_up (3, du, NX) below, f_dn and mac_dn (dd rows)
// above (null without strips, mac_* null in lean mode).
template <typename In, typename T>
struct StepIn {
  const In* f;
  const T *rho, *ux, *uy;
  const In* f_up;
  const T* mac_up;
  const In* f_dn;
  const T* mac_dn;
};

// Collide the pre-collision site (y, x) of the block, y in [-1, NY] and x
// in [0, NX): post gets its nine post-collision values. Returns false,
// with post untouched, for a halo row that a wall hides.
template <typename In, typename T, bool LEAN>
__device__ __forceinline__ bool collide_source_site(const StepIn<In, T>& in, const Geom& g, int y,
                                                    int x, T tau, T post[kQ]) {
  const In* fs = in.f;
  const T* mac = nullptr;   // a strip's (3, depth, NX) macros
  int64_t plane = static_cast<int64_t>(g.NY) * g.NX;
  int64_t off;
  if (y < 0 || y >= g.NY) {
    const bool below = y < 0;
    if (below ? g.b_row == 0 : g.l_row == g.NY - 1) return false;
    const int depth = below ? g.du : g.dd;
    if (depth > 0) {
      fs = below ? in.f_up : in.f_dn;
      mac = below ? in.mac_up : in.mac_dn;
      plane = static_cast<int64_t>(depth) * g.NX;
      off = static_cast<int64_t>(below ? depth - 1 : 0) * g.NX + x;
    } else {
      off = static_cast<int64_t>(below ? g.NY - 1 : 0) * g.NX + x;
    }
  } else {
    off = static_cast<int64_t>(y) * g.NX + x;
  }
  T fv[kQ];
#pragma unroll
  for (int i = 0; i < kQ; ++i) fv[i] = Io<In, T>::load(fs + i * plane + off, i);
  T rho, ux, uy;
  if constexpr (LEAN) {
    macros_guarded(fv, rho, ux, uy);
  } else if (mac != nullptr) {
    rho = mac[off];
    ux = mac[plane + off];
    uy = mac[2 * plane + off];
  } else {
    rho = in.rho[off];
    ux = in.ux[off];
    uy = in.uy[off];
  }
  collide(fv, rho, ux, uy, tau, post);
  return true;
}

// The new populations of site (y, x) of the block: the pull from the
// post-collision values post(i, dy, dx) of direction i at (y + dy, x + dx),
// the walls, then the lid of speed u (written last: it wins the corners).
template <typename T, typename Post>
__device__ __forceinline__ void pull_site(const Post& post, const Geom& g, int y, int x, T u,
                                          T out[kQ]) {
  const bool left = x == 0, right = x == g.NX - 1, bottom = y == g.b_row, top = y == g.l_row;
#pragma unroll
  for (int i = 0; i < kQ; ++i) {
    const int cx = cx_of(i), cy = cy_of(i);
    const bool blocked = (cx == 1 && left) || (cx == -1 && right) || (cy == 1 && bottom) ||
                         (cy == -1 && top);
    out[i] = blocked ? post(opp_of(i), 0, 0) : post(i, -cy, -cx);
  }
  if (top) {
    T rho_top = post(0, 0, 0);
#pragma unroll
    for (int j = 1; j < kQ; ++j) rho_top = rho_top + post(j, 0, 0);
    const T k6 = T(-6.0 * w_of(5));   // -6 w_5 == -6 w_6
    out[7] = out[7] + (k6 * rho_top) * (T(cx_of(5)) * u);
    out[8] = out[8] + (k6 * rho_top) * (T(cx_of(6)) * u);
  }
}

// Store a site's new populations at offset s of planes `plane` apart and,
// in stored mode, their guarded macros.
template <typename Out, typename T, bool LEAN>
__device__ __forceinline__ void store_site(const T out[kQ], Out* f_out, T* rho_out, T* ux_out,
                                           T* uy_out, int64_t plane, int64_t s) {
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

// A window of K lean steps from trajectory step t0.
template <typename T>
struct Window {
  T tau, u_over_sigma, u_lid, sigma;
  int t0, K;
};

template <typename T>
inline Window<T> make_window(int t0, int K, double u_lid, double sigma, double tau) {
  Window<T> w;
  w.tau = static_cast<T>(tau);
  w.u_over_sigma = static_cast<T>(u_lid / sigma);
  w.u_lid = static_cast<T>(u_lid);
  w.sigma = static_cast<T>(sigma);
  w.t0 = t0;
  w.K = K;
  return w;
}

// The lid speed of the window's step k (old codes/LBM_classic/LBM.cpp:180),
// in T as the TPU kernel computes it: t < sigma ? (u_lid / sigma) t : u_lid.
template <typename T>
__device__ __forceinline__ T lid_ramp(const Window<T>& w, int k) {
  const T t = T(w.t0) + T(k);
  return t < w.sigma ? w.u_over_sigma * t : w.u_lid;
}

}  // namespace cavity
}  // namespace
