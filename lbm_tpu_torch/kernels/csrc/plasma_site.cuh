// The arithmetic of the plasma's D2Q9 collide, one species of one site at
// a time: the one copy that the tile program (plasma_tile.cuh) runs for the
// per-step kernel (fused_step.cu) and for every collide stage of the K-step
// window kernel (fused_multistep.cu), and that the per-site halo kernel
// (halo_site.cuh) composes into a whole site (collide_site).
//
// moments, pair_vel, collide_species and rho_q_of compute what
// lbm_tpu/ops/macros.update_macro + ops/equilibrium + ops/collide compute:
//   * moments (pass 1) sums one species' 9 f and 9 g at a site in the
//     order of ops/macros.py (directions 0..8; the exact-equality guard
//     px == +-rho depends on it) and applies the guards and the half-force
//     shift;
//   * pair_vel forms a mixture velocity set from the three species'
//     moments, rho_q_of the site's charge density (the signed clamp);
//   * collide_species (pass 2) goes direction by direction: it reads f_s[i]
//     and g_s[i], rebuilds w_i * poly_i of the species' three velocity
//     sets, collides with the expression trees of ops/collide.py and hands
//     each pair of values to the caller, which places it.
// The populations are read through a pointer to direction 0 and a pitch
// between directions: the tile program keeps them in shared memory.
//
// Numbers: storage/compute type pairs are (double, double), (float, float)
// and (bf16, float). bf16 converts only through __bfloat162float /
// __float2bfloat16 (round to nearest even, like torch's .to()). The bf16
// mode's partial-fraction thermal term (FAST) uses the EXACT reciprocal
// 1/x, as the port's plain version does; the TPU kernels' approximate
// reciprocal is not reproduced. Every 1/x is recip's correctly rounded
// reciprocal (the quotient bit for bit); the other divisions (the force
// term's cu cE / cs2, -(rho u^2) / kb, the combined thermal form's n / d)
// are IEEE quotients, as ops/collide._true_div makes torch divide (a
// divisor-specific fold of cu cE / cs2, bitwise on all 2^32 floats, ran no
// faster than div_cs2: PERF.md §6).
// Constants are folded in double on the host, where the JAX code folds
// Python floats, and cast once to the compute type. Build with -fmad=false and without fast math: the moment
// sums feed exact-equality guards, and the native rounding is part of the
// golden trajectory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kQ = 9;
constexpr int kS = 3;

__host__ __device__ constexpr int cx_of(int i) {
  return (i == 1 || i == 5 || i == 8) ? 1 : ((i == 3 || i == 6 || i == 7) ? -1 : 0);
}
__host__ __device__ constexpr int cy_of(int i) {
  return (i == 2 || i == 5 || i == 6) ? 1 : ((i == 4 || i == 7 || i == 8) ? -1 : 0);
}
__host__ __device__ constexpr int opp_of(int i) {
  return i == 0 ? 0 : (i < 5 ? (i + 1) % 4 + 1 : (i - 3) % 4 + 5);
}
__host__ __device__ constexpr double w_of(int i) {
  return i == 0 ? 4.0 / 9.0 : (i < 5 ? 1.0 / 9.0 : 1.0 / 36.0);
}
// species s collides with pairs (ei, en, in): s=0 -> (0, 1), 1 -> (0, 2),
// 2 -> (1, 2); the pair velocities are of species (0,1), (0,2), (1,2)
__host__ __device__ constexpr int pair1_of(int s) { return s == 2 ? 1 : 0; }
__host__ __device__ constexpr int pair2_of(int s) { return s == 0 ? 1 : 2; }

}  // namespace

// Host-side constants, all in double. The ctypes Structure in
// lbm_tpu_torch/kernels/fused_step.py mirrors this layout field for field.
struct HostParams {
  double neutral_ref;     // rho_n background of the delta-stored neutral
  double half_qom[3];     // 0.5 * q_s / m_s
  double qom_i, qom_e;    // rho_q = qom_i rho_i + qom_e rho_e
  double inv_cs2, half_inv_cs2, half_inv_cs2_sq, cs2, kb;
  double charged[3];      // 1.0 where q_s != 0
  double inv[3][3];       // 1/tau of (self, pair1, pair2)
  double keep[3];         // 1 - sum(inv)
  double one_minus_keep[3];
  double force_c[3];      // q_s / m_s / cs2
  double force_t[3];      // 1 - 1/(2 tau_s)
  double tt_a[3][3];      // 2 r^2 - 2 r,  r = 1 - inv
  double tt_b[3][3];      // 4 r
  double active[3][3];    // 1.0 where r != 0
  double cs_a[3][3];      // r^2 - r
  double cs_b[3][3];      // r
  double offs[3][3];      // 2 r
  double cs9_a[3][3];     // (r^2 - r) / 9
  double cs9_b[3][3];     // r / 9
  double offs9[3][3];     // 2 r / 9
};

namespace {

template <typename T>
struct Params {
  T neutral_ref;
  T half_qom[3];
  T qom_i, qom_e;
  T inv_cs2, half_inv_cs2, half_inv_cs2_sq, cs2, kb;
  bool charged[3];
  T inv[3][3];
  T keep[3];
  T one_minus_keep[3];
  T force_c[3];
  T force_t[3];
  T tt_a[3][3];
  T tt_b[3][3];
  bool active[3][3];
  T cs_a[3][3];
  T cs_b[3][3];
  T offs[3][3];
  T cs9_a[3][3];
  T cs9_b[3][3];
  T offs9[3][3];
};

template <typename T>
Params<T> cast_params(const HostParams& h) {
  Params<T> p;
  p.neutral_ref = static_cast<T>(h.neutral_ref);
  p.qom_i = static_cast<T>(h.qom_i);
  p.qom_e = static_cast<T>(h.qom_e);
  p.inv_cs2 = static_cast<T>(h.inv_cs2);
  p.half_inv_cs2 = static_cast<T>(h.half_inv_cs2);
  p.half_inv_cs2_sq = static_cast<T>(h.half_inv_cs2_sq);
  p.cs2 = static_cast<T>(h.cs2);
  p.kb = static_cast<T>(h.kb);
  for (int s = 0; s < kS; ++s) {
    p.half_qom[s] = static_cast<T>(h.half_qom[s]);
    p.charged[s] = h.charged[s] != 0.0;
    p.keep[s] = static_cast<T>(h.keep[s]);
    p.one_minus_keep[s] = static_cast<T>(h.one_minus_keep[s]);
    p.force_c[s] = static_cast<T>(h.force_c[s]);
    p.force_t[s] = static_cast<T>(h.force_t[s]);
    for (int k = 0; k < 3; ++k) {
      p.inv[s][k] = static_cast<T>(h.inv[s][k]);
      p.tt_a[s][k] = static_cast<T>(h.tt_a[s][k]);
      p.tt_b[s][k] = static_cast<T>(h.tt_b[s][k]);
      p.active[s][k] = h.active[s][k] != 0.0;
      p.cs_a[s][k] = static_cast<T>(h.cs_a[s][k]);
      p.cs_b[s][k] = static_cast<T>(h.cs_b[s][k]);
      p.offs[s][k] = static_cast<T>(h.offs[s][k]);
      p.cs9_a[s][k] = static_cast<T>(h.cs9_a[s][k]);
      p.cs9_b[s][k] = static_cast<T>(h.cs9_b[s][k]);
      p.offs9[s][k] = static_cast<T>(h.offs9[s][k]);
    }
  }
  return p;
}

template <typename S, typename T>
struct Io {
  static __device__ __forceinline__ T load(const S* p) { return *p; }
  static __device__ __forceinline__ void store(S* p, T v) { *p = v; }
};
template <>
struct Io<__nv_bfloat16, float> {
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16(v);
  }
};

// 1 / x, correctly rounded: the IEEE reciprocal, which is the quotient
// 1 / x bit for bit and on the card skips the division's dividend checks
__device__ __forceinline__ float recip(float x) {
#if defined(__CUDA_ARCH__)
  return __frcp_rn(x);
#else
  return 1.0f / x;
#endif
}
__device__ __forceinline__ double recip(double x) {
#if defined(__CUDA_ARCH__)
  return __drcp_rn(x);
#else
  return 1.0 / x;
#endif
}

// x / cs2, the force term's division: the IEEE quotient, where x = +-0 is
// its own (cs2 > 0) and skips the division's sequence; the divisor read
// from the parameters, not held in a register (the per-step kernel ran
// 17% faster so, at 2048^2 f32: PERF.md §6)
template <typename T>
__device__ __forceinline__ T div_cs2(T x, const Params<T>& p) {
  return x == T(0) ? x : x / p.cs2;
}

template <typename T>
__device__ __forceinline__ bool alive(T r) {
  return r >= T(1e-10);
}

// a[s] for a species index known only at run time, without indexing a
// register array (which would put it in local memory)
template <typename T>
__device__ __forceinline__ T pick(int s, const T (&a)[kS]) {
  return s == 0 ? a[0] : (s == 1 ? a[1] : a[2]);
}

// One velocity set: (ux, uy) and |u|^2 / (2 cs2).
template <typename T>
struct Vel {
  T x, y, u2t;
};

template <typename T>
__device__ __forceinline__ Vel<T> vel(T ux, T uy, const Params<T>& p) {
  return {ux, uy, (ux * ux + uy * uy) * p.half_inv_cs2};
}

template <typename T>
__device__ __forceinline__ T cu_of(int i, const Vel<T>& v) {
  return T(cx_of(i)) * v.x + T(cy_of(i)) * v.y;
}

// w_i * poly_i (ops/equilibrium.equilibrium_wpolys); c1 = 1 / cs2,
// c2 = 1 / (2 cs2^2)
template <typename T>
__device__ __forceinline__ T wpoly(int i, const Vel<T>& v, T c1, T c2) {
  const T cu = cu_of(i, v);
  return T(w_of(i)) * (T(1.0) + cu * c1 + (cu * cu) * c2 - v.u2t);
}

// w_i * (poly_i - 1) (ops/equilibrium.equilibrium_wpolys_dev)
template <typename T>
__device__ __forceinline__ T wpoly_dev(int i, const Vel<T>& v, T c1, T c2) {
  const T cu = cu_of(i, v);
  return T(w_of(i)) * (cu * c1 + (cu * cu) * c2 - v.u2t);
}

// The 27 f and 27 g of one site, (3, 9, NY, NX) layout, decoded to T.
template <typename S, typename T>
__device__ __forceinline__ void load_site(const S* f, const S* g, int64_t plane, int64_t site,
                                          T (&fv)[kS][kQ], T (&gv)[kS][kQ]) {
#pragma unroll
  for (int s = 0; s < kS; ++s) {
#pragma unroll
    for (int i = 0; i < kQ; ++i) {
      fv[s][i] = Io<S, T>::load(f + (s * kQ + i) * plane + site);
      gv[s][i] = Io<S, T>::load(g + (s * kQ + i) * plane + site);
    }
  }
}

// One species' moments at one site: r is its density (the neutral's
// background added under DELTA), d the raw sum of the delta-stored
// neutral's f (DELTA, s = 2; else 0); the velocity and temp are guarded
// (0 where the species is dead), the velocity shifted by the half force.
template <typename T>
struct Moments {
  T r, d, ux, uy, temp;
};

// Pass 1 of species s (ops/macros.update_macro): f_s[i] at fs + i * pitch,
// g_s[i] at gs + i * pitch; the sums run over directions 0..8 in order (the
// exact-equality guard px == +-rho depends on it).
template <typename S, typename T, bool DELTA>
__device__ __forceinline__ Moments<T> moments(int s, const S* fs, const S* gs, int pitch, T Ex,
                                              T Ey, const Params<T>& p) {
  T fv[kQ];
#pragma unroll
  for (int i = 0; i < kQ; ++i) fv[i] = Io<S, T>::load(fs + i * pitch);
  T r = fv[0];
#pragma unroll
  for (int i = 1; i < kQ; ++i) r = r + fv[i];
  // _moments: the c_x / c_y nonzero directions in index order
  const T px = ((((fv[1] + (-fv[3])) + fv[5]) + (-fv[6])) + (-fv[7])) + fv[8];
  const T py = ((((fv[2] + (-fv[4])) + fv[5]) + fv[6]) + (-fv[7])) + (-fv[8]);
  T d = T(0);
  if (DELTA && s == 2) {
    d = r;
    r = p.neutral_ref + r;
  }
  const bool a = alive(r);
  const T inv_rho = recip(a ? r : T(1.0));
  T u = (px == r || px == -r) ? T(0.0) : px * inv_rho;
  T v = (py == r || py == -r) ? T(0.0) : py * inv_rho;
  if (p.charged[s]) {
    u = u + p.half_qom[s] * Ex;
    v = v + p.half_qom[s] * Ey;
  }
  T tsum = Io<S, T>::load(gs);
#pragma unroll
  for (int i = 1; i < kQ; ++i) tsum = tsum + Io<S, T>::load(gs + i * pitch);
  return {r, d, a ? u : T(0.0), a ? v : T(0.0), a ? tsum : T(0.0)};
}

// The velocity set of species pair k, (0, 1), (0, 2) or (1, 2), from the
// three species' densities and guarded velocities.
template <typename T>
__device__ __forceinline__ Vel<T> pair_vel(int k, const T (&r)[kS], const T (&ux)[kS],
                                           const T (&uy)[kS], const Params<T>& p) {
  // species a = k == 2 ? 1 : 0 and b = k == 0 ? 1 : 2
  const T ra = k == 2 ? r[1] : r[0], rb = k == 0 ? r[1] : r[2];
  const T xa = k == 2 ? ux[1] : ux[0], xb = k == 0 ? ux[1] : ux[2];
  const T ya = k == 2 ? uy[1] : uy[0], yb = k == 0 ? uy[1] : uy[2];
  const bool both_dead = !alive(ra) && !alive(rb);
  const T inv = recip(both_dead ? T(1.0) : ra + rb);
  return vel(both_dead ? T(0.0) : (ra * xa + rb * xb) * inv,
             both_dead ? T(0.0) : (ra * ya + rb * yb) * inv, p);
}

// rho_q of a site from the electrons' and ions' densities (guarded)
template <typename T>
__device__ __forceinline__ T rho_q_of(T r_e, T r_i, const Params<T>& p) {
  const T rq = p.qom_i * (alive(r_i) ? r_i : T(0.0)) + p.qom_e * (alive(r_e) ? r_e : T(0.0));
  return rq < T(1e-15) ? T(0.0) : rq;
}

// Pass 2 of species s at one site (ops/collide.collide_species_dirs): r,
// ux, uy are the three species' moments (Moments), ts this species' temp,
// drho_n the neutral's raw delta sum; f_s[i] and g_s[i] at fs / gs + i *
// pitch. emit(i, fo, go) receives each direction's pair.
// DELTA: the neutral's f holds deltas from neutral_ref * w_i.
// FAST: bf16-storage mode, the partial-fraction thermal forms (the fused
// form of f and g, and the neutral's under DELTA: its exact delta f and
// the g form alone).
template <typename S, typename T, bool DELTA, bool FAST, typename Emit>
__device__ __forceinline__ void collide_species(int s, const T (&r)[kS], const T (&ux)[kS],
                                                const T (&uy)[kS], T ts, T drho_n, T Ex, T Ey,
                                                const S* fs, const S* gs, int pitch,
                                                const Params<T>& p, Emit&& emit) {
  const T r_s = pick(s, r);
  const T rs = alive(r_s) ? r_s : T(0.0);
  const Vel<T> vs[3] = {vel(pick(s, ux), pick(s, uy), p), pair_vel(pair1_of(s), r, ux, uy, p),
                        pair_vel(pair2_of(s), r, ux, uy, p)};
  const T us = vs[0].x, ws = vs[0].y;
  T amp_f[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) amp_f[k] = rs * p.inv[s][k];
  const T keep = p.keep[s];
  const bool charged = p.charged[s];
  const bool neutral_delta = DELTA && s == 2;
  // the fused fast form (collide_species_dirs_fused_fast), else f and g
  // apart
  const bool fused = FAST && !neutral_delta;
  T uE = T(0.0), force_amp = T(0.0);
  if (charged) {
    uE = us * Ex + ws * Ey;
    force_amp = (p.force_c[s] * rs) * p.force_t[s];
  }
  const T u2 = us * us + ws * ws;
  const T dT_amp = -(rs * u2) / p.kb;
  const T damp = neutral_delta ? drho_n * p.one_minus_keep[s] : T(0.0);
  // thermal factors: cs9 (fused), cs (g fast form) or tt0 (combined form)
  T tc[3], ratio;
  if (FAST) {
#pragma unroll
    for (int k = 0; k < 3; ++k)
      tc[k] = fused ? rs * p.cs9_a[s][k] + p.cs9_b[s][k] : rs * p.cs_a[s][k] + p.cs_b[s][k];
    const T rr = ts * recip(rs == T(0.0) ? T(1.0) : rs);
    ratio = fused ? rr : rr * T(1.0 / kQ);
  } else {
#pragma unroll
    for (int k = 0; k < 3; ++k) tc[k] = p.tt_a[s][k] * rs;
    ratio = T(0.0);
  }
  // the loop's constants, read once: the caller's stores could alias
  // shared memory, which would make the compiler read them again each
  // direction
  const T c1 = p.inv_cs2, c2 = p.half_inv_cs2_sq;
  T tsi[3], dk[3];
  bool act[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    tsi[k] = ts * p.inv[s][k];
    dk[k] = FAST ? (fused ? p.offs9[s][k] : p.offs[s][k]) : p.tt_b[s][k];
    act[k] = p.active[s][k];
  }
#pragma unroll
  for (int i = 0; i < kQ; ++i) {
    const T fv = Io<S, T>::load(fs + i * pitch);
    const T gv = Io<S, T>::load(gs + i * pitch);
    T wp[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) wp[k] = wpoly(i, vs[k], c1, c2);
    T fo;
    if (neutral_delta) {
      // collide_species_f_dirs, exact delta form (the neutral is uncharged)
      fo = fv * keep + amp_f[0] * wpoly_dev(i, vs[0], c1, c2) +
           amp_f[1] * wpoly_dev(i, vs[1], c1, c2) + amp_f[2] * wpoly_dev(i, vs[2], c1, c2) +
           damp * T(w_of(i));
    } else {
      fo = fv * keep + (amp_f[0] * wp[0] + amp_f[1] * wp[1] + amp_f[2] * wp[2]);
      if (charged) {
        const T cE = T(cx_of(i)) * Ex + T(cy_of(i)) * Ey;
        const T cu = cu_of(i, vs[0]);
        fo = fo + (T(w_of(i)) * force_amp) * (cE + div_cs2(cu * cE, p) - uE);
      }
    }
    T geqd, tm;
    if (fused) {
      // the g half of collide_species_dirs_fused_fast
      T prod[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) prod[k] = amp_f[k] * wp[k];
      geqd = ratio * (prod[0] + prod[1] + prod[2]);
      tm = T(-1.5);
#pragma unroll
      for (int k = 0; k < 3; ++k)
        if (act[k]) tm = tm + tc[k] * recip(prod[k] + dk[k]);
    } else {
      T qf[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) qf[k] = T(kQ) * (amp_f[k] * wp[k]);
      if (FAST) {
        // collide_species_g_dirs_fast
        geqd = ratio * (qf[0] + qf[1] + qf[2]);
        tm = T(-1.5);
#pragma unroll
        for (int k = 0; k < 3; ++k)
          if (act[k]) tm = tm + tc[k] * recip(qf[k] + dk[k]);
      } else {
        // collide_species_g_dirs: common-denominator energy-loss term
        geqd = tsi[0] * wp[0] + tsi[1] * wp[1] + tsi[2] * wp[2];
        T ns[3], ds[3];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          ns[k] = tc[k] - qf[k];
          ds[k] = dk[k] + T(2.0) * qf[k];
        }
        const T d12 = ds[0] * ds[1];
        tm = (ns[0] * (ds[1] * ds[2]) + ns[1] * (ds[0] * ds[2]) + ns[2] * d12) / (d12 * ds[2]);
      }
    }
    emit(i, fo, gv * keep + geqd + dT_amp * tm);
  }
}

// The whole site: the composition of the pieces, for the per-site halo
// kernel (halo_site.cuh). Takes the site's 27 f and 27 g in the compute
// type, Ex and Ey, and hands each species' 9 + 9 post-collision values to
// emit(s, fo, go), which stores them wherever the caller's streaming puts
// them. Returns rho_q.
template <typename T, bool DELTA, bool FAST, typename Emit>
__device__ __forceinline__ T collide_site(const T (&fv)[kS][kQ], const T (&gv)[kS][kQ], T Ex,
                                          T Ey, const Params<T>& p, Emit&& emit) {
  T r[kS], ux[kS], uy[kS], temp[kS], drho_n = T(0);
#pragma unroll
  for (int s = 0; s < kS; ++s) {
    const Moments<T> m = moments<T, T, DELTA>(s, fv[s], gv[s], 1, Ex, Ey, p);
    r[s] = m.r;
    ux[s] = m.ux;
    uy[s] = m.uy;
    temp[s] = m.temp;
    if (DELTA && s == 2) drho_n = m.d;
  }
#pragma unroll
  for (int s = 0; s < kS; ++s) {
    T fo[kQ], go[kQ];
    collide_species<T, T, DELTA, FAST>(
        s, r, ux, uy, temp[s], drho_n, Ex, Ey, fv[s], gv[s], 1, p, [&](int i, T a, T b) {
          fo[i] = a;
          go[i] = b;
        });
    emit(s, fo, go);
  }
  return rho_q_of(r[0], r[1], p);
}

}  // namespace
