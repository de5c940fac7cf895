// The plasma's per-site collision, shared by the per-step kernel
// (fused_step.cu) and the K-step window kernel (fused_multistep.cu), so that
// the two cannot drift apart.
//
// collide_site computes what lbm_tpu/ops/macros.update_macro +
// ops/equilibrium + ops/collide compute for one lattice site: it takes the
// site's 27 f and 27 g in the compute type, Ex and Ey, and hands each
// species' 9 + 9 post-collision values to a callback, which stores them
// wherever the caller's streaming puts them. It returns rho_q. The thread
//   * computes the macros in the expression order of ops/macros.py, with
//     the moment sums taken sequentially over directions 0..8 (the
//     exact-equality guard px == +-rho depends on that order);
//   * builds each species' three w-polynomial sets when it needs them;
//   * collides each species with the expression trees of ops/collide.py.
//
// Numbers: storage/compute type pairs are (double, double), (float, float)
// and (bf16, float). bf16 converts only through __bfloat162float /
// __float2bfloat16 (round to nearest even, like torch's .to()). The bf16
// mode's partial-fraction thermal term (FAST) uses the EXACT reciprocal
// 1/x, as the port's plain version does; the TPU kernels' approximate
// reciprocal is not reproduced. Constants are folded in double on the
// host, where the JAX code folds Python floats, and cast once to the
// compute type. Build with -fmad=false and without fast math: the moment
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

// w_i * poly_i (ops/equilibrium.equilibrium_wpolys)
template <typename T>
__device__ __forceinline__ void wpolys(T ux, T uy, const Params<T>& p, T out[kQ]) {
  const T u2_term = (ux * ux + uy * uy) * p.half_inv_cs2;
#pragma unroll
  for (int i = 0; i < kQ; ++i) {
    const T cu = T(cx_of(i)) * ux + T(cy_of(i)) * uy;
    out[i] = T(w_of(i)) * (T(1.0) + cu * p.inv_cs2 + (cu * cu) * p.half_inv_cs2_sq - u2_term);
  }
}

// w_i * (poly_i - 1) (ops/equilibrium.equilibrium_wpolys_dev)
template <typename T>
__device__ __forceinline__ void wpolys_dev(T ux, T uy, const Params<T>& p, T out[kQ]) {
  const T u2_term = (ux * ux + uy * uy) * p.half_inv_cs2;
#pragma unroll
  for (int i = 0; i < kQ; ++i) {
    const T cu = T(cx_of(i)) * ux + T(cy_of(i)) * uy;
    out[i] = T(w_of(i)) * (cu * p.inv_cs2 + (cu * cu) * p.half_inv_cs2_sq - u2_term);
  }
}

// The 27 f and 27 g of one site, (3, 9, NY, NX) layout, decoded to T.
// Plain pointers: the window kernel reads buffers that it wrote earlier in
// the same launch.
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

// DELTA: the neutral's f holds deltas from neutral_ref * w_i.
// FAST: bf16-storage mode, the partial-fraction thermal forms.
// emit(s, fo, go) receives species s's 9 post-collision f and g; returns
// rho_q.
template <typename T, bool DELTA, bool FAST, typename Emit>
__device__ __forceinline__ T collide_site(const T (&fv)[kS][kQ], const T (&gv)[kS][kQ], T Ex,
                                          T Ey, const Params<T>& p, Emit&& emit) {
  // ---- macros (ops/macros.update_macro) ----
  T rho_raw[kS], rho[kS], ux[kS], uy[kS], temp[kS];
  bool alive[kS];
  T drho_n = T(0);
#pragma unroll
  for (int s = 0; s < kS; ++s) {
    const T* fs = fv[s];
    T r = fs[0];
#pragma unroll
    for (int i = 1; i < kQ; ++i) r = r + fs[i];
    // _moments: the c_x / c_y nonzero directions in index order
    const T px = ((((fs[1] + (-fs[3])) + fs[5]) + (-fs[6])) + (-fs[7])) + fs[8];
    const T py = ((((fs[2] + (-fs[4])) + fs[5]) + fs[6]) + (-fs[7])) + (-fs[8]);
    if (DELTA && s == 2) {
      drho_n = r;
      r = p.neutral_ref + r;
    }
    const bool a = r >= T(1e-10);
    const T safe = a ? r : T(1.0);
    const T inv_rho = T(1.0) / safe;
    T u = (px == r || px == -r) ? T(0.0) : px * inv_rho;
    T v = (py == r || py == -r) ? T(0.0) : py * inv_rho;
    if (p.charged[s]) {
      u = u + p.half_qom[s] * Ex;
      v = v + p.half_qom[s] * Ey;
    }
    T tsum = gv[s][0];
#pragma unroll
    for (int i = 1; i < kQ; ++i) tsum = tsum + gv[s][i];
    rho_raw[s] = r;
    alive[s] = a;
    rho[s] = a ? r : T(0.0);
    ux[s] = a ? u : T(0.0);
    uy[s] = a ? v : T(0.0);
    temp[s] = a ? tsum : T(0.0);
  }
  T uxp[3], uyp[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int a = k == 2 ? 1 : 0;
    const int b = k == 0 ? 1 : 2;
    const T ra = rho_raw[a], rb = rho_raw[b];
    const bool both_dead = !alive[a] && !alive[b];
    const T inv = T(1.0) / (both_dead ? T(1.0) : ra + rb);
    uxp[k] = both_dead ? T(0.0) : (ra * ux[a] + rb * ux[b]) * inv;
    uyp[k] = both_dead ? T(0.0) : (ra * uy[a] + rb * uy[b]) * inv;
  }
  T rq = p.qom_i * rho[1] + p.qom_e * rho[0];
  rq = rq < T(1e-15) ? T(0.0) : rq;

  // ---- collide (ops/collide.collide_species_dirs), species by species ----
#pragma unroll
  for (int s = 0; s < kS; ++s) {
    const T rs = rho[s], us = ux[s], vs = uy[s], ts = temp[s];
    T wp[3][kQ];
    wpolys(us, vs, p, wp[0]);
    wpolys(uxp[pair1_of(s)], uyp[pair1_of(s)], p, wp[1]);
    wpolys(uxp[pair2_of(s)], uyp[pair2_of(s)], p, wp[2]);
    T amp_f[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) amp_f[k] = rs * p.inv[s][k];
    const T keep = p.keep[s];
    const bool charged = p.charged[s];
    T uE = T(0.0), force_amp = T(0.0);
    if (charged) {
      uE = us * Ex + vs * Ey;
      force_amp = (p.force_c[s] * rs) * p.force_t[s];
    }
    const T u2 = us * us + vs * vs;
    const T dT_amp = -(rs * u2) / p.kb;
    T fo[kQ], go[kQ];

    if (FAST && !(DELTA && s == 2)) {
      // collide_species_dirs_fused_fast
      T cs9[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) cs9[k] = rs * p.cs9_a[s][k] + p.cs9_b[s][k];
      const T ratio = ts * (T(1.0) / (rs == T(0.0) ? T(1.0) : rs));
#pragma unroll
      for (int i = 0; i < kQ; ++i) {
        T prod[3];
#pragma unroll
        for (int k = 0; k < 3; ++k) prod[k] = amp_f[k] * wp[k][i];
        const T feqd = prod[0] + prod[1] + prod[2];
        T relax = fv[s][i] * keep + feqd;
        if (charged) {
          const T cE = T(cx_of(i)) * Ex + T(cy_of(i)) * Ey;
          const T cu = T(cx_of(i)) * us + T(cy_of(i)) * vs;
          relax = relax + (T(w_of(i)) * force_amp) * (cE + cu * cE / p.cs2 - uE);
        }
        fo[i] = relax;
        const T geqd = ratio * feqd;
        T tm = T(-1.5);
#pragma unroll
        for (int k = 0; k < 3; ++k)
          if (p.active[s][k]) tm = tm + cs9[k] * (T(1.0) / (prod[k] + p.offs9[s][k]));
        go[i] = gv[s][i] * keep + geqd + dT_amp * tm;
      }
    } else {
      if (DELTA && s == 2) {
        // collide_species_f_dirs, delta form (neutral: uncharged)
        T wd[3][kQ];
        wpolys_dev(us, vs, p, wd[0]);
        wpolys_dev(uxp[pair1_of(s)], uyp[pair1_of(s)], p, wd[1]);
        wpolys_dev(uxp[pair2_of(s)], uyp[pair2_of(s)], p, wd[2]);
        const T damp = drho_n * p.one_minus_keep[s];
#pragma unroll
        for (int i = 0; i < kQ; ++i)
          fo[i] = fv[s][i] * keep + amp_f[0] * wd[0][i] + amp_f[1] * wd[1][i] +
                  amp_f[2] * wd[2][i] + damp * T(w_of(i));
      } else {
        // collide_species_f_dirs
#pragma unroll
        for (int i = 0; i < kQ; ++i) {
          const T feqd = amp_f[0] * wp[0][i] + amp_f[1] * wp[1][i] + amp_f[2] * wp[2][i];
          T relax = fv[s][i] * keep + feqd;
          if (charged) {
            const T cE = T(cx_of(i)) * Ex + T(cy_of(i)) * Ey;
            const T cu = T(cx_of(i)) * us + T(cy_of(i)) * vs;
            relax = relax + (T(w_of(i)) * force_amp) * (cE + cu * cE / p.cs2 - uE);
          }
          fo[i] = relax;
        }
      }
      if (FAST) {
        // collide_species_g_dirs_fast
        T cs[3];
#pragma unroll
        for (int k = 0; k < 3; ++k) cs[k] = rs * p.cs_a[s][k] + p.cs_b[s][k];
        const T ratio_q = (ts * (T(1.0) / (rs == T(0.0) ? T(1.0) : rs))) * T(1.0 / kQ);
#pragma unroll
        for (int i = 0; i < kQ; ++i) {
          T qf[3];
#pragma unroll
          for (int k = 0; k < 3; ++k) qf[k] = T(kQ) * (amp_f[k] * wp[k][i]);
          const T geqd = ratio_q * (qf[0] + qf[1] + qf[2]);
          T tm = T(-1.5);
#pragma unroll
          for (int k = 0; k < 3; ++k)
            if (p.active[s][k]) tm = tm + cs[k] * (T(1.0) / (qf[k] + p.offs[s][k]));
          go[i] = gv[s][i] * keep + geqd + dT_amp * tm;
        }
      } else {
        // collide_species_g_dirs: common-denominator energy-loss term
        T amp_g[3], tt0[3];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          amp_g[k] = ts * p.inv[s][k];
          tt0[k] = p.tt_a[s][k] * rs;
        }
#pragma unroll
        for (int i = 0; i < kQ; ++i) {
          const T geqd = amp_g[0] * wp[0][i] + amp_g[1] * wp[1][i] + amp_g[2] * wp[2][i];
          T ns[3], ds[3];
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            const T qf = T(kQ) * (amp_f[k] * wp[k][i]);
            ns[k] = tt0[k] - qf;
            ds[k] = p.tt_b[s][k] + T(2.0) * qf;
          }
          const T d12 = ds[0] * ds[1];
          const T tm = (ns[0] * (ds[1] * ds[2]) + ns[1] * (ds[0] * ds[2]) + ns[2] * d12) /
                       (d12 * ds[2]);
          go[i] = gv[s][i] * keep + geqd + dT_amp * tm;
        }
      }
    }
    emit(s, fo, go);
  }
  return rq;
}

}  // namespace
