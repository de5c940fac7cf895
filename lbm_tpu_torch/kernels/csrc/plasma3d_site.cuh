// The arithmetic of the D3Q19 plasma column's collide, one species of one
// site at a time: the one copy that the tile program (plasma3d_tile.cuh)
// runs for the periodic step and for every halo geometry.
//
// moments3, pair3, collide_species3 and rho_q3 compute what
// lbm_tpu/ops/d3.update_macro3 + collide_species_dirs3 compute:
//   * moments3 (pass 1) sums one species' 19 f and 19 g at a site in the
//     order of ops/d3._sum_dirs / _moments3 (directions 0..18; the
//     exact-equality guard px == +-rho depends on it) and applies the
//     guards and the half-force shift (ops/d3.update_macro3's expression
//     trees);
//   * pair3 forms a mixture velocity set from the three species' moments,
//     rho_q3 the site's charge density;
//   * collide_species3 (pass 2) goes direction by direction: it reads f_s[i]
//     and g_s[i], rebuilds w_i * poly_i of the species' three velocity sets
//     from the velocities (holding the 3 x 19 polynomials would not fit in
//     registers), collides with ops/d3's expression trees and hands each
//     pair of values to the caller, which places it.
// The populations are read through a pointer to direction 0 and a pitch
// between directions: the tile program keeps them in shared memory.
//
// Numbers, as in plasma_site.cuh: constants folded in double on the host
// (HostParams), cast once; true IEEE divisions (cu*cE / cs2 and
// -(rho u^2) / kb are divided, as ops/collide._true_div makes torch divide;
// recip's 1 / x is correctly rounded too);
// -fmad=false. The bf16 mode (FAST) decodes with __bfloat162float, computes
// in float, takes the partial-fraction thermal term with the EXACT
// reciprocal 1/x for all three species (the delta-stored neutral too: 3-D
// has no neutral exclusion, unlike the 2-D fused fast form), and encodes
// with __float2bfloat16 (round to nearest even, as torch's .to()).
#pragma once

#include "plasma_site.cuh"

namespace {

constexpr int kQ3 = 19;

// the D3Q19 velocity set of lbm_tpu_torch/constants.py
__host__ __device__ constexpr int cx3_of(int i) {
  return (i == 1 || i == 7 || i == 9 || i == 11 || i == 13)
             ? 1
             : ((i == 2 || i == 8 || i == 10 || i == 12 || i == 14) ? -1 : 0);
}
__host__ __device__ constexpr int cy3_of(int i) {
  return (i == 3 || i == 7 || i == 10 || i == 15 || i == 17)
             ? 1
             : ((i == 4 || i == 8 || i == 9 || i == 16 || i == 18) ? -1 : 0);
}
__host__ __device__ constexpr int cz3_of(int i) {
  return (i == 5 || i == 11 || i == 14 || i == 15 || i == 18)
             ? 1
             : ((i == 6 || i == 12 || i == 13 || i == 16 || i == 17) ? -1 : 0);
}
__host__ __device__ constexpr double w3_of(int i) {
  return i == 0 ? 1.0 / 3.0 : (i < 7 ? 1.0 / 18.0 : 1.0 / 36.0);
}

// One velocity set: (ux, uy, uz) and |u|^2 / (2 cs2).
template <typename T>
struct Vel3 {
  T x, y, z, u2t;
};

template <typename T>
__device__ __forceinline__ Vel3<T> vel3(T ux, T uy, T uz, const Params<T>& p) {
  return {ux, uy, uz, (ux * ux + uy * uy + uz * uz) * p.half_inv_cs2};
}

template <typename T>
__device__ __forceinline__ T cu3(int i, const Vel3<T>& v) {
  return T(cx3_of(i)) * v.x + T(cy3_of(i)) * v.y + T(cz3_of(i)) * v.z;
}

// w_i * poly_i (ops/d3.equilibrium_wpolys3); c1 = 1 / cs2, c2 = 1 / (2 cs2^2)
template <typename T>
__device__ __forceinline__ T wpoly3(int i, const Vel3<T>& v, T c1, T c2) {
  const T cu = cu3(i, v);
  return T(w3_of(i)) * (T(1.0) + cu * c1 + (cu * cu) * c2 - v.u2t);
}

// w_i * (poly_i - 1) (ops/d3.equilibrium_wpolys3_dev)
template <typename T>
__device__ __forceinline__ T wpoly3_dev(int i, const Vel3<T>& v, T c1, T c2) {
  const T cu = cu3(i, v);
  return T(w3_of(i)) * (cu * c1 + (cu * cu) * c2 - v.u2t);
}

// One species' moments at one site: r is its density (the neutral's
// background added under DELTA), d the raw sum of the delta-stored
// neutral's f (DELTA, s = 2; else 0); the velocity and temp are guarded
// (0 where the species is dead), the velocity shifted by the half force.
template <typename T>
struct Moments3 {
  T r, d, ux, uy, uz, temp;
};

// Pass 1 of species s: f_s[i] at fs + i * pitch, g_s[i] at gs + i * pitch.
template <typename S, typename T, bool DELTA>
__device__ __forceinline__ Moments3<T> moments3(int s, const S* __restrict__ fs,
                                                const S* __restrict__ gs, int pitch,
                                                T Ex, T Ey, T Ez, const Params<T>& p) {
  T r = T(0), px = T(0), py = T(0), pz = T(0), tsum = T(0);
#pragma unroll
  for (int i = 0; i < kQ3; ++i) {
    const T v = Io<S, T>::load(fs + i * pitch);
    r = i == 0 ? v : r + v;
    // _moments3: each axis starts at its first nonzero direction (1, 3, 5)
    if (cx3_of(i) != 0) px = i == 1 ? v : (cx3_of(i) > 0 ? px + v : px + (-v));
    if (cy3_of(i) != 0) py = i == 3 ? v : (cy3_of(i) > 0 ? py + v : py + (-v));
    if (cz3_of(i) != 0) pz = i == 5 ? v : (cz3_of(i) > 0 ? pz + v : pz + (-v));
    const T w = Io<S, T>::load(gs + i * pitch);
    tsum = i == 0 ? w : tsum + w;
  }
  T d = T(0);
  if (DELTA && s == 2) {
    d = r;
    r = p.neutral_ref + r;
  }
  const bool a = alive(r);
  const T inv_rho = recip(a ? r : T(1.0));
  T u = (px == r || px == -r) ? T(0.0) : px * inv_rho;
  T v = (py == r || py == -r) ? T(0.0) : py * inv_rho;
  T w = (pz == r || pz == -r) ? T(0.0) : pz * inv_rho;
  if (p.charged[s]) {
    u = u + p.half_qom[s] * Ex;
    v = v + p.half_qom[s] * Ey;
    w = w + p.half_qom[s] * Ez;
  }
  return {r, d, a ? u : T(0.0), a ? v : T(0.0), a ? w : T(0.0), a ? tsum : T(0.0)};
}

// The velocity set of species pair k, (0, 1), (0, 2) or (1, 2), from the
// three species' densities and guarded velocities.
template <typename T>
__device__ __forceinline__ Vel3<T> pair3(int k, const T (&r)[kS], const T (&ux)[kS],
                                         const T (&uy)[kS], const T (&uz)[kS],
                                         const Params<T>& p) {
  // species a = k == 2 ? 1 : 0 and b = k == 0 ? 1 : 2
  const T ra = k == 2 ? r[1] : r[0], rb = k == 0 ? r[1] : r[2];
  const T xa = k == 2 ? ux[1] : ux[0], xb = k == 0 ? ux[1] : ux[2];
  const T ya = k == 2 ? uy[1] : uy[0], yb = k == 0 ? uy[1] : uy[2];
  const T za = k == 2 ? uz[1] : uz[0], zb = k == 0 ? uz[1] : uz[2];
  const bool both_dead = !alive(ra) && !alive(rb);
  const T inv = recip(both_dead ? T(1.0) : ra + rb);
  return vel3(both_dead ? T(0.0) : (ra * xa + rb * xb) * inv,
              both_dead ? T(0.0) : (ra * ya + rb * yb) * inv,
              both_dead ? T(0.0) : (ra * za + rb * zb) * inv, p);
}

// rho_q of a site from the electrons' and ions' densities (guarded)
template <typename T>
__device__ __forceinline__ T rho_q3(T r_e, T r_i, const Params<T>& p) {
  const T rq = p.qom_i * (alive(r_i) ? r_i : T(0.0)) + p.qom_e * (alive(r_e) ? r_e : T(0.0));
  return rq < T(1e-15) ? T(0.0) : rq;
}

// Pass 2 of species s at one site: r, ux, uy, uz are the three species'
// moments (Moments3), ts this species' temp, drho_n the neutral's raw delta
// sum; f_s[i] and g_s[i] at fs / gs + i * pitch. Each direction i for which
// need(i) holds is collided and emit(i, fo, go) receives its pair; the
// others are skipped (a run's x-neighbours need only the directions that
// land in the run).
// DELTA: the neutral's f holds deltas from neutral_ref * w_i.
// FAST: bf16-storage mode, the partial-fraction thermal form.
template <typename S, typename T, bool DELTA, bool FAST, typename Need, typename Emit>
__device__ __forceinline__ void collide_species3(int s, const T (&r)[kS], const T (&ux)[kS],
                                                 const T (&uy)[kS], const T (&uz)[kS], T ts,
                                                 T drho_n, T Ex, T Ey, T Ez,
                                                 const S* __restrict__ fs,
                                                 const S* __restrict__ gs, int pitch,
                                                 const Params<T>& p, Need&& need, Emit&& emit) {
  const T r_s = pick(s, r);
  const T rs = alive(r_s) ? r_s : T(0.0);
  const Vel3<T> vs[3] = {vel3(pick(s, ux), pick(s, uy), pick(s, uz), p),
                         pair3(pair1_of(s), r, ux, uy, uz, p),
                         pair3(pair2_of(s), r, ux, uy, uz, p)};
  T amp_f[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) amp_f[k] = rs * p.inv[s][k];
  const T keep = p.keep[s];
  const bool charged = p.charged[s];
  const bool neutral_delta = DELTA && s == 2;
  T uE = T(0.0), force_amp = T(0.0);
  if (charged) {
    uE = vs[0].x * Ex + vs[0].y * Ey + vs[0].z * Ez;
    force_amp = (p.force_c[s] * rs) * p.force_t[s];
  }
  const T u2 = vs[0].x * vs[0].x + vs[0].y * vs[0].y + vs[0].z * vs[0].z;
  const T dT_amp = -(rs * u2) / p.kb;
  const T damp = neutral_delta ? drho_n * p.one_minus_keep[s] : T(0.0);
  // thermal per-species factors: partial-fraction (FAST) or combined form
  T tc[3], ratio;
  if (FAST) {
#pragma unroll
    for (int k = 0; k < 3; ++k) tc[k] = rs * p.cs_a[s][k] + p.cs_b[s][k];
    ratio = (ts * recip(rs == T(0.0) ? T(1.0) : rs)) * T(1.0 / kQ3);
  } else {
#pragma unroll
    for (int k = 0; k < 3; ++k) tc[k] = p.tt_a[s][k] * rs;
    ratio = T(0.0);
  }
  // the loop's constants, read once: the caller's stores could alias
  // shared memory, which would make the compiler read them again each
  // direction
  const T c1 = p.inv_cs2, c2 = p.half_inv_cs2_sq, cs2 = p.cs2;
  T tsi[3], dk[3];
  bool act[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    tsi[k] = ts * p.inv[s][k];
    dk[k] = FAST ? p.offs[s][k] : p.tt_b[s][k];
    act[k] = p.active[s][k];
  }
#pragma unroll
  for (int i = 0; i < kQ3; ++i) {
    if (!need(i)) continue;
    const T fv = Io<S, T>::load(fs + i * pitch);
    const T gv = Io<S, T>::load(gs + i * pitch);
    T wp[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) wp[k] = wpoly3(i, vs[k], c1, c2);
    T fo;
    if (neutral_delta) {
      // collide_species_f_dirs3, exact delta form (the neutral is uncharged)
      fo = fv * keep + amp_f[0] * wpoly3_dev(i, vs[0], c1, c2) +
           amp_f[1] * wpoly3_dev(i, vs[1], c1, c2) + amp_f[2] * wpoly3_dev(i, vs[2], c1, c2) +
           damp * T(w3_of(i));
    } else {
      fo = fv * keep + (amp_f[0] * wp[0] + amp_f[1] * wp[1] + amp_f[2] * wp[2]);
      if (charged) {
        const T cE = T(cx3_of(i)) * Ex + T(cy3_of(i)) * Ey + T(cz3_of(i)) * Ez;
        const T cu = cu3(i, vs[0]);
        fo = fo + (T(w3_of(i)) * force_amp) * (cE + cu * cE / cs2 - uE);
      }
    }
    T qf[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) qf[k] = T(kQ3) * (amp_f[k] * wp[k]);
    T geqd, tm;
    if (FAST) {
      // collide_species_g_dirs3 with g_recip = 1/x
      geqd = ratio * (qf[0] + qf[1] + qf[2]);
      tm = T(-1.5);
#pragma unroll
      for (int k = 0; k < 3; ++k)
        if (act[k]) tm = tm + tc[k] * recip(qf[k] + dk[k]);
    } else {
      // collide_species_g_dirs3, common-denominator energy-loss term
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
    const T go = gv * keep + geqd + dT_amp * tm;
    emit(i, fo, go);
  }
}

}  // namespace
