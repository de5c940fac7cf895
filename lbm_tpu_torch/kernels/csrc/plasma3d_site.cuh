// The per-site work of the D3Q19 plasma column's collide + push-stream
// (fused_step3d.cu): one thread, one lattice site.
//
// collide_site3d and collide_stream_site3d compute what
// lbm_tpu/ops/d3.update_macro3 + collide_species_dirs3 + periodic
// streaming compute for one site:
//   * pass 1 reads the site's 57 f and 57 g once and accumulates the 15
//     moments (rho, px, py, pz, T of each species) in the order of
//     ops/d3._sum_dirs / _moments3 (directions 0..18; the exact-equality
//     guard px == +-rho depends on it), then the guards, the mixture
//     velocities and rho_q (ops/d3.update_macro3's expression trees);
//   * pass 2 goes species by species and direction by direction: it reads
//     f_s[i] and g_s[i] again (from L1/L2), rebuilds w_i * poly_i of the
//     three velocity sets from the velocities (holding 114 values or the
//     6 x 19 polynomials would not fit in registers), collides with
//     ops/d3's expression trees and hands each value to the caller, which
//     stores it: the periodic step at ((x+cx) mod NX, (y+cy) mod NY,
//     (z+cz) mod NZ) of the output, the halo step (halo3d_site.cuh) where
//     it lands inside the shard.
//
// Numbers, as in plasma_site.cuh: constants folded in double on the host
// (HostParams), cast once; true IEEE divisions (cu*cE / cs2 and
// -(rho u^2) / kb are divided, as ops/collide._true_div makes torch divide);
// -fmad=false. The bf16 mode (FAST) decodes with __bfloat162float, computes
// in float, takes the partial-fraction thermal term with the EXACT
// reciprocal 1/x for all three species (the delta-stored neutral too: 3-D
// has no neutral exclusion, unlike the 2-D fused fast form), and encodes
// with __float2bfloat16 (round to nearest even, as torch's .to()). Offsets
// are 64-bit: a population array holds 57 NZ NY NX elements, past 2^31 from
// 37.7M sites.
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

// w_i * poly_i (ops/d3.equilibrium_wpolys3)
template <typename T>
__device__ __forceinline__ T wpoly3(int i, const Vel3<T>& v, const Params<T>& p) {
  const T cu = cu3(i, v);
  return T(w3_of(i)) * (T(1.0) + cu * p.inv_cs2 + (cu * cu) * p.half_inv_cs2_sq - v.u2t);
}

// w_i * (poly_i - 1) (ops/d3.equilibrium_wpolys3_dev)
template <typename T>
__device__ __forceinline__ T wpoly3_dev(int i, const Vel3<T>& v, const Params<T>& p) {
  const T cu = cu3(i, v);
  return T(w3_of(i)) * (cu * p.inv_cs2 + (cu * cu) * p.half_inv_cs2_sq - v.u2t);
}

// The collision of one site whose 57 f and 57 g lie `off` into population
// planes `vol` apart (species s, direction i at (s * 19 + i) * vol + off):
// emit(s, i, fo, go) receives each post-collision pair, species by species
// and direction by direction; returns the site's rho_q (guarded). The
// periodic kernel and the halo kernel (halo3d_site.cuh) both collide
// through it, so a halo site recollides bitwise as its owner does.
// DELTA: the neutral's f holds deltas from neutral_ref * w_i.
// FAST: bf16-storage mode, the partial-fraction thermal form.
template <typename S, typename T, bool DELTA, bool FAST, typename Emit>
__device__ __forceinline__ T collide_site3d(const S* __restrict__ f, const S* __restrict__ g,
                                            int64_t vol, int64_t off, T Ex, T Ey, T Ez,
                                            const Params<T>& p, Emit&& emit) {
  // ---- pass 1: moments, guards, mixtures, rho_q (ops/d3.update_macro3) ----
  T rho_raw[kS], rho[kS], ux[kS], uy[kS], uz[kS], temp[kS];
  bool alive[kS];
  T drho_n = T(0);
#pragma unroll
  for (int s = 0; s < kS; ++s) {
    const S* fs = f + static_cast<int64_t>(s) * kQ3 * vol + off;
    const S* gs = g + static_cast<int64_t>(s) * kQ3 * vol + off;
    T r = T(0), px = T(0), py = T(0), pz = T(0), tsum = T(0);
#pragma unroll
    for (int i = 0; i < kQ3; ++i) {
      const T v = Io<S, T>::load(fs + i * vol);
      r = i == 0 ? v : r + v;
      // _moments3: each axis starts at its first nonzero direction (1, 3, 5)
      if (cx3_of(i) != 0) px = i == 1 ? v : (cx3_of(i) > 0 ? px + v : px + (-v));
      if (cy3_of(i) != 0) py = i == 3 ? v : (cy3_of(i) > 0 ? py + v : py + (-v));
      if (cz3_of(i) != 0) pz = i == 5 ? v : (cz3_of(i) > 0 ? pz + v : pz + (-v));
      const T w = Io<S, T>::load(gs + i * vol);
      tsum = i == 0 ? w : tsum + w;
    }
    if (DELTA && s == 2) {
      drho_n = r;
      r = p.neutral_ref + r;
    }
    const bool a = r >= T(1e-10);
    const T inv_rho = T(1.0) / (a ? r : T(1.0));
    T u = (px == r || px == -r) ? T(0.0) : px * inv_rho;
    T v = (py == r || py == -r) ? T(0.0) : py * inv_rho;
    T w = (pz == r || pz == -r) ? T(0.0) : pz * inv_rho;
    if (p.charged[s]) {
      u = u + p.half_qom[s] * Ex;
      v = v + p.half_qom[s] * Ey;
      w = w + p.half_qom[s] * Ez;
    }
    rho_raw[s] = r;
    alive[s] = a;
    rho[s] = a ? r : T(0.0);
    ux[s] = a ? u : T(0.0);
    uy[s] = a ? v : T(0.0);
    uz[s] = a ? w : T(0.0);
    temp[s] = a ? tsum : T(0.0);
  }
  Vel3<T> pair[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int a = k == 2 ? 1 : 0;
    const int b = k == 0 ? 1 : 2;
    const T ra = rho_raw[a], rb = rho_raw[b];
    const bool both_dead = !alive[a] && !alive[b];
    const T inv = T(1.0) / (both_dead ? T(1.0) : ra + rb);
    pair[k] = vel3(both_dead ? T(0.0) : (ra * ux[a] + rb * ux[b]) * inv,
                   both_dead ? T(0.0) : (ra * uy[a] + rb * uy[b]) * inv,
                   both_dead ? T(0.0) : (ra * uz[a] + rb * uz[b]) * inv, p);
  }
  const T rq = p.qom_i * rho[1] + p.qom_e * rho[0];

  // ---- pass 2: collide (ops/d3.collide_species_dirs3), species by species ----
#pragma unroll
  for (int s = 0; s < kS; ++s) {
    const T rs = rho[s], ts = temp[s];
    const Vel3<T> vs[3] = {vel3(ux[s], uy[s], uz[s], p), pair[pair1_of(s)], pair[pair2_of(s)]};
    T amp_f[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) amp_f[k] = rs * p.inv[s][k];
    const T keep = p.keep[s];
    const bool charged = p.charged[s];
    T uE = T(0.0), force_amp = T(0.0);
    if (charged) {
      uE = vs[0].x * Ex + vs[0].y * Ey + vs[0].z * Ez;
      force_amp = (p.force_c[s] * rs) * p.force_t[s];
    }
    const T u2 = vs[0].x * vs[0].x + vs[0].y * vs[0].y + vs[0].z * vs[0].z;
    const T dT_amp = -(rs * u2) / p.kb;
    const T damp = DELTA && s == 2 ? drho_n * p.one_minus_keep[s] : T(0.0);
    // thermal per-species factors: partial-fraction (FAST) or combined form
    T tc[3], ratio;
    if (FAST) {
#pragma unroll
      for (int k = 0; k < 3; ++k) tc[k] = rs * p.cs_a[s][k] + p.cs_b[s][k];
      ratio = (ts * (T(1.0) / (rs == T(0.0) ? T(1.0) : rs))) * T(1.0 / kQ3);
    } else {
#pragma unroll
      for (int k = 0; k < 3; ++k) tc[k] = p.tt_a[s][k] * rs;
      ratio = T(0.0);
    }
    const int64_t base = static_cast<int64_t>(s) * kQ3 * vol;
#pragma unroll
    for (int i = 0; i < kQ3; ++i) {
      const T fv = Io<S, T>::load(f + base + i * vol + off);
      const T gv = Io<S, T>::load(g + base + i * vol + off);
      T wp[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) wp[k] = wpoly3(i, vs[k], p);
      T fo;
      if (DELTA && s == 2) {
        // collide_species_f_dirs3, exact delta form (the neutral is uncharged)
        fo = fv * keep + amp_f[0] * wpoly3_dev(i, vs[0], p) +
             amp_f[1] * wpoly3_dev(i, vs[1], p) + amp_f[2] * wpoly3_dev(i, vs[2], p) +
             damp * T(w3_of(i));
      } else {
        fo = fv * keep + (amp_f[0] * wp[0] + amp_f[1] * wp[1] + amp_f[2] * wp[2]);
        if (charged) {
          const T cE = T(cx3_of(i)) * Ex + T(cy3_of(i)) * Ey + T(cz3_of(i)) * Ez;
          const T cu = cu3(i, vs[0]);
          fo = fo + (T(w3_of(i)) * force_amp) * (cE + cu * cE / p.cs2 - uE);
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
          if (p.active[s][k]) tm = tm + tc[k] * (T(1.0) / (qf[k] + p.offs[s][k]));
      } else {
        // collide_species_g_dirs3, common-denominator energy-loss term
        geqd = (ts * p.inv[s][0]) * wp[0] + (ts * p.inv[s][1]) * wp[1] +
               (ts * p.inv[s][2]) * wp[2];
        T ns[3], ds[3];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          ns[k] = tc[k] - qf[k];
          ds[k] = p.tt_b[s][k] + T(2.0) * qf[k];
        }
        const T d12 = ds[0] * ds[1];
        tm = (ns[0] * (ds[1] * ds[2]) + ns[1] * (ds[0] * ds[2]) + ns[2] * d12) / (d12 * ds[2]);
      }
      const T go = gv * keep + geqd + dT_amp * tm;
      emit(s, i, fo, go);
    }
  }
  return rq < T(1e-15) ? T(0.0) : rq;
}

// The periodic step's site: collide it and push each value to
// ((x+cx) mod NX, (y+cy) mod NY, (z+cz) mod NZ).
template <typename S, typename T, bool DELTA, bool FAST>
__device__ __forceinline__ void collide_stream_site3d(
    const S* __restrict__ f, const S* __restrict__ g, const T* __restrict__ Ex_in,
    const T* __restrict__ Ey_in, const T* __restrict__ Ez_in, S* __restrict__ f_out,
    S* __restrict__ g_out, T* __restrict__ rho_q_out, int NZ, int NY, int NX, int64_t site,
    const Params<T>& p) {
  const int64_t plane = static_cast<int64_t>(NY) * NX;
  const int64_t vol = plane * NZ;
  const int z = static_cast<int>(site / plane);
  const int64_t rem = site - z * plane;
  const int y = static_cast<int>(rem / NX);
  const int x = static_cast<int>(rem - static_cast<int64_t>(y) * NX);
  // push-stream destinations: the wrapped -1, 0, +1 neighbours per axis
  const int64_t zo[3] = {(z == 0 ? NZ - 1 : z - 1) * plane, z * plane,
                         (z == NZ - 1 ? 0 : z + 1) * plane};
  const int64_t yo[3] = {static_cast<int64_t>(y == 0 ? NY - 1 : y - 1) * NX,
                         static_cast<int64_t>(y) * NX,
                         static_cast<int64_t>(y == NY - 1 ? 0 : y + 1) * NX};
  const int xo[3] = {x == 0 ? NX - 1 : x - 1, x, x == NX - 1 ? 0 : x + 1};
  rho_q_out[site] = collide_site3d<S, T, DELTA, FAST>(
      f, g, vol, site, Ex_in[site], Ey_in[site], Ez_in[site], p,
      [&](int s, int i, T fo, T go) {
        const int64_t dst = (static_cast<int64_t>(s) * kQ3 + i) * vol +
                            zo[cz3_of(i) + 1] + yo[cy3_of(i) + 1] + xo[cx3_of(i) + 1];
        Io<S, T>::store(f_out + dst, fo);
        Io<S, T>::store(g_out + dst, go);
      });
}

}  // namespace
