"""D3Q19 physics operators of the 3-D plasma column (counterpart of
lbm_tpu/ops/d3.py).

The 2-D pairwise-BGK + Guo-forcing + DDF-thermal structure (ops/macros.py,
ops/collide.py) on the D3Q19 stencil, direction by direction with scalar
stencil constants, with the JAX functions' expression trees and summation
orders: the f64 results agree bit for bit when JAX runs op by op, and the
CUDA kernel (kernels/csrc/fused_step3d.cu) evaluates the same trees per
site. Three places need care:

  * the moment sums run sequentially over directions 0..18 (_sum_dirs,
    _moments3), since the exact-equality guard px == +-rho depends on it;
  * divisions by a Python scalar go through ops/collide._true_div: on CUDA
    tensors PyTorch computes x / c as x * (1/c), which moves last bits;
  * unlike the 2-D ops (ops/collide.collide_species_dirs), the bf16 mode's
    partial-fraction thermal form (g_recip) applies to all three species,
    the delta-stored neutral included.

collide3 and stream_periodic3 are lbm_tpu/models/plasma3d.py's collide and
stream_periodic; they live here so that the kernel's plain version
(kernels/fused_step3d.py) and the model share them. macros_from_pack3 serves
only the JAX package's mass/thermal split kernels, which the CUDA kernel
makes unnecessary, and is not ported.

Species axis order: 0=electron, 1=ion, 2=neutral; pair axis order:
0=(e,i), 1=(e,n), 2=(i,n).
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch

from ..constants import D3Q19
from .collide import _true_div, species_scalars

_W = [float(w) for w in D3Q19.W]
_CX = [float(c) for c in D3Q19.CX]
_CY = [float(c) for c in D3Q19.CY]
_CZ = [float(c) for c in D3Q19.CZ]
_Q = D3Q19.Q

_PAIR_IDX = ((0, 1), (0, 2), (1, 2))


def equilibrium_wpolys3(ux, uy, uz, cs2: float) -> List[torch.Tensor]:
    """w_i * poly_i(u) for the D3Q19 stencil (cf. ops/equilibrium.py)."""
    inv = 1.0 / cs2
    u2_term = (ux * ux + uy * uy + uz * uz) * (0.5 * inv)
    out = []
    for i in range(_Q):
        cu = _CX[i] * ux + _CY[i] * uy + _CZ[i] * uz
        out.append(_W[i] * (1.0 + cu * inv + (cu * cu) * (0.5 * inv * inv)
                            - u2_term))
    return out


def equilibrium_wpolys3_dev(ux, uy, uz, cs2: float) -> List[torch.Tensor]:
    """w_i * (poly_i - 1), built from the velocity terms directly (the
    neutral delta-storage mode; wpoly_i - w_i would cancel
    catastrophically at the tiny neutral velocities)."""
    inv = 1.0 / cs2
    u2_term = (ux * ux + uy * uy + uz * uz) * (0.5 * inv)
    out = []
    for i in range(_Q):
        cu = _CX[i] * ux + _CY[i] * uy + _CZ[i] * uz
        out.append(_W[i] * (cu * inv + (cu * cu) * (0.5 * inv * inv)
                            - u2_term))
    return out


class Macros3D(NamedTuple):
    rho: torch.Tensor       # (3, NZ, NY, NX) guarded
    ux: torch.Tensor
    uy: torch.Tensor
    uz: torch.Tensor
    T: Optional[torch.Tensor]
    ux_pair: torch.Tensor   # (3, NZ, NY, NX) — (ei, en, in)
    uy_pair: torch.Tensor
    uz_pair: torch.Tensor
    rho_q: torch.Tensor     # (NZ, NY, NX)
    rho_raw: Optional[torch.Tensor] = None
    # neutral density deviation when f[2] is delta-stored
    drho_n: Optional[torch.Tensor] = None


def _sum_dirs(a_s) -> torch.Tensor:
    acc = a_s[0]
    for i in range(1, _Q):
        acc = acc + a_s[i]
    return acc


def _moments3(f_s):
    """rho, px, py, pz for one species (sequential direction order)."""
    rho = _sum_dirs(f_s)
    px = py = pz = None

    def acc(m, c, v):
        if c == 0.0:
            return m
        term = v if c > 0 else -v
        return term if m is None else m + term

    for i in range(_Q):
        px = acc(px, _CX[i], f_s[i])
        py = acc(py, _CY[i], f_s[i])
        pz = acc(pz, _CZ[i], f_s[i])
    return rho, px, py, pz


def update_macro3(
    f, g, Ex, Ey, Ez, *,
    q_e: float, q_i: float, m_e: float, m_i: float,
    neutral_ref: float = 0.0,
) -> Macros3D:
    """Moments + guards + half-force + mixtures + rho_q on D3Q19, with the
    2-D update_macro's guard thresholds. neutral_ref != 0: f[2] holds
    deviations from the uniform background neutral_ref * w_i."""
    qom = (q_e / m_e, q_i / m_i, 0.0)
    rho_raw, rho_l, ux_l, uy_l, uz_l, T_l, alive_l = ([] for _ in range(7))
    drho_n = None
    for s in range(3):
        rho, px, py, pz = _moments3(f[s])
        if s == 2 and neutral_ref != 0.0:
            drho_n = rho
            rho = neutral_ref + rho
        alive = rho >= 1e-10
        inv_rho = 1.0 / torch.where(alive, rho, 1.0)
        ux = torch.where((px == rho) | (px == -rho), 0.0, px * inv_rho)
        uy = torch.where((py == rho) | (py == -rho), 0.0, py * inv_rho)
        uz = torch.where((pz == rho) | (pz == -rho), 0.0, pz * inv_rho)
        if qom[s] != 0.0:
            ux = ux + (0.5 * qom[s]) * Ex
            uy = uy + (0.5 * qom[s]) * Ey
            uz = uz + (0.5 * qom[s]) * Ez
        rho_raw.append(rho)
        alive_l.append(alive)
        rho_l.append(torch.where(alive, rho, 0.0))
        ux_l.append(torch.where(alive, ux, 0.0))
        uy_l.append(torch.where(alive, uy, 0.0))
        uz_l.append(torch.where(alive, uz, 0.0))
        if g is not None:
            T_l.append(torch.where(alive, _sum_dirs(g[s]), 0.0))

    uxp, uyp, uzp = [], [], []
    for a, b in _PAIR_IDX:
        ra, rb = rho_raw[a], rho_raw[b]
        both_dead = (~alive_l[a]) & (~alive_l[b])
        inv = 1.0 / torch.where(both_dead, 1.0, ra + rb)
        uxp.append(torch.where(both_dead, 0.0,
                               (ra * ux_l[a] + rb * ux_l[b]) * inv))
        uyp.append(torch.where(both_dead, 0.0,
                               (ra * uy_l[a] + rb * uy_l[b]) * inv))
        uzp.append(torch.where(both_dead, 0.0,
                               (ra * uz_l[a] + rb * uz_l[b]) * inv))

    # charge density with the signed < 1e-15 clamp
    rho_q = (q_i / m_i) * rho_l[1] + (q_e / m_e) * rho_l[0]
    rho_q = torch.where(rho_q < 1e-15, 0.0, rho_q)

    return Macros3D(
        rho=torch.stack(rho_l), ux=torch.stack(ux_l), uy=torch.stack(uy_l),
        uz=torch.stack(uz_l),
        T=torch.stack(T_l) if g is not None else None,
        ux_pair=torch.stack(uxp), uy_pair=torch.stack(uyp),
        uz_pair=torch.stack(uzp),
        rho_q=rho_q, rho_raw=torch.stack(rho_raw), drho_n=drho_n,
    )


def _pair_polys(mac: Macros3D, cs2: float, pairs):
    return {p: equilibrium_wpolys3(mac.ux_pair[p], mac.uy_pair[p],
                                   mac.uz_pair[p], cs2) for p in pairs}


def _species_setup3(s, mac, cs2, taus, pair_polys, self_wpolys=None):
    """Shared per-species precomputation (cf. 2-D _species_setup)."""
    p1, p2 = _PAIR_IDX[s]
    t_self, invs, keep = species_scalars(s, taus)
    if pair_polys is None:
        pair_polys = _pair_polys(mac, cs2, (p1, p2))
    wpoly_self = (self_wpolys if self_wpolys is not None
                  else equilibrium_wpolys3(mac.ux[s], mac.uy[s], mac.uz[s],
                                           cs2))
    wp = (wpoly_self, pair_polys[p1], pair_polys[p2])
    return t_self, invs, wp, keep


def collide_species_f_dirs3(
    s, f_s, mac, Ex, Ey, Ez, *,
    taus, q_e, q_i, m_e, m_i, cs2,
    pair_polys=None, self_wpolys=None, neutral_ref=0.0,
):
    """Mass-population update for species s (never reads g or T), with the
    exact delta-form BGK for delta-stored neutrals:
        delta'_i = keep delta_i + Sum_p amp_p wdev_p,i + drho_n (1-keep) w_i
    """
    charge = (q_e, q_i, 0.0)
    mass = (m_e, m_i, 1.0)
    t_self, invs, wp, keep = _species_setup3(s, mac, cs2, taus, pair_polys,
                                             self_wpolys)
    p1, p2 = _PAIR_IDX[s]
    rho_s = mac.rho[s]
    ux_s, uy_s, uz_s = mac.ux[s], mac.uy[s], mac.uz[s]
    amp_f = tuple(rho_s * inv for inv in invs)

    if s == 2 and neutral_ref != 0.0:
        wdev = (equilibrium_wpolys3_dev(ux_s, uy_s, uz_s, cs2),
                equilibrium_wpolys3_dev(mac.ux_pair[p1], mac.uy_pair[p1],
                                        mac.uz_pair[p1], cs2),
                equilibrium_wpolys3_dev(mac.ux_pair[p2], mac.uy_pair[p2],
                                        mac.uz_pair[p2], cs2))
        damp = mac.drho_n * (1.0 - keep)
        return [f_s[i] * keep
                + amp_f[0] * wdev[0][i] + amp_f[1] * wdev[1][i]
                + amp_f[2] * wdev[2][i] + damp * _W[i]
                for i in range(_Q)]

    charged = charge[s] != 0.0
    if charged:
        uE = ux_s * Ex + uy_s * Ey + uz_s * Ez
        force_amp = (charge[s] / mass[s] / cs2) * rho_s * (
            1.0 - 1.0 / (2.0 * t_self))

    f_dirs = []
    for i in range(_Q):
        feqd = (amp_f[0] * wp[0][i] + amp_f[1] * wp[1][i]
                + amp_f[2] * wp[2][i])
        relax = f_s[i] * keep + feqd
        if charged:
            cE = _CX[i] * Ex + _CY[i] * Ey + _CZ[i] * Ez
            cu = _CX[i] * ux_s + _CY[i] * uy_s + _CZ[i] * uz_s
            F = (_W[i] * force_amp) * (cE + _true_div(cu * cE, cs2) - uE)
            f_dirs.append(relax + F)
        else:
            f_dirs.append(relax)
    return f_dirs


def collide_species_g_dirs3(
    s, g_s, mac, *,
    taus, cs2, kb,
    pair_polys=None, self_wpolys=None, g_recip=None,
):
    """Thermal (DDF) update for species s; needs only macros. g_recip not
    None: the partial-fraction form with that reciprocal (bf16 mode, every
    species); None: the exact combined-fraction form."""
    t_self, invs, wp, keep = _species_setup3(s, mac, cs2, taus, pair_polys,
                                             self_wpolys)
    rho_s, T_s = mac.rho[s], mac.T[s]
    ux_s, uy_s, uz_s = mac.ux[s], mac.uy[s], mac.uz[s]
    amp_f = tuple(rho_s * inv for inv in invs)
    u2 = ux_s * ux_s + uy_s * uy_s + uz_s * uz_s
    dT_amp = _true_div(-(rho_s * u2), kb)

    if g_recip is not None:
        # a pair with tau = 1 (r = 0) contributes an exact -1/2: skipped
        active = [p for p in range(3) if (1.0 - invs[p]) != 0.0]
        cs_l, offs = {}, {}
        for p in active:
            r = 1.0 - invs[p]
            cs_l[p] = rho_s * (r * r - r) + r
            offs[p] = 2.0 * r
        ratio_q = (T_s * g_recip(torch.where(rho_s == 0.0, 1.0, rho_s))
                   ) * (1.0 / _Q)
        g_dirs = []
        for i in range(_Q):
            qf = [_Q * (amp_f[p] * wp[p][i]) for p in range(3)]
            geqd = ratio_q * (qf[0] + qf[1] + qf[2])
            tm = -1.5
            for p in active:
                tm = tm + cs_l[p] * g_recip(qf[p] + offs[p])
            g_dirs.append(g_s[i] * keep + geqd + dT_amp * tm)
        return g_dirs

    amp_g = tuple(T_s * inv for inv in invs)
    tt = []
    for inv in invs:
        r = 1.0 - inv
        tt.append(((2.0 * r * r - 2.0 * r) * rho_s, 4.0 * r))
    g_dirs = []
    for i in range(_Q):
        geqd = amp_g[0] * wp[0][i] + amp_g[1] * wp[1][i] + amp_g[2] * wp[2][i]
        ns, ds = [], []
        for p in range(3):
            qf = _Q * (amp_f[p] * wp[p][i])
            ns.append(tt[p][0] - qf)
            ds.append(tt[p][1] + 2.0 * qf)
        d12 = ds[0] * ds[1]
        tm = (ns[0] * (ds[1] * ds[2]) + ns[1] * (ds[0] * ds[2])
              + ns[2] * d12) / (d12 * ds[2])
        g_dirs.append(g_s[i] * keep + geqd + dT_amp * tm)
    return g_dirs


def collide_species_dirs3(
    s: int, f_s, g_s, mac: Macros3D, Ex, Ey, Ez, *,
    taus, q_e: float, q_i: float, m_e: float, m_i: float,
    cs2: float, kb: float,
    pair_polys=None,
    neutral_ref: float = 0.0,
    g_recip=None,
):
    """Post-collision (f_dirs, g_dirs) for species s, as lists of Q
    (NZ, NY, NX) planes."""
    if pair_polys is None:
        pair_polys = _pair_polys(mac, cs2, _PAIR_IDX[s])
    self_wpolys = equilibrium_wpolys3(mac.ux[s], mac.uy[s], mac.uz[s], cs2)
    f_dirs = collide_species_f_dirs3(
        s, f_s, mac, Ex, Ey, Ez, taus=taus, q_e=q_e, q_i=q_i, m_e=m_e,
        m_i=m_i, cs2=cs2, pair_polys=pair_polys, self_wpolys=self_wpolys,
        neutral_ref=neutral_ref)
    g_dirs = collide_species_g_dirs3(
        s, g_s, mac, taus=taus, cs2=cs2, kb=kb, pair_polys=pair_polys,
        self_wpolys=self_wpolys, g_recip=g_recip)
    return f_dirs, g_dirs


def collide3(f, g, mac: Macros3D, Ex, Ey, Ez, *, taus, q_e, q_i, m_e, m_i,
             cs2, kb, neutral_ref=0.0, g_recip=None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Triple-BGK + Guo + DDF thermal of the whole lattice: (f_post,
    g_post), each (3, 19, NZ, NY, NX)."""
    kw = dict(taus=taus, q_e=q_e, q_i=q_i, m_e=m_e, m_i=m_i, cs2=cs2, kb=kb,
              neutral_ref=neutral_ref, g_recip=g_recip)
    pair_polys = _pair_polys(mac, cs2, range(3))
    f_out, g_out = [], []
    for s in range(3):
        f_dirs, g_dirs = collide_species_dirs3(
            s, f[s], g[s], mac, Ex, Ey, Ez, pair_polys=pair_polys, **kw)
        f_out.append(torch.stack(f_dirs))
        g_out.append(torch.stack(g_dirs))
    return torch.stack(f_out), torch.stack(g_out)


def stream_periodic3(f: torch.Tensor) -> torch.Tensor:
    """Periodic push-stream of (..., 19, NZ, NY, NX) populations: direction
    i moves by (cz, cy, cx)."""
    parts = [
        torch.roll(f[..., i, :, :, :],
                   shifts=(int(D3Q19.CZ[i]), int(D3Q19.CY[i]),
                           int(D3Q19.CX[i])),
                   dims=(-3, -2, -1))
        for i in range(_Q)
    ]
    return torch.stack(parts, dim=-4)
