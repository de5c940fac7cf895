"""Pairwise-BGK collisions with Guo electric forcing and DDF thermal coupling
(counterpart of lbm_tpu/ops/collide.py; physics from src/collisions.cpp).

Mass populations (per species s, direction i):
    f_s' = f_s - (f_s - feq_s)/tau_s - (f_s - feq_s_p1)/tau_sp1
               - (f_s - feq_s_p2)/tau_sp2 + F_s
    F_s  = w_i q_s rho_s / (m_s cs2) (1 - 1/(2 tau_s))
             [ (c.E) + (c.u_s)(c.E)/cs2 - u_s.E ]        (charged only)
Thermal populations:
    g_a' = g_a - (g_a - geq_a)/tau_a - ... + DeltaT_a

Every expression tree matches the JAX function of the same name, so the f64
results agree to a few ulp. The CUDA kernel (kernels/csrc/fused_step.cu)
evaluates the same trees per lattice site.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..constants import D2Q9
from .equilibrium import equilibrium_wpolys, equilibrium_wpolys_dev
from .macros import PAIRS, Macros

_W = [float(w) for w in D2Q9.W]
_CX = [float(c) for c in D2Q9.CX]
_CY = [float(c) for c in D2Q9.CY]
_Q = D2Q9.Q

def _true_div(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c, rounded once. PyTorch's CUDA kernel divides by a Python
    scalar as a product with its reciprocal, which can move the last bit;
    a 0-dim divisor on x's device is divided, as JAX and the CUDA kernel
    divide. torch.full fills the divisor on the device, where torch.tensor
    would copy it from the host and wait for the stream."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


# species s collides with itself and with its two partners; pair-velocity
# axis order is (ei, en, in)
PAIR_IDX = ((0, 1), (0, 2), (1, 2))


def species_scalars(s: int, taus) -> Tuple[float, Tuple[float, float, float],
                                             float]:
    """(tau_self, (1/tau_self, 1/tau_c1, 1/tau_c2), keep) for species s,
    folded in double exactly as the JAX code folds them."""
    tau_e, tau_i, tau_n, tau_ei, tau_en, tau_in = taus
    tau_self = (tau_e, tau_i, tau_n)
    tau_cross = ((tau_ei, tau_en), (tau_ei, tau_in), (tau_en, tau_in))
    t_self = tau_self[s]
    t_c1, t_c2 = tau_cross[s]
    invs = (1.0 / t_self, 1.0 / t_c1, 1.0 / t_c2)
    keep = 1.0 - (invs[0] + invs[1] + invs[2])
    return t_self, invs, keep


def _species_setup(s, mac, cs2, taus, pair_polys, self_wpolys=None):
    """Shared per-species precomputation for the f- and g-side collisions."""
    p1, p2 = PAIR_IDX[s]
    t_self, invs, keep = species_scalars(s, taus)
    wpoly_self = (self_wpolys if self_wpolys is not None
                  else equilibrium_wpolys(mac.ux[s], mac.uy[s], cs2))
    if pair_polys is None:
        pair_polys = {
            p: equilibrium_wpolys(mac.ux_pair[p], mac.uy_pair[p], cs2)
            for p in (p1, p2)
        }
    wp = (wpoly_self, pair_polys[p1], pair_polys[p2])
    return t_self, invs, wp, keep


def collide_species_f_dirs(
    s, f_s, mac, Ex, Ey, *,
    taus, q_e, q_i, m_e, m_i, cs2,
    pair_polys=None, self_wpolys=None, neutral_ref=0.0,
):
    """Mass-population update for species s. With neutral_ref != 0 the
    neutral populations are deltas from rho_ref * w_i and relax in the
    exact delta form:
        delta'_i = keep * delta_i + Sum_p inv_p (rho_n wdev_p,i + drho_n w_i)
    """
    charge = (q_e, q_i, 0.0)
    mass = (m_e, m_i, 1.0)
    t_self, invs, wp, keep = _species_setup(s, mac, cs2, taus, pair_polys,
                                            self_wpolys)
    rho_s, ux_s, uy_s = mac.rho[s], mac.ux[s], mac.uy[s]
    amp_f = tuple(rho_s * inv for inv in invs)

    if s == 2 and neutral_ref != 0.0:
        p1, p2 = PAIR_IDX[s]
        wdev = (equilibrium_wpolys_dev(ux_s, uy_s, cs2),
                equilibrium_wpolys_dev(mac.ux_pair[p1], mac.uy_pair[p1], cs2),
                equilibrium_wpolys_dev(mac.ux_pair[p2], mac.uy_pair[p2], cs2))
        damp = mac.drho_n * (1.0 - keep)
        return [f_s[i] * keep
                + amp_f[0] * wdev[0][i] + amp_f[1] * wdev[1][i]
                + amp_f[2] * wdev[2][i] + damp * _W[i]
                for i in range(_Q)]

    charged = charge[s] != 0.0
    if charged:
        uE = ux_s * Ex + uy_s * Ey
        force_amp = (charge[s] / mass[s] / cs2) * rho_s * (
            1.0 - 1.0 / (2.0 * t_self))

    f_dirs = []
    for i in range(_Q):
        feqd = amp_f[0] * wp[0][i] + amp_f[1] * wp[1][i] + amp_f[2] * wp[2][i]
        relax = f_s[i] * keep + feqd
        if charged:
            cE = _CX[i] * Ex + _CY[i] * Ey
            cu = _CX[i] * ux_s + _CY[i] * uy_s
            F = (_W[i] * force_amp) * (cE + _true_div(cu * cE, cs2) - uE)
            f_dirs.append(relax + F)
        else:
            f_dirs.append(relax)
    return f_dirs


def collide_species_g_dirs(
    s, g_s, mac, *,
    taus, cs2, kb,
    pair_polys=None, self_wpolys=None,
):
    """Thermal (DDF) update for species s, energy-loss terms over a common
    denominator (src/collisions.cpp:86-96):
        term_p = (2 rho r^2 - 2 r rho - Q feq/tau) / (2 (2 r + Q feq/tau))
    """
    t_self, invs, wp, keep = _species_setup(s, mac, cs2, taus, pair_polys,
                                            self_wpolys)
    rho_s, ux_s, uy_s, T_s = mac.rho[s], mac.ux[s], mac.uy[s], mac.T[s]
    amp_f = tuple(rho_s * inv for inv in invs)
    amp_g = tuple(T_s * inv for inv in invs)

    tt = []
    for inv in invs:
        r = 1.0 - inv
        tt.append(((2.0 * r * r - 2.0 * r) * rho_s, 4.0 * r))
    u2 = ux_s * ux_s + uy_s * uy_s
    # per-cell factor of the heating source
    dT_amp = _true_div(-(rho_s * u2), kb)

    g_dirs = []
    for i in range(_Q):
        geqd = amp_g[0] * wp[0][i] + amp_g[1] * wp[1][i] + amp_g[2] * wp[2][i]
        ns, ds = [], []
        for p in range(3):
            qf = _Q * (amp_f[p] * wp[p][i])   # = Q feq_p / tau_p
            ns.append(tt[p][0] - qf)
            ds.append(tt[p][1] + 2.0 * qf)
        d12 = ds[0] * ds[1]
        tm = (ns[0] * (ds[1] * ds[2]) + ns[1] * (ds[0] * ds[2])
              + ns[2] * d12) / (d12 * ds[2])
        g_dirs.append(g_s[i] * keep + geqd + dT_amp * tm)
    return g_dirs


def _active_pairs(invs):
    """Pairs with tau != 1. A tau = 1 pair contributes an exact -1/2 to the
    partial-fraction thermal term, so it is skipped; that also removes the
    0 * recip(0) = NaN of dead cells."""
    return [p for p in range(3) if (1.0 - invs[p]) != 0.0]


def collide_species_g_dirs_fast(
    s, g_s, mac, *,
    taus, cs2, kb, recip,
    pair_polys=None, self_wpolys=None,
):
    """Thermal update with the energy-loss term in partial-fraction form
    (bf16-storage mode): tm = -3/2 + Sum_p C_p * recip(q_p + 2 r_p),
    C_p = rho (r^2 - r) + r. Algebraically identical to
    collide_species_g_dirs."""
    t_self, invs, wp, keep = _species_setup(s, mac, cs2, taus, pair_polys,
                                            self_wpolys)
    rho_s, ux_s, uy_s, T_s = mac.rho[s], mac.ux[s], mac.uy[s], mac.T[s]
    amp_f = tuple(rho_s * inv for inv in invs)

    active = _active_pairs(invs)
    cs, offs = {}, {}
    for p in active:
        r = 1.0 - invs[p]
        cs[p] = rho_s * (r * r - r) + r      # C_p, per-cell
        offs[p] = 2.0 * r                    # b_p / 2, scalar
    u2 = ux_s * ux_s + uy_s * uy_s
    dT_amp = _true_div(-(rho_s * u2), kb)
    # geqd = (T / rho) * Sum_p qf_p / Q; dead cells have T = 0
    ratio_q = (T_s * recip(torch.where(rho_s == 0.0, 1.0, rho_s))) * (1.0 / _Q)

    g_dirs = []
    for i in range(_Q):
        qf = [_Q * (amp_f[p] * wp[p][i]) for p in range(3)]  # Q feq_p/tau_p
        geqd = ratio_q * (qf[0] + qf[1] + qf[2])
        tm = -1.5
        for p in active:
            tm = tm + cs[p] * recip(qf[p] + offs[p])
        g_dirs.append(g_s[i] * keep + geqd + dT_amp * tm)
    return g_dirs


def collide_species_dirs_fused_fast(
    s, f_s, g_s, mac, Ex, Ey, *,
    taus, q_e, q_i, m_e, m_i, cs2, kb, recip,
    pair_polys=None, self_wpolys=None,
):
    """One-loop f+g update sharing the amp*wp equilibrium products, with the
    9x of qf refolded into the per-cell amplitudes (bf16-storage mode; not
    used for the delta-form neutral f side)."""
    charge = (q_e, q_i, 0.0)
    mass = (m_e, m_i, 1.0)
    t_self, invs, wp, keep = _species_setup(s, mac, cs2, taus, pair_polys,
                                            self_wpolys)
    rho_s, ux_s, uy_s, T_s = mac.rho[s], mac.ux[s], mac.uy[s], mac.T[s]
    amp_f = tuple(rho_s * inv for inv in invs)

    charged = charge[s] != 0.0
    if charged:
        uE = ux_s * Ex + uy_s * Ey
        force_amp = (charge[s] / mass[s] / cs2) * rho_s * (
            1.0 - 1.0 / (2.0 * t_self))

    active = _active_pairs(invs)
    cs9, offs9 = {}, {}
    for p in active:
        r = 1.0 - invs[p]
        cs9[p] = rho_s * ((r * r - r) * (1.0 / _Q)) + r * (1.0 / _Q)
        offs9[p] = 2.0 * r / _Q
    u2 = ux_s * ux_s + uy_s * uy_s
    dT_amp = _true_div(-(rho_s * u2), kb)
    ratio = T_s * recip(torch.where(rho_s == 0.0, 1.0, rho_s))

    f_dirs, g_dirs = [], []
    for i in range(_Q):
        prod = [amp_f[p] * wp[p][i] for p in range(3)]
        feqd = prod[0] + prod[1] + prod[2]
        relax = f_s[i] * keep + feqd
        if charged:
            cE = _CX[i] * Ex + _CY[i] * Ey
            cu = _CX[i] * ux_s + _CY[i] * uy_s
            F = (_W[i] * force_amp) * (cE + _true_div(cu * cE, cs2) - uE)
            f_dirs.append(relax + F)
        else:
            f_dirs.append(relax)
        geqd = ratio * feqd
        tm = -1.5
        for p in active:
            tm = tm + cs9[p] * recip(prod[p] + offs9[p])
        g_dirs.append(g_s[i] * keep + geqd + dT_amp * tm)
    return f_dirs, g_dirs


def collide_species_dirs(
    s: int, f_s, g_s, mac: Macros, Ex: torch.Tensor, Ey: torch.Tensor, *,
    taus, q_e: float, q_i: float, m_e: float, m_i: float,
    cs2: float, kb: float,
    pair_polys=None,
    neutral_ref: float = 0.0,
    g_recip=None,     # not None: bf16-mode thermal forms with this reciprocal
):
    """Post-collision populations for species s as two lists of Q planes."""
    if pair_polys is None:
        p1, p2 = PAIR_IDX[s]
        pair_polys = {
            p: equilibrium_wpolys(mac.ux_pair[p], mac.uy_pair[p], cs2)
            for p in (p1, p2)
        }
    self_wpolys = equilibrium_wpolys(mac.ux[s], mac.uy[s], cs2)
    if g_recip is not None and not (s == 2 and neutral_ref != 0.0):
        return collide_species_dirs_fused_fast(
            s, f_s, g_s, mac, Ex, Ey, taus=taus, q_e=q_e, q_i=q_i,
            m_e=m_e, m_i=m_i, cs2=cs2, kb=kb, recip=g_recip,
            pair_polys=pair_polys, self_wpolys=self_wpolys)
    f_dirs = collide_species_f_dirs(
        s, f_s, mac, Ex, Ey, taus=taus, q_e=q_e, q_i=q_i, m_e=m_e, m_i=m_i,
        cs2=cs2, pair_polys=pair_polys, self_wpolys=self_wpolys,
        neutral_ref=neutral_ref)
    if g_recip is not None:
        g_dirs = collide_species_g_dirs_fast(
            s, g_s, mac, taus=taus, cs2=cs2, kb=kb, recip=g_recip,
            pair_polys=pair_polys, self_wpolys=self_wpolys)
    else:
        g_dirs = collide_species_g_dirs(
            s, g_s, mac, taus=taus, cs2=cs2, kb=kb, pair_polys=pair_polys,
            self_wpolys=self_wpolys)
    return f_dirs, g_dirs


def collide(
    f: torch.Tensor,   # (3, Q, NY, NX)
    g: torch.Tensor,   # (3, Q, NY, NX)
    mac: Macros,
    Ex: torch.Tensor,  # (NY, NX)
    Ey: torch.Tensor,
    *,
    taus: Tuple[float, float, float, float, float, float],
    q_e: float, q_i: float, m_e: float, m_i: float,
    cs2: float, kb: float,
    neutral_ref: float = 0.0,
    g_recip=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One collision step; returns (f_post, g_post) (pre-streaming)."""
    kw = dict(taus=taus, q_e=q_e, q_i=q_i, m_e=m_e, m_i=m_i, cs2=cs2, kb=kb,
              neutral_ref=neutral_ref, g_recip=g_recip)
    pair_polys = {
        p: equilibrium_wpolys(mac.ux_pair[p], mac.uy_pair[p], cs2)
        for p in range(len(PAIRS))
    }
    f_out, g_out = [], []
    for s in range(3):
        f_dirs, g_dirs = collide_species_dirs(s, f[s], g[s], mac, Ex, Ey,
                                              pair_polys=pair_polys, **kw)
        f_out.append(torch.stack(f_dirs))
        g_out.append(torch.stack(g_dirs))
    return torch.stack(f_out), torch.stack(g_out)
