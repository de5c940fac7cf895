"""Macroscopic moment update (counterpart of lbm_tpu/ops/macros.py).

    rho_s = sum_i f_s_i
    u_s   = sum_i f_s_i c_i / rho_s  + (1/2) q_s E / m_s      (charged s only)
    T_s   = sum_i g_s_i

with the reference's three stability guards, which are part of the golden
trajectory (reference: src/plasma.cpp:317-456):
  * rho_s < 1e-10   -> cell zeroed (rho, u, T)
  * momentum == +/-rho (exact fp equality) -> that velocity component zeroed
  * rho_q < 1e-15   -> 0 (signed comparison: negative charge is clamped too)

Moment sums accumulate sequentially in direction order 0..8, never with
`tensor.sum(dim=...)`: a different reduction order makes the exact-equality
guard fire on different cells. The CUDA kernel follows the same order.

Species axis order: 0=electron, 1=ion, 2=neutral.
Pair axis order: 0=(e,i), 1=(e,n), 2=(i,n).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..constants import D2Q9

_CX = [float(c) for c in D2Q9.CX]
_CY = [float(c) for c in D2Q9.CY]
_Q = D2Q9.Q
PAIRS = ((0, 1), (0, 2), (1, 2))


class Macros(NamedTuple):
    rho: torch.Tensor      # (3, NY, NX) guarded densities
    ux: torch.Tensor       # (3, NY, NX)
    uy: torch.Tensor       # (3, NY, NX)
    T: torch.Tensor        # (3, NY, NX)
    ux_pair: torch.Tensor  # (3, NY, NX) — (ei, en, in)
    uy_pair: torch.Tensor  # (3, NY, NX)
    rho_q: torch.Tensor    # (NY, NX)
    rho_raw: torch.Tensor  # (3, NY, NX) pre-guard density
    # neutral density deviation Sum_i delta_i in neutral-delta storage;
    # None in classic mode (rho - rho_ref would cancel)
    drho_n: Optional[torch.Tensor] = None


def sum_dirs(a_s) -> torch.Tensor:
    """Sequential 0..8 accumulation (the reference's reduction order)."""
    acc = a_s[0]
    for i in range(1, _Q):
        acc = acc + a_s[i]
    return acc


def _moments(f_s):
    """rho, px, py for one species (sequential 0..8 order)."""
    rho = sum_dirs(f_s)
    px = None
    py = None
    for i in range(_Q):
        if _CX[i] != 0.0:
            term = f_s[i] if _CX[i] > 0 else -f_s[i]
            px = term if px is None else px + term
        if _CY[i] != 0.0:
            term = f_s[i] if _CY[i] > 0 else -f_s[i]
            py = term if py is None else py + term
    return rho, px, py


def _mixture_velocities(rho_raw, alive, ux, uy):
    """Pairwise density-weighted mixture velocities: raw densities as
    weights, guarded velocities, zeroed only when BOTH raw densities are
    dead (reference: src/plasma.cpp:426-449)."""
    uxp, uyp = [], []
    for a, b in PAIRS:
        ra, rb = rho_raw[a], rho_raw[b]
        both_dead = (~alive[a]) & (~alive[b])
        inv = 1.0 / torch.where(both_dead, 1.0, ra + rb)
        uxp.append(torch.where(both_dead, 0.0, (ra * ux[a] + rb * ux[b]) * inv))
        uyp.append(torch.where(both_dead, 0.0, (ra * uy[a] + rb * uy[b]) * inv))
    return uxp, uyp


def update_macro(
    f: torch.Tensor,                 # (3, Q, NY, NX)
    g: torch.Tensor,                 # (3, Q, NY, NX)
    Ex: torch.Tensor,                # (NY, NX)
    Ey: torch.Tensor,
    *,
    q_e: float,
    q_i: float,
    m_e: float,
    m_i: float,
    neutral_ref: float = 0.0,
) -> Macros:
    """The momentum==+/-rho guard assigns 0, as the final reference does
    (the debug predecessor's guard values are ROADMAP Queue 1 item 9).

    neutral_ref != 0: f[2] holds deviations delta_i from the uniform
    background neutral_ref * w_i, so rho_n = neutral_ref + Sum_i delta_i
    and the momenta come from the deltas directly."""
    qom = (q_e / m_e, q_i / m_i, 0.0)

    rho_raw, rho_l, ux_l, uy_l, T_l, alive_l = [], [], [], [], [], []
    drho_n = None
    for s in range(3):
        rho, px, py = _moments(f[s])
        if s == 2 and neutral_ref != 0.0:
            drho_n = rho
            rho = neutral_ref + rho
        alive = rho >= 1e-10
        safe_rho = torch.where(alive, rho, 1.0)
        inv_rho = 1.0 / safe_rho  # one division shared by both components
        ux = torch.where((px == rho) | (px == -rho), 0.0, px * inv_rho)
        uy = torch.where((py == rho) | (py == -rho), 0.0, py * inv_rho)
        if qom[s] != 0.0:
            # half-step Guo force correction (src/plasma.cpp:389-390)
            ux = ux + (0.5 * qom[s]) * Ex
            uy = uy + (0.5 * qom[s]) * Ey
        rho_raw.append(rho)
        alive_l.append(alive)
        rho_l.append(torch.where(alive, rho, 0.0))
        ux_l.append(torch.where(alive, ux, 0.0))
        uy_l.append(torch.where(alive, uy, 0.0))
        T_l.append(torch.where(alive, sum_dirs(g[s]), 0.0))

    uxp, uyp = _mixture_velocities(rho_raw, alive_l, ux_l, uy_l)

    # charge density with the signed < 1e-15 clamp (src/plasma.cpp:452-453)
    rho_q = (q_i / m_i) * rho_l[1] + (q_e / m_e) * rho_l[0]
    rho_q = torch.where(rho_q < 1e-15, 0.0, rho_q)

    return Macros(
        rho=torch.stack(rho_l), ux=torch.stack(ux_l), uy=torch.stack(uy_l),
        T=torch.stack(T_l),
        ux_pair=torch.stack(uxp), uy_pair=torch.stack(uyp),
        rho_q=rho_q, rho_raw=torch.stack(rho_raw), drho_n=drho_n,
    )
