"""Single-population D2Q9 cavity physics, per-direction form (counterpart
of lbm_tpu/ops/cavity.py).

The formulas replicate the classic solver (reference:
old codes/LBM_classic/LBM.cpp:43-88): BGK collision against the
second-order equilibrium with the hard-coded 3 / 4.5 / 1.5 coefficients,
and the post-streaming moment update with the rho < 1e-10 guard.

Every expression keeps the JAX function's order, with scalar stencil
constants and sequential 0..8 accumulation, so the f64 and f32 results
equal the JAX ops run op by op; the CUDA kernels
(kernels/csrc/fused_cavity.cu) evaluate the same trees per site.
"""
from __future__ import annotations

import functools
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..constants import D2Q9
from .collide import _true_div

W = [float(w) for w in D2Q9.W]
CX = [int(c) for c in D2Q9.CX]
CY = [int(c) for c in D2Q9.CY]
Q = D2Q9.Q
_NUMPY_DTYPES = {torch.float32: np.float32, torch.float64: np.float64}


def feq_dir(i: int, rho, ux, uy, u2):
    """w_i rho (1 + 3 c.u + 4.5 (c.u)^2 - 1.5 u^2)  (LBM.cpp:55).

    Zero-velocity stencil terms are elided; the elision only flips the sign
    of a floating-point zero, which every downstream consumer erases.
    """
    cx, cy = CX[i], CY[i]
    if cx and cy:
        cu = float(cx) * ux + float(cy) * uy
    elif cx:
        cu = float(cx) * ux
    elif cy:
        cu = float(cy) * uy
    else:
        return W[0] * rho * (1.0 - 1.5 * u2)
    return W[i] * rho * (1.0 + 3.0 * cu + 4.5 * cu * cu - 1.5 * u2)


def collide_dirs(f_dirs: Sequence, rho, ux, uy, tau: float) -> List:
    """BGK relaxation of all 9 populations: f - (f - feq)/tau (LBM.cpp:53-57).
    The division by tau is a true division (see ops/collide._true_div)."""
    u2 = ux * ux + uy * uy
    return [
        f_dirs[i] - _true_div(f_dirs[i] - feq_dir(i, rho, ux, uy, u2), tau)
        for i in range(Q)
    ]


def sum_dirs(planes: Sequence):
    """Sequential 0..8 accumulation (the reference's reduction order)."""
    acc = planes[0]
    for i in range(1, Q):
        acc = acc + planes[i]
    return acc


def macros_guarded(f_dirs: Sequence) -> Tuple:
    """(rho, ux, uy) with the rho < 1e-10 dead-cell guard (LBM.cpp:74-88).

    Momentum sums skip zero-velocity directions (sign-of-zero neutral);
    nonzero terms accumulate in direction order like the reference's loop.
    """
    rho_raw = sum_dirs(f_dirs)
    px = py = None
    for i in range(Q):
        if CX[i]:
            t = f_dirs[i] if CX[i] > 0 else -f_dirs[i]
            px = t if px is None else px + t
        if CY[i]:
            t = f_dirs[i] if CY[i] > 0 else -f_dirs[i]
            py = t if py is None else py + t
    alive = rho_raw >= 1e-10
    safe = torch.where(alive, rho_raw, 1.0)
    rho = torch.where(alive, rho_raw, 0.0)
    ux = torch.where(alive, px / safe, 0.0)
    uy = torch.where(alive, py / safe, 0.0)
    return rho, ux, uy


def lid_deltas(rho_top, u_lid_dyn) -> Tuple:
    """Zou/He-style momentum corrections on the moving lid (LBM.cpp:146-153).

    rho_top: per-column density of the PRE-streaming (post-collision)
    populations on the lid row; u_lid_dyn: the lid speed, a Python float
    that holds a value of rho_top's dtype. Returns (d5, d6), added to the
    reflected f[5] -> f[7] and f[6] -> f[8] populations.
    """
    d5 = -6.0 * W[5] * rho_top * (float(CX[5]) * u_lid_dyn)
    d6 = -6.0 * W[6] * rho_top * (float(CX[6]) * u_lid_dyn)
    return d5, d6


def lid_speed(step: int, *, u_lid: float, sigma: float,
              dtype: torch.dtype) -> float:
    """u_lid * t / sigma for t < sigma, else u_lid (LBM.cpp:180), as the
    JAX code evaluates it under weak typing: u_lid / sigma folded in double
    and cast to dtype, then multiplied by t in dtype. Computed on the host
    from the host step counter; returns a Python float that holds a value
    of dtype."""
    dt = _NUMPY_DTYPES[dtype]
    t = dt(step)
    if t < dt(sigma):
        return float(dt(u_lid / sigma) * t)
    return float(dt(u_lid))


@functools.lru_cache(maxsize=None)
def _w_f32(device: torch.device) -> torch.Tensor:
    return torch.tensor(D2Q9.W, dtype=torch.float32,
                        device=device)[:, None, None]


def decode(f: torch.Tensor) -> torch.Tensor:
    """Full populations in the compute dtype. bf16 storage holds f as
    deviations from the uniform background w_i, which cavity streaming and
    bounce-back leave invariant (w5 = w7, w6 = w8); arithmetic is f32."""
    if f.dtype == torch.bfloat16:
        return f.float() + _w_f32(f.device)
    return f


def encode(f_full: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The storage form of full populations: the step's single lossy
    rounding in bf16 storage."""
    if dtype == torch.bfloat16:
        return (f_full - _w_f32(f_full.device)).to(torch.bfloat16)
    return f_full
