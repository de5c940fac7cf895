"""Second-order equilibria on the D2Q9 stencil (counterpart of
lbm_tpu/ops/equilibrium.py).

    eq_i(amp, u) = w_i * amp * (1 + (c_i.u)/cs2 + (c_i.u)^2/(2 cs2^2)
                                 - |u|^2/(2 cs2))

`amp` is the species density for the mass populations f or its temperature
for the thermal populations g. Python-float constants fold in double where
the JAX code folds them, then meet the tensor in its dtype.
"""
from __future__ import annotations

from typing import List

import torch

from ..constants import D2Q9

_W = [float(w) for w in D2Q9.W]
_CX = [float(c) for c in D2Q9.CX]
_CY = [float(c) for c in D2Q9.CY]


def equilibrium_polys(ux: torch.Tensor, uy: torch.Tensor,
                      cs2: float) -> List[torch.Tensor]:
    """The amp-independent polynomial factor per direction (eq = w amp poly)."""
    inv = 1.0 / cs2
    u2_term = (ux * ux + uy * uy) * (0.5 * inv)
    out = []
    for i in range(D2Q9.Q):
        cu = _CX[i] * ux + _CY[i] * uy
        out.append(1.0 + cu * inv + (cu * cu) * (0.5 * inv * inv) - u2_term)
    return out


def equilibrium_wpolys(ux: torch.Tensor, uy: torch.Tensor,
                       cs2: float) -> List[torch.Tensor]:
    """w_i * poly_i: the weight folded into the shared polynomial."""
    polys = equilibrium_polys(ux, uy, cs2)
    return [_W[i] * polys[i] for i in range(D2Q9.Q)]


def equilibrium_wpolys_dev(ux: torch.Tensor, uy: torch.Tensor,
                           cs2: float) -> List[torch.Tensor]:
    """w_i * (poly_i - 1), built from the velocity terms directly (the
    neutral-delta mode; wpoly_i - w_i would cancel catastrophically)."""
    inv = 1.0 / cs2
    u2_term = (ux * ux + uy * uy) * (0.5 * inv)
    out = []
    for i in range(D2Q9.Q):
        cu = _CX[i] * ux + _CY[i] * uy
        out.append(_W[i] * (cu * inv + (cu * cu) * (0.5 * inv * inv)
                            - u2_term))
    return out
