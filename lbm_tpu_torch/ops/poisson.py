"""Spectral Poisson solve and periodic E-field (counterpart of
lbm_tpu/ops/poisson.py: solve_fft, efield_periodic).

Solves nabla^2 phi = -rho_q with the discrete 5-point eigenvalue
4 (sin^2(pi kx/NX) + sin^2(pi ky/NY)) and the k=0 mode zeroed
(src/poisson.cpp:365-420), then E = -grad phi by central differences
(src/poisson.cpp:589-607). torch.fft.rfft2/irfft2 at every size: the JAX
package's packed transform at >=2048^2 works around the TPU's slow real
FFT and has no purpose on a GPU. The iterative solvers are ROADMAP Queue 1
item 8.
"""
from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch


@functools.lru_cache(maxsize=8)
def _inverse_eigenvalues(NY: int, NX: int, dtype: torch.dtype,
                         device: torch.device) -> torch.Tensor:
    """1/eigenvalue of the 5-point Laplacian on the rfft2 half spectrum,
    0 at k=0; built in float64 numpy and cast once, like the JAX code.
    Cached because the step calls it with the same grid every time."""
    ky = np.fft.fftfreq(NY) * NY            # integer wavenumbers
    kx = np.arange(NX // 2 + 1)
    siny2 = np.sin(np.pi * ky / NY) ** 2    # (NY,)
    sinx2 = np.sin(np.pi * kx / NX) ** 2    # (NX//2+1,)
    denom = 4.0 * (siny2[:, None] + sinx2[None, :])
    inv = np.where(denom > 1e-15, 1.0 / np.maximum(denom, 1e-300), 0.0)
    return torch.as_tensor(inv, dtype=dtype, device=device)


def solve_fft(rho_q: torch.Tensor) -> torch.Tensor:
    """Spectral solve with periodic BCs: rho_q (NY, NX) -> zero-mean phi."""
    NY, NX = rho_q.shape
    rho_hat = torch.fft.rfft2(rho_q)        # (NY, NX//2+1)
    inv = _inverse_eigenvalues(NY, NX, rho_q.dtype, rho_q.device)
    phi = torch.fft.irfft2(rho_hat * inv, s=(NY, NX))
    return phi.to(rho_q.dtype)


def efield_periodic(phi: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Central differences with periodic wrap (src/poisson.cpp:589-607)."""
    Ex = -0.5 * (torch.roll(phi, -1, dims=1) - torch.roll(phi, 1, dims=1))
    Ey = -0.5 * (torch.roll(phi, -1, dims=0) - torch.roll(phi, 1, dims=0))
    return Ex, Ey
