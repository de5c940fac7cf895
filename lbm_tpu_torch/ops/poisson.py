"""Poisson solvers and E-field reconstruction (counterpart of
lbm_tpu/ops/poisson.py).

  * FFT: nabla^2 phi = -rho_q with the discrete 5-point eigenvalue
    4 (sin^2(pi kx/NX) + sin^2(pi ky/NY)) and the k=0 mode zeroed
    (src/poisson.cpp:365-420). torch.fft.rfft2/irfft2 at every size: the
    JAX package's packed transform at >=2048^2 works around the TPU's slow
    real FFT and has no purpose on a GPU.
  * GS / SOR: red-black Gauss-Seidel, red (x+y even) first; SOR blends
    with omega. NPS: the 9-point stencil, colour 2*(x%2)+(y%2) swept 0..3.
    Each colour updates out of place from the phi before it, as
    jnp.where does. Dirichlet variants (periodic=False) update the
    interior only (src/poisson.cpp:90-142, 216-279, 429-483).
  * E = -grad phi by central differences, with periodic wrap
    (src/poisson.cpp:589-607) or the Neumann copy-to-edge closure
    (src/poisson.cpp:551-585).

These sweeps are also the plain version of the iterative-solve kernel
(kernels/poisson_iter.py), which is bitwise equal to them.
"""
from __future__ import annotations

import functools
from typing import Callable, Tuple

import numpy as np
import torch

# Sweeps run by the last solve_gs / solve_9point call (the JAX package's
# while_loop counter, which it does not expose).
LAST_SWEEPS = 0


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


@functools.lru_cache(maxsize=8)
def _gradient_symbols(NY: int, NX: int, dtype: torch.dtype,
                      device: torch.device
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sin(2 pi kx/NX), sin(2 pi ky/NY)) times the inverse eigenvalue on
    the rfft2 half spectrum, built in float64 numpy and cast once."""
    ky = np.fft.fftfreq(NY) * NY
    kx = np.arange(NX // 2 + 1)
    siny2 = np.sin(np.pi * ky / NY) ** 2
    sinx2 = np.sin(np.pi * kx / NX) ** 2
    denom = 4.0 * (siny2[:, None] + sinx2[None, :])
    inv = np.where(denom > 1e-15, 1.0 / np.maximum(denom, 1e-300), 0.0)
    sx = np.sin(2.0 * np.pi * kx / NX)[None, :] * inv
    sy = np.sin(2.0 * np.pi * ky / NY)[:, None] * inv
    return (torch.as_tensor(sx, dtype=dtype, device=device),
            torch.as_tensor(sy, dtype=dtype, device=device))


def solve_fft_efield(rho_q: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Spectral solve with E computed in k-space; phi is never formed
    (lbm_tpu/ops/poisson.py:216).

    efield_periodic's central difference has the k-space symbol
    Ex_hat = -i sin(2 pi kx/NX) phi_hat (and sin(2 pi ky/NY) for Ey), so
    both fields come from rho_hat. After the y-axis inverse each row of
    Wx, Wy is Hermitian in kx (Ex, Ey are real), so D = Wx + i Wy,
    Hermitian-extended to the full width, inverts in ONE complex transform
    to z = Ex + i Ey. Algebraically solve_fft + efield_periodic; rounding
    differs at transform roundoff. This is the library (cuFFT) route, not
    the kernel of kernels/fft_tpu.py."""
    NY, NX = rho_q.shape
    H = NX // 2 + 1
    rho_hat = torch.fft.rfft2(rho_q)
    sx, sy = _gradient_symbols(NY, NX, rho_hat.real.dtype, rho_q.device)
    pr, pi = rho_hat.real, rho_hat.imag
    # E_hat = -i s phi_hat: re = s im(phi_hat), im = -s re(phi_hat)
    ex_hat = torch.complex(sx * pi, -(sx * pr))
    ey_hat = torch.complex(sy * pi, -(sy * pr))
    w = torch.fft.ifft(torch.stack([ex_hat, ey_hat]), dim=1)  # y inverse
    wx, wy = w[0], w[1]
    d_head = wx + torch.complex(-wy.imag, wy.real)            # wx + i wy
    # kx = H..NX-1: conj(wx[:, NX-kx]) + i conj(wy[:, NX-kx])
    tx = torch.flip(wx[:, 1:NX - H + 1], dims=(1,)).conj()
    ty = torch.flip(wy[:, 1:NX - H + 1], dims=(1,)).conj()
    d_tail = tx + torch.complex(-ty.imag, ty.real)
    z = torch.fft.ifft(torch.cat([d_head, d_tail], dim=1), dim=1)
    return z.real.to(rho_q.dtype), z.imag.to(rho_q.dtype)


@functools.lru_cache(maxsize=None)
def _checker_masks(NX: int, NY: int, interior_only: bool
                   ) -> Tuple[np.ndarray, np.ndarray]:
    ii, jj = np.meshgrid(np.arange(NX), np.arange(NY))  # ii=x, jj=y
    red = ((ii + jj) % 2 == 0)
    black = ~red
    if interior_only:
        inside = (ii >= 1) & (ii < NX - 1) & (jj >= 1) & (jj < NY - 1)
        red &= inside
        black &= inside
    return red, black


@functools.lru_cache(maxsize=None)
def _four_color_masks(NX: int, NY: int, interior_only: bool
                      ) -> Tuple[np.ndarray, ...]:
    ii, jj = np.meshgrid(np.arange(NX), np.arange(NY))
    color = 2 * (ii % 2) + (jj % 2)
    masks = []
    for c in range(4):
        m = color == c
        if interior_only:
            m &= (ii >= 1) & (ii < NX - 1) & (jj >= 1) & (jj < NY - 1)
        masks.append(m)
    return tuple(masks)


def _wrap(phi: torch.Tensor) -> torch.Tensor:
    """phi padded by its own periodic wrap, a one-cell ring: what
    jnp.roll reads beyond an edge (interior-only updates never select the
    wrapped values). One padding serves a colour pass's four (the 9-point
    pass's eight) rolls, bit for bit. On an H100 at 2048^2 f32,
    scripts/time_sweep_forms_torch.py timed the 9-point solve at 0.63-0.79
    of the rolls' time and GS and SOR at 0.85-1.13 (PERF.md §6). A block
    of a sharded plane takes its ring from its neighbours instead
    (parallel/mesh.pad_ring)."""
    p = torch.cat([phi[-1:], phi, phi[:1]], dim=0)
    return torch.cat([p[:, -1:], p, p[:, :1]], dim=1)


def _nb5_padded(p: torch.Tensor) -> torch.Tensor:
    """((phi[y,x-1] + phi[y,x+1]) + phi[y-1,x]) + phi[y+1,x] of the plane
    inside p, its one-cell ring: the sum of JAX's four rolls, in their
    order."""
    return p[1:-1, :-2] + p[1:-1, 2:] + p[:-2, 1:-1] + p[2:, 1:-1]


def _nb_diag_padded(p: torch.Tensor) -> torch.Tensor:
    """The diagonal neighbours' sum of the plane inside p, in the order of
    JAX's rolls by (1, 1), (1, -1), (-1, 1), (-1, -1)."""
    return p[:-2, :-2] + p[:-2, 2:] + p[2:, :-2] + p[2:, 2:]


def _masked_update(phi, new, mask):
    """(jnp.where(mask, new, phi), max |upd - phi| over the mask); the max
    propagates NaN, as jnp.max does."""
    upd = torch.where(mask, new, phi)
    err = torch.where(mask, (upd - phi).abs(), 0.0).max()
    return upd, err


def _gs_pass(phi, nb, rho_q, mask, omega):
    """One colour pass of GS (SOR with omega), given phi's 4-neighbour sum
    nb: the masked update and its error."""
    gs = 0.25 * (nb + rho_q)
    new = gs if omega is None else (1.0 - omega) * phi + omega * gs
    return _masked_update(phi, new, mask)


def _nps_pass(phi, nb5, diag, rho_q, mask, twenty):
    """One colour pass of the 9-point stencil, given phi's orthogonal and
    diagonal neighbour sums; twenty is a 0-dim tensor on the device (CUDA's
    true division by a host scalar multiplies by its reciprocal instead)."""
    return _masked_update(phi, (4.0 * nb5 + diag + 6.0 * rho_q) / twenty,
                          mask)


def _iterate(phi0: torch.Tensor, sweep_fn: Callable, max_iter: int,
             tol: float) -> torch.Tensor:
    """The JAX while_loop on the host: sweep while it < max_iter and
    err >= tol, err starting at inf (so at least one sweep). The test runs
    in phi's dtype, tol cast to it as JAX casts a weak-typed float, and is
    False for a NaN err. Reads err on the host after every sweep."""
    global LAST_SWEEPS
    phi, it = phi0, 0
    err = torch.tensor(float("inf"), dtype=phi0.dtype)
    while it < max_iter and bool(err >= tol):
        phi, err = sweep_fn(phi)
        it += 1
    LAST_SWEEPS = it
    return phi


def solve_gs(phi0: torch.Tensor, rho_q: torch.Tensor, *, periodic: bool,
             max_iter: int = 5000, tol: float = 1e-8,
             omega: float | None = None) -> torch.Tensor:
    """Red-black Gauss-Seidel (or SOR when omega is given)."""
    NY, NX = rho_q.shape
    red, black = (torch.as_tensor(m, device=rho_q.device)
                  for m in _checker_masks(NX, NY, not periodic))

    def sweep(phi):
        phi, e1 = _gs_pass(phi, _nb5_padded(_wrap(phi)), rho_q, red, omega)
        phi, e2 = _gs_pass(phi, _nb5_padded(_wrap(phi)), rho_q, black,
                           omega)
        return phi, torch.maximum(e1, e2)

    return _iterate(phi0, sweep, max_iter, tol)


def solve_9point(phi0: torch.Tensor, rho_q: torch.Tensor, *, periodic: bool,
                 max_iter: int = 5000, tol: float = 1e-8) -> torch.Tensor:
    """9-point stencil, 4-colour Gauss-Seidel ordering."""
    NY, NX = rho_q.shape
    masks = [torch.as_tensor(m, device=rho_q.device)
             for m in _four_color_masks(NX, NY, not periodic)]
    twenty = torch.tensor(20.0, dtype=rho_q.dtype, device=rho_q.device)

    def sweep(phi):
        err = torch.zeros((), dtype=phi.dtype, device=phi.device)
        for mask in masks:
            p = _wrap(phi)
            phi, e = _nps_pass(phi, _nb5_padded(p), _nb_diag_padded(p),
                               rho_q, mask, twenty)
            err = torch.maximum(err, e)
        return phi, err

    return _iterate(phi0, sweep, max_iter, tol)


def efield_periodic(phi: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Central differences with periodic wrap (src/poisson.cpp:589-607)."""
    Ex = -0.5 * (torch.roll(phi, -1, dims=1) - torch.roll(phi, 1, dims=1))
    Ey = -0.5 * (torch.roll(phi, -1, dims=0) - torch.roll(phi, 1, dims=0))
    return Ex, Ey


def efield_neumann(phi: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Central differences on the interior, copy-to-edge Neumann closure
    (src/poisson.cpp:551-585): the top/bottom rows copy rows 1 / NY-2
    first, then the left/right columns copy columns 1 / NX-2, corners
    included."""
    Ex, Ey = efield_periodic(phi)

    def close(E):
        E = E.clone()
        E[0, :] = E[1, :]
        E[-1, :] = E[-2, :]
        E[:, 0] = E[:, 1]
        E[:, -1] = E[:, -2]
        return E

    return close(Ex), close(Ey)
