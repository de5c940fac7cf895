"""solve_iter: the warm-started iterative Poisson solve (red-black GS, SOR
or the 4-colour 9-point NPS) in one kernel launch (counterpart of
lbm_tpu/kernels/poisson_iter.py:solve_iter_tpu).

On CUDA tensors the wrapper launches csrc/poisson_iter.cu, or raises; the
sweep loop and its stop test run on the device, with no host round trip
between sweeps. On CPU tensors it runs the plain sweeps of ops/poisson.py
(solve_gs / solve_9point), which the kernel equals bit for bit. LAUNCHES
counts kernel launches; LAST_SWEEPS holds the sweep count of the last
solve, after a launch as a 0-dim int32 tensor on the device (reading it
waits for the kernel).

Unlike the TPU kernel, which needs f32 and a grid that fits VMEM
(<= 1024^2), this one takes f32 and f64 at any size that fits the card.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from ..ops import poisson
from . import build

LAUNCHES = 0
LAST_SWEEPS: Union[int, torch.Tensor] = 0

_DTYPES = {torch.float64: 0, torch.float32: 1}

# spec = (kind, omega, max_iter, tol, interior_only): kind "gs" is GS, or
# SOR with an omega; "nps" the 9-point stencil (lbm_tpu's spec minus its
# trailing neumann element)
Spec = Tuple[str, Optional[float], int, float, bool]


def _kind_code(kind: str, omega: Optional[float]) -> int:
    if kind == "gs":
        return 0 if omega is None else 1
    if kind == "nps" and omega is None:
        return 2
    raise ValueError(f"solve_iter: unknown solver kind={kind!r} "
                     f"omega={omega!r}; want 'gs' (omega for SOR) or 'nps'")


def solve_iter_reference(phi0: torch.Tensor, rho_q: torch.Tensor, *,
                         spec: Spec) -> torch.Tensor:
    """Plain version: the sweeps of ops/poisson.py."""
    kind, omega, max_iter, tol, interior_only = spec
    _kind_code(kind, omega)
    kw = dict(periodic=not interior_only, max_iter=max_iter, tol=tol)
    if kind == "gs":
        return poisson.solve_gs(phi0, rho_q, omega=omega, **kw)
    return poisson.solve_9point(phi0, rho_q, **kw)


def solve_iter(phi0: torch.Tensor, rho_q: torch.Tensor, *,
               spec: Spec) -> torch.Tensor:
    """One warm-started solve of nabla^2 phi = -rho_q; returns phi. rho_q
    is cast to phi0's dtype, as the TPU kernel does."""
    global LAUNCHES, LAST_SWEEPS
    kind, omega, max_iter, tol, interior_only = spec
    code = _kind_code(kind, omega)
    rho_q = rho_q.to(phi0.dtype)
    if phi0.device.type == "cpu":
        phi = solve_iter_reference(phi0, rho_q, spec=spec)
        LAST_SWEEPS = poisson.LAST_SWEEPS
        return phi
    if phi0.device.type != "cuda" or rho_q.device != phi0.device:
        raise ValueError(f"solve_iter: phi0 and rho_q must lie on one CUDA "
                         f"device (or both on the CPU), got {phi0.device} "
                         f"and {rho_q.device}")
    if phi0.dtype not in _DTYPES:
        raise TypeError(f"solve_iter: the kernel takes float32 or float64, "
                        f"got {phi0.dtype}")
    if phi0.dim() != 2 or rho_q.shape != phi0.shape:
        raise ValueError(f"solve_iter: shapes phi0={tuple(phi0.shape)} "
                         f"rho_q={tuple(rho_q.shape)}; want two (NY, NX)")
    phi0, rho_q = phi0.contiguous(), rho_q.contiguous()
    lib = build.load()
    NY, NX = phi0.shape
    out = torch.empty_like(phi0)
    scratch = torch.empty_like(phi0)
    err_ring = torch.empty(3, dtype=torch.int64, device=phi0.device)
    sweeps = torch.empty((), dtype=torch.int32, device=phi0.device)
    stream = torch.cuda.current_stream(phi0.device).cuda_stream
    with torch.cuda.device(phi0.device):
        err = lib.lbm_solve_iter(
            _DTYPES[phi0.dtype], code, int(bool(interior_only)),
            0.0 if omega is None else float(omega), int(max_iter), float(tol),
            phi0.data_ptr(), rho_q.data_ptr(), scratch.data_ptr(),
            out.data_ptr(), err_ring.data_ptr(), sweeps.data_ptr(), NY, NX,
            stream)
    if err != 0:
        raise RuntimeError(f"solve_iter kernel launch failed: "
                           f"cudaError_t {err}")
    LAUNCHES += 1
    LAST_SWEEPS = sweeps
    return out
