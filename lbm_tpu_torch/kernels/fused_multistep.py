"""collide_stream_multistep: K whole plasma steps in one kernel launch
(counterpart of lbm_tpu/kernels/fused_multistep.py:collide_stream_multistep).

Modes, as the JAX kernel's:
  * constant E: the NONE solver under either wall type, and FFT under
    bounce-back (the reference's no-op solve, src/poisson.cpp:76-77). Step
    1 collides with the given E; with kill_field (the NONE quirk,
    src/poisson.cpp:34-43) every later step collides with 0. Returns
    (f, g); the caller handles the state's E.
  * solve_fft: FFT + periodic, the golden configuration. Every step solves
    its own rho_q with the half-spectrum DFT chain of dft_solve_mats and
    takes E by periodic central differences. Returns (f, g, Ex, Ey, phi),
    the last step's field and potential.
  * solve_iter=(kind, omega, max_iter, tol, interior_only, neumann): the
    GS/SOR ("gs") or NPS ("nps") sweeps, warm-started from phi and carried
    through the window, then the Neumann or periodic E closure. Returns the
    same 5-tuple.
bounce=True streams with the bounce-back walls, the corner holes' stale
values included (ops/stream.py).

On CUDA tensors the wrapper checks its inputs and launches
csrc/fused_multistep.cu into fresh output buffers, or raises: the DFT runs
inside that kernel, never in cuBLAS or cuFFT. On CPU tensors it runs
the plain version, collide_stream_multistep_reference, which the tests hold
against the JAX package and which chip_smoke.py holds against the kernel.
LAUNCHES counts the launches.

bf16 storage decodes to f32 once, marches K steps in f32 and rounds once at
the end, with the bf16 thermal forms and an exact reciprocal (the TPU
kernel's approximate one is not copied). The TPU kernel needs the whole
state in VMEM (<= ~256^2 f64, ~304^2 f32/bf16) and a banded wrapper past
that; this one keeps the state in device memory and takes any grid that
fits the card.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from ..constants import D2Q9
from ..ops import poisson
from ..ops.collide import collide
from ..ops.macros import update_macro
from ..ops.stream import (HOLE_SLOTS, bounceback_from_periodic, hole_values,
                          stream_bounceback, stream_periodic)
from . import build, fused_step, poisson_iter
from .fused_cavity import compute_dtype

LAUNCHES = 0
_NAME = "collide_stream_multistep"

# (kind, omega, max_iter, tol, interior_only, neumann)
IterSpec = Tuple[str, Optional[float], int, float, bool, bool]

_VP, _CI, _CD = ctypes.c_void_p, ctypes.c_int, ctypes.c_double


class MultistepHost(ctypes.Structure):
    """Mirror of struct MultistepHost in csrc/fused_multistep.cu."""

    _fields_ = [
        ("f_in", _VP), ("g_in", _VP), ("f_out", _VP), ("g_out", _VP),
        ("work_f", _VP * 2), ("work_g", _VP * 2),
        ("Ex_in", _VP), ("Ey_in", _VP), ("Ex_out", _VP), ("Ey_out", _VP),
        ("phi", _VP), ("rho_q", _VP), ("phi_in", _VP), ("scratch", _VP),
        ("err_ring", _VP), ("mats", _VP * 7), ("dft", _VP * 4),
        ("NY", _CI), ("NX", _CI), ("Hp", _CI), ("K", _CI),
        ("bounce", _CI), ("kill", _CI), ("iter_kind", _CI),
        ("interior", _CI), ("neumann", _CI), ("max_iter", _CI),
        ("tol", _CD), ("omega", _CD),
    ]


def pad_half(NX: int) -> int:
    """The half-spectrum width NX//2+1 padded up to a multiple of 128 (the
    pad columns are exact zeros through the whole chain)."""
    H = NX // 2 + 1
    return ((H + 127) // 128) * 128


@functools.lru_cache(maxsize=8)
def dft_solve_mats(NY: int, NX: int):
    """float64 numpy matrices of the half-spectrum Poisson solve
    (lbm_tpu/kernels/fused_multistep.py:_dft_solve_mats), H = NX//2+1
    padded to Hp = pad_half(NX):
      forward x (real input):        A = rho @ cxh, B = rho @ sxh
      forward y:                     R = (cy - i sy) @ (A - i B)
      eigenvalue, k=(0,0) zeroed, 1/(NY NX) folded in:   P = R * invh
      inverse y:                     U + i V = (cy + i sy) @ P
      inverse x (real output):       phi = U @ gcx - V @ gsx
    with gcx[k, x] = a_k cos(2 pi k x / NX), gsx likewise with sin, a_0 = 1,
    a_k = 2 inside, a_{NX/2} = 1 for even NX. Returns (cy, sy, cxh, sxh,
    invh, gcx, gsx)."""
    H = NX // 2 + 1
    Hp = pad_half(NX)
    jy = np.arange(NY, dtype=np.float64)
    cy = np.cos(2.0 * np.pi * np.outer(jy, jy) / NY)
    sy = np.sin(2.0 * np.pi * np.outer(jy, jy) / NY)
    x = np.arange(NX, dtype=np.float64)
    k = np.arange(H, dtype=np.float64)
    ang = 2.0 * np.pi * np.outer(x, k) / NX            # (NX, H)
    cxh = np.zeros((NX, Hp))
    sxh = np.zeros((NX, Hp))
    cxh[:, :H] = np.cos(ang)
    sxh[:, :H] = np.sin(ang)
    ky = np.arange(NY, dtype=np.float64)
    siny2 = np.sin(np.pi * ky / NY) ** 2
    sinx2 = np.sin(np.pi * k / NX) ** 2
    denom = 4.0 * (siny2[:, None] + sinx2[None, :])    # (NY, H)
    inv = np.where(denom > 1e-15, 1.0 / np.maximum(denom, 1e-300), 0.0)
    invh = np.zeros((NY, Hp))
    invh[:, :H] = inv / (NY * NX)
    alpha = np.full(H, 2.0)
    alpha[0] = 1.0
    if NX % 2 == 0:
        alpha[H - 1] = 1.0
    angk = 2.0 * np.pi * np.outer(np.arange(H), x) / NX  # (H, NX)
    gcx = np.zeros((Hp, NX))
    gsx = np.zeros((Hp, NX))
    gcx[:H] = alpha[:, None] * np.cos(angk)
    gsx[:H] = alpha[:, None] * np.sin(angk)
    return cy, sy, cxh, sxh, invh, gcx, gsx


@functools.lru_cache(maxsize=8)
def _device_mats(NY: int, NX: int, dtype: torch.dtype, device: torch.device):
    """dft_solve_mats cast once to the compute dtype on the device (cached:
    a run calls every window with the same grid)."""
    return tuple(torch.as_tensor(m, dtype=dtype, device=device).contiguous()
                 for m in dft_solve_mats(NY, NX))


def solve_field_dft(rho_q: torch.Tensor, mats) -> torch.Tensor:
    """phi of rho_q through the DFT chain of dft_solve_mats (mats in
    rho_q's dtype and on its device), every product summed over its inner
    index in order, one rounding per multiply and per add, as the kernel
    sums it. torch.matmul would sum in another order, and in f32 the golden
    plasma grows such a last-bit difference of E into a drift of f and g
    far above rounding within a 17-step window, so the kernel could not be
    held to it."""
    cy, sy, cxh, sxh, invh, gcx, gsx = mats
    H = rho_q.shape[1] // 2 + 1   # the pad columns are zeros throughout

    def mm(a, b):
        acc = torch.zeros((a.shape[0], b.shape[1]), dtype=a.dtype,
                          device=a.device)
        for j in range(a.shape[1]):
            acc = acc + a[:, j:j + 1] * b[j:j + 1, :]
        return acc

    A = mm(rho_q, cxh[:, :H])
    B = mm(rho_q, sxh[:, :H])
    Pr = (mm(cy, A) - mm(sy, B)) * invh[:, :H]
    Pi = (-(mm(cy, B) + mm(sy, A))) * invh[:, :H]
    U = mm(cy, Pr) - mm(sy, Pi)
    V = mm(sy, Pr) + mm(cy, Pi)
    return mm(U, gcx[:H]) - mm(V, gsx[:H])


def _check_modes(f, phi, k_steps, bounce, solve_fft, solve_iter) -> None:
    """The combinations the JAX wrapper refuses (its l.557-572), without
    its VMEM limit."""
    if solve_fft and bounce:
        raise ValueError("solve_fft is the FFT+periodic mode; FFT under "
                         "bounce-back is the no-op solve (bounce=True, "
                         "solve_fft=False)")
    if solve_fft and solve_iter:
        raise ValueError("solve_fft and solve_iter are exclusive")
    if solve_iter is not None and phi is None:
        raise ValueError("solve_iter needs the warm-start phi")
    if k_steps < 1:
        raise ValueError("k_steps must be >= 1")
    if f.dim() != 4 or tuple(f.shape[:2]) != (3, D2Q9.Q):
        raise ValueError(f"{_NAME}: f has shape {tuple(f.shape)}, want "
                         f"(3, 9, NY, NX)")


def _g_holes(f_post: torch.Tensor, neutral_ref: float) -> list:
    """The g pass's 8 stale corner values: post-collision f, plus the
    neutral's background neutral_ref * w_i under delta storage
    (models/plasma._g_holes_with_background), in the compute dtype."""
    vals = hole_values(f_post)
    if neutral_ref != 0.0:
        for v, (i, _, _) in zip(vals, HOLE_SLOTS):
            v[..., 2] = v[..., 2] + neutral_ref * float(D2Q9.W[i])
    return vals


def collide_stream_multistep_reference(
    f: torch.Tensor, g: torch.Tensor, Ex: torch.Tensor, Ey: torch.Tensor,
    phi: Optional[torch.Tensor] = None, *,
    taus, q_e: float, q_i: float, m_e: float, m_i: float,
    cs2: float, kb: float, neutral_ref: float = 0.0,
    k_steps: int, kill_field: bool = True, bounce: bool = False,
    solve_fft: bool = False, solve_iter: Optional[IterSpec] = None,
):
    """Plain version: k_steps of update_macro -> collide -> stream in the
    compute dtype, decoded once and rounded to the storage dtype once."""
    _check_modes(f, phi, k_steps, bounce, solve_fft, solve_iter)
    cdt = compute_dtype(f)
    NY, NX = f.shape[-2:]
    recip = (lambda x: 1.0 / x) if f.dtype == torch.bfloat16 else None
    ff, gg = f.to(cdt), g.to(cdt)
    Ex, Ey = Ex.to(cdt), Ey.to(cdt)
    if solve_fft:
        mats = _device_mats(NY, NX, cdt, f.device)
        phi = torch.zeros_like(Ex)
    elif solve_iter is not None:
        phi = phi.to(cdt)
    for k in range(k_steps):
        mac = update_macro(ff, gg, Ex, Ey, q_e=q_e, q_i=q_i, m_e=m_e,
                           m_i=m_i, neutral_ref=neutral_ref)
        f_post, g_post = collide(ff, gg, mac, Ex, Ey, taus=taus, q_e=q_e,
                                 q_i=q_i, m_e=m_e, m_i=m_i, cs2=cs2, kb=kb,
                                 neutral_ref=neutral_ref, g_recip=recip)
        if bounce:
            # the reference's recycled temp buffers: pre-collision f in the
            # f pass's corner holes, post-collision f in the g pass's
            f_new = stream_bounceback(f_post, stale=ff)
            g_new = bounceback_from_periodic(stream_periodic(g_post),
                                             _g_holes(f_post, neutral_ref))
        else:
            f_new, g_new = stream_periodic(f_post), stream_periodic(g_post)
        if solve_fft:
            phi = solve_field_dft(mac.rho_q, mats)
            Ex, Ey = poisson.efield_periodic(phi)
        elif solve_iter is not None:
            phi = poisson_iter.solve_iter_reference(phi, mac.rho_q,
                                                    spec=solve_iter[:5])
            Ex, Ey = (poisson.efield_neumann(phi) if solve_iter[5]
                      else poisson.efield_periodic(phi))
        elif kill_field and k == 0:
            Ex, Ey = torch.zeros_like(Ex), torch.zeros_like(Ey)
        ff, gg = f_new, g_new
    f_out, g_out = ff.to(f.dtype), gg.to(g.dtype)
    if solve_fft or solve_iter is not None:
        return f_out, g_out, Ex, Ey, phi
    return f_out, g_out


def _launch(f, g, Ex, Ey, phi, phys, k_steps, kill_field, bounce, solve_fft,
            solve_iter):
    cdt = compute_dtype(f)
    Ex, Ey = Ex.to(cdt), Ey.to(cdt)
    mode = fused_step._check_inputs(_NAME, fused_step._MODES, f, g, Ex, Ey)
    NY, NX = Ex.shape
    neumann = bool(solve_iter[5]) if solve_iter is not None else False
    if (bounce or neumann) and min(NY, NX) < 3:
        raise ValueError(f"{_NAME}: walls need a grid of at least 3x3, got "
                         f"{NY}x{NX}")
    if NY * NX > 2**31 - 1:
        raise ValueError(f"{_NAME}: {NY}x{NX} exceeds 2^31 sites")
    lib = build.load()
    if lib.lbm_multistep_host_size() != ctypes.sizeof(MultistepHost):
        raise RuntimeError("MultistepHost layout differs between "
                           "csrc/fused_multistep.cu and its ctypes mirror")
    dev = f.device

    def plane():
        return torch.empty((NY, NX), dtype=cdt, device=dev)

    h = MultistepHost(NY=NY, NX=NX, Hp=pad_half(NX), K=int(k_steps),
                      bounce=int(bool(bounce)), kill=int(bool(kill_field)))
    f_out, g_out = torch.empty_like(f), torch.empty_like(g)
    # bf16 storage decodes into, and encodes from, the work buffers
    n_work = 2 if cdt != f.dtype else min(int(k_steps) - 1, 2)
    work = [torch.empty(f.shape, dtype=cdt, device=dev)
            for _ in range(2 * n_work)]
    for b in range(n_work):
        h.work_f[b] = work[2 * b].data_ptr()
        h.work_g[b] = work[2 * b + 1].data_ptr()
    h.f_in, h.g_in = f.data_ptr(), g.data_ptr()
    h.f_out, h.g_out = f_out.data_ptr(), g_out.data_ptr()
    h.Ex_in, h.Ey_in = Ex.data_ptr(), Ey.data_ptr()
    # every buffer the kernel uses is a local, alive until it is enqueued
    solve_kind, out = 0, (f_out, g_out)
    if solve_fft or solve_iter is not None:
        Ex_out, Ey_out, phi_out, rho_q = plane(), plane(), plane(), plane()
        h.Ex_out, h.Ey_out = Ex_out.data_ptr(), Ey_out.data_ptr()
        h.phi, h.rho_q = phi_out.data_ptr(), rho_q.data_ptr()
        out = (f_out, g_out, Ex_out, Ey_out, phi_out)
    if solve_fft:
        solve_kind = 1
        for m, t in enumerate(_device_mats(NY, NX, cdt, dev)):
            h.mats[m] = t.data_ptr()
        dft = [torch.empty((NY, NX // 2 + 1), dtype=cdt, device=dev)
               for _ in range(4)]
        for m, t in enumerate(dft):
            h.dft[m] = t.data_ptr()
    elif solve_iter is not None:
        solve_kind = 2
        kind, omega, max_iter, tol, interior_only, _ = solve_iter
        phi_in = phi.to(cdt).contiguous()
        if phi_in.device != dev or phi_in.shape != (NY, NX):
            raise ValueError(f"{_NAME}: phi must be an (NY, NX) tensor on "
                             f"{dev}, got {tuple(phi.shape)} on {phi.device}")
        scratch = plane()
        err_ring = torch.empty(3, dtype=torch.int64, device=dev)
        h.phi_in, h.scratch = phi_in.data_ptr(), scratch.data_ptr()
        h.err_ring = err_ring.data_ptr()
        h.iter_kind = poisson_iter._kind_code(kind, omega)
        h.interior, h.neumann = int(bool(interior_only)), int(neumann)
        h.max_iter, h.tol = int(max_iter), float(tol)
        h.omega = 0.0 if omega is None else float(omega)
    hp = fused_step.host_params(**phys)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.lbm_plasma_multistep(
            mode, int(phys["neutral_ref"] != 0.0), solve_kind,
            ctypes.addressof(h), ctypes.addressof(hp), stream)
    if err != 0:
        raise RuntimeError(f"{_NAME} kernel launch failed: cudaError_t {err}")
    return out


def collide_stream_multistep(
    f: torch.Tensor,    # (3, Q, NY, NX)
    g: torch.Tensor,
    Ex: torch.Tensor,   # (NY, NX): constant across the window, or the
    Ey: torch.Tensor,   # window's starting field in a solve mode
    phi: Optional[torch.Tensor] = None,   # (NY, NX) warm start, solve_iter
    *,
    taus, q_e: float, q_i: float, m_e: float, m_i: float,
    cs2: float, kb: float, neutral_ref: float = 0.0,
    k_steps: int, kill_field: bool = True, bounce: bool = False,
    solve_fft: bool = False, solve_iter: Optional[IterSpec] = None,
):
    """k_steps full plasma steps in one launch; returns (f, g), or
    (f, g, Ex, Ey, phi) in a solve mode."""
    global LAUNCHES
    _check_modes(f, phi, k_steps, bounce, solve_fft, solve_iter)
    phys = dict(taus=tuple(taus), q_e=q_e, q_i=q_i, m_e=m_e, m_i=m_i,
                cs2=cs2, kb=kb, neutral_ref=neutral_ref)
    mode = dict(k_steps=int(k_steps), kill_field=kill_field, bounce=bounce,
                solve_fft=solve_fft, solve_iter=solve_iter)
    if f.device.type == "cpu":
        return collide_stream_multistep_reference(f, g, Ex, Ey, phi, **phys,
                                                  **mode)
    out = _launch(f, g, Ex, Ey, phi, phys, **mode)
    LAUNCHES += 1
    return out
