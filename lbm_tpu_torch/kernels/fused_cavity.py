"""The cavity step kernels (counterpart of lbm_tpu/kernels/fused_cavity.py):

  collide_stream_cavity            collide (stored macros) + pull stream +
                                   walls + lid + guarded macros;
  collide_stream_cavity_lean       the same with the macros recomputed from
                                   f, populations only in and out;
  collide_stream_cavity_multistep  K lean steps in one launch, the lid ramp
                                   evaluated from step0 in the kernel.

On CUDA tensors each wrapper checks its inputs and launches its entry of
csrc/fused_cavity.cu into fresh output buffers, or raises; on CPU tensors it
runs its plain version (the *_reference functions: ops/cavity collide,
ops/stream.stream_cavity, macros_guarded in eager torch), which the kernels
equal bit for bit. LAUNCHES counts each kernel's launches by the name of
its TPU counterpart.

Unlike the TPU kernels, which alias their outputs onto their inputs and
need NY % 8 == 0 (banded) or a grid that fits VMEM (multistep), these take
any grid that fits the card.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..ops.cavity import (Q, collide_dirs, decode, encode, lid_speed,
                          macros_guarded)
from ..ops.stream import stream_cavity
from . import build

LAUNCHES = {"collide_stream_cavity": 0, "collide_stream_cavity_lean": 0,
            "collide_stream_cavity_multistep": 0}

# (storage dtype, compute dtype) -> the C interface's mode
_MODES = {
    (torch.float64, torch.float64): 0,
    (torch.float32, torch.float32): 1,
    (torch.bfloat16, torch.float32): 2,
}


def compute_dtype(f: torch.Tensor) -> torch.dtype:
    """The arithmetic dtype of populations stored as f (f32 for bf16)."""
    return torch.float32 if f.dtype == torch.bfloat16 else f.dtype


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def collide_stream_cavity_reference(
        f: torch.Tensor, rho: torch.Tensor, ux: torch.Tensor,
        uy: torch.Tensor, u_lid_dyn: float, *, tau: float
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Collide against the stored macros, stream_cavity, then the guarded
    macros of the new full populations (before the bf16 rounding)."""
    ff = decode(f)
    post = collide_dirs([ff[i] for i in range(Q)], rho, ux, uy, tau)
    fn = stream_cavity(torch.stack(post), u_lid_dyn)
    rho, ux, uy = macros_guarded([fn[i] for i in range(Q)])
    return encode(fn, f.dtype), rho, ux, uy


def _lean_step(ff: torch.Tensor, u_lid_dyn: float, tau: float
               ) -> torch.Tensor:
    dirs = [ff[i] for i in range(Q)]
    rho, ux, uy = macros_guarded(dirs)
    return stream_cavity(torch.stack(collide_dirs(dirs, rho, ux, uy, tau)),
                         u_lid_dyn)


def collide_stream_cavity_lean_reference(f: torch.Tensor, u_lid_dyn: float,
                                         *, tau: float) -> torch.Tensor:
    """One lean step: macros from f, collide, stream_cavity."""
    return encode(_lean_step(decode(f), u_lid_dyn, tau), f.dtype)


def collide_stream_cavity_multistep_reference(
        f: torch.Tensor, step0: int, *, tau: float, k_steps: int,
        u_lid: float, sigma: float) -> torch.Tensor:
    """k_steps lean steps in the compute dtype from trajectory step step0,
    decoded once and rounded to the storage dtype once, at the end."""
    ff = decode(f)
    for k in range(k_steps):
        u = lid_speed(step0 + k, u_lid=u_lid, sigma=sigma, dtype=ff.dtype)
        ff = _lean_step(ff, u, tau)
    return encode(ff, f.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check(name: str, f: torch.Tensor, *fields: torch.Tensor) -> int:
    """Validate what the kernel takes; returns its mode."""
    tensors = (f, *fields)
    devices = {t.device for t in tensors}
    if len(devices) != 1 or f.device.type != "cuda":
        raise ValueError(f"{name}: the tensors must lie on one CUDA device "
                         f"(or all on the CPU), got "
                         f"{sorted(map(str, devices))}")
    mode = _MODES.get((f.dtype, compute_dtype(f)))
    if mode is None or any(t.dtype != compute_dtype(f) for t in fields):
        raise TypeError(f"{name}: unsupported dtypes f={f.dtype} fields="
                        f"{[str(t.dtype) for t in fields]}; the kernel "
                        f"takes (storage, compute) dtypes "
                        f"{sorted(map(str, _MODES))}")
    if f.dim() != 3 or f.shape[0] != Q or any(t.shape != f.shape[1:]
                                              for t in fields):
        raise ValueError(f"{name}: shapes f={tuple(f.shape)} fields="
                         f"{[tuple(t.shape) for t in fields]}; want "
                         f"(9, NY, NX) and (NY, NX)")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: inputs must be contiguous")
    return mode


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")


def collide_stream_cavity(
        f: torch.Tensor,      # (Q, NY, NX)
        rho: torch.Tensor,    # (NY, NX) stored macros, compute dtype
        ux: torch.Tensor,
        uy: torch.Tensor,
        u_lid_dyn: float,     # lid speed at this step (lid_speed)
        *, tau: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One cavity step; returns (f_new, rho, ux, uy)."""
    if f.device.type == "cpu":
        return collide_stream_cavity_reference(f, rho, ux, uy, u_lid_dyn,
                                               tau=tau)
    name = "collide_stream_cavity"
    mode = _check(name, f, rho, ux, uy)
    lib = build.load()
    NY, NX = rho.shape
    out = (torch.empty_like(f), torch.empty_like(rho), torch.empty_like(ux),
           torch.empty_like(uy))
    stream = torch.cuda.current_stream(f.device).cuda_stream
    with torch.cuda.device(f.device):
        err = lib.lbm_cavity_collide_stream(
            mode, f.data_ptr(), rho.data_ptr(), ux.data_ptr(), uy.data_ptr(),
            *(t.data_ptr() for t in out), float(u_lid_dyn), float(tau), NY,
            NX, stream)
    _raise_on(err, name)
    LAUNCHES[name] += 1
    return out


def collide_stream_cavity_lean(f: torch.Tensor, u_lid_dyn: float, *,
                               tau: float) -> torch.Tensor:
    """One cavity step, populations only; the macros on demand with
    ops.cavity.macros_guarded."""
    if f.device.type == "cpu":
        return collide_stream_cavity_lean_reference(f, u_lid_dyn, tau=tau)
    name = "collide_stream_cavity_lean"
    mode = _check(name, f)
    lib = build.load()
    _, NY, NX = f.shape
    f_out = torch.empty_like(f)
    stream = torch.cuda.current_stream(f.device).cuda_stream
    with torch.cuda.device(f.device):
        err = lib.lbm_cavity_collide_stream_lean(
            mode, f.data_ptr(), f_out.data_ptr(), float(u_lid_dyn),
            float(tau), NY, NX, stream)
    _raise_on(err, name)
    LAUNCHES[name] += 1
    return f_out


def collide_stream_cavity_multistep(
        f: torch.Tensor, step0: int, *, tau: float, k_steps: int,
        u_lid: float, sigma: float) -> torch.Tensor:
    """k_steps cavity steps in one launch (lean semantics), starting at
    trajectory step step0 (a host int)."""
    if k_steps < 1:
        raise ValueError("k_steps must be >= 1")
    if f.device.type == "cpu":
        return collide_stream_cavity_multistep_reference(
            f, step0, tau=tau, k_steps=k_steps, u_lid=u_lid, sigma=sigma)
    name = "collide_stream_cavity_multistep"
    mode = _check(name, f)
    lib = build.load()
    _, NY, NX = f.shape
    f_out = torch.empty_like(f)
    work = [torch.empty(f.shape, dtype=compute_dtype(f), device=f.device)
            for _ in range(min(k_steps - 1, 2))]
    ptrs = [w.data_ptr() for w in work] + [None] * (2 - len(work))
    stream = torch.cuda.current_stream(f.device).cuda_stream
    with torch.cuda.device(f.device):
        err = lib.lbm_cavity_multistep(
            mode, f.data_ptr(), *ptrs, f_out.data_ptr(), int(step0),
            int(k_steps), float(u_lid), float(sigma), float(tau), NY, NX,
            stream)
    _raise_on(err, name)
    LAUNCHES[name] += 1
    return f_out
