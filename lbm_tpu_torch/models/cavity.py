"""Single-population D2Q9 lid-driven cavity, the Ghia-validation workload
(counterpart of lbm_tpu/models/cavity.py).

Replicates the classic solver (reference: old codes/LBM_classic/LBM.cpp):
collide -> stream -> macros, pull streaming, three bounce-back walls, the
moving lid with the ramp u_lid_dyn = u_lid * t / sigma for t < sigma, and
the rho < 1e-10 macro guard. The state carries (f, rho, ux, uy) like the
reference: the macros are updated after streaming and consumed by the next
step's collision. The step counter is a host int, so the lid speed is known
on the host and no step waits for the device.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..config import CavityConfig
from ..constants import D2Q9
from ..kernels import fused_cavity
from ..ops.cavity import (collide_dirs, decode, encode, lid_speed,
                          macros_guarded)
from ..ops.stream import stream_cavity

Q = D2Q9.Q


class CavityState(NamedTuple):
    f: torch.Tensor    # (Q, NY, NX), cfg.dtype or bf16 deltas
    rho: torch.Tensor  # (NY, NX), compute dtype
    ux: torch.Tensor   # (NY, NX)
    uy: torch.Tensor   # (NY, NX)
    step: int


def decode_f(cfg: CavityConfig, f: torch.Tensor) -> torch.Tensor:
    """Full populations in the compute dtype (bf16 storage holds f as
    deviations from the uniform background w_i; f's dtype tells)."""
    return decode(f)


def encode_f(cfg: CavityConfig, f_full: torch.Tensor) -> torch.Tensor:
    """Storage representation of full populations."""
    return encode(f_full, torch.bfloat16) if cfg.storage == "bf16" else f_full


def _check_supported(cfg: CavityConfig) -> None:
    if cfg.dtype not in (torch.float32, torch.float64):
        raise NotImplementedError(f"lbm_tpu_torch computes the cavity in "
                                  f"float32 or float64, not {cfg.dtype}")


def init_state(cfg: CavityConfig, device) -> CavityState:
    """rho = 1, u = 0, f = f_eq = w (old codes/LBM_classic/LBM.cpp:26-41),
    built on `device`. In bf16 storage f holds deviations from w, exactly
    zero here."""
    _check_supported(cfg)
    NY, NX, dtype = cfg.NY, cfg.NX, cfg.dtype
    if cfg.storage == "bf16":
        f = torch.zeros((Q, NY, NX), dtype=torch.bfloat16, device=device)
    else:
        w = torch.tensor(D2Q9.W, dtype=dtype, device=device)
        f = w[:, None, None].expand(Q, NY, NX).contiguous()
    return CavityState(
        f=f,
        rho=torch.ones((NY, NX), dtype=dtype, device=device),
        ux=torch.zeros((NY, NX), dtype=dtype, device=device),
        uy=torch.zeros((NY, NX), dtype=dtype, device=device),
        step=0)


def macros_of(cfg: CavityConfig, f: torch.Tensor):
    """(rho, ux, uy) recomputed from stored populations: what the state's
    macro fields always equal (the lean modes materialize them so)."""
    ff = decode_f(cfg, f)
    return macros_guarded([ff[i] for i in range(Q)])


def _lid_speed(cfg: CavityConfig, step: int) -> float:
    """u_lid * t / sigma ramp for t < sigma (LBM.cpp:180), in cfg.dtype."""
    return lid_speed(step, u_lid=cfg.u_lid, sigma=cfg.sigma, dtype=cfg.dtype)


def make_step(cfg: CavityConfig) -> Callable[[CavityState], CavityState]:
    """One cavity step: collide -> pull-stream + walls -> guarded macros.

    backend "plain" runs eager torch ops; "fused" runs the stored-macro
    kernel, the lean kernel (lean_macros, then macros_of) or the multistep
    kernel with k=1 (multistep > 0). On CPU tensors the kernels' plain
    versions run.
    """
    _check_supported(cfg)
    tau = cfg.tau

    if cfg.backend == "fused":
        if cfg.multistep:
            def step_ms(state: CavityState) -> CavityState:
                f = fused_cavity.collide_stream_cavity_multistep(
                    state.f, state.step, tau=tau, k_steps=1, u_lid=cfg.u_lid,
                    sigma=cfg.sigma)
                rho, ux, uy = macros_of(cfg, f)
                return CavityState(f, rho, ux, uy, state.step + 1)

            return step_ms

        if cfg.lean_macros:
            def step_lean(state: CavityState) -> CavityState:
                f = fused_cavity.collide_stream_cavity_lean(
                    state.f, _lid_speed(cfg, state.step), tau=tau)
                rho, ux, uy = macros_of(cfg, f)
                return CavityState(f, rho, ux, uy, state.step + 1)

            return step_lean

        def step_fused(state: CavityState) -> CavityState:
            f, rho, ux, uy = fused_cavity.collide_stream_cavity(
                state.f, state.rho, state.ux, state.uy,
                _lid_speed(cfg, state.step), tau=tau)
            return CavityState(f, rho, ux, uy, state.step + 1)

        return step_fused

    def step(state: CavityState) -> CavityState:
        # collide against the equilibrium of the *current* macros
        ff = decode_f(cfg, state.f)
        f_dirs = collide_dirs([ff[i] for i in range(Q)],
                              state.rho, state.ux, state.uy, tau)
        # pull streaming + walls + moving lid
        f = stream_cavity(torch.stack(f_dirs), _lid_speed(cfg, state.step))
        # macros with the rho < 1e-10 guard (LBM.cpp:74-88)
        rho, ux, uy = macros_guarded([f[i] for i in range(Q)])
        return CavityState(encode_f(cfg, f), rho, ux, uy, state.step + 1)

    return step


def make_rollout(cfg: CavityConfig, n: Optional[int] = None
                 ) -> Callable[[CavityState], CavityState]:
    """n steps (cfg.nsteps by default). Multistep: floor(n / K) windows of
    K steps and one remainder window, the macros computed once at the end;
    lean: only f is carried, the macros computed once at the end;
    otherwise a loop of make_step."""
    n_steps = cfg.nsteps if n is None else n
    tau = cfg.tau

    if cfg.backend == "fused" and cfg.multistep:
        K = min(int(cfg.multistep), max(n_steps, 1))
        full, rem = divmod(n_steps, K)

        def rollout_ms(state: CavityState) -> CavityState:
            f, t = state.f, state.step
            for k in [K] * full + ([rem] if rem else []):
                f = fused_cavity.collide_stream_cavity_multistep(
                    f, t, tau=tau, k_steps=k, u_lid=cfg.u_lid,
                    sigma=cfg.sigma)
                t += k
            rho, ux, uy = macros_of(cfg, f)
            return CavityState(f, rho, ux, uy, t)

        return rollout_ms

    if cfg.backend == "fused" and cfg.lean_macros:
        def rollout_lean(state: CavityState) -> CavityState:
            f, t = state.f, state.step
            for _ in range(n_steps):
                f = fused_cavity.collide_stream_cavity_lean(
                    f, _lid_speed(cfg, t), tau=tau)
                t += 1
            rho, ux, uy = macros_of(cfg, f)
            return CavityState(f, rho, ux, uy, t)

        return rollout_lean

    step = make_step(cfg)

    def rollout(state: CavityState) -> CavityState:
        for _ in range(n_steps):
            state = step(state)
        return state

    return rollout


# ---------------------------------------------------------------------------
# Ghia, Ghia & Shin (1982) reference data, Re=100, 129x129 grid.
# Table I (u through vertical centerline) and Table II (v through horizontal
# centerline). Public benchmark values (y/x in cavity units, lid at y=1).
# ---------------------------------------------------------------------------

GHIA_Y = np.array([
    0.0000, 0.0547, 0.0625, 0.0703, 0.1016, 0.1719, 0.2813, 0.4531,
    0.5000, 0.6172, 0.7344, 0.8516, 0.9531, 0.9609, 0.9688, 0.9766, 1.0000,
])
GHIA_U_RE100 = np.array([
    0.00000, -0.03717, -0.04192, -0.04775, -0.06434, -0.10150, -0.15662,
    -0.21090, -0.20581, -0.13641, 0.00332, 0.23151, 0.68717, 0.73722,
    0.78871, 0.84123, 1.00000,
])
GHIA_X = np.array([
    0.0000, 0.0625, 0.0703, 0.0781, 0.0938, 0.1563, 0.2266, 0.2344,
    0.5000, 0.8047, 0.8594, 0.9063, 0.9453, 0.9531, 0.9609, 0.9688, 1.0000,
])
GHIA_V_RE100 = np.array([
    0.00000, 0.09233, 0.10091, 0.10890, 0.12317, 0.16077, 0.17507, 0.17527,
    0.05454, -0.24533, -0.22445, -0.16914, -0.10313, -0.08864, -0.07391,
    -0.05906, 0.00000,
])


def centerline_profiles(state: CavityState, u_lid: float):
    """(y, u/u_lid at x-center), (x, v/u_lid at y-center) for Ghia comparison."""
    NY, NX = state.ux.shape
    xc, yc = NX // 2, NY // 2
    y = np.arange(NY) / (NY - 1)
    x = np.arange(NX) / (NX - 1)
    u_prof = state.ux[:, xc].double().cpu().numpy() / u_lid
    v_prof = state.uy[yc, :].double().cpu().numpy() / u_lid
    return (y, u_prof), (x, v_prof)


def ghia_errors(state: CavityState, u_lid: float) -> dict:
    """|profile - Ghia| at the Ghia stations (profiles interpolated
    linearly): max and rms for u and v. Meaningful at Re = 100."""
    (yp, up), (xp, vp) = centerline_profiles(state, u_lid)
    eu = np.abs(np.interp(GHIA_Y, yp, up) - GHIA_U_RE100)
    ev = np.abs(np.interp(GHIA_X, xp, vp) - GHIA_V_RE100)
    return dict(u_max=float(eu.max()), u_rms=float(np.sqrt((eu ** 2).mean())),
                v_max=float(ev.max()), v_rms=float(np.sqrt((ev ** 2).mean())))
