"""Three-population (e/i/n) D2Q9 plasma: state, init and the step
(counterpart of lbm_tpu/models/plasma.py).

The step replicates the reference's time loop (src/plasma.cpp:476-523):
macros -> equilibria -> collide -> stream -> Poisson solve -> E. The port
runs the periodic FFT configuration, the golden run's; check_supported
refuses the rest with the ROADMAP item that brings it.

State layout: populations f, g as (3, 9, NY, NX) tensors (species-major,
direction next, lattice minor), the JAX package's layout.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..config import BC, PlasmaConfig, PoissonSolver
from ..constants import D2Q9
from ..kernels.fused_step import collide_stream
from ..ops import poisson as poisson_ops
from ..ops.collide import collide
from ..ops.macros import Macros, update_macro
from ..ops.stream import stream_periodic

_NUMPY_DTYPES = {torch.float32: np.float32, torch.float64: np.float64}


class PlasmaState(NamedTuple):
    """Full simulation state (everything needed to resume)."""

    f: torch.Tensor    # (3, Q, NY, NX) mass populations (e, i, n)
    g: torch.Tensor    # (3, Q, NY, NX) thermal (DDF) populations
    Ex: torch.Tensor   # (NY, NX)
    Ey: torch.Tensor   # (NY, NX)
    phi: torch.Tensor  # (NY, NX) potential of the last solve
    step: int


def check_supported(cfg: PlasmaConfig) -> None:
    """Raise NotImplementedError for configurations the port cannot run
    yet, naming the ROADMAP item that will bring each."""
    gaps = []
    if cfg.NZ:
        gaps.append("NZ>0 (3-D column: ROADMAP Queue 1 item 12)")
    if cfg.bc != BC.PERIODIC:
        gaps.append("bounce-back BCs (ROADMAP Queue 1 item 8)")
    if cfg.poisson != PoissonSolver.FFT:
        gaps.append(f"the {cfg.poisson.name} solver (ROADMAP Queue 1 item 8)")
    if cfg.multistep:
        gaps.append("multistep>0 (temporal blocking: ROADMAP Queue 1 item 11)")
    if cfg.fft_engine == "pallas":
        gaps.append("fft_engine='pallas' (ROADMAP Queue 2 item 11)")
    if cfg.compat.debug_variant:
        gaps.append("debug_variant (ROADMAP Queue 1 item 9)")
    if cfg.backend == "pallas":
        gaps.append("backend='pallas' (ROADMAP Queue 2 item 2)")
    if cfg.dtype not in _NUMPY_DTYPES:
        gaps.append(f"dtype {cfg.dtype} (the port computes in float32 or "
                    f"float64)")
    if cfg.storage == "bf16" and cfg.dtype != torch.float32:
        gaps.append("bf16 storage with a compute dtype other than float32")
    if gaps:
        raise NotImplementedError(
            "lbm_tpu_torch does not run " + "; ".join(gaps) + " yet")


def init_state(cfg: PlasmaConfig, device) -> PlasmaState:
    """Initial condition (reference: src/plasma.cpp:131-158), built on
    `device`: electrons and ions seeded at w_i * rho_init inside the centre
    box x in (NX/4, 3NX/4), y in (NY/4, 3NY/4) (exclusive); neutrals fill
    the domain; E at the external field; phi zero."""
    check_supported(cfg)
    u = cfg.units()
    NX, NY, dtype = cfg.NX, cfg.NY, cfg.dtype
    iy = torch.arange(NY, device=device)[:, None]
    ix = torch.arange(NX, device=device)[None, :]
    box = ((iy >= NY // 4 + 1) & (iy < (3 * NY) // 4)
           & (ix >= NX // 4 + 1) & (ix < (3 * NX) // 4)).to(dtype)
    ones = torch.ones((NY, NX), dtype=dtype, device=device)
    # per-(species, direction) amplitudes in float64 on the host, cast once
    w = np.asarray(D2Q9.W)
    # delta mode: f[2] holds deviations from rho_n_init * w_i, which is
    # exactly the uniform neutral initial condition -> deltas are 0
    rho_n_amp = 0.0 if cfg.neutral_delta else u.rho_n_init
    np_dtype = _NUMPY_DTYPES[dtype]
    amp_f = np.stack([w * u.rho_e_init, w * u.rho_i_init,
                      w * rho_n_amp]).astype(np_dtype)
    amp_g = np.stack([w * u.T_e_init, w * u.T_i_init,
                      w * u.T_n_init]).astype(np_dtype)
    mask = torch.stack([box, box, ones])[:, None]          # (3, 1, NY, NX)
    f = torch.as_tensor(amp_f, device=device)[:, :, None, None] * mask
    g = torch.as_tensor(amp_g, device=device)[:, :, None, None] * mask
    if cfg.storage == "bf16":
        f = f.to(torch.bfloat16)
        g = g.to(torch.bfloat16)
    return PlasmaState(
        f=f.contiguous(), g=g.contiguous(),
        Ex=torch.full((NY, NX), u.Ex_ext, dtype=dtype, device=device),
        Ey=torch.full((NY, NX), u.Ey_ext, dtype=dtype, device=device),
        phi=torch.zeros((NY, NX), dtype=dtype, device=device),
        step=0,
    )


def compute_macros(cfg: PlasmaConfig, state: PlasmaState) -> Macros:
    """Macroscopic fields for observation (same op as the step)."""
    u = cfg.units()
    return update_macro(state.f.to(cfg.dtype), state.g.to(cfg.dtype),
                        state.Ex, state.Ey,
                        q_e=u.q_e, q_i=u.q_i, m_e=u.m_e, m_i=u.m_i,
                        neutral_ref=u.rho_n_init if cfg.neutral_delta else 0.0)


def make_step(cfg: PlasmaConfig) -> Callable[[PlasmaState], PlasmaState]:
    """The single-step function for this configuration (periodic BCs, FFT
    solve). backend="fused" runs collide+stream as one kernel call;
    backend="plain" runs the eager ops, rounding bf16 storage once per
    step at the final write."""
    check_supported(cfg)
    u = cfg.units()
    storage_bf16 = cfg.storage == "bf16"
    neutral_ref = u.rho_n_init if cfg.neutral_delta else 0.0
    phys = dict(taus=cfg.taus, q_e=u.q_e, q_i=u.q_i, m_e=u.m_e, m_i=u.m_i,
                cs2=u.cs2, kb=u.kb, neutral_ref=neutral_ref)

    def solve(rho_q):
        phi = poisson_ops.solve_fft(rho_q)
        Ex, Ey = poisson_ops.efield_periodic(phi)
        return Ex, Ey, phi

    def fused_step(state: PlasmaState) -> PlasmaState:
        f, g, rho_q = collide_stream(state.f, state.g, state.Ex, state.Ey,
                                     **phys)
        Ex, Ey, phi = solve(rho_q)
        return PlasmaState(f=f, g=g, Ex=Ex, Ey=Ey, phi=phi,
                           step=state.step + 1)

    def plain_step(state: PlasmaState) -> PlasmaState:
        f_in, g_in = state.f.to(cfg.dtype), state.g.to(cfg.dtype)
        mac = update_macro(f_in, g_in, state.Ex, state.Ey,
                           q_e=u.q_e, q_i=u.q_i, m_e=u.m_e, m_i=u.m_i,
                           neutral_ref=neutral_ref)
        f_post, g_post = collide(
            f_in, g_in, mac, state.Ex, state.Ey, **phys,
            # bf16 mode: the kernel's partial-fraction thermal algebra
            g_recip=(lambda x: 1.0 / x) if storage_bf16 else None)
        f = stream_periodic(f_post)
        g = stream_periodic(g_post)
        Ex, Ey, phi = solve(mac.rho_q)
        if storage_bf16:
            f = f.to(torch.bfloat16)
            g = g.to(torch.bfloat16)
        return PlasmaState(f=f, g=g, Ex=Ex, Ey=Ey, phi=phi,
                           step=state.step + 1)

    return fused_step if cfg.backend == "fused" else plain_step


def make_rollout(cfg: PlasmaConfig, n: Optional[int] = None
                 ) -> Callable[[PlasmaState], PlasmaState]:
    """state -> state after n steps (cfg.nsteps by default), one step at a
    time."""
    n_steps = cfg.nsteps if n is None else n
    step = make_step(cfg)

    def rollout(state: PlasmaState) -> PlasmaState:
        for _ in range(n_steps):
            state = step(state)
        return state

    return rollout
