"""Three-population (e/i/n) D2Q9 plasma: state, init and the step
(counterpart of lbm_tpu/models/plasma.py).

The step replicates the reference's time loop (src/plasma.cpp:476-523):
macros -> equilibria -> collide -> stream (periodic or bounce-back) ->
Poisson solve (NONE, GS, SOR, FFT or NPS) -> E. With cfg.multistep = K the
rollout runs K steps per kernel launch (kernels/fused_multistep.py). The FFT
solve runs torch.fft (fft_engine "xla" or "auto") or the spectral CUDA
kernel of kernels/fft_tpu.py ("pallas"), which never forms phi.
CompatFlags.debug_variant replicates the reference's debug predecessor build
on the plain backend (models/plasma_staged.py dumps it stage by stage).
check_supported refuses what the port does not run yet, with the ROADMAP
item that brings it.

State layout: populations f, g as (3, 9, NY, NX) tensors (species-major,
direction next, lattice minor), the JAX package's layout.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import BC, PlasmaConfig, PoissonSolver
from ..constants import D2Q9
from ..kernels import fft_tpu, poisson_iter
from ..kernels.collide_pallas import fused_collide
from ..kernels.fused_multistep import collide_stream_multistep
from ..kernels.fused_step import collide_reference, collide_stream
from ..ops import poisson as poisson_ops
from ..ops import stream as stream_ops
from ..ops.macros import Macros, update_macro
from ..ops.stream import stream_periodic

_NUMPY_DTYPES = {torch.float32: np.float32, torch.float64: np.float64}


class PlasmaState(NamedTuple):
    """Full simulation state (everything needed to resume)."""

    f: torch.Tensor    # (3, Q, NY, NX) mass populations (e, i, n)
    g: torch.Tensor    # (3, Q, NY, NX) thermal (DDF) populations
    Ex: torch.Tensor   # (NY, NX)
    Ey: torch.Tensor   # (NY, NX)
    phi: torch.Tensor  # (NY, NX) potential, warm-started across steps
    step: int


def check_supported(cfg: PlasmaConfig) -> None:
    """Raise NotImplementedError for configurations the port cannot run
    yet, naming the ROADMAP item that will bring each."""
    gaps = []
    if cfg.NZ:
        gaps.append("NZ>0 in the 2-D model (the 3-D column is "
                    "models/plasma3d, run by run_plasma3d, with its "
                    "multistep)")
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


def guard_values(cfg: PlasmaConfig) -> Tuple[float, float, float]:
    """What the momentum == +/-rho guard assigns per species: 0, or in the
    debug variant 0.01 cs2, 1e-5 cs2, 0 (lbm_tpu/models/plasma.py:319)."""
    cs2 = cfg.units().cs2
    return ((0.01 * cs2, 0.00001 * cs2, 0.0) if cfg.compat.debug_variant
            else (0.0, 0.0, 0.0))


def compute_macros(cfg: PlasmaConfig, state: PlasmaState) -> Macros:
    """Macroscopic fields for observation (same op as the step)."""
    u = cfg.units()
    return update_macro(state.f.to(cfg.dtype), state.g.to(cfg.dtype),
                        state.Ex, state.Ey,
                        q_e=u.q_e, q_i=u.q_i, m_e=u.m_e, m_i=u.m_i,
                        guard_vals=guard_values(cfg),
                        neutral_ref=u.rho_n_init if cfg.neutral_delta else 0.0)


def _use_pallas_fft(cfg: PlasmaConfig, shape) -> bool:
    """Resolve cfg.fft_engine for this grid (lbm_tpu/models/plasma.py:94):
    "xla" is torch.fft; "pallas" the spectral CUDA kernel (on CPU tensors
    its plain version), which needs both axes (power of two) * 128 and
    float32; "auto" resolves to torch.fft, as the JAX package resolves it
    to XLA."""
    if cfg.fft_engine != "pallas":
        return False
    if not fft_tpu.supports(*shape):
        raise ValueError(f"fft_engine='pallas' needs both grid axes = "
                         f"power-of-two * 128, got {tuple(shape)}")
    if cfg.dtype != torch.float32:
        # the kernel computes in f32; silently downgrading an f64 parity
        # run's E field would be a trap
        raise ValueError("fft_engine='pallas' is f32-only (the xla engine "
                         "serves f64 parity runs)")
    return True


def reconstruct_phi(cfg: PlasmaConfig, state: PlasmaState) -> torch.Tensor:
    """The potential of the CURRENT state's charge density.

    The pallas FFT path never forms phi (state.phi goes stale); this
    recomputes one. The state's Ex/Ey derive from the PRE-step rho_q, so
    this phi, the solve of the post-step rho_q, is one step ahead of the
    stored E: the warm start a resumed run's first solve would produce, not
    -grad^-1 of the stored E."""
    return poisson_ops.solve_fft(compute_macros(cfg, state).rho_q)


def _use_iter_kernel(cfg: PlasmaConfig) -> bool:
    """Resolve cfg.iter_engine: "xla" runs the plain sweeps, "pallas" the
    solve kernel, and "auto" the kernel on the fused and pallas backends.
    The JAX package's "auto" also asks for f32 and a grid that fits VMEM
    (<= 1024^2), limits of Mosaic and the TPU that the H100 does not have:
    here the kernel takes f32 and f64 at any size. That changes no number,
    because the kernel is bitwise equal to the sweeps. On CPU tensors the
    kernel's wrapper runs those same sweeps."""
    if cfg.iter_engine == "auto":
        return cfg.backend in ("fused", "pallas")
    return cfg.iter_engine == "pallas"


def _solve_poisson(
    cfg: PlasmaConfig,
    rho_q: torch.Tensor,
    phi: torch.Tensor,
    Ex: torch.Tensor,
    Ey: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Poisson dispatch replicating src/poisson.cpp:25-82. Returns
    (Ex, Ey, phi)."""
    sol = cfg.poisson
    compat = cfg.compat

    if sol == PoissonSolver.NONE:
        if compat.none_solver_kills_external_field:
            # The reference zeroes E on the first call and never restores
            # it (src/poisson.cpp:34-43): the post-step field is always 0.
            return torch.zeros_like(Ex), torch.zeros_like(Ey), phi
        return Ex, Ey, phi

    periodic_bc = cfg.bc == BC.PERIODIC

    if sol == PoissonSolver.FFT:
        if not periodic_bc:
            # FFT under bounce-back: the reference returns without solving
            # (src/poisson.cpp:76-77); E keeps its previous value.
            return Ex, Ey, phi
        if _use_pallas_fft(cfg, rho_q.shape):
            # phi is not formed on this path; reconstruct_phi serves it
            Ex2, Ey2 = fft_tpu.solve_fft_efield_tpu(rho_q)
            return Ex2, Ey2, phi
        phi = poisson_ops.solve_fft(rho_q)
        Ex2, Ey2 = poisson_ops.efield_periodic(phi)
        return Ex2, Ey2, phi

    # Iterative solvers; E follows the BC type.
    spec = _iter_spec(cfg, periodic_bc)
    if _use_iter_kernel(cfg):
        phi = poisson_iter.solve_iter(phi, rho_q, spec=spec)
    else:
        phi = poisson_iter.solve_iter_reference(phi, rho_q, spec=spec)
    if periodic_bc:
        Ex2, Ey2 = poisson_ops.efield_periodic(phi)
    else:
        Ex2, Ey2 = poisson_ops.efield_neumann(phi)
    return Ex2, Ey2, phi


def _neutral_hole_backgrounds(ref: float):
    """Per-HOLE_SLOT background f value rho_ref * w_i of the neutral.

    The reference's g-streaming leaks post-collision f values into the 8
    bounce-back corner holes. In delta mode f[2] holds deltas, so the
    classic leaked value is delta + rho_ref * w_i; g is not delta-stored,
    so the background is added back to keep the quirk."""
    return [ref * float(D2Q9.W[i]) for (i, _, _) in stream_ops.HOLE_SLOTS]


def _g_holes_with_background(vals, neutral_ref: float, compute_dtype=None):
    """Add the neutral background to the 8 g-hole values. `compute_dtype`
    (bf16-storage mode) does the add at full precision. The fused path's
    hole bases are already bf16-rounded (the kernel stored them), so those
    8 cells round twice against the plain path's round-at-final-write: at
    most one bf16 ulp of the ~1.8e10 background."""
    if neutral_ref == 0.0:
        return vals
    out = []
    for v, bg in zip(vals, _neutral_hole_backgrounds(neutral_ref)):
        w = v.to(v.dtype if compute_dtype is None else compute_dtype,
                 copy=True)
        w[..., 2] = w[..., 2] + bg
        out.append(w.to(v.dtype))
    return out


def make_step(cfg: PlasmaConfig) -> Callable[[PlasmaState], PlasmaState]:
    """The single-step function for this configuration.

    backend="fused": collide+stream in one kernel call, then the
    bounce-back edge fixups; "pallas": the collide-only kernel, then
    streaming in torch; "plain": the eager ops. The plain and pallas steps
    round bf16 storage once per step, at the final write (pallas refuses
    bf16, as the JAX package does).

    debug_variant (plain backend only): the debug build's guard values,
    pre-collision g in the bounce-back corner holes (its own g temp
    buffers), and the external field zeroed after step 0 for every solver
    (plasma_debug.cpp:1558-1566)."""
    check_supported(cfg)
    u = cfg.units()
    periodic = cfg.bc == BC.PERIODIC
    storage_bf16 = cfg.storage == "bf16"
    if storage_bf16 and cfg.backend == "pallas":
        raise ValueError("bf16 storage supports the plain and fused backends")
    debug_variant = cfg.compat.debug_variant
    if debug_variant and cfg.backend != "plain":
        raise ValueError("debug_variant mode is plain-backend only")
    if cfg.poisson == PoissonSolver.FFT and periodic:
        _use_pallas_fft(cfg, (cfg.NY, cfg.NX))   # refuse a bad engine now
    neutral_ref = u.rho_n_init if cfg.neutral_delta else 0.0
    phys = dict(taus=cfg.taus, q_e=u.q_e, q_i=u.q_i, m_e=u.m_e, m_i=u.m_i,
                cs2=u.cs2, kb=u.kb, neutral_ref=neutral_ref)

    def fused_step(state: PlasmaState) -> PlasmaState:
        if not periodic:
            # Bounce-back rides the periodic kernel: the reflections are
            # edge fixups of its result, which holds every post-collision
            # value at a shifted index (ops/stream.py). The f holes' stale
            # contents are 8 pre-collision values, read from state.f.
            f_holes = stream_ops.hole_values(state.f)
        f, g, rho_q = collide_stream(state.f, state.g, state.Ex, state.Ey,
                                     **phys)
        if not periodic:
            g_holes = _g_holes_with_background(
                stream_ops.hole_values_from_periodic(f), neutral_ref,
                compute_dtype=cfg.dtype if storage_bf16 else None)
            f = stream_ops.bounceback_from_periodic(f, f_holes)
            g = stream_ops.bounceback_from_periodic(g, g_holes)
        Ex, Ey, phi = _solve_poisson(cfg, rho_q, state.phi, state.Ex,
                                     state.Ey)
        return PlasmaState(f=f, g=g, Ex=Ex, Ey=Ey, phi=phi,
                           step=state.step + 1)

    if cfg.backend == "fused":
        return fused_step

    def stream(f_post, g_post, f_holes, g_holes):
        return tuple(stream_periodic(p) if h is None
                     else stream_ops.bounceback_from_periodic(
                         stream_periodic(p), h)
                     for p, h in ((f_post, f_holes), (g_post, g_holes)))

    return plain_step(cfg, cfg.backend == "pallas", stream, _solve_poisson)


def plain_step(cfg: PlasmaConfig, collide_kernel: bool, stream: Callable,
               solve: Callable) -> Callable[[PlasmaState], PlasmaState]:
    """The plain step around its streaming and its solve, which the
    single-device step (make_step) and the sharded one
    (parallel/sharding.make_sharded_step) give it: update_macro + collide
    in cfg.dtype (bf16 storage: the kernel's partial-fraction thermal
    algebra), or with collide_kernel the collide-only kernel; then
    stream(f_post, g_post, f_holes, g_holes) -> (f, g), the holes None
    under periodic walls; then solve(cfg, rho_q, phi, Ex, Ey) -> (Ex, Ey,
    phi). bf16 storage rounds once, at the final write."""
    u = cfg.units()
    periodic = cfg.bc == BC.PERIODIC
    neutral_ref = u.rho_n_init if cfg.neutral_delta else 0.0
    debug_variant = cfg.compat.debug_variant
    phys = dict(taus=cfg.taus, q_e=u.q_e, q_i=u.q_i, m_e=u.m_e, m_i=u.m_i,
                cs2=u.cs2, kb=u.kb, neutral_ref=neutral_ref)
    if collide_kernel:
        collide_stage, stage_kw = fused_collide, phys
    else:
        collide_stage = collide_reference
        stage_kw = dict(phys, guard_vals=guard_values(cfg))

    def step(state: PlasmaState) -> PlasmaState:
        f_post, g_post, rho_q = collide_stage(state.f, state.g, state.Ex,
                                              state.Ey, **stage_kw)
        f_holes = g_holes = None
        if not periodic:
            # The reference's recycled temp buffers leak stale values into
            # the corner holes: pre-collision f for the f-streaming,
            # post-collision f for the g-streaming (ops/stream.py). The
            # debug build has its own g temp buffers, so its g holes keep
            # the pre-collision g.
            f_holes = stream_ops.hole_values(state.f.to(cfg.dtype))
            g_holes = (stream_ops.hole_values(state.g.to(cfg.dtype))
                       if debug_variant else _g_holes_with_background(
                           stream_ops.hole_values(f_post), neutral_ref))
        f, g = stream(f_post, g_post, f_holes, g_holes)
        Ex, Ey, phi = solve(cfg, rho_q, state.phi, state.Ex, state.Ey)
        if debug_variant and state.step == 0:
            # the "pulsed" external field: zeroed at the end of step 0
            Ex, Ey = torch.zeros_like(Ex), torch.zeros_like(Ey)
        if cfg.storage == "bf16":
            f = f.to(torch.bfloat16)
            g = g.to(torch.bfloat16)
        return PlasmaState(f=f, g=g, Ex=Ex, Ey=Ey, phi=phi,
                           step=state.step + 1)

    return step


def _iter_spec(cfg: PlasmaConfig, periodic_bc: bool):
    """The iterative solve's (kind, omega, max_iter, tol, interior_only)
    as _solve_poisson dispatches it: in compat mode the Dirichlet
    (interior-only) sweeps run even under periodic BCs."""
    iter_periodic = (periodic_bc
                     and not cfg.compat.dirichlet_iterative_under_periodic)
    return ("nps" if cfg.poisson == PoissonSolver.NPS else "gs",
            cfg.omega_sor if cfg.poisson == PoissonSolver.SOR else None,
            cfg.poisson_max_iter, cfg.poisson_tol, not iter_periodic)


def multistep_kwargs(cfg: PlasmaConfig) -> dict:
    """collide_stream_multistep's keyword arguments for this configuration
    (all but k_steps), as lbm_tpu/models/plasma.py:435-460 builds them:
    kill_field under the NONE quirk; the in-kernel FFT solve for FFT +
    periodic (FFT + bounce-back is the reference's no-op solve, a constant
    E); for GS/SOR/NPS the iterative spec of _solve_poisson with the
    Neumann E closure under bounce-back."""
    u = cfg.units()
    periodic_bc = cfg.bc == BC.PERIODIC
    solve_iter = None
    if cfg.poisson in (PoissonSolver.GS, PoissonSolver.SOR, PoissonSolver.NPS):
        solve_iter = _iter_spec(cfg, periodic_bc) + (not periodic_bc,)
    return dict(taus=cfg.taus, q_e=u.q_e, q_i=u.q_i, m_e=u.m_e, m_i=u.m_i,
                cs2=u.cs2, kb=u.kb,
                neutral_ref=u.rho_n_init if cfg.neutral_delta else 0.0,
                kill_field=(cfg.poisson == PoissonSolver.NONE and
                            cfg.compat.none_solver_kills_external_field),
                bounce=not periodic_bc,
                solve_fft=cfg.poisson == PoissonSolver.FFT and periodic_bc,
                solve_iter=solve_iter)


def _multistep_rollout(cfg: PlasmaConfig, n_steps: int
                       ) -> Callable[[PlasmaState], PlasmaState]:
    """n_steps as windows of cfg.multistep steps, one kernel launch each,
    plus one remainder window (lbm_tpu/models/plasma.py:429-516 without
    its banded branch: the CUDA kernel takes any grid).

    Under the NONE quirk the per-step E zeroing happens once per window:
    the kernel collides step 1 with the state's field and later steps with
    0, and the state's E is zeroed after the window. FFT + bounce-back is
    the reference's no-op solve, so every step collides with the state's
    E. FFT + periodic and the iterative solvers solve in the kernel every
    step and return the last step's (Ex, Ey, phi)."""
    kw = multistep_kwargs(cfg)
    kill = kw["kill_field"]
    solves = kw["solve_fft"] or kw["solve_iter"] is not None
    K = min(int(cfg.multistep), max(n_steps, 1))
    full, rem = divmod(n_steps, K)

    def window(state: PlasmaState, k: int) -> PlasmaState:
        if solves:
            f, g, Ex, Ey, phi = collide_stream_multistep(
                state.f, state.g, state.Ex, state.Ey, state.phi, k_steps=k,
                **kw)
            return PlasmaState(f=f, g=g, Ex=Ex, Ey=Ey,
                               phi=phi.to(state.phi.dtype),
                               step=state.step + k)
        f, g = collide_stream_multistep(state.f, state.g, state.Ex,
                                        state.Ey, k_steps=k, **kw)
        Ex, Ey = ((torch.zeros_like(state.Ex), torch.zeros_like(state.Ey))
                  if kill else (state.Ex, state.Ey))
        return PlasmaState(f=f, g=g, Ex=Ex, Ey=Ey, phi=state.phi,
                           step=state.step + k)

    def rollout(state: PlasmaState) -> PlasmaState:
        for _ in range(full):
            state = window(state, K)
        if rem:
            state = window(state, rem)
        return state

    return rollout


def make_rollout(cfg: PlasmaConfig, n: Optional[int] = None
                 ) -> Callable[[PlasmaState], PlasmaState]:
    """state -> state after n steps (cfg.nsteps by default): one step at a
    time, or with cfg.multistep = K windows of K steps per kernel launch
    (on CPU tensors the kernel's plain version runs)."""
    check_supported(cfg)
    n_steps = cfg.nsteps if n is None else n
    if cfg.multistep:
        return _multistep_rollout(cfg, n_steps)
    step = make_step(cfg)

    def rollout(state: PlasmaState) -> PlasmaState:
        for _ in range(n_steps):
            state = step(state)
        return state

    return rollout
