"""Three-population plasma on a D3Q19 lattice: the 3-D column
(counterpart of lbm_tpu/models/plasma3d.py).

The 2-D physics (models/plasma.py) on the D3Q19 stencil with periodic
boundaries and a 3-D spectral Poisson solve

    phi_hat = rho_hat / (4 (sin^2(pi kx/NX) + sin^2(pi ky/NY)
                             + sin^2(pi kz/NZ)))

with the k=0 mode zeroed. The thermal energy-loss term uses Q=19.

Backends: "plain" runs the eager ops of ops/d3.py; "fused" runs the
hand-written CUDA collide+stream kernel (kernels/fused_step3d.py; on CPU
tensors its plain version). The JAX package's mass/thermal split pair and
its y-paneled kernel exist to fit the TPU's VMEM: the CUDA kernel takes any
cross-section, so the fused step always runs it. 3-D temporal blocking is
the JAX package's multi-device K-slab protocol only
(parallel/fused_sharded.make_fused_sharded_multistep_rollout_3d): make_step
refuses cfg.multistep, as the JAX model's does.

State layout: (3, 19, NZ, NY, NX) populations, (NZ, NY, NX) fields.
"""
from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import BC, PlasmaConfig, PoissonSolver
from ..constants import D3Q19
from ..kernels import fused_step3d
from ..ops.d3 import Macros3D, collide3, stream_periodic3, update_macro3

_NUMPY_DTYPES = {torch.float32: np.float32, torch.float64: np.float64}

# the JAX model's names for the shared ops
update_macro = update_macro3
collide = collide3
stream_periodic = stream_periodic3


class Plasma3DState(NamedTuple):
    f: torch.Tensor    # (3, 19, NZ, NY, NX)
    g: torch.Tensor
    Ex: torch.Tensor   # (NZ, NY, NX)
    Ey: torch.Tensor
    Ez: torch.Tensor
    phi: torch.Tensor
    step: int


def check_supported(cfg: PlasmaConfig) -> None:
    """Raise for configurations the 3-D model does not run: ValueError
    where the JAX package refuses them too, NotImplementedError (with the
    ROADMAP item) where the port does not run them yet."""
    if cfg.NZ <= 0:
        raise ValueError("the 3-D model needs NZ > 0 (models/plasma runs "
                         "NZ = 0)")
    if cfg.poisson not in (PoissonSolver.FFT, PoissonSolver.NONE):
        raise ValueError("3-D model supports FFT/NONE Poisson")
    if cfg.bc != BC.PERIODIC:
        raise ValueError("the 3-D column is periodic only")
    if cfg.backend == "pallas":
        # as the JAX model: no separate 3-D collide-only kernel
        raise ValueError("3-D model backends are 'plain' and 'fused' "
                         "(there is no separate 3-D pallas collide kernel)")
    if cfg.dtype not in _NUMPY_DTYPES:
        raise NotImplementedError(f"dtype {cfg.dtype} (the port computes in "
                                  f"float32 or float64)")
    if cfg.storage == "bf16" and cfg.dtype != torch.float32:
        raise NotImplementedError("bf16 storage computes in float32")


def init_state(cfg: PlasmaConfig, device) -> Plasma3DState:
    """Electrons and ions seeded in the centre column (the 2-D box in x-y,
    spanning all z), neutrals everywhere, the uniform external E field;
    built on `device`."""
    check_supported(cfg)
    u = cfg.units()
    NZ, NY, NX, dtype = cfg.NZ, cfg.NY, cfg.NX, cfg.dtype
    iy = torch.arange(NY, device=device)[None, :, None]
    ix = torch.arange(NX, device=device)[None, None, :]
    box = ((iy >= NY // 4 + 1) & (iy < (3 * NY) // 4)
           & (ix >= NX // 4 + 1) & (ix < (3 * NX) // 4)).to(dtype)
    box = box.expand(NZ, NY, NX)
    ones = torch.ones((NZ, NY, NX), dtype=dtype, device=device)
    w = np.asarray(D3Q19.W)   # float64 on the host, cast once
    # delta mode: f[2] holds deviations from rho_n_init * w_i, which is
    # exactly the uniform neutral initial condition -> deltas are 0
    rho_n_amp = 0.0 if cfg.neutral_delta else u.rho_n_init
    np_dtype = _NUMPY_DTYPES[dtype]
    amp_f = np.stack([w * u.rho_e_init, w * u.rho_i_init,
                      w * rho_n_amp]).astype(np_dtype)
    amp_g = np.stack([w * u.T_e_init, w * u.T_i_init,
                      w * u.T_n_init]).astype(np_dtype)
    mask = torch.stack([box, box, ones])[:, None]   # (3, 1, NZ, NY, NX)
    store = torch.bfloat16 if cfg.storage == "bf16" else dtype
    f = (torch.as_tensor(amp_f, device=device)[:, :, None, None, None]
         * mask).to(store)
    g = (torch.as_tensor(amp_g, device=device)[:, :, None, None, None]
         * mask).to(store)
    zero = torch.zeros((NZ, NY, NX), dtype=dtype, device=device)
    return Plasma3DState(
        f=f.contiguous(), g=g.contiguous(),
        Ex=torch.full((NZ, NY, NX), u.Ex_ext, dtype=dtype, device=device),
        Ey=torch.full((NZ, NY, NX), u.Ey_ext, dtype=dtype, device=device),
        Ez=zero, phi=zero.clone(), step=0)


def compute_macros(cfg: PlasmaConfig, state: Plasma3DState) -> Macros3D:
    """Macros for observation, honouring the storage contracts: bf16
    populations upcast to cfg.dtype, delta-stored neutrals read with
    neutral_ref as full densities."""
    u = cfg.units()
    return update_macro3(
        state.f.to(cfg.dtype), state.g.to(cfg.dtype),
        state.Ex, state.Ey, state.Ez,
        q_e=u.q_e, q_i=u.q_i, m_e=u.m_e, m_i=u.m_i,
        neutral_ref=u.rho_n_init if cfg.neutral_delta else 0.0)


@functools.lru_cache(maxsize=8)
def _spectral_inv3d_tensor(NZ: int, NY: int, NX: int, dtype: torch.dtype,
                           device: torch.device) -> torch.Tensor:
    return torch.as_tensor(spectral_inv3d(NZ, NY, NX), dtype=dtype,
                           device=device)


def spectral_inv3d(NZ: int, NY: int, NX: int) -> np.ndarray:
    """1/eigenvalue of the discrete 3-D Laplacian on the rfft grid (k=0
    mode zeroed), in float64 on the host."""
    kz = np.fft.fftfreq(NZ) * NZ
    ky = np.fft.fftfreq(NY) * NY
    kx = np.arange(NX // 2 + 1)
    den = 4.0 * (np.sin(np.pi * kz / NZ)[:, None, None] ** 2
                 + np.sin(np.pi * ky / NY)[None, :, None] ** 2
                 + np.sin(np.pi * kx / NX)[None, None, :] ** 2)
    return np.where(den > 1e-15, 1.0 / np.maximum(den, 1e-300), 0.0)


def solve_fft3d(rho_q: torch.Tensor) -> torch.Tensor:
    """3-D spectral Poisson solve with torch.fft.rfftn / irfftn (cuFFT on
    the card). The JAX package routes volumes of 128^3 sites and more
    through a packed-halves transform (_rfft3_packed) because XLA's real
    FFT is slow on the TPU; cuFFT's real transforms have no such gap, so
    that branch is not ported."""
    NZ, NY, NX = rho_q.shape
    rho_hat = torch.fft.rfftn(rho_q, dim=(-3, -2, -1))
    inv = _spectral_inv3d_tensor(NZ, NY, NX, rho_q.dtype, rho_q.device)
    phi = torch.fft.irfftn(rho_hat * inv, s=(NZ, NY, NX), dim=(-3, -2, -1))
    return phi.to(rho_q.dtype)


def efield_periodic3d(phi: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """E = -grad phi by central differences with periodic wrap."""
    Ex = -0.5 * (torch.roll(phi, -1, 2) - torch.roll(phi, 1, 2))
    Ey = -0.5 * (torch.roll(phi, -1, 1) - torch.roll(phi, 1, 1))
    Ez = -0.5 * (torch.roll(phi, -1, 0) - torch.roll(phi, 1, 0))
    return Ex, Ey, Ez


def make_step(cfg: PlasmaConfig) -> Callable[[Plasma3DState], Plasma3DState]:
    """The single-step function: collide + stream (the CUDA kernel on the
    fused backend, the eager ops on plain; bf16 storage upcast, collided
    with the exact reciprocal 1/x and rounded once, at the final write),
    then the Poisson dispatch."""
    check_supported(cfg)
    if cfg.multistep:
        # the per-step kernel is one pass over device memory already: 3-D
        # windows exist only to amortise the multi-device exchange
        raise ValueError(
            "3-D multistep is multi-chip only: use parallel/fused_sharded."
            "make_fused_sharded_multistep_rollout_3d")
    u = cfg.units()
    phys = dict(taus=cfg.taus, q_e=u.q_e, q_i=u.q_i, m_e=u.m_e, m_i=u.m_i,
                cs2=u.cs2, kb=u.kb,
                neutral_ref=u.rho_n_init if cfg.neutral_delta else 0.0)
    collide_stream = (fused_step3d.collide_stream3d if cfg.backend == "fused"
                      else fused_step3d.collide_stream3d_reference)

    def step(state: Plasma3DState) -> Plasma3DState:
        f, g, rho_q = collide_stream(state.f, state.g, state.Ex, state.Ey,
                                     state.Ez, **phys)
        return _poisson_and_pack(cfg, state, f, g, rho_q)

    return step


def _poisson_and_pack(cfg, state, f, g, rho_q) -> Plasma3DState:
    """FFT + periodic solve, or the NONE solver's quirk
    (src/poisson.cpp:34-43): E zeroed for good, or kept when the quirk is
    off."""
    if cfg.poisson == PoissonSolver.FFT:
        phi = solve_fft3d(rho_q)
        Ex, Ey, Ez = efield_periodic3d(phi)
    elif cfg.compat.none_solver_kills_external_field:
        z = torch.zeros_like(state.Ex)
        Ex, Ey, Ez, phi = z, z, z, state.phi
    else:
        Ex, Ey, Ez, phi = state.Ex, state.Ey, state.Ez, state.phi
    return Plasma3DState(f=f, g=g, Ex=Ex, Ey=Ey, Ez=Ez, phi=phi,
                         step=state.step + 1)


def make_rollout(cfg: PlasmaConfig, n: Optional[int] = None
                 ) -> Callable[[Plasma3DState], Plasma3DState]:
    """state -> state after n steps (cfg.nsteps by default), a step at a
    time from the host."""
    step = make_step(cfg)
    n_steps = cfg.nsteps if n is None else n

    def rollout(state: Plasma3DState) -> Plasma3DState:
        for _ in range(n_steps):
            state = step(state)
        return state

    return rollout
