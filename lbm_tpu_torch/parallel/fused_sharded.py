"""The 2-D plasma step and the lid-driven cavity sharded over ranks: ring
halo exchange + the halo kernels (+ the plasma's sharded Poisson solve)
(counterpart of the 2-D plasma and cavity parts of
lbm_tpu/parallel/fused_sharded.py).

Each rank holds one block of the lattice (parallel/sharding) and runs, each
step:

  1. the exchange: the block's edge rows go to its dy neighbours (ring,
     periodic) with parallel/mesh.ring_shift, as 1-row strips of f, g, Ex,
     Ey; on a (dy, dx) mesh the y strips are then corner-extended by the dx
     neighbours' edge columns, and the block's edge columns go to its dx
     neighbours;
  2. the halo kernel (kernels/fused_step.collide_stream_halo on a y-shard,
     collide_stream_halo2d on a tile), which collides the strips' edge
     sites again and streams them into the block; on CPU tensors its plain
     version;
  3. the sharded Poisson solve (parallel/poisson) on the block's rho_q.

make_fused_sharded_step_auto picks the mesh as the JAX package does
(pick_mesh), without its TPU memory test, and raises NotImplementedError
where the JAX package falls back to its GSPMD jnp step (ROADMAP Queue 1
item 17).

The cavity runs on a (dy, 1) mesh of y-shards. Its per-step paths
(make_fused_sharded_cavity_step, _rollout) exchange 1-row strips of f, and
in stored mode of the macros, and run collide_stream_cavity_halo or
_halo_lean; the window path (make_fused_sharded_cavity_multistep_rollout)
exchanges K-row slabs of f once a window and runs
collide_stream_cavity_multistep_gated on the extended shard. The wall shards
apply the bottom wall and the lid; the strips the ring wraps onto them are
ignored there. The JAX package's VMEM tests (_pick_band,
check_vmem_multistep) measure the TPU's scratch memory and are dropped: the
CUDA kernels take any shard that fits the card.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..config import BC, CavityConfig, PlasmaConfig, PoissonSolver
from ..kernels.fused_cavity import (collide_stream_cavity_halo,
                                    collide_stream_cavity_halo_lean,
                                    collide_stream_cavity_multistep_gated)
from ..kernels.fused_step import collide_stream_halo, collide_stream_halo2d
from ..models import cavity
from ..models.cavity import CavityState
from ..models.plasma import PlasmaState, check_supported
from .mesh import AXIS_X, AXIS_Y, make_mesh, mesh_shape, ring_shift
from .poisson import solve_poisson_sharded
from .sharding import shard_state, validate_grid

GSPMD_ITEM = "ROADMAP Queue 1 item 17"


def _refuse_solver_and_walls(cfg: PlasmaConfig) -> None:
    if cfg.poisson not in (PoissonSolver.FFT, PoissonSolver.NONE):
        raise ValueError("sharded fused step supports FFT/NONE Poisson")
    if cfg.bc != BC.PERIODIC:
        raise ValueError("fused sharded step is periodic-BC only (the "
                         f"sharded step for bounce-back is {GSPMD_ITEM})")


def _phys(cfg: PlasmaConfig) -> dict:
    u = cfg.units()
    return dict(taus=cfg.taus, q_e=u.q_e, q_i=u.q_i, m_e=u.m_e, m_i=u.m_i,
                cs2=u.cs2, kb=u.kb,
                neutral_ref=u.rho_n_init if cfg.neutral_delta else 0.0)


def _edges(arrays, lo: bool, dim: int):
    """The first (lo) or last row (dim -2) or column (dim -1) of each."""
    idx = slice(0, 1) if lo else slice(-1, None)
    return [a[..., idx, :] if dim == -2 else a[..., idx] for a in arrays]


def make_fused_sharded_step(cfg: PlasmaConfig, mesh: DeviceMesh
                            ) -> Callable[[PlasmaState], PlasmaState]:
    """The sharded step on a 1-D (dy) mesh: full lattice width per rank,
    periodic walls, FFT or NONE, NY divisible by 8 * ranks (the JAX
    package's rules; the CUDA kernel itself takes any NY)."""
    ny, nx = mesh_shape(mesh)
    if nx != 1:
        raise ValueError("fused sharded step is 1-D (dy) only; got "
                         f"nontrivial axes ['{AXIS_X}']")
    if cfg.NY % (8 * ny):
        raise ValueError(f"NY={cfg.NY} must be divisible by 8*{ny}")
    _refuse_solver_and_walls(cfg)
    check_supported(cfg)
    phys = _phys(cfg)

    def step(state: PlasmaState) -> PlasmaState:
        arrays = (state.f, state.g, state.Ex, state.Ey)
        up = ring_shift(_edges(arrays, False, -2), mesh, AXIS_Y, 1)
        dn = ring_shift(_edges(arrays, True, -2), mesh, AXIS_Y, -1)
        f, g, rho_q = collide_stream_halo(*arrays, *up, *dn, **phys)
        Ex, Ey, phi = solve_poisson_sharded(cfg, rho_q, state.phi, state.Ex,
                                            state.Ey, mesh)
        return PlasmaState(f=f, g=g, Ex=Ex, Ey=Ey, phi=phi,
                           step=state.step + 1)

    return step


def make_fused_sharded_step_2d(cfg: PlasmaConfig, mesh: DeviceMesh
                               ) -> Callable[[PlasmaState], PlasmaState]:
    """The sharded step on a (dy, dx) mesh (the JAX package's rules: NY and
    NX divisible by 8 times the mesh dims, FFT or NONE, periodic walls).

    The exchange has the JAX package's two stages: the y strips along dy,
    then along dx the y strips' edge columns (their corners) and the
    block's edge columns (the x strips)."""
    ny, nx = mesh_shape(mesh)
    if cfg.NY % (8 * ny) or cfg.NX % (max(nx, 1) * 8):
        raise ValueError("NY/NX must be divisible by 8*mesh dims")
    _refuse_solver_and_walls(cfg)
    check_supported(cfg)
    phys = _phys(cfg)

    def step(state: PlasmaState) -> PlasmaState:
        arrays = (state.f, state.g, state.Ex, state.Ey)
        ys = (ring_shift(_edges(arrays, False, -2), mesh, AXIS_Y, 1)
              + ring_shift(_edges(arrays, True, -2), mesh, AXIS_Y, -1))
        # each y strip's edge columns (its corners), then the block's
        from_left = ring_shift(
            _edges(ys, False, -1) + _edges(arrays, False, -1), mesh, AXIS_X, 1)
        from_right = ring_shift(
            _edges(ys, True, -1) + _edges(arrays, True, -1), mesh, AXIS_X, -1)
        ext = [torch.cat([lt, s, rt], dim=-1)
               for lt, s, rt in zip(from_left[:8], ys, from_right[:8])]
        f, g, rho_q = collide_stream_halo2d(*arrays, *ext, *from_left[8:],
                                            *from_right[8:], **phys)
        Ex, Ey, phi = solve_poisson_sharded(cfg, rho_q, state.phi, state.Ex,
                                            state.Ey, mesh)
        return PlasmaState(f=f, g=g, Ex=Ex, Ey=Ey, phi=phi,
                           step=state.step + 1)

    return step


def pick_mesh(cfg: PlasmaConfig, n: int) -> Tuple[int, int]:
    """The (ny, nx) mesh make_fused_sharded_step_auto runs n ranks on, in
    the JAX package's order of preference: (n, 1) with the 1-D step when
    NY divides 8n; else a (dy, dx) mesh with the 2-D step, dy descending
    from n to 2 with nx >= 2. The JAX package's per-shard VMEM test
    (_pick_band) is dropped: it measures the TPU's scratch memory, and the
    CUDA kernel has no band; picks differ only where that band would not
    fit. Where the JAX package falls back to its GSPMD jnp step
    (bounce-back, GS/SOR/NPS, or no divisible 8-multiple) this raises
    NotImplementedError; a grid that no factorisation divides raises
    ValueError."""
    if n < 2:
        raise ValueError("auto sharding needs >= 2 devices")
    fused_ok = (cfg.bc == BC.PERIODIC
                and cfg.poisson in (PoissonSolver.FFT, PoissonSolver.NONE))
    if fused_ok and cfg.NY % (8 * n) == 0:
        return n, 1
    divisors = [d for d in range(n, 0, -1) if n % d == 0]
    if fused_ok:
        for ny in divisors:
            nx = n // ny
            if ny < 2 or nx < 2:
                continue
            if cfg.NY % (8 * ny) or cfg.NX % (8 * nx):
                continue
            return ny, nx
    for ny in divisors:
        if cfg.NY % ny == 0 and cfg.NX % (n // ny) == 0:
            raise NotImplementedError(
                f"sharding {cfg.NY}x{cfg.NX} ({cfg.poisson.name}, "
                f"{cfg.bc.name}) over {n} ranks needs the sharded plain "
                f"step for any solver and wall, {GSPMD_ITEM}")
    raise ValueError(
        f"no feasible decomposition of {cfg.NY}x{cfg.NX} over {n} devices: "
        f"no mesh factorization divides the grid")


def make_fused_sharded_step_auto(cfg: PlasmaConfig, n: int,
                                 device_type: str = "cuda"):
    """(step, mesh, shard_fn) for n ranks: the mesh of pick_mesh over the
    initialised default group, its step, and shard_fn(full state) -> this
    rank's block (the counterpart of the JAX function's shardings)."""
    shape = pick_mesh(cfg, n)
    mesh = make_mesh(shape, device_type)
    validate_grid(cfg, mesh)
    make = (make_fused_sharded_step if shape[1] == 1
            else make_fused_sharded_step_2d)
    return make(cfg, mesh), mesh, lambda state: shard_state(state, mesh)


# ---------------------------------------------------------------------------
# the lid-driven cavity
# ---------------------------------------------------------------------------

def _cavity_ranks(mesh: DeviceMesh, what: str) -> int:
    """The dy size of a (dy, 1) mesh; a nontrivial dx axis is refused."""
    ny, nx = mesh_shape(mesh)
    if nx != 1:
        raise ValueError(f"{what} is 1-D (dy) only; got nontrivial axes "
                         f"['{AXIS_X}']")
    return ny


def _cavity_walls(mesh: DeviceMesh, n: int) -> Tuple[bool, bool]:
    """(bottom, top): this rank's shard holds y = 0, holds the lid."""
    idx = mesh.get_local_rank(AXIS_Y)
    return idx == 0, idx == n - 1


def _cavity_shard_step(cfg: CavityConfig, mesh: DeviceMesh) -> Callable:
    """The refusals of the per-step paths, then one shard step: lean
    f -> f, stored (f, rho, ux, uy) -> (f, rho, ux, uy), at a host lid
    speed. Each step sends the shard's edge rows to its dy neighbours
    (ring): 9 planes a strip in lean mode, 12 in stored mode."""
    n = _cavity_ranks(mesh, "fused sharded cavity step")
    if cfg.NY % (8 * n):
        raise ValueError(f"NY={cfg.NY} must be divisible by 8*{n} (the Ghia "
                         f"129^2 default is indivisible: use a multiple-of-8 "
                         f"grid; the GSPMD cavity step is {GSPMD_ITEM})")
    cavity._check_supported(cfg)
    tau = cfg.tau
    bottom, top = _cavity_walls(mesh, n)

    def exchange(f, macros=()):
        """The rows below the shard (the previous rank's last row) and
        above it (the next rank's first row): f's, then the macros'
        stacked (3, 1, NX)."""
        up = [f[:, -1:]] + ([torch.stack([m[-1:] for m in macros])]
                            if macros else [])
        dn = [f[:, :1]] + ([torch.stack([m[:1] for m in macros])]
                           if macros else [])
        return (ring_shift(up, mesh, AXIS_Y, 1),
                ring_shift(dn, mesh, AXIS_Y, -1))

    if cfg.lean_macros:
        def local_lean(f, u):
            (f_up,), (f_dn,) = exchange(f)
            return collide_stream_cavity_halo_lean(f, f_up, f_dn, u, bottom,
                                                   top, tau=tau)
        return local_lean

    def local(f, rho, ux, uy, u):
        (f_up, m_up), (f_dn, m_dn) = exchange(f, (rho, ux, uy))
        return collide_stream_cavity_halo(f, rho, ux, uy, f_up, m_up, f_dn,
                                          m_dn, u, bottom, top, tau=tau)
    return local


def make_fused_sharded_cavity_step(cfg: CavityConfig, mesh: DeviceMesh
                                   ) -> Callable[[CavityState], CavityState]:
    """The sharded cavity step on a (dy, 1) mesh: NY divisible by 8 *
    ranks (the JAX package's rule; the CUDA kernels take any NY). Each rank
    holds its rows (parallel/sharding.shard_cavity_state); the step counter
    is a host int on every rank. cfg.lean_macros runs the populations-only
    halo kernel and recomputes the macros after it, as the JAX step does;
    long lean marches should take make_fused_sharded_cavity_rollout, which
    carries f alone."""
    local = _cavity_shard_step(cfg, mesh)
    lean = cfg.lean_macros

    def step(state: CavityState) -> CavityState:
        u = cavity._lid_speed(cfg, state.step)
        if lean:
            f = local(state.f, u)
            return CavityState(f, *cavity.macros_of(cfg, f), state.step + 1)
        return CavityState(*local(state.f, state.rho, state.ux, state.uy, u),
                           state.step + 1)

    return step


def make_fused_sharded_cavity_rollout(cfg: CavityConfig, mesh: DeviceMesh,
                                      n: int
                                      ) -> Callable[[CavityState], CavityState]:
    """n sharded cavity steps. In lean mode the loop carries (f, step) only
    and the macros are computed once at the end, on each shard; stored mode
    carries the whole state."""
    local = _cavity_shard_step(cfg, mesh)

    def rollout(state: CavityState) -> CavityState:
        if cfg.lean_macros:
            f = state.f
            for t in range(state.step, state.step + n):
                f = local(f, cavity._lid_speed(cfg, t))
            return CavityState(f, *cavity.macros_of(cfg, f), state.step + n)
        out = (state.f, state.rho, state.ux, state.uy)
        for t in range(state.step, state.step + n):
            out = local(*out, cavity._lid_speed(cfg, t))
        return CavityState(*out, state.step + n)

    return rollout


def make_fused_sharded_cavity_multistep_rollout(
        cfg: CavityConfig, mesh: DeviceMesh, n: int
) -> Callable[[CavityState], CavityState]:
    """n sharded cavity steps in windows of K = cfg.multistep: floor(n / K)
    windows of K steps and one of the remainder. Each window sends the
    shard's K edge rows to its dy neighbours (ring), concatenates
    [below, shard, above] and runs the gated window kernel on the extended
    (rows + 2K, NX) block with the bottom wall at row K on the first rank
    and the lid at row K + rows - 1 on the last (-1, none, elsewhere); the
    shard is the block's rows [K, K + rows). Garbage that the ring wraps
    onto the wall shards never crosses the wall rows, and the periodic
    wrap's error travels one row a step, so it stays in the ghost rows.
    A remainder window runs on K-deep slabs too. The loop carries (f,
    step); the macros are computed once at the end. NY must divide by the
    ranks (any alignment) and K must not exceed a shard's rows: one ring
    hop brings no deeper ghost."""
    ranks = _cavity_ranks(mesh, "sharded cavity multistep")
    K = int(cfg.multistep)
    if K <= 0:
        raise ValueError("sharded cavity multistep needs cfg.multistep > 0")
    if cfg.NY % ranks:
        raise ValueError(f"NY={cfg.NY} must be divisible by {ranks}")
    rows = cfg.NY // ranks
    if K > rows:
        raise ValueError(f"multistep K={K} exceeds rows/shard={rows}; the "
                         f"one-hop ghost exchange needs K <= rows (smaller K "
                         f"or fewer devices)")
    cavity._check_supported(cfg)
    bottom, top = _cavity_walls(mesh, ranks)
    wall_rows = (K if bottom else -1, K + rows - 1 if top else -1)
    windows = [K] * (n // K) + ([n % K] if n % K else [])
    kw = dict(tau=cfg.tau, u_lid=cfg.u_lid, sigma=cfg.sigma)

    def rollout(state: CavityState) -> CavityState:
        f, t = state.f, state.step
        for k in windows:
            (below,) = ring_shift([f[:, -K:]], mesh, AXIS_Y, 1)
            (above,) = ring_shift([f[:, :K]], mesh, AXIS_Y, -1)
            block = torch.cat([below, f, above], dim=1)
            f = collide_stream_cavity_multistep_gated(
                block, t, wall_rows, k_steps=k, **kw)[:, K:K + rows]
            f = f.contiguous()
            t += k
        return CavityState(f, *cavity.macros_of(cfg, f), t)

    return rollout
