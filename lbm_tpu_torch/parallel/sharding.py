"""Block placement of the 2-D plasma state on a (dy, dx) mesh, of the
cavity state on a (dy, 1) mesh and of the 3-D column on a (dz, dy) mesh
(counterpart of the placement half of lbm_tpu/parallel/sharding.py:
validate_grid, state_shardings/shard_state,
cavity_state_shardings/shard_cavity_state, and of the NamedShardings that
lbm_tpu/parallel/fused_sharded.py's 3-D steps place their state with).

Each rank holds its block of the (NY, NX) lattice: rows
[by * NY/ny, (by + 1) * NY/ny) and columns [bx * NX/nx, (bx + 1) * NX/nx)
of the populations (3, 9, NY, NX) and of the fields (NY, NX), where
(by, bx) = (rank // nx, rank % nx). shard_state cuts a full state into
this rank's block; gather_state all-gathers the blocks back into the full
state on every rank (the tests and the CLI's outputs read it).
shard_cavity_state and gather_cavity_state do the same for the cavity's
(f, rho, ux, uy). A 3-D rank owns slices [bz * NZ/dz, (bz + 1) * NZ/dz) and
rows [by * NY/dy, ...) of the column, NX whole, where (bz, by) = (rank //
dy, rank % dy): shard_state3d and gather_state3d place and gather f, g,
Ex, Ey, Ez and phi of a Plasma3DState.

The JAX module's GSPMD steps run here as explicit block programs on the
(dy, dx) mesh: make_sharded_step (the 2-D plasma, any solver and wall) and
make_sharded_cavity_step. Each rank collides its block (site-local), pads
the post-collision populations with their one-cell ring
(parallel/mesh.pad_ring: what the partitioner inserts for every jnp.roll),
streams from the ring (ops/stream.stream_padded), takes the walls its
block holds (ops/stream.bounceback_block, cavity_walls: only the blocks at
the lattice's edges; the corner holes only on the corner blocks) and, for
the plasma, solves on the block (parallel/poisson.solve_poisson_sharded:
the iterative sweeps' error all-reduced with MAX). Each equals the
single-device plain step's block bit for bit, apart from the periodic FFT
solve's rounding. The 3-D GSPMD step (state_shardings3d,
make_sharded_step3d) is ROADMAP Queue 1 item 17b.
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import Callable, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..config import BC, CavityConfig, PlasmaConfig
from ..models import cavity
from ..models.plasma import PlasmaState, check_supported, plain_step
from ..ops import stream as stream_ops
from ..ops.cavity import collide_dirs, macros_guarded
from .mesh import _wire, block_walls, mesh_shape, pad_ring
from .poisson import solve_poisson_sharded


def validate_grid(cfg, mesh: DeviceMesh) -> None:
    """The grid must divide the mesh (cfg duck-typed: NY, NX)."""
    ny, nx = mesh_shape(mesh)
    if cfg.NY % ny or cfg.NX % nx:
        raise ValueError(
            f"grid {cfg.NY}x{cfg.NX} not divisible by mesh {ny}x{nx}")


def block(cfg, mesh: DeviceMesh, rank: int) -> Tuple[slice, slice]:
    """(rows, columns) of the lattice that `rank` owns."""
    validate_grid(cfg, mesh)
    ny, nx = mesh_shape(mesh)
    rows, cols = cfg.NY // ny, cfg.NX // nx
    by, bx = divmod(rank, nx)
    return (slice(by * rows, (by + 1) * rows),
            slice(bx * cols, (bx + 1) * cols))


def _block_of(t: torch.Tensor, rows: slice, cols: slice) -> torch.Tensor:
    return t[..., rows, cols].contiguous()


def _grid(NY: int, NX: int) -> SimpleNamespace:
    return SimpleNamespace(NY=NY, NX=NX)


PLASMA_FIELDS = ("f", "g", "Ex", "Ey", "phi")
CAVITY_FIELDS = ("f", "rho", "ux", "uy")


def _shard(state, mesh: DeviceMesh, fields):
    rows, cols = block(_grid(*getattr(state, fields[-1]).shape), mesh,
                       dist.get_rank())
    return state._replace(**{k: _block_of(getattr(state, k), rows, cols)
                             for k in fields})


def shard_state(state: PlasmaState, mesh: DeviceMesh) -> PlasmaState:
    """This rank's block of a full state (a copy, on the state's device)."""
    return _shard(state, mesh, PLASMA_FIELDS)


def shard_cavity_state(state, mesh: DeviceMesh):
    """This rank's rows of a full cavity state (f, rho, ux, uy: copies, on
    the state's device); the step counter is a host int and stays."""
    return _shard(state, mesh, CAVITY_FIELDS)


def _assemble(parts, mesh: DeviceMesh) -> torch.Tensor:
    """The full array of every rank's block, parts in rank order."""
    ny, nx = mesh_shape(mesh)
    t = parts[0]
    grid = _grid(t.shape[-2] * ny, t.shape[-1] * nx)
    out = t.new_empty(t.shape[:-2] + (grid.NY, grid.NX))
    for r, p in enumerate(parts):
        rows, cols = block(grid, mesh, r)
        out[..., rows, cols] = p
    return out


def _gather(t: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """All-gather every rank's block of one array into the full array."""
    parts = [torch.empty_like(t) for _ in range(mesh.size())]
    dist.all_gather([_wire(p) for p in parts], _wire(t.contiguous()))
    return _assemble(parts, mesh)


def gather_to_rank0(t: torch.Tensor, mesh: DeviceMesh):
    """Every rank's block of one array (..., rows, cols), assembled in
    mesh order on rank 0 (the others get None): one gather, no all-gather
    (the video's uint8 tiles, which only rank 0 writes)."""
    t = t.contiguous()
    mine = dist.get_rank() == 0
    parts = [torch.empty_like(t) for _ in range(mesh.size())] if mine else None
    dist.gather(t, parts, dst=0)
    return _assemble(parts, mesh) if mine else None


def gather_state(state: PlasmaState, mesh: DeviceMesh) -> PlasmaState:
    """The full state from every rank's block, on every rank."""
    return state._replace(**{k: _gather(getattr(state, k), mesh)
                             for k in PLASMA_FIELDS})


def gather_cavity_state(state, mesh: DeviceMesh):
    """The full cavity state from every rank's rows, on every rank (rank 0
    reads the centerlines, the Ghia check and the timing from it)."""
    return state._replace(**{k: _gather(getattr(state, k), mesh)
                             for k in CAVITY_FIELDS})


PLASMA3D_FIELDS = ("f", "g", "Ex", "Ey", "Ez", "phi")


def block3d(cfg, mesh: DeviceMesh, rank: int) -> Tuple[slice, slice]:
    """(slices, rows) of the column that `rank` owns on a (dz, dy) mesh
    (cfg duck-typed: NZ, NY)."""
    dz, dy = mesh_shape(mesh)
    if cfg.NZ % dz or cfg.NY % dy:
        raise ValueError(f"grid NZ x NY = {cfg.NZ}x{cfg.NY} not divisible "
                         f"by mesh {dz}x{dy}")
    nz, ny = cfg.NZ // dz, cfg.NY // dy
    bz, by = divmod(rank, dy)
    return (slice(bz * nz, (bz + 1) * nz), slice(by * ny, (by + 1) * ny))


def shard_state3d(state, mesh: DeviceMesh):
    """This rank's block of a full Plasma3DState (copies, on the state's
    device); the step counter is a host int and stays."""
    NZ, NY, _ = state.Ex.shape
    zs, ys = block3d(SimpleNamespace(NZ=NZ, NY=NY), mesh, dist.get_rank())
    return state._replace(**{k: getattr(state, k)[..., zs, ys, :].contiguous()
                             for k in PLASMA3D_FIELDS})


def _gather3d(t: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    dz, dy = mesh_shape(mesh)
    nz, ny = t.shape[-3], t.shape[-2]
    grid = SimpleNamespace(NZ=nz * dz, NY=ny * dy)
    parts = [torch.empty_like(t) for _ in range(dz * dy)]
    dist.all_gather([_wire(p) for p in parts], _wire(t.contiguous()))
    out = t.new_empty(t.shape[:-3] + (grid.NZ, grid.NY, t.shape[-1]))
    for r, p in enumerate(parts):
        zs, ys = block3d(grid, mesh, r)
        out[..., zs, ys, :] = p
    return out


def gather_state3d(state, mesh: DeviceMesh):
    """The full Plasma3DState from every rank's block, on every rank."""
    return state._replace(**{k: _gather3d(getattr(state, k), mesh)
                             for k in PLASMA3D_FIELDS})


# ---------------------------------------------------------------------------
# The sharded plain steps (lbm_tpu/parallel/sharding.py: make_sharded_step,
# make_sharded_cavity_step)
# ---------------------------------------------------------------------------

def make_sharded_step(cfg: PlasmaConfig, mesh: DeviceMesh
                      ) -> Callable[[PlasmaState], PlasmaState]:
    """One plasma step on this rank's block of a (dy, dx) mesh, for every
    solver (NONE, FFT, GS, SOR, NPS) and both wall types, native f64 and
    f32 or bf16 storage: models/plasma.plain_step, streaming from the
    block's ring with the walls the block holds, and solving on the block.
    The single-device plain step's quirks come along: the stale
    pre-collision f in f's corner holes, the post-collision f (plus the
    neutral's delta background) in g's, the debug variant's own.

    The collide is site-local: the plain ops on the plain backend, the
    collide-only kernel (kernels/collide_pallas.fused_collide) on the
    fused and pallas backends, where it raises if its build or launch
    fails. That kernel has no bf16 mode, as the TPU one has none, so bf16
    storage collides with the plain ops on the plain and fused backends
    and is refused on the pallas one, as make_step refuses it. The solves
    take the plain routes (parallel/poisson.solve_poisson_sharded), as
    lbm_tpu forces fft_engine = iter_engine = "xla" under GSPMD."""
    check_supported(cfg)
    if cfg.storage == "bf16" and cfg.backend == "pallas":
        raise ValueError("bf16 storage supports the plain and fused backends")
    validate_grid(cfg, mesh)
    ny, nx = mesh_shape(mesh)
    if cfg.bc != BC.PERIODIC and (cfg.NY // ny < 2 or cfg.NX // nx < 2):
        # efield_neumann's edge rows and columns copy their neighbours
        raise ValueError(f"grid {cfg.NY}x{cfg.NX} on mesh {ny}x{nx}: a "
                         f"walled block needs two rows and two columns")
    if cfg.compat.debug_variant and cfg.backend != "plain":
        raise ValueError("debug_variant mode is plain-backend only")
    walls = block_walls(mesh)

    def stream(f_post, g_post, f_holes, g_holes):
        out = []
        for p, h in zip(pad_ring([f_post, g_post], mesh), (f_holes, g_holes)):
            streamed = stream_ops.stream_padded(p)
            out.append(streamed if h is None else
                       stream_ops.bounceback_block(streamed, p, h, walls))
        return out

    def solve(cfg, rho_q, phi, Ex, Ey):
        return solve_poisson_sharded(cfg, rho_q, phi, Ex, Ey, mesh)

    return plain_step(cfg, cfg.backend in ("fused", "pallas")
                      and cfg.storage != "bf16", stream, solve)


def make_sharded_cavity_step(cfg: CavityConfig, mesh: DeviceMesh
                             ) -> Callable:
    """One cavity step on this rank's block of a (dy, dx) mesh: collide,
    pull-stream from the block's ring, the side walls on the blocks that
    hold x = 0 or x = NX-1, the bottom wall and the moving lid (at the
    host-side ramp's speed) on the blocks that hold the lattice's first
    and last rows, then the guarded macros. The plain ops on every backend
    (lbm_tpu runs its jnp step under GSPMD). The grid must divide the mesh
    (Ghia's 129^2 runs on a (1, 1) mesh only)."""
    validate_grid(cfg, mesh)
    cavity._check_supported(cfg)
    tau = cfg.tau
    bottom, top, left, right = block_walls(mesh)
    Q = stream_ops.Q

    def step(state):
        ff = cavity.decode_f(cfg, state.f)
        f_post = torch.stack(collide_dirs([ff[i] for i in range(Q)],
                                          state.rho, state.ux, state.uy,
                                          tau))
        (p,) = pad_ring([f_post], mesh)
        f = stream_ops.cavity_walls(
            stream_ops.stream_padded(p), f_post,
            cavity._lid_speed(cfg, state.step), 0 if bottom else -1,
            f_post.shape[-2] - 1 if top else -1, left, right)
        rho, ux, uy = macros_guarded([f[i] for i in range(Q)])
        return cavity.CavityState(cavity.encode_f(cfg, f), rho, ux, uy,
                                  state.step + 1)

    return step
