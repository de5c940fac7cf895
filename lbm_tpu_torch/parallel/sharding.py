"""Block placement of the 2-D plasma state on a (dy, dx) mesh, and of the
cavity state on a (dy, 1) mesh (counterpart of the placement half of
lbm_tpu/parallel/sharding.py: validate_grid, state_shardings/shard_state,
cavity_state_shardings/shard_cavity_state).

Each rank holds its block of the (NY, NX) lattice: rows
[by * NY/ny, (by + 1) * NY/ny) and columns [bx * NX/nx, (bx + 1) * NX/nx)
of the populations (3, 9, NY, NX) and of the fields (NY, NX), where
(by, bx) = (rank // nx, rank % nx). shard_state cuts a full state into
this rank's block; gather_state all-gathers the blocks back into the full
state on every rank (the tests and the CLI's outputs read it).
shard_cavity_state and gather_cavity_state do the same for the cavity's
(f, rho, ux, uy).

The JAX module's GSPMD steps (make_sharded_step for any solver and wall,
make_sharded_step3d, make_sharded_cavity_step) hold no kernel and are not
ported here; ROADMAP Queue 1 item 17 brings them.
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..models.plasma import PlasmaState
from .mesh import _wire, mesh_shape


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


def _gather(t: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """All-gather every rank's block of one array into the full array."""
    ny, nx = mesh_shape(mesh)
    grid = _grid(t.shape[-2] * ny, t.shape[-1] * nx)
    parts = [torch.empty_like(t) for _ in range(ny * nx)]
    dist.all_gather([_wire(p) for p in parts], _wire(t.contiguous()))
    out = t.new_empty(t.shape[:-2] + (grid.NY, grid.NX))
    for r, p in enumerate(parts):
        rows, cols = block(grid, mesh, r)
        out[..., rows, cols] = p
    return out


def gather_state(state: PlasmaState, mesh: DeviceMesh) -> PlasmaState:
    """The full state from every rank's block, on every rank."""
    return state._replace(**{k: _gather(getattr(state, k), mesh)
                             for k in PLASMA_FIELDS})


def gather_cavity_state(state, mesh: DeviceMesh):
    """The full cavity state from every rank's rows, on every rank (rank 0
    reads the centerlines, the Ghia check and the timing from it)."""
    return state._replace(**{k: _gather(getattr(state, k), mesh)
                             for k in CAVITY_FIELDS})
