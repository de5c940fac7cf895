"""The Poisson solve of a sharded 2-D plasma step (counterpart of the GSPMD
partition of lbm_tpu/models/plasma._solve_poisson that
lbm_tpu/parallel/fused_sharded.py:93-97 relies on), and the three sharded
spectral solves of the 3-D column (the solve_fft_transposed and
solve_fft_2dsharded of lbm_tpu/parallel/fused_sharded.py's 3-D steps).

NONE is element-wise: models/plasma._solve_poisson runs on the shard as it
is (the compat flag that zeroes E included). FFT with periodic walls is a
slab decomposition over the dy ranks:

  1. rfft along x, on the rank's full rows;
  2. one all_to_all over the dy group transposes to full columns of a
     block of the NX//2 + 1 wavenumbers (the block count padded up to a
     multiple of the dy size);
  3. fft along y, times the float64-built inverse eigenvalues of
     ops/poisson (the single-device solve's), ifft along y;
  4. one all_to_all back;
  5. irfft along x to phi.

On a (y, x) mesh the ranks of each dx group first all-gather rho_q into
full-width row slabs, run the slab solve over their dy group, and keep
their own columns: every dx rank repeats its slab's transforms, which is
correct but does not scale (a pencil decomposition is later work). E is
ops/poisson.efield_periodic's central difference, with the neighbours'
edge columns and rows taken by ring_shift. cfg.fft_engine is not read: the
spectral kernel never runs sharded, as in the JAX package.

GS, SOR and NPS (the sharded plain step's, lbm_tpu/parallel/sharding.py:
make_sharded_step, whose GSPMD partition of ops/poisson.solve_gs and
solve_9point this is) sweep the block: before each colour pass phi gets
its one-cell ring (parallel/mesh.pad_ring; the 9-point pass reads the
corners), the colour masks are the single-device ones cut to the block,
and each sweep's error is all-reduced with MAX, so that every rank runs
the single-device stop test on the same number and stops at the same
sweep (ops/poisson.LAST_SWEEPS is the single-device count). cfg.iter_engine
is not read: the solve kernel never runs sharded, as lbm_tpu forces
iter_engine="xla" there. Under bounce-back E takes the Neumann closure on
the blocks that hold the lattice's edges.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..config import BC, PoissonSolver
from ..models.plasma import _iter_spec, _solve_poisson
from ..models.plasma3d import _spectral_inv3d_tensor
from ..ops import poisson as poisson_ops
from ..ops.poisson import _inverse_eigenvalues
from .mesh import (AXIS_X, AXIS_Y, AXIS_Z, _wire, block_walls, mesh_shape,
                   pad_ring, ring_shift)


def _all_to_all(t: torch.Tensor, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    """all_to_all_single over one mesh axis: chunk j of dim 0 goes to the
    axis' rank j, chunk i of the result came from its rank i."""
    if mesh.size(mesh.mesh_dim_names.index(axis)) == 1:
        return t.clone(memory_format=torch.contiguous_format)
    t = t.contiguous()
    out = torch.empty_like(t)
    dist.all_to_all_single(_wire(out), _wire(t), group=mesh.get_group(axis))
    return out


def _solve_slab(rho: torch.Tensor, mesh: DeviceMesh, NY: int
                ) -> torch.Tensor:
    """phi of this dy rank's full-width row slab rho (NY/ny, NX)."""
    ny = mesh.size(0)
    rows, NX = rho.shape
    H = NX // 2 + 1
    hb = -(-H // ny)                       # wavenumbers a dy rank holds
    R = torch.fft.rfft(rho, dim=1)         # (rows, H)
    if hb * ny > H:
        R = torch.cat([R, R.new_zeros(rows, hb * ny - H)], dim=1)
    cols = _all_to_all(R.reshape(rows, ny, hb).transpose(0, 1), mesh,
                       AXIS_Y).reshape(NY, hb)
    k0 = mesh.get_local_rank(AXIS_Y) * hb
    inv = rho.new_zeros(NY, hb)
    inv[:, :max(0, min(hb, H - k0))] = _inverse_eigenvalues(
        NY, NX, rho.dtype, rho.device)[:, k0:k0 + hb]
    cols = torch.fft.ifft(torch.fft.fft(cols, dim=0) * inv, dim=0)
    R = _all_to_all(cols.reshape(ny, rows, hb), mesh, AXIS_Y)
    R = R.transpose(0, 1).reshape(rows, ny * hb)[:, :H]
    return torch.fft.irfft(R, n=NX, dim=1).to(rho.dtype)


def solve_fft_sharded(rho_q: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """Spectral solve with periodic BCs of a sharded rho_q: this rank's
    block of the zero-mean phi."""
    ny, nx = mesh_shape(mesh)
    rows, cols = rho_q.shape
    if nx == 1:
        return _solve_slab(rho_q, mesh, rows * ny)
    parts = [torch.empty_like(rho_q) for _ in range(nx)]
    dist.all_gather(parts, rho_q.contiguous(), group=mesh.get_group(AXIS_X))
    phi = _solve_slab(torch.cat(parts, dim=1), mesh, rows * ny)
    x0 = mesh.get_local_rank(AXIS_X) * cols
    return phi[:, x0:x0 + cols].contiguous()


def efield_periodic_sharded(phi: torch.Tensor, mesh: DeviceMesh
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """ops/poisson.efield_periodic on a sharded phi: the column left and
    right of the block come from the dx ring, the rows above and below
    from the dy ring (the block's own wrap on an axis of size 1)."""
    (left,) = ring_shift([phi[:, -1:]], mesh, AXIS_X, 1)
    (right,) = ring_shift([phi[:, :1]], mesh, AXIS_X, -1)
    (above,) = ring_shift([phi[-1:, :]], mesh, AXIS_Y, 1)
    (below,) = ring_shift([phi[:1, :]], mesh, AXIS_Y, -1)
    px = torch.cat([left, phi, right], dim=1)
    py = torch.cat([above, phi, below], dim=0)
    Ex = -0.5 * (px[:, 2:] - px[:, :-2])
    Ey = -0.5 * (py[2:] - py[:-2])
    return Ex, Ey


def efield_neumann_sharded(phi: torch.Tensor, mesh: DeviceMesh
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """ops/poisson.efield_neumann on a sharded phi: the central difference
    of efield_periodic_sharded, then the copy-to-edge closure on the
    blocks that hold the lattice's edges, rows first, then columns (the
    single-device order, corners included). The block needs two rows and
    two columns (make_sharded_step checks)."""
    Ex, Ey = efield_periodic_sharded(phi, mesh)
    bottom, top, left, right = block_walls(mesh)
    for E in (Ex, Ey):
        if bottom:
            E[0, :] = E[1, :]
        if top:
            E[-1, :] = E[-2, :]
        if left:
            E[:, 0] = E[:, 1]
        if right:
            E[:, -1] = E[:, -2]
    return Ex, Ey


def _max_over_ranks(err: torch.Tensor) -> torch.Tensor:
    """The largest of every rank's 0-dim err, NaN if any rank's is NaN
    (jnp.max and torch's max propagate NaN; an all-reduce MAX need not):
    one all-reduce of (err, isnan)."""
    if dist.get_world_size() == 1:
        return err
    nan = err.isnan()
    t = torch.stack([torch.where(nan, torch.zeros_like(err), err),
                     nan.to(err.dtype)])
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return torch.where(t[1] > 0, torch.full_like(err, float("nan")), t[0])


def solve_iter_sharded(phi0: torch.Tensor, rho_q: torch.Tensor,
                       mesh: DeviceMesh, spec) -> torch.Tensor:
    """ops/poisson.solve_gs (GS, or SOR with an omega) or solve_9point
    (NPS) on this rank's block of phi and rho_q; spec is
    kernels/poisson_iter's (kind, omega, max_iter, tol, interior_only).
    Bitwise the single-device sweeps' block, with their sweep count."""
    kind, omega, max_iter, tol, interior_only = spec
    n, m = rho_q.shape
    ny, nx = mesh_shape(mesh)
    y0 = mesh.get_local_rank(AXIS_Y) * n
    x0 = mesh.get_local_rank(AXIS_X) * m
    masks = (poisson_ops._checker_masks if kind == "gs"
             else poisson_ops._four_color_masks)(nx * m, ny * n,
                                                 interior_only)
    masks = [torch.as_tensor(k[y0:y0 + n, x0:x0 + m], device=rho_q.device)
             for k in masks]

    def ring(phi):
        return pad_ring([phi], mesh)[0]

    if kind == "gs":
        def sweep(phi):
            phi, e1 = poisson_ops._gs_pass(
                phi, poisson_ops._nb5_padded(ring(phi)), rho_q, masks[0],
                omega)
            phi, e2 = poisson_ops._gs_pass(
                phi, poisson_ops._nb5_padded(ring(phi)), rho_q, masks[1],
                omega)
            return phi, _max_over_ranks(torch.maximum(e1, e2))
    else:
        twenty = torch.tensor(20.0, dtype=rho_q.dtype, device=rho_q.device)

        def sweep(phi):
            err = torch.zeros((), dtype=phi.dtype, device=phi.device)
            for mask in masks:
                p = ring(phi)
                phi, e = poisson_ops._nps_pass(
                    phi, poisson_ops._nb5_padded(p),
                    poisson_ops._nb_diag_padded(p), rho_q, mask, twenty)
                err = torch.maximum(err, e)
            return phi, _max_over_ranks(err)

    return poisson_ops._iterate(phi0, sweep, max_iter, tol)


def solve_poisson_sharded(cfg, rho_q: torch.Tensor, phi: torch.Tensor,
                          Ex: torch.Tensor, Ey: torch.Tensor,
                          mesh: DeviceMesh
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(Ex, Ey, phi) of this rank's block after the step's solve, with
    models/plasma._solve_poisson's quirks: NONE as on one device (the
    compat flag that zeroes E included); FFT under bounce-back the
    reference's no-op (E keeps its value); FFT with periodic walls by the
    slab solve; GS, SOR and NPS by solve_iter_sharded, E following the
    walls."""
    sol = cfg.poisson
    if sol == PoissonSolver.NONE:
        return _solve_poisson(cfg, rho_q, phi, Ex, Ey)
    periodic_bc = cfg.bc == BC.PERIODIC
    if sol == PoissonSolver.FFT:
        if not periodic_bc:
            return Ex, Ey, phi
        phi = solve_fft_sharded(rho_q, mesh)
    else:
        phi = solve_iter_sharded(phi, rho_q, mesh,
                                 _iter_spec(cfg, periodic_bc))
    Ex, Ey = (efield_periodic_sharded(phi, mesh) if periodic_bc
              else efield_neumann_sharded(phi, mesh))
    return Ex, Ey, phi


# ---------------------------------------------------------------------------
# The 3-D column on a (dz, dy) mesh. Each solve keeps every 1-D transform on
# an axis the rank holds whole and moves the lattice between transforms with
# all_to_all over one mesh axis, in the JAX step's order: a z-shard takes
# x and y, swaps z<->y and takes z; a y-shard takes x and z, swaps y<->z
# and takes y; a (dz, dy) tile takes x, swaps y<->x over dy for y, then
# z<->y over dz for z. Each inverse retraces its swaps. The product with
# the float64-built inverse eigenvalues (models/plasma3d.spectral_inv3d)
# runs on the rank's block of wavenumbers. The order rounds otherwise than
# the single-device rfftn, by ~1e-15 of scale.
# ---------------------------------------------------------------------------

def _size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def _swap(h: torch.Tensor, mesh: DeviceMesh, axis: str, split: int,
          gather: int) -> torch.Tensor:
    """all_to_all over one mesh axis of n ranks: dim `split`, whole here,
    is cut into n blocks (zero-padded up to a multiple of n), block j going
    to the axis' rank j; dim `gather`, this rank's block, comes back whole,
    the ranks' blocks in order."""
    n = _size(mesh, axis)
    if n == 1:
        return h
    L = h.shape[split]
    blk = -(-L // n)
    if blk * n != L:
        pad = list(h.shape)
        pad[split] = blk * n - L
        h = torch.cat([h, h.new_zeros(pad)], dim=split)
    x = h.movedim(split, 0)
    x = _all_to_all(x.reshape(n, blk, *x.shape[1:]), mesh, axis)
    g = 2 + (gather if gather < split else gather - 1)
    x = x.movedim(0, g - 1)   # the source rank just before `gather`
    x = x.reshape(*x.shape[:g - 1], -1, *x.shape[g + 1:])
    return x.movedim(0, split)


def _inv_block(h: torch.Tensor, grid, mesh: DeviceMesh, blocks
               ) -> torch.Tensor:
    """This rank's block of the inverse eigenvalues on h's wavenumbers:
    blocks maps a dim of (kz, ky, kx) to the mesh axis whose rank index
    picks its block (the dim's length on h; padding zero)."""
    inv = _spectral_inv3d_tensor(*grid, h.real.dtype, h.device)
    for dim, axis in blocks.items():
        blk = h.shape[dim]
        pad = list(inv.shape)
        pad[dim] = blk * _size(mesh, axis) - inv.shape[dim]
        if pad[dim]:
            inv = torch.cat([inv, inv.new_zeros(pad)], dim=dim)
        inv = inv.narrow(dim, mesh.get_local_rank(axis) * blk, blk)
    return inv


def _real(h: torch.Tensor, NX: int, dtype) -> torch.Tensor:
    """The inverse x transform, as a contiguous phi (the FFTs may hand back
    permuted strides, and the kernels take contiguous fields)."""
    return torch.fft.irfft(h, n=NX, dim=2).to(dtype).contiguous()


def solve_fft3d_z(rho_q: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """phi of a z-shard's rho_q (NZl, NY, NX) on an (n, 1) mesh."""
    NZl, NY, NX = rho_q.shape
    grid = (NZl * _size(mesh, AXIS_Z), NY, NX)
    h = torch.fft.fft(torch.fft.rfft(rho_q, dim=2), dim=1)
    h = _swap(h, mesh, AXIS_Z, split=1, gather=0)
    h = torch.fft.fft(h, dim=0)
    h = torch.fft.ifft(h * _inv_block(h, grid, mesh, {1: AXIS_Z}), dim=0)
    h = _swap(h, mesh, AXIS_Z, split=0, gather=1)[:, :NY]
    h = torch.fft.ifft(h, dim=1)
    return _real(h, NX, rho_q.dtype)


def solve_fft3d_y(rho_q: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """phi of a y-shard's rho_q (NZ, NYl, NX) on a (1, n) mesh."""
    NZ, NYl, NX = rho_q.shape
    grid = (NZ, NYl * _size(mesh, AXIS_Y), NX)
    h = torch.fft.fft(torch.fft.rfft(rho_q, dim=2), dim=0)
    h = _swap(h, mesh, AXIS_Y, split=0, gather=1)
    h = torch.fft.fft(h, dim=1)
    h = torch.fft.ifft(h * _inv_block(h, grid, mesh, {0: AXIS_Y}), dim=1)
    h = _swap(h, mesh, AXIS_Y, split=1, gather=0)[:NZ]
    h = torch.fft.ifft(h, dim=0)
    return _real(h, NX, rho_q.dtype)


def solve_fft3d_yz(rho_q: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """phi of a (dz, dy) tile's rho_q (NZl, NYl, NX)."""
    NZl, NYl, NX = rho_q.shape
    NY = NYl * _size(mesh, AXIS_Y)
    grid = (NZl * _size(mesh, AXIS_Z), NY, NX)
    h = torch.fft.rfft(rho_q, dim=2)
    H = h.shape[2]
    h = torch.fft.fft(_swap(h, mesh, AXIS_Y, split=2, gather=1), dim=1)
    h = torch.fft.fft(_swap(h, mesh, AXIS_Z, split=1, gather=0), dim=0)
    h = h * _inv_block(h, grid, mesh, {1: AXIS_Z, 2: AXIS_Y})
    h = _swap(torch.fft.ifft(h, dim=0), mesh, AXIS_Z, split=0, gather=1)
    h = torch.fft.ifft(h[:, :NY], dim=1)
    h = _swap(h, mesh, AXIS_Y, split=1, gather=2)[..., :H]
    return _real(h, NX, rho_q.dtype)


def efield_periodic3d_sharded(phi: torch.Tensor, mesh: DeviceMesh
                              ) -> Tuple[torch.Tensor, ...]:
    """models/plasma3d.efield_periodic3d on a sharded phi: x is whole; the
    slices above and below the block come from the dz ring, its edge rows'
    neighbours from the dy ring (the block's own wrap on an axis of size
    1)."""
    (up,) = ring_shift([phi[-1:]], mesh, AXIS_Z, 1)
    (dn,) = ring_shift([phi[:1]], mesh, AXIS_Z, -1)
    (above,) = ring_shift([phi[:, -1:]], mesh, AXIS_Y, 1)
    (below,) = ring_shift([phi[:, :1]], mesh, AXIS_Y, -1)
    pz = torch.cat([up, phi, dn], dim=0)
    py = torch.cat([above, phi, below], dim=1)
    Ex = -0.5 * (torch.roll(phi, -1, 2) - torch.roll(phi, 1, 2))
    Ey = -0.5 * (py[:, 2:] - py[:, :-2])
    Ez = -0.5 * (pz[2:] - pz[:-2])
    return Ex, Ey, Ez
