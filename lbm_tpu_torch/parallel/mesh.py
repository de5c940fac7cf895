"""The (dy, dx) device mesh over torch.distributed, and ring exchanges on
its axes (counterpart of lbm_tpu/parallel/mesh.py, and of the
jax.lax.ppermute rings of lbm_tpu/parallel/fused_sharded.py).

One process per device, launched by torchrun (or any launcher that sets
RANK, WORLD_SIZE and LOCAL_RANK). Rank r owns block (r // nx, r % nx) of
an (ny, nx) mesh: the row-major order of JAX's devices.reshape(ny, nx). On
CUDA devices the group is NCCL, one device a rank (cuda:LOCAL_RANK); gloo
is used only when the caller asks for the CPU.
"""
from __future__ import annotations

import math
import os
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

AXIS_Y = "dy"
AXIS_X = "dx"


def factor_2d(n: int) -> Tuple[int, int]:
    """Factor n devices into the most-square (ny, nx) grid."""
    best = (1, n)
    for a in range(1, int(math.isqrt(n)) + 1):
        if n % a == 0:
            best = (a, n // a)
    return best


def init_distributed(device, init_method: Optional[str] = None,
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None) -> torch.device:
    """Join the default process group and return this rank's device.

    rank and world_size default to torchrun's RANK and WORLD_SIZE, and
    init_method to torchrun's env:// rendezvous. A CUDA `device` means NCCL
    on cuda:LOCAL_RANK; "cpu" means gloo. A group that is already
    initialised is kept."""
    device = torch.device(device)
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"device {device}: want cuda or cpu")
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA device was asked for, but none is "
                               "available")
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        rank = int(os.environ["RANK"]) if rank is None else rank
        world_size = (int(os.environ["WORLD_SIZE"]) if world_size is None
                      else world_size)
        dist.init_process_group(
            "nccl" if device.type == "cuda" else "gloo",
            init_method=init_method or "env://", rank=rank,
            world_size=world_size)
    return device


def make_mesh(shape: Optional[Tuple[int, int]] = None,
              device_type: str = "cuda") -> DeviceMesh:
    """2-D mesh (AXIS_Y, AXIS_X) over the initialised default group; shape
    defaults to factor_2d(world size)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(init_distributed)")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_mesh: device_type 'cuda' without a CUDA "
                           "device")
    n = dist.get_world_size()
    ny, nx = factor_2d(n) if shape is None else shape
    if ny * nx != n:
        raise ValueError(f"mesh shape {(ny, nx)} != {n} ranks")
    return init_device_mesh(device_type, (ny, nx),
                            mesh_dim_names=(AXIS_Y, AXIS_X))


def mesh_shape(mesh: DeviceMesh) -> Tuple[int, int]:
    """(ny, nx) of a (dy, dx) mesh."""
    return mesh.size(0), mesh.size(1)


def _neighbour(mesh: DeviceMesh, axis: str, step: int) -> int:
    """Global rank `step` places ahead of this rank along `axis` (ring)."""
    dim = mesh.mesh_dim_names.index(axis)
    coord = list(mesh.get_coordinate())
    coord[dim] = (coord[dim] + step) % mesh.size(dim)
    return int(mesh.mesh[tuple(coord)])


def _wire(t: torch.Tensor) -> torch.Tensor:
    """A view of t that every backend carries: complex as pairs of reals."""
    return torch.view_as_real(t) if t.is_complex() else t


def ring_shift(tensors: Sequence[torch.Tensor], mesh: DeviceMesh, axis: str,
               step: int) -> List[torch.Tensor]:
    """jax.lax.ppermute over a ring on one mesh axis: each rank sends its
    tensors to the rank `step` ahead and receives the tensors of the rank
    `step` behind, all in one batch_isend_irecv. The sent slices are made
    contiguous first (column strips are strided). On an axis of size 1 the
    result is the rank's own tensors, copied, with no collective."""
    dim = mesh.mesh_dim_names.index(axis)
    if mesh.size(dim) == 1:
        return [t.clone(memory_format=torch.contiguous_format)
                for t in tensors]
    group = mesh.get_group(axis)
    ahead, behind = _neighbour(mesh, axis, step), _neighbour(mesh, axis, -step)
    sends = [t.contiguous() for t in tensors]
    recvs = [torch.empty_like(t) for t in sends]
    # sends and receives in one order: on a ring of two the peer ahead and
    # the peer behind are one rank, which pairs them in posting order
    ops = [dist.P2POp(dist.isend, _wire(t), ahead, group) for t in sends]
    ops += [dist.P2POp(dist.irecv, _wire(t), behind, group) for t in recvs]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return recvs
