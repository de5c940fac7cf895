"""The 3-D step's y-shard and (dz, dy) tile forms (counterparts of
lbm_tpu/kernels/fused_panel3d.py:collide_stream_panel3d with halo_rows, and
collide_stream_panel3d_zhalo).

The JAX module cuts each z-slice into (ty, NX) y-panels so that 512^2 and
wider cross-sections fit the TPU's VMEM; the CUDA kernels take any
cross-section, so there is no panel here. collide_stream_panel3d without
halo_rows is collide_stream3d (kernels/fused_step3d). With the ten rows
of a y-shard, and in collide_stream_panel3d_zhalo, it runs the halo kernel
of csrc/fused_step3d.cu (kernels/fused_step3d.halo3d) in its y-halo and
tile geometries, or on CPU tensors that kernel's plain version; launches
count in fused_step3d.HALO_LAUNCHES under the TPU kernel's name.

pick_panel3d and check_vmem measure the TPU's VMEM and are not ported. The
panel rule they enforce is kept, because the JAX package refuses with it:
the panel height (`panel`, or the largest of 256, 128, ..., 8 that divides
NY) must divide the shard's NY and be a multiple of 8.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from . import fused_step3d
from .fused_step3d import halo3d, halo3d_reference

_PANELS = (256, 128, 64, 32, 16, 8)


def check_panel(NY: int, NX: int, panel: int = 0) -> int:
    """The panel height JAX's kernels would take for an (NY, NX) shard
    cross-section; raises ValueError where they refuse the shape."""
    ty = panel or next((t for t in _PANELS if NY % t == 0), 0)
    if not panel and not ty:
        raise ValueError(f"no feasible 3-D panel height for {NY}x{NX} "
                         f"cross-sections")
    if ty < 8 or ty % 8 or NY % ty:
        raise ValueError(f"panel height {ty} invalid for NY={NY} "
                         f"(must divide NY and be a multiple of 8)")
    return ty


def _strips(t: Sequence[torch.Tensor], what: str, n: int):
    """A flat tuple of n 5-tuples (f, g, Ex, Ey, Ez), JAX's layout."""
    if len(t) != 5 * n:
        raise ValueError(f"{what} holds {len(t)} arrays, want {5 * n}")
    return tuple(tuple(t[5 * k:5 * k + 5]) for k in range(n))


def collide_stream_panel3d_reference(f, g, Ex, Ey, Ez, *, halo_rows=None,
                                     **phys):
    """Plain version of collide_stream_panel3d."""
    if halo_rows is None:
        return fused_step3d.collide_stream3d_reference(f, g, Ex, Ey, Ez,
                                                       **phys)
    return halo3d_reference((f, g, Ex, Ey, Ez), None,
                            _strips(halo_rows, "halo_rows", 2), None, **phys)


def collide_stream_panel3d(
    f: torch.Tensor,   # (3, Q, NZ, NY, NX)
    g: torch.Tensor,
    Ex: torch.Tensor,  # (NZ, NY, NX)
    Ey: torch.Tensor,
    Ez: torch.Tensor,
    *,
    taus: Tuple[float, ...],
    q_e: float, q_i: float, m_e: float, m_i: float,
    cs2: float, kb: float,
    neutral_ref: float = 0.0,
    panel: int = 0,
    halo_rows: Optional[Sequence[torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(f_streamed, g_streamed, rho_q), collide_stream3d's contract.

    halo_rows: None for a periodic lattice (collide_stream3d). For a
    y-sharded one, the tuple (up_f, up_g, up_Ex, up_Ey, up_Ez, dn_f, dn_g,
    dn_Ex, dn_Ey, dn_Ez) of pre-collision neighbour rows: up_* the row just
    above the shard (the previous rank's last row), dn_* the row just below
    (the next rank's first); pops (3, 19, NZ, NX), fields (NZ, NX). z and x
    wrap inside the shard."""
    phys = dict(taus=tuple(taus), q_e=q_e, q_i=q_i, m_e=m_e, m_i=m_i,
                cs2=cs2, kb=kb, neutral_ref=neutral_ref)
    check_panel(f.shape[-2], f.shape[-1], panel)
    if halo_rows is None:
        return fused_step3d.collide_stream3d(f, g, Ex, Ey, Ez, **phys)
    return halo3d("collide_stream_panel3d", (f, g, Ex, Ey, Ez), None,
                  _strips(halo_rows, "halo_rows", 2), None, phys)


def _zhalo_strips(zhalo, yrows, corners_up, corners_dn):
    return (_strips(zhalo, "zhalo", 2), _strips(yrows, "yrows", 2),
            _strips(corners_up, "corners_up", 2)
            + _strips(corners_dn, "corners_dn", 2))


def collide_stream_panel3d_zhalo_reference(f, g, Ex, Ey, Ez, zhalo, yrows,
                                           corners_up, corners_dn, **phys):
    """Plain version of collide_stream_panel3d_zhalo."""
    return halo3d_reference((f, g, Ex, Ey, Ez),
                            *_zhalo_strips(zhalo, yrows, corners_up,
                                           corners_dn), **phys)


def collide_stream_panel3d_zhalo(
    f: torch.Tensor,   # (3, Q, NZ_local, NY_local, NX)
    g: torch.Tensor,
    Ex: torch.Tensor,  # (NZ_local, NY_local, NX)
    Ey: torch.Tensor,
    Ez: torch.Tensor,
    zhalo: Sequence[torch.Tensor],
    yrows: Sequence[torch.Tensor],
    corners_up: Sequence[torch.Tensor],
    corners_dn: Sequence[torch.Tensor],
    *,
    taus: Tuple[float, ...],
    q_e: float, q_i: float, m_e: float, m_i: float,
    cs2: float, kb: float,
    neutral_ref: float = 0.0,
    panel: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The step of one shard of a (dz, dy) mesh: explicit slices, rows and
    corner lines, no wrap but x's. All pre-collision, in JAX's layouts:
      zhalo      = (up_f, up_g, up_Ex, up_Ey, up_Ez, dn_f, ..., dn_Ez): the
                   slice just above (the previous z-shard's last) and just
                   below; pops (3, 19, NY, NX), fields (NY, NX);
      yrows      = the same layout with the rows just above and below the
                   shard; pops (3, 19, NZ, NX), fields (NZ, NX);
      corners_up = (above_f, ..., above_Ez, below_f, ..., below_Ez): the
                   rows just above and below the shard inside the up
                   slice; pops (3, 19, NX), fields (NX,);
      corners_dn = the same inside the down slice."""
    phys = dict(taus=tuple(taus), q_e=q_e, q_i=q_i, m_e=m_e, m_i=m_i,
                cs2=cs2, kb=kb, neutral_ref=neutral_ref)
    check_panel(f.shape[-2], f.shape[-1], panel)
    return halo3d("collide_stream_panel3d_zhalo", (f, g, Ex, Ey, Ez),
                  *_zhalo_strips(zhalo, yrows, corners_up, corners_dn), phys)


def collide_stream_shard3d(
        shard, zhalo, yrows, corners, **phys
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The public step of the shard's geometry on strips in the halo form's
    layout (fused_step3d.halo_inputs3d): collide_stream_halo3d on a
    z-shard, collide_stream_panel3d with halo_rows on a y-shard,
    collide_stream_panel3d_zhalo on a tile."""
    if yrows is None:
        return fused_step3d.collide_stream_halo3d(
            *shard, *(t.unsqueeze(-3) for t in zhalo[0] + zhalo[1]), **phys)
    if zhalo is None:
        return collide_stream_panel3d(*shard, halo_rows=yrows[0] + yrows[1],
                                      **phys)
    return collide_stream_panel3d_zhalo(
        *shard, zhalo[0] + zhalo[1], yrows[0] + yrows[1],
        corners[0] + corners[1], corners[2] + corners[3], **phys)
