"""collide_stream3d: the periodic D3Q19 collide + push-stream step of the
3-D plasma column in one kernel (counterpart of
lbm_tpu/kernels/fused_step3d.py:collide_stream3d), and its halo form for a
z-shard, collide_stream_halo3d (the JAX function of the same name).

On CUDA tensors the wrapper launches the hand-written kernel in
csrc/fused_step3d.cu, or raises; on CPU tensors it runs the plain version,
collide_stream3d_reference (ops/d3 update_macro3 + collide3 +
stream_periodic3 in eager torch), which the tests compare with the JAX
package and which the chip smoke test compares with the kernel. LAUNCHES
counts kernel launches.

The halo form runs csrc/fused_step3d.cu's second entry, which also serves
kernels/fused_panel3d's y-shard and (dz, dy) tile steps: one kernel in
three geometries, counted in HALO_LAUNCHES under the TPU kernel's name.

The launch writes fresh output buffers (a push-stream in place races on a
GPU), where the TPU kernel aliases its outputs onto f and g. The launch,
its input checks and the kernel's constants (HostParams, folded in double
with ops/d3's expressions) are the 2-D kernel's (kernels/fused_step.py).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from ..constants import D3Q19
from ..ops.d3 import collide3, stream_periodic3, update_macro3
from .fused_step import (_MODES, _check_inputs, _library_and_params,
                         launch_collide)

LAUNCHES = 0
HALO_LAUNCHES = {"collide_stream_halo3d": 0, "collide_stream_panel3d": 0,
                 "collide_stream_panel3d_zhalo": 0}


def collide_stream3d_reference(
    f: torch.Tensor, g: torch.Tensor, Ex: torch.Tensor, Ey: torch.Tensor,
    Ez: torch.Tensor, *, taus, q_e: float, q_i: float, m_e: float,
    m_i: float, cs2: float, kb: float, neutral_ref: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version: populations upcast to Ex's dtype, update_macro3 +
    collide3 (bf16 storage: the partial-fraction thermal form with the exact
    reciprocal 1/x) + stream_periodic3, rounded to the storage dtype once,
    at the end. Returns (f, g, rho_q)."""
    fc, gc = f.to(Ex.dtype), g.to(Ex.dtype)
    mac = update_macro3(fc, gc, Ex, Ey, Ez, q_e=q_e, q_i=q_i, m_e=m_e,
                        m_i=m_i, neutral_ref=neutral_ref)
    f_post, g_post = collide3(
        fc, gc, mac, Ex, Ey, Ez, taus=taus, q_e=q_e, q_i=q_i, m_e=m_e,
        m_i=m_i, cs2=cs2, kb=kb, neutral_ref=neutral_ref,
        g_recip=(lambda x: 1.0 / x) if f.dtype == torch.bfloat16 else None)
    return (stream_periodic3(f_post).to(f.dtype),
            stream_periodic3(g_post).to(g.dtype), mac.rho_q)


def collide_stream3d(
    f: torch.Tensor,   # (3, 19, NZ, NY, NX)
    g: torch.Tensor,
    Ex: torch.Tensor,  # (NZ, NY, NX)
    Ey: torch.Tensor,
    Ez: torch.Tensor,
    *,
    taus: Tuple[float, ...],
    q_e: float, q_i: float, m_e: float, m_i: float,
    cs2: float, kb: float,
    neutral_ref: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(f_streamed, g_streamed, rho_q) in one pass. Periodic BC."""
    global LAUNCHES
    phys = dict(taus=tuple(taus), q_e=q_e, q_i=q_i, m_e=m_e, m_i=m_i,
                cs2=cs2, kb=kb, neutral_ref=neutral_ref)
    if f.device.type == "cpu":
        return collide_stream3d_reference(f, g, Ex, Ey, Ez, **phys)
    out = launch_collide("lbm_plasma3d_collide_stream", _MODES, f, g,
                         (Ex, Ey, Ez), phys)
    LAUNCHES += 1
    return out


# ---------------------------------------------------------------------------
# The halo form. A shard of the (NZ, NY, NX) column, NX whole, is extended by
# its neighbours' pre-collision strips (the strip contract of
# lbm_tpu/kernels/fused_step3d.py:collide_stream_halo3d and
# fused_panel3d.py:collide_stream_panel3d, _zhalo); each strip is a 5-tuple
# (f, g, Ex, Ey, Ez):
#   zhalo   (up, dn): the slices z0 - 1 and z0 + NZl, pops (3, 19, NYl, NX),
#           fields (NYl, NX); None on a y-shard, whose z wraps;
#   yrows   (up, dn): the rows y0 - 1 and y0 + NYl, pops (3, 19, NZl, NX),
#           fields (NZl, NX); None on a z-shard, whose y wraps;
#   corners (up_above, up_below, dn_above, dn_below): on a tile, the rows
#           y0 - 1 ("above") and y0 + NYl ("below") of the slices z0 - 1
#           ("up") and z0 + NZl ("dn"), pops (3, 19, NX), fields (NX,).
# ---------------------------------------------------------------------------

Strip = Tuple[torch.Tensor, ...]


def _check_halo3d(name, shard: Strip, zhalo, yrows, corners) -> None:
    """Validate a halo call's shapes, dtypes and devices (the shard's own
    CUDA checks are _check_inputs')."""
    f, _, Ex = shard[:3]
    if f.dim() != 5 or Ex.dim() != 3:
        raise ValueError(f"{name}: want f (3, 19, NZ, NY, NX) and Ex (NZ, NY, "
                         f"NX), got {tuple(f.shape)} and {tuple(Ex.shape)}")
    NZ, NY, NX = Ex.shape
    pops, fields = [], []
    strips = []
    if zhalo is not None:
        strips += [("slice " + k, s, (NY, NX)) for k, s in zip(("up", "dn"),
                                                             zhalo)]
    if yrows is not None:
        strips += [("row " + k, s, (NZ, NX)) for k, s in zip(("up", "dn"),
                                                           yrows)]
    if corners is not None:
        strips += [("corner " + k, s, (NX,)) for k, s in zip(
            ("up above", "up below", "dn above", "dn below"), corners)]
    for side, strip, grid in [("shard", shard, (NZ, NY, NX))] + strips:
        if len(strip) != 5:
            raise ValueError(f"{name}: the {side} strip has {len(strip)} "
                             f"arrays, want (f, g, Ex, Ey, Ez)")
        want = [(3, D3Q19.Q, *grid)] * 2 + [grid] * 3
        shapes = [tuple(t.shape) for t in strip]
        if shapes != want:
            raise ValueError(f"{name}: {side} strip shapes {shapes} do not "
                             f"fit the shard {tuple(f.shape)}; want {want}")
        pops += strip[:2]
        fields += strip[2:]
    if any(t.dtype != f.dtype for t in pops) or any(
            t.dtype != Ex.dtype for t in fields):
        raise TypeError(f"{name}: strips must have the shard's dtypes "
                        f"({f.dtype}, {Ex.dtype})")
    if len({t.device for t in pops + fields}) != 1:
        raise ValueError(f"{name}: the shard and its strips must lie on one "
                         f"device")


def _extended(shard: Strip, zhalo, yrows, corners) -> Strip:
    """The shard's five arrays extended by their strips: the block the halo
    kernel's threads cover, (NZl + 2 zh, NYl + 2 yh, NX)."""
    out = []
    for k, a in enumerate(shard):
        if yrows is not None:
            a = torch.cat([yrows[0][k].unsqueeze(-2), a,
                           yrows[1][k].unsqueeze(-2)], dim=-2)
        if zhalo is not None:
            up, dn = zhalo[0][k], zhalo[1][k]
            if corners is not None:
                up = torch.cat([corners[0][k].unsqueeze(-2), up,
                                corners[1][k].unsqueeze(-2)], dim=-2)
                dn = torch.cat([corners[2][k].unsqueeze(-2), dn,
                                corners[3][k].unsqueeze(-2)], dim=-2)
            a = torch.cat([up.unsqueeze(-3), a, dn.unsqueeze(-3)], dim=-3)
        out.append(a)
    return tuple(out)


def halo3d_reference(shard: Strip, zhalo, yrows, corners, **phys
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the halo kernel in each geometry: the extended block
    through collide_stream3d_reference (its periodic wrap only moves values
    into the block's border), cropped to the shard. Bitwise equal to
    collide_stream3d_reference on the full grid at the shard's sites."""
    f, g, rho_q = collide_stream3d_reference(
        *_extended(shard, zhalo, yrows, corners), **phys)
    zs = slice(1, -1) if zhalo is not None else slice(None)
    ys = slice(1, -1) if yrows is not None else slice(None)
    return (f[..., zs, ys, :].contiguous(), g[..., zs, ys, :].contiguous(),
            rho_q[zs, ys, :].contiguous())


def _launch_halo3d(name: str, shard: Strip, zhalo, yrows, corners,
                   phys: dict
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch lbm_plasma3d_collide_stream_halo on the shard and its strips
    into fresh (f, g, rho_q) buffers and count it under `name`; raises if
    the build or the launch fails."""
    f, g, Ex = shard[0], shard[1], shard[2]
    mode = _check_inputs(name, _MODES, *shard)
    groups = [shard, *(zhalo or (None, None)), *(yrows or (None, None)),
              *(corners or (None,) * 4)]
    tensors = [t for grp in groups for t in (grp or (None,) * 5)]
    if not all(t.is_contiguous() for t in tensors if t is not None):
        raise ValueError(f"{name}: strips must be contiguous")
    lib, hp = _library_and_params(phys)
    ptrs = (ctypes.c_void_p * 45)(*(None if t is None else t.data_ptr()
                                    for t in tensors))
    geom = (ctypes.c_int * 5)(*Ex.shape, int(zhalo is not None),
                              int(yrows is not None))
    f_new, g_new, rho_q = (torch.empty_like(f), torch.empty_like(g),
                           torch.empty_like(Ex))
    stream = torch.cuda.current_stream(f.device).cuda_stream
    with torch.cuda.device(f.device):
        err = lib.lbm_plasma3d_collide_stream_halo(
            mode, int(phys["neutral_ref"] != 0.0), ctypes.addressof(ptrs),
            f_new.data_ptr(), g_new.data_ptr(), rho_q.data_ptr(),
            ctypes.addressof(geom), ctypes.addressof(hp), stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")
    HALO_LAUNCHES[name] += 1
    return f_new, g_new, rho_q


def halo3d(name: str, shard: Strip, zhalo, yrows, corners, phys: dict
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The halo step in the geometry the strips give: the kernel on CUDA
    tensors, its plain version on CPU tensors."""
    _check_halo3d(name, shard, zhalo, yrows, corners)
    if shard[0].device.type == "cpu":
        return halo3d_reference(shard, zhalo, yrows, corners, **phys)
    return _launch_halo3d(name, shard, zhalo, yrows, corners, phys)


def _slices(up_dn: Sequence[torch.Tensor]) -> Tuple[Strip, Strip]:
    """collide_stream_halo3d's (3, 19, 1, NY, NX) / (1, NY, NX) slices as
    the halo form's (3, 19, NY, NX) / (NY, NX) views; other shapes raise."""
    for t in up_dn:
        if t.dim() < 3 or t.shape[-3] != 1:
            raise ValueError(f"collide_stream_halo3d: halo slices must be one "
                             f"slice deep, got {tuple(t.shape)}")
    views = tuple(t[..., 0, :, :] for t in up_dn)
    return views[:5], views[5:]


def collide_stream_halo3d_reference(f, g, Ex, Ey, Ez, f_up, g_up, Ex_up,
                                    Ey_up, Ez_up, f_dn, g_dn, Ex_dn, Ey_dn,
                                    Ez_dn, **phys):
    """Plain version of collide_stream_halo3d."""
    zhalo = _slices((f_up, g_up, Ex_up, Ey_up, Ez_up,
                     f_dn, g_dn, Ex_dn, Ey_dn, Ez_dn))
    return halo3d_reference((f, g, Ex, Ey, Ez), zhalo, None, None, **phys)


def collide_stream_halo3d(
    f: torch.Tensor, g: torch.Tensor,           # (3, Q, NZl, NY, NX) z-shard
    Ex: torch.Tensor, Ey: torch.Tensor,         # (NZl, NY, NX)
    Ez: torch.Tensor,
    f_up: torch.Tensor, g_up: torch.Tensor,     # (3, Q, 1, NY, NX) slice above
    Ex_up: torch.Tensor, Ey_up: torch.Tensor,   # (1, NY, NX)
    Ez_up: torch.Tensor,
    f_dn: torch.Tensor, g_dn: torch.Tensor,     # (3, Q, 1, NY, NX) slice below
    Ex_dn: torch.Tensor, Ey_dn: torch.Tensor,   # (1, NY, NX)
    Ez_dn: torch.Tensor,
    *,
    taus: Tuple[float, ...],
    q_e: float, q_i: float, m_e: float, m_i: float,
    cs2: float, kb: float,
    neutral_ref: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(f_streamed, g_streamed, rho_q) of one z-shard, periodic in y and x:
    the slice above (the up neighbour's last) and below (the dn
    neighbour's first), pre-collision, are collided again and streamed
    into the shard."""
    phys = dict(taus=tuple(taus), q_e=q_e, q_i=q_i, m_e=m_e, m_i=m_i,
                cs2=cs2, kb=kb, neutral_ref=neutral_ref)
    zhalo = _slices((f_up, g_up, Ex_up, Ey_up, Ez_up,
                     f_dn, g_dn, Ex_dn, Ey_dn, Ez_dn))
    return halo3d("collide_stream_halo3d", (f, g, Ex, Ey, Ez), zhalo, None,
                  None, phys)


def halo_inputs3d(arrays: Sequence[torch.Tensor], zs: Optional[slice],
                  ys: Optional[slice]):
    """One shard's strips cut from the full periodic grid's (f, g, Ex, Ey,
    Ez): what the sharded steps' exchanges deliver. zs None is a y-shard
    (z whole, wrapping), ys None a z-shard (y whole, wrapping), both given
    a (dz, dy) tile (a slice of the whole axis too: its strips are then the
    shard's own wrap). Returns (shard, zhalo, yrows, corners) as the halo
    form takes them (halo3d), each tensor a contiguous copy."""
    NZ, NY, NX = arrays[2].shape
    dev = arrays[2].device

    def rng(lo, hi, n):
        return torch.arange(lo, hi, device=dev) % n

    def take(iz, iy, squeeze=()):
        out = []
        for a in arrays:
            t = a.index_select(-3, iz).index_select(-2, iy)
            for dim in squeeze:
                t = t.squeeze(dim)
            out.append(t.contiguous())
        return tuple(out)

    z, y = zs or slice(0, NZ), ys or slice(0, NY)
    iz, iy = rng(z.start, z.stop, NZ), rng(y.start, y.stop, NY)
    up_z, dn_z = rng(z.start - 1, z.start, NZ), rng(z.stop, z.stop + 1, NZ)
    up_y, dn_y = rng(y.start - 1, y.start, NY), rng(y.stop, y.stop + 1, NY)
    zhalo = yrows = corners = None
    if zs is not None:
        zhalo = (take(up_z, iy, (-3,)), take(dn_z, iy, (-3,)))
    if ys is not None:
        yrows = (take(iz, up_y, (-2,)), take(iz, dn_y, (-2,)))
    if zs is not None and ys is not None:
        corners = tuple(take(a, b, (-2, -2)) for a in (up_z, dn_z)
                        for b in (up_y, dn_y))
    return take(iz, iy), zhalo, yrows, corners
