"""collide_stream: the periodic D2Q9 collide + push-stream step in one
kernel (counterpart of lbm_tpu/kernels/fused_step.py:collide_stream), and
its two halo variants for a sharded lattice, collide_stream_halo (a
y-shard) and collide_stream_halo2d (a (y, x) tile), counterparts of the
JAX functions of the same names.

On CUDA tensors the wrapper launches the hand-written kernel in
csrc/fused_step.cu, or raises; on CPU tensors it runs the plain version,
collide_stream_reference (update_macro + collide + stream_periodic in eager
torch), which the tests compare with the JAX package and which the chip
smoke test compares with the kernel. LAUNCHES counts kernel launches;
HALO_LAUNCHES counts each halo variant's, by name.

Unlike the TPU kernel, which aliases its outputs onto f and g, the launch
writes fresh buffers (a push-stream in place races on a GPU); the caller's
old f and g return to torch's caching allocator when it drops them.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from ..constants import D2Q9, D3Q19
from ..ops.collide import collide, species_scalars
from ..ops.macros import update_macro
from ..ops.stream import stream_periodic
from . import build

LAUNCHES = 0
HALO_LAUNCHES = {"collide_stream_halo": 0, "collide_stream_halo2d": 0}

# (storage dtype, compute dtype) -> the C interface's mode
_MODES = {
    (torch.float64, torch.float64): 0,
    (torch.float32, torch.float32): 1,
    (torch.bfloat16, torch.float32): 2,
}

_D3 = ctypes.c_double * 3
_D33 = _D3 * 3


class HostParams(ctypes.Structure):
    """Mirror of struct HostParams in csrc/plasma_site.cuh, field for field."""

    _fields_ = [
        ("neutral_ref", ctypes.c_double),
        ("half_qom", _D3),
        ("qom_i", ctypes.c_double), ("qom_e", ctypes.c_double),
        ("inv_cs2", ctypes.c_double), ("half_inv_cs2", ctypes.c_double),
        ("half_inv_cs2_sq", ctypes.c_double), ("cs2", ctypes.c_double),
        ("kb", ctypes.c_double),
        ("charged", _D3),
        ("inv", _D33),
        ("keep", _D3),
        ("one_minus_keep", _D3),
        ("force_c", _D3),
        ("force_t", _D3),
        ("tt_a", _D33), ("tt_b", _D33), ("active", _D33),
        ("cs_a", _D33), ("cs_b", _D33), ("offs", _D33),
        ("cs9_a", _D33), ("cs9_b", _D33), ("offs9", _D33),
    ]


@functools.lru_cache(maxsize=16)
def host_params(*, taus, q_e, q_i, m_e, m_i, cs2, kb,
                neutral_ref) -> HostParams:
    """The kernel's constants, folded in double with the same Python
    expressions as ops/macros.py and ops/collide.py (the 3-D kernel,
    fused_step3d.cu, takes them too; the cs9 fields are D2Q9's). Read-only
    once built (cached: the step passes the same physics every call)."""
    q = D2Q9.Q
    charge = (q_e, q_i, 0.0)
    mass = (m_e, m_i, 1.0)
    inv = 1.0 / cs2
    p = HostParams()
    p.neutral_ref = neutral_ref
    p.qom_i = q_i / m_i
    p.qom_e = q_e / m_e
    p.inv_cs2 = inv
    p.half_inv_cs2 = 0.5 * inv
    p.half_inv_cs2_sq = 0.5 * inv * inv
    p.cs2 = cs2
    p.kb = kb
    for s in range(3):
        t_self, invs, keep = species_scalars(s, taus)
        p.half_qom[s] = 0.5 * (charge[s] / mass[s])
        p.charged[s] = float(charge[s] != 0.0)
        p.keep[s] = keep
        p.one_minus_keep[s] = 1.0 - keep
        p.force_c[s] = charge[s] / mass[s] / cs2
        p.force_t[s] = 1.0 - 1.0 / (2.0 * t_self)
        for k, iv in enumerate(invs):
            r = 1.0 - iv
            p.inv[s][k] = iv
            p.tt_a[s][k] = 2.0 * r * r - 2.0 * r
            p.tt_b[s][k] = 4.0 * r
            p.active[s][k] = float(r != 0.0)
            p.cs_a[s][k] = r * r - r
            p.cs_b[s][k] = r
            p.offs[s][k] = 2.0 * r
            p.cs9_a[s][k] = (r * r - r) * (1.0 / q)
            p.cs9_b[s][k] = r * (1.0 / q)
            p.offs9[s][k] = 2.0 * r / q
    return p


def collide_reference(
    f: torch.Tensor, g: torch.Tensor, Ex: torch.Tensor, Ey: torch.Tensor, *,
    taus, q_e: float, q_i: float, m_e: float, m_i: float,
    cs2: float, kb: float, neutral_ref: float = 0.0,
    guard_vals: Tuple[float, float, float] = (0.0, 0.0, 0.0),
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """update_macro + collide: (f_post, g_post, rho_q) in Ex's dtype; bf16
    storage takes the bf16 thermal forms with an exact reciprocal.
    guard_vals (the debug variant's, on the plain backend only) is no
    argument of the kernels."""
    fc, gc = f.to(Ex.dtype), g.to(Ex.dtype)
    mac = update_macro(fc, gc, Ex, Ey, q_e=q_e, q_i=q_i, m_e=m_e, m_i=m_i,
                       guard_vals=guard_vals, neutral_ref=neutral_ref)
    f_post, g_post = collide(
        fc, gc, mac, Ex, Ey, taus=taus, q_e=q_e, q_i=q_i, m_e=m_e, m_i=m_i,
        cs2=cs2, kb=kb, neutral_ref=neutral_ref,
        g_recip=(lambda x: 1.0 / x) if f.dtype == torch.bfloat16 else None)
    return f_post, g_post, mac.rho_q


def collide_stream_reference(f, g, Ex, Ey, **phys
                             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version: collide_reference + stream_periodic, rounded to the
    storage dtype once, at the end."""
    f_post, g_post, rho_q = collide_reference(f, g, Ex, Ey, **phys)
    return (stream_periodic(f_post).to(f.dtype),
            stream_periodic(g_post).to(g.dtype), rho_q)


def _check_inputs(name, modes, f, g, *fields) -> int:
    """Validate what a plasma kernel takes: f and g of shape (3, Q, *grid)
    (D2Q9 on a 2-D grid, D3Q19 on a 3-D one) and the fields of shape grid,
    contiguous on one CUDA device; returns the kernel's mode from `modes`."""
    tensors = (f, g, *fields)
    devices = {t.device for t in tensors}
    if len(devices) != 1 or f.device.type != "cuda":
        raise ValueError(f"{name}: f, g and the fields must lie on one CUDA "
                         f"device (or all on the CPU), got {sorted(map(str, devices))}")
    field = fields[0]
    mode = modes.get((f.dtype, field.dtype))
    dtypes = [str(t.dtype) for t in tensors]
    if (mode is None or g.dtype != f.dtype
            or any(t.dtype != field.dtype for t in fields)):
        raise TypeError(f"{name}: unsupported dtypes {dtypes} (f, g, "
                        f"fields); the kernel takes (storage, field) dtypes "
                        f"{sorted(map(str, modes))}")
    grid = tuple(field.shape)
    q = {2: D2Q9.Q, 3: D3Q19.Q}.get(len(grid))
    shapes = [tuple(t.shape) for t in tensors]
    if (tuple(f.shape) != (3, q, *grid) or g.shape != f.shape
            or any(t.shape != field.shape for t in fields)):
        raise ValueError(f"{name}: shapes {shapes} (f, g, fields); want "
                         f"(3, 9, NY, NX) and (NY, NX), or (3, 19, NZ, NY, "
                         f"NX) and (NZ, NY, NX)")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: inputs must be contiguous")
    return mode


def _library_and_params(phys: dict):
    """The built library (its HostParams layout checked against the ctypes
    mirror) and the kernel constants of `phys`."""
    lib = build.load()
    if lib.lbm_host_params_size() != ctypes.sizeof(HostParams):
        raise RuntimeError("HostParams layout differs between "
                           "csrc/plasma_site.cuh and its ctypes mirror")
    return lib, host_params(**phys)


def launch_collide(entry: str, modes: dict, f, g, fields, phys: dict
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Check the inputs and launch the plasma kernel `entry` (arguments
    mode, delta, f, g, *fields, f_out, g_out, rho_q, *grid, params, stream)
    into fresh (f, g, rho_q) buffers; raises if the build or the launch
    fails."""
    mode = _check_inputs(entry, modes, f, g, *fields)
    lib, hp = _library_and_params(phys)
    f_new = torch.empty_like(f)
    g_new = torch.empty_like(g)
    rho_q = torch.empty_like(fields[0])
    stream = torch.cuda.current_stream(f.device).cuda_stream
    with torch.cuda.device(f.device):
        err = getattr(lib, entry)(
            mode, int(phys["neutral_ref"] != 0.0), f.data_ptr(), g.data_ptr(),
            *(t.data_ptr() for t in fields), f_new.data_ptr(),
            g_new.data_ptr(), rho_q.data_ptr(), *fields[0].shape,
            ctypes.addressof(hp), stream)
    if err != 0:
        raise RuntimeError(f"{entry} kernel launch failed: cudaError_t {err}")
    return f_new, g_new, rho_q


def collide_stream(
    f: torch.Tensor,   # (3, Q, NY, NX)
    g: torch.Tensor,
    Ex: torch.Tensor,  # (NY, NX)
    Ey: torch.Tensor,
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
        return collide_stream_reference(f, g, Ex, Ey, **phys)
    out = launch_collide("lbm_collide_stream", _MODES, f, g, (Ex, Ey), phys)
    LAUNCHES += 1
    return out


# ---------------------------------------------------------------------------
# The halo variants. A shard's neighbours arrive as pre-collision strips (the
# strip contract of lbm_tpu/kernels/fused_step.py:collide_stream_halo and
# _halo2d): the row above the shard is the last row of the up strip, the row
# below the first row of the dn strip; on a (y, x) tile the y strips are
# corner-extended by e >= 1 columns a side (width NXl + 2e, e read from the
# width), the column left is the last column of the lt strip and the column
# right the first column of the rt strip. Strips may be any depth >= 1; only
# the edge row or column is read.
# ---------------------------------------------------------------------------

def _halo_ext(f_up, NX: int) -> int:
    """The corner extension e of y strips of width NX + 2e."""
    return (f_up.shape[-1] - NX) // 2


def halo_inputs(arrays, rows: slice, cols: Optional[slice] = None,
                depth: int = 1, ext: int = 1):
    """One shard's arguments of collide_stream_halo (cols None: a full-width
    y-shard) or collide_stream_halo2d, cut from the full periodic grid's
    arrays (f, g, Ex, Ey): what the sharded step's exchange delivers, with
    strips `depth` deep and y strips corner-extended by `ext` columns on a
    tile. Every tensor is a contiguous copy."""
    NY, NX = arrays[2].shape

    def take(ys, xs):
        iy = torch.arange(ys[0], ys[1], device=arrays[2].device) % NY
        ix = torch.arange(xs[0], xs[1], device=arrays[2].device) % NX
        return [a.index_select(-2, iy).index_select(-1, ix).contiguous()
                for a in arrays]

    y0, y1 = rows.start, rows.stop
    if cols is None:
        full = (0, NX)
        return (take((y0, y1), full) + take((y0 - depth, y0), full)
                + take((y1, y1 + depth), full))
    x0, x1 = cols.start, cols.stop
    wide = (x0 - ext, x1 + ext)
    return (take((y0, y1), (x0, x1)) + take((y0 - depth, y0), wide)
            + take((y1, y1 + depth), wide) + take((y0, y1), (x0 - depth, x0))
            + take((y0, y1), (x1, x1 + depth)))


def _check_halo(name, f, g, Ex, Ey, up, dn, lt=None, rt=None) -> int:
    """Validate a halo call's shapes and dtypes (the shard's own are left to
    _check_inputs on CUDA); returns the y strips' corner extension e (0 for
    a y-shard)."""
    if f.dim() != 4 or Ex.dim() != 2:
        raise ValueError(f"{name}: want f (3, 9, NY, NX) and Ex (NY, NX), "
                         f"got {tuple(f.shape)} and {tuple(Ex.shape)}")
    NY, NX = Ex.shape
    pops = [f, g]
    fields = [Ex, Ey]
    tile = lt is not None
    e = _halo_ext(up[0], NX) if tile else 0
    if tile and (e < 1 or up[0].shape[-1] != NX + 2 * e):
        raise ValueError(f"{name}: y strips must be corner-extended to "
                         f"NX + 2e (e >= 1) = {NX} + 2e columns, got "
                         f"{up[0].shape[-1]}")
    strips = [("up", up, None), ("dn", dn, None)]
    if tile:
        strips += [("lt", lt, NY), ("rt", rt, NY)]
    for side, (fs, gs, exs, eys), rows in strips:
        if fs.dim() != 4 or exs.dim() != 2:
            raise ValueError(f"{name}: {side} strips have shapes "
                             f"{tuple(fs.shape)} and {tuple(exs.shape)}")
        depth, width = exs.shape
        if rows is None:     # a y strip: >= 1 rows of the (extended) width
            ok = depth >= 1 and width == NX + 2 * e
        else:                # an x strip: the shard's rows, >= 1 columns
            ok = depth == rows and width >= 1
        want = (3, D2Q9.Q, depth, width)
        if (not ok or tuple(fs.shape) != want or gs.shape != fs.shape
                or eys.shape != exs.shape):
            shapes = [tuple(t.shape) for t in (fs, gs, exs, eys)]
            raise ValueError(f"{name}: {side} strips {shapes} do not fit "
                             f"the shard {tuple(f.shape)}")
        pops += [fs, gs]
        fields += [exs, eys]
    if any(t.dtype != f.dtype for t in pops) or any(
            t.dtype != Ex.dtype for t in fields):
        raise TypeError(f"{name}: strips must have the shard's dtypes "
                        f"({f.dtype}, {Ex.dtype})")
    if len({t.device for t in pops + fields}) != 1:
        raise ValueError(f"{name}: the shard and its strips must lie on one "
                         f"device")
    return e


def _stream_cropped(f, g, fields, phys, rows, cols):
    """collide_reference + stream_periodic on an extended block, cropped
    to [rows, cols] and rounded to the storage dtype once, at the end: the
    wrap only moves values into the block's border, which the crop drops."""
    f_post, g_post, rho_q = collide_reference(f, g, *fields, **phys)
    return (stream_periodic(f_post)[..., rows, cols].to(f.dtype).contiguous(),
            stream_periodic(g_post)[..., rows, cols].to(g.dtype).contiguous(),
            rho_q[rows, cols].contiguous())


def collide_stream_halo_reference(f, g, Ex, Ey, f_up, g_up, Ex_up, Ey_up,
                                  f_dn, g_dn, Ex_dn, Ey_dn, **phys):
    """Plain version of collide_stream_halo: the shard extended by the row
    above and the row below, collided and periodically streamed, the
    interior rows kept. Bitwise equal to collide_stream_reference on the
    full grid at the shard's rows."""
    def ext(a, up, dn):
        return torch.cat([up[..., -1:, :], a, dn[..., :1, :]], dim=-2)

    return _stream_cropped(
        ext(f, f_up, f_dn), ext(g, g_up, g_dn),
        (ext(Ex, Ex_up, Ex_dn), ext(Ey, Ey_up, Ey_dn)), phys,
        slice(1, -1), slice(None))


def collide_stream_halo2d_reference(f, g, Ex, Ey, f_up, g_up, Ex_up, Ey_up,
                                    f_dn, g_dn, Ex_dn, Ey_dn,
                                    f_lt, g_lt, Ex_lt, Ey_lt,
                                    f_rt, g_rt, Ex_rt, Ey_rt, **phys):
    """Plain version of collide_stream_halo2d: the tile extended by one row
    and one column a side (the corners from the corner-extended y strips),
    collided and periodically streamed, the interior kept."""
    NX = Ex.shape[-1]
    e = _halo_ext(f_up, NX)
    cols = slice(e - 1, e + NX + 1)

    def ext(a, up, dn, lt, rt):
        mid = torch.cat([lt[..., -1:], a, rt[..., :1]], dim=-1)
        return torch.cat([up[..., -1:, cols], mid, dn[..., :1, cols]], dim=-2)

    return _stream_cropped(
        ext(f, f_up, f_dn, f_lt, f_rt), ext(g, g_up, g_dn, g_lt, g_rt),
        (ext(Ex, Ex_up, Ex_dn, Ex_lt, Ex_rt),
         ext(Ey, Ey_up, Ey_dn, Ey_lt, Ey_rt)), phys,
        slice(1, -1), slice(1, -1))


def _launch_halo(name, tensors, e, phys):
    """Launch lbm_collide_stream_halo on the shard and its strips
    (tensors: f, g, Ex, Ey, then each strip's four; None for a y-shard's
    x strips) into fresh buffers."""
    f, g, Ex, Ey = tensors[:4]
    mode = _check_inputs(name, _MODES, f, g, Ex, Ey)
    if not all(t.is_contiguous() for t in tensors if t is not None):
        raise ValueError(f"{name}: strips must be contiguous")
    lib, hp = _library_and_params(phys)
    ptrs = (ctypes.c_void_p * 20)(*(None if t is None else t.data_ptr()
                                    for t in tensors))
    NY, NX = Ex.shape
    dl, dr = ((tensors[12].shape[-1], tensors[16].shape[-1]) if e
              else (0, 0))
    geom = (ctypes.c_int * 7)(NY, NX, tensors[6].shape[0],
                              tensors[10].shape[0], e, dl, dr)
    f_new, g_new, rho_q = (torch.empty_like(f), torch.empty_like(g),
                           torch.empty_like(Ex))
    stream = torch.cuda.current_stream(f.device).cuda_stream
    with torch.cuda.device(f.device):
        err = lib.lbm_collide_stream_halo(
            mode, int(phys["neutral_ref"] != 0.0), ctypes.addressof(ptrs),
            f_new.data_ptr(), g_new.data_ptr(), rho_q.data_ptr(),
            ctypes.addressof(geom), ctypes.addressof(hp), stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")
    HALO_LAUNCHES[name] += 1
    return f_new, g_new, rho_q


def collide_stream_halo(
    f: torch.Tensor, g: torch.Tensor,          # (3, Q, NYl, NX) shard
    Ex: torch.Tensor, Ey: torch.Tensor,        # (NYl, NX)
    f_up: torch.Tensor, g_up: torch.Tensor,    # (3, Q, du, NX) rows above
    Ex_up: torch.Tensor, Ey_up: torch.Tensor,  # (du, NX)
    f_dn: torch.Tensor, g_dn: torch.Tensor,    # (3, Q, dd, NX) rows below
    Ex_dn: torch.Tensor, Ey_dn: torch.Tensor,  # (dd, NX)
    *,
    taus: Tuple[float, ...],
    q_e: float, q_i: float, m_e: float, m_i: float,
    cs2: float, kb: float,
    neutral_ref: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(f_streamed, g_streamed, rho_q) of one y-shard, periodic in x: the
    up strip's last row and the dn strip's first row are collided again
    and streamed into the shard."""
    phys = dict(taus=tuple(taus), q_e=q_e, q_i=q_i, m_e=m_e, m_i=m_i,
                cs2=cs2, kb=kb, neutral_ref=neutral_ref)
    up, dn = (f_up, g_up, Ex_up, Ey_up), (f_dn, g_dn, Ex_dn, Ey_dn)
    _check_halo("collide_stream_halo", f, g, Ex, Ey, up, dn)
    if f.device.type == "cpu":
        return collide_stream_halo_reference(f, g, Ex, Ey, *up, *dn, **phys)
    return _launch_halo("collide_stream_halo",
                        (f, g, Ex, Ey, *up, *dn, *(None,) * 8), 0, phys)


def collide_stream_halo2d(
    f, g, Ex, Ey,                  # (3, Q, NYl, NXl) / (NYl, NXl) tile
    f_up, g_up, Ex_up, Ey_up,      # (.., du, NXl + 2e) corner-extended
    f_dn, g_dn, Ex_dn, Ey_dn,      # (.., dd, NXl + 2e)
    f_lt, g_lt, Ex_lt, Ey_lt,      # (.., NYl, dl) columns left
    f_rt, g_rt, Ex_rt, Ey_rt,      # (.., NYl, dr) columns right
    *,
    taus: Tuple[float, ...],
    q_e: float, q_i: float, m_e: float, m_i: float,
    cs2: float, kb: float,
    neutral_ref: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(f_streamed, g_streamed, rho_q) of one (y, x) tile: the edge rows of
    the y strips (corners included) and the edge columns of the x strips
    are collided again and streamed into the tile."""
    phys = dict(taus=tuple(taus), q_e=q_e, q_i=q_i, m_e=m_e, m_i=m_i,
                cs2=cs2, kb=kb, neutral_ref=neutral_ref)
    up, dn = (f_up, g_up, Ex_up, Ey_up), (f_dn, g_dn, Ex_dn, Ey_dn)
    lt, rt = (f_lt, g_lt, Ex_lt, Ey_lt), (f_rt, g_rt, Ex_rt, Ey_rt)
    e = _check_halo("collide_stream_halo2d", f, g, Ex, Ey, up, dn, lt, rt)
    if f.device.type == "cpu":
        return collide_stream_halo2d_reference(f, g, Ex, Ey, *up, *dn, *lt,
                                               *rt, **phys)
    return _launch_halo("collide_stream_halo2d",
                        (f, g, Ex, Ey, *up, *dn, *lt, *rt), e, phys)
