"""collide_stream: the periodic D2Q9 collide + push-stream step in one
kernel (counterpart of lbm_tpu/kernels/fused_step.py:collide_stream).

On CUDA tensors the wrapper launches the hand-written kernel in
csrc/fused_step.cu, or raises; on CPU tensors it runs the plain version,
collide_stream_reference (update_macro + collide + stream_periodic in eager
torch), which the tests compare with the JAX package and which the chip
smoke test compares with the kernel. LAUNCHES counts kernel launches.

Unlike the TPU kernel, which aliases its outputs onto f and g, the launch
writes fresh buffers (a push-stream in place races on a GPU); the caller's
old f and g return to torch's caching allocator when it drops them.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from ..constants import D2Q9, D3Q19
from ..ops.collide import collide, species_scalars
from ..ops.macros import update_macro
from ..ops.stream import stream_periodic
from . import build

LAUNCHES = 0

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
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """update_macro + collide: (f_post, g_post, rho_q) in Ex's dtype; bf16
    storage takes the bf16 thermal forms with an exact reciprocal."""
    fc, gc = f.to(Ex.dtype), g.to(Ex.dtype)
    mac = update_macro(fc, gc, Ex, Ey, q_e=q_e, q_i=q_i, m_e=m_e, m_i=m_i,
                       neutral_ref=neutral_ref)
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


def launch_collide(entry: str, modes: dict, f, g, fields, phys: dict
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Check the inputs and launch the plasma kernel `entry` (arguments
    mode, delta, f, g, *fields, f_out, g_out, rho_q, *grid, params, stream)
    into fresh (f, g, rho_q) buffers; raises if the build or the launch
    fails."""
    mode = _check_inputs(entry, modes, f, g, *fields)
    lib = build.load()
    if lib.lbm_host_params_size() != ctypes.sizeof(HostParams):
        raise RuntimeError("HostParams layout differs between "
                           "csrc/plasma_site.cuh and its ctypes mirror")
    hp = host_params(**phys)
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
