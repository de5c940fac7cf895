"""collide_stream3d: the periodic D3Q19 collide + push-stream step of the
3-D plasma column in one kernel (counterpart of
lbm_tpu/kernels/fused_step3d.py:collide_stream3d).

On CUDA tensors the wrapper launches the hand-written kernel in
csrc/fused_step3d.cu, or raises; on CPU tensors it runs the plain version,
collide_stream3d_reference (ops/d3 update_macro3 + collide3 +
stream_periodic3 in eager torch), which the tests compare with the JAX
package and which the chip smoke test compares with the kernel. LAUNCHES
counts kernel launches.

The launch writes fresh output buffers (a push-stream in place races on a
GPU), where the TPU kernel aliases its outputs onto f and g. The launch,
its input checks and the kernel's constants (HostParams, folded in double
with ops/d3's expressions) are the 2-D kernel's (kernels/fused_step.py).
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..ops.d3 import collide3, stream_periodic3, update_macro3
from .fused_step import _MODES, launch_collide

LAUNCHES = 0


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
