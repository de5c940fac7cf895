"""fused_collide: macros + equilibria + collide in one kernel, without the
stream (counterpart of lbm_tpu/kernels/collide_pallas.py:fused_collide;
the "pallas" backend's collide stage, streaming left to torch).

On CUDA tensors the wrapper launches the collide-only instantiation of
csrc/fused_step.cu (entry lbm_collide: the collide+stream kernel storing
each post-collision value at its own site), or raises; on CPU tensors it
runs the plain version, fused_step.collide_reference (update_macro +
collide). Native f32 and f64 storage, with or without neutral-delta
storage; no bf16, as the TPU kernel. LAUNCHES counts kernel launches.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .fused_step import collide_reference, launch_collide

LAUNCHES = 0

# (storage dtype, compute dtype) -> the C interface's mode
_MODES = {
    (torch.float64, torch.float64): 0,
    (torch.float32, torch.float32): 1,
}


def fused_collide(
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
    """(f_post, g_post, rho_q): post-collision, pre-streaming populations."""
    global LAUNCHES
    phys = dict(taus=tuple(taus), q_e=q_e, q_i=q_i, m_e=m_e, m_i=m_i,
                cs2=cs2, kb=kb, neutral_ref=neutral_ref)
    if f.device.type == "cpu":
        return collide_reference(f, g, Ex, Ey, **phys)
    out = launch_collide("lbm_collide", _MODES, f, g, Ex, Ey, phys)
    LAUNCHES += 1
    return out
