"""Push-periodic streaming (counterpart of lbm_tpu/ops/stream.py:
stream_periodic; bounce-back is ROADMAP Queue 1 item 8)."""
from __future__ import annotations

import torch

from ..constants import D2Q9


def stream_periodic(f: torch.Tensor) -> torch.Tensor:
    """Push-periodic streaming of (..., Q, NY, NX) populations:
    temp[y+cy, x+cx, i] = f[y, x, i] with wraparound
    (reference: src/streaming.cpp:35-59)."""
    parts = [
        torch.roll(f[..., i, :, :], shifts=(int(D2Q9.CY[i]), int(D2Q9.CX[i])),
                   dims=(-2, -1))
        for i in range(D2Q9.Q)
    ]
    return torch.stack(parts, dim=-3)
