"""Probe-point time series: 19 quantities at 9 fixed lattice points
(counterpart of lbm_tpu/io/probes.py; layout of src/visualize.cpp:77-85).

    ux/uy/|u| per species (9), T per species (3), rho per species + rho_q
    (4), Ex/Ey/|E| (3) = 19 quantities.

Sampling gathers 9 scalars per field on the device; the series reach the
host in one copy when they are read.
"""
from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np
import torch

QUANTITIES = [
    "ux_e", "uy_e", "ue_mag",
    "ux_i", "uy_i", "ui_mag",
    "ux_n", "uy_n", "un_mag",
    "T_e", "T_i", "T_n",
    "rho_e", "rho_i", "rho_n", "rho_q",
    "Ex", "Ey", "E_mag",
]


def probe_points(NX: int, NY: int) -> Tuple[np.ndarray, np.ndarray]:
    """(xs, ys) of the 9 sample points (reference: src/visualize.cpp:78-85)."""
    cx, cy, dx, dy = NX // 2, NY // 2, NX // 4, NY // 4
    pts = [
        (cx, cy),
        (cx + dx, cy), (cx - dx, cy),
        (cx, cy + dy), (cx, cy - dy),
        (cx + dx, cy + dy), (cx + dx, cy - dy),
        (cx - dx, cy + dy), (cx - dx, cy - dy),
    ]
    xs = np.array([p[0] for p in pts])
    ys = np.array([p[1] for p in pts])
    return xs, ys


def sample(mac, Ex, Ey, xs, ys) -> Dict[str, torch.Tensor]:
    """All 19 quantities at the probe points; returns dict of (9,) tensors.
    xs, ys: integer index arrays (numpy or tensors on the fields' device)."""
    xs = torch.as_tensor(xs, device=Ex.device)
    ys = torch.as_tensor(ys, device=Ex.device)
    out = {}
    for k, s in enumerate("ein"):
        ux = mac.ux[k][ys, xs]
        uy = mac.uy[k][ys, xs]
        out[f"ux_{s}"] = ux
        out[f"uy_{s}"] = uy
        out[f"u{s}_mag"] = torch.sqrt(ux * ux + uy * uy)
        out[f"T_{s}"] = mac.T[k][ys, xs]
        out[f"rho_{s}"] = mac.rho[k][ys, xs]
    out["rho_q"] = mac.rho_q[ys, xs]
    ex = Ex[ys, xs]
    ey = Ey[ys, xs]
    out["Ex"] = ex
    out["Ey"] = ey
    out["E_mag"] = torch.sqrt(ex * ex + ey * ey)
    return out


class ProbeRecorder:
    """Accumulates per-step probe samples without host synchronisation:
    each record() keeps one (19, 9) device tensor; the series are copied to
    the host in one transfer when read."""

    def __init__(self, NX: int, NY: int, device):
        xs, ys = probe_points(NX, NY)
        self.xs = torch.as_tensor(xs, device=device)
        self.ys = torch.as_tensor(ys, device=device)
        self._frames: List[torch.Tensor] = []

    def record(self, mac, Ex, Ey) -> None:
        vals = sample(mac, Ex, Ey, self.xs, self.ys)
        self._frames.append(torch.stack([vals[q] for q in QUANTITIES]))

    def as_arrays(self) -> Dict[str, np.ndarray]:
        """{quantity: (T, 9) array} — one batched device->host copy."""
        if not self._frames:
            return {}
        data = torch.stack(self._frames).cpu().numpy()   # (T, 19, 9)
        return {q: data[:, k, :] for k, q in enumerate(QUANTITIES)}

    def save_csv(self, out_dir: str) -> None:
        os.makedirs(out_dir, exist_ok=True)
        for q, arr in self.as_arrays().items():
            np.savetxt(os.path.join(out_dir, f"ts_{q}.csv"), arr,
                       delimiter=",",
                       header=",".join(f"p{i}" for i in range(arr.shape[1])))
