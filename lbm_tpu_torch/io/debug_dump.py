"""Stage-by-stage grid dump in the reference debug build's format
(counterpart of lbm_tpu/io/debug_dump.py).

Replicates old codes/Plasma debug plasma_debug.cpp:1480-1557 +
DumpGridStateReadable (:1984-2180): after every pipeline stage of every
step, the macroscopic fields, E, the mass populations and the 9
materialised equilibrium sets as %.6e comma-separated grids (y descending),
only on small grids (NX < 11 in the reference). The block order, the labels
(the reference's duplicated "Ex" label on the Ey block included) and the
3x3 "directions arrangement" preamble match the C++ file byte for byte, so
a dump and the reference's debug_dump.txt diff line for line:

    python scripts/run_plasma_torch.py --device cpu --nx 8 --ny 8 --steps 5 \\
        --f64 --debug-variant --poisson FFT --debug-dump --out build/dbg
"""
from __future__ import annotations

from typing import Optional, TextIO

import numpy as np
import torch

from ..config import PlasmaConfig
from ..constants import D2Q9
from ..models.plasma_staged import EQ_LABELS, STAGES, StageSnapshot

# dump order: (label, dir index) of the 3x3 stencil arrangement
_DIR3X3 = ((6, 2, 5), (3, 0, 1), (7, 4, 8))
_DIR_ORDER = tuple(d for row in _DIR3X3 for d in row)


def _np64(a) -> np.ndarray:
    """A tensor or an array as float64 numpy."""
    if isinstance(a, torch.Tensor):
        a = a.detach().to("cpu", torch.float64).numpy()
    return np.asarray(a, np.float64)


class DebugDumper:
    def __init__(self, cfg: PlasmaConfig, path: str = "debug_dump.txt",
                 max_nx: int = 11):
        self.cfg = cfg
        self.enabled = cfg.NX < max_nx
        self._fh: Optional[TextIO] = None
        if self.enabled:
            self._fh = open(path, "w")
            self._fh.write("# Debug dump per LBmethod\n")

    def _grid(self, arr) -> None:
        fh = self._fh
        for row in _np64(arr)[::-1]:  # y descending
            fh.write(",".join(f"{v:.6e}" for v in row) + "\n")

    def _scalar(self, label: str, arr) -> None:
        self._fh.write(label + "\n")
        self._grid(arr)

    def _populations(self, label: str, f_sp) -> None:
        """One species' per-direction grids with the 3x3 stencil preamble."""
        fh = self._fh
        fh.write(label + "\n")
        fh.write("directions arrangement:\n")
        for row in _DIR3X3:
            fh.write(",".join(str(d) for d in row) + "\n")
        f_np = _np64(f_sp)
        for d in _DIR_ORDER:
            fh.write(f"{label} dir {d} "
                     f"(cx={int(D2Q9.CX[d])},cy={int(D2Q9.CY[d])})\n")
            self._grid(f_np[d])

    def dump_stage(self, step: int, stage: str, snap: StageSnapshot) -> None:
        """Write one stage snapshot in the C++ block order."""
        if not self.enabled:
            return
        if stage not in STAGES:
            raise ValueError(f"unknown stage {stage!r}; want one of {STAGES}")
        fh = self._fh
        fh.write(f"step = {step}\n")
        fh.write(f"stage = {stage}\n")
        mac = snap.mac
        for k, s in enumerate("ein"):
            self._scalar(f"ux_{s}", mac.ux[k])
            self._scalar(f"uy_{s}", mac.uy[k])
        self._scalar("rho_q", mac.rho_q)
        for k, s in enumerate("ein"):
            self._scalar(f"rho_{s}", mac.rho[k])
        self._scalar("Ex", snap.Ex)
        self._scalar("Ex", snap.Ey)   # the reference labels Ey "Ex" too
        for k, s in enumerate("ein"):
            self._populations(f"f_{s}", snap.f[k])
        for label in EQ_LABELS:
            self._populations(label, snap.feq[label])
        fh.write("\n")  # the C++ dump closes each stage with a blank line
        fh.flush()

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None
