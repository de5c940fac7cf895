"""Run timing: the reference's CSV-append habit plus an MLUPS meter
(a copy of lbm_tpu/io/timing.py, which is pure Python).

Schema matches src/main_plasma.cpp:86-92 so the reference's scalability
analysis scripts (build/Scalability_analysis.py) can parse our rows too:

    Grid_Dimension,Number_of_Steps,Number_of_Cores,Poisson,BC,Total_Computation_Time(ms)

"Number_of_Cores" carries the device count.
"""
from __future__ import annotations

import os
import time
from typing import Optional


CSV_HEADER = ("Grid_Dimension,Number_of_Steps,Number_of_Cores,Poisson,BC,"
              "Total_Computation_Time(ms)\n")


def append_timing_csv(path: str, *, NX: int, NY: int, nsteps: int,
                      n_devices: int, poisson: int, bc: int,
                      wall_ms: float) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    new = not os.path.exists(path) or os.path.getsize(path) == 0
    with open(path, "a") as f:
        if new:
            f.write(CSV_HEADER)
        f.write(f"{NX}x{NY},{nsteps},{n_devices},{poisson},{bc},"
                f"{int(round(wall_ms))}\n")


class StepTimer:
    """Wall-clock + MLUPS for a run; optional per-phase marks."""

    def __init__(self, NX: int, NY: int):
        self.sites = NX * NY
        self.t0: Optional[float] = None
        self.steps = 0

    def start(self) -> None:
        self.t0 = time.perf_counter()

    def tick(self, n: int = 1) -> None:
        self.steps += n

    @property
    def wall_s(self) -> float:
        if self.t0 is None:
            raise RuntimeError("StepTimer.start() was not called")
        return time.perf_counter() - self.t0

    @property
    def mlups(self) -> float:
        return self.sites * self.steps / self.wall_s / 1e6
