#!/usr/bin/env python
"""f32-vs-f64 drift at the golden configuration (200x200, 200 steps) in
the PyTorch/CUDA port (the counterpart of scripts/measure_drift.py).

For every observable field: max |run - truth| / the truth's max |field|
after the run, for three runs against the f64 truth:
  * classic f32   - full neutral populations (rho_n ~ 1.8e10 lattice units
                    leave the f32 neutral moments to rounding);
  * delta f32     - neutral delta storage (cfg.neutral_delta), which keeps
                    the neutral channel;
  * bf16 delta    - bf16 population storage with delta neutrals.
The truth is the f64 run in the classic layout, the one the C++ fixtures
pin. On --device cuda (the default) every run takes the fused backend: the
f32 and bf16 runs and the truth all go through the collide+stream kernel.
--device cpu runs the plain backend. The table has the layout of
docs/STATUS.md's drift table, with a bf16 column.

    python scripts/measure_drift_torch.py                  # on the GPU
    python scripts/measure_drift_torch.py --device cpu --n 64 --steps 20
    python scripts/measure_drift_torch.py --json drift.json

main(argv) returns {column: {field: max|err|/scale}}.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from typing import Dict, Optional, Sequence

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import torch  # noqa: E402

from lbm_tpu_torch import config as C  # noqa: E402
from lbm_tpu_torch.models import plasma  # noqa: E402

COLUMNS = ("classic f32", "delta f32", "bf16 delta")
# (label, field) rows as docs/STATUS.md groups them
ROWS = [("rho_e / rho_i / rho_n", ("rho_e", "rho_i", "rho_n")),
        ("ux_i / uy_i", ("ux_i", "uy_i")),
        ("ux_n / uy_n", ("ux_n", "uy_n")),
        ("T_e / T_i", ("T_e", "T_i")),
        ("T_n", ("T_n",)),
        ("ux_e / uy_e", ("ux_e", "uy_e")),
        ("Ex / Ey / rho_q", ("Ex", "Ey", "rho_q"))]


def run(n: int, steps: int, device: torch.device, dtype, delta: bool,
        storage: str = "native") -> Dict[str, np.ndarray]:
    """The observable fields after `steps` golden steps at n x n, in f64
    on the host."""
    cfg = dataclasses.replace(
        C.preset_golden_plasma(), NX=n, NY=n, nsteps=steps, dtype=dtype,
        neutral_delta=delta, storage=storage,
        backend="fused" if device.type == "cuda" else "plain")
    state = plasma.make_rollout(cfg)(plasma.init_state(cfg, device))
    mac = plasma.compute_macros(cfg, state)
    out = {}
    for k, s in enumerate("ein"):
        for name in ("rho", "ux", "uy", "T"):
            out[f"{name}_{s}"] = getattr(mac, name)[k]
    out.update(rho_q=mac.rho_q, Ex=state.Ex, Ey=state.Ey)
    return {k: v.double().cpu().numpy() for k, v in out.items()}


def drift(runs: Dict[str, Dict[str, np.ndarray]],
          truth: Dict[str, np.ndarray]) -> Dict[str, Dict[str, float]]:
    return {col: {k: float(np.abs(r[k] - t).max() / np.abs(t).max())
                  for k, t in truth.items()}
            for col, r in runs.items()}


def table(errs: Dict[str, Dict[str, float]]) -> str:
    lines = ["| field | " + " | ".join(COLUMNS) + " |",
             "|---|" + "---|" * len(COLUMNS)]
    for label, fields in ROWS:
        cells = [" / ".join(f"{errs[c][f]:.2e}" for f in fields)
                 for c in COLUMNS]
        lines.append(f"| {label} | " + " | ".join(cells) + " |")
    return "\n".join(lines)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--n", type=int, default=200, help="NX = NY")
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--device", default="cuda",
                   help="cuda (fused backend) or cpu (plain backend)")
    p.add_argument("--json", default=None, metavar="PATH",
                   help="also write the numbers as JSON")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available "
                           "(pass --device cpu to run on the CPU)")
    what = ("fused backend on " + torch.cuda.get_device_name(device)
            if device.type == "cuda" else "plain backend on the CPU")
    print(f"golden drift, {args.n}x{args.n}, {args.steps} steps, {what}",
          flush=True)
    f32 = torch.float32
    runs = {"classic f32": run(args.n, args.steps, device, f32, False),
            "delta f32": run(args.n, args.steps, device, f32, True),
            "bf16 delta": run(args.n, args.steps, device, f32, True,
                              storage="bf16")}
    truth = run(args.n, args.steps, device, torch.float64, False)
    errs = drift(runs, truth)
    print("max |err| / field scale against the f64 truth (classic layout)")
    print(table(errs))
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(errs, fh, indent=1)
    return errs


if __name__ == "__main__":
    main()
