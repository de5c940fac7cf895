#!/usr/bin/env python
"""The port's cavity against Ghia et al. (1982) at Re 100, 400 and 1000
(counterpart of scripts/validate_cavity_re.py).

Runs each Re with lbm_tpu_torch.models.cavity.make_rollout (the CUDA
kernels by default: the stored step, or the K-step window with
--multistep K) to steady state: the largest change of ux between two
chunks of --chunk steps, in lid units, below --tol. It then interpolates
the centerlines onto Ghia's stations and writes summary.json in the JAX
script's schema, with the card's name and power limit and each Re's wall
time, plus ghia_re<Re>.png where matplotlib is present. Ghia's columns
and the suspected misprint (SUSPECT) are models/cavity's, copies of the
JAX script's tables.

    python scripts/validate_cavity_re_torch.py --nx 256 \
        --out artifacts/cavity_re_torch
    python scripts/validate_cavity_re_torch.py --device cpu --nx 24 \
        --chunk 100 --max-steps 300 --re 100
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import torch  # noqa: E402

from lbm_tpu_torch.config import CavityConfig  # noqa: E402
from lbm_tpu_torch.models import cavity  # noqa: E402


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--nx", type=int, default=256)
    p.add_argument("--re", default="100,400,1000")
    p.add_argument("--u-lid", type=float, default=0.1)
    p.add_argument("--max-steps", type=int, default=1_500_000)
    p.add_argument("--chunk", type=int, default=20_000)
    p.add_argument("--tol", type=float, default=5e-5,
                   help="steady-state gate: max|du| between chunks, in lid "
                        "units (the f32 steady state floors at ~3e-5)")
    p.add_argument("--backend", choices=("plain", "fused"), default="fused")
    p.add_argument("--multistep", type=int, default=0, metavar="K",
                   help="fused: K steps per launch of the window kernel")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda or cpu (the plain backend)")
    p.add_argument("--out", default=os.path.join("build", "output",
                                                 "cavity_re_torch"))
    return p.parse_args(argv)


def card_line() -> str:
    """nvidia-smi's name and power limit of the card, or "" without one."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return ""


def steady_state(cfg: CavityConfig, device, chunk: int, max_steps: int,
                 tol: float):
    """(state, steps, residual): chunks of `chunk` steps until ux moves by
    less than tol * u_lid between two chunks, or max_steps."""
    roll = cavity.make_rollout(cfg, chunk)
    s = cavity.init_state(cfg, device)
    prev_u = None
    resid = float("inf")
    done = 0
    while done < max_steps:
        s = roll(s)
        done += chunk
        u = s.ux.double().cpu().numpy()
        if prev_u is not None:
            resid = float(np.abs(u - prev_u).max() / cfg.u_lid)
            if resid < tol:
                break
        prev_u = u
    return s, done, resid


def errors(re_n: int, yp, up, xp, vp) -> dict:
    """validate_cavity_re.py's per-Re record, from the centerlines."""
    if re_n == 100:
        gu, gv = cavity.GHIA_U_RE100, cavity.GHIA_V_RE100
    else:
        gu, gv = cavity.GHIA_U[re_n], cavity.GHIA_V[re_n]
    gy, gx = cavity.GHIA_Y, cavity.GHIA_X
    su, sv = np.interp(gy, yp, up), np.interp(gx, xp, vp)
    eu, ev = np.abs(su - gu), np.abs(sv - gv)
    keep = np.array([(re_n, "v", float(x)) not in cavity.SUSPECT
                     for x in gx])
    return {
        "u_max_err": float(eu.max()),
        "u_rms_err": float(np.sqrt((eu ** 2).mean())),
        "v_max_err": float(ev.max()),
        "v_rms_err": float(np.sqrt((ev ** 2).mean())),
        "v_max_err_excl_misprints": float(ev[keep].max()),
        "stations": [
            {"axis": "u", "pos": float(y), "ghia": float(g),
             "sim": float(si), "err": float(e)}
            for y, g, si, e in zip(gy, gu, su, eu)
        ] + [
            {"axis": "v", "pos": float(x), "ghia": float(g),
             "sim": float(si), "err": float(e),
             "suspect_misprint": bool(not k)}
            for x, g, si, e, k in zip(gx, gv, sv, ev, keep)
        ],
    }


def _plot(out: str, re_n: int, nx: int, yp, up, xp, vp) -> None:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if re_n == 100:
        gu, gv = cavity.GHIA_U_RE100, cavity.GHIA_V_RE100
    else:
        gu, gv = cavity.GHIA_U[re_n], cavity.GHIA_V[re_n]
    fig, (a1, a2) = plt.subplots(1, 2, figsize=(10, 4.2), dpi=110)
    a1.plot(up, yp, "-", label=f"lbm_tpu_torch {nx}^2")
    a1.plot(gu, cavity.GHIA_Y, "ko", ms=4, label="Ghia 1982")
    a1.set_xlabel("u/u_lid"), a1.set_ylabel("y"), a1.legend()
    a1.set_title(f"Re={re_n}: u on x-centerline")
    a2.plot(xp, vp, "-", label=f"lbm_tpu_torch {nx}^2")
    a2.plot(cavity.GHIA_X, gv, "ko", ms=4, label="Ghia 1982")
    a2.set_xlabel("x"), a2.set_ylabel("v/u_lid"), a2.legend()
    a2.set_title(f"Re={re_n}: v on y-centerline")
    fig.tight_layout()
    fig.savefig(os.path.join(out, f"ghia_re{re_n}.png"))
    plt.close(fig)


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = torch.device(args.device)
    backend, multistep = args.backend, args.multistep
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda: no CUDA device is available "
                               "(pass --device cpu to run on the CPU)")
    elif backend != "plain":
        print("--device cpu: the cavity kernels need a GPU, using the "
              "plain backend")
        backend, multistep = "plain", 0
    try:
        import matplotlib  # noqa: F401
        plots = True
    except ImportError:
        print("plots skipped: matplotlib is absent (summary.json is "
              "written)")
        plots = False
    os.makedirs(args.out, exist_ok=True)
    summary = {}
    for re_n in (int(r) for r in args.re.split(",")):
        cfg = CavityConfig(NX=args.nx, NY=args.nx, u_lid=args.u_lid,
                           Re=float(re_n), nsteps=0, backend=backend,
                           multistep=multistep)
        if not 0.5 < cfg.tau < 2.0:
            raise SystemExit(f"Re={re_n}: tau={cfg.tau:.4f} outside the "
                             f"stable BGK window at {args.nx}^2: change "
                             f"--nx or --u-lid")
        t0 = time.perf_counter()
        s, done, resid = steady_state(cfg, device, args.chunk,
                                      args.max_steps, args.tol)
        wall_s = time.perf_counter() - t0
        print(f"Re={re_n}: steady after {done} steps (residual "
              f"{resid:.2e}), {wall_s:.1f} s", flush=True)
        (yp, up), (xp, vp) = cavity.centerline_profiles(s, cfg.u_lid)
        summary[re_n] = {"steps": done, "residual": resid,
                         "wall_s": wall_s, **errors(re_n, yp, up, xp, vp)}
        r = summary[re_n]
        print(f"  u max={r['u_max_err']:.4f} rms={r['u_rms_err']:.4f}  "
              f"v max={r['v_max_err']:.4f} (excl misprints "
              f"{r['v_max_err_excl_misprints']:.4f}) "
              f"rms={r['v_rms_err']:.4f}", flush=True)
        if plots:
            _plot(args.out, re_n, args.nx, yp, up, xp, vp)
    device_name = (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu")
    out = {"grid": args.nx, "u_lid": args.u_lid, "backend": backend,
           "multistep": multistep, "device": device_name,
           "card": card_line() if device.type == "cuda" else "",
           "errors_vs_ghia": summary}
    with open(os.path.join(args.out, "summary.json"), "w") as fh:
        json.dump(out, fh, indent=2)
        fh.write("\n")
    print(f"wrote {args.out}/summary.json"
          + (f" + {len(summary)} plots" if plots else ""))
    return out


if __name__ == "__main__":
    main()
