"""Plasma CLI of the port: the 2-D subset of scripts/run_plasma.py.

Runs the three-population plasma under any Poisson solver and either wall
type, with the 19-quantity probe series and the reference-schema timing
CSV.

    python scripts/run_plasma_torch.py                    # golden 200x200/200
    python scripts/run_plasma_torch.py --preset 1024 --storage bf16
    python scripts/run_plasma_torch.py --poisson SOR --bc bounceback
    python scripts/run_plasma_torch.py --preset 1024 --poisson GS --backend pallas
    python scripts/run_plasma_torch.py --multistep 8          # 8 steps a launch
    python scripts/run_plasma_torch.py --device cpu --nx 64 --ny 64 --steps 6

Defaults: --backend fused (the CUDA collide+stream kernel; GS/SOR/NPS
solve in the CUDA solve kernel) on --device cuda. --multistep K runs K
steps per launch of the CUDA window kernel, every solver and wall type in
the kernel; probes are then sampled once per window. --backend pallas runs
the collide-only CUDA kernel and streams in torch. There is no silent CPU
fallback: without a GPU, --device cuda raises; only an explicit --device
cpu runs on the CPU, with the plain backend. main(argv) returns a summary
dict (the probe series and each kernel's launch count included).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Optional, Sequence

import torch

from . import config as C
from .io import probes, timing
from .kernels import collide_pallas, fused_multistep, fused_step, poisson_iter
from .models import plasma

# each kernel wrapper's module, by the name of its TPU counterpart
KERNELS = {"collide_stream": fused_step, "fused_collide": collide_pallas,
           "solve_iter": poisson_iter,
           "collide_stream_multistep": fused_multistep}


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--preset", choices=["golden", "1024", "4096"],
                   default="golden")
    p.add_argument("--nx", type=int)
    p.add_argument("--ny", type=int)
    p.add_argument("--steps", type=int)
    p.add_argument("--poisson", choices=[s.name for s in C.PoissonSolver])
    p.add_argument("--bc", choices=["periodic", "bounceback"])
    p.add_argument("--omega-sor", type=float)
    p.add_argument("--backend", choices=["plain", "pallas", "fused"],
                   default="fused")
    p.add_argument("--storage", choices=["native", "bf16"], default="native",
                   help="population storage precision; arithmetic stays f32")
    p.add_argument("--neutral-delta", dest="neutral_delta",
                   action=argparse.BooleanOptionalAction, default=None,
                   help="store neutral populations as deltas from the "
                        "uniform background (default: on for f32, off for "
                        "f64)")
    p.add_argument("--f64", action="store_true", help="float64 parity mode")
    p.add_argument("--multistep", type=int, default=0, metavar="K",
                   help="temporal blocking: K whole steps per kernel launch "
                        "(fused backend; every solver/BC combination: "
                        "FFT+periodic solves in the kernel by DFT, GS/SOR/"
                        "NPS sweep in the kernel). Probes then sample at "
                        "WINDOW boundaries (every K steps) instead of every "
                        "step: use the default per-step marching when the "
                        "reference's per-step probe series is the point")
    p.add_argument("--out", default=os.path.join("build", "output", "torch"))
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda, cuda:N or cpu")
    return p.parse_args(argv)


def build_config(args: argparse.Namespace) -> C.PlasmaConfig:
    cfg = {
        "golden": C.preset_golden_plasma(),
        "1024": C.preset_plasma_1024(),
        "4096": C.preset_plasma_4096(),
    }[args.preset]
    over = {}
    if args.nx:
        over["NX"] = args.nx
    if args.ny:
        over["NY"] = args.ny
    if args.steps:
        over["nsteps"] = args.steps
    if args.poisson:
        over["poisson"] = C.PoissonSolver[args.poisson]
    if args.bc:
        over["bc"] = (C.BC.PERIODIC if args.bc == "periodic"
                      else C.BC.BOUNCE_BACK)
    if args.omega_sor:
        over["omega_sor"] = args.omega_sor
    over["backend"] = args.backend
    over["dtype"] = torch.float64 if args.f64 else torch.float32
    # delta storage is an accuracy win in f32; f64 keeps the classic layout
    # for golden parity (scripts/run_plasma.py:136-139)
    over["neutral_delta"] = (args.neutral_delta if args.neutral_delta
                             is not None else not args.f64)
    if args.storage != "native":
        if args.f64:
            raise SystemExit("--storage bf16 is an f32 fast mode (drop --f64)")
        over["storage"] = args.storage
    if args.multistep:
        over["multistep"] = args.multistep
        over["backend"] = "fused"
    try:
        return dataclasses.replace(cfg, **over)
    except ValueError as e:
        raise SystemExit(str(e))


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda: no CUDA device is available "
                               "(pass --device cpu to run on the CPU)")
    elif device.type == "cpu":
        # --multistep stays on the fused backend, whose window kernel runs
        # its plain version on CPU tensors
        if args.backend != "plain" and not args.multistep:
            print(f"--device cpu: the {args.backend} backend's kernels need "
                  f"a GPU, using the plain backend")
            args.backend = "plain"
    else:
        raise SystemExit(f"--device {args.device}: want cuda[:N] or cpu")
    cfg = build_config(args)

    os.makedirs(args.out, exist_ok=True)
    state = plasma.init_state(cfg, device)
    stride = cfg.multistep or 1
    # one rollout per window length: stride steps, and the remainder
    rollouts = {k: plasma.make_rollout(cfg, k)
                for k in {stride, cfg.nsteps % stride} if k}
    rec = probes.ProbeRecorder(cfg.NX, cfg.NY, device)
    launches0 = {k: m.LAUNCHES for k, m in KERNELS.items()}

    timer = timing.StepTimer(cfg.NX, cfg.NY)
    timer.start()
    for t in range(0, cfg.nsteps, stride):
        k = min(stride, cfg.nsteps - t)
        # Reference alignment: row t holds the macros computed at the TOP
        # of iteration t (the pre-step state) and the post-Poisson E of the
        # same iteration, which lives on the post-step state. Under
        # --multistep a row is a window: the macros before it, E after it.
        mac = plasma.compute_macros(cfg, state)
        state = rollouts[k](state)
        timer.tick(k)
        rec.record(mac, state.Ex, state.Ey)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall_ms = timer.wall_s * 1000

    series = rec.as_arrays()
    rec.save_csv(os.path.join(args.out, "graphs"))
    n_devices = torch.cuda.device_count() if device.type == "cuda" else 1
    timing.append_timing_csv(
        os.path.join(args.out, "simulation_time_plasma_details.csv"),
        NX=cfg.NX, NY=cfg.NY, nsteps=cfg.nsteps, n_devices=n_devices,
        poisson=cfg.poisson.value, bc=cfg.bc.value, wall_ms=wall_ms)
    finite = all(bool(torch.isfinite(t.float()).all())
                 for t in (state.f, state.g, state.Ex, state.Ey))
    device_name = (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu")
    launches = {k: m.LAUNCHES - launches0[k] for k, m in KERNELS.items()}
    print(f"Simulation ended: {cfg.NX}x{cfg.NY}, {cfg.nsteps} steps, "
          f"{wall_ms:.0f} ms ({timer.mlups:.2f} MLUPS) on {device_name}, "
          f"backend {cfg.backend}, poisson {cfg.poisson.name}, "
          f"bc {cfg.bc.name}, storage {cfg.storage}, {cfg.dtype}"
          + (f", multistep {cfg.multistep}" if cfg.multistep else "")
          + "; kernel "
          f"launches " + ", ".join(f"{k} {n}" for k, n in launches.items()))
    return dict(NX=cfg.NX, NY=cfg.NY, steps=cfg.nsteps, wall_ms=wall_ms,
                mlups=timer.mlups, device=device_name, backend=cfg.backend,
                poisson=cfg.poisson.name, bc=cfg.bc.name,
                storage=cfg.storage, dtype=str(cfg.dtype),
                multistep=cfg.multistep,
                launches=launches, finite=finite, probes=series,
                state=state)
