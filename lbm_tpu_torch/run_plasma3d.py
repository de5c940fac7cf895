"""3-D plasma column CLI of the port: the single-device subset of
scripts/run_plasma3d.py (BASELINE config #5).

    python scripts/run_plasma3d_torch.py                  # 64^2x64, 50 steps
    python scripts/run_plasma3d_torch.py --n 128 --nz 128 --storage bf16
    python scripts/run_plasma3d_torch.py --device cpu --n 16 --nz 8 --steps 3

Defaults: FFT Poisson, periodic, --backend fused (the CUDA collide+stream
kernel) on --device cuda, f32 with neutral-delta storage (--f64 turns it
off). There is no silent CPU fallback: without a GPU, --device cuda raises;
only an explicit --device cpu runs on the CPU, with the plain backend.
--slice-every N writes the z-midplane rho_e and rho_q every N steps as
slice_<step>.npz (PNG rendering waits for the port's io/colormap, ROADMAP
Queue 1 item 13). The timing CSV row goes to <out>/simulation_time_3d.csv.
main(argv) returns a summary dict (the state and the kernel's launch count
included).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Optional, Sequence

import numpy as np
import torch

from . import config as C
from .io import timing
from .kernels import fused_step3d
from .models import plasma3d

# flags of scripts/run_plasma3d.py that the port refuses, with the ROADMAP
# item that brings each
_REFUSED = {
    "shard": "--shard: 3-D sharding is ROADMAP Queue 1 item 14",
    "multistep": "--multistep: 3-D temporal blocking is the multi-device "
                 "K-slab protocol, ROADMAP Queue 1 item 14",
    "checkpoint_every": "--checkpoint-every: 3-D checkpoints are ROADMAP "
                        "Queue 1 item 13",
    "resume": "--resume: 3-D checkpoints are ROADMAP Queue 1 item 13",
}


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--n", type=int, default=64, help="NX = NY")
    p.add_argument("--nz", type=int, default=64)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--poisson", choices=["FFT", "NONE"], default="FFT")
    p.add_argument("--backend", choices=["plain", "fused"], default="fused",
                   help="fused = the CUDA collide+stream kernel")
    p.add_argument("--storage", choices=["native", "bf16"], default="native",
                   help="population storage precision; arithmetic stays f32")
    p.add_argument("--neutral-delta", dest="neutral_delta",
                   action=argparse.BooleanOptionalAction, default=None,
                   help="store neutral populations as deltas from the "
                        "uniform background (default: on, off with --f64)")
    p.add_argument("--f64", action="store_true", help="float64 parity mode")
    p.add_argument("--slice-every", type=int, default=10, metavar="N",
                   help="write the z-midplane rho_e and rho_q as "
                        "slice_<step>.npz every N steps (0: never); PNG "
                        "rendering waits for io/colormap (ROADMAP Queue 1 "
                        "item 13)")
    p.add_argument("--out", default=os.path.join("build", "output",
                                                 "torch_3d"))
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda, cuda:N or cpu")
    p.add_argument("--shard", type=int, default=0, help="refused (Q1 #14)")
    p.add_argument("--multistep", type=int, default=0,
                   help="refused (Q1 #14)")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="refused (Q1 #13)")
    p.add_argument("--resume", default=None, help="refused (Q1 #13)")
    return p.parse_args(argv)


def build_config(args: argparse.Namespace) -> C.PlasmaConfig:
    for flag, msg in _REFUSED.items():
        if getattr(args, flag):
            raise SystemExit(msg)
    if args.storage == "bf16" and args.f64:
        raise SystemExit("--storage bf16 is an f32 fast mode (drop --f64)")
    try:
        return dataclasses.replace(
            C.preset_plasma_3d(args.n, args.nz), nsteps=args.steps,
            poisson=C.PoissonSolver[args.poisson], backend=args.backend,
            dtype=torch.float64 if args.f64 else torch.float32,
            storage=args.storage,
            neutral_delta=(args.neutral_delta if args.neutral_delta
                           is not None else not args.f64))
    except ValueError as e:
        raise SystemExit(str(e))


def write_slice(path: str, cfg: C.PlasmaConfig,
                state: plasma3d.Plasma3DState) -> None:
    """The z-midplane rho_e and rho_q of `state`, observed with the storage
    contracts (bf16 upcast, delta neutrals read with neutral_ref)."""
    mac = plasma3d.compute_macros(cfg, state)
    zmid = cfg.NZ // 2
    np.savez(path, step=state.step,
             rho_e=mac.rho[0, zmid].double().cpu().numpy(),
             rho_q=mac.rho_q[zmid].double().cpu().numpy())


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda: no CUDA device is available "
                               "(pass --device cpu to run on the CPU)")
    elif device.type == "cpu":
        if args.backend != "plain":
            print(f"--device cpu: the {args.backend} backend's kernel needs "
                  f"a GPU, using the plain backend")
            args.backend = "plain"
    else:
        raise SystemExit(f"--device {args.device}: want cuda[:N] or cpu")
    cfg = build_config(args)

    os.makedirs(args.out, exist_ok=True)
    state = plasma3d.init_state(cfg, device)
    step = plasma3d.make_step(cfg)
    launches0 = fused_step3d.LAUNCHES

    timer = timing.StepTimer(cfg.NX, cfg.NY * cfg.NZ)
    timer.start()
    for t in range(cfg.nsteps):
        state = step(state)
        timer.tick()
        if args.slice_every and (t + 1) % args.slice_every == 0:
            write_slice(os.path.join(args.out, f"slice_{t + 1:05d}.npz"),
                        cfg, state)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall_ms = timer.wall_s * 1000

    n_devices = torch.cuda.device_count() if device.type == "cuda" else 1
    timing.append_timing_csv(
        os.path.join(args.out, "simulation_time_3d.csv"),
        NX=cfg.NX, NY=cfg.NY * cfg.NZ, nsteps=cfg.nsteps,
        n_devices=n_devices, poisson=cfg.poisson.value, bc=0,
        wall_ms=wall_ms)
    finite = all(bool(torch.isfinite(t.float()).all())
                 for t in (state.f, state.g, state.Ex, state.Ey, state.Ez))
    device_name = (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu")
    launches = fused_step3d.LAUNCHES - launches0
    print(f"3D column done: {cfg.NX}^2x{cfg.NZ}, {cfg.nsteps} steps, "
          f"{wall_ms:.0f} ms ({timer.mlups:.2f} MLUPS) on {device_name}, "
          f"backend {cfg.backend}, poisson {cfg.poisson.name}, storage "
          f"{cfg.storage}, {cfg.dtype}, neutral delta {cfg.neutral_delta}; "
          f"collide_stream3d launches {launches}")
    return dict(NX=cfg.NX, NY=cfg.NY, NZ=cfg.NZ, steps=cfg.nsteps,
                wall_ms=wall_ms, mlups=timer.mlups, device=device_name,
                backend=cfg.backend, poisson=cfg.poisson.name,
                storage=cfg.storage, dtype=str(cfg.dtype),
                neutral_delta=cfg.neutral_delta,
                launches={"collide_stream3d": launches}, finite=finite,
                state=state)
