"""Lid-driven cavity CLI of the port (scripts/run_cavity.py).

The classic validation workload (old codes/LBM_classic): Re=100, 129^2,
u_lid=0.1, 10k steps, compared against Ghia et al. (1982) centerlines.

    python scripts/run_cavity_torch.py                 # 129^2 x 10k, fused kernel
    python scripts/run_cavity_torch.py --lean          # populations-only kernel
    python scripts/run_cavity_torch.py --multistep 100 # 100 steps a launch
    python scripts/run_cavity_torch.py --nx 1000 --steps 2000 --storage bf16
    python scripts/run_cavity_torch.py --device cpu --nx 33 --steps 50
    torchrun --nproc-per-node 2 scripts/run_cavity_torch.py --device cpu \
        --shard 2 --nx 32 --steps 50 --multistep 4    # 2 ranks, gloo
    python scripts/run_cavity_torch.py --steps 6000 --checkpoint-every 2000
    python scripts/run_cavity_torch.py \
        --resume build/output/torch_cavity/ckpt_0006000.npz

Defaults: --backend fused (the CUDA stored-macro kernel; --lean and
--multistep select the other two cavity kernels) on --device cuda. There is
no silent CPU fallback: without a GPU, --device cuda raises; only an
explicit --device cpu runs on the CPU, with the plain backend. --shard N
runs under torchrun --nproc-per-node N: each rank holds NY/N rows
(parallel/fused_sharded), on cuda:LOCAL_RANK over NCCL, or over gloo with
--device cpu, where the halo kernels' plain versions run; it takes the halo
kernels whatever --backend says and composes with --lean, --multistep K
and --storage bf16, as the JAX CLI's does. Rank 0 gathers the state and
alone writes the outputs. --checkpoint-every N marches in chunks of N
steps and writes <out>/ckpt_<step>.npz after each (under --multistep K, a
multiple of K keeps the windows of a straight run, so a resume is bitwise),
then <out>/final_state.npz; --resume PATH continues a checkpoint of either
package (its storage layout reconciled with --storage; the grid must
match, since tau depends on NY) toward --steps, the total trajectory
length. --profile DIR writes a torch.profiler trace of the timed loop.
Video (on unless --no-video): after every --video-every steps (default
100; counted from the run's start) a frame of the JET colours of |u|^2,
normalised by its own min and max (under --shard the global ones, by an
all-reduce; rank 0 gathers the blocks' pixels), goes to
<out>/cavity.mp4 (cv2), else <out>/cavity.avi (the native writer), else
.gif, at 10 frames a second: the frame is rendered on the device and
copied to the host without a wait, and a writer thread encodes it
(io/video.FrameQueue). The run then marches in chunks that end at
every multiple of either cadence (video, checkpoint); with --no-video the
chunks are those of the checkpoint cadence alone.
Writes the centerline CSVs and the reference-schema timing CSV
(poisson=-1, bc=-1) to --out and prints the Ghia check at 129^2 and
Re=100. main(argv) returns a summary dict (wall
ms, MLUPS, each cavity kernel's launch count, the Ghia errors, finiteness,
relative mass drift, the video's path, the final state; under --shard
the gathered state).
"""
from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .config import CavityConfig
from .io import checkpoint as ckpt
from .io import colormap, profile, timing, video
from .kernels import build, fused_cavity
from .models import cavity
from .parallel import fused_sharded, mesh as pmesh, sharding
from .utils.watchdog import state_is_finite


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--nx", type=int, default=129, help="grid side (NX = NY)")
    p.add_argument("--steps", type=int, default=10_000)
    p.add_argument("--re", type=float, default=100.0)
    p.add_argument("--u-lid", type=float, default=0.1)
    p.add_argument("--f64", action="store_true", help="float64 arithmetic")
    p.add_argument("--out", default=os.path.join("build", "output",
                                                 "torch_cavity"))
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda, cuda:N or cpu")
    p.add_argument("--backend", choices=("plain", "fused"), default="fused",
                   help="fused = the CUDA cavity kernels; plain = eager torch")
    p.add_argument("--storage", choices=("native", "bf16"), default="native",
                   help="bf16 = f stored as bfloat16 deviations from the "
                        "uniform background (60 B/site stored, 36 lean); "
                        "arithmetic and macros stay f32")
    p.add_argument("--lean", action="store_true",
                   help="fused: recompute the macros from f in the kernel "
                        "and move the populations only (72 B/site in f32)")
    p.add_argument("--multistep", type=int, default=0, metavar="K",
                   help="fused: K steps per kernel launch (lean semantics; "
                        "bf16 rounds once per window)")
    p.add_argument("--stability-guard", action="store_true",
                   help="auto-resize the grid if tau leaves [0.5, 2]")
    p.add_argument("--shard", type=int, default=0, metavar="N",
                   help="shard the rows over N ranks (run under torchrun "
                        "--nproc-per-node N): the halo kernels, or with "
                        "--multistep K the gated window kernel on K-deep "
                        "ghost rows (parallel.fused_sharded)")
    p.add_argument("--checkpoint-every", type=int, default=0, metavar="N",
                   help="write <out>/ckpt_<step>.npz every N steps "
                        "(plus final_state.npz at the end)")
    p.add_argument("--resume", default=None, metavar="PATH",
                   help="resume from a cavity checkpoint (storage layout "
                        "reconciled to --storage)")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler trace of the timed loop, "
                        "DIR/trace_rank<r>.json")
    p.add_argument("--video-every", type=int, default=100, metavar="N",
                   help="a |u|^2 video frame every N steps")
    p.add_argument("--no-video", action="store_true",
                   help="write no video (the chunks then follow "
                        "--checkpoint-every alone)")
    return p.parse_args(argv)


def build_config(args: argparse.Namespace) -> CavityConfig:
    if args.storage == "bf16" and args.f64:
        raise SystemExit("--storage bf16 computes in f32 (drop --f64)")
    backend = ("fused" if (args.lean or args.multistep or args.shard)
               else args.backend)
    cfg = CavityConfig(NX=args.nx, NY=args.nx, nsteps=args.steps,
                       u_lid=args.u_lid, Re=args.re,
                       dtype=torch.float64 if args.f64 else torch.float32,
                       backend=backend, storage=args.storage,
                       lean_macros=args.lean, multistep=args.multistep)
    return cfg.with_stability_guard() if args.stability_guard else cfg


def _mass(cfg: CavityConfig, f: torch.Tensor) -> float:
    return float(cavity.decode_f(cfg, f).double().sum())


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda: no CUDA device is available "
                               "(pass --device cpu to run on the CPU)")
    elif device.type == "cpu":
        # under --shard the kernels' plain versions run on CPU tensors
        if not args.shard and (args.backend != "plain" or args.lean
                               or args.multistep):
            print("--device cpu: the cavity kernels need a GPU, using the "
                  "plain backend")
            args.backend, args.lean, args.multistep = "plain", False, 0
    else:
        raise SystemExit(f"--device {args.device}: want cuda[:N] or cpu")
    cfg = build_config(args)
    if args.shard:
        world = int(os.environ.get("WORLD_SIZE", 1))
        if world != args.shard:
            raise SystemExit(f"--shard {args.shard}: the world has {world} "
                             f"ranks; run under torchrun --nproc-per-node "
                             f"{args.shard}")
    own_group = bool(args.shard) and not dist.is_initialized()
    try:
        return _run(args, cfg, device)
    finally:
        if own_group and dist.is_initialized():
            dist.destroy_process_group()


def _run(args: argparse.Namespace, cfg: CavityConfig,
         device: torch.device) -> dict:
    m = None
    if args.shard:
        device = pmesh.init_distributed(device)
        m = pmesh.make_mesh((args.shard, 1), device.type)
    rank0 = m is None or dist.get_rank() == 0
    log = print if rank0 else (lambda *a, **k: None)
    log(f"cavity: {cfg.NX}^2, tau={cfg.tau:.4f}, {cfg.nsteps} steps")
    if rank0:
        os.makedirs(args.out, exist_ok=True)
    if device.type == "cuda" and cfg.backend == "fused":
        build.load()   # build the kernels outside the timer
    state = initial_state(args, cfg, device, log)
    start_step = state.step
    mass0 = _mass(cfg, state.f)
    # nsteps is the TOTAL trajectory length: a resumed run does the rest,
    # in chunks of the checkpoint and video cadences
    target = max(cfg.nsteps - start_step, 0)
    every = args.checkpoint_every
    if every and cfg.multistep and every % cfg.multistep:
        log(f"--checkpoint-every {every} is not a multiple of --multistep "
            f"{cfg.multistep}: each chunk ends in a shorter window, so a "
            f"resumed run is not bitwise equal to a straight one")
    video_every = 0 if args.no_video else args.video_every
    if video_every and cfg.multistep and video_every % cfg.multistep:
        log(f"--video-every {video_every} is not a multiple of --multistep "
            f"{cfg.multistep}: each chunk ends in a shorter window")
    chunks = chunk_lengths(target, [c for c in (every, video_every) if c])
    lengths = set(chunks)
    if m is None:
        rolls = {k: cavity.make_rollout(cfg, k) for k in lengths}
    else:
        maker = (fused_sharded.make_fused_sharded_cavity_multistep_rollout
                 if cfg.multistep else
                 fused_sharded.make_fused_sharded_cavity_rollout)
        try:
            rolls = {k: maker(cfg, m, k) for k in lengths}
        except ValueError as e:
            raise SystemExit(f"--shard: {e}")
        state = sharding.shard_cavity_state(state, m)
        log(f"sharded over mesh {{'dy': {args.shard}, 'dx': 1}}")
    launches0 = dict(fused_cavity.LAUNCHES)

    def save(name, state):
        """Every rank takes part in the gather; rank 0 writes."""
        full = state if m is None else sharding.gather_cavity_state(state, m)
        if rank0:
            path = os.path.join(args.out, name)
            ckpt.save_cavity(path, full, storage=cfg.storage)
            print(f"checkpoint: {path}")
        return full

    writer = None
    if video_every and rank0:
        writer = video.FrameQueue([video.open_writer(
            os.path.join(args.out, "cavity.avi"), cfg.NX, cfg.NY, fps=10,
            log=log)])

    def frame(state):
        """The video frame of `state` on rank 0 (None elsewhere): under
        --shard each rank colours its rows with the global extrema and
        rank 0 gathers them."""
        if m is None:
            return colormap.cavity_frame(state.ux, state.uy)
        speed2 = colormap.speed2(state.ux, state.uy)
        lo, hi = (t.clone() for t in torch.aminmax(speed2))
        dist.all_reduce(lo, op=dist.ReduceOp.MIN)
        dist.all_reduce(hi, op=dist.ReduceOp.MAX)
        rgb = sharding.gather_to_rank0(
            colormap.cavity_rgb(speed2, lo, hi).permute(2, 0, 1), m)
        return (None if rgb is None
                else torch.flip(rgb.permute(1, 2, 0), dims=(0,)))

    timer = timing.StepTimer(cfg.NX, cfg.NY)
    with profile.trace(args.profile, device, 0 if m is None
                       else dist.get_rank()):
        timer.start()
        done = 0
        for k in chunks:
            state = rolls[k](state)
            done += k
            timer.tick(k)
            if video_every and done % video_every == 0:
                rgb = frame(state)
                if writer is not None:
                    writer.put([rgb])
            if every and done % every == 0:
                save(f"ckpt_{state.step:07d}.npz", state)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        wall_ms = timer.wall_s * 1000
        mlups = timer.mlups
    launches = {k: n - launches0[k] for k, n in fused_cavity.LAUNCHES.items()}
    if writer is not None:
        writer.close()
    if every:
        state = save("final_state.npz", state)
    elif m is not None:
        state = sharding.gather_cavity_state(state, m)
    n_devices = (dist.get_world_size() if m is not None else
                 torch.cuda.device_count() if device.type == "cuda" else 1)

    ghia = None
    if cfg.NX == 129 and abs(cfg.Re - 100.0) < 1e-9:
        ghia = cavity.ghia_errors(state, cfg.u_lid)
    finite = state_is_finite(state)
    mass_drift = abs(_mass(cfg, state.f) - mass0) / mass0
    device_name = (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu")
    summary = dict(NX=cfg.NX, steps=target, start_step=start_step,
                   wall_ms=wall_ms, mlups=mlups, device=device_name,
                   backend=cfg.backend, storage=cfg.storage,
                   dtype=str(cfg.dtype), lean=cfg.lean_macros,
                   multistep=cfg.multistep, n_devices=n_devices,
                   launches=launches, ghia=ghia, finite=finite,
                   mass_drift=mass_drift,
                   video=None if writer is None else writer.paths[0],
                   state=state)
    if not rank0:
        return summary
    (yp, up), (xp, vp) = cavity.centerline_profiles(state, cfg.u_lid)
    np.savetxt(os.path.join(args.out, "centerline_u.csv"),
               np.column_stack([yp, up]), delimiter=",", header="y,u/u_lid")
    np.savetxt(os.path.join(args.out, "centerline_v.csv"),
               np.column_stack([xp, vp]), delimiter=",", header="x,v/u_lid")
    if ghia is not None:
        print(f"Ghia check: max|du|={ghia['u_max']:.4f}, "
              f"max|dv|={ghia['v_max']:.4f}")
    timing.append_timing_csv(
        os.path.join(args.out, "simulation_time_details.csv"),
        NX=cfg.NX, NY=cfg.NY, nsteps=target, n_devices=n_devices,
        poisson=-1, bc=-1, wall_ms=wall_ms)
    print(f"cavity done: {target} steps"
          + (f" from step {start_step}" if start_step else "") + ", "
          f"{wall_ms:.0f} ms ({mlups:.2f} MLUPS) on "
          f"{device_name}, backend {cfg.backend}, storage {cfg.storage}, "
          f"{cfg.dtype}, lean {cfg.lean_macros}, multistep {cfg.multistep}"
          + (f", {n_devices} ranks" if args.shard else "")
          + "; mass drift "
          f"{mass_drift:.3e}; kernel launches "
          + ", ".join(f"{k} {n}" for k, n in launches.items()))
    return summary


def chunk_lengths(target: int, cadences) -> list:
    """The march's chunks: they end at every multiple of each cadence and
    at the target (one chunk of the target without a cadence)."""
    chunks, done = [], 0
    while done < target:
        stop = min([target] + [(done // c + 1) * c for c in cadences])
        chunks.append(stop - done)
        done = stop
    return chunks


def initial_state(args: argparse.Namespace, cfg: CavityConfig, device,
                  log=print) -> cavity.CavityState:
    """The cavity at rest on `device`, or with --resume the checkpoint's,
    its storage layout reconciled with cfg; the grid must match (tau
    depends on NY)."""
    if not args.resume:
        return cavity.init_state(cfg, device)
    try:
        state = ckpt.reconcile_cavity_state(
            ckpt.load_cavity(args.resume, device), args.resume, cfg)
    except OSError as e:
        raise SystemExit(f"--resume: {e}")
    if tuple(state.rho.shape) != (cfg.NY, cfg.NX):
        raise SystemExit(
            f"--resume checkpoint grid {tuple(state.rho.shape)} != run grid "
            f"({cfg.NY}, {cfg.NX}): pass the matching --nx (tau depends on "
            f"NY; a silent mismatch runs the wrong Reynolds number)")
    log(f"resumed from {args.resume} at step {state.step}")
    return state
