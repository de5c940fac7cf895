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
    python scripts/run_plasma_torch.py --device cpu --nx 8 --ny 8 --steps 5 \
        --f64 --poisson FFT --debug-variant --debug-dump   # C++ dump format
    torchrun --nproc-per-node 2 scripts/run_plasma_torch.py --device cpu \
        --shard 2 --nx 32 --ny 32 --steps 3                # 2 ranks, gloo
    torchrun --nproc-per-node 2 scripts/run_plasma_torch.py --device cpu \
        --shard 2 --multistep 4 --nx 32 --ny 32 --steps 10 \
        --bc bounceback --poisson NONE                     # sharded windows
    python scripts/run_plasma_torch.py --steps 120 --checkpoint-every 40
    python scripts/run_plasma_torch.py \
        --resume build/output/torch/ckpt_000120.npz

Defaults: --backend fused (the CUDA collide+stream kernel; GS/SOR/NPS
solve in the CUDA solve kernel) on --device cuda. --multistep K runs K
steps per launch of the CUDA window kernel, every solver and wall type in
the kernel; probes are then sampled once per window. --backend pallas runs
the collide-only CUDA kernel and streams in torch. There is no silent CPU
fallback: without a GPU, --device cuda raises; only an explicit --device
cpu runs on the CPU, with the plain backend. --debug-variant replicates the
reference's debug build (plain backend); --debug-dump writes every pipeline
stage of every step in its dump format (grids with NX < 11; the staged plain
step). --shard N runs under torchrun --nproc-per-node N: each rank holds one
block of the lattice (parallel/fused_sharded picks the mesh), on
cuda:LOCAL_RANK over NCCL, or over gloo with --device cpu; the probes go to
rank 0 in one collective a step (a window), and rank 0 alone writes the
CSVs. --shard N --multistep K runs K-step windows on an (N, 1) mesh of
y-shards with K-row ghost slabs (NONE under either wall type, or FFT +
bounce-back; --shard 1 allowed).
--checkpoint-every N writes <out>/ckpt_<step>.npz whenever a step (a
window end under --multistep) reaches a multiple of N, and every run ends
with <out>/final_state.npz; --resume PATH continues a checkpoint of either
package (io/checkpoint: the JAX package's npz layout) toward --steps, the
absolute target. Under --shard every rank loads the file and keeps its
block, and rank 0 writes the gathered state. --watchdog-every N checks the
state for non-finite values every N steps (per step at (t + 1) % N == 0,
as the JAX CLI; under --multistep after each window that crosses a
multiple of N, where the JAX CLI tests the window's first step alone and
never checks under an even K and N) and raises BlowupError; under --shard
the flag is all-reduced first. --profile DIR writes a torch.profiler
trace of the timed loop.
Video (on unless --no-video): the density, velocity and temperature
frames of the pre-step macros whenever t % --video-every == 0 (under
--multistep one frame a window, at window starts, as the JAX CLI samples),
rendered on the device (io/colormap) and encoded on a host thread
(io/video) into <out>/video/video_{density,velocity,temperature}: mp4v
where cv2 is present, else the native AVI (g++), else GIF (PIL), each tile
row under a 30-px label strip. Under --shard each rank renders the index
tiles of its block and rank 0 gathers and assembles them. After the CSVs,
<out>/graphs/plot_<q>.png (matplotlib; skipped with a message without it)
unless --no-plots.
main(argv) returns a summary dict (the probe series, on rank 0 under
--shard, the video paths, and each kernel's launch count included).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Optional, Sequence

import torch

from . import config as C
from .io import checkpoint as ckpt
from .io import colormap, debug_dump, probes, profile, timing, video
from .kernels import (collide_pallas, fft_tpu, fused_multistep, fused_step,
                      poisson_iter)
from .models import plasma, plasma_staged
from .parallel import fused_sharded, mesh as pmesh, sharding
from .utils.watchdog import Watchdog, state_is_finite

# each kernel wrapper's module, by the name of its TPU counterpart
KERNELS = {"collide_stream": fused_step, "fused_collide": collide_pallas,
           "solve_iter": poisson_iter,
           "collide_stream_multistep": fused_multistep,
           "fft_solve": fft_tpu}


def launch_counts() -> dict:
    """Every kernel's launches so far: KERNELS', the gated window's and the
    halo kernels'."""
    return {**{k: m.LAUNCHES for k, m in KERNELS.items()},
            "collide_stream_multistep_gated": fused_multistep.GATED_LAUNCHES,
            **fused_step.HALO_LAUNCHES}


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
    p.add_argument("--debug-dump", action="store_true",
                   help="per-stage grid dumps on small grids (NX<11) in the "
                        "C++ debug build's exact format (all 5 pipeline "
                        "stages every step); runs the staged plain step")
    p.add_argument("--debug-variant", action="store_true",
                   help="replicate the 'Plasma debug' predecessor build "
                        "(guard values, step-0 E pulse, true periodic "
                        "iterative sweeps) on the plain backend: the "
                        "configuration of the C++ debug_dump fixtures")
    p.add_argument("--shard", type=int, default=0, metavar="N",
                   help="shard the lattice over N ranks (run under torchrun "
                        "--nproc-per-node N): the halo-exchange step of "
                        "parallel.fused_sharded.make_fused_sharded_step_auto "
                        "(periodic walls, FFT or NONE); with --multistep K, "
                        "K-row ghost windows on an (N, 1) mesh "
                        "(make_fused_sharded_multistep_rollout: NONE, or "
                        "FFT + bounce-back)")
    p.add_argument("--checkpoint-every", type=int, default=0, metavar="N",
                   help="write <out>/ckpt_<step>.npz when a step (a window "
                        "end under --multistep) reaches a multiple of N")
    p.add_argument("--resume", default=None, metavar="PATH",
                   help="continue from a checkpoint of either package "
                        "toward --steps (an absolute target)")
    p.add_argument("--assume-ckpt-layout", choices=["classic", "delta"],
                   default=None,
                   help="declare the neutral-population layout of a "
                        "pre-metadata checkpoint (newer checkpoints record "
                        "it and don't need this)")
    p.add_argument("--watchdog-every", type=int, default=100, metavar="N",
                   help="NaN-watchdog cadence in steps (0 = off)")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler trace of the timed loop, "
                        "DIR/trace_rank<r>.json")
    p.add_argument("--no-video", action="store_true",
                   help="write no field videos")
    p.add_argument("--no-plots", action="store_true",
                   help="write no probe plots (the CSVs stay)")
    p.add_argument("--video-every", type=int, default=1, metavar="N",
                   help="a video frame when the loop's step t is a "
                        "multiple of N (0: none)")
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
    if args.debug_variant:
        # the C++ debug build's behaviour set (tests/test_reference_parity.py)
        over["compat"] = C.CompatFlags(
            none_solver_kills_external_field=False,
            dirichlet_iterative_under_periodic=False,
            debug_variant=True)
        over["backend"] = "plain"  # debug_variant mode is plain-backend only
    if args.multistep:
        if args.debug_dump or args.debug_variant:
            raise SystemExit("--multistep fuses whole windows; per-step/"
                             "per-stage dumps need per-step marching")
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
    if args.shard:
        _check_shard(args, cfg)
    # rank 0 writes the outputs; one process alone is rank 0
    rank0 = not args.shard or int(os.environ.get("RANK", 0)) == 0
    log = print if rank0 else (lambda *a, **k: None)

    if rank0:
        os.makedirs(args.out, exist_ok=True)
    stride = cfg.multistep or 1
    if args.checkpoint_every and args.checkpoint_every % stride:
        log(f"--checkpoint-every {args.checkpoint_every} is not a multiple "
            f"of --multistep {stride}: checkpoints are written only at the "
            f"window ends that reach a multiple of it")
    dmp = staged = m = None
    if args.debug_dump:
        dmp = debug_dump.DebugDumper(cfg, os.path.join(args.out,
                                                       "debug_dump.txt")
                                     if rank0 else os.devnull)
        if dmp.enabled:
            # per-stage dumps need the stage-granular step; tiny grids only
            # (under --shard every rank runs it, as the JAX CLI does)
            staged = plasma_staged.make_staged_step(cfg)
            feq = plasma_staged.init_feq(cfg, device)
    rec = probes.ProbeRecorder(cfg.NX, cfg.NY, device)
    own_group = False
    if args.shard and staged is None:
        own_group = not torch.distributed.is_initialized()
        device = pmesh.init_distributed(device)
    state = initial_state(args, cfg, device, log)
    start_step = state.step
    # one rollout per window length: stride steps, and the remainder
    lengths = {k for k in {stride, max(cfg.nsteps - start_step, 0) % stride}
               if k}
    if args.shard and staged is None:
        if cfg.multistep:
            m = pmesh.make_mesh((args.shard, 1), device.type)
            rollouts = {k: fused_sharded.make_fused_sharded_multistep_rollout(
                cfg, m, k) for k in lengths}
            what = "sharded multistep"
        else:
            step, m, _ = fused_sharded.make_fused_sharded_step_auto(
                cfg, args.shard, device.type)
            rollouts, what = {1: step}, "sharded"
        log(f"{what} over mesh {mesh_shape_of(m)}")
        # each rank keeps its block of the initial (or resumed) state
        state = sharding.shard_state(state, m)
        rec = probes.ShardedProbeRecorder(cfg.NX, cfg.NY, device,
                                          *sharding.block(
                                              cfg, m,
                                              torch.distributed.get_rank()))
    else:
        rollouts = {k: plasma.make_rollout(cfg, k) for k in lengths}
    vid = None
    if not args.no_video and args.video_every and rank0:
        vid = video.VideoRecorder(os.path.join(args.out, "video"), cfg.NX,
                                  cfg.NY, log=log)

    def record_video(mac):
        """This step's frames; under --shard every rank sends the tiles of
        its block, and rank 0 assembles and records them."""
        if m is None:
            if vid is not None:
                vid.record(mac)
            return
        panels = sharding.gather_to_rank0(
            colormap.index_panels(*colormap.macro_fields(mac)), m)
        if vid is not None:
            vid.record_panels(panels)

    wd = (Watchdog(every=args.watchdog_every,
                   group=None if m is None else torch.distributed.group.WORLD)
          if args.watchdog_every else None)

    def save(name, state):
        """Every rank takes part in the gather; rank 0 writes."""
        full = state if m is None else sharding.gather_state(state, m)
        if rank0:
            ckpt.save(os.path.join(args.out, name),
                      ckpt.with_fresh_phi(cfg, full),
                      neutral_delta=cfg.neutral_delta, storage=cfg.storage)
        return full

    if start_step >= cfg.nsteps:
        # --steps is an ABSOLUTE target (resume continues toward it)
        log(f"resume: checkpoint already at step {start_step} >= --steps "
            f"{cfg.nsteps}; nothing to run (raise --steps to continue "
            f"further)")
    launches0 = launch_counts()

    timer = timing.StepTimer(cfg.NX, cfg.NY)
    rank = torch.distributed.get_rank() if m is not None else 0
    with profile.trace(args.profile, device, rank):
        timer.start()
        for t in range(start_step, cfg.nsteps, stride):
            k = min(stride, cfg.nsteps - t)
            # Reference alignment: row t holds the macros computed at the
            # TOP of iteration t (the pre-step state) and the post-Poisson E
            # of the same iteration, which lives on the post-step state.
            # Under --multistep a row is a window: the macros before it, E
            # after it.
            if staged is not None:
                state, feq, stages = staged(state, feq)
                mac = stages["UpdateMacro"].mac
                for stage in plasma_staged.STAGES:
                    dmp.dump_stage(t, stage, stages[stage])
            else:
                mac = plasma.compute_macros(cfg, state)
                state = rollouts[k](state)
            timer.tick(k)
            if wd is not None:
                state = wd.check(t, state, k)
            rec.record(mac, state.Ex, state.Ey)
            if (not args.no_video and args.video_every
                    and t % args.video_every == 0):
                record_video(mac)
            if args.checkpoint_every and (t + k) % args.checkpoint_every == 0:
                save(f"ckpt_{t + k:06d}.npz", state)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        wall_ms = timer.wall_s * 1000
        mlups = timer.mlups
    if vid is not None:
        vid.close()
    if dmp is not None:
        dmp.close()
    launches = {k: n - launches0[k] for k, n in launch_counts().items()}
    state = save("final_state.npz", state)
    if m is not None:
        n_devices = torch.distributed.get_world_size()
        if own_group:
            torch.distributed.destroy_process_group()
    else:
        n_devices = torch.cuda.device_count() if device.type == "cuda" else 1

    steps = max(cfg.nsteps - start_step, 0)
    series = rec.as_arrays()
    if rank0:
        rec.save_csv(os.path.join(args.out, "graphs"))
        if not args.no_plots:
            rec.save_plots(os.path.join(args.out, "graphs"))
        timing.append_timing_csv(
            os.path.join(args.out, "simulation_time_plasma_details.csv"),
            NX=cfg.NX, NY=cfg.NY, nsteps=steps, n_devices=n_devices,
            poisson=cfg.poisson.value, bc=cfg.bc.value, wall_ms=wall_ms)
    finite = state_is_finite(state)
    device_name = (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu")
    summary = dict(NX=cfg.NX, NY=cfg.NY, steps=steps, start_step=start_step,
                   wall_ms=wall_ms, mlups=mlups, device=device_name,
                   backend=cfg.backend, poisson=cfg.poisson.name,
                   bc=cfg.bc.name, storage=cfg.storage, dtype=str(cfg.dtype),
                   multistep=cfg.multistep, n_devices=n_devices,
                   mesh=None if m is None else mesh_shape_of(m),
                   launches=launches, finite=finite, probes=series,
                   video=None if vid is None else vid.paths, state=state)
    if not rank0:
        return summary
    print(f"Simulation ended: {cfg.NX}x{cfg.NY}, {steps} steps"
          + (f" from step {start_step}" if start_step else "") + ", "
          f"{wall_ms:.0f} ms ({mlups:.2f} MLUPS) on {device_name}, "
          f"backend {cfg.backend}, poisson {cfg.poisson.name}, "
          f"bc {cfg.bc.name}, storage {cfg.storage}, {cfg.dtype}"
          + (f", multistep {cfg.multistep}" if cfg.multistep else "")
          + "; kernel "
          f"launches " + ", ".join(f"{k} {n}" for k, n in launches.items())
          + (f"; {n_devices} ranks, mesh {summary['mesh']}" if m is not None
             else ""))
    return summary


def initial_state(args: argparse.Namespace, cfg: C.PlasmaConfig, device,
                  log=print) -> plasma.PlasmaState:
    """The initial state on `device`, or with --resume the checkpoint's, its
    neutral layout and storage reconciled with cfg (a pre-metadata file
    needs --assume-ckpt-layout)."""
    if not args.resume:
        return plasma.init_state(cfg, device)
    try:
        state = ckpt.load_for_run(args.resume, cfg, device,
                                  assume_layout=args.assume_ckpt_layout,
                                  log=log)
    except (OSError, ValueError) as e:
        raise SystemExit(f"--resume: {e}")
    log(f"resumed from {args.resume} at step {state.step}")
    return state


def mesh_shape_of(m) -> dict:
    return dict(zip(m.mesh_dim_names, m.shape))


def _check_shard(args: argparse.Namespace, cfg: C.PlasmaConfig) -> None:
    """Refuse what --shard cannot run, before any process group starts:
    the windows' rules on an (N, 1) mesh under --multistep (as
    scripts/run_plasma.py:194-218), else the auto mesh's."""
    world = int(os.environ.get("WORLD_SIZE", 1))
    if world != args.shard:
        raise SystemExit(f"--shard {args.shard}: the world has {world} "
                         f"ranks; run under torchrun --nproc-per-node "
                         f"{args.shard}")
    try:
        if cfg.multistep:
            fused_sharded.multistep_plan(cfg, (args.shard, 1))
        else:
            fused_sharded.pick_mesh(cfg, args.shard)
    except (ValueError, NotImplementedError) as e:
        raise SystemExit(f"--shard{' --multistep' if cfg.multistep else ''}"
                         f": {e}")
