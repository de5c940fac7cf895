"""3-D plasma column CLI of the port: scripts/run_plasma3d.py (BASELINE
config #5).

    python scripts/run_plasma3d_torch.py                  # 64^2x64, 50 steps
    python scripts/run_plasma3d_torch.py --n 128 --nz 128 --storage bf16
    python scripts/run_plasma3d_torch.py --device cpu --n 16 --nz 8 --steps 3
    torchrun --nproc-per-node 2 scripts/run_plasma3d_torch.py --device cpu \
        --shard 2 --n 16 --nz 8 --steps 3                 # 2 ranks, gloo
    torchrun --nproc-per-node 2 scripts/run_plasma3d_torch.py --shard 2 \
        --multistep 8 --poisson NONE                      # K-slice windows
    python scripts/run_plasma3d_torch.py --steps 30 --checkpoint-every 10
    python scripts/run_plasma3d_torch.py \
        --resume build/output/torch_3d/ckpt_000030.npz

Defaults: FFT Poisson, periodic, --backend fused (the CUDA collide+stream
kernel) on --device cuda, f32 with neutral-delta storage (--f64 turns it
off). There is no silent CPU fallback: without a GPU, --device cuda raises;
only an explicit --device cpu runs on the CPU, with the plain backend.
--slice-every N writes the z-midplane rho_e and rho_q every N steps as
slice_<step>.npz and, where matplotlib is present, as the JAX CLI's figure
slice_<step>.png (rho_e, and rho_q in RdBu_r). The timing CSV row goes to
<out>/simulation_time_3d.csv.
--checkpoint-every N writes <out>/ckpt_<step>.npz whenever a step (a window
end under --multistep) reaches a multiple of N, and every run ends with
<out>/final_state.npz; --resume PATH continues a checkpoint of either
package (io/checkpoint) toward --steps, the absolute target
(--assume-ckpt-layout declares a pre-metadata file's neutral layout).
--profile DIR writes a torch.profiler trace of the timed loop.
--shard N runs under torchrun --nproc-per-node N: each rank holds one block
of the column on the mesh parallel.fused_sharded.make_fused_sharded_step3d_auto
picks (z-shards, y-shards or (dz, dy) tiles), on cuda:LOCAL_RANK over NCCL,
or over gloo with --device cpu (the kernels' plain versions); with
--multistep K (and --poisson NONE) the column is z-sharded over N ranks and
advances in K-step windows of K-slice ghost slabs
(make_fused_sharded_multistep_rollout_3d; --shard 1 is allowed), slices
then sample at window boundaries. Rank 0 gathers the state and alone writes
the slices, the checkpoints and the CSV; every rank loads a resumed file
and keeps its block. main(argv) returns a summary dict (the state and
each kernel's launch count included).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from . import config as C
from .io import checkpoint as ckpt
from .io import profile, timing
from .kernels import fused_step3d
from .models import plasma3d
from .parallel import fused_sharded, mesh as pmesh, sharding
from .utils.watchdog import state_is_finite


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
                        "slice_<step>.npz, and slice_<step>.png where "
                        "matplotlib is present, every N steps (0: never)")
    p.add_argument("--out", default=os.path.join("build", "output",
                                                 "torch_3d"))
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda, cuda:N or cpu")
    p.add_argument("--shard", type=int, default=0, metavar="N",
                   help="shard the column over N ranks (run under torchrun "
                        "--nproc-per-node N): z-shards, y-shards or (dz, dy) "
                        "tiles, as parallel.fused_sharded."
                        "make_fused_sharded_step3d_auto picks")
    p.add_argument("--multistep", type=int, default=0, metavar="K",
                   help="with --shard N and --poisson NONE: K steps a "
                        "window on an (N, 1) dz mesh, one exchange of "
                        "K-slice ghost slabs a window (parallel."
                        "fused_sharded.make_fused_sharded_multistep_"
                        "rollout_3d); slices sample at window boundaries")
    p.add_argument("--checkpoint-every", type=int, default=0, metavar="N",
                   help="write <out>/ckpt_<step>.npz when a step (a window "
                        "end under --multistep) reaches a multiple of N")
    p.add_argument("--resume", default=None, metavar="PATH",
                   help="continue from a checkpoint of either package "
                        "toward --steps (an absolute target)")
    p.add_argument("--assume-ckpt-layout", choices=["classic", "delta"],
                   default=None,
                   help="declare the neutral layout of a pre-metadata "
                        "checkpoint (newer checkpoints record it)")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler trace of the timed loop, "
                        "DIR/trace_rank<r>.json")
    return p.parse_args(argv)


def build_config(args: argparse.Namespace) -> C.PlasmaConfig:
    if args.storage == "bf16" and args.f64:
        raise SystemExit("--storage bf16 is an f32 fast mode (drop --f64)")
    if args.multistep:
        # 3-D temporal blocking is the multi-device K-slab protocol only
        if not args.shard:
            raise SystemExit("--multistep is multi-chip only in 3-D: add "
                             "--shard N")
        if args.poisson != "NONE":
            raise SystemExit("--multistep (3-D) needs --poisson NONE "
                             "(window-constant E; FFT is a global "
                             "per-step solve)")
    try:
        return dataclasses.replace(
            C.preset_plasma_3d(args.n, args.nz), nsteps=args.steps,
            poisson=C.PoissonSolver[args.poisson],
            backend="fused" if args.multistep else args.backend,
            multistep=args.multistep,
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
    rho_e = mac.rho[0, zmid].double().cpu().numpy()
    rho_q = mac.rho_q[zmid].double().cpu().numpy()
    np.savez(path, step=state.step, rho_e=rho_e, rho_q=rho_q)
    try:
        import matplotlib
    except ImportError:
        return
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    # the figure of scripts/run_plasma3d.py:202-212
    fig, axes = plt.subplots(1, 2, figsize=(9, 4), dpi=100)
    im = axes[0].imshow(rho_e, origin="lower")
    fig.colorbar(im, ax=axes[0], label="rho_e")
    im = axes[1].imshow(rho_q, origin="lower", cmap="RdBu_r")
    fig.colorbar(im, ax=axes[1], label="rho_q")
    fig.suptitle(f"z-midplane, step {state.step}")
    fig.tight_layout()
    fig.savefig(os.path.splitext(path)[0] + ".png")
    plt.close(fig)


def launch_counts() -> dict:
    """The 3-D kernels' launches so far, by the TPU kernels' names."""
    return {"collide_stream3d": fused_step3d.LAUNCHES,
            **fused_step3d.HALO_LAUNCHES}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda: no CUDA device is available "
                               "(pass --device cpu to run on the CPU)")
    elif device.type == "cpu":
        # under --shard the kernels' plain versions run on CPU tensors
        if args.backend != "plain" and not args.shard:
            print(f"--device cpu: the {args.backend} backend's kernel needs "
                  f"a GPU, using the plain backend")
            args.backend = "plain"
    else:
        raise SystemExit(f"--device {args.device}: want cuda[:N] or cpu")
    cfg = build_config(args)
    if args.shard:
        world = int(os.environ.get("WORLD_SIZE", 1))
        if world != args.shard:
            raise SystemExit(f"--shard {args.shard}: the world has {world} "
                             f"ranks; run under torchrun --nproc-per-node "
                             f"{args.shard}")
        if not cfg.multistep:
            try:
                fused_sharded.pick_mesh3d(cfg, args.shard)
            except ValueError as e:
                raise SystemExit(f"--shard: {e}")
    own_group = bool(args.shard) and not dist.is_initialized()
    try:
        return _run(args, cfg, device)
    finally:
        if own_group and dist.is_initialized():
            dist.destroy_process_group()


def _run(args: argparse.Namespace, cfg: C.PlasmaConfig,
         device: torch.device) -> dict:
    stride = cfg.multistep or 1
    m = None
    if args.shard:
        device = pmesh.init_distributed(device)
    rank0 = not args.shard or dist.get_rank() == 0
    log = print if rank0 else (lambda *a, **k: None)
    if args.checkpoint_every and args.checkpoint_every % stride:
        log(f"--checkpoint-every {args.checkpoint_every} is not a multiple "
            f"of --multistep {stride}: checkpoints are written only at the "
            f"window ends that reach a multiple of it")
    state = initial_state(args, cfg, device, log)
    start_step = state.step
    lengths = {k for k in {stride, max(cfg.nsteps - start_step, 0) % stride}
               if k}
    if args.shard:
        if cfg.multistep:
            m = pmesh.make_mesh3d((args.shard, 1), device.type)
            try:
                rollouts = {
                    k: fused_sharded.make_fused_sharded_multistep_rollout_3d(
                        cfg, m, k) for k in lengths}
            except ValueError as e:
                raise SystemExit(f"--shard --multistep: {e}")
            log(f"sharded 3-D multistep (K={stride}-slab ghosts) over "
                f"{args.shard}-device dz mesh")
        else:
            step, m, _ = fused_sharded.make_fused_sharded_step3d_auto(
                cfg, args.shard, device.type)
            rollouts = {1: step}
            log(f"sharded over mesh {dict(zip(m.mesh_dim_names, m.shape))}")
        # each rank keeps its block of the initial (or resumed) state
        state = sharding.shard_state3d(state, m)
    else:
        rollouts = {1: plasma3d.make_step(cfg)}
    if rank0:
        os.makedirs(args.out, exist_ok=True)
    if start_step >= cfg.nsteps:
        # --steps is an ABSOLUTE target (resume continues toward it)
        log(f"resume: checkpoint already at step {start_step} >= --steps "
            f"{cfg.nsteps}; nothing to run (raise --steps to continue "
            f"further)")
    launches0 = launch_counts()

    def save(name, full):
        if rank0:
            ckpt.save3d(os.path.join(args.out, name), full,
                        neutral_delta=cfg.neutral_delta, storage=cfg.storage)

    timer = timing.StepTimer(cfg.NX, cfg.NY * cfg.NZ)
    with profile.trace(args.profile, device, 0 if m is None
                       else dist.get_rank()):
        timer.start()
        for t in range(start_step, cfg.nsteps, stride):
            k = min(stride, cfg.nsteps - t)
            state = rollouts[k](state)
            timer.tick(k)
            at_ckpt = bool(args.checkpoint_every
                           and (t + k) % args.checkpoint_every == 0)
            at_slice = bool(args.slice_every
                            and (t + k) % args.slice_every == 0)
            if at_ckpt or at_slice:
                # every rank takes part in the gather; rank 0 writes
                full = (state if m is None
                        else sharding.gather_state3d(state, m))
                if at_ckpt:
                    save(f"ckpt_{t + k:06d}.npz", full)
                if at_slice and rank0:
                    write_slice(os.path.join(args.out,
                                             f"slice_{t + k:05d}.npz"),
                                cfg, full)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        wall_ms = timer.wall_s * 1000
        mlups = timer.mlups
    launches = {k: n - launches0[k] for k, n in launch_counts().items()}
    if m is not None:
        state = sharding.gather_state3d(state, m)
        n_devices = dist.get_world_size()
    else:
        n_devices = torch.cuda.device_count() if device.type == "cuda" else 1
    save("final_state.npz", state)

    steps = max(cfg.nsteps - start_step, 0)
    if rank0:
        timing.append_timing_csv(
            os.path.join(args.out, "simulation_time_3d.csv"),
            NX=cfg.NX, NY=cfg.NY * cfg.NZ, nsteps=steps,
            n_devices=n_devices, poisson=cfg.poisson.value, bc=0,
            wall_ms=wall_ms)
    finite = state_is_finite(state)
    device_name = (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu")
    summary = dict(NX=cfg.NX, NY=cfg.NY, NZ=cfg.NZ, steps=steps,
                   start_step=start_step, wall_ms=wall_ms, mlups=mlups,
                   device=device_name, backend=cfg.backend,
                   poisson=cfg.poisson.name, storage=cfg.storage,
                   dtype=str(cfg.dtype), neutral_delta=cfg.neutral_delta,
                   multistep=cfg.multistep, n_devices=n_devices,
                   mesh=None if m is None else dict(zip(m.mesh_dim_names,
                                                        m.shape)),
                   launches=launches, finite=finite, state=state)
    if rank0:
        print(f"3D column done: {cfg.NX}^2x{cfg.NZ}, {steps} steps"
              + (f" from step {start_step}" if start_step else "") + ", "
              f"{wall_ms:.0f} ms ({mlups:.2f} MLUPS) on {device_name}, "
              f"backend {cfg.backend}, poisson {cfg.poisson.name}, storage "
              f"{cfg.storage}, {cfg.dtype}, neutral delta "
              f"{cfg.neutral_delta}"
              + (f", multistep {cfg.multistep}" if cfg.multistep else "")
              + (f"; {n_devices} ranks, mesh {summary['mesh']}"
                 if m is not None else "")
              + "; kernel launches "
              + ", ".join(f"{k} {n}" for k, n in launches.items()))
    return summary


def initial_state(args: argparse.Namespace, cfg: C.PlasmaConfig, device,
                  log=print) -> plasma3d.Plasma3DState:
    """The initial column on `device`, or with --resume the checkpoint's, its
    neutral layout and storage reconciled with cfg (a pre-metadata file
    needs --assume-ckpt-layout)."""
    if not args.resume:
        return plasma3d.init_state(cfg, device)
    try:
        state = ckpt.load_for_run(args.resume, cfg, device,
                                  assume_layout=args.assume_ckpt_layout,
                                  log=log)
    except (OSError, ValueError) as e:
        raise SystemExit(f"--resume: {e}")
    log(f"resumed from {args.resume} at step {state.step}")
    return state