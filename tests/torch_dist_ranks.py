"""Rank bodies of tests/test_torch_sharded.py,
tests/test_torch_cavity_sharded.py, tests/test_torch_sharded3d.py,
tests/test_torch_multistep_sharded.py, tests/test_torch_checkpoint.py and
tests/test_torch_video.py (not collected), and spawn(), which runs them.

    python tests/torch_dist_ranks.py SCENARIO RANK WORLD INIT_FILE OUT_DIR

Each rank is its own process on the CPU: it joins a gloo group through a
file:// store, runs SCENARIO, and rank 0 writes what the test compares to
OUT_DIR/result.pt. It imports torch and lbm_tpu_torch only, never JAX.
"""
from __future__ import annotations

import dataclasses
import os
import subprocess
import sys

import numpy as np
import torch
import torch.distributed as dist

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, REPO)

from lbm_tpu_torch.config import (BC, CavityConfig,  # noqa: E402
                                  PlasmaConfig, PoissonSolver)
from lbm_tpu_torch.models import cavity, plasma, plasma3d  # noqa: E402
from lbm_tpu_torch.parallel import fused_sharded, mesh, sharding  # noqa: E402


def spawn(scenario: str, world: int, tmp):
    """Run `scenario` on `world` rank processes (tmp: a pathlib.Path for
    the store and the result); returns rank 0's result."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_dist_ranks.py"), scenario,
         str(r), str(world), str(tmp / "store"), str(tmp)],
        cwd=tmp, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}:\n{log[-3000:]}"
    return torch.load(tmp / "result.pt", weights_only=False)  # our own file

# (label, mesh shape, NY, NX, solver, dtype, storage, neutral_delta)
STEP_CASES = [
    ("y4_fft", (4, 1), 64, 32, "FFT", torch.float64, "native", False),
    ("y4_none", (4, 1), 64, 32, "NONE", torch.float64, "native", False),
    ("yx22_fft", (2, 2), 64, 64, "FFT", torch.float64, "native", False),
    ("x4_fft", (1, 4), 64, 64, "FFT", torch.float64, "native", False),
    ("y4_none_bf16", (4, 1), 64, 32, "NONE", torch.float32, "bf16", True),
]
STEPS = 3


def case_config(ny: int, nx: int, solver: str, dtype, storage: str,
                delta: bool) -> PlasmaConfig:
    return PlasmaConfig(NX=nx, NY=ny, dtype=dtype, storage=storage,
                        neutral_delta=delta,
                        poisson=PoissonSolver[solver])


def steps_on_meshes(out_dir: str) -> None:
    """Every STEP_CASES case for STEPS steps through its sharded step
    (the 1-D step on (n, 1), the 2-D step otherwise); rank 0 saves the
    gathered states."""
    results = {}
    for label, shape, ny, nx, solver, dtype, storage, delta in STEP_CASES:
        cfg = case_config(ny, nx, solver, dtype, storage, delta)
        m = mesh.make_mesh(shape, "cpu")
        make = (fused_sharded.make_fused_sharded_step if shape[1] == 1
                else fused_sharded.make_fused_sharded_step_2d)
        step = make(cfg, m)
        state = sharding.shard_state(plasma.init_state(cfg, "cpu"), m)
        for _ in range(STEPS):
            state = step(state)
        full = sharding.gather_state(state, m)
        results[label] = {k: getattr(full, k) for k in
                          ("f", "g", "Ex", "Ey", "phi")}
    if dist.get_rank() == 0:
        torch.save(results, os.path.join(out_dir, "result.pt"))


def ring_and_cli(out_dir: str) -> None:
    """On two ranks: ring_shift one step either way (the peer ahead is the
    peer behind), the CLI's refusal of --shard 3, then the CLI with
    --shard 2; rank 0 saves what each rank received and the probes."""
    from lbm_tpu_torch import run_plasma

    m = mesh.make_mesh((2, 1), "cpu")
    r = dist.get_rank()
    mine = [torch.full((3,), float(r)), torch.arange(4.0) + 10 * r,
            torch.full((2, 2), r, dtype=torch.bfloat16)]
    got = {step: mesh.ring_shift(mine, m, mesh.AXIS_Y, step)
           for step in (1, -1)}
    received = [None] * 2
    dist.all_gather_object(received, {s: [t.float().tolist() for t in v]
                                      for s, v in got.items()})
    try:
        run_plasma.main(["--device", "cpu", "--shard", "3", "--out",
                         os.path.join(out_dir, "refused")])
        refused = None
    except SystemExit as e:
        refused = str(e)
    summary = run_plasma.main([
        "--device", "cpu", "--shard", "2", "--nx", "32", "--ny", "32",
        "--steps", "3", "--f64", "--poisson", "FFT", "--no-video",
        "--no-plots", "--out", os.path.join(out_dir, "cli")])
    if r == 0:
        torch.save({"received": received, "refused": refused,
                    "probes": summary["probes"], "mesh": summary["mesh"],
                    "launches": summary["launches"],
                    "f": summary["state"].f}, os.path.join(out_dir,
                                                           "result.pt"))


# the cavity on a (world, 1) mesh: (label, NY, NX, dtype, storage, path,
# steps, K); path "stored" and "lean" march make_fused_sharded_cavity_step,
# "rollout" runs make_fused_sharded_cavity_rollout (lean), "window"
# make_fused_sharded_cavity_multistep_rollout
F64, F32 = torch.float64, torch.float32
CAVITY_CASES = {
    4: [("f64_stored", 64, 48, F64, "native", "stored", 30, 0),
        ("f64_lean", 64, 48, F64, "native", "lean", 30, 0),
        ("bf16_stored", 64, 48, F32, "bf16", "stored", 20, 0),
        ("bf16_lean", 64, 48, F32, "bf16", "rollout", 20, 0),
        ("window_16_8", 32, 48, F64, "native", "window", 16, 8)],
    2: [("f64_stored", 64, 48, F64, "native", "stored", 30, 0),
        ("f64_lean", 64, 48, F64, "native", "lean", 30, 0),
        ("f32_lean_marching", 32, 32, F32, "native", "lean", 12, 0),
        ("f32_lean_rollout", 32, 32, F32, "native", "rollout", 12, 0),
        ("window_23_5", 32, 48, F64, "native", "window", 23, 5)],
}
# the sharded cavity CLI's runs on two ranks: (label, extra flags)
CAVITY_CLI = [("stored", []), ("multistep", ["--multistep", "4"])]
CAVITY_CLI_ARGS = ["--device", "cpu", "--nx", "32", "--steps", "30", "--f64",
                   "--no-video"]


def cavity_config(NY, NX, dtype, storage, path, K) -> CavityConfig:
    return CavityConfig(NX=NX, NY=NY, dtype=dtype, storage=storage,
                        backend="fused", lean_macros=path in ("lean",
                                                              "rollout"),
                        multistep=K)


def cavity_runs(out_dir: str) -> None:
    """Every CAVITY_CASES case of this world size through its sharded path;
    on two ranks also the CLI's refusal of --shard 3 and its CAVITY_CLI
    runs. Rank 0 saves the gathered states."""
    from lbm_tpu_torch import run_cavity

    n = dist.get_world_size()
    m = mesh.make_mesh((n, 1), "cpu")
    results = {}
    for label, NY, NX, dtype, storage, path, steps, K in CAVITY_CASES[n]:
        cfg = cavity_config(NY, NX, dtype, storage, path, K)
        state = sharding.shard_cavity_state(cavity.init_state(cfg, "cpu"), m)
        if path in ("stored", "lean"):
            step = fused_sharded.make_fused_sharded_cavity_step(cfg, m)
            for _ in range(steps):
                state = step(state)
        elif path == "rollout":
            state = fused_sharded.make_fused_sharded_cavity_rollout(
                cfg, m, steps)(state)
        else:
            state = fused_sharded.make_fused_sharded_cavity_multistep_rollout(
                cfg, m, steps)(state)
        results[label] = sharding.gather_cavity_state(state, m)
    if n == 2:
        try:
            run_cavity.main(["--device", "cpu", "--shard", "3", "--out",
                             os.path.join(out_dir, "refused")])
            results["refused"] = None
        except SystemExit as e:
            results["refused"] = str(e)
        for label, flags in CAVITY_CLI:
            summary = run_cavity.main(
                [*CAVITY_CLI_ARGS, "--shard", "2", "--out",
                 os.path.join(out_dir, "cli_" + label), *flags])
            results["cli_" + label] = {k: summary[k] for k in (
                "launches", "state", "n_devices", "finite", "mass_drift")}
    if dist.get_rank() == 0:
        torch.save(results, os.path.join(out_dir, "result.pt"))


# the 3-D column, by world size: (label, step, mesh shape, NZ, NY, NX,
# solver, dtype, storage, neutral_delta); step "auto" takes
# make_fused_sharded_step3d_auto's pick (its mesh is saved)
STEP3D_CASES = {
    4: [("z4_fft", "z", (4, 1), 8, 16, 8, "FFT", F64, "native", False),
        ("z4_none", "z", (4, 1), 8, 16, 8, "NONE", F64, "native", False),
        ("y4_fft", "y", (1, 4), 4, 32, 8, "FFT", F64, "native", False),
        ("y4_none_bf16", "y", (1, 4), 4, 32, 8, "NONE", F32, "bf16", True),
        ("yz22_fft", "yz", (2, 2), 4, 16, 8, "FFT", F64, "native", False),
        ("yz22_none", "yz", (2, 2), 4, 16, 8, "NONE", F64, "native", False),
        ("auto4_fft", "auto", None, 4, 16, 8, "FFT", F64, "native", False)],
    2: [("z2_none_f32", "z", (2, 1), 8, 16, 8, "NONE", F32, "native", True),
        ("y2_fft", "y", (1, 2), 4, 16, 8, "FFT", F64, "native", False),
        ("yz12_fft", "yz", (1, 2), 4, 16, 8, "FFT", F64, "native", False),
        ("yz21_none_bf16", "yz", (2, 1), 4, 16, 8, "NONE", F32, "bf16",
         True),
        ("auto2_fft", "auto", None, 8, 16, 8, "FFT", F64, "native", False)],
}
# the 3-D windows on a (world, 1) mesh: (label, NZ, K, steps, kill)
WINDOW3D_CASES = {
    4: [("k1_kill", 12, 1, 3, True), ("k3_keep", 12, 3, 7, False)],
    2: [("k3_kill", 8, 3, 7, True), ("k1_keep", 8, 1, 3, False)],
}
STEPS3D = 3
# the sharded 3-D CLI's runs on two ranks: (label, flags)
CLI3D = [("fft", ["--steps", "3", "--f64", "--slice-every", "3"]),
         ("window", ["--steps", "5", "--multistep", "2", "--poisson", "NONE",
                     "--slice-every", "4"])]
CLI3D_ARGS = ["--device", "cpu", "--n", "16", "--nz", "8"]


def config3d(NZ, NY, NX, solver, dtype, storage, delta, K=0, kill=True
             ) -> PlasmaConfig:
    cfg = PlasmaConfig(NX=NX, NY=NY, NZ=NZ, dtype=dtype, storage=storage,
                       neutral_delta=delta, poisson=PoissonSolver[solver],
                       backend="fused" if K else "plain", multistep=K)
    return dataclasses.replace(cfg, compat=dataclasses.replace(
        cfg.compat, none_solver_kills_external_field=kill))


def seeded_state3d(cfg: PlasmaConfig, label: str):
    """The initial column with a relative perturbation of ~1e-3 of f, g and
    Ex and an additive one of Ey and Ez (numpy, float64, seeded from the
    case's label), so that nothing is uniform in z."""
    state = plasma3d.init_state(cfg, "cpu")
    rng = np.random.default_rng([ord(c) for c in label])
    e = 1e-3 * float(state.Ex.abs().max())

    def perturb(t, additive=0.0):
        a = t.double().numpy()
        noise = rng.standard_normal(a.shape)
        return torch.from_numpy(a * (1 + 1e-3 * noise) + additive * noise
                                ).to(t.dtype).contiguous()

    return state._replace(f=perturb(state.f), g=perturb(state.g),
                          Ex=perturb(state.Ex), Ey=perturb(state.Ey, e),
                          Ez=perturb(state.Ez, e))


STEP3D_MAKERS = {"z": "make_fused_sharded_step3d",
                 "y": "make_fused_sharded_step3d_y",
                 "yz": "make_fused_sharded_step3d_yz"}


def column_runs(out_dir: str) -> None:
    """Every STEP3D_CASES and WINDOW3D_CASES case of this world size from
    its seeded state through its sharded path; on two ranks also the 3-D
    CLI's refusals and its CLI3D runs. Rank 0 saves the gathered states."""
    from lbm_tpu_torch import run_plasma3d

    n = dist.get_world_size()
    results = {}
    for label, kind, shape, *grid in STEP3D_CASES[n]:
        cfg = config3d(*grid)
        if kind == "auto":
            step, m, shard_fn = fused_sharded.make_fused_sharded_step3d_auto(
                cfg, n, "cpu")
            results[label + "_mesh"] = tuple(m.shape)
        else:
            m = mesh.make_mesh3d(shape, "cpu")
            step = getattr(fused_sharded, STEP3D_MAKERS[kind])(cfg, m)
        state = sharding.shard_state3d(seeded_state3d(cfg, label), m)
        for _ in range(STEPS3D):
            state = step(state)
        results[label] = sharding.gather_state3d(state, m)
    m = mesh.make_mesh3d((n, 1), "cpu")
    for label, NZ, K, steps, kill in WINDOW3D_CASES[n]:
        cfg = config3d(NZ, 8, 8, "NONE", F64, "native", False, K, kill)
        state = sharding.shard_state3d(seeded_state3d(cfg, label), m)
        state = fused_sharded.make_fused_sharded_multistep_rollout_3d(
            cfg, m, steps)(state)
        results["window_" + label] = sharding.gather_state3d(state, m)
    if n == 2:
        for flags in (["--shard", "3"],
                      ["--shard", "2", "--multistep", "5", "--poisson",
                       "NONE"]):
            try:
                run_plasma3d.main([*CLI3D_ARGS, *flags, "--out",
                                   os.path.join(out_dir, "refused")])
                results["refused", flags[1]] = None
            except SystemExit as e:
                results["refused", flags[1]] = str(e)
        for label, flags in CLI3D:
            summary = run_plasma3d.main(
                [*CLI3D_ARGS, "--shard", "2", *flags, "--out",
                 os.path.join(out_dir, "cli3d_" + label)])
            results["cli3d_" + label] = {k: summary[k] for k in (
                "launches", "state", "n_devices", "mesh", "finite")}
    if dist.get_rank() == 0:
        torch.save(results, os.path.join(out_dir, "result.pt"))


# the 2-D plasma's windows (K = 8) by world size: (label, mesh shape, NY,
# NX, solver, bc, dtype, storage, neutral_delta, kill quirk, steps); the
# JAX package's shapes (tests/test_fused_multistep.py:269-297, 559-620)
WINDOW_K = 8
WINDOW_CASES = {
    4: [("none_keep_delta", (4, 1), 64, 24, "NONE", "periodic", F64,
         "native", True, False, 19),
        ("none_bb_16", (4, 1), 64, 24, "NONE", "bounceback", F64, "native",
         False, True, 16),
        ("bf16_delta_bb", (4, 1), 64, 24, "NONE", "bounceback", F32, "bf16",
         True, True, 19),
        ("tile22", (2, 2), 32, 16, "NONE", "periodic", F64, "native", False,
         True, 19)],
    2: [("none_kill", (2, 1), 64, 24, "NONE", "periodic", F64, "native",
         False, True, 19),
        ("none_bb_19", (2, 1), 64, 24, "NONE", "bounceback", F64, "native",
         False, True, 19),
        ("fft_bb", (2, 1), 64, 24, "FFT", "bounceback", F64, "native", False,
         True, 19),
        ("bf16_delta", (2, 1), 64, 24, "NONE", "periodic", F32, "bf16", True,
         True, 19)],
}
# the windowed CLI on two ranks, and a K beyond a shard's 16 rows
WINDOW_CLI = ["--device", "cpu", "--multistep", "4", "--nx", "32", "--ny",
              "32", "--steps", "10", "--bc", "bounceback", "--poisson",
              "NONE", "--f64", "--no-video", "--no-plots"]


def window_config(NY, NX, solver, bc, dtype, storage, delta, kill
                  ) -> PlasmaConfig:
    cfg = PlasmaConfig(NX=NX, NY=NY, dtype=dtype, storage=storage,
                       neutral_delta=delta, poisson=PoissonSolver[solver],
                       bc=BC.PERIODIC if bc == "periodic" else BC.BOUNCE_BACK,
                       backend="fused", multistep=WINDOW_K)
    return dataclasses.replace(cfg, compat=dataclasses.replace(
        cfg.compat, none_solver_kills_external_field=kill))


def window_runs(out_dir: str) -> None:
    """Every WINDOW_CASES case of this world size from the initial state
    through its sharded windows (y-shards on (n, 1), tiles otherwise); on
    two ranks also the windowed CLI (its printed lines kept) and its
    refusal of a K deeper than a shard. Rank 0 saves the gathered states."""
    import contextlib
    import io

    from lbm_tpu_torch import run_plasma

    n = dist.get_world_size()
    results = {}
    for label, shape, *grid, steps in WINDOW_CASES[n]:
        cfg = window_config(*grid)
        m = mesh.make_mesh(shape, "cpu")
        make = (fused_sharded.make_fused_sharded_multistep_rollout
                if shape[1] == 1 else
                fused_sharded.make_fused_sharded_multistep_rollout_2d)
        state = sharding.shard_state(plasma.init_state(cfg, "cpu"), m)
        state = make(cfg, m, steps)(state)
        results[label] = sharding.gather_state(state, m)
    if n == 2:
        m = mesh.make_mesh((2, 1), "cpu")
        try:
            run_plasma.main([*WINDOW_CLI, "--shard", "2", "--multistep",
                             "20", "--out", os.path.join(out_dir, "refused")])
            results["refused"] = None
        except SystemExit as e:
            results["refused"] = str(e)
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            summary = run_plasma.main([*WINDOW_CLI, "--shard", "2", "--out",
                                       os.path.join(out_dir, "cli")])
        results["cli"] = {k: summary[k] for k in (
            "launches", "probes", "mesh", "n_devices", "finite", "state")}
        results["cli"]["printed"] = printed.getvalue()
    if dist.get_rank() == 0:
        torch.save(results, os.path.join(out_dir, "result.pt"))


# the three CLIs under --shard 2: (label, CLI, flags, straight steps,
# steps to the checkpoint)
CHECKPOINT_CLI = [
    ("plasma_fft", "plasma", ["--nx", "32", "--ny", "32", "--f64",
                              "--watchdog-every", "1"], 4, 2),
    ("plasma_windows", "plasma", ["--nx", "32", "--ny", "32", "--multistep",
                                  "2", "--poisson", "NONE"], 6, 4),
    ("cavity_windows", "cavity", ["--nx", "32", "--multistep", "2"], 8, 4),
    ("column", "plasma3d", ["--n", "8", "--nz", "8", "--slice-every",
                            "0"], 3, 2)]


def checkpoint_runs(out_dir: str) -> None:
    """On two ranks, each CHECKPOINT_CLI case straight and as a
    checkpoint-and-resume pair, every rank loading the file; then a resume
    of the plasma case from a file whose NaN lies in rank 1's block, which
    the all-reduced watchdog must raise on both ranks. Rank 0 saves the
    final_state.npz files' states and each rank's BlowupError step."""
    from lbm_tpu_torch import run_cavity, run_plasma, run_plasma3d
    from lbm_tpu_torch.io import checkpoint
    from lbm_tpu_torch.utils.watchdog import BlowupError

    # no videos or plots: these runs test checkpoints
    quiet = {"plasma": ["--no-video", "--no-plots"], "cavity": ["--no-video"],
             "plasma3d": []}
    clis = {"plasma": (run_plasma.main, checkpoint.load),
            "cavity": (run_cavity.main, checkpoint.load_cavity),
            "plasma3d": (run_plasma3d.main, checkpoint.load3d)}
    results = {}
    for label, cli, flags, steps, at in CHECKPOINT_CLI:
        main, load = clis[cli]
        base = ["--device", "cpu", "--shard", "2", *quiet[cli], *flags]
        every = ["--checkpoint-every", str(at)]
        run = os.path.join(out_dir, label)
        main(base + ["--steps", str(steps), *every, "--out", run + "_a"])
        main(base + ["--steps", str(at), *every, "--out", run + "_b"])
        width = 7 if cli == "cavity" else 6
        ck = os.path.join(run + "_b", f"ckpt_{at:0{width}d}.npz")
        main(base + ["--steps", str(steps), *every, "--resume", ck,
                     "--out", run + "_c"])
        dist.barrier()
        results[label] = {r: load(os.path.join(run + r, "final_state.npz"),
                                  "cpu") for r in ("_a", "_c")}
    # a NaN in g of the bottom half: rank 1's rows of the (2, 1) mesh;
    # without a solve it reaches rank 0's rows only after 8 steps
    bad = results["plasma_fft"]["_c"]
    g = bad.g.clone()
    g[0, 0, 24, 5] = float("nan")
    path = os.path.join(out_dir, "nan.npz")
    if dist.get_rank() == 0:
        checkpoint.save(path, bad._replace(g=g, step=0),
                        neutral_delta=False, storage="native")
    dist.barrier()
    try:
        run_plasma.main(["--device", "cpu", "--shard", "2", "--nx", "32",
                         "--ny", "32", "--f64", "--poisson", "NONE",
                         "--steps", "5", "--resume", path, "--no-video",
                         "--no-plots", "--watchdog-every", "2", "--out",
                         os.path.join(out_dir, "nan")])
        raised = None
    except BlowupError as e:
        raised = e.step
    every_rank = [None] * 2
    dist.all_gather_object(every_rank, raised)
    results["blowup_steps"] = every_rank
    if dist.get_rank() == 0:
        torch.save(results, os.path.join(out_dir, "result.pt"))


# the video runs on two ranks (and on one, in the test): the plasma CLI
# without a solve (the sharded step is then bitwise the single-device one)
# and the cavity CLI, both through the native AVI writer
VIDEO_PLASMA = ["--device", "cpu", "--nx", "32", "--ny", "32", "--steps",
                "3", "--f64", "--poisson", "NONE", "--no-plots"]
VIDEO_CAVITY = ["--device", "cpu", "--nx", "32", "--steps", "60",
                "--video-every", "20"]


def video_runs(out_dir: str) -> None:
    """The plasma and cavity CLIs with --shard 2 and their videos on; rank
    0 saves the frames as read back from its AVIs."""
    from lbm_tpu_torch import run_cavity, run_plasma
    from lbm_tpu_torch.io.avi import read_frames

    os.environ["LBM_VIDEO_FORMAT"] = "avi"
    plasma = run_plasma.main([*VIDEO_PLASMA, "--shard", "2", "--out",
                              os.path.join(out_dir, "plasma")])
    cav = run_cavity.main([*VIDEO_CAVITY, "--shard", "2", "--out",
                           os.path.join(out_dir, "cavity")])
    if dist.get_rank() == 0:
        torch.save({"plasma": {k: read_frames(p)
                               for k, p in plasma["video"].items()},
                    "cavity": read_frames(cav["video"]),
                    "mesh": plasma["mesh"]},
                   os.path.join(out_dir, "result.pt"))
    else:
        assert plasma["video"] is None and cav["video"] is None


SCENARIOS = {"steps": steps_on_meshes, "ring_cli": ring_and_cli,
             "cavity": cavity_runs, "column": column_runs,
             "windows": window_runs, "checkpoint": checkpoint_runs,
             "video": video_runs}


def main(argv) -> None:
    scenario, rank, world, init_file, out_dir = argv
    torch.set_num_threads(1)
    os.environ.update(RANK=rank, WORLD_SIZE=world, LOCAL_RANK=rank)
    mesh.init_distributed("cpu", init_method=f"file://{init_file}")
    try:
        SCENARIOS[scenario](out_dir)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
