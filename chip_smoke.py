#!/usr/bin/env python
"""Smoke test of the PyTorch/CUDA port (lbm_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's paths on the card and fails (nonzero exit) if any
phase fails:

  1. environment: nvidia-smi's name and power limit, torch, CUDA, nvcc;
  2. build: compiles the CUDA kernels from lbm_tpu_torch/kernels/csrc;
  3. kernel vs plain: one collide_stream call each way on the same seeded
     state, at 37x53 and 200x200, in f64, f32 and bf16 storage, with and
     without neutral-delta storage, each within its stated tolerance; and
     at the tile program's run edges (rows of 1, 3, 33, 37, 65 and 100
     sites, a one-row grid);
  3b. solve kernel vs plain sweeps: GS, SOR (omega 1.8) and NPS, interior-
     only and periodic, f64 and f32, at 37x53, 200x200 and 1024x1024, with
     tol 0 / 60 sweeps and with tol 1e-8 / max 5000 sweeps on the rho_q of
     a step, a phi0 holding a NaN and max_iter 0 (37x53); f32 at 1000^2
     (ragged tiles), 2048^2 and the first square past the tiled loop's
     shared-memory fit (tol 0 / 60 sweeps): phi and the sweep count
     bitwise, each plane's loop (tiled or streaming) printed, and both
     sides of the size dispatch run;
  3c. collide-only kernel vs its plain version: f64 and f32, with and
     without neutral-delta storage, at 37x53 and 200x200 and at the tile
     program's run edges, at phase 3's tolerances;
  4. golden run: lbm_tpu_torch.run_plasma.main at 200x200 for 200 steps in
     f64 through the kernel; its 19 probe series must match the compiled
     C++ reference fixture at rtol 1e-5 / atol 1e-5*scale, with exactly
     one kernel launch per step;
  4b. SOR + bounce-back: the CLI at 200x200 for 50 steps in f64 with the
     fused, pallas and plain backends; fused and pallas against plain at
     rtol 1e-12 / atol 1e-14*scale, with one launch of each of their
     kernels per step;
  5. real size: 2048^2 in f32 and in bf16 + neutral-delta storage, 5 warm-up
     and 30 timed steps (CUDA events); the state must stay finite;
  5b. real sizes of the other solvers and walls: 1024^2 and 2048^2 f32
     SOR + bounce-back + delta (fused), 256^2 f32 GS (fused), 4096^2 bf16 +
     delta NONE (fused), 2048^2 f32 FFT (pallas); ms/step, MLUPS, each
     kernel's ms and its plain version's, sweeps per solve; the solve's
     loop, us a sweep beside its barrier floor (the tiled loop's grid
     barrier and error reduction with no stencil work) and its flop bound;
     the state must stay finite;
  6a. cavity kernels vs their plain versions: stored, lean and multistep
     (K = 1, 4, 17 from step 8, across the lid ramp) on a seeded state
     warmed past the ramp, f64, f32 and bf16 storage, at 37x53 and
     129x129; bitwise, or for stored and lean within the ladder f64 1e-12
     relative, f32 4 ulp, bf16 f one bf16 ulp (multistep bitwise only);
     the step program's run edges (NX = 1, 3, 127, 129, 130, 256, 257, a
     ragged strip, on one-row spans; 2053x130: spans of several rows, the
     last ragged; 3x220000: NY = 3 below the plan's span), stored and
     lean from rest and seeded, bitwise; both window routes at K = 1,
     2, 17 on the largest square the resident route takes and the first
     past it (the route printed), bitwise;
  6b. Ghia: lbm_tpu_torch.run_cavity.main at 129^2, Re = 100, u_lid = 0.1,
     10,000 steps, stored f32 and f64, lean f32, multistep 100 f32, each
     within the gate of tests/test_cavity.py (max|du| < 0.035, rms < 0.02,
     max|dv| < 0.02, rms < 0.01), one launch a step (a window for
     multistep); f64 mass drift < 1e-12;
  6c. cavity real sizes: bench.py's legs (1000^2 lean f32 and bf16 stored,
     512^2 multistep 256, 2048^2 multistep 32) and 2048^2 stored and lean
     f32; ms/step, MLUPS, each kernel's device ms chained as the rollout
     chains it, from the rollout's end state (started from rest) and from a
     seeded state, beside its plain version's, its bound and the step
     program's issue floor, and the window's route; the state must stay
     finite.
  7a. the K-step window kernel vs its plain version on a seeded state, in
     every mode (NONE periodic with and without the quirk, NONE and FFT
     under bounce-back, FFT + periodic, GS periodic with and without the
     Dirichlet-sweep quirk, SOR + bounce-back, NPS periodic; 60 sweeps),
     f64, f32 and bf16 + delta, K = 1, 4, 17, at 7x3, 5x65, 37x53 and
     200x200, and K = 32 at 200x200;
     bitwise or the phase-3 ladder, the FFT mode within 1e-11 (f64) and
     1e-4 (f32) of scale (the plain version sums the DFT in the kernel's
     order);
  7b. the golden CLI in f64 with --multistep 8: exactly 25 window
     launches, the window rows against the C++ fixture (macros at rows
     t = 0, 8, ..., 192, E at rows t + 7) at rtol 1e-5 / atol 1e-5*scale;
  7c. real sizes: bench.py's three window legs (200^2 FFT K = 256 f32 and
     bf16 + delta, 256^2 NONE bf16 + delta K = 256) and 2048^2 / 4096^2
     NONE bf16 + delta K = 32, periodic and (2048^2) bounce-back, the last
     three held against the plain version on the rollout's end state;
     ms/step, MLUPS, device ms a launch (chained, and one input repeated on
     the initial state and on the rollout's end state), the plain version's
     ms, the bound (K times the collide stage's issue floor, or the bytes).
  8a. the 3-D collide_stream3d kernel vs its plain version on seeded warm
     states at 12x16x8, 16x16x1 and 17x13x2 (x, y, z), f64 and f32 with
     and without neutral-delta storage and bf16 + delta, at phase 3's
     tolerances, with the number of bitwise-equal elements; and bitwise in
     all six modes at the edges of the tile program's runs (rows of 1, 3,
     W + 1 = 65 and 33 sites, a ragged 100 = 64 + 36), which take its TMA
     and its cp.async staging routes;
  8b. the 3-D CLI with its defaults (lbm_tpu_torch.run_plasma3d.main: 64^3,
     50 steps, FFT, fused, f32 + delta): exactly 50 launches, a finite
     state, the kernel held against its plain version on the end state and
     timed; then --f64 for 3 steps: neutral mass drift < 1e-12;
  8c. 3-D real sizes with FFT: 128^3 bf16 + delta and f32 + delta, 256^3,
     512^2x64 and 1024^2x32 bf16 + delta (bench.py's 3-D legs and their
     neighbours), 2 warm-up + 6 timed steps: ms/step, MLUPS, the kernel's
     ms and its byte bound, the solve + E's ms (the plain version's ms at
     128^3; at 1024^2x32, 16 runs a row, the kernel held bitwise against
     the plain version slab by slab); and the kernel held against its plain
     version at the cross-
     sections where the JAX package routes to its split pair and panel
     kernel: 192^2 f32 + delta and 256^2, 512^2, 1024^2 bf16 + delta, NZ=4.
  9a. the spectral solve kernel (solve_fft_efield_tpu) vs its plain
     version (the permuted four-step, full-f32 products) at 1e-5 of scale,
     at 128^2, 128x256, 256x128, 256^2, 2048^2, 4096^2, 128x16384 and
     16384x128 on seeded rho (amplitude 1e-8), and on the rho_q of a warm
     seeded 2048^2 state; also vs the k-space cuFFT route
     (ops.poisson.solve_fft_efield) at 2e-5, the float64 answer at 1e-5,
     and the phi route (solve_fft + efield_periodic) at 2e-5 on the small
     grids (printed elsewhere); at 2048^2 and 4096^2 the kernel's device ms
     and its three passes' (rows_forward_pair, panel_solve,
     rows_inverse_tiled, torch.profiler) beside the phi route's and the
     44 B/site the passes move; a 32768-long axis is refused;
  9b. the 2-D fused step with fft_engine="pallas" at 2048^2, f32 and bf16 +
     delta, 5 warm-up + 30 timed steps: one solve launch a step (counts
     reset before the run), ms/step, MLUPS, the kernel's device ms and its
     passes' beside its bound, the plain version's and the two library
     routes'; the state finite, phi never formed, the kernel held on the
     end state's rho_q;
  9c. the --debug-variant --debug-dump CLI at 8x8 f64, FFT, on the card,
     against the C++ debug dump ref_dump_solver3 at rtol 3e-6 / atol
     max(3e-6*scale, 1e-15), every field of all 25 (step, stage) pairs.
  10a. the halo kernels (collide_stream_halo on y-shards, _halo2d on
     (y, x) tiles): a seeded warm full grid cut into 2, 4 and 8 y-shards
     and (2, 2), (2, 4), (4, 2) tiles, each shard's strips cut from its
     neighbours (1-row, or 8-deep with 8-column corners on two cuts), at
     2048^2 f32 and bf16 + delta, 512^2 f64, and ragged 24x40 and 25x22
     tiles; every shard bitwise equal to collide_stream on the full grid
     and within phase 3's gates of its plain version; each kernel's device
     ms at 2048^2 (a world of one) and at 512x2048 / 1024x1024 beside its
     bound and its plain version's;
  10b. the sharded steps (parallel.fused_sharded) on a one-rank NCCL group
     and a (1, 1) mesh: 2048^2 NONE f32 and bf16 + delta, 35 steps, both
     steps bitwise equal to the single-device fused step; 512^2 f64 FFT,
     20 steps, within 1e-11 (f, g) and 1e-9 (E) of it, each of the element
     and of the scale; 2048^2 FFT f32, 5 warm-up + 30 timed steps: ms/step,
     MLUPS, 35 launches of each halo kernel (counts reset just before),
     the sharded solve's ms beside the cuFFT route's.
  11a. the cavity's y-shard kernels (collide_stream_cavity_halo, _halo_lean
     on y-shards with strips; _multistep_gated on shards extended by K
     ghost rows, K = 1, 4, 17 from step 8): seeded warm full grids of
     2048^2 f32 and bf16 storage and 512^2 f64 cut into 2, 4 and 8
     y-shards (1-row strips, 8-row on the 4-cut), and 129^2 f64 cut into
     3 ragged 43-row shards; every shard bitwise equal to the single-device
     kernels on the full grid at its rows, and to its plain version (the
     window on its whole extended block; the gated window's routes
     printed: streaming at 2048^2, resident for K >= 2 on the 512^2 and
     129^2 cuts); each kernel's device ms at 2048^2
     (a world of one) and 512x2048 (a 4-card shard) beside its bound, its
     plain version's and the single-device kernels' on the same input;
  11b. the cavity CLI with --shard 1 on a one-rank NCCL group: 128^2, Re
     100, 2,000 steps, stored, --lean and --multistep 100, each bitwise
     equal to the single-device CLI's state, with 2,000 launches of the
     halo kernel (20 of the window); --shard 1 --multistep 100 at Ghia's
     129^2 for 10,000 steps within the Ghia gate;
  11c. 2048^2 f32 stored, lean and multistep K = 32 sharded over a world
     of one, beside the single-device rollouts: ms/step and MLUPS; the
     state finite, and the sharded end state bitwise equal to the
     single-device one.
  12a. the 3-D halo kernel (collide_stream_halo3d on z-shards,
     collide_stream_panel3d with halo_rows on y-shards, _panel3d_zhalo on
     (dz, dy) tiles): seeded warm 64^3 columns in f64, f32 and bf16 + delta
     cut into 2, 4 and 8 z-shards, 2 and 4 y-shards and (2, 2), (1, 2),
     (2, 1), (4, 2) tiles, and a 24x40x48 (x, y, z) f32 + delta column cut
     unevenly; every shard bitwise equal to collide_stream3d on the full
     grid at its sites and to its plain version;
  12b. the z-, y- and (1, 1) yz-sharded 3-D steps on a one-rank NCCL group
     at 64^3: NONE f32 + delta and bf16 + delta, 20 steps, bitwise equal to
     the single-device fused step, with 20 launches of each step's kernel
     (counts reset just before); f64 FFT, 10 steps, each from the single-
     device trajectory's state, within 1e-11 of scale;
     the K = 8 windows (20 steps, either kill setting) bitwise equal to the
     single-device rollout; then torchrun --nproc-per-node 1 of the 3-D CLI
     with --shard 1 --multistep 8 --poisson NONE: 50 launches, slices 40
     and 50 bitwise equal to the single-device CLI's;
  12c. the 3-D halo kernel at the shard shapes of a 256^3 column on 1 card
     (256^3 in each geometry) and on 4 (64x256x256 z, 256x64x256 y,
     128x128x256 tile), bf16 + delta and f32, beside collide_stream3d and
     the byte bound (928 / 472 B a shard site plus the strips' sites read);
     the plain version's ms at the 4-card shapes; the 256^3 bf16 + delta FFT
     z, y and yz steps over a world of one beside the single-device step,
     the z step's sharded solve + E beside rfftn's; the K = 8 NONE window
     at 256^3 beside the single-device step.
  13a. the gated window kernel (collide_stream_multistep_gated) bitwise
     against its plain version on a 37-row band of a seeded warm 74x53
     bounce-back state extended by K = 1, 4, 17 rows a side, with the walls
     at (K, K+R-1), (K, -1), (-1, K+R-1) and (-1, -1), NONE with the kill
     quirk on and off and FFT + bounce-back, in f64, f32 and bf16 + delta;
     and on every y-shard of 2/4/8-way cuts of 512^2 f64 (NONE, FFT) and
     2048^2 bf16 + delta (NONE), K = 8, bitwise against the whole-grid
     bounce-back window at the shard's rows, and at walls (0, NY-1) on the
     whole grid;
  13b. the sharded windows on a one-rank NCCL group: the y-shard rollout
     under NONE periodic, NONE and FFT bounce-back and the 2-D rollout, 512^2
     f32 + delta, 20 steps with K = 8, bitwise equal to the single-device
     window rollout with 3 launches of their kernel; (2, 2) and (2, 4) tiles
     of 512^2, each extended by K-deep slabs and corners, bitwise against the
     whole-grid window; torchrun --nproc-per-node 1 of the plasma CLI with
     --shard 1 --multistep 8 --poisson NONE --bc bounceback (200^2, 200
     steps): 25 gated launches, its 19 probe series bitwise equal to the
     single-device CLI's;
  13c. the gated window at 2048^2 NONE bf16 + delta, K = 32, on the bands
     of 1 card (2112x2048) and 4 (576x2048) beside the whole-grid
     bounce-back window, the bound (K times the collide stage's issue floor)
     and the plain version; the sharded rollout over a world of one beside
     the single-device window rollout, ms/step and MLUPS.
  14. checkpoints, resume, the watchdog and --profile (io/checkpoint,
     utils/watchdog; every resumed run bitwise equal to the straight one):
  14a. the golden f64 CLI to step 120 with --checkpoint-every 40, resumed
     to 200: final_state.npz bitwise equal to phase 4's, its 80 probe rows
     equal to phase 4's rows 120-199 (and so within the C++ fixture's
     gate), exactly 80 collide_stream launches; --multistep 8 with
     --checkpoint-every 48, resumed at step 96, against phase 7b: 13
     window launches;
  14b. the 3-D CLI (64^3 f32 + delta) to 30, resumed to 50, against phase
     8b: 20 launches;
  14c. the cavity CLI at 129^2, stored f32 and bf16 and --multistep 100
     f32: 6,000 steps, resumed to 10,000, against the straight runs; the
     bf16 checkpoint resumed into an f64 native run (reconcile_cavity_state
     on the card bitwise equal to the CPU's; Ghia's gates);
  14d. the plasma CLI at 1024^2 bf16 + delta: 5 steps, resumed to 10;
  14e. 512^2 f32 with fft_engine="pallas" through make_rollout: the saved
     phi equals reconstruct_phi of the state, and the resume is bitwise;
  14f. convert_neutral_layout and the float64 -> bfloat16 cast on the card
     bitwise equal to the CPU's (and the cast to a numpy bit-level
     reference);
  14g. the plasma CLI with --shard 1 --multistep 8 on a one-rank NCCL
     group, 512^2 NONE f32, 24 steps: rank 0's final_state.npz equal to the
     single-device run's, and a --shard 1 resume at step 16 equal to both;
  14h. the watchdog: a NaN set in g of a 2048^2 f32 state raises
     BlowupError at the first check after it; one check's ms beside a
     step's;
  14i. the golden CLI with --profile for 10 steps: the Chrome trace names
     the collide+stream kernel 10 times;
  14j. scripts/measure_drift_torch.py on the card: its drift table through
     the fused kernel, the delta column's rho_n, ux_n, uy_n and T_n within
     1e-3 of scale, the classic column's T_n at or past 1;
  14k. a checkpoint's write and load ms at 1024^2 bf16;
  15a. rendering (lbm_tpu_torch.io.colormap): render_all on the card
     uint8-equal to render_all on CPU copies of the same fields (the golden
     end state's macros in f64 and f32, a seeded 2048^2 f32 state) and the
     cavity's |u|^2 frame at 2048^2; render_all and its copy into pinned
     host memory timed at 200^2 and 2048^2;
  15b. the golden CLI (f32) with its videos on and off, ms a step in
     three alternating pairs of runs;
     its three AVIs (the native writer) read back: 200 frames of 600 x 230,
     600 x 460 and 600 x 230, none constant; --multistep 8 --video-every 8
     writes 25; the NONE windows' videos (--multistep 8) with --shard 1 on
     a one-rank NCCL group bitwise equal to the single-device run's;
  15c. the cavity CLI at 129^2 for 10,000 steps with --video-every 100:
     100 frames; at 2048^2 for 2,000 steps (20 frames) with the video on
     and off in three alternating pairs, ms a step each; --multistep 100
     with --shard 1 on a one-rank NCCL group
     frame for frame equal to the single-device run;
  15d. scripts/validate_cavity_re_torch.py --nx 256 (Re 100, 400, 1000)
     against artifacts/cavity_re/summary.json: steps within 20,000, each
     station and each max error within 2e-3 of the lid speed;
  15e. the watchdog under --multistep 8 --watchdog-every 100 checks the
     windows that cross steps 100 and 200, and a NaN in a resumed state
     raises at the first of them.
  16. the sharded plain steps (parallel/sharding) on a one-rank NCCL group
     and a (1, 1) mesh, every exchange the block's own wrap: make_sharded_step
     at 2048^2 f32 for 3 steps under SOR + bounce-back, GS + bounce-back and
     NPS periodic (200 sweeps a solve), with the collide-only kernel
     (backend "fused"; 3 launches, counts reset just before), bitwise equal
     to the single-device pallas step with the plain sweeps
     (iter_engine="xla") and its sweep counts; NONE + bounce-back in bf16 +
     delta (the plain collide: the kernel has no bf16 mode) bitwise equal
     to the single-device plain step; ms a step of each beside the
     single-device step's, with the card's name and power limit;
     make_sharded_cavity_step at Ghia's 129^2, Re = 100, 10,000 steps,
     bitwise equal to the single-device plain step and within the Ghia
     gate, ms a step of each.
The earlier phases pass --no-video (and --no-plots) to the 2-D and cavity
CLIs, so that their times and launch counts are those of the runs alone.
Phase 3 also holds collide_stream at the fused_split shapes (64x8192 f32,
64x4096 f64), where the JAX package needs its split kernel pair.

    python3 chip_smoke.py --only 3,7    # phases 1-2 and the listed ones

The line before the last is a JSON object {"kernels": [...]}: for each
kernel its launch count on its CLI run (phase 4, 4b, 6b, 7b or 8b, counts
reset before the run; 9b's step run for the spectral solve; 10b's 2048^2
FFT runs for the halo kernels; 11b's 128^2 runs for the cavity's y-shard
kernels; 12b's 64^3 f32 + delta NONE runs for the 3-D halo kernel in its
three roles; 13b's torchrun CLI for the gated window; fused_collide
also its launches in phase 16's sharded runs, "launches_sharded"), its
worst
error against its plain version, its time beside the plain version's,
beside its bound and, where one PyTorch call computes the same function,
beside that call's (library_ms), at the main path's shapes. The last line is {"ok": true, "device": {...}}; with --only, no
kernels line and no ok line are printed. Needs no JAX.
"""
from __future__ import annotations

import csv
import dataclasses
import gzip
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(HERE, "tests", "fixtures",
                       "ref_probes_200x200_200steps_fft.csv.gz")
OUT = os.path.join(HERE, "build", "output", "chip_smoke")
CSRC = "lbm_tpu_torch/kernels/csrc/"
BYTES_PER_SITE = {"native": 432, "bf16": 216}   # f+g read and write
HBM_BYTES_PER_S = 3.35e12      # H100 SXM (data sheet)
F32_FLOP_PER_S = 67e12         # non-tensor f32
F64_FLOP_PER_S = 34e12         # non-tensor f64
# flop per updated site and sweep: the stencil, then |new - p| and the max
SWEEP_FLOP = {("gs", False): 8, ("gs", True): 11, ("nps", False): 14}
# the halo kernels' launch counts in a CLI summary of a single-device run
NO_HALO = {"collide_stream_halo": 0, "collide_stream_halo2d": 0}
# and the gated window's (the sharded windows' kernel)
NO_GATED = {"collide_stream_multistep_gated": 0}


# the earlier phases run the 2-D and cavity CLIs without their videos and
# probe plots, so that their times and launch counts keep their meaning;
# phase 15 turns them on
NO_VIDEO = ["--no-video", "--no-plots"]
NO_CAVITY_VIDEO = ["--no-video"]


# the straight CLI runs of phases 4, 7b and 8b (their summaries), which
# phase 14 holds its resumed runs against; phase 14 makes the ones missing
STRAIGHT = {}


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def phase_environment():
    import torch
    require(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    sys.path.insert(0, HERE)
    import lbm_tpu_torch
    require(os.path.dirname(os.path.dirname(os.path.abspath(
        lbm_tpu_torch.__file__))) == HERE,
        f"lbm_tpu_torch imported from {lbm_tpu_torch.__file__}, "
        f"not from this checkout")
    require("jax" not in sys.modules, "JAX was imported")
    from lbm_tpu_torch.kernels import build
    nvcc = subprocess.run([build.find_nvcc(), "--version"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()
    print("== phase 1: environment")
    print(card_line())
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    print(f"nvcc: {nvcc[-1] if nvcc else '?'}")
    # float32 products stay in full float32 (the spectral solve's plain
    # version multiplies by DFT matrices, as JAX's Precision.HIGHEST; TF32
    # would miss its 1e-5 gate for the wrong reason)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def phase_build():
    from lbm_tpu_torch.kernels import build
    print("== phase 2: build")
    t0 = time.perf_counter()
    lib = build.build()
    build.load()
    print(f"built {os.path.relpath(lib, HERE)} in "
          f"{time.perf_counter() - t0:.1f} s")
    log = (lib.parent / "build.log").read_text()
    for line in log.splitlines():
        if re.search(r"Compiling entry|Used \d+ registers|spill", line):
            print("  ptxas:", line.strip())


def _seeded_state(cfg, device, seed, warm_steps=2):
    """The initial state after `warm_steps` plain steps, with a seeded
    relative perturbation of ~1e-3 (made with numpy in float64)."""
    import torch
    from lbm_tpu_torch.models import plasma

    state = plasma.init_state(cfg, device)
    step = plasma.make_step(dataclasses.replace(cfg, backend="plain"))
    for _ in range(warm_steps):
        state = step(state)
    rng = np.random.default_rng(seed)

    def perturb(t, additive=0.0):
        a = t.double().cpu().numpy()
        noise = rng.standard_normal(a.shape)
        a = a * (1.0 + 1e-3 * noise) + additive * noise
        return torch.as_tensor(a, device=device).to(t.dtype).contiguous()

    ex_scale = float(state.Ex.abs().max())
    return state._replace(f=perturb(state.f), g=perturb(state.g),
                          Ex=perturb(state.Ex), Ey=perturb(state.Ey,
                                                           1e-3 * ex_scale))


def _errors(got, want, rtol, atol_rel, bf16_ulp=False):
    """(max abs err, max err / allowed, bitwise-equal share); the scale of
    atol is per species for (3, Q, NY, NX) and (3, Q, NZ, NY, NX)
    populations."""
    import torch
    g64, w64 = got.double(), want.double()
    err = (g64 - w64).abs()
    if bf16_ulp:
        mag = torch.maximum(g64.abs(), w64.abs()).float()
        exp = torch.frexp(mag).exponent.double()
        allowed = torch.where(mag == 0, torch.zeros_like(err),
                              torch.exp2(exp - 8.0))
    else:
        if w64.dim() in (4, 5):
            scale = w64.abs().amax(dim=tuple(range(1, w64.dim())),
                                   keepdim=True)
        else:
            scale = w64.abs().max()
        allowed = atol_rel * scale + rtol * w64.abs()
    excess = torch.where(err == 0, torch.zeros_like(err),
                         err / torch.where(allowed == 0,
                                           torch.full_like(allowed, 1e-300),
                                           allowed))
    same = float((got.view(-1) == want.view(-1)).double().mean())
    return float(err.max()), float(excess.max()), same


def _time_ms(fn, reps):
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


# (label, dtype, storage, neutral_delta, rtol, atol*scale)
COLLIDE_MODES = [
    ("f64", "float64", "native", False, 1e-12, 1e-14),
    ("f64+delta", "float64", "native", True, 1e-12, 1e-14),
    ("f32", "float32", "native", False, 1e-5, 1e-6),
    ("f32+delta", "float32", "native", True, 1e-5, 1e-6),
    ("bf16", "float32", "bf16", False, None, None),
    ("bf16+delta", "float32", "bf16", True, None, None),
]


def phys_of(cfg):
    u = cfg.units()
    return dict(taus=cfg.taus, q_e=u.q_e, q_i=u.q_i, m_e=u.m_e, m_i=u.m_i,
                cs2=u.cs2, kb=u.kb,
                neutral_ref=u.rho_n_init if cfg.neutral_delta else 0.0)


# the tile program's run edges (NY, NX), W = 64 sites (f64 32): rows of 1,
# 3, 33 and 37 sites (NX < W; odd rows, whose bf16 planes take the element
# route), 65 and 100 (a ragged last run), a one-row grid of one aligned run
RUN_EDGES_2D = ((5, 1), (4, 3), (3, 33), (2, 37), (3, 65), (2, 100), (1, 64))


def phase_kernel_vs_plain():
    from lbm_tpu_torch.kernels import fused_step

    print("== phase 3: kernel vs plain version on the card")
    golden_err = _collide_vs_plain(fused_step.collide_stream,
                                   fused_step.collide_stream_reference,
                                   COLLIDE_MODES)
    # the widths where the JAX package routes to its split kernel pair
    # (fused_split.py: f64 from NX = 4096, f32 from NX = 8192)
    print("   fused_split shapes:")
    for shape, dtype in (((64, 8192), "float32"), ((64, 4096), "float64")):
        _collide_vs_plain(fused_step.collide_stream,
                          fused_step.collide_stream_reference,
                          [m for m in COLLIDE_MODES
                           if m[1] == dtype and m[2] == "native"], [shape])
    print("   the tile program's run edges:")
    _collide_vs_plain(fused_step.collide_stream,
                      fused_step.collide_stream_reference, COLLIDE_MODES,
                      RUN_EDGES_2D)
    return golden_err


def _collide_vs_plain(kernel_fn, plain_fn, modes,
                      shapes=((37, 53), (200, 200))):
    """Both versions on the same seeded state at each shape in each mode;
    returns the worst max|err| at 200x200 f64."""
    import torch
    from lbm_tpu_torch.config import PlasmaConfig

    device = torch.device("cuda")
    golden_err = None
    for ny, nx in shapes:
        for label, dtype, storage, delta, rtol, atol in modes:
            cfg = PlasmaConfig(NX=nx, NY=ny, dtype=getattr(torch, dtype),
                               storage=storage, neutral_delta=delta,
                               backend="fused")
            phys = phys_of(cfg)
            st = _seeded_state(cfg, device, seed=ny * 1000 + nx)
            args = (st.f, st.g, st.Ex, st.Ey)
            k_out = kernel_fn(*args, **phys)
            p_out = plain_fn(*args, **phys)
            torch.cuda.synchronize()
            line = []
            worst_abs = 0.0
            for name, kg, pg in zip(("f", "g", "rho_q"), k_out, p_out):
                require(kg.shape == pg.shape and kg.dtype == pg.dtype,
                        f"{label} {ny}x{nx} {name}: shape/dtype differ")
                require(bool(torch.isfinite(kg.float()).all()),
                        f"{label} {ny}x{nx} {name}: kernel output not finite")
                if rtol is None and name != "rho_q":
                    mx, ratio, same = _errors(kg, pg, 0, 0, bf16_ulp=True)
                    tol = "1 bf16 ulp"
                else:
                    r, a = (rtol, atol) if rtol is not None else (1e-5, 1e-6)
                    mx, ratio, same = _errors(kg, pg, r, a)
                    tol = f"rtol {r:g} atol {a:g}*scale"
                worst_abs = max(worst_abs, mx)
                line.append(f"{name}: max|err| {mx:.3e} ({ratio:.3f} of "
                            f"{tol}), bitwise {100 * same:.2f}%")
                require(ratio <= 1.0, f"{label} {ny}x{nx} {name}: error "
                        f"{ratio:.3f} x the tolerance ({tol})")
            ms = _time_ms(lambda: kernel_fn(*args, **phys), 20)
            plain_ms = _time_ms(lambda: plain_fn(*args, **phys), 5)
            print(f"{label:>10} {ny}x{nx}: " + "; ".join(line)
                  + f"; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
            if (ny, nx, label) == (200, 200, "f64"):
                golden_err = worst_abs
    return golden_err


def _bits(t):
    import torch
    return t.view({8: torch.int64, 4: torch.int32,
                   2: torch.int16}[t.element_size()])


# phase 3b's planes: (NY, NX, dtypes, whether to add the tol-1e-8 solve of a
# step's rho_q); 1000^2 cuts into ragged tiles, and the past-fit plane (the
# first square past the largest the tiled loop holds in f32) is added at run
# time
SOLVE_SHAPES = [(37, 53, ("f64", "f32"), True),
                (200, 200, ("f64", "f32"), True),
                (1000, 1000, ("f32",), False),
                (1024, 1024, ("f64", "f32"), True),
                (2048, 2048, ("f32",), False)]


def _past_tiled_fit(dtype):
    """The first n (a multiple of 8 from 2048) whose n x n interior-only
    solve takes the streaming loop, by the kernel's own size test."""
    from lbm_tpu_torch.kernels import poisson_iter
    n = 2048
    while poisson_iter.path(n, n, dtype, True) == "tiled":
        n += 8
    return n


def phase_solve_kernel():
    """Phase 3b; returns the worst max|err| (0: every case is bitwise)."""
    import torch
    from lbm_tpu_torch.config import PlasmaConfig
    from lbm_tpu_torch.kernels import fused_step, poisson_iter
    from lbm_tpu_torch.ops import poisson

    print("== phase 3b: solve kernel vs plain sweeps, bitwise")
    device = torch.device("cuda")
    dtypes = {"f64": torch.float64, "f32": torch.float32}
    kinds = [("gs", None), ("gs", 1.8), ("nps", None)]
    past = _past_tiled_fit(torch.float32)
    paths = set()
    for ny, nx, names, with_step in [*SOLVE_SHAPES,
                                     (past, past, ("f32",), False)]:
        for dtype in (dtypes[d] for d in names):
            rng = np.random.default_rng(ny * nx)
            rho = 0.1 * rng.random((ny, nx))
            rho -= rho.mean()
            seeded = (torch.as_tensor(0.05 * rng.random((ny, nx)),
                                      dtype=dtype, device=device),
                      torch.as_tensor(rho, dtype=dtype, device=device))
            runs = [("seeded", seeded, 60, 0.0)]
            if with_step:
                # the rho_q of a step from a seeded state, solved from 0
                cfg = PlasmaConfig(NX=nx, NY=ny, dtype=dtype,
                                   neutral_delta=True)
                st = _seeded_state(cfg, device, seed=ny + nx, warm_steps=1)
                rho_q = fused_step.collide_stream(st.f, st.g, st.Ex, st.Ey,
                                                  **phys_of(cfg))[2]
                runs.append(("step", (torch.zeros_like(rho_q), rho_q), 5000,
                             1e-8))
            if (ny, nx) == (37, 53):
                nan_phi = seeded[0].clone()
                nan_phi[ny // 2, nx // 2] = float("nan")
                runs.append(("NaN", (nan_phi, seeded[1]), 5000, 1e-8))
                runs.append(("max_iter 0", seeded, 0, 1e-8))
            line = []
            for kind, omega in kinds:
                for interior in (False, True):
                    way = poisson_iter.path(ny, nx, dtype, interior, kind)
                    paths.add(way)
                    for label, (phi0, rq), max_iter, tol in runs:
                        spec = (kind, omega, max_iter, tol, interior)
                        got = poisson_iter.solve_iter(phi0, rq, spec=spec)
                        n_kernel = int(poisson_iter.LAST_SWEEPS)
                        want = poisson_iter.solve_iter_reference(phi0, rq,
                                                                 spec=spec)
                        n_plain = poisson.LAST_SWEEPS
                        tag = (f"{kind}{'' if omega is None else '-sor'}/"
                               f"{'int' if interior else 'per'}/{label}")
                        name = f"{ny}x{nx} {dtype} {tag} ({way})"
                        require(n_kernel == n_plain, f"{name}: {n_kernel} "
                                f"kernel sweeps vs {n_plain} plain")
                        require(label != "NaN" or n_kernel == 1,
                                f"{name}: {n_kernel} sweeps, want 1")
                        if not torch.equal(_bits(got), _bits(want)):
                            err = float((got - want).abs().nan_to_num(
                                float("inf")).max())
                            raise SmokeFailure(f"{name}: kernel differs from "
                                               f"the plain sweeps, max|err| "
                                               f"{err:.3e}")
                        line.append(f"{tag} {n_kernel}")
            ways = {poisson_iter.path(ny, nx, dtype, i, kd)
                    for i in (False, True) for kd, _ in kinds}
            print(f"{ny}x{nx} {str(dtype)[6:]} ({'/'.join(sorted(ways))}): "
                  f"bitwise; sweeps " + ", ".join(line))
            del seeded, runs
            torch.cuda.empty_cache()
    require(paths == {"tiled", "streaming"}, f"3b ran the loops {paths}; "
            f"want both sides of the size dispatch")
    print(f"the f32 tiled loop holds up to {past - 8}^2 (interior-only); "
          f"{past}^2 takes the streaming loop")
    return 0.0


def phase_collide_kernel():
    from lbm_tpu_torch.kernels import collide_pallas, fused_step

    print("== phase 3c: collide-only kernel vs plain version on the card")
    native = [m for m in COLLIDE_MODES if m[2] == "native"]
    err = _collide_vs_plain(collide_pallas.fused_collide,
                            fused_step.collide_reference, native)
    print("   the tile program's run edges:")
    _collide_vs_plain(collide_pallas.fused_collide,
                      fused_step.collide_reference, native, RUN_EDGES_2D)
    return err


def _parse_probe_fixture(path):
    """-> {field: (T, 9) array} from the release-build probe-series dump
    (the parser of tests/test_reference_parity.py)."""
    series = {}
    with gzip.open(path, "rt") as fh:
        rd = csv.reader(fh)
        next(rd)
        for row in rd:
            series.setdefault(row[0], []).append([float(v) for v in row[2:]])
    return {k: np.asarray(v) for k, v in series.items()}


def phase_golden():
    from lbm_tpu_torch import run_plasma
    from lbm_tpu_torch.kernels import fused_step

    print("== phase 4: golden 200x200x200 f64 run through the kernel")
    ref = _parse_probe_fixture(FIXTURE)
    fused_step.LAUNCHES = 0
    summary = run_plasma.main(["--preset", "golden", "--f64", "--backend",
                               "fused", "--device", "cuda",
                               "--out", os.path.join(OUT, "golden")]
                              + NO_VIDEO)
    launches = fused_step.LAUNCHES
    STRAIGHT["golden"] = summary
    require(launches == 200, f"golden run launched the kernel {launches} "
            f"times, want 200")
    require(summary["finite"], "golden run state is not finite")
    worst = 0.0
    for k, want in ref.items():
        got = summary["probes"][k]
        require(got.shape == want.shape,
                f"probe {k}: shape {got.shape} vs {want.shape}")
        scale = np.abs(want).max()
        err = np.abs(got - want)
        allowed = 1e-5 * np.abs(want) + 1e-5 * scale
        ratio = float((err / np.where(allowed == 0, 1e-300, allowed)).max())
        worst = max(worst, float(err.max() / scale) if scale else 0.0)
        require(ratio <= 1.0, f"probe series {k}: {ratio:.3f} x the "
                f"rtol 1e-5 / atol 1e-5*scale gate")
    print(f"19 probe series match the C++ fixture: worst max|err|/scale "
          f"{worst:.3e} (gate 1e-5); {launches} kernel launches; "
          f"{summary['wall_ms'] / 200:.3f} ms/step with probes "
          f"({summary['mlups']:.2f} MLUPS)")
    return launches


def _reset_launches():
    """Every plasma kernel's launch count to 0 (the 2-D ones, the gated
    window, the halo kernels, the 3-D collide_stream3d and its halo
    kernel)."""
    from lbm_tpu_torch.kernels import fused_multistep, fused_step, fused_step3d
    from lbm_tpu_torch.run_plasma import KERNELS
    for mod in (*KERNELS.values(), fused_step3d):
        mod.LAUNCHES = 0
    fused_multistep.GATED_LAUNCHES = 0
    for counts in (fused_step.HALO_LAUNCHES, fused_step3d.HALO_LAUNCHES):
        for name in counts:
            counts[name] = 0


def phase_sor_bounceback():
    """Phase 4b; returns the launch counts of the fused and pallas runs."""
    from lbm_tpu_torch import run_plasma
    from lbm_tpu_torch.kernels import poisson_iter
    from lbm_tpu_torch.ops import poisson

    print("== phase 4b: 200x200 f64 SOR + bounce-back, 50 steps, CLI")
    steps, runs, sweeps = 50, {}, {}
    for backend in ("fused", "pallas", "plain"):
        _reset_launches()
        runs[backend] = run_plasma.main([
            "--nx", "200", "--ny", "200", "--steps", str(steps), "--f64",
            "--poisson", "SOR", "--bc", "bounceback", "--backend", backend,
            "--device", "cuda", "--out",
            os.path.join(OUT, f"sor_bb_{backend}")] + NO_VIDEO)
        require(runs[backend]["finite"], f"{backend}: state not finite")
        sweeps[backend] = (poisson.LAST_SWEEPS if backend == "plain"
                           else int(poisson_iter.LAST_SWEEPS))
    want_launches = {
        "fused": {"collide_stream": steps, "fused_collide": 0,
                  "solve_iter": steps, "collide_stream_multistep": 0,
                  "fft_solve": 0, **NO_HALO, **NO_GATED},
        "pallas": {"collide_stream": 0, "fused_collide": steps,
                   "solve_iter": steps, "collide_stream_multistep": 0,
                   "fft_solve": 0, **NO_HALO, **NO_GATED},
        "plain": {"collide_stream": 0, "fused_collide": 0, "solve_iter": 0,
                  "collide_stream_multistep": 0, "fft_solve": 0,
                  **NO_HALO, **NO_GATED}}
    for backend, summary in runs.items():
        require(summary["launches"] == want_launches[backend],
                f"{backend}: launches {summary['launches']}, want "
                f"{want_launches[backend]}")
    plain = runs["plain"]["state"]
    for backend in ("fused", "pallas"):
        state = runs[backend]["state"]
        line = []
        for name in ("f", "g", "phi", "Ex", "Ey"):
            mx, ratio, same = _errors(getattr(state, name),
                                      getattr(plain, name), 1e-12, 1e-14)
            line.append(f"{name} {mx:.3e} ({100 * same:.1f}% bitwise)")
            require(ratio <= 1.0, f"{backend} vs plain {name}: {ratio:.3f} "
                    f"x the rtol 1e-12 / atol 1e-14*scale gate")
        print(f"{backend} vs plain after {steps} steps: " + "; ".join(line)
              + f"; {runs[backend]['wall_ms'] / steps:.3f} ms/step with "
              f"probes")
    print(f"plain: {runs['plain']['wall_ms'] / steps:.3f} ms/step with "
          f"probes; launches fused {runs['fused']['launches']}, pallas "
          f"{runs['pallas']['launches']}; sweeps of the last solve {sweeps}")
    return {"fused_collide": runs["pallas"]["launches"]["fused_collide"],
            "solve_iter": runs["fused"]["launches"]["solve_iter"]}


def phase_real_size():
    import torch
    from lbm_tpu_torch.config import PlasmaConfig
    from lbm_tpu_torch.kernels import fused_step
    from lbm_tpu_torch.models import plasma
    from lbm_tpu_torch.ops import poisson

    print("== phase 5: 2048^2 FFT + periodic, 5 warm-up + 30 timed steps")
    n, warm, steps = 2048, 5, 30
    device = torch.device("cuda")
    timings = {}
    for storage in ("native", "bf16"):
        cfg = PlasmaConfig(NX=n, NY=n, dtype=torch.float32, backend="fused",
                           storage=storage, neutral_delta=storage == "bf16")
        u = cfg.units()
        phys = dict(taus=cfg.taus, q_e=u.q_e, q_i=u.q_i, m_e=u.m_e,
                    m_i=u.m_i, cs2=u.cs2, kb=u.kb,
                    neutral_ref=u.rho_n_init if cfg.neutral_delta else 0.0)
        state = plasma.init_state(cfg, device)
        step = plasma.make_step(cfg)
        for _ in range(warm):
            state = step(state)
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(steps):
            state = step(state)
        t1.record()
        torch.cuda.synchronize()
        step_ms = t0.elapsed_time(t1) / steps
        require(all(bool(torch.isfinite(t.float()).all())
                    for t in (state.f, state.g, state.Ex, state.Ey)),
                f"2048^2 {storage}: state not finite after "
                f"{warm + steps} steps")
        args = (state.f, state.g, state.Ex, state.Ey)
        kern_ms = _time_ms(lambda: fused_step.collide_stream(*args, **phys),
                           steps)
        rho_q = fused_step.collide_stream(*args, **phys)[2]
        solve_ms = _time_ms(
            lambda: poisson.efield_periodic(poisson.solve_fft(rho_q)), steps)
        gbs = BYTES_PER_SITE[storage] * n * n / (kern_ms * 1e-3) / 1e9
        label = "f32" if storage == "native" else "bf16+delta"
        print(f"{label:>10}: {step_ms:.4f} ms/step, "
              f"{n * n / (step_ms * 1e-3) / 1e6:.1f} MLUPS; kernel "
              f"{kern_ms:.4f} ms ({gbs:.0f} GB/s at "
              f"{BYTES_PER_SITE[storage]} B/site), solve+E {solve_ms:.4f} ms"
              f" (kernel {100 * kern_ms / (kern_ms + solve_ms):.1f}% of "
              f"their sum)")
        timings[storage] = kern_ms
        if storage == "native":
            timings["plain"] = _time_ms(
                lambda: fused_step.collide_stream_reference(*args, **phys), 3)
            print(f"{'':>10}  plain collide+stream {timings['plain']:.4f} ms"
                  f" per call (3 calls)")
        del state, args, rho_q
        torch.cuda.empty_cache()
    return timings


def _window(step, state, warm, steps):
    """warm + steps steps; returns (state, ms/step over the last steps)."""
    import torch
    for _ in range(warm):
        state = step(state)
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(steps):
        state = step(state)
    t1.record()
    torch.cuda.synchronize()
    return state, t0.elapsed_time(t1) / steps


def _solve_bound_ms(spec, sweeps, sites, dtype):
    """(least ms, "bytes" or "operations") of a solve: phi0 and rho_q read
    once and phi written once, against the flop of the sweeps it ran."""
    import torch
    itemsize = torch.finfo(dtype).bits // 8
    t_bytes = 3 * sites * itemsize / HBM_BYTES_PER_S * 1e3
    flop = SWEEP_FLOP[(spec[0], spec[1] is not None)] * sweeps * sites
    t_ops = flop / (F32_FLOP_PER_S if dtype == torch.float32
                    else F64_FLOP_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_real_size_solvers():
    """Phase 5b; returns {kernel: (ms, plain_ms, bound_ms, bound_by, at)}
    from the first cell that runs it: solve_iter at 1024^2 f32 SOR +
    bounce-back, fused_collide at 2048^2 f32."""
    import torch
    from lbm_tpu_torch.config import BC, PlasmaConfig, PoissonSolver
    from lbm_tpu_torch.kernels import collide_pallas, fused_step, poisson_iter
    from lbm_tpu_torch.models import plasma

    print("== phase 5b: real sizes of the other solvers and walls")
    device = torch.device("cuda")
    f32 = torch.float32
    cells = [  # label, n, storage, delta, poisson, bc, backend, warm, steps
        ("1024^2 f32 SOR+bounceback+delta fused", 1024, "native", True,
         PoissonSolver.SOR, BC.BOUNCE_BACK, "fused", 2, 10),
        ("2048^2 f32 SOR+bounceback+delta fused", 2048, "native", True,
         PoissonSolver.SOR, BC.BOUNCE_BACK, "fused", 1, 3),
        ("256^2 f32 GS periodic fused", 256, "native", False,
         PoissonSolver.GS, BC.PERIODIC, "fused", 2, 10),
        ("4096^2 bf16+delta NONE periodic fused", 4096, "bf16", True,
         PoissonSolver.NONE, BC.PERIODIC, "fused", 5, 30),
        ("2048^2 f32 FFT periodic pallas", 2048, "native", False,
         PoissonSolver.FFT, BC.PERIODIC, "pallas", 5, 30),
    ]
    out = {}
    for label, n, storage, delta, sol, bc, backend, warm, steps in cells:
        cfg = PlasmaConfig(NX=n, NY=n, dtype=f32, storage=storage,
                           neutral_delta=delta, poisson=sol, bc=bc,
                           backend=backend)
        phys = phys_of(cfg)
        step = plasma.make_step(cfg)
        state, step_ms = _window(step, plasma.init_state(cfg, device), warm,
                                 steps)
        require(all(bool(torch.isfinite(t.float()).all())
                    for t in (state.f, state.g, state.Ex, state.Ey,
                              state.phi)),
                f"{label}: state not finite after {warm + steps} steps")
        args = (state.f, state.g, state.Ex, state.Ey)
        parts = [f"{step_ms:.4f} ms/step, "
                 f"{n * n / (step_ms * 1e-3) / 1e6:.1f} MLUPS "
                 f"(window {warm}+{steps} steps)"]
        if backend == "pallas":
            ms = _time_ms(lambda: collide_pallas.fused_collide(*args, **phys),
                          steps)
            plain_ms = _time_ms(
                lambda: fused_step.collide_reference(*args, **phys), 3)
            bound, bound_by = _collide_bound_ms(n * n)
            parts.append(f"fused_collide {ms:.4f} ms (bound {bound:.4f} ms "
                         f"by {bound_by}; plain {plain_ms:.4f} ms)")
            out.setdefault("fused_collide", (ms, plain_ms, bound, bound_by,
                                             f"{n}x{n} f32"))
        else:
            ms = _time_ms(lambda: fused_step.collide_stream(*args, **phys),
                          steps)
            parts.append(f"collide_stream {ms:.4f} ms")
        if sol in (PoissonSolver.GS, PoissonSolver.SOR, PoissonSolver.NPS):
            rho_q = fused_step.collide_stream(*args, **phys)[2]
            spec = ("nps" if sol == PoissonSolver.NPS else "gs",
                    cfg.omega_sor if sol == PoissonSolver.SOR else None,
                    cfg.poisson_max_iter, cfg.poisson_tol, True)
            phi0 = state.phi
            poisson_iter.solve_iter(phi0, rho_q, spec=spec)
            sweeps = int(poisson_iter.LAST_SWEEPS)
            ms = _time_ms(
                lambda: poisson_iter.solve_iter(phi0, rho_q, spec=spec), 3)
            t0 = time.perf_counter()
            poisson_iter.solve_iter_reference(phi0, rho_q, spec=spec)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            bound, bound_by = _solve_bound_ms(spec, sweeps, n * n, f32)
            way = poisson_iter.path(n, n, f32, True, spec[0])
            floor = "none (streaming loop)"
            if way == "tiled":
                floor_ms = _time_ms(lambda: poisson_iter.sweep_floor(
                    n, n, f32, spec[0], True, sweeps, device), 3)
                floor = f"{1e3 * floor_ms / max(sweeps, 1):.3f} us/sweep"
            parts.append(f"solve_iter ({way}) {ms:.4f} ms for {sweeps} "
                         f"sweeps ({1e3 * ms / max(sweeps, 1):.3f} us/sweep; "
                         f"barrier floor {floor}; flop bound "
                         f"{1e3 * bound / max(sweeps, 1):.3f} us/sweep, "
                         f"{bound:.4f} ms by {bound_by}; plain sweeps "
                         f"{plain_ms:.1f} ms, 1 call)")
            out.setdefault("solve_iter", (ms, plain_ms, bound, bound_by,
                                          f"{n}x{n} f32 {sweeps} sweeps"))
        print(f"{label}: " + "; ".join(parts))
        del state, args, step
        torch.cuda.empty_cache()
    return out


# cavity kernels: bytes a site that each must move (f read and written,
# plus rho, ux, uy in stored mode), by (kernel, storage, compute itemsize)
def _cavity_bytes_per_site(kernel, f_itemsize, c_itemsize):
    pops = 2 * 9 * f_itemsize
    return pops + 2 * 3 * c_itemsize if kernel == "stored" else pops


CAVITY_FLOP = 170   # a site and step (the JAX kernels' cost estimate)


def _cavity_bound_ms(kernel, sites, f_itemsize, c_itemsize, k_steps=1):
    """(least ms, "bytes" or "operations") of one launch: its bytes, or its
    operations, the larger of 170 flop a site and step at the type's rate
    and, in f32 compute, the step program's issue floor (_cavity_floor_ms)."""
    t_bytes = (_cavity_bytes_per_site(kernel, f_itemsize, c_itemsize)
               * sites / HBM_BYTES_PER_S * 1e3)
    flop_rate = F64_FLOP_PER_S if c_itemsize == 8 else F32_FLOP_PER_S
    t_ops = CAVITY_FLOP * k_steps * sites / flop_rate * 1e3
    if c_itemsize == 4:
        t_ops = max(t_ops, _cavity_floor_ms(
            kernel == "lean", "bf16" if f_itemsize == 2 else "native",
            sites * k_steps))
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _device_ms(fn, reps):
    """Device ms per call of back-to-back launches: the card first spins
    for ~10 ms so that the host has queued the launches before the timed
    window opens."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def _cavity_seeded(cfg, device, seed):
    """The initial state after 12 plain steps (past the sigma = 10 lid
    ramp), with a seeded relative perturbation of ~1e-3 of the full
    populations and of the stored macros (made with numpy in float64)."""
    import torch
    from lbm_tpu_torch.models import cavity

    plain = dataclasses.replace(cfg, backend="plain", lean_macros=False,
                                multistep=0)
    state = cavity.make_rollout(plain, 12)(cavity.init_state(plain, device))
    rng = np.random.default_rng(seed)

    def perturb(t, dtype, additive=0.0):
        a = t.double().cpu().numpy()
        noise = rng.standard_normal(a.shape)
        a = a * (1.0 + 1e-3 * noise) + additive * noise
        return torch.as_tensor(a, device=device).to(dtype).contiguous()

    dt = cfg.dtype
    f = cavity.encode_f(cfg, perturb(cavity.decode_f(cfg, state.f), dt))
    return state._replace(f=f.contiguous(), rho=perturb(state.rho, dt),
                          ux=perturb(state.ux, dt, 1e-4),
                          uy=perturb(state.uy, dt, 1e-4))


# (label, dtype, storage, f rtol, f atol*scale); None: one bf16 ulp
CAVITY_MODES = [("f64", "float64", "native", 1e-12, 1e-14),
                ("f32", "float32", "native", 4 * 2.0 ** -23, 4 * 2.0 ** -23),
                ("bf16", "float32", "bf16", None, None)]


def _hold_cavity(what, name, mode, k_out, p_out):
    """Hold a cavity kernel's outputs (f, then rho, ux, uy where stored)
    against its plain version's: bitwise, or for the stored and lean
    kernels within the mode's tolerance ladder; returns (max|err|, notes on
    the fields that differ)."""
    import torch
    rtol, atol = mode[3:]
    worst, notes = 0.0, []
    for field, kg, pg in zip(("f", "rho", "ux", "uy"), k_out, p_out):
        where = f"{what} {field}"
        require(kg.shape == pg.shape and kg.dtype == pg.dtype,
                f"{where}: shape/dtype differ")
        require(bool(torch.isfinite(kg.float()).all()),
                f"{where}: kernel output not finite")
        if torch.equal(_bits(kg), _bits(pg)):
            continue
        require("multistep" not in name,
                f"{where}: not bitwise equal to the plain version")
        if rtol is None and field == "f":
            mx, ratio, same = _errors(kg, pg, 0, 0, bf16_ulp=True)
        else:
            r, a = (rtol, atol) if rtol else CAVITY_MODES[1][3:]
            mx, ratio, same = _errors(kg, pg, r, a)
        worst = max(worst, mx)
        notes.append(f"{field} max|err| {mx:.3e} ({ratio:.3f} of the ladder, "
                     f"bitwise {100 * same:.2f}%)")
        require(ratio <= 1.0, f"{where}: error {ratio:.3f} x the tolerance "
                f"ladder")
    return worst, notes


# the cavity step program's run edges on the card (strips of W = 128
# sites in f32 and bf16, 64 in f64): (NY, NX); NX = 1, 3, W - 1, W + 1,
# W + 2, 2 W, 2 W + 1 and a ragged last strip, on grids small enough that
# the plan gives every task a span of one row (the card holds more than
# 1,000 step blocks); then spans of several rows, the last ragged (2053
# rows, a prime, over at most 12 blocks an SM x 132 SMs: 3 or more rows a
# span in every mode), and NY = 3 shorter than the span the plan asks for
# (1,719 strips in f32 and bf16, 3,438 in f64: the span is cut to the
# grid's 3 rows)
CAVITY_RUN_EDGES = [(13, 1), (9, 3), (7, 127), (37, 129), (11, 130),
                    (5, 256), (5, 257), (3, 200), (301, 65), (2053, 130),
                    (3, 220000)]
CAVITY_ROUTE_KS = (1, 2, 17)


def _resident_edge(mode_dtype, storage):
    """The largest n whose n x n window of K = 2 the resident route takes on
    this card (window_route), by bisection over n."""
    import torch
    from lbm_tpu_torch.kernels import fused_cavity as fc

    dtype = torch.bfloat16 if storage == "bf16" else mode_dtype

    def resident(n):
        probe = torch.empty((9, n, n), dtype=dtype, device="cuda")
        return fc.window_route(probe, 2) == "resident"

    lo, hi = 2, 4096
    require(resident(lo) and not resident(hi), "the resident route's edge "
            "lies outside 2..4096")
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if resident(mid) else (lo, mid)
    return lo


def _hold_bitwise(where, k_out, p_out):
    """Every output bitwise equal to the plain version's."""
    import torch
    for field, kg, pg in zip(("f", "rho", "ux", "uy"), k_out, p_out):
        require(kg.shape == pg.shape and kg.dtype == pg.dtype
                and torch.equal(_bits(kg), _bits(pg)),
                f"{where} {field}: not bitwise equal to the plain version")


def phase_cavity_kernels():
    """Phase 6a: the three cavity kernels against their plain versions on
    the same seeded states, at the step program's run edges and on both
    window routes at their size edge; returns each kernel's worst
    max|err|."""
    import torch
    from lbm_tpu_torch.config import CavityConfig
    from lbm_tpu_torch.kernels import fused_cavity as fc
    from lbm_tpu_torch.models import cavity

    print("== phase 6a: cavity kernels vs plain versions on the card")
    device = torch.device("cuda")
    worst = dict.fromkeys(fc.LAUNCHES, 0.0)
    for ny, nx in ((37, 53), (129, 129)):
        for mode in CAVITY_MODES:
            label, dtype, storage = mode[:3]
            cfg = CavityConfig(NX=nx, NY=ny, dtype=getattr(torch, dtype),
                               storage=storage, backend="fused")
            st = _cavity_seeded(cfg, device, seed=ny * 1000 + nx)
            u = cavity._lid_speed(cfg, st.step)
            macros = (st.rho, st.ux, st.uy)
            cases = [
                ("collide_stream_cavity", "stored",
                 fc.collide_stream_cavity(st.f, *macros, u, tau=cfg.tau),
                 fc.collide_stream_cavity_reference(st.f, *macros, u,
                                                    tau=cfg.tau)),
                ("collide_stream_cavity_lean", "lean",
                 [fc.collide_stream_cavity_lean(st.f, u, tau=cfg.tau)],
                 [fc.collide_stream_cavity_lean_reference(st.f, u,
                                                          tau=cfg.tau)])]
            for k in (1, 4, 17):
                kw = dict(tau=cfg.tau, k_steps=k, u_lid=cfg.u_lid,
                          sigma=cfg.sigma)
                cases.append(
                    ("collide_stream_cavity_multistep", f"multistep K={k}",
                     [fc.collide_stream_cavity_multistep(st.f, 8, **kw)],
                     [fc.collide_stream_cavity_multistep_reference(st.f, 8,
                                                                   **kw)]))
            torch.cuda.synchronize()
            line = []
            for name, tag, k_out, p_out in cases:
                mx, notes = _hold_cavity(f"{label} {ny}x{nx} {tag}", name,
                                         mode, k_out, p_out)
                worst[name] = max(worst[name], mx)
                line += [f"{tag} {note}" for note in notes]
            print(f"{label:>5} {ny}x{nx}: stored, lean, multistep K=1/4/17 "
                  f"from step 8: " + ("; ".join(line) if line
                                      else "all bitwise equal"))
    # the step program's run edges: stored and lean, from rest (exact zero
    # dividends) and seeded, bitwise
    n_edges = 0
    for ny, nx in CAVITY_RUN_EDGES:
        for mode in CAVITY_MODES:
            label, dtype, storage = mode[:3]
            cfg = CavityConfig(NX=nx, NY=ny, dtype=getattr(torch, dtype),
                               storage=storage, backend="fused")
            for st in (cavity.init_state(cfg, device),
                       _cavity_seeded(cfg, device, seed=ny * 1000 + nx)):
                u = cavity._lid_speed(cfg, 15)
                macros = (st.rho, st.ux, st.uy)
                where = f"{label} {ny}x{nx} step {st.step}"
                _hold_bitwise(f"{where} stored", fc.collide_stream_cavity(
                    st.f, *macros, u, tau=cfg.tau),
                    fc.collide_stream_cavity_reference(
                        st.f, *macros, u, tau=cfg.tau))
                _hold_bitwise(f"{where} lean", [fc.collide_stream_cavity_lean(
                    st.f, u, tau=cfg.tau)],
                    [fc.collide_stream_cavity_lean_reference(
                        st.f, u, tau=cfg.tau)])
                n_edges += 2
    print(f"run edges {CAVITY_RUN_EDGES} (NY, NX), f64/f32/bf16, from rest "
          f"and seeded: {n_edges} stored and lean holds, all bitwise equal")
    # both window routes on the largest square the resident route takes
    # and on the first square past it
    for mode in CAVITY_MODES:
        label, dtype, storage = mode[:3]
        edge = _resident_edge(getattr(torch, dtype), storage)
        for n in (edge, edge + 1):
            cfg = CavityConfig(NX=n, NY=n, dtype=getattr(torch, dtype),
                               storage=storage, backend="fused")
            st = _cavity_seeded(cfg, device, seed=n)
            routes = []
            for k in CAVITY_ROUTE_KS:
                kw = dict(tau=cfg.tau, k_steps=k, u_lid=cfg.u_lid,
                          sigma=cfg.sigma)
                route = fc.window_route(st.f, k)
                require(route == ("resident" if n == edge and k > 1
                                  else "streaming"),
                        f"{label} {n}^2 K={k}: route {route}")
                _hold_bitwise(f"{label} {n}^2 window K={k} ({route})",
                              [fc.collide_stream_cavity_multistep(
                                  st.f, 8, **kw)],
                              [fc.collide_stream_cavity_multistep_reference(
                                  st.f, 8, **kw)])
                routes.append(f"K={k} {route}")
            print(f"{label:>5} {n}^2 window from step 8: "
                  + ", ".join(routes) + " - bitwise equal")
            del st
            torch.cuda.empty_cache()
    return worst


GHIA_GATE = {"u_max": 0.035, "u_rms": 0.02, "v_max": 0.02, "v_rms": 0.01}


def _reset_cavity_launches():
    from lbm_tpu_torch.kernels import fused_cavity
    for k in fused_cavity.LAUNCHES:
        fused_cavity.LAUNCHES[k] = 0


def phase_cavity_ghia():
    """Phase 6b: the cavity CLI at 129^2, Re = 100, 10,000 steps through
    each kernel, against Ghia (1982); returns each kernel's launch count
    from its run (counts set to 0 just before the run, read just after)."""
    from lbm_tpu_torch import run_cavity
    from lbm_tpu_torch.kernels import fused_cavity

    print("== phase 6b: Ghia 129^2 Re=100, 10,000 steps, CLI")
    steps = 10_000
    runs = [("stored f32", [], "collide_stream_cavity", steps),
            ("stored f64", ["--f64"], "collide_stream_cavity", steps),
            ("lean f32", ["--lean"], "collide_stream_cavity_lean", steps),
            ("multistep 100 f32", ["--multistep", "100"],
             "collide_stream_cavity_multistep", -(-steps // 100))]
    launches = {}
    for label, flags, kernel, want in runs:
        _reset_cavity_launches()
        s = run_cavity.main(["--nx", "129", "--steps", str(steps), "--re",
                             "100", "--u-lid", "0.1", "--backend", "fused",
                             "--device", "cuda", "--out",
                             os.path.join(OUT, "cavity_" + label.replace(
                                 " ", "_"))] + flags + NO_CAVITY_VIDEO)
        counts = dict(fused_cavity.LAUNCHES)
        require(counts == {k: want if k == kernel else 0 for k in counts},
                f"{label}: launches {counts}, want {want} of {kernel}")
        require(s["launches"] == counts, f"{label}: the CLI counted "
                f"{s['launches']}")
        require(s["finite"], f"{label}: state not finite")
        g = s["ghia"]
        for key, gate in GHIA_GATE.items():
            require(g[key] < gate, f"{label}: Ghia {key} {g[key]:.4f} >= "
                    f"{gate}")
        if "f64" in label:
            require(s["mass_drift"] < 1e-12, f"{label}: mass drift "
                    f"{s['mass_drift']:.3e} >= 1e-12")
        launches.setdefault(kernel, counts[kernel])
        print(f"{label:>17}: Ghia u max {g['u_max']:.4f} rms {g['u_rms']:.4f}"
              f", v max {g['v_max']:.4f} rms {g['v_rms']:.4f}; mass drift "
              f"{s['mass_drift']:.3e}; {counts[kernel]} launches; "
              f"{s['wall_ms']:.1f} ms ({s['mlups']:.1f} MLUPS)")
    return launches


# label, n, storage, lean, multistep K, warm-up steps, timed steps; the
# legs of bench.py's cavity (bench.py:481-486, 495-505) plus 2048^2 stored
# and lean
CAVITY_CELLS = [
    ("1000^2 lean f32", 1000, "native", True, 0, 20, 400),
    ("1000^2 bf16 stored", 1000, "bf16", False, 0, 20, 400),
    ("512^2 multistep 256 f32", 512, "native", False, 256, 256, 2048),
    ("2048^2 multistep 32 f32", 2048, "native", False, 32, 32, 512),
    ("2048^2 stored f32", 2048, "native", False, 0, 20, 200),
    ("2048^2 lean f32", 2048, "native", True, 0, 20, 200),
]


def phase_cavity_real_size():
    """Phase 6c: each cell's rollout timed, then its kernel held against
    its plain version on the rollout's end state and both timed; returns
    ({kernel: (ms, plain_ms, bound_ms, bound_by, at)} at 2048^2 f32,
    {kernel: worst max|err|})."""
    import torch
    from lbm_tpu_torch.config import CavityConfig
    from lbm_tpu_torch.kernels import fused_cavity as fc
    from lbm_tpu_torch.models import cavity

    print("== phase 6c: cavity at real sizes (CUDA events)")
    device = torch.device("cuda")
    out, worst = {}, dict.fromkeys(fc.LAUNCHES, 0.0)
    for label, n, storage, lean, K, warm, steps in CAVITY_CELLS:
        cfg = CavityConfig(NX=n, NY=n, dtype=torch.float32, storage=storage,
                           backend="fused", lean_macros=lean, multistep=K)
        state = cavity.make_rollout(cfg, warm)(cavity.init_state(cfg, device))
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        state = cavity.make_rollout(cfg, steps)(state)
        t1.record()
        torch.cuda.synchronize()
        step_ms = t0.elapsed_time(t1) / steps
        require(all(bool(torch.isfinite(t.float()).all())
                    for t in (state.f, state.rho, state.ux, state.uy)),
                f"{label}: state not finite after {warm + steps} steps")
        f, tau = state.f, cfg.tau
        u = cavity._lid_speed(cfg, state.step)
        if K:
            kernel, kind, reps, plain_reps = (
                "collide_stream_cavity_multistep", "lean", 5, 1)
            args = (f, state.step)
            kw = dict(tau=tau, k_steps=K, u_lid=cfg.u_lid, sigma=cfg.sigma)
        elif lean:
            kernel, kind, reps, plain_reps = (
                "collide_stream_cavity_lean", "lean", 50, 3)
            args, kw = (f, u), dict(tau=tau)
        else:
            kernel, kind, reps, plain_reps = (
                "collide_stream_cavity", "stored", 50, 3)
            args, kw = (f, state.rho, state.ux, state.uy, u), dict(tau=tau)
        run = getattr(fc, kernel)
        plain = getattr(fc, kernel + "_reference")
        k_out, p_out = run(*args, **kw), plain(*args, **kw)
        if kind == "lean":
            k_out, p_out = [k_out], [p_out]
        torch.cuda.synchronize()
        mode = CAVITY_MODES[2 if storage == "bf16" else 1]
        mx, notes = _hold_cavity(label, kernel, mode, k_out, p_out)
        worst[kernel] = max(worst[kernel], mx)
        del k_out, p_out
        # the launches chained as the rollout chains them, each on the
        # previous one's output: from the rollout's end state (a cavity
        # started from rest, most of it still at rest) and from a seeded
        # state 12 steps in (no exact zeros)
        def chained_ms(first):
            box = [first]

            def chained():
                a = box[0]
                if K:
                    box[0] = (run(*a, **kw), a[1] + K)
                elif lean:
                    box[0] = (run(*a, **kw), a[1])
                else:
                    box[0] = (*run(*a, **kw), a[4])
            return _device_ms(chained, reps)

        ms = chained_ms(args)
        sd = _cavity_seeded_on_card(cfg, device, seed=n * 10 + K)
        u_sd = cavity._lid_speed(cfg, sd.step)
        seeded_ms = chained_ms(
            (sd.f, sd.step) if K else (sd.f, u_sd) if lean else
            (sd.f, sd.rho, sd.ux, sd.uy, u_sd))
        del sd
        plain_ms = _time_ms(lambda: plain(*args, **kw), plain_reps)
        bound, bound_by = _cavity_bound_ms(kind, n * n, f.element_size(), 4,
                                           max(K, 1))
        floor = _cavity_floor_ms(kind == "lean", storage, n * n * max(K, 1))
        route = f", {fc.window_route(f, K)} route" if K else ""
        per = (f" ({ms / K:.4f} / {seeded_ms / K:.4f} ms a step)" if K
               else "")
        print(f"{label}: {step_ms:.4f} ms/step, "
              f"{n * n / (step_ms * 1e-3) / 1e6:.1f} MLUPS (window {warm}+"
              f"{steps} steps); {kernel} vs plain on the end state: "
              + ("; ".join(notes) if notes else "bitwise equal")
              + f"; {ms:.4f} ms a launch chained from rest, {seeded_ms:.4f} "
              f"from a seeded state{per}{route}; bound {bound:.4f} ms by "
              f"{bound_by} ({100 * bound / ms:.1f}% of chained); issue floor "
              f"{floor:.4f} ms; plain {plain_ms:.4f} ms")
        if n == 2048:
            out[kernel] = (ms, plain_ms, bound, bound_by,
                           "2048x2048 f32 chained" + (f" K={K}" if K else ""))
        del state, f, args
        torch.cuda.empty_cache()
    return out, worst


# the window kernel's modes: (label, PlasmaConfig fields)
def _multistep_modes():
    from lbm_tpu_torch.config import BC, CompatFlags, PoissonSolver as P
    bb = BC.BOUNCE_BACK
    return [
        ("NONE periodic", dict(poisson=P.NONE)),
        ("NONE periodic, quirk off", dict(poisson=P.NONE, compat=CompatFlags(
            none_solver_kills_external_field=False))),
        ("NONE bounce-back", dict(poisson=P.NONE, bc=bb)),
        ("FFT bounce-back", dict(poisson=P.FFT, bc=bb)),
        ("FFT periodic", dict(poisson=P.FFT)),
        ("GS periodic", dict(poisson=P.GS)),
        ("GS periodic, quirk off", dict(poisson=P.GS, compat=CompatFlags(
            dirichlet_iterative_under_periodic=False))),
        ("SOR bounce-back", dict(poisson=P.SOR, bc=bb)),
        ("NPS periodic", dict(poisson=P.NPS)),
    ]


# 7a's grids (NY, NX): the run edges of the tile program (rows of 3 and 65
# sites: a row shorter than a run, a ragged last run), 37x53 and 200^2
MULTISTEP_SHAPES = ((7, 3), (5, 65), (37, 53), (200, 200))
# (label, dtype, storage, neutral_delta, rtol, atol*scale, FFT-mode tol)
MULTISTEP_DTYPES = [
    ("f64", "float64", "native", False, 1e-12, 1e-14, 1e-11),
    ("f32", "float32", "native", False, 1e-5, 1e-6, 1e-4),
    ("bf16+delta", "float32", "bf16", True, None, None, 1e-4),
]
WINDOW_FIELDS = ("f", "g", "Ex", "Ey", "phi")


def _hold_window(where, dmode, fft, k_out, p_out):
    """Hold a window's outputs against the plain version's: bitwise, or
    the phase-3 ladder (bf16 storage: f and g within one bf16 ulp); in the
    FFT mode within the mode's share of scale (per species for f and g;
    bf16 f and g: that, or one bf16 ulp). Returns (max|err|, notes on the
    fields that differ)."""
    import torch
    _, _, storage, _, rtol, atol, fft_tol = dmode
    worst, notes = 0.0, []
    require(len(k_out) == len(p_out), f"{where}: {len(k_out)} outputs vs "
            f"{len(p_out)}")
    for name, kg, pg in zip(WINDOW_FIELDS, k_out, p_out):
        require(kg.shape == pg.shape and kg.dtype == pg.dtype,
                f"{where} {name}: shape/dtype differ")
        require(bool(torch.isfinite(kg.float()).all()),
                f"{where} {name}: kernel output not finite")
        if torch.equal(_bits(kg), _bits(pg)):
            continue
        pops = name in ("f", "g")
        if fft:
            mx, ratio, same = _errors(kg, pg, 0.0, fft_tol)
            tol = f"{fft_tol:g} of scale"
            if storage == "bf16" and pops and ratio > 1.0:
                # either within the share of scale or within one ulp
                ulp = _errors(kg, pg, 0, 0, bf16_ulp=True)[1]
                ratio, tol = min(ratio, ulp), tol + " or 1 bf16 ulp"
        elif storage == "bf16" and pops:
            mx, ratio, same = _errors(kg, pg, 0, 0, bf16_ulp=True)
            tol = "1 bf16 ulp"
        else:
            r, a = (rtol, atol) if rtol is not None else (1e-5, 1e-6)
            mx, ratio, same = _errors(kg, pg, r, a)
            tol = f"rtol {r:g} atol {a:g}*scale"
        worst = max(worst, mx)
        notes.append(f"{name} {mx:.3e} ({ratio:.3f} of {tol}, "
                     f"{100 * same:.1f}% bitwise)")
        require(ratio <= 1.0, f"{where} {name}: error {ratio:.3f} x the "
                f"tolerance ({tol})")
    return worst, notes


def phase_multistep_kernel():
    """Phase 7a; returns the worst max|err| over the f64 cases."""
    import torch
    from lbm_tpu_torch.config import PlasmaConfig
    from lbm_tpu_torch.kernels import fused_multistep as fm
    from lbm_tpu_torch.models import plasma

    print("== phase 7a: window kernel vs plain version, K = 1, 4, 17 (and "
          "32 at 200^2)")
    device = torch.device("cuda")
    worst_f64 = 0.0
    for ny, nx in MULTISTEP_SHAPES:
        for dmode in MULTISTEP_DTYPES:
            label, dtype, storage, delta = dmode[:4]
            line = []
            for mlabel, fields in _multistep_modes():
                cfg = PlasmaConfig(NX=nx, NY=ny, dtype=getattr(torch, dtype),
                                   storage=storage, neutral_delta=delta,
                                   poisson_max_iter=60, **fields)
                kw = plasma.multistep_kwargs(cfg)
                st = _seeded_state(cfg, device, seed=ny * 1000 + nx)
                args = (st.f, st.g, st.Ex, st.Ey, st.phi)
                notes = []
                for k in (1, 4, 17, 32) if ny == 200 else (1, 4, 17):
                    k_out = fm.collide_stream_multistep(*args, k_steps=k, **kw)
                    p_out = fm.collide_stream_multistep_reference(
                        *args, k_steps=k, **kw)
                    torch.cuda.synchronize()
                    mx, n = _hold_window(f"{label} {ny}x{nx} {mlabel} K={k}",
                                         dmode, kw["solve_fft"], k_out, p_out)
                    if label == "f64":
                        worst_f64 = max(worst_f64, mx)
                    notes += [f"K={k} {note}" for note in n]
                line.append(f"{mlabel}: " + ("; ".join(notes) if notes
                                             else "bitwise"))
            print(f"{label:>10} {ny}x{nx}: " + " | ".join(line))
    return worst_f64


PROBE_E = ("Ex", "Ey", "E_mag")


def phase_multistep_golden():
    """Phase 7b; returns the window kernel's launch count."""
    from lbm_tpu_torch import run_plasma

    print("== phase 7b: golden 200x200x200 f64, --multistep 8, CLI")
    ref = _parse_probe_fixture(FIXTURE)
    _reset_launches()
    summary = run_plasma.main(["--preset", "golden", "--f64", "--multistep",
                               "8", "--device", "cuda", "--out",
                               os.path.join(OUT, "golden_multistep")]
                              + NO_VIDEO)
    STRAIGHT["golden_multistep"] = summary
    launches = summary["launches"]
    want = {"collide_stream": 0, "fused_collide": 0, "solve_iter": 0,
            "collide_stream_multistep": 25, "fft_solve": 0, **NO_HALO,
            **NO_GATED}
    require(launches == want, f"launches {launches}, want {want}")
    require(summary["finite"], "golden multistep state is not finite")
    worst = 0.0
    for k, series in ref.items():
        # a window row holds the macros before it and the E after it
        rows = series[7::8] if k in PROBE_E else series[0::8]
        got = summary["probes"][k]
        require(got.shape == rows.shape,
                f"probe {k}: shape {got.shape} vs {rows.shape}")
        scale = np.abs(series).max()
        err = np.abs(got - rows)
        allowed = 1e-5 * np.abs(rows) + 1e-5 * scale
        ratio = float((err / np.where(allowed == 0, 1e-300, allowed)).max())
        worst = max(worst, float(err.max() / scale) if scale else 0.0)
        require(ratio <= 1.0, f"probe series {k}: {ratio:.3f} x the "
                f"rtol 1e-5 / atol 1e-5*scale gate")
    print(f"25 window rows of 19 probe series match the C++ fixture (macros "
          f"at t = 0, 8, ..., 192; E at t + 7): worst max|err|/scale "
          f"{worst:.3e} (gate 1e-5); {launches['collide_stream_multistep']} "
          f"launches; {summary['wall_ms']:.1f} ms wall with probes "
          f"({summary['wall_ms'] / 200:.4f} ms/step, {summary['mlups']:.2f} "
          f"MLUPS)")
    return launches["collide_stream_multistep"]


def _dft_flop(ny, nx):
    """flop of one in-kernel DFT solve and E, as the kernel's loops count
    them (a multiply and an add are two): A, B over x (4 NX each of the
    NY H outputs); the forward and the inverse y passes (8 NY, plus 4 and
    2); phi over k (4 H + 1 each of NY NX); E (4 a site)."""
    h = nx // 2 + 1
    return (ny * h * (4 * nx + 8 * ny + 4 + 8 * ny + 2)
            + ny * nx * (4 * h + 1 + 4))


_SASS = {}


def _issue_floor_ms(mode, sites):
    """The collide stage's issue floor at `sites` sites a step: the static
    FP32, FP64 and MUFU instruction counts (cuobjdump -sass of the built
    library) of the per-step tile kernel of the mode's arithmetic ("f32",
    "f32+delta", "bf16+delta", "f64"; a bf16 window's f32 work buffers
    collide with the bf16 mode's arithmetic), a thread a site, over the
    SMs' issue rates at the card's maximum SM clock:
    scripts/trace_plasma3d_torch.py's model, the largest of the three
    pipes' times."""
    from collections import Counter
    from lbm_tpu_torch.kernels import build
    sys.path.insert(0, os.path.join(HERE, "scripts"))
    import trace_plasma3d_torch as t3
    if not _SASS:
        _SASS.update(t3.sass_counts(
            str(build.build()), lambda n: "plasma_tiles_kernel" in n
            or "cavity_step_kernel" in n))
        _SASS["clock"] = t3.max_sm_clock_hz()
    args = {"f64": "Idd", "f32": "Iff", "f32+delta": "Iff",
            "bf16+delta": "I13__nv_bfloat16f"}[mode]
    args += ("Lb1E" if mode.endswith("delta") else "Lb0E") + \
        ("Lb1E" if mode.startswith("bf16") else "Lb0E")
    fn = [k for k in _SASS if f"plasma_tiles_kernel{args}E" in k]
    require(len(fn) == 1, f"tile kernel of {mode}: {len(fn)} SASS matches")
    t = t3.issue_ms(Counter(_SASS[fn[0]]), 1 / 32, sites, _SASS["clock"])
    return max(t["fp32"], t["fp64"], t["mufu"])


def _cavity_floor_ms(lean, storage, sites):
    """The cavity step program's issue floor at `sites` sites (a window: K
    times its sites): _issue_floor_ms's model on the f32 (bf16: bf16
    storage) cavity_step_kernel of the stored or lean form. The kernel
    holds one copy of the collision (one call of collide_row) and one of
    the pull and store, each run once a site; the edge columns and span
    ends that the tasks collide again (3-8% more collisions) are left out,
    so the floor stays below the work."""
    from collections import Counter
    _issue_floor_ms("f32", 1)   # loads the SASS counts and the clock
    t3 = sys.modules["trace_plasma3d_torch"]
    args = ("I13__nv_bfloat16f" if storage == "bf16" else "Iff") + \
        f"Lb{int(lean)}E"
    fn = [k for k in _SASS if f"cavity_step_kernel{args}" in k]
    require(len(fn) == 1, f"cavity step kernel {args}: {len(fn)} SASS "
            f"matches")
    t = t3.issue_ms(Counter(_SASS[fn[0]]), 1 / 32, sites, _SASS["clock"])
    return max(t["fp32"], t["fp64"], t["mufu"])


def _collide_bound_ms(sites):
    """(least ms, "bytes" or "operations") of an f32 collide+stream call:
    444 B a site (f, g, E, rho_q once) against the tile kernel's issue
    floor."""
    t_bytes = 444 * sites / HBM_BYTES_PER_S * 1e3
    t_ops = _issue_floor_ms("f32", sites)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _multistep_bound_ms(n, k_steps, storage, fft):
    """(least ms, "bytes" or "operations") of one window at n x n f32
    compute: K times the collide stage's issue floor plus the DFT solve's
    flop as the kernel computes it at the non-tensor f32 rate, or f and g
    read and written once."""
    mode = "bf16+delta" if storage == "bf16" else "f32"
    t_ops = (k_steps * _issue_floor_ms(mode, n * n)
             + (_dft_flop(n, n) * k_steps / F32_FLOP_PER_S * 1e3 if fft
                else 0.0))
    t_bytes = BYTES_PER_SITE[storage] * n * n / HBM_BYTES_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _init_fields(cfg, device):
    """(f, g, Ex, Ey, phi) of the initial state."""
    from lbm_tpu_torch.models import plasma
    st = plasma.init_state(cfg, device)
    return st.f, st.g, st.Ex, st.Ey, st.phi


# label, n, storage, poisson, bc, K, windows (one warm-up), chained
# launches, hold against the plain version; bench.py's legs
# (bench.py:456-473) and the sizes where the JAX package needs its banded
# wrapper (whose bounce-back branch runs the gated kernel)
def _multistep_cells():
    from lbm_tpu_torch.config import BC, PoissonSolver as P
    per, bb = BC.PERIODIC, BC.BOUNCE_BACK
    return [
        ("200^2 FFT f32 K=256", 200, "native", P.FFT, per, 256, 3, 3, False),
        ("200^2 FFT bf16+delta K=256", 200, "bf16", P.FFT, per, 256, 3, 3,
         False),
        ("256^2 NONE bf16+delta K=256", 256, "bf16", P.NONE, per, 256, 3, 3,
         False),
        ("2048^2 NONE bf16+delta K=32", 2048, "bf16", P.NONE, per, 32, 3, 3,
         True),
        ("2048^2 NONE bounce-back bf16+delta K=32", 2048, "bf16", P.NONE, bb,
         32, 3, 3, True),
        ("4096^2 NONE bf16+delta K=32", 4096, "bf16", P.NONE, per, 32, 2, 2,
         True),
    ]


def phase_multistep_real_size():
    """Phase 7c; returns ((ms, plain_ms, bound_ms, bound_by, at) at 2048^2,
    the worst max|err| of the holds)."""
    import torch
    from lbm_tpu_torch.config import PlasmaConfig
    from lbm_tpu_torch.kernels import fused_multistep as fm
    from lbm_tpu_torch.models import plasma

    print("== phase 7c: window kernel at real sizes (CUDA events)")
    device = torch.device("cuda")
    out, worst = None, 0.0
    for (label, n, storage, sol, bc, K, windows, reps,
         hold) in _multistep_cells():
        cfg = PlasmaConfig(NX=n, NY=n, dtype=torch.float32, storage=storage,
                           neutral_delta=storage == "bf16", poisson=sol,
                           bc=bc, backend="fused", multistep=K)
        roll = plasma.make_rollout(cfg, K)
        state = roll(plasma.init_state(cfg, device))
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(windows - 1):
            state = roll(state)
        t1.record()
        torch.cuda.synchronize()
        step_ms = t0.elapsed_time(t1) / ((windows - 1) * K)
        require(all(bool(torch.isfinite(t.float()).all())
                    for t in (state.f, state.g, state.Ex, state.Ey,
                              state.phi)),
                f"{label}: state not finite after {windows * K} steps")
        kw = plasma.multistep_kwargs(cfg)
        args = (state.f, state.g, state.Ex, state.Ey, state.phi)
        notes = []
        if hold:
            k_out = fm.collide_stream_multistep(*args, k_steps=K, **kw)
        # the plain version at the cell's K, or a 16-step window where a
        # K = 256 one would take ~25 s (its host-driven DFT loops)
        k_plain = K if hold else min(K, 16)
        torch.cuda.synchronize()
        tp = time.perf_counter()
        p_out = fm.collide_stream_multistep_reference(*args, k_steps=k_plain,
                                                      **kw)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - tp) * 1e3
        if hold:
            dmode = MULTISTEP_DTYPES[2 if storage == "bf16" else 1]
            mx, notes = _hold_window(label, dmode, kw["solve_fft"], k_out,
                                     p_out)
            worst = max(worst, mx)
            del k_out
        del p_out
        # launches chained as the rollout chains them
        box = [args]

        def chained():
            f, g, Ex, Ey, phi = box[0]
            o = fm.collide_stream_multistep(f, g, Ex, Ey, phi, k_steps=K,
                                            **kw)
            box[0] = o if len(o) == 5 else (*o, Ex, Ey, phi)

        ms = _device_ms(chained, reps)
        # one input repeated: the initial state and the rollout's end state
        init = _init_fields(cfg, device)
        seeded = _device_ms(lambda: fm.collide_stream_multistep(
            *init, k_steps=K, **kw), max(reps - 1, 1))
        developed = _device_ms(lambda: fm.collide_stream_multistep(
            *args, k_steps=K, **kw), max(reps - 1, 1))
        del init
        bound, bound_by = _multistep_bound_ms(n, K, storage, kw["solve_fft"])
        print(f"{label}: {step_ms:.4f} ms/step, "
              f"{n * n / (step_ms * 1e-3) / 1e6:.1f} MLUPS (window "
              f"{K}+{(windows - 1) * K} steps); "
              + (("vs plain on the end state: " + ("; ".join(notes) if notes
                                                   else "bitwise equal")
                  + "; ") if hold else "")
              + f"{ms:.4f} ms a launch chained ({ms / K:.4f} ms a step); "
              f"one input: the initial state {seeded:.4f}, the end state "
              f"{developed:.4f} ms; "
              f"bound {bound:.4f} ms by {bound_by} ({100 * bound / ms:.1f}% "
              f"of chained); plain {plain_ms:.1f} ms (1 call, K={k_plain}, "
              f"{plain_ms / k_plain:.2f} ms a step)")
        if label == "2048^2 NONE bf16+delta K=32":
            out = (ms, plain_ms, bound, bound_by,
                   f"2048x2048 bf16+delta NONE K={K}, a launch chained")
        del state, args, box
        torch.cuda.empty_cache()
    return out, worst



# the 3-D kernel: bytes a site (f and g read and written, E read, rho_q
# written) by storage, and operations a site (the JAX kernel's cost
# estimate, lbm_tpu/kernels/fused_step3d.py:486)
BYTES_PER_SITE_3D = {"native": 928, "bf16": 472}
FLOP_PER_SITE_3D = 6000
# (label, dtype, storage, neutral_delta, rtol, atol*scale); None: one bf16 ulp
COLLIDE3D_MODES = [m for m in COLLIDE_MODES if m[0] != "bf16"]


def _bound3d_ms(f, Ex):
    """(least ms, "bytes" or "operations") of one collide_stream3d call on
    these inputs: f and g read and written once, Ex, Ey, Ez read, rho_q
    written, against FLOP_PER_SITE_3D a site at the compute type's rate."""
    sites = Ex.numel()
    t_bytes = ((4 * f.numel() * f.element_size() + 4 * sites
                * Ex.element_size()) / HBM_BYTES_PER_S * 1e3)
    rate = F64_FLOP_PER_S if Ex.element_size() == 8 else F32_FLOP_PER_S
    t_ops = FLOP_PER_SITE_3D * sites / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _seeded_state3d(cfg, device, seed, warm_steps):
    """The 3-D initial state after `warm_steps` plain steps, with a seeded
    relative perturbation of ~1e-3 of f, g and Ex and an additive one of Ey
    and Ez (made on the card from a torch.Generator)."""
    import torch
    from lbm_tpu_torch.models import plasma3d

    state = plasma3d.init_state(cfg, device)
    step = plasma3d.make_step(dataclasses.replace(cfg, backend="plain"))
    for _ in range(warm_steps):
        state = step(state)
    gen = torch.Generator(device=device).manual_seed(seed)

    def perturb(t, additive=0.0):
        a = t.double()
        noise = torch.randn(a.shape, generator=gen, device=device,
                            dtype=torch.float64)
        return (a * (1.0 + 1e-3 * noise) + additive * noise).to(
            t.dtype).contiguous()

    e = 1e-3 * float(state.Ex.abs().max())
    return state._replace(f=perturb(state.f), g=perturb(state.g),
                          Ex=perturb(state.Ex), Ey=perturb(state.Ey, e),
                          Ez=perturb(state.Ez, e))


def _hold3d(where, mode, k_out, p_out):
    """Hold collide_stream3d's (f, g, rho_q) against its plain version's
    with the phase-3 ladder; returns (max|err|, the line to print)."""
    import torch
    label, _, storage, _, rtol, atol = mode
    worst, line = 0.0, []
    for name, kg, pg in zip(("f", "g", "rho_q"), k_out, p_out):
        require(kg.shape == pg.shape and kg.dtype == pg.dtype,
                f"{where} {name}: shape/dtype differ")
        require(bool(torch.isfinite(kg.float()).all()),
                f"{where} {name}: kernel output not finite")
        if storage == "bf16" and name != "rho_q":
            mx, ratio, same = _errors(kg, pg, 0, 0, bf16_ulp=True)
            tol = "1 bf16 ulp"
        else:
            r, a = (rtol, atol) if rtol is not None else (1e-5, 1e-6)
            mx, ratio, same = _errors(kg, pg, r, a)
            tol = f"rtol {r:g} atol {a:g}*scale"
        worst = max(worst, mx)
        line.append(f"{name} {mx:.3e} ({ratio:.3f} of {tol}, "
                    f"{int(round(same * kg.numel()))}/{kg.numel()} bitwise)")
        require(ratio <= 1.0, f"{where} {name}: error {ratio:.3f} x the "
                f"tolerance ({tol})")
    return worst, "; ".join(line)


# 8a's shapes at the edges of the tile program's runs (x, y, z): W = 64
# sites (f64 32), so a row of 1 or 3 sites, W + 1 in f32 / bf16 and in f64,
# and a ragged last run (100 = 64 + 36); rows whose bytes are not a
# multiple of 16 take the unaligned route (cp.async and element stores)
RUN_EDGES_3D = [(1, 5, 4), (3, 5, 4), (65, 6, 3), (33, 6, 3), (100, 6, 3)]


def _tile_route(nx, storage, dtype):
    """The staging route the tile program takes for rows of nx sites."""
    s_size = 2 if storage == "bf16" else (8 if dtype == "float64" else 4)
    t_size = 8 if dtype == "float64" else 4
    return ("TMA" if (nx * s_size) % 16 == 0 and (nx * t_size) % 16 == 0
            else "cp.async")


def phase_3d_kernel():
    """Phase 8a; returns the worst max|err| over the f64 holds."""
    import torch
    from lbm_tpu_torch.config import PlasmaConfig
    from lbm_tpu_torch.kernels import fused_step3d

    print("== phase 8a: collide_stream3d vs plain version on the card")
    device = torch.device("cuda")
    worst_f64 = 0.0
    for nx, ny, nz in ((12, 16, 8), (16, 16, 1), (17, 13, 2)):
        for mode in COLLIDE3D_MODES:
            label, dtype, storage, delta = mode[:4]
            cfg = PlasmaConfig(NX=nx, NY=ny, NZ=nz,
                               dtype=getattr(torch, dtype), storage=storage,
                               neutral_delta=delta, backend="fused")
            st = _seeded_state3d(cfg, device, nz * 10000 + ny * 100 + nx, 2)
            args = (st.f, st.g, st.Ex, st.Ey, st.Ez)
            phys = phys_of(cfg)
            k_out = fused_step3d.collide_stream3d(*args, **phys)
            p_out = fused_step3d.collide_stream3d_reference(*args, **phys)
            torch.cuda.synchronize()
            where = f"{label} {nx}x{ny}x{nz}"
            mx, line = _hold3d(where, mode, k_out, p_out)
            if dtype == "float64":
                worst_f64 = max(worst_f64, mx)
            print(f"{where:>22}: {line}")
    # the run's edges, both staging routes, every mode
    for nx, ny, nz in RUN_EDGES_3D:
        routes = set()
        for mode in COLLIDE_MODES:
            label, dtype, storage, delta = mode[:4]
            cfg = PlasmaConfig(NX=nx, NY=ny, NZ=nz,
                               dtype=getattr(torch, dtype), storage=storage,
                               neutral_delta=delta, backend="fused")
            st = _seeded_state3d(cfg, device, nz * 10000 + ny * 100 + nx, 2)
            args = (st.f, st.g, st.Ex, st.Ey, st.Ez)
            phys = phys_of(cfg)
            k_out = fused_step3d.collide_stream3d(*args, **phys)
            p_out = fused_step3d.collide_stream3d_reference(*args, **phys)
            torch.cuda.synchronize()
            for name, kg, pg in zip(("f", "g", "rho_q"), k_out, p_out):
                require(torch.equal(kg, pg), f"run edge {label} {nx}x{ny}x"
                        f"{nz} {name}: not bitwise equal to the plain version")
            if dtype == "float64":
                worst_f64 = max(worst_f64, max(float(
                    (a.double() - b.double()).abs().max())
                    for a, b in zip(k_out, p_out)))
            routes.add(_tile_route(nx, storage, dtype))
        print(f"run edge {nx}x{ny}x{nz}: bitwise equal to the plain version "
              f"in all {len(COLLIDE_MODES)} modes ({', '.join(sorted(routes))})")
    return worst_f64


def phase_3d_cli():
    """Phase 8b; returns (launches, (ms, plain_ms, bound_ms, bound_by, at),
    max|err| of the hold) of collide_stream3d on the CLI's default run."""
    import torch
    from lbm_tpu_torch import run_plasma3d
    from lbm_tpu_torch.kernels import fused_step3d
    from lbm_tpu_torch.models import plasma3d

    print("== phase 8b: 3-D CLI defaults (64^2x64, 50 steps, FFT, fused)")
    _reset_launches()
    _reset_cavity_launches()
    summary = run_plasma3d.main(["--out", os.path.join(OUT, "plasma3d")])
    STRAIGHT["plasma3d"] = summary
    launches = fused_step3d.LAUNCHES
    require(summary["launches"]["collide_stream3d"] == launches == 50,
            f"3-D CLI launched collide_stream3d {launches} times, want 50")
    require(summary["finite"], "3-D CLI state not finite")
    require(summary["device"] == torch.cuda.get_device_name(0)
            and summary["backend"] == "fused", f"3-D CLI ran on "
            f"{summary['device']}, backend {summary['backend']}")
    # the kernel against its plain version on the run's end state
    cfg = run_plasma3d.build_config(run_plasma3d.parse_args([]))
    st = summary["state"]
    args = (st.f, st.g, st.Ex, st.Ey, st.Ez)
    phys = phys_of(cfg)
    mode = COLLIDE_MODES[3]   # f32+delta, the CLI's default
    err, line = _hold3d("8b end state", mode,
                        fused_step3d.collide_stream3d(*args, **phys),
                        fused_step3d.collide_stream3d_reference(*args, **phys))
    ms = _device_ms(lambda: fused_step3d.collide_stream3d(*args, **phys), 50)
    plain_ms = _time_ms(
        lambda: fused_step3d.collide_stream3d_reference(*args, **phys), 3)
    bound, bound_by = _bound3d_ms(st.f, st.Ex)
    print(f"{launches} launches, finite; {summary['wall_ms'] / 50:.4f} "
          f"ms/step with slices ({summary['mlups']:.1f} MLUPS); kernel vs "
          f"plain on the end state: {line}; kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {bound:.4f} ms by {bound_by}")
    # f64, 3 steps: the neutral mass is conserved (tests/test_plasma3d.py)
    f64 = run_plasma3d.main(["--f64", "--steps", "3", "--slice-every", "0",
                             "--out", os.path.join(OUT, "plasma3d_f64")])
    cfg64 = run_plasma3d.build_config(run_plasma3d.parse_args(["--f64"]))
    m0 = float(plasma3d.init_state(cfg64, torch.device("cuda")).f[2].sum())
    m3 = float(f64["state"].f[2].sum())
    drift = abs(m3 - m0) / m0
    require(f64["finite"] and f64["launches"]["collide_stream3d"] == 3,
            f"3-D f64 run: finite {f64['finite']}, launches "
            f"{f64['launches']}")
    require(drift < 1e-12, f"3-D f64 neutral mass drift {drift:.3e} >= "
            f"1e-12 after 3 steps")
    print(f"f64, 3 steps: neutral mass drift {drift:.3e} (gate 1e-12)")
    return launches, (ms, plain_ms, bound, bound_by,
                      "64x64x64 f32+delta, the CLI's end state"), err


# label, n, nz, storage; bench.py's 3-D legs (bench.py:506-516) and their
# neighbours
CELLS_3D = [
    ("128^3 bf16+delta", 128, 128, "bf16"),
    ("128^3 f32+delta", 128, 128, "native"),
    ("256^3 bf16+delta", 256, 256, "bf16"),
    ("512^2x64 bf16+delta", 512, 64, "bf16"),
    ("1024^2x32 bf16+delta", 1024, 32, "bf16"),
]
# the cross-sections where the JAX package routes to its split pair
# (fused_split3d, f32 ~152-192^2, bf16 ~216-256^2) and its y-paneled kernel
# (fused_panel3d, 512^2-1024^2), at NZ = 4
SHAPE_HOLDS_3D = [(192, "native"), (256, "bf16"), (512, "bf16"),
                  (1024, "bf16")]


def _hold3d_by_slabs(args, phys, depth):
    """collide_stream3d on a grid too large for its plain version's
    temporaries, held bitwise slab by slab: each z-slab of `depth` slices
    against halo3d_reference on that slab and its two neighbour slices
    (which equals the plain version on the whole grid at the slab)."""
    import torch
    from lbm_tpu_torch.kernels import fused_step3d

    out = fused_step3d.collide_stream3d(*args, **phys)
    NZ = args[2].shape[0]
    for z0 in range(0, NZ, depth):
        zs = slice(z0, min(z0 + depth, NZ))
        want = fused_step3d.halo3d_reference(
            *fused_step3d.halo_inputs3d(args, zs, None), **phys)
        for name, k, w in zip(("f", "g", "rho_q"), out, want):
            require(torch.equal(k[..., zs, :, :], w), f"slab {zs} {name}: "
                    f"collide_stream3d not bitwise equal to the plain version")
        del want
    del out
    torch.cuda.empty_cache()
    return f"bitwise equal to the plain version in {-(-NZ // depth)} slabs"


def phase_3d_real_size():
    """Phase 8c; returns the worst max|err| of the shape holds."""
    import torch
    from lbm_tpu_torch.config import PlasmaConfig
    from lbm_tpu_torch.kernels import fused_step3d
    from lbm_tpu_torch.models import plasma3d

    print("== phase 8c: 3-D real sizes, FFT (CUDA events) and shape holds")
    device = torch.device("cuda")
    warm, steps = 2, 6
    for label, n, nz, storage in CELLS_3D:
        cfg = PlasmaConfig(NX=n, NY=n, NZ=nz, dtype=torch.float32,
                           storage=storage, neutral_delta=True,
                           backend="fused")
        phys = phys_of(cfg)
        state, step_ms = _window(plasma3d.make_step(cfg),
                                 plasma3d.init_state(cfg, device), warm, steps)
        require(all(bool(torch.isfinite(t.float()).all())
                    for t in (state.f, state.g, state.Ex, state.Ey,
                              state.Ez)),
                f"{label}: state not finite after {warm + steps} steps")
        args = (state.f, state.g, state.Ex, state.Ey, state.Ez)
        ms = _device_ms(lambda: fused_step3d.collide_stream3d(*args, **phys),
                        10)
        rho_q = fused_step3d.collide_stream3d(*args, **phys)[2]
        solve_ms = _time_ms(lambda: plasma3d.efield_periodic3d(
            plasma3d.solve_fft3d(rho_q)), 10)
        bound, bound_by = _bound3d_ms(state.f, state.Ex)
        sites = n * n * nz
        line = (f"{label}: {step_ms:.4f} ms/step, "
                f"{sites / (step_ms * 1e-3) / 1e6:.1f} MLUPS (window "
                f"{warm}+{steps} steps); kernel {ms:.4f} ms "
                f"({BYTES_PER_SITE_3D[storage] * sites / (ms * 1e-3) / 1e9:.0f}"
                f" GB/s at {BYTES_PER_SITE_3D[storage]} B/site; bound "
                f"{bound:.4f} ms by {bound_by}, {100 * bound / ms:.1f}%); "
                f"solve+E {solve_ms:.4f} ms")
        if n == 128:
            plain_ms = _time_ms(lambda: fused_step3d.collide_stream3d_reference(
                *args, **phys), 3)
            line += f"; plain {plain_ms:.4f} ms"
        if n == 1024:
            line += "; " + _hold3d_by_slabs(args, phys, 4)
        print(line)
        del state, args, rho_q
        torch.cuda.empty_cache()
    worst = 0.0
    for n, storage in SHAPE_HOLDS_3D:
        mode = COLLIDE_MODES[3 if storage == "native" else 5]
        cfg = PlasmaConfig(NX=n, NY=n, NZ=4, dtype=torch.float32,
                           storage=storage, neutral_delta=True,
                           backend="fused")
        phys = phys_of(cfg)
        st = _seeded_state3d(cfg, device, n, 1)
        args = (st.f, st.g, st.Ex, st.Ey, st.Ez)
        where = f"{n}^2x4 {mode[0]}"
        mx, line = _hold3d(where, mode,
                           fused_step3d.collide_stream3d(*args, **phys),
                           fused_step3d.collide_stream3d_reference(*args,
                                                                   **phys))
        worst = max(worst, mx)
        print(f"shape hold {where}: {line}")
        del st, args
        torch.cuda.empty_cache()
    return worst

# the spectral solve kernel: the shapes phase 9a holds (both A = 1 axes, the
# 2-D step's real sizes and the longest axes a block holds), and those where
# the phi route (solve_fft + efield_periodic) is also a gate: the JAX
# package's own gate shapes for it (tests/test_fft_tpu.py:48-57) and the
# 128/256 grids. At larger or longer grids the phi route's own f32 error
# against the float64 answer reaches the gate (it differences a potential
# whose low modes grow with the grid), so there it is printed, not gated.
FFT_SHAPES = [(128, 128), (128, 256), (256, 128), (256, 256), (2048, 2048),
              (4096, 4096), (128, 16384), (16384, 128)]
FFT_PHI_GATE_SHAPES = {(128, 128), (128, 256), (256, 128), (256, 256),
                       (512, 256), (128, 512)}
FFT_BYTES_PER_SITE = 12          # rho read, Ex and Ey written, f32
# the three passes through the tiled complex f32 scratch: rho in and the
# scratch out (4 + 8), the panels in and out (8 + 8), the scratch in and Ex,
# Ey out (8 + 8)
FFT_PASS_BYTES_PER_SITE = 44
FFT_PASSES = ("rows_forward_pair", "panel_solve", "rows_inverse_tiled")


def _fft_bound_ms(ny, nx):
    """(least ms, "bytes" or "operations") of one solve: 12 B a site
    against 2 x 5 N log2 N flop (a forward and an inverse 2-D complex
    transform of N sites) at the f32 rate."""
    n = ny * nx
    t_bytes = FFT_BYTES_PER_SITE * n / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * 5 * n * np.log2(n) / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _field_err(got, want):
    """(max |err| over Ex and Ey, the same over the larger field's scale)."""
    err = max(float((g.double() - w.double()).abs().max())
              for g, w in zip(got, want))
    scale = max(float(w.double().abs().max()) for w in want)
    return err, err / scale


def _hold_fft(where, rho, gate_phi):
    """The kernel on rho against its plain version (1e-5 of scale), the
    k-space cuFFT route (2e-5), the float64 answer (1e-5) and, where
    gate_phi, the phi route (2e-5); returns (max|err| vs plain, line)."""
    import torch
    from lbm_tpu_torch.kernels import fft_tpu
    from lbm_tpu_torch.ops import poisson

    got = fft_tpu.solve_fft_efield_tpu(rho)
    torch.cuda.synchronize()
    require(all(bool(g.isfinite().all()) for g in got),
            f"{where}: kernel output not finite")
    checks = [
        ("plain", fft_tpu.solve_fft_efield_reference(rho), 1e-5),
        ("kspace", poisson.solve_fft_efield(rho), 2e-5),
        ("f64", poisson.solve_fft_efield(rho.double()), 1e-5),
        ("phi", poisson.efield_periodic(poisson.solve_fft(rho)),
         2e-5 if gate_phi else None)]
    parts, worst = [], None
    for name, want, gate in checks:
        err, rel = _field_err(got, want)
        if name == "plain":
            worst = err
        parts.append(f"{name} {rel:.3e}" + ("" if gate else " (not gated)"))
        if gate is not None:
            require(rel <= gate, f"{where}: kernel vs {name} {rel:.3e} of "
                    f"scale > {gate:g}")
    return worst, "; ".join(parts)


def phase_fft_kernel():
    """Phase 9a; returns the worst max|err| against the plain version."""
    import torch
    from lbm_tpu_torch.config import PlasmaConfig
    from lbm_tpu_torch.kernels import fft_tpu, fused_step
    from lbm_tpu_torch.ops import poisson

    print("== phase 9a: spectral solve kernel vs plain version, "
          "errors over the field scale")
    device = torch.device("cuda")
    worst = 0.0
    for ny, nx in FFT_SHAPES:
        rng = np.random.default_rng(ny * 7 + nx)
        rho = torch.as_tensor(rng.standard_normal((ny, nx)) * 1e-8,
                              dtype=torch.float32, device=device)
        err, line = _hold_fft(f"{ny}x{nx} seeded", rho,
                              (ny, nx) in FFT_PHI_GATE_SHAPES)
        worst = max(worst, err)
        if ny == nx >= 2048:
            ms = _device_ms(lambda: fft_tpu.solve_fft_efield_tpu(rho), 20)
            phi_ms = _time_ms(lambda: poisson.efield_periodic(
                poisson.solve_fft(rho)), 20)
            bound, bound_by = _fft_bound_ms(ny, nx)
            passes = _pass_ms(lambda: fft_tpu.solve_fft_efield_tpu(rho), 20,
                              FFT_PASSES)
            line += (f"; kernel {ms:.4f} ms (bound {bound:.4f} by "
                     f"{bound_by}; passes " + ", ".join(
                         f"{k} " + ("not measured" if v is None
                                    else f"{v:.4f}")
                         for k, v in passes.items())
                     + f" ms against {FFT_PASS_BYTES_PER_SITE} B/site "
                     f"{FFT_PASS_BYTES_PER_SITE * ny * nx / HBM_BYTES_PER_S * 1e3:.4f}"
                     f" ms), solve_fft + efield_periodic {phi_ms:.4f} ms")
        print(f"{ny}x{nx} seeded rho: {line}")
    # the rho_q of a warm seeded 2048^2 state (two plain steps)
    cfg = PlasmaConfig(NX=2048, NY=2048, dtype=torch.float32,
                       backend="fused")
    st = _seeded_state(cfg, device, seed=2048)
    rho_q = fused_step.collide_stream(st.f, st.g, st.Ex, st.Ey,
                                      **phys_of(cfg))[2]
    err, line = _hold_fft("2048x2048 warm rho_q", rho_q, False)
    worst = max(worst, err)
    print(f"2048x2048 warm state's rho_q: {line}")
    try:
        fft_tpu.solve_fft_efield_tpu(torch.zeros((128, 32768),
                                                 device=device))
        raise SmokeFailure("a 32768-long axis was not refused")
    except ValueError as e:
        print(f"128x32768 refused: {e}")
    del st, rho_q
    torch.cuda.empty_cache()
    return worst


def _pass_ms(fn, reps, names):
    """Device ms per call of each kernel whose name holds one of `names`,
    from a torch.profiler trace of `reps` calls (None where the trace
    holds no device time for it)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = dict.fromkeys(names)
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", 0) or 0
        for name in names:
            if name in ev.key and us:
                out[name] = (out[name] or 0.0) + us / 1e3 / reps
    return out


def phase_fft_real_size():
    """Phase 9b: the 2-D fused step with fft_engine="pallas" at 2048^2;
    returns (launches of the f32 run, (ms, plain_ms, bound_ms, bound_by,
    library_ms, at), max|err| of the holds)."""
    import torch
    from lbm_tpu_torch.config import PlasmaConfig
    from lbm_tpu_torch.kernels import fft_tpu, fused_step
    from lbm_tpu_torch.models import plasma
    from lbm_tpu_torch.ops import poisson

    print("== phase 9b: 2048^2 FFT + periodic, fft_engine='pallas', fused, "
          "5 warm-up + 30 timed steps")
    n, warm, steps = 2048, 5, 30
    device = torch.device("cuda")
    out, worst = None, 0.0
    for storage in ("native", "bf16"):
        label = "f32" if storage == "native" else "bf16+delta"
        cfg = PlasmaConfig(NX=n, NY=n, dtype=torch.float32, backend="fused",
                           storage=storage, neutral_delta=storage == "bf16",
                           fft_engine="pallas")
        phys = phys_of(cfg)
        step = plasma.make_step(cfg)
        state = plasma.init_state(cfg, device)
        _reset_launches()
        state, step_ms = _window(step, state, warm, steps)
        launches = fft_tpu.LAUNCHES
        require(launches == fused_step.LAUNCHES == warm + steps,
                f"{label}: {launches} solve and {fused_step.LAUNCHES} "
                f"collide launches in {warm + steps} steps")
        require(all(bool(torch.isfinite(t.float()).all())
                    for t in (state.f, state.g, state.Ex, state.Ey)),
                f"{label}: state not finite after {warm + steps} steps")
        require(not state.phi.any(), f"{label}: phi was formed")
        args = (state.f, state.g, state.Ex, state.Ey)
        rho_q = fused_step.collide_stream(*args, **phys)[2]
        err, line = _hold_fft(f"9b {label} end state", rho_q, False)
        worst = max(worst, err)
        ms = _device_ms(lambda: fft_tpu.solve_fft_efield_tpu(rho_q), steps)
        kern_ms = _time_ms(lambda: fused_step.collide_stream(*args, **phys),
                           steps)
        phi_ms = _time_ms(lambda: poisson.efield_periodic(
            poisson.solve_fft(rho_q)), steps)
        kspace_ms = _time_ms(lambda: poisson.solve_fft_efield(rho_q), steps)
        plain_ms = _time_ms(
            lambda: fft_tpu.solve_fft_efield_reference(rho_q), 3)
        bound, bound_by = _fft_bound_ms(n, n)
        pass_ms = FFT_PASS_BYTES_PER_SITE * n * n / HBM_BYTES_PER_S * 1e3
        if storage == "native":
            passes = _pass_ms(lambda: fft_tpu.solve_fft_efield_tpu(rho_q),
                              steps, FFT_PASSES)
            print("   the passes, torch.profiler: " + ", ".join(
                f"{k} " + ("not measured" if v is None else f"{v:.4f} ms")
                for k, v in passes.items()))
        print(f"{label:>10}: {step_ms:.4f} ms/step, "
              f"{n * n / (step_ms * 1e-3) / 1e6:.1f} MLUPS; {launches} solve "
              f"launches in {warm + steps} steps (1 a step); solve kernel "
              f"{ms:.4f} ms (bound {bound:.4f} ms by {bound_by}, "
              f"{100 * bound / ms:.1f}%; {FFT_PASS_BYTES_PER_SITE} B/site of "
              f"three passes: {pass_ms:.4f} ms); library: solve_fft + "
              f"efield_periodic {phi_ms:.4f} ms, solve_fft_efield "
              f"{kspace_ms:.4f} ms; plain four-step {plain_ms:.4f} ms; "
              f"collide_stream {kern_ms:.4f} ms; end-state hold: {line}")
        if out is None:
            out = (launches, (ms, plain_ms, bound, bound_by, phi_ms,
                              f"{n}x{n} f32, the 9b end state's rho_q"))
        del state, args, rho_q, step
        torch.cuda.empty_cache()
    return out[0], out[1], worst


def _parse_dump(path, NX=8, NY=8):
    """-> {(step, stage): {field: (NY, NX) array, 'f_e': {dir: grid}, ...}}
    from a debug dump (the parser of tests/test_reference_parity.py)."""
    scalars = {"ux_e", "uy_e", "ux_i", "uy_i", "ux_n", "uy_n", "rho_q",
               "rho_e", "rho_i", "rho_n"}
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as fh:
        lines = [ln.rstrip("\n") for ln in fh]
    out, cur, i = {}, None, 0

    def grid(i):
        rows = [[float(v) for v in lines[i + r].split(",")]
                for r in range(NY)]
        return np.asarray(rows)[::-1], i + NY   # y descending in the file

    while i < len(lines):
        ln = lines[i]
        if ln.startswith("step = "):
            key = (int(ln.split("=")[1]), lines[i + 1].split("=")[1].strip())
            cur = out[key] = {}
            i += 2
            continue
        if cur is not None and (ln in scalars or ln == "Ex"):
            name = ln if ln != "Ex" else ("Ey" if "Ex" in cur else "Ex")
            cur[name], i = grid(i + 1)
            continue
        m = re.match(r"(f(?:_eq)?_[ein](?:_[ein])?) dir (\d+)", ln)
        if cur is not None and m:
            g, i = grid(i + 1)
            cur.setdefault(m.group(1), {})[int(m.group(2))] = g
            continue
        i += 1
    return out


def phase_debug_dump():
    """Phase 9c: the --debug-variant --debug-dump CLI at 8x8 f64, FFT, on
    the card, against the C++ debug build's dump."""
    import torch
    from lbm_tpu_torch import run_plasma

    print("== phase 9c: --debug-variant --debug-dump CLI, 8x8 f64 FFT, "
          "against the C++ debug dump")
    out = os.path.join(OUT, "debug_dump")
    summary = run_plasma.main(["--device", "cuda", "--f64", "--nx", "8",
                               "--ny", "8", "--steps", "5", "--poisson",
                               "FFT", "--debug-variant", "--debug-dump",
                               "--out", out] + NO_VIDEO)
    require(summary["device"] == torch.cuda.get_device_name(0)
            and summary["backend"] == "plain" and summary["finite"],
            f"debug CLI ran on {summary['device']}, backend "
            f"{summary['backend']}, finite {summary['finite']}")
    mine = _parse_dump(os.path.join(out, "debug_dump.txt"))
    ref = _parse_dump(os.path.join(HERE, "tests", "fixtures",
                                   "ref_dump_solver3.txt.gz"))
    require(set(mine) == set(ref) and len(ref) == 25,
            f"dump covers {len(mine)} (step, stage) pairs, want the "
            f"fixture's {len(ref)}")
    worst = 0.0
    for key in sorted(ref):
        for field, want in ref[key].items():
            got = mine[key].get(field)
            require(got is not None, f"{field} missing at {key}")
            if isinstance(want, dict):
                want = np.stack([want[d] for d in range(9)])
                got = np.stack([got[d] for d in range(9)])
            scale = np.abs(want).max()
            err = np.abs(got - want)
            allowed = 3e-6 * np.abs(want) + max(3e-6 * scale, 1e-15)
            ratio = float((err / allowed).max())
            worst = max(worst, ratio)
            require(ratio <= 1.0, f"{field} at {key}: {ratio:.3f} x the rtol "
                    f"3e-6 / atol max(3e-6*scale, 1e-15) gate")
    print(f"25 (step, stage) pairs, every field within the gate (worst "
          f"{worst:.3f} of it); {summary['wall_ms']:.1f} ms wall")


# phase 10: the halo kernels' cuts of a full grid, (ny, nx) shards; nx = 1
# is a y-shard (collide_stream_halo), nx > 1 a tile (collide_stream_halo2d)
HALO_CUTS = [(2, 1), (4, 1), (8, 1), (2, 2), (2, 4), (4, 2)]
# strips 8 deep and y strips corner-extended by 8 (the JAX contract's) on
# these cuts, 1-row strips with 1-column corners elsewhere
HALO_DEEP = {(4, 1), (2, 4)}
# (label, NY, NX, mode of COLLIDE_MODES, cuts)
HALO_GRIDS = [
    ("2048^2", 2048, 2048, "f32", HALO_CUTS),
    ("2048^2", 2048, 2048, "bf16+delta", HALO_CUTS),
    ("512^2", 512, 512, "f64", HALO_CUTS),
    ("48x80, 24x40 tiles", 48, 80, "f32+delta", [(2, 1), (2, 2)]),
    ("50x66, 25x22 tiles", 50, 66, "f64+delta", [(2, 1), (2, 3)]),
]
HALO_FLOP = {"collide_stream_halo": 3000, "collide_stream_halo2d": 3200}


def _seeded_state_on_card(cfg, device, seed):
    """As _seeded_state, with the perturbation drawn on the card from a
    seeded torch generator (a 2048^2 state holds 113M populations)."""
    import torch
    from lbm_tpu_torch.models import plasma

    state = plasma.init_state(cfg, device)
    step = plasma.make_step(dataclasses.replace(cfg, backend="plain"))
    for _ in range(2):
        state = step(state)
    gen = torch.Generator(device=device).manual_seed(seed)

    def perturb(t, additive=0.0):
        a = t.double()
        noise = torch.randn(a.shape, generator=gen, device=device,
                            dtype=torch.float64)
        return (a * (1.0 + 1e-3 * noise) + additive * noise).to(t.dtype)

    ex_scale = float(state.Ex.abs().max())
    return state._replace(f=perturb(state.f), g=perturb(state.g),
                          Ex=perturb(state.Ex),
                          Ey=perturb(state.Ey, 1e-3 * ex_scale))


def _halo_bound_ms(name, f, Ex):
    """(least ms, "bytes" or "operations") of one halo launch on the shard
    (f, Ex): f and g read and written, Ex and Ey read, rho_q written, and
    the strips' edge sites read once; the operations of every site of the
    extended block (the JAX kernels' cost estimate a site)."""
    ny, nx = Ex.shape
    p, e = f.element_size(), Ex.element_size()
    tile = name == "collide_stream_halo2d"
    edge = 2 * (nx + 2) + 2 * ny if tile else 2 * nx
    nbytes = ny * nx * (108 * p + 3 * e) + edge * (54 * p + 2 * e)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    sites = (ny + 2) * (nx + 2 if tile else nx)
    rate = F64_FLOP_PER_S if e == 8 else F32_FLOP_PER_S
    t_ops = HALO_FLOP[name] * sites / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_halo_kernels():
    """Phase 10a: each halo kernel on every shard of a cut of a full grid,
    bitwise against collide_stream on that grid and against its plain
    version at phase 3's gates; times at the world-of-one 2048^2 shape and
    the 512x2048 / 1024x1024 shard shapes. Returns (worst max|err| against
    the plain version at 512^2 f64 by kernel, {kernel: (ms, plain_ms,
    bound_ms, bound_by, at)} at 2048^2 f32)."""
    import torch
    from lbm_tpu_torch.config import PlasmaConfig
    from lbm_tpu_torch.kernels import fused_step

    print("== phase 10a: halo kernels on cuts of a full grid, bitwise vs "
          "collide_stream and vs their plain versions")
    device = torch.device("cuda")
    modes = {m[0]: m for m in COLLIDE_MODES}
    kernels = {1: (fused_step.collide_stream_halo,
                   fused_step.collide_stream_halo_reference),
               2: (fused_step.collide_stream_halo2d,
                   fused_step.collide_stream_halo2d_reference)}
    names = {1: "collide_stream_halo", 2: "collide_stream_halo2d"}
    worst = dict.fromkeys(names.values(), 0.0)
    times = {}
    for label, NY, NX, mode, cuts in HALO_GRIDS:
        _, dtype, storage, delta, rtol, atol = modes[mode]
        cfg = PlasmaConfig(NX=NX, NY=NY, dtype=getattr(torch, dtype),
                           storage=storage, neutral_delta=delta)
        phys = phys_of(cfg)
        st = _seeded_state_on_card(cfg, device, seed=NY * 10000 + NX)
        arrays = (st.f, st.g, st.Ex, st.Ey)
        full = fused_step.collide_stream(*arrays, **phys)
        line = []
        for ny, nx in cuts:
            kind = 1 if nx == 1 else 2
            kernel, plain = kernels[kind]
            rows, cols = NY // ny, NX // nx
            deep = (ny, nx) in HALO_DEEP
            ratio_max, err_max = 0.0, 0.0
            for by in range(ny):
                for bx in range(nx):
                    ys = slice(by * rows, (by + 1) * rows)
                    xs = slice(bx * cols, (bx + 1) * cols)
                    args = fused_step.halo_inputs(
                        arrays, ys, None if kind == 1 else xs,
                        depth=8 if deep else 1, ext=8 if deep else 1)
                    k_out = kernel(*args, **phys)
                    p_out = plain(*args, **phys)
                    torch.cuda.synchronize()
                    for name, kg, pg, fg in zip(("f", "g", "rho_q"), k_out,
                                                p_out, full):
                        where = (f"{label} {mode} cut {ny}x{nx} shard "
                                 f"({by}, {bx}) {name}")
                        require(torch.equal(kg, fg[..., ys, xs]),
                                f"{where}: not bitwise equal to "
                                f"collide_stream on the full grid")
                        if rtol is None and name != "rho_q":
                            mx, ratio, _ = _errors(kg, pg, 0, 0,
                                                   bf16_ulp=True)
                        else:
                            r, a = ((rtol, atol) if rtol is not None
                                    else (1e-5, 1e-6))
                            mx, ratio, _ = _errors(kg, pg, r, a)
                        require(ratio <= 1.0, f"{where}: {ratio:.3f} x the "
                                f"gate against the plain version")
                        ratio_max = max(ratio_max, ratio)
                        err_max = max(err_max, mx)
            if mode == "f64" and NY == 512:
                worst[names[kind]] = max(worst[names[kind]], err_max)
            line.append(f"{ny}x{nx}{' (8-deep)' if deep else ''}: "
                        f"{err_max:.2e} ({ratio_max:.3f} of the gate)")
        print(f"{label:>20} {mode:>10}: every shard bitwise equal to "
              f"collide_stream; vs plain, max|err| by cut: "
              + ", ".join(line))
        if NY == 2048:
            col_ms = _device_ms(lambda: fused_step.collide_stream(
                *arrays, **phys), 20)
            shapes = ((1, (slice(0, NY), None)),
                      (1, (slice(0, NY // 4), None)),
                      (2, (slice(0, NY), slice(0, NX))),
                      (2, (slice(0, NY // 2), slice(0, NX // 2))))
            out = [f"collide_stream {col_ms:.4f} ms"]
            for kind, (ys, xs) in shapes:
                kernel, plain = kernels[kind]
                args = fused_step.halo_inputs(arrays, ys, xs)
                ms = _device_ms(lambda: kernel(*args, **phys), 20)
                plain_ms = _time_ms(lambda: plain(*args, **phys), 3)
                bound, bound_by = _halo_bound_ms(names[kind], args[0],
                                                 args[2])
                shape = f"{args[2].shape[0]}x{args[2].shape[1]}"
                out.append(f"{names[kind]} {shape} {ms:.4f} ms (bound "
                           f"{bound:.4f} by {bound_by}, "
                           f"{100 * bound / ms:.1f}%; plain "
                           f"{plain_ms:.4f})")
                if mode == "f32" and ys.stop == NY:
                    times[names[kind]] = (ms, plain_ms, bound, bound_by,
                                          f"{shape} f32, a world of one")
                del args
            print(f"{'':>20} {mode:>10} timings: " + "; ".join(out))
        del st, arrays, full
        torch.cuda.empty_cache()
    return worst, times


def phase_sharded_world_of_one():
    """Phase 10b: make_fused_sharded_step and _2d on a (1, 1) mesh over a
    one-rank NCCL group: the exchanges are the shard's own wraps, so the
    halo kernels run at full width. Returns the halo kernels' launches in
    the 2048^2 FFT f32 runs (counts reset just before each)."""
    import shutil

    import torch
    import torch.distributed as dist
    from lbm_tpu_torch.config import PlasmaConfig, PoissonSolver
    from lbm_tpu_torch.kernels import fused_step
    from lbm_tpu_torch.models import plasma
    from lbm_tpu_torch.ops import poisson
    from lbm_tpu_torch.parallel import fused_sharded
    from lbm_tpu_torch.parallel import mesh as pmesh
    from lbm_tpu_torch.parallel import poisson as ppoisson

    print("== phase 10b: the sharded steps on a one-rank NCCL group, "
          "(1, 1) mesh")
    store = os.path.join(OUT, "dist_store")
    shutil.rmtree(store, ignore_errors=True)
    os.makedirs(store)
    device = pmesh.init_distributed(
        "cuda", init_method=f"file://{store}/store", rank=0, world_size=1)
    launches = {}
    try:
        m = pmesh.make_mesh((1, 1), "cuda")

        def runs(cfg, steps):
            """End states of the single-device fused step and the two
            sharded steps after `steps` steps from the initial state."""
            out = {}
            for name, step in (
                    ("single", plasma.make_step(cfg)),
                    ("y", fused_sharded.make_fused_sharded_step(cfg, m)),
                    ("yx", fused_sharded.make_fused_sharded_step_2d(cfg, m))):
                state = plasma.init_state(cfg, device)
                for _ in range(steps):
                    state = step(state)
                out[name] = state
            torch.cuda.synchronize()
            return out

        for storage in ("native", "bf16"):
            label = "f32" if storage == "native" else "bf16+delta"
            cfg = PlasmaConfig(NX=2048, NY=2048, dtype=torch.float32,
                               storage=storage,
                               neutral_delta=storage == "bf16",
                               poisson=PoissonSolver.NONE, backend="fused")
            out = runs(cfg, 35)
            for name in ("y", "yx"):
                for k in ("f", "g", "Ex", "Ey"):
                    require(torch.equal(getattr(out[name], k),
                                        getattr(out["single"], k)),
                            f"2048^2 NONE {label} {name} step: {k} not "
                            f"bitwise equal to the single-device step")
            print(f"2048^2 NONE {label}, 35 steps: both sharded steps "
                  f"bitwise equal to the single-device fused step")
            del out

        cfg = PlasmaConfig(NX=512, NY=512, dtype=torch.float64,
                           poisson=PoissonSolver.FFT, backend="fused")
        # the JAX package's sharded tolerances (f, g 1e-11; E 1e-9), each
        # relative to the element and to the field's (species') scale: the
        # slab FFT sums in another order than the 2-D one, ~1e-14 of E's
        # scale, which per element alone fails where E or g crosses zero
        out = runs(cfg, 20)
        line = []
        for name in ("y", "yx"):
            for k, rtol in (("f", 1e-11), ("g", 1e-11), ("Ex", 1e-9),
                            ("Ey", 1e-9)):
                mx, ratio, same = _errors(getattr(out[name], k),
                                          getattr(out["single"], k), rtol,
                                          rtol)
                require(ratio <= 1.0, f"512^2 f64 FFT {name} step: {k} at "
                        f"{ratio:.3f} x rtol {rtol:g} (element and scale)")
                line.append(f"{name} {k} {mx:.2e} ({ratio:.4f} of the gate, "
                            f"{100 * same:.1f}% bitwise)")
        print("512^2 f64 FFT, 20 steps, against the single-device step "
              "(gate rtol 1e-11 f, g and 1e-9 E, of the element and of the "
              "scale): " + ", ".join(line))
        del out

        cfg = PlasmaConfig(NX=2048, NY=2048, dtype=torch.float32,
                           poisson=PoissonSolver.FFT, backend="fused")
        n, warm, steps = 2048, 5, 30
        _, single_ms = _window(plasma.make_step(cfg),
                               plasma.init_state(cfg, device), warm, steps)
        for name, make in (
                ("collide_stream_halo", fused_sharded.make_fused_sharded_step),
                ("collide_stream_halo2d",
                 fused_sharded.make_fused_sharded_step_2d)):
            step = make(cfg, m)
            state = plasma.init_state(cfg, device)
            _reset_launches()
            state, ms = _window(step, state, warm, steps)
            launches[name] = dict(fused_step.HALO_LAUNCHES)[name]
            require(dict(fused_step.HALO_LAUNCHES) == {
                **NO_HALO, name: warm + steps} and fused_step.LAUNCHES == 0,
                f"{name} step: launches {fused_step.HALO_LAUNCHES}, "
                f"collide_stream {fused_step.LAUNCHES}")
            require(all(bool(torch.isfinite(t.float()).all())
                        for t in (state.f, state.g, state.Ex, state.Ey)),
                    f"{name} step: state not finite")
            rho_q = fused_step.collide_stream(state.f, state.g, state.Ex,
                                              state.Ey, **phys_of(cfg))[2]
            solve_ms = _device_ms(lambda: ppoisson.solve_poisson_sharded(
                cfg, rho_q, state.phi, state.Ex, state.Ey, m), steps)
            cufft_ms = _device_ms(lambda: poisson.efield_periodic(
                poisson.solve_fft(rho_q)), steps)
            print(f"2048^2 FFT f32, {name} step: {ms:.4f} ms/step, "
                  f"{n * n / (ms * 1e-3) / 1e6:.1f} MLUPS (single-device "
                  f"fused step {single_ms:.4f}); {launches[name]} launches "
                  f"in {warm + steps} steps; sharded solve + E "
                  f"{solve_ms:.4f} ms, cuFFT solve_fft + efield_periodic "
                  f"{cufft_ms:.4f} ms")
            del state, rho_q
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    return launches


# phase 11: the cavity's y-shard kernels. (label, NY, NX, dtype, storage,
# shard counts); 2048^2 is the world-of-one size of the main path, 129^2
# cut in 3 gives ragged 43-row shards
CAVITY_SHARD_GRIDS = [
    ("2048^2 f32", 2048, 2048, "float32", "native", (2, 4, 8)),
    ("2048^2 bf16", 2048, 2048, "float32", "bf16", (2, 4, 8)),
    ("512^2 f64", 512, 512, "float64", "native", (2, 4, 8)),
    ("129^2 f64", 129, 129, "float64", "native", (3,)),
]
CAVITY_WINDOW_KS = (1, 4, 17)
CAVITY_HALO = ("collide_stream_cavity_halo", "collide_stream_cavity_halo_lean",
               "collide_stream_cavity_multistep_gated")


def _cavity_seeded_on_card(cfg, device, seed):
    """As _cavity_seeded, with the perturbation drawn on the card from a
    seeded torch generator (a 2048^2 state holds 38M populations)."""
    import torch
    from lbm_tpu_torch.models import cavity

    plain = dataclasses.replace(cfg, backend="plain", lean_macros=False,
                                multistep=0)
    state = cavity.make_rollout(plain, 12)(cavity.init_state(plain, device))
    gen = torch.Generator(device=device).manual_seed(seed)

    def perturb(t, additive=0.0):
        a = t.double()
        noise = torch.randn(a.shape, generator=gen, device=device,
                            dtype=torch.float64)
        return (a * (1.0 + 1e-3 * noise) + additive * noise).to(cfg.dtype)

    f = cavity.encode_f(cfg, perturb(cavity.decode_f(cfg, state.f)))
    return state._replace(f=f.contiguous(), rho=perturb(state.rho),
                          ux=perturb(state.ux, 1e-4),
                          uy=perturb(state.uy, 1e-4))


def _cavity_halo_bound_ms(name, f, rows_ext=None, k_steps=1):
    """(least ms, "bytes" or "operations") of one launch on the shard f
    (9, NY, NX): the stored step reads and writes f and the three macros
    and reads the two strip rows (96 B/site in f32, 60 with bf16 f), the
    lean step f alone (72 / 36); the window (rows_ext rows of the extended
    block) f once, and its operations (_cavity_bound_ms)."""
    _, ny, nx = f.shape
    p = f.element_size()
    c = 8 if p == 8 else 4
    if name == "collide_stream_cavity_multistep_gated":
        return _cavity_bound_ms("lean", rows_ext * nx, p, c, k_steps)
    kind = "stored" if name == "collide_stream_cavity_halo" else "lean"
    per_site = _cavity_bytes_per_site(kind, p, c)
    strip = 2 * nx * (9 * p + (3 * c if kind == "stored" else 0))
    t_bytes = (per_site * ny * nx + strip) / HBM_BYTES_PER_S * 1e3
    rate = F64_FLOP_PER_S if c == 8 else F32_FLOP_PER_S
    t_ops = CAVITY_FLOP * ny * nx / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_cavity_halo_kernels():
    """Phase 11a: the three y-shard cavity kernels on every shard of cuts of
    seeded warm full grids, bitwise against the single-device kernels on
    the full grid and against their plain versions; times at 2048^2 (a
    world of one) and 512x2048 (a 4-card shard). Returns ({kernel: worst
    max|err| against its plain version}, {kernel: (ms, plain_ms, bound_ms,
    bound_by, at)} at 2048^2 f32)."""
    import torch
    from lbm_tpu_torch.config import CavityConfig
    from lbm_tpu_torch.kernels import fused_cavity as fc
    from lbm_tpu_torch.models import cavity

    print("== phase 11a: cavity y-shard kernels on cuts of a full grid, "
          "bitwise vs the single-device kernels and their plain versions")
    device = torch.device("cuda")
    worst = dict.fromkeys(CAVITY_HALO, 0.0)
    times = {}

    def hold(where, got, single, plain):
        """got bitwise equal to the single-device kernel's rows and to the
        plain version; returns max|got - plain|."""
        for k, (g, w, pl) in enumerate(zip(got, single, plain)):
            require(torch.equal(_bits(g), _bits(w)), f"{where} output {k}: "
                    f"not bitwise equal to the single-device kernel")
            require(torch.equal(_bits(g), _bits(pl)), f"{where} output {k}: "
                    f"not bitwise equal to the plain version")
        return max(float((g.double() - pl.double()).abs().max())
                   for g, pl in zip(got, plain))

    for label, NY, NX, dtype, storage, cuts in CAVITY_SHARD_GRIDS:
        cfg = CavityConfig(NX=NX, NY=NY, dtype=getattr(torch, dtype),
                           storage=storage, backend="fused")
        st = _cavity_seeded_on_card(cfg, device, seed=NY * 10000 + NX)
        u, tau = cavity._lid_speed(cfg, 9), cfg.tau
        macros = (st.rho, st.ux, st.uy)
        kw = dict(tau=tau, u_lid=cfg.u_lid, sigma=cfg.sigma)
        full = {"collide_stream_cavity_halo": fc.collide_stream_cavity(
                    st.f, *macros, u, tau=tau),
                "collide_stream_cavity_halo_lean": [
                    fc.collide_stream_cavity_lean(st.f, u, tau=tau)]}
        windows = {k: fc.collide_stream_cavity_multistep(st.f, 8, k_steps=k,
                                                         **kw)
                   for k in CAVITY_WINDOW_KS}
        n_holds, routes = 0, set()
        for n in cuts:
            rows = NY // n
            depth = 8 if n == 4 else 1    # JAX's 8-row strips on one cut
            for r in range(n):
                ys = slice(r * rows, (r + 1) * rows)
                where = f"{label} cut {n} shard {r}"
                for name, mac in (("collide_stream_cavity_halo", macros),
                                  ("collide_stream_cavity_halo_lean", None)):
                    args, walls = fc.halo_inputs(st.f, mac, ys, depth)
                    run = getattr(fc, name)
                    plain = getattr(fc, name + "_reference")
                    got, ref = run(*args, u, *walls, tau=tau), plain(
                        *args, u, *walls, tau=tau)
                    if mac is None:
                        got, ref = [got], [ref]
                    single = [t[..., ys, :] for t in full[name]]
                    worst[name] = max(worst[name], hold(
                        f"{where} {name}", got, single, ref))
                    n_holds += 1
                for k in CAVITY_WINDOW_KS:
                    block, wall_rows = fc.window_inputs(st.f, ys, k)
                    got = fc.collide_stream_cavity_multistep_gated(
                        block, 8, wall_rows, k_steps=k, **kw)
                    ref = fc.collide_stream_cavity_multistep_gated_reference(
                        block, 8, wall_rows, k_steps=k, **kw)
                    name = "collide_stream_cavity_multistep_gated"
                    routes.add(f"K={k} {fc.window_route(block, k)}")
                    require(torch.equal(_bits(got), _bits(ref)),
                            f"{where} window K={k}: the extended block not "
                            f"bitwise equal to the plain version")
                    require(torch.equal(_bits(got[:, k:k + rows]),
                                        _bits(windows[k][:, ys])),
                            f"{where} window K={k}: the shard not bitwise "
                            f"equal to the single-device window")
                    n_holds += 1
            torch.cuda.synchronize()
        print(f"{label:>12}: {n_holds} holds on cuts {cuts} (stored, lean, "
              f"window K={'/'.join(map(str, CAVITY_WINDOW_KS))} from step "
              f"8; gated window routes {sorted(routes)}), every shard "
              f"bitwise equal to the single-device kernels and to the plain "
              f"versions")
        if NY == 2048:
            stored_ms = _device_ms(lambda: fc.collide_stream_cavity(
                st.f, *macros, u, tau=tau), 50)
            lean_ms = _device_ms(lambda: fc.collide_stream_cavity_lean(
                st.f, u, tau=tau), 50)
            out = [f"collide_stream_cavity {stored_ms:.4f} ms, _lean "
                   f"{lean_ms:.4f} ms"]
            if storage == "native":
                window_ms = _device_ms(
                    lambda: fc.collide_stream_cavity_multistep(
                        st.f, 8, k_steps=32, **kw), 5)
                out[0] += f", _multistep K=32 {window_ms:.4f} ms"
            for ys in (slice(0, NY), slice(NY // 4, NY // 2)):
                shape = f"{ys.stop - ys.start}x{NX}"
                for name, mac in (("collide_stream_cavity_halo", macros),
                                  ("collide_stream_cavity_halo_lean", None),
                                  ("collide_stream_cavity_multistep_gated",
                                   None)):
                    if name.endswith("gated"):
                        if storage == "bf16":
                            continue
                        k = 32
                        block, wall_rows = fc.window_inputs(st.f, ys, k)
                        args = (block, 8, wall_rows)
                        call_kw = dict(k_steps=k, **kw)
                        bound, bound_by = _cavity_halo_bound_ms(
                            name, block, block.shape[1], k)
                        reps, plain_reps = 5, 1
                    else:
                        a, walls = fc.halo_inputs(st.f, mac, ys)
                        args, call_kw = (*a, u, *walls), dict(tau=tau)
                        bound, bound_by = _cavity_halo_bound_ms(name, a[0])
                        reps, plain_reps = 50, 3
                    run = getattr(fc, name)
                    plain = getattr(fc, name + "_reference")
                    ms = _device_ms(lambda: run(*args, **call_kw), reps)
                    plain_ms = _time_ms(lambda: plain(*args, **call_kw),
                                        plain_reps)
                    tag = " K=32" if name.endswith("gated") else ""
                    out.append(f"{name} {shape}{tag} {ms:.4f} ms (bound "
                               f"{bound:.4f} by {bound_by}, "
                               f"{100 * bound / ms:.1f}%; plain "
                               f"{plain_ms:.4f})")
                    if storage == "native" and ys.stop == NY:
                        times[name] = (ms, plain_ms, bound, bound_by,
                                       f"{shape}{tag} f32, a world of one")
                    del args
            print(f"{'':>12} timings: " + "; ".join(out))
        del st, macros, full, windows
        torch.cuda.empty_cache()
    return worst, times


def _one_rank_group(name="cavity"):
    """A one-rank NCCL group for phases 11 and 12 (torchrun's environment
    is not needed: the CLIs keep a group that exists)."""
    import shutil

    from lbm_tpu_torch.parallel import mesh as pmesh
    store = os.path.join(OUT, f"dist_store_{name}")
    shutil.rmtree(store, ignore_errors=True)
    os.makedirs(store)
    return pmesh.init_distributed("cuda", init_method=f"file://{store}/store",
                                  rank=0, world_size=1)


def phase_cavity_sharded_cli():
    """Phase 11b: the cavity CLI with --shard 1 on a one-rank NCCL group,
    128^2 Re 100, 2,000 steps, stored, lean and --multistep 100, each
    bitwise equal to the single-device CLI's state with one halo launch a
    step (a window launch per 100 steps); then --shard 1 --multistep 100 at
    Ghia's 129^2 for 10,000 steps within the Ghia gate. Returns the halo
    kernels' launches in the 128^2 runs (counts set to 0 just before each
    run, read just after)."""
    import torch
    import torch.distributed as dist
    from lbm_tpu_torch import run_cavity
    from lbm_tpu_torch.kernels import fused_cavity

    print("== phase 11b: the cavity CLI with --shard 1 on a one-rank NCCL "
          "group")
    _one_rank_group()
    launches = {}
    try:
        steps = 2000
        for label, flags, kernel, want in (
                ("stored", [], "collide_stream_cavity_halo", steps),
                ("lean", ["--lean"], "collide_stream_cavity_halo_lean",
                 steps),
                ("multistep 100", ["--multistep", "100"],
                 "collide_stream_cavity_multistep_gated", steps // 100)):
            base = ["--nx", "128", "--steps", str(steps), "--re", "100",
                    "--u-lid", "0.1", "--device", "cuda"] + flags
            tag = label.replace(" ", "_")
            single = run_cavity.main(base + ["--out", os.path.join(
                OUT, "cavity128_" + tag)] + NO_CAVITY_VIDEO)
            _reset_cavity_launches()
            s = run_cavity.main(base + ["--shard", "1", "--out", os.path.join(
                OUT, "cavity128_shard_" + tag)] + NO_CAVITY_VIDEO)
            counts = dict(fused_cavity.LAUNCHES)
            require(counts == {k: want if k == kernel else 0 for k in counts},
                    f"--shard 1 {label}: launches {counts}, want {want} of "
                    f"{kernel}")
            require(s["launches"] == counts and s["n_devices"] == 1,
                    f"--shard 1 {label}: the CLI counted {s['launches']} on "
                    f"{s['n_devices']} ranks")
            require(s["finite"], f"--shard 1 {label}: state not finite")
            for k in ("f", "rho", "ux", "uy"):
                require(torch.equal(_bits(getattr(s["state"], k)),
                                    _bits(getattr(single["state"], k))),
                        f"--shard 1 {label}: {k} not bitwise equal to the "
                        f"single-device CLI's")
            launches[kernel] = counts[kernel]
            print(f"128^2 {label:>13}, {steps} steps: bitwise equal to the "
                  f"single-device CLI; {counts[kernel]} launches of {kernel}; "
                  f"{s['wall_ms']:.1f} ms ({s['mlups']:.1f} MLUPS), single-"
                  f"device {single['wall_ms']:.1f} ms")
        _reset_cavity_launches()
        s = run_cavity.main(["--nx", "129", "--steps", "10000", "--re",
                             "100", "--u-lid", "0.1", "--device", "cuda",
                             "--shard", "1", "--multistep", "100", "--out",
                             os.path.join(OUT, "cavity_ghia_shard")]
                            + NO_CAVITY_VIDEO)
        g = s["ghia"]
        for key, gate in GHIA_GATE.items():
            require(g[key] < gate, f"--shard 1 --multistep 100 Ghia: {key} "
                    f"{g[key]:.4f} >= {gate}")
        n = fused_cavity.LAUNCHES["collide_stream_cavity_multistep_gated"]
        require(n == 100 and s["finite"], f"Ghia --shard 1: {n} window "
                f"launches, finite {s['finite']}")
        print(f"129^2 Ghia, --shard 1 --multistep 100, 10,000 steps: u max "
              f"{g['u_max']:.4f} rms {g['u_rms']:.4f}, v max {g['v_max']:.4f}"
              f" rms {g['v_rms']:.4f}; mass drift {s['mass_drift']:.3e}; "
              f"{n} launches; {s['wall_ms']:.1f} ms ({s['mlups']:.1f} MLUPS)")
    finally:
        dist.destroy_process_group()
    return launches


def phase_cavity_sharded_real_size():
    """Phase 11c: 2048^2 f32 stored, lean and multistep K = 32 sharded over
    a world of one, beside the single-device rollouts in the same call:
    ms/step and MLUPS (CUDA events over a window after warm-up); the state
    stays finite."""
    import torch
    import torch.distributed as dist
    from lbm_tpu_torch.config import CavityConfig
    from lbm_tpu_torch.models import cavity
    from lbm_tpu_torch.parallel import fused_sharded, sharding
    from lbm_tpu_torch.parallel import mesh as pmesh

    print("== phase 11c: 2048^2 f32 cavity sharded over a world of one "
          "(CUDA events)")
    device = _one_rank_group()
    try:
        m = pmesh.make_mesh((1, 1), "cuda")
        n = 2048
        for label, lean, K, warm, steps in (
                ("stored", False, 0, 20, 200), ("lean", True, 0, 20, 200),
                ("multistep 32", False, 32, 32, 512)):
            cfg = CavityConfig(NX=n, NY=n, dtype=torch.float32,
                               backend="fused", lean_macros=lean,
                               multistep=K)
            if K:
                make = fused_sharded.make_fused_sharded_cavity_multistep_rollout
            else:
                make = fused_sharded.make_fused_sharded_cavity_rollout
            line, ends = [], []
            for side, roll_of in (
                    ("single-device", lambda k: cavity.make_rollout(cfg, k)),
                    ("sharded", lambda k: make(cfg, m, k))):
                state = cavity.init_state(cfg, device)
                if side == "sharded":
                    state = sharding.shard_cavity_state(state, m)
                state = roll_of(warm)(state)
                torch.cuda.synchronize()
                t0 = torch.cuda.Event(enable_timing=True)
                t1 = torch.cuda.Event(enable_timing=True)
                t0.record()
                state = roll_of(steps)(state)
                t1.record()
                torch.cuda.synchronize()
                ms = t0.elapsed_time(t1) / steps
                require(all(bool(torch.isfinite(t.float()).all())
                            for t in (state.f, state.rho, state.ux,
                                      state.uy)),
                        f"2048^2 {label} {side}: state not finite")
                line.append(f"{side} {ms:.4f} ms/step "
                            f"({n * n / (ms * 1e-3) / 1e6:.1f} MLUPS)")
                ends.append(sharding.gather_cavity_state(state, m)
                            if side == "sharded" else state)
            for k in ("f", "rho", "ux", "uy"):
                require(torch.equal(_bits(getattr(ends[0], k)),
                                    _bits(getattr(ends[1], k))),
                        f"2048^2 {label}: the sharded end state's {k} not "
                        f"bitwise equal to the single-device one's")
            print(f"2048^2 f32 {label:>12} ({warm} + {steps} steps): "
                  + "; ".join(line) + "; end states bitwise equal")
            del ends, state
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()


# phase 12: the 3-D halo kernel's cuts of full grids, (dz, dy); None keeps
# the axis whole (z-shards: collide_stream_halo3d; y-shards:
# collide_stream_panel3d with halo_rows; tiles: _panel3d_zhalo)
HALO3D_CUTS = [(2, None), (4, None), (8, None), (None, 2), (None, 4),
               (2, 2), (1, 2), (2, 1), (4, 2)]
# (label, NX, NY, NZ, mode of COLLIDE_MODES, cuts)
HALO3D_GRIDS = [
    ("64^3", 64, 64, 64, "f64", HALO3D_CUTS),
    ("64^3", 64, 64, 64, "f32", HALO3D_CUTS),
    ("64^3", 64, 64, 64, "bf16+delta", HALO3D_CUTS),
    ("24x40x48", 24, 40, 48, "f32+delta",
     [(2, None), (3, None), (None, 5), (3, 5), (1, 5), (2, 1)]),
]
HALO3D_NAMES = ("collide_stream_halo3d", "collide_stream_panel3d",
                "collide_stream_panel3d_zhalo")
# phase 12b's column: the 3-D CLI's default 64^3, which its CLI runs use
SHARDED3D_N = 64


def _halo3d_name(zs, ys):
    return HALO3D_NAMES[0 if ys is None else 1 if zs is None else 2]


def _cuts3d(NZ, NY, dz, dy):
    """(slices, rows) of every shard of a (dz, dy) cut; None: whole."""
    zs = ([None] if dz is None else
          [slice(b * NZ // dz, (b + 1) * NZ // dz) for b in range(dz)])
    ys = ([None] if dy is None else
          [slice(b * NY // dy, (b + 1) * NY // dy) for b in range(dy)])
    return [(z, y) for z in zs for y in ys]


def _halo3d_bound_ms(strips):
    """(least ms, "bytes" or "operations") of one 3-D halo launch: the
    shard's f and g read and written, E read, rho_q written (928 / 472 B a
    site), each strip site read once (f, g, E), against FLOP_PER_SITE_3D
    for every site of the extended block."""
    shard, zhalo, yrows, corners = strips
    f, Ex = shard[0], shard[2]
    p, e = f.element_size(), Ex.element_size()
    NZ, NY, NX = Ex.shape
    edge = sum(grp[2].numel() for grp in (*(zhalo or ()), *(yrows or ()),
                                          *(corners or ())))
    nbytes = NZ * NY * NX * (228 * p + 4 * e) + edge * (114 * p + 3 * e)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    ext = ((NZ + 2 * (zhalo is not None)) * (NY + 2 * (yrows is not None))
           * NX)
    rate = F64_FLOP_PER_S if e == 8 else F32_FLOP_PER_S
    t_ops = FLOP_PER_SITE_3D * ext / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_halo3d_kernel():
    """Phase 12a: the 3-D halo kernel on every shard of every cut of seeded
    warm full grids, bitwise against collide_stream3d on the full grid at
    the shard's sites and against its plain version. Returns the worst
    max|err| against the plain version in f64, by kernel name (0 when
    bitwise)."""
    import torch
    from lbm_tpu_torch.config import PlasmaConfig
    from lbm_tpu_torch.kernels import fused_panel3d, fused_step3d

    print("== phase 12a: the 3-D halo kernel on cuts of full grids, bitwise "
          "vs collide_stream3d and vs its plain versions")
    device = torch.device("cuda")
    modes = {m[0]: m for m in COLLIDE_MODES}
    worst = dict.fromkeys(HALO3D_NAMES, 0.0)
    for label, NX, NY, NZ, mode, cuts in HALO3D_GRIDS:
        _, dtype, storage, delta = modes[mode][:4]
        cfg = PlasmaConfig(NX=NX, NY=NY, NZ=NZ, dtype=getattr(torch, dtype),
                           storage=storage, neutral_delta=delta)
        phys = phys_of(cfg)
        st = _seeded_state3d(cfg, device, NZ * 10000 + NY * 100 + NX, 1)
        arrays = (st.f, st.g, st.Ex, st.Ey, st.Ez)
        full = fused_step3d.collide_stream3d(*arrays, **phys)
        held = 0
        for dz, dy in cuts:
            for zs, ys in _cuts3d(NZ, NY, dz, dy):
                strips = fused_step3d.halo_inputs3d(arrays, zs, ys)
                k_out = fused_panel3d.collide_stream_shard3d(*strips, **phys)
                p_out = fused_step3d.halo3d_reference(*strips, **phys)
                torch.cuda.synchronize()
                at = (zs or slice(None), ys or slice(None), slice(None))
                name = _halo3d_name(zs, ys)
                for out, kg, pg, fg in zip(("f", "g", "rho_q"), k_out, p_out,
                                           full):
                    where = (f"{label} {mode} cut {dz}x{dy} shard "
                             f"({zs}, {ys}) {out}")
                    require(torch.equal(kg, fg[(..., *at)]),
                            f"{where}: not bitwise equal to collide_stream3d "
                            f"on the full grid")
                    mx = float((kg.double() - pg.double()).abs().max())
                    if dtype == "float64":
                        worst[name] = max(worst[name], mx)
                    require(torch.equal(kg, pg), f"{where}: not bitwise "
                            f"equal to its plain version (max|err| {mx:.3e})")
                held += 1
        print(f"{label:>9} {mode:>10}: {held} shards of {len(cuts)} cuts, "
              f"each bitwise equal to collide_stream3d on the full grid and "
              f"to its plain version")
        del st, arrays, full
        torch.cuda.empty_cache()
    return worst


def phase_sharded3d_world_of_one():
    """Phase 12b: the z-, y- and (1, 1) yz-sharded 3-D steps and the K-slice
    windows on a one-rank NCCL group, against the single-device fused step
    and rollout: bitwise under NONE, within 1e-11 of scale under FFT in
    f64, each step from the single-device trajectory's state; then the CLI
    under torchrun with --shard 1 --multistep 8 --poisson NONE against the
    single-device CLI's slices. Returns each halo kernel's
    launches in the 64^3 f32+delta NONE runs (counts set to 0 just before
    each run, read just after)."""
    import torch
    import torch.distributed as dist
    from lbm_tpu_torch import run_plasma3d
    from lbm_tpu_torch.config import PlasmaConfig, PoissonSolver
    from lbm_tpu_torch.kernels import fused_step3d
    from lbm_tpu_torch.models import plasma3d
    from lbm_tpu_torch.parallel import fused_sharded, sharding
    from lbm_tpu_torch.parallel import mesh as pmesh

    print("== phase 12b: the sharded 3-D steps and windows on a one-rank "
          "NCCL group, (1, 1) mesh")
    device = _one_rank_group("plasma3d")
    N = SHARDED3D_N
    fields = ("f", "g", "Ex", "Ey", "Ez", "phi")
    launches = {}
    try:
        m = pmesh.make_mesh3d((1, 1), "cuda")
        steps3d = (("collide_stream_halo3d",
                    fused_sharded.make_fused_sharded_step3d),
                   ("collide_stream_panel3d",
                    fused_sharded.make_fused_sharded_step3d_y),
                   ("collide_stream_panel3d_zhalo",
                    fused_sharded.make_fused_sharded_step3d_yz))
        modes = {mode[0]: mode for mode in COLLIDE_MODES}
        for mode, poisson, steps in (("f32+delta", "NONE", 20),
                                     ("bf16+delta", "NONE", 20),
                                     ("f64", "FFT", 10)):
            _, dtype, storage, delta = modes[mode][:4]
            cfg = PlasmaConfig(NX=N, NY=N, NZ=N,
                               dtype=getattr(torch, dtype), storage=storage,
                               neutral_delta=delta,
                               poisson=PoissonSolver[poisson],
                               backend="fused")
            st0 = _seeded_state3d(cfg, device, 646464, 1)
            trajectory = [st0]
            step = plasma3d.make_step(cfg)
            for _ in range(steps):
                trajectory.append(step(trajectory[-1]))
            line = []
            for name, make in steps3d:
                step = make(cfg, m)
                _reset_launches()
                if poisson == "NONE":
                    state = sharding.shard_state3d(st0, m)
                    for _ in range(steps):
                        state = step(state)
                    pairs = [(state, trajectory[-1])]
                else:
                    # each step from the single-device trajectory's state:
                    # the sharded solve rounds otherwise than rfftn, ~1e-15
                    # of E's scale, which the physics grows along a
                    # trajectory (to 5e-11 of g's scale in 10 steps here)
                    pairs = [(step(sharding.shard_state3d(a, m)), b)
                             for a, b in zip(trajectory, trajectory[1:])]
                torch.cuda.synchronize()
                counts = dict(fused_step3d.HALO_LAUNCHES)
                require(counts == {k: steps if k == name else 0
                                   for k in counts}
                        and fused_step3d.LAUNCHES == 0,
                        f"{name} step: launches {counts}, collide_stream3d "
                        f"{fused_step3d.LAUNCHES}")
                if mode == "f32+delta":
                    launches[name] = counts[name]
                worst = dict.fromkeys(fields, 0.0)
                for got, want in pairs:
                    for k in fields:
                        a, b = getattr(got, k), getattr(want, k)
                        if poisson == "NONE":
                            require(torch.equal(a, b), f"{N}^3 {mode} NONE "
                                    f"{name} step: {k} not bitwise equal to "
                                    f"the single-device fused step")
                            continue
                        _, ratio, _ = _errors(a, b, 0, 1e-11)
                        require(ratio <= 1.0, f"{N}^3 f64 FFT {name} step "
                                f"{a.shape}: {k} at {ratio:.3f} x 1e-11 of "
                                f"scale")
                        worst[k] = max(worst[k], ratio)
                line.append(f"{name}: " + ", ".join(
                    f"{k} {r:.1e}" for k, r in worst.items()))
                del pairs
            print(f"{N}^3 {mode} {poisson}, {steps} steps: z, y and yz steps "
                  + ("bitwise equal to the single-device fused step"
                     if poisson == "NONE" else
                     "each from the single-device state, within 1e-11 of "
                     "scale of the single-device step (worst share of the "
                     "gate) " + "; ".join(line)))
            del st0, trajectory
        for kill in (True, False):
            cfg = PlasmaConfig(NX=N, NY=N, NZ=N, dtype=torch.float32,
                               neutral_delta=True,
                               poisson=PoissonSolver.NONE, backend="fused",
                               multistep=8)
            cfg = dataclasses.replace(cfg, compat=dataclasses.replace(
                cfg.compat, none_solver_kills_external_field=kill))
            st0 = _seeded_state3d(dataclasses.replace(cfg, multistep=0),
                                  device, 6408, 1)
            _reset_launches()
            got = fused_sharded.make_fused_sharded_multistep_rollout_3d(
                cfg, m, 20)(sharding.shard_state3d(st0, m))
            n_win = fused_step3d.LAUNCHES
            want = plasma3d.make_rollout(dataclasses.replace(
                cfg, multistep=0), 20)(st0)
            torch.cuda.synchronize()
            for k in fields:
                require(torch.equal(getattr(got, k), getattr(want, k)),
                        f"{N}^3 window K=8 kill={kill}: {k} not bitwise "
                        f"equal to the single-device rollout")
            require(n_win == 20 and got.step == want.step == st0.step + 20,
                    f"window K=8: {n_win} launches, step {got.step}")
            print(f"{N}^3 f32+delta NONE kill={kill}, 20 steps in K = 8 "
                  f"windows (8 + 8 + 4): bitwise equal to the single-device "
                  f"rollout; {n_win} launches of collide_stream3d")
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    # the CLI under torchrun, one rank, against the single-device CLI
    # the CLIs' default grid, N^3: under torchrun's own argument parser
    # "--n" is an ambiguous prefix of its options
    grid = ["--poisson", "NONE"]
    single_out = os.path.join(OUT, "plasma3d_none")
    run_plasma3d.main([*grid, "--out", single_out])
    shard_out = os.path.join(OUT, "plasma3d_shard1_ms8")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "1",
           os.path.join(HERE, "scripts", "run_plasma3d_torch.py"),
           *grid, "--shard", "1", "--multistep", "8", "--out", shard_out]
    r = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True,
                       timeout=300, env=dict(os.environ, PYTHONPATH=HERE))
    require(r.returncode == 0, f"torchrun CLI failed:\n{r.stderr[-3000:]}")
    found = re.search(r"kernel launches (.*)$", r.stdout, re.M)
    counts = dict((k, int(v)) for k, v in (
        kv.rsplit(" ", 1) for kv in found.group(1).split(", "))) if found \
        else {}
    require(counts == {"collide_stream3d": 50, **dict.fromkeys(
        HALO3D_NAMES, 0)}, f"torchrun CLI launches {counts}")
    require("sharded 3-D multistep (K=8-slab ghosts) over 1-device dz mesh"
            in r.stdout, f"torchrun CLI printed:\n{r.stdout[-2000:]}")
    for t in (40, 50):
        a = np.load(os.path.join(shard_out, f"slice_{t:05d}.npz"))
        b = np.load(os.path.join(single_out, f"slice_{t:05d}.npz"))
        for k in ("rho_e", "rho_q"):
            require(np.array_equal(a[k], b[k]), f"torchrun CLI slice {t} "
                    f"{k}: not bitwise equal to the single-device CLI's")
    print(f"torchrun --nproc-per-node 1 ... --shard 1 --multistep 8 "
          f"--poisson NONE ({N}^3, 50 steps): 50 launches of "
          f"collide_stream3d in 7 windows; slices 40 and 50 bitwise equal to "
          f"the single-device CLI's")
    return launches


# phase 12c's column: 256^3 (PERF.md's 3-D cells), and the shards it
# times, (label, slices, rows, 4 cards) (None: the axis whole): those of a
# world of one, and of 4 cards
TIMED3D_N = 256
HALO3D_TIMED = [
    ("N^3 z", (0, 1), None, False),
    ("N^3 y", None, (0, 1), False),
    ("N^3 tile", (0, 1), (0, 1), False),
    ("N/4xNxN z", (0, 4), None, True),
    ("NxN/4xN y", None, (0, 4), True),
    ("N/2xN/2xN tile", (0, 2), (0, 2), True),
]


def phase_sharded3d_real_size():
    """Phase 12c: the 3-D halo kernel at the shard shapes of 1 and 4 cards
    in bf16 + delta and f32 beside collide_stream3d and its bound; the
    256^3 bf16 + delta FFT sharded steps over a world of one beside the
    single-device step; the K = 8 window. Returns {kernel: (ms, plain_ms,
    bound_ms, bound_by, at)} at the 4-card shapes in f32."""
    import torch
    import torch.distributed as dist
    from lbm_tpu_torch.config import PlasmaConfig, PoissonSolver
    from lbm_tpu_torch.kernels import fused_panel3d, fused_step3d
    from lbm_tpu_torch.models import plasma3d
    from lbm_tpu_torch.parallel import fused_sharded, poisson, sharding
    from lbm_tpu_torch.parallel import mesh as pmesh

    N = TIMED3D_N
    print(f"== phase 12c: the 3-D halo kernel and the sharded 3-D steps at "
          f"{N}^3 (CUDA events)")
    device = torch.device("cuda")
    times = {}
    for mode in ("bf16+delta", "f32"):
        storage = "bf16" if mode.startswith("bf16") else "native"
        cfg = PlasmaConfig(NX=N, NY=N, NZ=N, dtype=torch.float32,
                           storage=storage, neutral_delta=storage == "bf16",
                           backend="fused")
        phys = phys_of(cfg)
        st = plasma3d.init_state(cfg, device)
        st = plasma3d.make_step(cfg)(st)
        arrays = (st.f, st.g, st.Ex, st.Ey, st.Ez)
        full_ms = _device_ms(lambda: fused_step3d.collide_stream3d(
            *arrays, **phys), 5)
        bound, _ = _bound3d_ms(st.f, st.Ex)
        out = [f"collide_stream3d {N}^3 {full_ms:.4f} ms (bound "
               f"{bound:.4f})"]
        for label, zs, ys, four in HALO3D_TIMED:
            zs, ys = (None if c is None else slice(c[0], N // c[1])
                      for c in (zs, ys))
            label = label.replace("N/4", str(N // 4)).replace(
                "N/2", str(N // 2)).replace("N", str(N))
            strips = fused_step3d.halo_inputs3d(arrays, zs, ys)
            ms = _device_ms(lambda: fused_panel3d.collide_stream_shard3d(
                *strips, **phys), 5)
            bound, bound_by = _halo3d_bound_ms(strips)
            item = (f"{label} {ms:.4f} ms (bound {bound:.4f} by {bound_by}, "
                    f"{100 * bound / ms:.1f}%)")
            if mode == "f32" and four:
                plain_ms = _time_ms(lambda: fused_step3d.halo3d_reference(
                    *strips, **phys), 1)
                item += f", plain {plain_ms:.4f} ms"
                times[_halo3d_name(zs, ys)] = (
                    ms, plain_ms, bound, bound_by,
                    f"{label.split()[0]} f32, a shard of {N}^3 on 4 cards")
            out.append(item)
            del strips
            torch.cuda.empty_cache()
        print(f"{mode}: " + "; ".join(out))
        del st, arrays
        torch.cuda.empty_cache()
    device = _one_rank_group("plasma3d_12c")
    try:
        m = pmesh.make_mesh3d((1, 1), "cuda")
        cfg = PlasmaConfig(NX=N, NY=N, NZ=N, dtype=torch.float32,
                           storage="bf16", neutral_delta=True,
                           backend="fused")
        n = N ** 3
        line = []
        for label, make in (
                ("single-device", plasma3d.make_step),
                ("z", lambda c: fused_sharded.make_fused_sharded_step3d(c, m)),
                ("y", lambda c: fused_sharded.make_fused_sharded_step3d_y(
                    c, m)),
                ("yz", lambda c: fused_sharded.make_fused_sharded_step3d_yz(
                    c, m))):
            state, ms = _window(make(cfg), plasma3d.init_state(cfg, device),
                                2, 6)
            require(all(bool(torch.isfinite(t.float()).all())
                        for t in (state.f, state.g, state.Ex, state.Ey,
                                  state.Ez)),
                    f"{N}^3 FFT {label}: state not finite")
            line.append(f"{label} {ms:.4f} ms/step "
                        f"({n / (ms * 1e-3) / 1e6:.1f} MLUPS)")
            if label == "z":
                rho_q = fused_step3d.collide_stream3d(
                    state.f, state.g, state.Ex, state.Ey, state.Ez,
                    **phys_of(cfg))[2]
                solve_ms = _device_ms(
                    lambda: poisson.efield_periodic3d_sharded(
                        poisson.solve_fft3d_z(rho_q, m), m), 5)
                cufft_ms = _device_ms(lambda: plasma3d.efield_periodic3d(
                    plasma3d.solve_fft3d(rho_q)), 5)
                line.append(f"(z solve + E {solve_ms:.4f} ms, rfftn solve + E "
                            f"{cufft_ms:.4f} ms)")
                del rho_q
            del state
            torch.cuda.empty_cache()
        print(f"{N}^3 bf16+delta FFT, 2 warm-up + 6 timed steps: "
              + "; ".join(line))
        cfg = dataclasses.replace(cfg, poisson=PoissonSolver.NONE,
                                  multistep=8)
        state = sharding.shard_state3d(plasma3d.init_state(cfg, device), m)
        roll = fused_sharded.make_fused_sharded_multistep_rollout_3d(
            cfg, m, 8)
        state, win_ms = _window(roll, state, 1, 2)
        require(bool(torch.isfinite(state.f.float()).all()),
                f"{N}^3 window: state not finite")
        del state
        torch.cuda.empty_cache()
        _, single_ms = _window(plasma3d.make_step(dataclasses.replace(
            cfg, multistep=0)), plasma3d.init_state(cfg, device), 2, 6)
        print(f"{N}^3 bf16+delta NONE, K = 8 window over a world of one "
              f"({N + 16} slices a launch): {win_ms / 8:.4f} ms/step "
              f"({n / (win_ms / 8 * 1e-3) / 1e6:.1f} MLUPS); single-device "
              f"NONE step {single_ms:.4f} ms")
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    return times



# phase 13: the gated window. 13a's band: rows [0, GATED_ROWS) of a seeded
# warm GATED_NY x GATED_NX bounce-back state, extended by K rows a side,
# under each wall setting ((b, t): the rows of the band's bottom and top
# walls, -1: none)
GATED_NY, GATED_NX, GATED_ROWS = 74, 53, 37
# the full grids cut into y-shards: (label, n, mode of COLLIDE_MODES,
# solvers, cuts); K = GATED_CUT_K
GATED_CUTS = [("512^2", 512, "f64", ("NONE", "FFT"), (2, 4, 8)),
              ("2048^2", 2048, "bf16+delta", ("NONE",), (2, 4, 8))]
GATED_CUT_K = 8
# 13b's grid, whose y-shard and tile windows run 20 steps with K = 8
GATED_SHARDED_N = 512
# 13c: the cell (2048^2 NONE bf16 + delta, K = 32) and the bands of 1 and 4
# cards
GATED_TIMED_N, GATED_TIMED_K = 2048, 32


def _gated_kw(cfg):
    """collide_stream_multistep_gated's keywords for a bounce-back cfg:
    the physics, and the kill quirk under NONE (FFT + bounce-back is the
    no-op solve: E kept)."""
    from lbm_tpu_torch.models import plasma
    kw = plasma.multistep_kwargs(cfg)
    return {k: v for k, v in kw.items()
            if k not in ("bounce", "solve_fft", "solve_iter")}


def _gated_walls(K, R):
    return [(K, K + R - 1), (K, -1), (-1, K + R - 1), (-1, -1)]


def phase_gated_kernel():
    """Phase 13a: the gated window kernel bitwise against its plain version
    on a band under each wall setting, and on every y-shard of cuts of full
    grids (extended by K ghost rows as the ring exchange delivers them)
    bitwise against the whole-grid bounce-back window at the shard's rows,
    and at walls (0, NY-1) against it on the whole grid. Returns the worst
    max|err| against the plain version in f64 (0 when bitwise)."""
    import torch
    from lbm_tpu_torch.config import BC, CompatFlags, PlasmaConfig
    from lbm_tpu_torch.config import PoissonSolver as P
    from lbm_tpu_torch.kernels import fused_multistep as fm

    print("== phase 13a: the gated window kernel vs its plain version and "
          "vs the whole-grid window on cuts of full grids")
    device = torch.device("cuda")
    modes = [("NONE kill", dict(poisson=P.NONE)),
             ("NONE keep", dict(poisson=P.NONE, compat=CompatFlags(
                 none_solver_kills_external_field=False))),
             ("FFT", dict(poisson=P.FFT))]
    worst = 0.0
    for dmode in MULTISTEP_DTYPES:
        label, dtype, storage, delta = dmode[:4]
        held = 0
        for mlabel, fields in modes:
            cfg = PlasmaConfig(NX=GATED_NX, NY=GATED_NY,
                               dtype=getattr(torch, dtype), storage=storage,
                               neutral_delta=delta, bc=BC.BOUNCE_BACK,
                               **fields)
            kw = _gated_kw(cfg)
            st = _seeded_state(cfg, device, seed=7453)
            for k in (1, 4, 17):
                band, _ = fm.window_inputs((st.f, st.g, st.Ex, st.Ey),
                                           slice(0, GATED_ROWS), k)
                for walls in _gated_walls(k, GATED_ROWS):
                    k_out = fm.collide_stream_multistep_gated(
                        *band, walls, k_steps=k, **kw)
                    p_out = fm.collide_stream_multistep_gated_reference(
                        *band, walls, k_steps=k, **kw)
                    torch.cuda.synchronize()
                    for name, kg, pg in zip(("f", "g"), k_out, p_out):
                        require(bool(torch.isfinite(kg.float()).all()),
                                f"{label} {mlabel} K={k} walls {walls} "
                                f"{name}: not finite")
                        mx = float((kg.double() - pg.double()).abs().max())
                        if label == "f64":
                            worst = max(worst, mx)
                        require(torch.equal(_bits(kg), _bits(pg)),
                                f"{label} {mlabel} K={k} walls {walls} "
                                f"{name}: not bitwise equal to the plain "
                                f"version (max|err| {mx:.3e})")
                    held += 1
        print(f"{label:>10}: {held} windows (NONE kill / keep, FFT; K = 1, "
              f"4, 17; walls (K, K+R-1), (K, -1), (-1, K+R-1), (-1, -1) on "
              f"a {GATED_ROWS}-row band of {GATED_NX} columns), each bitwise "
              f"equal to the plain version")
    modes_by = {m[0]: m for m in COLLIDE_MODES}
    K = GATED_CUT_K
    for glabel, n, mode, solvers, cuts in GATED_CUTS:
        _, dtype, storage, delta = modes_by[mode][:4]
        for solver in solvers:
            cfg = PlasmaConfig(NX=n, NY=n, dtype=getattr(torch, dtype),
                               storage=storage, neutral_delta=delta,
                               bc=BC.BOUNCE_BACK, poisson=P[solver])
            kw = _gated_kw(cfg)
            st = _seeded_state(cfg, device, seed=n + 13, warm_steps=1)
            arrays = (st.f, st.g, st.Ex, st.Ey)
            whole = fm.collide_stream_multistep(*arrays, k_steps=K,
                                                bounce=True, **kw)
            pin = fm.collide_stream_multistep_gated(*arrays, (0, n - 1),
                                                    k_steps=K, **kw)
            torch.cuda.synchronize()
            for name, a, b in zip(("f", "g"), pin, whole):
                require(torch.equal(_bits(a), _bits(b)),
                        f"{glabel} {mode} {solver} walls (0, {n - 1}) "
                        f"{name}: not bitwise the whole-grid window")
            shards = 0
            for cut in cuts:
                R = n // cut
                for r in range(cut):
                    rows = slice(r * R, (r + 1) * R)
                    band, walls = fm.window_inputs(arrays, rows, K)
                    out = fm.collide_stream_multistep_gated(
                        *band, walls, k_steps=K, **kw)
                    torch.cuda.synchronize()
                    for name, a, b in zip(("f", "g"), out, whole):
                        require(torch.equal(_bits(a[..., K:-K, :]),
                                            _bits(b[..., rows, :])),
                                f"{glabel} {mode} {solver} cut {cut} shard "
                                f"{r} walls {walls} {name}: not bitwise the "
                                f"whole-grid window at its rows")
                    shards += 1
            print(f"{glabel} {mode} {solver} K={K}: walls (0, NY-1) and "
                  f"{shards} shards of {len(cuts)} cuts, each bitwise equal "
                  f"to the whole-grid bounce-back window")
            del st, arrays, whole, pin
            torch.cuda.empty_cache()
    return worst


def phase_gated_sharded():
    """Phase 13b: the sharded windows on a one-rank NCCL group and (1, 1)
    mesh, 20 steps with K = 8, bitwise against the single-device window
    rollout (y-shards under each solver and wall, the 2-D rollout), the
    tile protocol held in one process on (2, 2) and (2, 4) cuts, then the
    windowed CLI under torchrun against the single-device CLI. Returns the
    gated kernel's launches in the CLI run."""
    import torch
    import torch.distributed as dist
    from lbm_tpu_torch import run_plasma
    from lbm_tpu_torch.config import BC, PlasmaConfig
    from lbm_tpu_torch.config import PoissonSolver as P
    from lbm_tpu_torch.kernels import fused_multistep as fm
    from lbm_tpu_torch.models import plasma
    from lbm_tpu_torch.parallel import fused_sharded, sharding
    from lbm_tpu_torch.parallel import mesh as pmesh

    print("== phase 13b: the sharded windows on a one-rank NCCL group, "
          "(1, 1) mesh; the tile protocol; the torchrun CLI")
    device = _one_rank_group("windows")
    n, K, steps = GATED_SHARDED_N, 8, 20
    fields = ("f", "g", "Ex", "Ey", "phi")
    try:
        m = pmesh.make_mesh((1, 1), "cuda")
        for label, make, solver, bc in (
                ("y-shards NONE periodic",
                 fused_sharded.make_fused_sharded_multistep_rollout, P.NONE,
                 BC.PERIODIC),
                ("y-shards NONE bounce-back",
                 fused_sharded.make_fused_sharded_multistep_rollout, P.NONE,
                 BC.BOUNCE_BACK),
                ("y-shards FFT bounce-back",
                 fused_sharded.make_fused_sharded_multistep_rollout, P.FFT,
                 BC.BOUNCE_BACK),
                ("tiles NONE periodic",
                 fused_sharded.make_fused_sharded_multistep_rollout_2d,
                 P.NONE, BC.PERIODIC)):
            cfg = PlasmaConfig(NX=n, NY=n, dtype=torch.float32,
                               neutral_delta=True, poisson=solver, bc=bc,
                               backend="fused", multistep=K)
            st0 = _seeded_state(dataclasses.replace(cfg, multistep=0),
                                device, seed=5120, warm_steps=1)
            want = plasma.make_rollout(cfg, steps)(st0)
            _reset_launches()
            got = make(cfg, m, steps)(sharding.shard_state(st0, m))
            torch.cuda.synchronize()
            counts = (fm.LAUNCHES, fm.GATED_LAUNCHES)
            for k in fields:
                require(torch.equal(getattr(got, k), getattr(want, k)),
                        f"{n}^2 {label}: {k} not bitwise equal to the "
                        f"single-device window rollout")
            gated = bc == BC.BOUNCE_BACK
            require(counts == ((0, 3) if gated else (3, 0))
                    and got.step == want.step == st0.step + steps,
                    f"{label}: launches (window, gated) {counts}, step "
                    f"{got.step}")
            print(f"{n}^2 f32+delta {label}, {steps} steps in K = {K} "
                  f"windows (8 + 8 + 4): bitwise equal to the single-device "
                  f"window rollout; 3 launches of "
                  f"{'the gated window' if gated else 'the window kernel'}")
            del st0, want, got
        # the tile protocol: each tile extended by K-deep slabs of the
        # grid around it (the two-hop corners included), one window
        cfg = PlasmaConfig(NX=n, NY=n, dtype=torch.float32,
                           neutral_delta=True, poisson=P.NONE,
                           backend="fused", multistep=K)
        st = _seeded_state(dataclasses.replace(cfg, multistep=0), device,
                           seed=5121, warm_steps=1)
        arrays = (st.f, st.g, st.Ex, st.Ey)
        kw = plasma.multistep_kwargs(cfg)
        whole = fm.collide_stream_multistep(*arrays, k_steps=K, **kw)
        tiles = 0
        for ndy, ndx in ((2, 2), (2, 4)):
            R, C = n // ndy, n // ndx
            for by in range(ndy):
                for bx in range(ndx):
                    rows = slice(by * R, (by + 1) * R)
                    cols = slice(bx * C, (bx + 1) * C)
                    ext, _ = fm.window_inputs(arrays, rows, K, cols)
                    out = fm.collide_stream_multistep(*ext, k_steps=K, **kw)
                    torch.cuda.synchronize()
                    for name, a, b in zip(("f", "g"), out, whole):
                        require(torch.equal(a[..., K:-K, K:-K],
                                            b[..., rows, cols]),
                                f"tile ({by}, {bx}) of {ndy}x{ndx} {name}: "
                                f"not bitwise the whole-grid window")
                    tiles += 1
        print(f"{n}^2 f32+delta NONE, K = {K}: {tiles} tiles of (2, 2) and "
              f"(2, 4) cuts, each extended by {K}-deep slabs and corners, "
              f"bitwise equal to the whole-grid window")
        del st, arrays, whole
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    # the CLI under torchrun, one rank, against the single-device CLI
    # (the golden 200^2, 200 steps)
    flags = ["--poisson", "NONE", "--bc", "bounceback", "--multistep", "8"]
    single_out = os.path.join(OUT, "plasma_bb_ms8")
    run_plasma.main([*flags, "--out", single_out] + NO_VIDEO)
    shard_out = os.path.join(OUT, "plasma_bb_shard1_ms8")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "1",
           os.path.join(HERE, "scripts", "run_plasma_torch.py"),
           *NO_VIDEO, *flags, "--shard", "1", "--out", shard_out]
    r = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True,
                       timeout=300, env=dict(os.environ, PYTHONPATH=HERE))
    require(r.returncode == 0, f"torchrun CLI failed:\n{r.stderr[-3000:]}")
    found = re.search(r"kernel launches (.*?)(;|$)", r.stdout, re.M)
    counts = dict((k, int(v)) for k, v in (
        kv.rsplit(" ", 1) for kv in found.group(1).split(", "))) if found \
        else {}
    want = dict.fromkeys(run_plasma.launch_counts(), 0)
    want["collide_stream_multistep_gated"] = 25
    require(counts == want, f"torchrun CLI launches {counts}")
    require("sharded multistep over mesh {'dy': 1, 'dx': 1}" in r.stdout,
            f"torchrun CLI printed:\n{r.stdout[-2000:]}")
    series = 0
    for name in sorted(os.listdir(os.path.join(single_out, "graphs"))):
        a = np.loadtxt(os.path.join(single_out, "graphs", name),
                       delimiter=",")
        b = np.loadtxt(os.path.join(shard_out, "graphs", name),
                       delimiter=",")
        require(a.shape == b.shape == (25, 9) and np.array_equal(a, b),
                f"torchrun CLI probe series {name}: not bitwise equal to "
                f"the single-device CLI's")
        series += 1
    print(f"torchrun --nproc-per-node 1 ... {' '.join(flags)} --shard 1 "
          f"(200^2, 200 steps): 25 launches of the gated window; {series} "
          f"probe series bitwise equal to the single-device CLI's")
    return counts["collide_stream_multistep_gated"]


def _gated_bound_ms(rows, nx, k_steps, storage):
    """(least ms, "bytes" or "operations") of one gated window on a band of
    rows x nx: f and g read and written once, against K times the collide
    stage's issue floor (_issue_floor_ms)."""
    t_ops = k_steps * _issue_floor_ms(
        "bf16+delta" if storage == "bf16" else "f32", rows * nx)
    t_bytes = BYTES_PER_SITE[storage] * rows * nx / HBM_BYTES_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_gated_real_size():
    """Phase 13c: the gated window at 2048^2 NONE bf16 + delta, K = 32, on
    the bands of 1 card (2112 x 2048) and 4 cards (576 x 2048) beside the
    whole-grid bounce-back window, the bound and the plain version; the
    sharded rollout over a world of one beside the single-device window
    rollout. Returns (ms, plain_ms, bound_ms, bound_by, at) on the 1-card
    band."""
    import torch
    import torch.distributed as dist
    from lbm_tpu_torch.config import BC, PlasmaConfig, PoissonSolver
    from lbm_tpu_torch.kernels import fused_multistep as fm
    from lbm_tpu_torch.models import plasma
    from lbm_tpu_torch.parallel import fused_sharded, sharding
    from lbm_tpu_torch.parallel import mesh as pmesh

    n, K = GATED_TIMED_N, GATED_TIMED_K
    print(f"== phase 13c: the gated window at {n}^2 NONE bf16+delta, K = "
          f"{K} (CUDA events)")
    device = torch.device("cuda")
    cfg = PlasmaConfig(NX=n, NY=n, dtype=torch.float32, storage="bf16",
                       neutral_delta=True, poisson=PoissonSolver.NONE,
                       bc=BC.BOUNCE_BACK, backend="fused", multistep=K)
    kw = _gated_kw(cfg)
    st = plasma.make_rollout(cfg, K)(plasma.init_state(cfg, device))
    arrays = (st.f, st.g, st.Ex, st.Ey)
    whole_ms = _device_ms(lambda: fm.collide_stream_multistep(
        *arrays, k_steps=K, bounce=True, **kw), 3)
    whole_bound, _ = _gated_bound_ms(n, n, K, "bf16")
    out, line = None, []
    for cards in (1, 4):
        rows = slice(0, n // cards)
        band, walls = fm.window_inputs(arrays, rows, K)
        ms = _device_ms(lambda: fm.collide_stream_multistep_gated(
            *band, walls, k_steps=K, **kw), 3)
        band0, _ = fm.window_inputs(_init_fields(cfg, device)[:4], rows, K)
        ms0 = _device_ms(lambda: fm.collide_stream_multistep_gated(
            *band0, walls, k_steps=K, **kw), 3)
        del band0
        torch.cuda.synchronize()
        tp = time.perf_counter()
        fm.collide_stream_multistep_gated_reference(*band, walls, k_steps=K,
                                                    **kw)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - tp) * 1e3
        bound, bound_by = _gated_bound_ms(band[2].shape[0], n, K, "bf16")
        shape = f"{band[2].shape[0]}x{n}"
        line.append(f"{cards} card{'s' if cards > 1 else ''}: band {shape} "
                    f"walls {walls} {ms:.4f} ms a launch ({ms / K:.4f} a "
                    f"step; the initial state {ms0:.4f}), bound {bound:.4f} by {bound_by} "
                    f"({100 * bound / ms:.1f}%), plain {plain_ms:.1f} ms")
        if cards == 1:
            out = (ms, plain_ms, bound, bound_by,
                   f"{shape} bf16+delta NONE K={K}, the band of a world of "
                   f"one")
        del band
        torch.cuda.empty_cache()
    print(f"whole-grid bounce-back window {n}x{n} {whole_ms:.4f} ms a launch "
          f"(bound {whole_bound:.4f}); " + "; ".join(line))
    del st, arrays
    torch.cuda.empty_cache()
    device = _one_rank_group("windows_13c")
    try:
        m = pmesh.make_mesh((1, 1), "cuda")
        res = []
        for side, roll_of in (
                ("single-device", lambda k: plasma.make_rollout(cfg, k)),
                ("sharded", lambda k: fused_sharded.
                 make_fused_sharded_multistep_rollout(cfg, m, k))):
            state = plasma.init_state(cfg, device)
            if side == "sharded":
                state = sharding.shard_state(state, m)
            state, ms = _window(roll_of(K), state, 1, 3)
            ms /= K
            require(all(bool(torch.isfinite(t.float()).all())
                        for t in (state.f, state.g)),
                    f"{n}^2 {side} windows: state not finite")
            res.append(f"{side} {ms:.4f} ms/step "
                       f"({n * n / (ms * 1e-3) / 1e6:.1f} MLUPS)")
            del state
            torch.cuda.empty_cache()
        print(f"{n}^2 bf16+delta NONE bounce-back, K = {K} windows (1 + 3 "
              f"timed) over a world of one: " + "; ".join(res))
    finally:
        dist.destroy_process_group()
    return out

# phase 14: checkpoints, resume, the watchdog, --profile and measure_drift.
# 14a's cadences: (label, flags, steps to the checkpoint, cadence, window
# launches of the resumed run)
CKPT_GOLDEN = [("per step", [], 120, 40, 80),
               ("multistep 8", ["--multistep", "8"], 96, 48, 13)]
# 14c's cavity runs at 129^2: (label, flags, kernel, launches from 6,000)
CKPT_CAVITY = [("stored f32", [], "collide_stream_cavity", 4000),
               ("stored bf16", ["--storage", "bf16"],
                "collide_stream_cavity", 4000),
               ("multistep 100 f32", ["--multistep", "100"],
                "collide_stream_cavity_multistep", 40)]


def _same_state(where, got, want, fields=None):
    """Every tensor field of two states bitwise equal, and the steps."""
    import torch
    for k in fields or got._fields:
        g, w = getattr(got, k), getattr(want, k)
        if k == "step":
            require(int(g) == int(w), f"{where}: step {g} vs {w}")
            continue
        g, w = g.to(w.device), w
        require(g.shape == w.shape and g.dtype == w.dtype
                and torch.equal(_bits(g), _bits(w)),
                f"{where} {k}: not bitwise equal")


def _straight(key, run):
    """Phase 4's, 7b's or 8b's straight run, or this call's own."""
    if key not in STRAIGHT:
        STRAIGHT[key] = run()
    return STRAIGHT[key]


def _bf16_bits_reference(x):
    """float64 -> bfloat16 bits as numpy rounds it (round to nearest even
    to float32, then to bfloat16), from the float32 bits: finite inputs."""
    b = x.astype(np.float32).view(np.uint32).astype(np.uint64)
    return ((b + 0x7FFF + ((b >> 16) & 1)) >> 16).astype(np.uint16)


def phase_checkpoint_golden():
    """Phase 14a: the golden CLI checkpointed and resumed, per step and
    with --multistep 8."""
    from lbm_tpu_torch import run_plasma
    from lbm_tpu_torch.io import checkpoint
    from lbm_tpu_torch.models.plasma import PlasmaState

    print("== phase 14a: the golden CLI, checkpoint and resume")
    ref = _parse_probe_fixture(FIXTURE)
    base = ["--preset", "golden", "--f64", "--device", "cuda"]
    for label, flags, at, every, want in CKPT_GOLDEN:
        key = "golden_multistep" if flags else "golden"
        out = os.path.join(OUT, key)
        straight = _straight(key, lambda: run_plasma.main(
            base + flags + ["--out", out] + NO_VIDEO))
        ck_out = os.path.join(OUT, f"ckpt_{key}")
        t0 = time.perf_counter()
        run_plasma.main(base + flags + ["--steps", str(at),
                                        "--checkpoint-every", str(every),
                                        "--out", ck_out] + NO_VIDEO)
        first_s = time.perf_counter() - t0
        names = sorted(n for n in os.listdir(ck_out) if n.startswith("ckpt"))
        require(names == [f"ckpt_{s:06d}.npz" for s in
                          range(every, at + 1, every)],
                f"{label}: checkpoints {names}")
        _reset_launches()
        resumed = run_plasma.main(base + flags + [
            "--resume", os.path.join(ck_out, f"ckpt_{at:06d}.npz"),
            "--out", ck_out + "_resumed"] + NO_VIDEO)
        kernel = ("collide_stream_multistep" if flags else "collide_stream")
        counts = resumed["launches"]
        require(counts == {k: want if k == kernel else 0 for k in counts},
                f"{label}: resumed launches {counts}, want {want} of "
                f"{kernel}")
        _same_state(f"{label}: final_state.npz",
                    checkpoint.load(os.path.join(ck_out + "_resumed",
                                                 "final_state.npz"), "cuda"),
                    checkpoint.load(os.path.join(out, "final_state.npz"),
                                    "cuda"), PlasmaState._fields)
        _same_state(f"{label}: the end state", resumed["state"],
                    straight["state"])
        stride = 8 if flags else 1
        rows = at // stride
        worst = 0.0
        for k, series in straight["probes"].items():
            got = resumed["probes"][k]
            require(np.array_equal(got, series[rows:]),
                    f"{label}: probe series {k} not bitwise equal to the "
                    f"straight run's rows {rows}-")
            # a window row holds the macros before it and the E after it
            fix = ref[k][at + (stride - 1 if k in PROBE_E else 0)::stride]
            scale = np.abs(ref[k]).max()
            allowed = 1e-5 * np.abs(fix) + 1e-5 * scale
            ratio = float((np.abs(got - fix) / np.where(
                allowed == 0, 1e-300, allowed)).max())
            require(ratio <= 1.0, f"{label}: resumed probe series {k}: "
                    f"{ratio:.3f} x the fixture's gate")
            worst = max(worst, float(np.abs(got - fix).max() / scale))
        print(f"{label:>12}: to {at} with --checkpoint-every {every} "
              f"({first_s:.2f} s, {len(names)} files), resumed to 200: "
              f"final_state.npz and the end state bitwise equal to the "
              f"straight run's, {len(got)} probe rows bitwise equal "
              f"(fixture {worst:.3e} of scale); {want} launches of "
              f"{kernel}")


def phase_checkpoint_3d_cavity():
    """Phases 14b and 14c: the 3-D and cavity CLIs checkpointed and
    resumed; a bf16 cavity checkpoint resumed into an f64 run."""
    import torch
    from lbm_tpu_torch import run_cavity, run_plasma3d
    from lbm_tpu_torch.config import CavityConfig
    from lbm_tpu_torch.io import checkpoint
    from lbm_tpu_torch.kernels import fused_cavity

    print("== phase 14b: the 3-D CLI (64^3 f32 + delta), checkpoint and "
          "resume")
    out = os.path.join(OUT, "plasma3d")
    straight = _straight("plasma3d", lambda: run_plasma3d.main(
        ["--out", out]))
    ck_out = os.path.join(OUT, "ckpt_plasma3d")
    run_plasma3d.main(["--steps", "30", "--checkpoint-every", "30",
                       "--slice-every", "0", "--out", ck_out])
    _reset_launches()
    resumed = run_plasma3d.main([
        "--resume", os.path.join(ck_out, "ckpt_000030.npz"),
        "--slice-every", "0", "--out", ck_out + "_resumed"])
    require(resumed["launches"]["collide_stream3d"] == 20
            and sum(resumed["launches"].values()) == 20,
            f"3-D resumed launches {resumed['launches']}")
    _same_state("3-D final_state.npz",
                checkpoint.load3d(os.path.join(ck_out + "_resumed",
                                               "final_state.npz"), "cuda"),
                checkpoint.load3d(os.path.join(out, "final_state.npz"),
                                  "cuda"))
    _same_state("3-D end state", resumed["state"], straight["state"])
    print("to 30, resumed to 50: final_state.npz bitwise equal to phase "
          "8b's; 20 launches of collide_stream3d")

    print("== phase 14c: the cavity CLI at 129^2, checkpoint and resume")
    base = ["--nx", "129", "--re", "100", "--u-lid", "0.1", "--device",
            "cuda"]
    for label, flags, kernel, want in CKPT_CAVITY:
        tag = label.replace(" ", "_")
        a = os.path.join(OUT, f"ckpt_cavity_{tag}")
        straight = run_cavity.main(base + flags + [
            "--steps", "10000", "--checkpoint-every", "10000", "--out", a]
            + NO_CAVITY_VIDEO)
        run_cavity.main(base + flags + ["--steps", "6000",
                                        "--checkpoint-every", "6000",
                                        "--out", a + "_b"] + NO_CAVITY_VIDEO)
        _reset_cavity_launches()
        resumed = run_cavity.main(base + flags + [
            "--steps", "10000", "--checkpoint-every", "6000", "--resume",
            os.path.join(a + "_b", "ckpt_0006000.npz"), "--out", a + "_c"]
            + NO_CAVITY_VIDEO)
        counts = dict(fused_cavity.LAUNCHES)
        require(counts == {k: want if k == kernel else 0 for k in counts},
                f"{label}: resumed launches {counts}")
        _same_state(f"{label}: final_state.npz",
                    checkpoint.load_cavity(os.path.join(
                        a + "_c", "final_state.npz"), "cuda"),
                    checkpoint.load_cavity(os.path.join(
                        a, "final_state.npz"), "cuda"))
        _same_state(f"{label}: end state", resumed["state"],
                    straight["state"])
        g = resumed["ghia"]
        print(f"{label:>17}: 6,000 steps, resumed to 10,000: bitwise equal "
              f"to the straight run; {want} launches of {kernel}; Ghia u max "
              f"{g['u_max']:.4f}")
    # the bf16 checkpoint into an f64 native run: reconcile on the card
    path = os.path.join(OUT, "ckpt_cavity_stored_bf16_b", "ckpt_0006000.npz")
    cfg64 = CavityConfig(NX=129, NY=129, dtype=torch.float64)
    on_card = checkpoint.reconcile_cavity_state(
        checkpoint.load_cavity(path, "cuda"), path, cfg64)
    on_cpu = checkpoint.reconcile_cavity_state(
        checkpoint.load_cavity(path, "cpu"), path, cfg64)
    _same_state("bf16 -> f64 reconcile, card vs CPU", on_card, on_cpu)
    s = run_cavity.main(base + ["--f64", "--steps", "10000", "--resume", path,
                                "--out", os.path.join(OUT, "ckpt_cavity_f64")]
                        + NO_CAVITY_VIDEO)
    require(s["finite"] and s["state"].f.dtype == torch.float64
            and s["start_step"] == 6000, "bf16 -> f64 resume")
    g = s["ghia"]
    print(f"bf16 checkpoint at 6,000 into an f64 native run: reconcile on "
          f"the card bitwise equal to the CPU's; to 10,000 in f64, Ghia u "
          f"max {g['u_max']:.4f}, v max {g['v_max']:.4f}")


def phase_checkpoint_real_size():
    """Phases 14d-14h and 14k: bf16 resume at 1024^2, the spectral
    engine's phi, the layout conversion and the cast on the card, the
    --shard 1 CLI, the watchdog, and a checkpoint's write and load times."""
    import dataclasses

    import torch
    import torch.distributed as dist
    from lbm_tpu_torch import run_plasma
    from lbm_tpu_torch.config import PlasmaConfig, PoissonSolver
    from lbm_tpu_torch.io import checkpoint
    from lbm_tpu_torch.kernels import fft_tpu
    from lbm_tpu_torch.models import plasma
    from lbm_tpu_torch.utils.watchdog import (BlowupError, Watchdog,
                                              finite_reduction)

    dev = torch.device("cuda")
    print("== phase 14d: the plasma CLI at 1024^2 bf16 + delta, 5 steps "
          "resumed to 10")
    base = ["--preset", "1024", "--storage", "bf16", "--device", "cuda"]
    a = os.path.join(OUT, "ckpt_1024")
    straight = run_plasma.main(base + ["--steps", "10", "--out", a] + NO_VIDEO)
    run_plasma.main(base + ["--steps", "5", "--checkpoint-every", "5",
                            "--out", a + "_b"] + NO_VIDEO)
    _reset_launches()
    resumed = run_plasma.main(base + [
        "--steps", "10", "--resume", os.path.join(a + "_b", "ckpt_000005.npz"),
        "--out", a + "_c"] + NO_VIDEO)
    require(resumed["launches"]["collide_stream"] == 5,
            f"1024^2 resumed launches {resumed['launches']}")
    _same_state("1024^2 bf16 final_state.npz",
                checkpoint.load(os.path.join(a + "_c", "final_state.npz"),
                                dev),
                checkpoint.load(os.path.join(a, "final_state.npz"), dev))
    _same_state("1024^2 bf16 end state", resumed["state"], straight["state"])
    print("bitwise equal to the straight run; 5 launches of collide_stream")

    print("== phase 14e: 512^2 f32, fft_engine='pallas', make_rollout and "
          "the checkpoint module")
    cfg = dataclasses.replace(PlasmaConfig(), NX=512, NY=512,
                              dtype=torch.float32, neutral_delta=True,
                              backend="fused", fft_engine="pallas")
    want = plasma.make_rollout(cfg, 10)(plasma.init_state(cfg, dev))
    mid = plasma.make_rollout(cfg, 5)(plasma.init_state(cfg, dev))
    path = os.path.join(OUT, "ckpt_pallas", "ckpt_000005.npz")
    checkpoint.save(path, checkpoint.with_fresh_phi(cfg, mid),
                    neutral_delta=True, storage="native")
    back = checkpoint.reconcile_resumed_state(
        checkpoint.load(path, dev, dtype=torch.float32), path, cfg)
    phi = plasma.reconstruct_phi(cfg, mid)
    require(torch.equal(_bits(back.phi), _bits(phi))
            and not torch.equal(phi, mid.phi),
            "the saved phi is not reconstruct_phi of the state")
    fft_tpu.LAUNCHES = 0
    got = plasma.make_rollout(cfg, 5)(back)
    require(fft_tpu.LAUNCHES == 5, f"spectral solve launches "
            f"{fft_tpu.LAUNCHES}")
    _same_state("pallas-engine resume", got, want,
                ("f", "g", "Ex", "Ey", "step"))
    print(f"saved phi = reconstruct_phi (max|phi| "
          f"{float(phi.abs().max()):.3e}); resumed 5 steps bitwise equal to "
          f"the straight 10 (f, g, E); 5 spectral-solve launches")

    print("== phase 14f: convert_neutral_layout and the f64 -> bf16 cast "
          "on the card")
    rng = np.random.default_rng(14)
    x = rng.standard_normal(1 << 20) * 2.0 ** rng.integers(-30, 34, 1 << 20)
    # just past a bf16 rounding tie, by less than a float32 ulp: rounding
    # straight to bf16 and rounding through float32 part there
    v = _bf16_bits_reference(x).astype(np.uint32) << 16
    v = v.view(np.float32).astype(np.float64)
    tie = (v + np.sign(v) * np.ldexp(1.0, np.frexp(v)[1] - 9)) * (
        1 + 2.0 ** -30)
    x = np.concatenate([x, tie])
    ref = _bf16_bits_reference(x)
    xt = torch.from_numpy(x)
    card = checkpoint.cast(xt.to(dev), torch.bfloat16).cpu()
    host = checkpoint.cast(xt, torch.bfloat16)
    require(np.array_equal(_bits(card).numpy().view(np.uint16), ref)
            and torch.equal(_bits(card), _bits(host)),
            "the f64 -> bf16 cast on the card differs from numpy's rounding")
    rho_n = PlasmaConfig().units().rho_n_init
    held = 0
    for st in (straight["state"], want):
        for to_delta in (False, True):
            on_card = checkpoint.convert_neutral_layout(
                st, to_delta=to_delta, rho_n_ref=rho_n)
            host_st = st._replace(**{k: getattr(st, k).cpu() for k in
                                     ("f", "g", "Ex", "Ey", "phi")})
            on_cpu = checkpoint.convert_neutral_layout(
                host_st, to_delta=to_delta, rho_n_ref=rho_n)
            _same_state("convert_neutral_layout card vs CPU", on_card,
                        on_cpu)
            held += 1
    print(f"cast: {x.size} values ({tie.size} near bf16 ties) bitwise equal "
          f"to numpy's rounding and the CPU's; convert_neutral_layout: "
          f"{held} conversions (1024^2 bf16, 512^2 f32) bitwise equal to "
          f"the CPU's")

    print("== phase 14g: the plasma CLI with --shard 1 --multistep 8 on a "
          "one-rank NCCL group, 512^2 NONE f32")
    # --shard 1 takes the windowed path (the per-step auto mesh wants 2
    # ranks or more): 24 steps, 3 windows, and a resume at step 16
    grid = ["--nx", "512", "--ny", "512", "--poisson", "NONE", "--multistep",
            "8", "--device", "cuda"]
    single = os.path.join(OUT, "ckpt_shard_single")
    run_plasma.main(grid + ["--steps", "24", "--out", single] + NO_VIDEO)
    _one_rank_group("checkpoint")
    try:
        sh = os.path.join(OUT, "ckpt_shard1")
        run_plasma.main(grid + ["--shard", "1", "--steps", "24", "--out", sh]
                        + NO_VIDEO)
        run_plasma.main(grid + ["--shard", "1", "--steps", "16",
                                "--checkpoint-every", "16",
                                "--out", sh + "_b"] + NO_VIDEO)
        _reset_launches()
        s = run_plasma.main(grid + [
            "--shard", "1", "--steps", "24", "--resume",
            os.path.join(sh + "_b", "ckpt_000016.npz"), "--out", sh + "_c"]
            + NO_VIDEO)
        windows = sum(s["launches"].values())
        require(windows == 1 and s["mesh"] == {"dy": 1, "dx": 1},
                f"--shard 1 resumed launches {s['launches']}")
    finally:
        dist.destroy_process_group()
    want_final = checkpoint.load(os.path.join(single, "final_state.npz"),
                                 dev)
    for where in (sh, sh + "_c"):
        _same_state(f"--shard 1 {os.path.basename(where)} final_state.npz",
                    checkpoint.load(os.path.join(where, "final_state.npz"),
                                    dev), want_final)
    print("rank 0's final_state.npz bitwise equal to the single-device "
          "run's, straight and resumed at step 16 (one window launch)")

    print("== phase 14h: the watchdog at 2048^2 f32")
    cfg = dataclasses.replace(PlasmaConfig(), NX=2048, NY=2048,
                              dtype=torch.float32, neutral_delta=True,
                              backend="fused")
    step = plasma.make_step(cfg)
    state = step(plasma.init_state(cfg, dev))
    g = state.g.clone()
    g[1, 4, 1000, 1500] = float("nan")
    state = state._replace(g=g)
    wd = Watchdog(every=2)
    raised = None
    for t in range(4):
        state = step(state)
        try:
            state = wd.check(t, state)
        except BlowupError as e:
            raised = e.step
            break
    require(raised == 1, f"the watchdog raised at {raised}, want t = 1")
    fresh = step(plasma.init_state(cfg, dev))
    for value in (float("inf"), -float("inf")):
        f = fresh.f.clone()
        f[2, 7, 2047, 0] = value
        require(not bool(finite_reduction(fresh._replace(f=f))),
                f"finite_reduction missed {value} on the card")
    del f
    reduce_ms = _device_ms(lambda: finite_reduction(fresh), 20)
    check_ms = _time_ms(lambda: wd.check(1, fresh), 20)
    step_ms = _time_ms(lambda: step(fresh), 10)
    print(f"NaN in g at step 0: BlowupError at the first check (t = "
          f"{raised}); +-inf in f found; the reduction (min and max of f, "
          f"g, E, phi) {reduce_ms:.4f} ms on the device, one check with "
          f"its host read {check_ms:.4f} ms, beside a step's {step_ms:.4f} "
          f"ms; {card_line()}")
    del state, fresh, g
    torch.cuda.empty_cache()

    print("== phase 14k: a checkpoint's write and load at 1024^2 bf16")
    st = resumed["state"]
    cfg = dataclasses.replace(PlasmaConfig(), NX=1024, NY=1024,
                              storage="bf16", neutral_delta=True,
                              dtype=torch.float32)
    path = os.path.join(OUT, "ckpt_1024_timing", "ckpt.npz")
    times = {"write": [], "load": []}
    for _ in range(3):
        t0 = time.perf_counter()
        checkpoint.save(path, st, neutral_delta=True, storage="bf16")
        times["write"].append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        back = checkpoint.reconcile_resumed_state(
            checkpoint.load(path, dev, dtype=torch.float32), path, cfg,
            log=lambda *a: None)
        torch.cuda.synchronize()
        times["load"].append((time.perf_counter() - t0) * 1e3)
    _same_state("1024^2 bf16 save + load", back, st)
    mb = os.path.getsize(path) / 2 ** 20
    raw = sum(t.numel() * t.element_size() for t in st
              if isinstance(t, torch.Tensor)) / 2 ** 20
    print(f"write {min(times['write']):.1f}-{max(times['write']):.1f} ms, "
          f"load + reconcile {min(times['load']):.1f}-"
          f"{max(times['load']):.1f} ms (3 runs, warm file cache), "
          f"{raw:.1f} MiB of state in a {mb:.1f} MiB file; {card_line()}")


def phase_profile_and_drift():
    """Phases 14i and 14j: --profile on the golden CLI; the drift table."""
    import importlib.util
    import torch
    from lbm_tpu_torch import run_plasma
    from lbm_tpu_torch.kernels import fused_step

    print("== phase 14i: the golden CLI with --profile, 10 steps")
    trace_dir = os.path.join(OUT, "profile")
    path = os.path.join(trace_dir, "trace_rank0.json")
    if os.path.exists(path):
        os.remove(path)
    fused_step.LAUNCHES = 0
    run_plasma.main(["--f64", "--steps", "10", "--profile", trace_dir,
                     "--out", os.path.join(OUT, "profile_run")] + NO_VIDEO)
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    tiles = [e for e in kernels if "plasma_tiles_kernel" in e.get("name", "")]
    require(len(tiles) == 10 == fused_step.LAUNCHES,
            f"the trace names the collide+stream kernel {len(tiles)} times "
            f"({fused_step.LAUNCHES} launches)")
    dur = sorted(e.get("dur", 0) for e in tiles)
    print(f"{os.path.relpath(path, HERE)}: {len(events)} events, "
          f"{len(kernels)} kernels, plasma_tiles_kernel 10 times (median "
          f"{dur[len(dur) // 2]} us)")

    print("== phase 14j: scripts/measure_drift_torch.py on the card")
    spec = importlib.util.spec_from_file_location(
        "measure_drift_torch",
        os.path.join(HERE, "scripts", "measure_drift_torch.py"))
    drift = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(drift)
    fused_step.LAUNCHES = 0
    errs = drift.main(["--json", os.path.join(OUT, "drift.json")])
    require(fused_step.LAUNCHES == 4 * 200, f"measure_drift launched "
            f"collide_stream {fused_step.LAUNCHES} times, want 800")
    for k in ("rho_n", "ux_n", "uy_n", "T_n"):
        require(errs["delta f32"][k] <= 1e-3, f"drift: delta f32 {k} "
                f"{errs['delta f32'][k]:.3e} > 1e-3 of scale")
    require(errs["classic f32"]["T_n"] >= 1.0, f"drift: classic f32 T_n "
            f"{errs['classic f32']['T_n']:.3e}, the documented divergence "
            f"is >= 1")
    print(f"delta f32 neutral rows within 1e-3 of scale, classic T_n "
          f"{errs['classic f32']['T_n']:.3e}; 800 collide_stream launches; "
          f"{torch.cuda.get_device_name(0)}")


# phase 15: the frames of the golden CLI's three videos (rows, columns) at
# 200^2, each row of tiles under a 30-px label strip
GOLDEN_FRAMES = {"density": (230, 600), "velocity": (460, 600),
                 "temperature": (230, 600)}
# phase 15d: how far the Re sweep may land from the JAX package's committed
# 256^2 run (artifacts/cavity_re/summary.json): steps to steady state, each
# Ghia station's value and each max error, in lid units
RE_STEPS_GATE, RE_SIM_GATE, RE_ERR_GATE = 20_000, 2e-3, 2e-3


def _video_frames(where, path, n, shape, tiles=slice(30, 230)):
    """The frames of an AVI that the port wrote: n of (rows, cols), none
    whose `tiles` rows (the golden videos' first row of tiles, below its
    label strip) are constant."""
    from lbm_tpu_torch.io.avi import read_frames

    fr = read_frames(path)
    require(fr.shape == (n, *shape, 3),
            f"{where}: {path} holds frames {fr.shape}, want {(n, *shape, 3)}")
    flat = [i for i, f in enumerate(fr) if f[tiles].min() == f[tiles].max()]
    require(not flat, f"{where}: frames {flat[:5]} of {path} are constant")
    return fr


def _golden_cfg(flags):
    from lbm_tpu_torch import run_plasma
    return run_plasma.build_config(run_plasma.parse_args(flags))


def phase_render():
    """Phase 15a: render_all on the card against the same function on CPU
    copies of the same fields, uint8 for uint8: the golden end state's
    macros in f64 (phase 4's run) and f32 (a --no-video golden run, which
    15b reuses), a seeded 2048^2 f32 state, the cavity frame at 2048^2.
    Times render_all and render_all + its copy into pinned host memory at
    200^2 and 2048^2 by CUDA events."""
    import torch
    from lbm_tpu_torch import run_plasma
    from lbm_tpu_torch.config import CavityConfig
    from lbm_tpu_torch.io import colormap, video
    from lbm_tpu_torch.models import cavity, plasma

    print("== phase 15a: rendering on the card against the CPU")
    card = card_line()
    golden64 = _straight("golden", lambda: run_plasma.main(
        ["--preset", "golden", "--f64", "--device", "cuda", "--out",
         os.path.join(OUT, "golden")] + NO_VIDEO))
    golden32 = _golden_f32()
    cfg2048 = _golden_cfg(["--nx", "2048", "--ny", "2048"])
    fields = {
        "golden end state f64": colormap.macro_fields(plasma.compute_macros(
            _golden_cfg(["--f64"]), golden64["state"])),
        "golden end state f32": colormap.macro_fields(plasma.compute_macros(
            _golden_cfg([]), golden32["state"])),
        "seeded 2048^2 f32": colormap.macro_fields(plasma.compute_macros(
            cfg2048, _seeded_state(cfg2048, "cuda", seed=15)))}
    for where, f in fields.items():
        got = colormap.render_all(*f)
        want = colormap.render_all(*[t.cpu() for t in f])
        for name, g, w in zip(GOLDEN_FRAMES, got, want):
            bad = int((g.cpu() != w).sum())
            require(bad == 0, f"15a {where}: {bad} pixels of the {name} "
                    f"frame differ from the CPU's render")
        print(f"{where}: the three frames {[tuple(g.shape) for g in got]} "
              f"uint8-equal to the CPU's")
    ccfg = CavityConfig(NX=2048, NY=2048, nsteps=500, u_lid=0.1, Re=100.0,
                        backend="fused")
    cs = cavity.make_rollout(ccfg)(cavity.init_state(ccfg, "cuda"))
    got = colormap.cavity_frame(cs.ux, cs.uy)
    bad = int((got.cpu() != colormap.cavity_frame(cs.ux.cpu(),
                                                  cs.uy.cpu())).sum())
    require(bad == 0, f"15a cavity 2048^2: {bad} channel values differ "
            f"from the CPU's frame")
    require(got.min() != got.max(), "15a cavity 2048^2: a constant frame")
    print("cavity 2048^2 after 500 steps: the |u|^2 frame uint8-equal to "
          "the CPU's")
    for where in ("golden end state f32", "seeded 2048^2 f32"):
        f = fields[where]
        render = _time_ms(lambda: colormap.render_all(*f), 50)
        copied = _time_ms(lambda: video.to_host(colormap.render_all(*f)), 50)
        nbytes = sum(g.numel() for g in colormap.render_all(*f))
        ny, nx = f[0].shape
        rec = video.VideoRecorder(os.path.join(OUT, f"render_{nx}"), nx, ny,
                                  log=lambda *a: None)
        try:
            whole = _time_ms(lambda: video.to_host([
                rec._label(k, colormap.expand(g)) for k, g in zip(
                    GOLDEN_FRAMES, colormap.render_all(*f))]), 50)
        finally:
            rec.close()
        print(f"[{card}] render_all at {tuple(f[0].shape)}: {render:.4f} ms "
              f"on the device; with the copy of its {nbytes} bytes into "
              f"pinned host memory {copied:.4f} ms; the recorder's device "
              f"work (render, expand to RGB, label strips, copy of "
              f"{3 * nbytes + 3 * 30 * 4 * 3 * nx} bytes) {whole:.4f} ms")
    cf = _time_ms(lambda: colormap.cavity_frame(cs.ux, cs.uy), 50)
    print(f"[{card}] cavity_frame at 2048^2: {cf:.4f} ms on the device")


def _golden_f32():
    """The golden CLI in f32 (its defaults) without video: 15a's render
    holds and 15b's time without video."""
    from lbm_tpu_torch import run_plasma
    return _straight("golden_f32", lambda: run_plasma.main(
        ["--device", "cuda", "--out", os.path.join(OUT, "golden_f32")]
        + NO_VIDEO))


def _encode_ms(reps=20):
    """Host ms the recorder's encoder thread spends on one step's three
    golden frames, labelled RGB from the device: the three native AVI
    writes (into a scratch directory)."""
    from lbm_tpu_torch.io import video

    rng = np.random.default_rng(16)
    frames = [rng.integers(0, 256, (*shape, 3), dtype=np.uint8)
              for shape in GOLDEN_FRAMES.values()]
    rec = video.VideoRecorder(os.path.join(OUT, "encode_timing"), 200, 200,
                              log=lambda *a: None)
    try:
        t0 = time.perf_counter()
        for _ in range(reps):
            for kind, frame in zip(GOLDEN_FRAMES, frames):
                rec._writers[kind].write(frame)
        return (time.perf_counter() - t0) * 1e3 / reps
    finally:
        rec.close()


def _video_cost(what, main, flags, name, card, pairs=3):
    """ms a step of a CLI with its video on and off, in alternating runs
    (off, on, on, off, ...: `pairs` runs each way), so that drift of the
    host's speed across the call falls on both. Returns the last run with
    video."""
    runs, last = {"on": [], "off": []}, None
    order = (["off", "on", "on", "off"] * pairs)[:2 * pairs]
    for i, mode in enumerate(order):
        s = main(flags + (["--no-video"] if mode == "off" else [])
                 + ["--out", os.path.join(OUT, f"{name}_{i}")])
        runs[mode].append(s["wall_ms"] / s["steps"])
        last = s if mode == "on" else last
    on, off = (float(np.median(runs[k])) for k in ("on", "off"))
    print(f"[{card}] {what}, ms a step in alternating runs: with video "
          f"{', '.join(f'{v:.4f}' for v in runs['on'])}; without "
          f"{', '.join(f'{v:.4f}' for v in runs['off'])}; medians "
          f"{on:.4f} / {off:.4f} (+{on - off:.4f})")
    return last


def phase_golden_video():
    """Phase 15b: the golden CLI (200^2 f32, 200 steps) with its videos on
    and off, ms a step each; its three AVIs read back (200 frames of 600 x
    230, 600 x 460, 600 x 230, none constant); --multistep 8 --video-every
    8 (25 frames); and the NONE windows' videos with --shard 1 on a
    one-rank NCCL group bitwise equal to the single-device run's."""
    import torch.distributed as dist
    from lbm_tpu_torch import run_plasma

    print("== phase 15b: the golden CLI's videos")
    card = card_line()
    golden_off = _golden_f32()
    _reset_launches()
    on = run_plasma.main(["--device", "cuda", "--out",
                          os.path.join(OUT, "golden_video")])
    require(on["launches"]["collide_stream"] == 200 and on["finite"],
            f"golden with video: launches {on['launches']}")
    require(golden_off["launches"]["collide_stream"] == 200,
            f"golden without video: launches {golden_off['launches']}")
    for kind, shape in GOLDEN_FRAMES.items():
        _video_frames(f"15b {kind}", on["video"][kind], 200, shape)
    print("3 AVIs of 200 frames read back")
    _video_cost("golden 200^2 f32, 200 steps", run_plasma.main,
                ["--device", "cuda", "--no-plots"], "golden_pair", card)
    print(f"the encoder thread's work a step on this host: {_encode_ms():.4f}"
          f" ms (the three AVI writes)")
    ms = run_plasma.main(["--device", "cuda", "--multistep", "8",
                          "--video-every", "8", "--out",
                          os.path.join(OUT, "golden_video_ms8")])
    for kind, shape in GOLDEN_FRAMES.items():
        _video_frames(f"15b --multistep 8 {kind}", ms["video"][kind], 25,
                      shape)
    print(f"[{card}] --multistep 8 --video-every 8: 25 frames a video, "
          f"{ms['wall_ms'] / ms['steps']:.4f} ms a step")
    # the per-step sharded step needs two ranks or more; the windows run on
    # a world of one (NONE, 8-row ghost slabs, the gated kernel)
    flags = ["--device", "cuda", "--poisson", "NONE", "--multistep", "8",
             "--video-every", "8", "--no-plots"]
    single = run_plasma.main(flags + ["--out", os.path.join(
        OUT, "golden_video_none")])
    _one_rank_group("video")
    try:
        shard = run_plasma.main(flags + ["--shard", "1", "--out", os.path.join(
            OUT, "golden_video_none_shard1")])
    finally:
        dist.destroy_process_group()
    for kind, shape in GOLDEN_FRAMES.items():
        a = _video_frames(f"15b NONE {kind}", single["video"][kind], 25,
                          shape)
        b = _video_frames(f"15b NONE --shard 1 {kind}",
                          shard["video"][kind], 25, shape)
        require(np.array_equal(a, b), f"15b --shard 1 {kind}: "
                f"{int((a != b).sum())} values differ from the single-"
                f"device frames")
    print(f"--shard 1 --multistep 8 (mesh {shard['mesh']}), NONE, 200 "
          f"steps: the three videos (25 frames) bitwise equal to the single-"
          f"device run's; [{card}] "
          f"{shard['wall_ms'] / 200:.4f} ms a step (single-device "
          f"{single['wall_ms'] / 200:.4f})")


def phase_cavity_video():
    """Phase 15c: the cavity CLI at Ghia's 129^2, 10,000 steps with
    --video-every 100: 100 frames, the Ghia gate; then --multistep 100 on
    one device and with --shard 1 on a one-rank NCCL group: frames bitwise
    equal."""
    import torch.distributed as dist
    from lbm_tpu_torch import run_cavity

    print("== phase 15c: the cavity CLI's video at 129^2")
    card = card_line()
    base = ["--nx", "129", "--steps", "10000", "--re", "100", "--u-lid",
            "0.1", "--device", "cuda", "--video-every", "100"]
    s = run_cavity.main(base + ["--out", os.path.join(OUT, "cavity_video")])
    _video_frames("15c", s["video"], 100, (129, 129), tiles=slice(None))
    for key, gate in GHIA_GATE.items():
        require(s["ghia"][key] < gate, f"15c Ghia {key} {s['ghia'][key]}")
    off = run_cavity.main(base + ["--no-video", "--out", os.path.join(
        OUT, "cavity_video_off")])
    print(f"[{card}] 129^2 stored, 10,000 steps: 100 frames; "
          f"{s['wall_ms'] / 1e4:.5f} ms a step with the video, "
          f"{off['wall_ms'] / 1e4:.5f} without")
    big = _video_cost(
        "cavity 2048^2 stored f32, 2,000 steps, a frame every 100",
        run_cavity.main, ["--nx", "2048", "--steps", "2000", "--re", "100",
                          "--u-lid", "0.1", "--device", "cuda",
                          "--video-every", "100"], "cavity_pair", card)
    _video_frames("15c 2048^2", big["video"], 20, (2048, 2048),
                  tiles=slice(None))
    flags = base + ["--multistep", "100"]
    single = run_cavity.main(flags + ["--out", os.path.join(
        OUT, "cavity_video_ms")])
    _one_rank_group("cavity_video")
    try:
        shard = run_cavity.main(flags + ["--shard", "1", "--out", os.path.join(
            OUT, "cavity_video_ms_shard1")])
    finally:
        dist.destroy_process_group()
    a = _video_frames("15c --multistep 100", single["video"], 100,
                      (129, 129), tiles=slice(None))
    b = _video_frames("15c --shard 1", shard["video"], 100, (129, 129),
                      tiles=slice(None))
    require(np.array_equal(a, b), f"15c --shard 1 --multistep 100: "
            f"{int((a != b).sum())} values differ from the single-device "
            f"frames")
    print(f"--shard 1 --multistep 100: 100 frames bitwise equal to the "
          f"single-device run's; [{card}] {shard['wall_ms'] / 1e4:.5f} ms a "
          f"step (single-device {single['wall_ms'] / 1e4:.5f})")


def phase_cavity_re():
    """Phase 15d: scripts/validate_cavity_re_torch.py --nx 256 (Re 100,
    400 and 1000 to steady state through the stored kernel) against the
    JAX package's artifacts/cavity_re/summary.json: steps within one
    20,000-step chunk, every station's value and every max error within
    2e-3 of the lid speed."""
    sys.path.insert(0, os.path.join(HERE, "scripts"))
    import validate_cavity_re_torch as sweep

    print("== phase 15d: the Re 100/400/1000 Ghia sweep at 256^2")
    card = card_line()
    out_dir = os.path.join(OUT, "cavity_re_torch")
    t0 = time.perf_counter()
    out = sweep.main(["--nx", "256", "--out", out_dir])
    wall = time.perf_counter() - t0
    with open(os.path.join(HERE, "artifacts", "cavity_re",
                           "summary.json")) as fh:
        ref = json.load(fh)["errors_vs_ghia"]
    for re_n, got in out["errors_vs_ghia"].items():
        want = ref[str(re_n)]
        require(abs(got["steps"] - want["steps"]) <= RE_STEPS_GATE,
                f"15d Re {re_n}: steady after {got['steps']} steps, the JAX "
                f"run after {want['steps']}")
        sim = max(abs(a["sim"] - b["sim"]) for a, b in
                  zip(got["stations"], want["stations"]))
        require(sim <= RE_SIM_GATE, f"15d Re {re_n}: a station's value "
                f"{sim:.2e} from the JAX run's (gate {RE_SIM_GATE})")
        errs = {k: got[k] - want[k] for k in got
                if k.endswith("_max_err") or k.endswith("_misprints")}
        worst = max(abs(v) for v in errs.values())
        require(worst <= RE_ERR_GATE, f"15d Re {re_n}: max errors "
                f"{errs} from the JAX run's (gate {RE_ERR_GATE})")
        print(f"Re {re_n}: {got['steps']} steps (JAX {want['steps']}), "
              f"residual {got['residual']:.2e}; u max {got['u_max_err']:.4f}"
              f" (JAX {want['u_max_err']:.4f}), v max {got['v_max_err']:.4f}"
              f" (JAX {want['v_max_err']:.4f}), excl. misprints "
              f"{got['v_max_err_excl_misprints']:.4f}; stations within "
              f"{sim:.2e} of JAX's; [{card}] {got['wall_s']:.2f} s")
    print(f"[{card}] the sweep took {wall:.1f} s; {out_dir}/summary.json")


def phase_watchdog_multistep():
    """Phase 15e: the golden CLI with --multistep 8 --watchdog-every 100
    checks at the windows that cross steps 100 and 200 (twice in 25
    windows); from a resumed state holding a NaN it raises at the first
    crossing, the window of steps 96-103."""
    import torch
    from lbm_tpu_torch import run_plasma
    from lbm_tpu_torch.io import checkpoint
    from lbm_tpu_torch.models import plasma
    from lbm_tpu_torch.utils import watchdog

    print("== phase 15e: the watchdog under --multistep 8")
    flags = ["--device", "cuda", "--multistep", "8", "--watchdog-every",
             "100"] + NO_VIDEO
    checks = []
    finite = watchdog.state_is_finite

    def counted(state, group=None):
        checks.append(state.step)
        return finite(state, group)
    watchdog.state_is_finite = counted
    try:
        s = run_plasma.main(flags + ["--out", os.path.join(OUT, "wd_ms8")])
    finally:
        watchdog.state_is_finite = finite
    require(checks == [104, 200] and s["finite"],
            f"15e: the watchdog checked the states at steps {checks}, want "
            f"[104, 200]")
    cfg = _golden_cfg([])
    st = plasma.init_state(cfg, "cuda")
    g = st.g.clone()
    g[0, 0, 100, 100] = float("nan")
    path = os.path.join(OUT, "wd_nan.npz")
    checkpoint.save(path, st._replace(g=g), neutral_delta=cfg.neutral_delta,
                    storage=cfg.storage)
    try:
        run_plasma.main(flags + ["--resume", path, "--out",
                                 os.path.join(OUT, "wd_nan")])
        raised = None
    except watchdog.BlowupError as e:
        raised = e.step
    require(raised == 103, f"15e: the NaN run raised at {raised}, want 103 "
            f"(the window of steps 96-103)")
    print(f"checks after the windows ending at steps {checks} (25 windows "
          f"of 8); a NaN in g raises BlowupError at step {raised}")


# phase 16: the sharded plain steps (parallel/sharding) on a (1, 1) mesh:
# (label, solver, bc, storage); bf16 storage collides with the plain ops
# (the collide-only kernel has no bf16 mode), against the single-device
# plain step
PLAIN_SHARDED = [("SOR + bounce-back", "SOR", "BOUNCE_BACK", "native"),
                 ("GS + bounce-back", "GS", "BOUNCE_BACK", "native"),
                 ("NPS periodic", "NPS", "PERIODIC", "native"),
                 ("NONE + bounce-back bf16 + delta", "NONE", "BOUNCE_BACK",
                  "bf16")]
PLAIN_SHARDED_N = 2048
PLAIN_SHARDED_STEPS = 3
# the iterative solves' cap: 5,000 plain sweeps a step at 2048^2, host-synced
# each, would take minutes; the sweeps run to the cap (f32, tol 1e-8)
PLAIN_SHARDED_SWEEPS = 200


def phase_sharded_plain():
    """Phase 16: make_sharded_step and make_sharded_cavity_step on a
    one-rank NCCL group and a (1, 1) mesh (every exchange is the block's
    own wrap). Returns the collide-only kernel's launches in the sharded
    runs (counts reset just before each, read just after)."""
    import torch
    import torch.distributed as dist
    from lbm_tpu_torch.config import (BC, CavityConfig, PlasmaConfig,
                                      PoissonSolver)
    from lbm_tpu_torch.kernels import (collide_pallas, fused_step,
                                       poisson_iter)
    from lbm_tpu_torch.models import cavity, plasma
    from lbm_tpu_torch.ops import poisson
    from lbm_tpu_torch.parallel import mesh as pmesh
    from lbm_tpu_torch.parallel import sharding

    n, steps = PLAIN_SHARDED_N, PLAIN_SHARDED_STEPS
    print(f"== phase 16: the sharded plain steps on a one-rank NCCL group, "
          f"(1, 1) mesh ({card_line()})")
    device = _one_rank_group("plain")
    launches = 0
    try:
        m = pmesh.make_mesh((1, 1), "cuda")
        for label, solver, bc, storage in PLAIN_SHARDED:
            bf16 = storage == "bf16"
            cfg = PlasmaConfig(NX=n, NY=n, dtype=torch.float32,
                               storage=storage, neutral_delta=bf16,
                               poisson=PoissonSolver[solver], bc=BC[bc],
                               backend="plain" if bf16 else "pallas",
                               iter_engine="xla",
                               poisson_max_iter=PLAIN_SHARDED_SWEEPS)
            runs, sweeps = {}, {}
            for name, step in (
                    ("single", plasma.make_step(cfg)),
                    ("sharded", sharding.make_sharded_step(
                        dataclasses.replace(cfg, backend="fused"), m))):
                state = plasma.init_state(cfg, device)
                _reset_launches()
                per_step = []

                def counted(s, step=step):
                    s = step(s)
                    per_step.append(poisson.LAST_SWEEPS)
                    return s

                state, ms = _window(counted, state, 1, steps - 1)
                runs[name] = (state, ms)
                sweeps[name] = per_step
                if name == "sharded":
                    got = collide_pallas.LAUNCHES
                    require(got == (0 if bf16 else steps)
                            and fused_step.LAUNCHES == 0
                            and poisson_iter.LAUNCHES == 0,
                            f"{label}: sharded step launched fused_collide "
                            f"{got}, collide_stream {fused_step.LAUNCHES}, "
                            f"solve_iter {poisson_iter.LAUNCHES} times")
                    launches += got
            (single, single_ms), (sharded, sharded_ms) = (runs["single"],
                                                           runs["sharded"])
            for k in ("f", "g", "Ex", "Ey", "phi"):
                require(torch.equal(getattr(sharded, k), getattr(single, k)),
                        f"{label}: sharded {k} not bitwise equal to the "
                        f"single-device step")
            require(all(bool(torch.isfinite(t.float()).all())
                         for t in (sharded.f, sharded.g, sharded.Ex)),
                    f"{label}: state not finite")
            if solver != "NONE":
                require(sweeps["sharded"] == sweeps["single"],
                        f"{label}: sweeps {sweeps}")
            swept = (f" (sweeps {sweeps['sharded']})" if solver != "NONE"
                     else "")
            print(f"{n}^2 {label}, {steps} steps: bitwise equal to the "
                  f"single-device {cfg.backend} step{swept}; "
                  f"{sharded_ms:.3f} ms/step sharded, "
                  f"{single_ms:.3f} single-device, over the last "
                  f"{steps - 1}; fused_collide launches "
                  f"{0 if bf16 else steps}")
            del runs, single, sharded

        cfg = CavityConfig()
        cav = {}
        for name, step in (("single", cavity.make_step(cfg)),
                           ("sharded",
                            sharding.make_sharded_cavity_step(cfg, m))):
            state = cavity.init_state(cfg, device)
            state, ms = _window(step, state, 0, cfg.nsteps)
            cav[name] = (state, ms)
        (single, single_ms), (sharded, sharded_ms) = (cav["single"],
                                                       cav["sharded"])
        for k in ("f", "rho", "ux", "uy"):
            require(torch.equal(getattr(sharded, k), getattr(single, k)),
                    f"cavity: sharded {k} not bitwise equal to the "
                    f"single-device plain step")
        g = cavity.ghia_errors(sharded, cfg.u_lid)
        for key, gate in GHIA_GATE.items():
            require(g[key] < gate, f"sharded cavity: Ghia {key} "
                    f"{g[key]:.4f} >= {gate}")
        print(f"cavity {cfg.NX}^2 Re 100 f32, {cfg.nsteps} steps: bitwise "
              f"equal to the single-device plain step; Ghia u max "
              f"{g['u_max']:.4f} rms {g['u_rms']:.4f}, v max "
              f"{g['v_max']:.4f} rms {g['v_rms']:.4f}; {sharded_ms:.4f} "
              f"ms/step sharded, {single_ms:.4f} single-device")
    finally:
        dist.destroy_process_group()
    return launches


def main(argv=None) -> int:
    import argparse
    import torch
    ap = argparse.ArgumentParser(description="Smoke test of lbm_tpu_torch "
                                 "on one NVIDIA GPU (see the module doc).")
    ap.add_argument("--only", default=None,
                    metavar="3,4,5,6,7,8,9,10,11,12,13,14,15,16",
                    help="run phases 1-2 and these phases only (no kernels "
                         "line, no ok line)")
    args = ap.parse_args(argv)
    only = None if args.only is None else set(args.only.split(","))

    def run(phase):
        return only is None or phase in only

    def timed(phase):
        t0 = time.perf_counter()
        out = phase()
        print(f"   [{phase.__name__}: {time.perf_counter() - t0:.1f} s]")
        return out

    t_start = time.perf_counter()
    timed(phase_environment)
    timed(phase_build)
    launches, others = {}, {}
    if run("3"):
        golden_err = timed(phase_kernel_vs_plain)
        solve_err = timed(phase_solve_kernel)
        collide_err = timed(phase_collide_kernel)
    if run("4"):
        launches["collide_stream"] = timed(phase_golden)
        launches.update(timed(phase_sor_bounceback))
    if run("5"):
        timings = timed(phase_real_size)
        others = timed(phase_real_size_solvers)
    if run("6"):
        cavity_err = timed(phase_cavity_kernels)
        launches.update(timed(phase_cavity_ghia))
        cavity_times, cavity_err_6c = timed(phase_cavity_real_size)
        others.update(cavity_times)
        for name, err in cavity_err_6c.items():
            cavity_err[name] = max(cavity_err[name], err)
    if run("7"):
        multistep_err = timed(phase_multistep_kernel)
        launches["collide_stream_multistep"] = timed(phase_multistep_golden)
        others["collide_stream_multistep"], err_7c = \
            timed(phase_multistep_real_size)
        multistep_err = max(multistep_err, err_7c)
    if run("8"):
        err_3d = timed(phase_3d_kernel)
        launches["collide_stream3d"], others["collide_stream3d"], err_8b = \
            timed(phase_3d_cli)
        err_3d = max(err_3d, err_8b, timed(phase_3d_real_size))
    if run("9"):
        fft_err = timed(phase_fft_kernel)
        launches["solve_fft_efield_tpu"], fft_times, err_9b = \
            timed(phase_fft_real_size)
        fft_err = max(fft_err, err_9b)
        timed(phase_debug_dump)
    if run("10"):
        halo_err, halo_times = timed(phase_halo_kernels)
        launches.update(timed(phase_sharded_world_of_one))
    if run("11"):
        cavity_halo_err, cavity_halo_times = timed(phase_cavity_halo_kernels)
        launches.update(timed(phase_cavity_sharded_cli))
        timed(phase_cavity_sharded_real_size)
    if run("12"):
        halo3d_err = timed(phase_halo3d_kernel)
        launches.update(timed(phase_sharded3d_world_of_one))
        halo3d_times = timed(phase_sharded3d_real_size)
    if run("13"):
        gated_err = timed(phase_gated_kernel)
        launches["collide_stream_multistep_gated"] = timed(
            phase_gated_sharded)
        gated_times = timed(phase_gated_real_size)
    if run("14"):
        timed(phase_checkpoint_golden)
        timed(phase_checkpoint_3d_cavity)
        timed(phase_checkpoint_real_size)
        timed(phase_profile_and_drift)
    if run("15"):
        os.environ["LBM_VIDEO_FORMAT"] = "avi"    # read back by read_frames
        timed(phase_render)
        timed(phase_golden_video)
        timed(phase_cavity_video)
        timed(phase_cavity_re)
        timed(phase_watchdog_multistep)
    if run("16"):
        launches["fused_collide_sharded"] = timed(phase_sharded_plain)
    print(f"phases took {time.perf_counter() - t_start:.1f} s")
    if only is not None:
        print(card_line())
        print(f"chip_smoke: phases 1, 2 and {sorted(only)} passed (--only)")
        return 0
    n = 2048
    kernels = [{
        "name": "collide_stream", "route": "cuda",
        "source": CSRC + "fused_step.cu",
        "replaces": "lbm_tpu/kernels/fused_step.py:685",
        "launches": launches["collide_stream"],
        "max_abs_err": golden_err, "max_abs_err_at": "200x200 f64",
        "ms": timings["native"], "plain_ms": timings["plain"],
        "bound_ms": _collide_bound_ms(n * n)[0],
        "bound_by": _collide_bound_ms(n * n)[1],
        "library_ms": None, "ms_at": "2048x2048 f32"}]
    for name, source, replaces, err, err_at in (
            ("solve_iter", "poisson_iter.cu",
             "lbm_tpu/kernels/poisson_iter.py:59", solve_err,
             "phase 3b, every case"),
            ("fused_collide", "fused_step.cu",
             "lbm_tpu/kernels/collide_pallas.py:78", collide_err,
             "200x200 f64"),
            ("collide_stream_cavity", "fused_cavity.cu",
             "lbm_tpu/kernels/fused_cavity.py:1008",
             cavity_err["collide_stream_cavity"],
             "phases 6a and 6c, every case"),
            ("collide_stream_cavity_lean", "fused_cavity.cu",
             "lbm_tpu/kernels/fused_cavity.py:251",
             cavity_err["collide_stream_cavity_lean"],
             "phases 6a and 6c, every case"),
            ("collide_stream_cavity_multistep", "fused_cavity.cu",
             "lbm_tpu/kernels/fused_cavity.py:759",
             cavity_err["collide_stream_cavity_multistep"],
             "phases 6a and 6c, every case"),
            ("collide_stream_multistep", "fused_multistep.cu",
             "lbm_tpu/kernels/fused_multistep.py:504", multistep_err,
             "phase 7a f64 every mode, and the 7c holds"),
            ("collide_stream3d", "fused_step3d.cu",
             "lbm_tpu/kernels/fused_step3d.py:416", err_3d,
             "phase 8a f64, the 8b end state and the 8c holds")):
        ms, plain_ms, bound, bound_by, at = others[name]
        kernels.append({
            "name": name, "route": "cuda", "source": CSRC + source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": err, "max_abs_err_at": err_at, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
            "library_ms": None, "ms_at": at})
        if name == "fused_collide":
            # its launches on phase 16's path, the sharded plain step
            kernels[-1]["launches_sharded"] = launches[
                "fused_collide_sharded"]
    ms, plain_ms, bound, bound_by, library_ms, at = fft_times
    kernels.append({
        "name": "solve_fft_efield_tpu", "route": "cuda",
        "source": CSRC + "fft_solve.cu",
        "replaces": "lbm_tpu/kernels/fft_tpu.py:330",
        "launches": launches["solve_fft_efield_tpu"], "max_abs_err": fft_err,
        "max_abs_err_at": "phase 9a every shape, and the 9b end states",
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
        "bound_by": bound_by, "library_ms": library_ms, "ms_at": at,
        "library": "solve_fft + efield_periodic (torch.fft, cuFFT)"})
    for name, line in (("collide_stream_halo", 337),
                       ("collide_stream_halo2d", 566)):
        ms, plain_ms, bound, bound_by, at = halo_times[name]
        kernels.append({
            "name": name, "route": "cuda", "source": CSRC + "fused_step.cu",
            "replaces": f"lbm_tpu/kernels/fused_step.py:{line}",
            "launches": launches[name], "max_abs_err": halo_err[name],
            "max_abs_err_at": "phase 10a, 512x512 f64, every cut",
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": bound_by, "library_ms": None, "ms_at": at})
    for name, line in (("collide_stream_cavity_halo", 512),
                       ("collide_stream_cavity_halo_lean", 373),
                       ("collide_stream_cavity_multistep_gated", 821)):
        ms, plain_ms, bound, bound_by, at = cavity_halo_times[name]
        kernels.append({
            "name": name, "route": "cuda", "source": CSRC + "fused_cavity.cu",
            "replaces": f"lbm_tpu/kernels/fused_cavity.py:{line}",
            "launches": launches[name], "max_abs_err": cavity_halo_err[name],
            "max_abs_err_at": "phase 11a, every shard of every cut",
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": bound_by, "library_ms": None, "ms_at": at})
    for name, line in (("collide_stream_halo3d", "fused_step3d.py:301"),
                       ("collide_stream_panel3d", "fused_panel3d.py:371"),
                       ("collide_stream_panel3d_zhalo",
                        "fused_panel3d.py:502")):
        ms, plain_ms, bound, bound_by, at = halo3d_times[name]
        kernels.append({
            "name": name, "route": "cuda", "source": CSRC + "fused_step3d.cu",
            "replaces": f"lbm_tpu/kernels/{line}",
            "launches": launches[name], "max_abs_err": halo3d_err[name],
            "max_abs_err_at": "phase 12a, 64^3 f64, every shard of every cut",
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": bound_by, "library_ms": None, "ms_at": at})
    ms, plain_ms, bound, bound_by, at = gated_times
    kernels.append({
        "name": "collide_stream_multistep_gated", "route": "cuda",
        "source": CSRC + "fused_multistep.cu",
        "replaces": "lbm_tpu/kernels/fused_multistep.py:659",
        "launches": launches["collide_stream_multistep_gated"],
        "max_abs_err": gated_err,
        "max_abs_err_at": "phase 13a f64, every band and wall setting",
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
        "bound_by": bound_by, "library_ms": None, "ms_at": at})
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        sys.exit(1)
