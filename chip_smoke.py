#!/usr/bin/env python
"""Smoke test of the PyTorch/CUDA port (lbm_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's paths on the card and fails (nonzero exit) if any
phase fails:

  1. environment: nvidia-smi's name and power limit, torch, CUDA, nvcc;
  2. build: compiles the CUDA kernels from lbm_tpu_torch/kernels/csrc;
  3. kernel vs plain: one collide_stream call each way on the same seeded
     state, at 37x53 and 200x200, in f64, f32 and bf16 storage, with and
     without neutral-delta storage, each within its stated tolerance;
  3b. solve kernel vs plain sweeps: GS, SOR (omega 1.8) and NPS, interior-
     only and periodic, f64 and f32, at 37x53, 200x200 and 1024x1024, with
     tol 0 / 60 sweeps and with tol 1e-8 / max 5000 sweeps on the rho_q of
     a step, and a phi0 holding a NaN: phi and the sweep count bitwise;
  3c. collide-only kernel vs its plain version: f64 and f32, with and
     without neutral-delta storage, at 37x53 and 200x200, at phase 3's
     tolerances;
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
  5b. real sizes of the other solvers and walls: 1024^2 f32 SOR +
     bounce-back + delta (fused), 256^2 f32 GS (fused), 4096^2 bf16 + delta
     NONE (fused), 2048^2 f32 FFT (pallas); ms/step, MLUPS, each kernel's
     ms and its plain version's, sweeps per solve; the state must stay
     finite;
  6a. cavity kernels vs their plain versions: stored, lean and multistep
     (K = 1, 4, 17 from step 8, across the lid ramp) on a seeded state
     warmed past the ramp, f64, f32 and bf16 storage, at 37x53 and
     129x129; bitwise, or for stored and lean within the ladder f64 1e-12
     relative, f32 4 ulp, bf16 f one bf16 ulp (multistep bitwise only);
  6b. Ghia: lbm_tpu_torch.run_cavity.main at 129^2, Re = 100, u_lid = 0.1,
     10,000 steps, stored f32 and f64, lean f32, multistep 100 f32, each
     within the gate of tests/test_cavity.py (max|du| < 0.035, rms < 0.02,
     max|dv| < 0.02, rms < 0.01), one launch a step (a window for
     multistep); f64 mass drift < 1e-12;
  6c. cavity real sizes: bench.py's legs (1000^2 lean f32 and bf16 stored,
     512^2 multistep 256, 2048^2 multistep 32) and 2048^2 stored and lean
     f32; ms/step, MLUPS, each kernel's device ms (chained as the rollout
     chains it, and repeated on one input) beside its plain version's and
     its bound; the state must stay finite.
  7a. the K-step window kernel vs its plain version on a seeded state, in
     every mode (NONE periodic with and without the quirk, NONE and FFT
     under bounce-back, FFT + periodic, GS periodic with and without the
     Dirichlet-sweep quirk, SOR + bounce-back, NPS periodic; 60 sweeps),
     f64, f32 and bf16 + delta, K = 1, 4, 17, at 37x53 and 200x200;
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
     ms/step, MLUPS, device ms a launch, the plain version's ms, the bound.
Phase 3 also holds collide_stream at the fused_split shapes (64x8192 f32,
64x4096 f64), where the JAX package needs its split kernel pair.

    python3 chip_smoke.py --only 3,7    # phases 1-2 and the listed ones

The line before the last is a JSON object {"kernels": [...]}: for each
kernel its launch count on its CLI run (phase 4, 4b, 6b or 7b, counts
reset before the run), its worst error against its plain version, its time
beside the plain version's and beside its bound at the main path's
shapes. The last line is {"ok": true, "device": {...}}; with --only, no
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
    # float32 products stay in full float32 (the port has no matmuls or
    # convolutions on its path; stated for the record)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


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
    atol is per species for (3, Q, NY, NX) populations."""
    import torch
    g64, w64 = got.double(), want.double()
    err = (g64 - w64).abs()
    if bf16_ulp:
        mag = torch.maximum(g64.abs(), w64.abs()).float()
        exp = torch.frexp(mag).exponent.double()
        allowed = torch.where(mag == 0, torch.zeros_like(err),
                              torch.exp2(exp - 8.0))
    else:
        if w64.dim() == 4:
            scale = w64.abs().amax(dim=(1, 2, 3), keepdim=True)
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


def phase_solve_kernel():
    """Phase 3b; returns the worst max|err| (0: every case is bitwise)."""
    import torch
    from lbm_tpu_torch.config import PlasmaConfig
    from lbm_tpu_torch.kernels import fused_step, poisson_iter
    from lbm_tpu_torch.ops import poisson

    print("== phase 3b: solve kernel vs plain sweeps, bitwise")
    device = torch.device("cuda")
    kinds = [("gs", None), ("gs", 1.8), ("nps", None)]
    for ny, nx in ((37, 53), (200, 200), (1024, 1024)):
        for dtype in (torch.float64, torch.float32):
            rng = np.random.default_rng(ny * nx)
            rho = 0.1 * rng.random((ny, nx))
            rho -= rho.mean()
            seeded = (torch.as_tensor(0.05 * rng.random((ny, nx)),
                                      dtype=dtype, device=device),
                      torch.as_tensor(rho, dtype=dtype, device=device))
            # the rho_q of a step from a seeded state, solved from phi = 0
            cfg = PlasmaConfig(NX=nx, NY=ny, dtype=dtype, neutral_delta=True)
            st = _seeded_state(cfg, device, seed=ny + nx, warm_steps=1)
            rho_q = fused_step.collide_stream(st.f, st.g, st.Ex, st.Ey,
                                              **phys_of(cfg))[2]
            runs = [("seeded", seeded, 60, 0.0),
                    ("step", (torch.zeros_like(rho_q), rho_q), 5000, 1e-8)]
            if (ny, nx) == (37, 53):
                nan_phi = seeded[0].clone()
                nan_phi[ny // 2, nx // 2] = float("nan")
                runs.append(("NaN", (nan_phi, seeded[1]), 5000, 1e-8))
            line = []
            for kind, omega in kinds:
                for interior in (False, True):
                    for label, (phi0, rq), max_iter, tol in runs:
                        spec = (kind, omega, max_iter, tol, interior)
                        got = poisson_iter.solve_iter(phi0, rq, spec=spec)
                        n_kernel = int(poisson_iter.LAST_SWEEPS)
                        want = poisson_iter.solve_iter_reference(phi0, rq,
                                                                 spec=spec)
                        n_plain = poisson.LAST_SWEEPS
                        tag = (f"{kind}{'' if omega is None else '-sor'}/"
                               f"{'int' if interior else 'per'}/{label}")
                        name = f"{ny}x{nx} {dtype} {tag}"
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
            print(f"{ny}x{nx} {str(dtype)[6:]}: bitwise; sweeps "
                  + ", ".join(line))
    return 0.0


def phase_collide_kernel():
    from lbm_tpu_torch.kernels import collide_pallas, fused_step

    print("== phase 3c: collide-only kernel vs plain version on the card")
    return _collide_vs_plain(collide_pallas.fused_collide,
                             fused_step.collide_reference,
                             [m for m in COLLIDE_MODES if m[2] == "native"])


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
                               "--out", os.path.join(OUT, "golden")])
    launches = fused_step.LAUNCHES
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
    from lbm_tpu_torch.run_plasma import KERNELS
    for mod in KERNELS.values():
        mod.LAUNCHES = 0


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
            os.path.join(OUT, f"sor_bb_{backend}")])
        require(runs[backend]["finite"], f"{backend}: state not finite")
        sweeps[backend] = (poisson.LAST_SWEEPS if backend == "plain"
                           else int(poisson_iter.LAST_SWEEPS))
    want_launches = {
        "fused": {"collide_stream": steps, "fused_collide": 0,
                  "solve_iter": steps, "collide_stream_multistep": 0},
        "pallas": {"collide_stream": 0, "fused_collide": steps,
                   "solve_iter": steps, "collide_stream_multistep": 0},
        "plain": {"collide_stream": 0, "fused_collide": 0, "solve_iter": 0,
                  "collide_stream_multistep": 0}}
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
            bound = 444 * n * n / HBM_BYTES_PER_S * 1e3
            parts.append(f"fused_collide {ms:.4f} ms (bound {bound:.4f} ms; "
                         f"plain {plain_ms:.4f} ms)")
            out.setdefault("fused_collide", (ms, plain_ms, bound, "bytes",
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
            parts.append(f"solve_iter {ms:.4f} ms for {sweeps} sweeps "
                         f"({1e3 * ms / max(sweeps, 1):.3f} us/sweep; bound "
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
    """(least ms, "bytes" or "operations") of one launch."""
    t_bytes = (_cavity_bytes_per_site(kernel, f_itemsize, c_itemsize)
               * sites / HBM_BYTES_PER_S * 1e3)
    flop_rate = F64_FLOP_PER_S if c_itemsize == 8 else F32_FLOP_PER_S
    t_ops = CAVITY_FLOP * k_steps * sites / flop_rate * 1e3
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


def phase_cavity_kernels():
    """Phase 6a: the three cavity kernels against their plain versions on
    the same seeded states; returns each kernel's worst max|err|."""
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
                                 " ", "_"))] + flags)
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
        # previous one's output
        box = [args]

        def chained():
            a = box[0]
            if K:
                box[0] = (run(*a, **kw), a[1] + K)
            elif lean:
                box[0] = (run(*a, **kw), a[1])
            else:
                box[0] = (*run(*a, **kw), a[4])

        ms = _device_ms(chained, reps)
        plain_ms = _time_ms(lambda: plain(*args, **kw), plain_reps)
        bound, bound_by = _cavity_bound_ms(kind, n * n, f.element_size(), 4,
                                           max(K, 1))
        per = f" ({ms / K:.4f} ms a step)" if K else ""
        print(f"{label}: {step_ms:.4f} ms/step, "
              f"{n * n / (step_ms * 1e-3) / 1e6:.1f} MLUPS (window {warm}+"
              f"{steps} steps); {kernel} vs plain on the end state: "
              + ("; ".join(notes) if notes else "bitwise equal")
              + f"; {ms:.4f} ms a launch chained{per}; bound {bound:.4f} ms "
              f"by {bound_by} ({100 * bound / ms:.1f}% of chained); plain "
              f"{plain_ms:.4f} ms")
        if n == 2048:
            out[kernel] = (ms, plain_ms, bound, bound_by,
                           "2048x2048 f32 chained" + (f" K={K}" if K else ""))
        del state, f, args, box
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

    print("== phase 7a: window kernel vs plain version, K = 1, 4, 17")
    device = torch.device("cuda")
    worst_f64 = 0.0
    for ny, nx in ((37, 53), (200, 200)):
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
                for k in (1, 4, 17):
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
                               os.path.join(OUT, "golden_multistep")])
    launches = summary["launches"]
    want = {"collide_stream": 0, "fused_collide": 0, "solve_iter": 0,
            "collide_stream_multistep": 25}
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


def _multistep_bound_ms(n, k_steps, storage, fft):
    """(least ms, "bytes" or "operations") of one window at n x n f32
    compute: the JAX kernel's 1,500 flop a site and step for the collision
    plus the DFT solve as the kernel computes it, at the non-tensor f32
    rate, or f and g read and written once."""
    flop = (1500 * n * n + (_dft_flop(n, n) if fft else 0)) * k_steps
    t_ops = flop / F32_FLOP_PER_S * 1e3
    t_bytes = BYTES_PER_SITE[storage] * n * n / HBM_BYTES_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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
        bound, bound_by = _multistep_bound_ms(n, K, storage, kw["solve_fft"])
        print(f"{label}: {step_ms:.4f} ms/step, "
              f"{n * n / (step_ms * 1e-3) / 1e6:.1f} MLUPS (window "
              f"{K}+{(windows - 1) * K} steps); "
              + (("vs plain on the end state: " + ("; ".join(notes) if notes
                                                   else "bitwise equal")
                  + "; ") if hold else "")
              + f"{ms:.4f} ms a launch chained ({ms / K:.4f} ms a step); "
              f"bound {bound:.4f} ms by {bound_by} ({100 * bound / ms:.1f}% "
              f"of chained); plain {plain_ms:.1f} ms (1 call, K={k_plain}, "
              f"{plain_ms / k_plain:.2f} ms a step)")
        if label == "2048^2 NONE bf16+delta K=32":
            out = (ms, plain_ms, bound, bound_by,
                   f"2048x2048 bf16+delta NONE K={K}, a launch chained")
        del state, args, box
        torch.cuda.empty_cache()
    return out, worst



def main(argv=None) -> int:
    import argparse
    import torch
    ap = argparse.ArgumentParser(description="Smoke test of lbm_tpu_torch "
                                 "on one NVIDIA GPU (see the module doc).")
    ap.add_argument("--only", default=None, metavar="3,4,5,6,7",
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
        "bound_ms": 444 * n * n / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
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
             "phase 7a f64 every mode, and the 7c holds")):
        ms, plain_ms, bound, bound_by, at = others[name]
        kernels.append({
            "name": name, "route": "cuda", "source": CSRC + source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": err, "max_abs_err_at": err_at, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
            "library_ms": None, "ms_at": at})
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
