#!/usr/bin/env python
"""Smoke test of the PyTorch/CUDA port (lbm_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path, the golden plasma run, on the card and
fails (nonzero exit) if any phase fails:

  1. environment: nvidia-smi's name and power limit, torch, CUDA, nvcc;
  2. build: compiles the CUDA kernels from lbm_tpu_torch/kernels/csrc;
  3. kernel vs plain: one collide_stream call each way on the same seeded
     state, at 37x53 and 200x200, in f64, f32 and bf16 storage, with and
     without neutral-delta storage, each within its stated tolerance;
  4. golden run: lbm_tpu_torch.run_plasma.main at 200x200 for 200 steps in
     f64 through the kernel; its 19 probe series must match the compiled
     C++ reference fixture at rtol 1e-5 / atol 1e-5*scale, with exactly
     one kernel launch per step;
  5. real size: 2048^2 in f32 and in bf16 + neutral-delta storage, 5 warm-up
     and 30 timed steps (CUDA events); the state must stay finite.

The line before the last is a JSON object {"kernels": [...]} with each
kernel's launch count on the golden run, its worst error against its plain
version there, and its time beside the plain version's at 2048^2 f32; the
last line is {"ok": true, "device": {...}}. Needs no JAX.
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
KERNEL_SOURCE = "lbm_tpu_torch/kernels/csrc/fused_step.cu"
KERNEL_REPLACES = "lbm_tpu/kernels/fused_step.py:685"
BYTES_PER_SITE = {"native": 432, "bf16": 216}   # f+g read and write


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


def phase_kernel_vs_plain():
    import torch
    from lbm_tpu_torch.config import PlasmaConfig
    from lbm_tpu_torch.kernels import fused_step

    print("== phase 3: kernel vs plain version on the card")
    device = torch.device("cuda")
    modes = [  # (label, dtype, storage, neutral_delta, rtol, atol*scale)
        ("f64", torch.float64, "native", False, 1e-12, 1e-14),
        ("f64+delta", torch.float64, "native", True, 1e-12, 1e-14),
        ("f32", torch.float32, "native", False, 1e-5, 1e-6),
        ("f32+delta", torch.float32, "native", True, 1e-5, 1e-6),
        ("bf16", torch.float32, "bf16", False, None, None),
        ("bf16+delta", torch.float32, "bf16", True, None, None),
    ]
    golden_err = None
    for ny, nx in ((37, 53), (200, 200)):
        for label, dtype, storage, delta, rtol, atol in modes:
            cfg = PlasmaConfig(NX=nx, NY=ny, dtype=dtype, storage=storage,
                               neutral_delta=delta, backend="fused")
            u = cfg.units()
            phys = dict(taus=cfg.taus, q_e=u.q_e, q_i=u.q_i, m_e=u.m_e,
                        m_i=u.m_i, cs2=u.cs2, kb=u.kb,
                        neutral_ref=u.rho_n_init if delta else 0.0)
            st = _seeded_state(cfg, device, seed=ny * 1000 + nx)
            args = (st.f, st.g, st.Ex, st.Ey)
            k_out = fused_step.collide_stream(*args, **phys)
            p_out = fused_step.collide_stream_reference(*args, **phys)
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
            ms = _time_ms(lambda: fused_step.collide_stream(*args, **phys), 20)
            plain_ms = _time_ms(
                lambda: fused_step.collide_stream_reference(*args, **phys), 5)
            print(f"{label:>10} {ny}x{nx}: " + "; ".join(line)
                  + f"; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
            if (ny, nx, label) == (200, 200, "f64"):
                golden_err = worst_abs
    return golden_err


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


def main() -> int:
    import torch
    phase_environment()
    phase_build()
    golden_err = phase_kernel_vs_plain()
    launches = phase_golden()
    timings = phase_real_size()
    print(card_line())
    print(json.dumps({"kernels": [{
        "name": "collide_stream", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": launches,
        "max_abs_err": golden_err, "max_abs_err_at": "200x200 f64",
        "ms": timings["native"], "plain_ms": timings["plain"],
        "ms_at": "2048x2048 f32"}]}))
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
