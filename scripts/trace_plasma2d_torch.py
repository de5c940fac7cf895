#!/usr/bin/env python
"""Time the port's 2-D plasma collide kernels (the per-step collide+stream,
the collide without the stream and the K-step window) on one CUDA card,
for this checkout and, in turns, for another one.

    python scripts/trace_plasma2d_torch.py [--other DIR] [--reps N]
        [--cells TEXT ...] [--variant NAME ...]

For each checkout (this script's, and DIR: another checkout of the repo,
for example a `git archive` of the parent commit unpacked under
build/output/) it builds the kernels from that checkout's sources and
prints, for every cell, on the state one fused step in and on the state 8
steps in (the kernels' time depends on the state):

  * kernels.fused_step.collide_stream's device ms a call (CUDA events over
    N calls of one input after a warm-up) at 2048^2 f32 and bf16 +
    neutral-delta storage and at the fused_split shapes (64x8192 f32,
    64x4096 f64), and kernels.collide_pallas.fused_collide's at 2048^2 f32;
  * the 2048^2 f32 FFT fused step's ms (models.plasma.make_step, 20 steps);
  * kernels.fused_multistep's window a launch (one input repeated): 2048^2
    bf16 + delta NONE K = 32 periodic and bounce-back, the gated window on
    the band of one card (2112 x 2048), 200^2 FFT f32 and bf16 + delta
    K = 256, 256^2 NONE bf16 + delta K = 256 and 4096^2 NONE bf16 + delta
    K = 32; and the split of a window by stage: each NONE window again at
    K = 1 (decode + one step + encode), so that a step costs
    (t_K - t_1) / (K - 1) and the rest t_1 less a step; and 200^2 NONE
    windows beside the FFT ones (the DFT solve and E a step is their
    difference);
  * each cell's byte bound (f and g read and written once, 432 / 216 /
    864 B a site, plus E and rho_q, at 3.35 TB/s) and its issue floor;
  * ptxas's registers, spills and shared memory of the kernels of
    csrc/fused_step.cu (but the halo entry) and csrc/fused_multistep.cu,
    and each kernel's SASS instruction counts by class (as
    scripts/trace_plasma3d_torch.py counts them).

The issue floor is that script's model: the static SASS counts of the
per-step kernel of the cell's mode, taken as the instructions that each
thread issues for its site (a thread a site in both the parent's kernel
and the tile program), over the SMs' issue rates at the card's maximum
SM clock; a
window's is its collide stage's, the per-step kernel's of the same
arithmetic (bf16 + delta for the bf16 windows, whose work buffers are f32),
times K.

With --other, the checkouts run in the order other, this, this, other, each
in its own process. Each --variant (VARIANTS below; '+' combines) is this
checkout built from a copy of its csrc/ with one change, timed between
this checkout's two runs: the divisions or the force term's division as
products, the force term's division without its zero test, the walls'
code compiled into every kernel (one body for the periodic and the
walled window), one block an SM, runs of 64 sites, no TMA (every run by
cp.async). --cells limits the rows to those whose label holds the text.
Needs no JAX. Writes nothing but its output (and each checkout's kernel
build).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from collections import Counter

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import trace_plasma3d_torch as t3  # noqa: E402

HERE = t3.HERE
# (label, kind, (NY, NX), mode, K); kind: step, collide, model, window,
# bounce (the whole-grid bounce-back window), gated (the band of one card
# of a bounce-back grid: NY = 2048 rows extended by K a side)
CELLS = [
    ("collide_stream 2048^2 f32", "step", (2048, 2048), "f32", 0),
    ("collide_stream 2048^2 bf16+delta", "step", (2048, 2048), "bf16+delta",
     0),
    ("fused_collide 2048^2 f32", "collide", (2048, 2048), "f32", 0),
    ("collide_stream 64x8192 f32", "step", (64, 8192), "f32", 0),
    ("collide_stream 64x4096 f64", "step", (64, 4096), "f64", 0),
    ("fused step 2048^2 f32 FFT", "model", (2048, 2048), "f32", 0),
    ("window 2048^2 bf16+delta NONE K=32", "window", (2048, 2048),
     "bf16+delta", 32),
    ("window 2048^2 bf16+delta NONE bounce-back K=32", "bounce",
     (2048, 2048), "bf16+delta", 32),
    ("gated 2112x2048 bf16+delta NONE K=32", "gated", (2048, 2048),
     "bf16+delta", 32),
    ("window 200^2 FFT f32 K=256", "window", (200, 200), "f32", 256),
    ("window 200^2 NONE f32 K=256", "window", (200, 200), "f32", 256),
    ("window 200^2 FFT bf16+delta K=256", "window", (200, 200), "bf16+delta",
     256),
    ("window 200^2 NONE bf16+delta K=256", "window", (200, 200),
     "bf16+delta", 256),
    ("window 256^2 NONE bf16+delta K=256", "window", (256, 256),
     "bf16+delta", 256),
    ("window 4096^2 NONE bf16+delta K=32", "window", (4096, 4096),
     "bf16+delta", 32),
]
STATES = (1, 8)   # fused steps from the initial state
_SITE = "plasma_site.cuh"
VARIANTS = {
    # the collision's divisions as products: the force term's cu cE / cs2,
    # the bf16 forms' 1 / x, the combined thermal form's n / d
    "no-divide": [(_SITE, "div_cs2(cu * cE, p)", "cu * cE * p.cs2"),
                  (_SITE, "recip(prod[k] + dk[k])", "(prod[k] + dk[k])"),
                  (_SITE, "recip(qf[k] + dk[k])", "(qf[k] + dk[k])"),
                  (_SITE, ") / (d12 * ds[2]);", ") * (d12 * ds[2]);")],
    "no-force-divide": [(_SITE, "div_cs2(cu * cE, p)", "cu * cE * p.cs2")],
    # the force term's division without div_cs2's zero test
    "plain-divide": [(_SITE, "  return x == T(0) ? x : x / p.cs2;",
                      "  return x / p.cs2;")],
    # one block an SM: its shared memory padded past half an SM's
    "1-block": [("plasma_tile.cuh", "  static constexpr size_t kBytes = kBars + 16;",
                 "  static constexpr size_t kBytes = kBars + 16 + 120 * 1024;")],
    # runs of 64 sites (f64 32): blocks of 2 warps, six an SM
    "run64": [("plasma_tile.cuh", "constexpr int kRun2 = sizeof(S) == 8 ? 64 : 128;",
               "constexpr int kRun2 = sizeof(S) == 8 ? 32 : 64;"),
              ("fused_step.cu", "__launch_bounds__(kThreads2<S>, 3)",
               "__launch_bounds__(kThreads2<S>, 6)"),
              ("fused_multistep.cu", "__launch_bounds__(kThreads2<T>, 3)",
               "__launch_bounds__(kThreads2<T>, 6)")],
    # every run staged by cp.async
    "no-tma": [("plasma_tile.cuh", "  if ((W * sizeof(S)) % 16 ||",
                "  if (true || (W * sizeof(S)) % 16 ||")],
    # the walls' code compiled into the periodic kernels too (one body
    # for the periodic and the walled window)
    "one-body": [("fused_step.cu", "tile2_block<S, T, DELTA, FAST, false>",
                  "tile2_block<S, T, DELTA, FAST, true>"),
                 ("fused_multistep.cu", "  if (h.bounce)\n", "  if (true)\n")],
}
# the SASS template arguments of each mode: storage, compute
MANGLED = {"f64": "Idd", "f32": "Iff", "bf16+delta": "I13__nv_bfloat16f"}


def _kernel_names(name):
    return ("fused_step_cu" in name or "fused_multistep_cu" in name) and \
        "halo" not in name


def _phys(cfg):
    u = cfg.units()
    return dict(taus=cfg.taus, q_e=u.q_e, q_i=u.q_i, m_e=u.m_e, m_i=u.m_i,
                cs2=u.cs2, kb=u.kb,
                neutral_ref=u.rho_n_init if cfg.neutral_delta else 0.0)


def measure(reps: int, cells, variant):
    """This process's checkout, or its variant: the cells' ms on both
    states, the build's ptxas and SASS."""
    import torch
    from lbm_tpu_torch.config import BC, PlasmaConfig, PoissonSolver
    from lbm_tpu_torch.kernels import (build, collide_pallas, fused_multistep,
                                       fused_step)
    from lbm_tpu_torch.models import plasma

    dev = torch.device("cuda")
    if variant:
        build.CSRC = t3.patched_csrc(variant, VARIANTS)
    lib = str(build.build())
    log = open(os.path.join(os.path.dirname(lib), "build.log")).read()
    res = {"ptxas": t3.ptxas(log, _kernel_names),
           "sass": {k: dict(v) for k, v in
                    t3.sass_counts(lib, _kernel_names).items()},
           "cells": {}}
    fm = fused_multistep
    for label, kind, (ny, nx), mode, K in CELLS:
        if cells and not any(c in label for c in cells):
            continue
        solver = PoissonSolver.FFT if "FFT" in label else PoissonSolver.NONE
        bounce = kind in ("bounce", "gated")
        cfg = PlasmaConfig(
            NX=nx, NY=ny, dtype=torch.float64 if mode == "f64"
            else torch.float32, storage="bf16" if mode.startswith("bf16")
            else "native", neutral_delta=mode.endswith("delta"),
            poisson=solver if kind == "model" or K else PoissonSolver.FFT,
            bc=BC.BOUNCE_BACK if bounce else BC.PERIODIC, backend="fused")
        phys = _phys(cfg)
        wkw = plasma.multistep_kwargs(cfg) if K else None
        out = {}
        for steps in STATES:
            st = plasma.init_state(cfg, dev)
            step = plasma.make_step(cfg)
            for _ in range(steps):
                st = step(st)
            args = (st.f, st.g, st.Ex, st.Ey)
            r = {}
            if kind == "step":
                r["ms"] = t3.device_ms(
                    lambda: fused_step.collide_stream(*args, **phys), reps)
            elif kind == "collide":
                r["ms"] = t3.device_ms(
                    lambda: collide_pallas.fused_collide(*args, **phys), reps)
            elif kind == "model":
                box = [st]

                def adv():
                    box[0] = step(box[0])
                r["ms"] = t3.device_ms(adv, 20)
            else:
                if kind == "gated":
                    gkw = {k: v for k, v in wkw.items()
                           if k not in ("bounce", "solve_fft", "solve_iter")}
                    band, walls = fm.window_inputs(args, slice(0, ny), K)

                    def launch(k):
                        return lambda: fm.collide_stream_multistep_gated(
                            *band, walls, k_steps=k, **gkw)
                else:
                    def launch(k):
                        return lambda: fm.collide_stream_multistep(
                            *args, st.phi, k_steps=k, **wkw)
                wreps = max(2, reps // (4 if nx * K >= 2048 * 32 else 2))
                r["ms"] = t3.device_ms(launch(K), wreps)
                if solver == PoissonSolver.NONE:
                    r["ms_k1"] = t3.device_ms(launch(1), reps)
            out[f"{steps} step{'s' if steps > 1 else ''} in"] = r
            del st, args
            torch.cuda.empty_cache()
        p = 8 if mode == "f64" else (2 if mode.startswith("bf16") else 4)
        e = 8 if mode == "f64" else 4
        rows = ny + 2 * K if kind == "gated" else ny
        res["cells"][label] = {"runs": out, "sites": rows * nx, "K": K,
                               "mode": mode, "kind": kind,
                               "bytes_ms": rows * nx * (108 * p + 3 * e)
                               / t3.HBM_BYTES_PER_S * 1e3}
    return res


def _floor(sass, cell, clock):
    """(issue floor ms, class, all-instructions ms) of a cell, from the
    per-step kernel of its arithmetic: the tile program's
    plasma_tiles_kernel<S, T, DELTA, FAST>, or the parent's
    collide_stream_kernel<S, T, DELTA, FAST, STREAM>."""
    mode = cell["mode"]
    b = lambda on: "Lb1E" if on else "Lb0E"   # noqa: E731
    args = MANGLED[mode] + b(mode.endswith("delta")) + b(mode.startswith("bf16"))
    want = (f"plasma_tiles_kernel{args}E",
            f"collide_stream_kernel{args}{b(cell['kind'] != 'collide')}E")
    fns = [fn for fn in sass if any(w in fn for w in want)]
    if not fns:
        return None
    t = t3.issue_ms(Counter(sass[fns[0]]), 1 / 32,
                    cell["sites"] * max(cell["K"], 1), clock)
    cls = max(("fp32", "fp64", "mufu"), key=t.get)
    return t[cls], cls, t["all"]


def report(name: str, runs, clock: float):
    first = runs[0]
    print(f"== {name}")
    for fn, info in sorted(first["ptxas"].items()):
        print(f"  ptxas {fn[:90]}: {info}")
    for fn, c in sorted(first["sass"].items()):
        print(f"  SASS {fn[:90]}: " + ", ".join(
            f"{k} {c.get(k, 0)}" for k in ("all", "fp32", "fp64", "mufu",
                                           "lds", "sts", "ldg", "stg")))
    for label, cell in first["cells"].items():
        fl = _floor(first["sass"], cell, clock)
        floor = "not found" if fl is None else (
            f"{fl[0]:.4f} ms ({fl[1]}; all instructions {fl[2]:.4f})")
        print(f"  {label}: byte bound {cell['bytes_ms']:.4f} ms; issue floor "
              f"{floor}")
        for state in cell["runs"]:
            times = [r["cells"][label]["runs"][state]["ms"] for r in runs]
            line = f"    {state}: " + ", ".join(f"{t:.4f}" for t in times) \
                + " ms"
            k1 = [r["cells"][label]["runs"][state].get("ms_k1") for r in runs]
            K = cell["K"]
            if k1[0] is not None and K > 1:
                per = [(t - a) / (K - 1) for t, a in zip(times, k1)]
                line += ("; K = 1: " + ", ".join(f"{a:.4f}" for a in k1)
                         + " ms; a step " + ", ".join(f"{x:.4f}" for x in per)
                         + " ms; decode + encode + launch "
                         + ", ".join(f"{a - x:.4f}" for a, x in zip(k1, per))
                         + " ms")
            print(line)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", default=None,
                    help="another checkout of the repo, timed in turns")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--cells", action="append", default=[],
                    help="time only the cells whose label holds this text "
                         "(repeatable)")
    ap.add_argument("--variant", action="append", default=[],
                    metavar="NAME[+NAME]",
                    help="also time this build variant of this checkout "
                         "(VARIANTS; '+' combines), between its two runs "
                         "(repeatable)")
    ap.add_argument("--measure", action="store_true",
                    help="measure the checkout on PYTHONPATH; print JSON")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("trace_plasma2d_torch: no CUDA device", file=sys.stderr)
        return 1
    if args.measure:
        print(json.dumps(measure(args.reps, args.cells,
                                 args.variant[0] if args.variant else None)))
        return 0
    print(t3.card_line())
    clock = t3.max_sm_clock_hz()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}; max SM "
          f"clock {clock / 1e6:.0f} MHz")
    this = ("this checkout", HERE, None)
    order = [this, *((f"variant {v}", HERE, v) for v in args.variant), this]
    if args.other:
        path = os.path.abspath(args.other)
        other = (os.path.relpath(path, HERE), path, None)
        order = [other, *order, other]
    runs = {}
    for name, path, variant in order:
        try:
            runs.setdefault(name, []).append(t3.run_checkout(
                path, args.reps, args.cells, variant, script=__file__))
        except RuntimeError as e:
            if not variant:
                raise
            print(f"== {name}: {str(e)[-1500:]}")
    for name, found in runs.items():
        if found:
            report(name, found, clock)
    print(t3.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
