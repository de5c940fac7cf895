#!/usr/bin/env python
"""Time the port's cavity kernels on one CUDA card, for this checkout and,
in turns, for another one.

    python scripts/trace_cavity_torch.py [--other DIR] [--reps N]
        [--cells TEXT ...] [--variant NAME ...]

For each checkout (this script's, and DIR: another checkout of the repo,
for example a `git archive` of the parent commit unpacked under
build/output/) it builds the kernels from that checkout's sources and
prints, for every cell, the device ms a launch (CUDA events over N
launches after a warm-up) on two states, because the kernels' time depends
on the state:

  * "from rest": the rest state rolled forward through the fused kernels
    (20 steps, or one window), then N launches chained, each on the one
    before's output, as a rollout runs them; most of a large cavity is
    still at rest then, where velocities and many f - feq are exact zeros;
  * "seeded": 12 plain steps with a seeded ~1e-3 relative perturbation of
    the populations and the stored macros (made on the card), where no
    value is an exact zero, then N launches chained likewise.

The cells (kernels.fused_cavity; CELLS below): collide_stream_cavity at
2048^2 f32 and bf16 and 129^2 f32 / f64; collide_stream_cavity_lean at
2048^2 f32 and bf16; the y-shard kernels _halo and _halo_lean at 2048^2
(a world of one) and on the 512x2048 shard of a 4-card cut, f32 and bf16
(one input repeated); the window collide_stream_cavity_multistep at
2048^2 f32 K = 32, 512^2 f32 K = 256 and 129^2 f32 / f64 K = 100, with
the route it takes (window_route); the gated window on the bands of one
card (2112 x 2048) and of a 4-card shard (576 x 2048), f32 K = 32; and the
129^2 f32 rollout with multistep 100 as the CLI runs it (ms a step, 10,000
steps). Beside each: its byte bound (96 / 60 / 72 / 36 B a site a launch
at 3.35 TB/s; a window's f read and written once), and its issue floor.

The issue floor is scripts/trace_plasma3d_torch.py's model: the static
SASS counts by class of the kernel that runs the cell (the step program's
cavity_step_kernel<S, T, LEAN>, which holds one copy of the collision and
one of the pull; a window's lean step kernel of its arithmetic, times K),
taken as the instructions a thread issues for its site, over the SMs'
issue rates at the card's maximum SM clock: a lower bound, since the
sites that the tasks collide again are not counted. ptxas's registers,
spills and shared memory and the SASS counts of every kernel of
csrc/fused_cavity.cu are printed.

With --other, the checkouts run in the order other, this, this, other, each
in its own process. Each --variant (VARIANTS below; '+' combines) is this
checkout built from a copy of its csrc/ with one change, timed between this
checkout's two runs: no-zero-test (div_pos without its zero test: the
plain IEEE division), zero-test-everywhere (the resident route with it
too), no-divide (the divisions as products), no-edge-warp
(the step blocks without their extra warp), streaming-only (the
window's resident route off), res512 (its f32 blocks at 512 threads
holding 8 sites each), occ10 / occ12 (the step kernels held to 10 or 12
blocks an SM), 1-block (one block an SM), w64 (strips of 64 sites, 32 in
f64), span1 / span2x (spans of one row / twice the plan's). --cells limits the rows to those whose label holds the text.
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
# (label, kind, (NY, NX), dtype, storage, K[, (y0, y1)]); kind: stored,
# lean, halo, halo_lean, window, gated, rollout (the multistep rollout, ms
# a step). The halo and gated kinds run on the shard of rows [y0, y1) of
# the NY x NX grid (all rows if not given), the halo kernels on one input
# repeated, the gated window on the shard's band (its rows extended by K a
# side) chained; (512, 1024) is the second shard of a 4-card cut.
CELLS = [
    ("collide_stream_cavity 2048^2 f32", "stored", (2048, 2048), "float32",
     "native", 0),
    ("collide_stream_cavity 2048^2 bf16", "stored", (2048, 2048), "float32",
     "bf16", 0),
    ("collide_stream_cavity_lean 2048^2 f32", "lean", (2048, 2048),
     "float32", "native", 0),
    ("collide_stream_cavity_lean 2048^2 bf16", "lean", (2048, 2048),
     "float32", "bf16", 0),
    ("collide_stream_cavity_halo 2048^2 f32", "halo", (2048, 2048),
     "float32", "native", 0),
    ("collide_stream_cavity_halo_lean 2048^2 f32", "halo_lean", (2048, 2048),
     "float32", "native", 0),
    ("collide_stream_cavity_halo_lean 2048^2 bf16", "halo_lean",
     (2048, 2048), "float32", "bf16", 0),
    ("collide_stream_cavity_halo 512x2048 f32", "halo", (2048, 2048),
     "float32", "native", 0, (512, 1024)),
    ("collide_stream_cavity_halo 512x2048 bf16", "halo", (2048, 2048),
     "float32", "bf16", 0, (512, 1024)),
    ("collide_stream_cavity_halo_lean 512x2048 f32", "halo_lean",
     (2048, 2048), "float32", "native", 0, (512, 1024)),
    ("collide_stream_cavity_halo_lean 512x2048 bf16", "halo_lean",
     (2048, 2048), "float32", "bf16", 0, (512, 1024)),
    ("collide_stream_cavity 129^2 f32", "stored", (129, 129), "float32",
     "native", 0),
    ("collide_stream_cavity 129^2 f64", "stored", (129, 129), "float64",
     "native", 0),
    ("window 2048^2 f32 K=32", "window", (2048, 2048), "float32", "native",
     32),
    ("gated 2112x2048 f32 K=32", "gated", (2048, 2048), "float32", "native",
     32),
    ("gated 576x2048 f32 K=32", "gated", (2048, 2048), "float32", "native",
     32, (512, 1024)),
    ("window 512^2 f32 K=256", "window", (512, 512), "float32", "native",
     256),
    ("window 129^2 f32 K=100", "window", (129, 129), "float32", "native",
     100),
    ("window 129^2 f64 K=100", "window", (129, 129), "float64", "native",
     100),
    ("rollout 129^2 f32 multistep 100", "rollout", (129, 129), "float32",
     "native", 100),
]
STATES = ("from rest", "seeded")
_SITE, _TILE, _CU = "cavity_site.cuh", "cavity_tile.cuh", "fused_cavity.cu"
VARIANTS = {
    # div_pos without its zero test everywhere (the plain IEEE division),
    # with it everywhere (the resident route too), and as a product
    "no-zero-test": [(_SITE, "  if constexpr (ZERO) return x == T(0) ? x "
                      ": x / d;\n", "")],
    "zero-test-everywhere": [(_TILE, "collide_site<T, false>(",
                              "collide_site<T, true>(")],
    "no-divide": [(_SITE, "  return x / d;\n}", "  return x * d;\n}"),
                  (_SITE, "return x == T(0) ? x : x / d;", "return x * d;")],
    "streaming-only": [(_TILE, "  if (K < 2 || nb < 1 || chunk < 1) return p;",
                        "  if (true) return p;")],
    # the step program's blocks without their extra warp: two threads
    # collide the strip's edge columns after their own sites
    "no-edge-warp": [(_CU, "constexpr int kStepThreads = kRunC<T> + 32;",
                      "constexpr int kStepThreads = kRunC<T>;")],
    # the step and streaming kernels held to 10 or 12 blocks an SM (a
    # register cap of 40 or 34 at 160 threads)
    "occ10": [(_CU, "__launch_bounds__(kStepThreads<T>)\n    cavity_step_kernel(",
               "__launch_bounds__(kStepThreads<T>, 10)\n    cavity_step_kernel("),
              (_CU, "__launch_bounds__(kStepThreads<T>)\n    cavity_stream_window",
               "__launch_bounds__(kStepThreads<T>, 10)\n    cavity_stream_window")],
    "occ12": [(_CU, "__launch_bounds__(kStepThreads<T>)\n    cavity_step_kernel(",
               "__launch_bounds__(kStepThreads<T>, 12)\n    cavity_step_kernel("),
              (_CU, "__launch_bounds__(kStepThreads<T>)\n    cavity_stream_window",
               "__launch_bounds__(kStepThreads<T>, 12)\n    cavity_stream_window")],
    # a persistent grid of one block an SM
    "1-block": [(_CU, "  f.resident = static_cast<int64_t>(per_sm) * f.sms;",
                 "  f.resident = per_sm > 0 ? f.sms : 0;")],
    # spans of one row (every task collides its rows above and below again:
    # 3x the collisions, the most tasks), or twice the plan's span (half
    # the tasks, fewer rows collided again)
    "span1": [(_TILE, "  p.span = static_cast<int>(per < NY ? per : NY);",
               "  p.span = 1;")],
    "span2x": [(_TILE, "  p.span = static_cast<int>(per < NY ? per : NY);",
                "  p.span = static_cast<int>(2 * per < NY ? 2 * per : NY);")],
    "w64": [(_TILE, "constexpr int kRunC = sizeof(T) == 8 ? 64 : 128;",
             "constexpr int kRunC = sizeof(T) == 8 ? 32 : 64;")],
    # the resident route at 512 threads a block holding 8 sites each (f32)
    "res512": [(_TILE, "constexpr int kResThreads = sizeof(T) == 8 ? 512 : 1024;",
                "constexpr int kResThreads = 512;"),
               (_TILE, "constexpr int kHold = sizeof(T) == 8 ? 2 : 4;",
                "constexpr int kHold = sizeof(T) == 8 ? 2 : 8;")],
}
MANGLED = {"float64": "Idd", "float32": "Iff", "bf16": "I13__nv_bfloat16f"}


def _kernel_names(name):
    return "cavity" in name and "kernel" in name


def _bytes_ms(kind, sites, f_size, c_size):
    """The byte bound of one launch: f (and in stored mode the macros) read
    and written once; a window's f once for the whole window."""
    per = 2 * 9 * f_size + (2 * 3 * c_size if kind in ("stored", "halo")
                            else 0)
    return per * sites / t3.HBM_BYTES_PER_S * 1e3


def device_ms(fn, reps: int) -> float:
    """CUDA events over reps calls of fn after one warm-up call; the card
    first spins ~25 ms so that the host has queued the launches before the
    timed window opens (a step is shorter than its launch's host time)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(50_000_000)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def measure(reps: int, cells, variant):
    """This process's checkout, or its variant: the cells' ms on both
    states, the routes, the build's ptxas and SASS."""
    import dataclasses

    import torch
    from lbm_tpu_torch.config import CavityConfig
    from lbm_tpu_torch.kernels import build
    from lbm_tpu_torch.kernels import fused_cavity as fc
    from lbm_tpu_torch.models import cavity

    dev = torch.device("cuda")
    if variant:
        build.CSRC = t3.patched_csrc(variant, VARIANTS)
    lib = str(build.build())
    log = open(os.path.join(os.path.dirname(lib), "build.log")).read()
    res = {"ptxas": t3.ptxas(log, _kernel_names),
           "sass": {k: dict(v) for k, v in
                    t3.sass_counts(lib, _kernel_names).items()},
           "cells": {}}

    def seeded(cfg, seed):
        plain = dataclasses.replace(cfg, backend="plain", lean_macros=False,
                                    multistep=0)
        st = cavity.make_rollout(plain, 12)(cavity.init_state(plain, dev))
        gen = torch.Generator(device=dev).manual_seed(seed)

        def perturb(t, additive=0.0):
            a = t.double()
            noise = torch.randn(a.shape, generator=gen, device=dev,
                                dtype=torch.float64)
            return (a * (1.0 + 1e-3 * noise) + additive * noise).to(cfg.dtype)

        f = cavity.encode_f(cfg, perturb(cavity.decode_f(cfg, st.f)))
        return st._replace(f=f.contiguous(), rho=perturb(st.rho),
                           ux=perturb(st.ux, 1e-4), uy=perturb(st.uy, 1e-4))

    for label, kind, (ny, nx), dtype, storage, K, *shard in CELLS:
        if cells and not any(c in label for c in cells):
            continue
        ys = slice(*shard[0]) if shard else slice(0, ny)
        cfg = CavityConfig(NX=nx, NY=ny, dtype=getattr(torch, dtype),
                           storage=storage, backend="fused",
                           lean_macros=kind != "stored",
                           multistep=K if kind in ("window", "rollout")
                           else 0)
        tau, kw = cfg.tau, dict(u_lid=cfg.u_lid, sigma=cfg.sigma)
        out = {}
        for state in STATES:
            if state == "from rest":
                st = cavity.make_rollout(cfg, max(K, 20))(
                    cavity.init_state(cfg, dev))
            else:
                st = seeded(cfg, ny * 1000 + nx)
            u = cavity._lid_speed(cfg, st.step)
            box = [st]
            r = {}
            if kind == "rollout":
                roll = cavity.make_rollout(cfg, 10_000)
                r["ms"] = t3.device_ms(lambda: roll(box[0]), 1) / 10_000
            elif kind == "stored":
                def chained():
                    s = box[0]
                    f, rho, ux, uy = fc.collide_stream_cavity(
                        s.f, s.rho, s.ux, s.uy, u, tau=tau)
                    box[0] = s._replace(f=f, rho=rho, ux=ux, uy=uy)
                r["ms"] = device_ms(chained, reps)
            elif kind == "lean":
                def chained():
                    box[0] = box[0]._replace(f=fc.collide_stream_cavity_lean(
                        box[0].f, u, tau=tau))
                r["ms"] = device_ms(chained, reps)
            elif kind in ("halo", "halo_lean"):
                mac = (st.rho, st.ux, st.uy) if kind == "halo" else None
                args, walls = fc.halo_inputs(st.f, mac, ys)
                run = getattr(fc, "collide_stream_cavity_" + kind)
                r["ms"] = device_ms(lambda: run(*args, u, *walls, tau=tau),
                                       reps)
                del args
            elif kind == "window":
                def chained():
                    s = box[0]
                    box[0] = s._replace(
                        f=fc.collide_stream_cavity_multistep(
                            s.f, s.step, tau=tau, k_steps=K, **kw),
                        step=s.step + K)
                r["ms"] = device_ms(chained, max(2, reps // 4))
            else:   # gated: the band of one card, chained on the band
                block, walls = fc.window_inputs(st.f, ys, K)
                bx = [block]

                def chained():
                    out_ = fc.collide_stream_cavity_multistep_gated(
                        bx[0], 8, walls, tau=tau, k_steps=K, **kw)
                    bx[0] = out_
                r["ms"] = device_ms(chained, max(2, reps // 4))
                del block, bx
            out[state] = r
            del st, box
            torch.cuda.empty_cache()
        route = None
        if kind in ("window", "gated") and hasattr(fc, "window_route"):
            rows = ys.stop - ys.start + (2 * K if kind == "gated" else 0)
            probe = torch.empty((9, rows, nx), dtype=(
                torch.bfloat16 if storage == "bf16" else cfg.dtype),
                device=dev)
            route = fc.window_route(probe, K)
            del probe
        f_size = 2 if storage == "bf16" else (8 if dtype == "float64" else 4)
        c_size = 8 if dtype == "float64" else 4
        rows = ys.stop - ys.start + (2 * K if kind == "gated" else 0)
        res["cells"][label] = {
            "runs": out, "sites": rows * nx, "K": K, "kind": kind,
            "dtype": dtype, "storage": storage, "route": route,
            "bytes_ms": _bytes_ms(kind, rows * nx, f_size, c_size)}
    return res


def _floor(sass, cell, clock):
    """(issue floor ms, class, all-instructions ms) of a cell, from the
    step kernel of its arithmetic (lean for the windows and halo_lean),
    times K for a window. The kernel holds one copy of the collision (one
    call of collide_row) and of the pull and store, each counted once a
    site: the edge columns and span ends collided again are left out, so
    the floor stays below the work."""
    mangled = MANGLED["bf16" if cell["storage"] == "bf16" else cell["dtype"]]
    lean = cell["kind"] not in ("stored", "halo")
    want = f"cavity_step_kernel{mangled}Lb{int(lean)}E"
    fns = [fn for fn in sass if want in fn]
    if not fns:
        return None
    steps = max(cell["K"], 1) if cell["kind"] != "rollout" else 1
    t = t3.issue_ms(Counter(sass[fns[0]]), 1 / 32, cell["sites"] * steps,
                    clock)
    cls = max(("fp32", "fp64", "mufu"), key=t.get)
    return t[cls], cls, t["all"]


def report(name: str, runs, clock: float):
    first = runs[0]
    print(f"== {name}")
    for fn, info in sorted(first["ptxas"].items()):
        print(f"  ptxas {fn[:100]}: {info}")
    for fn, c in sorted(first["sass"].items()):
        print(f"  SASS {fn[:100]}: " + ", ".join(
            f"{k} {c.get(k, 0)}" for k in ("all", "fp32", "fp64", "mufu",
                                           "lds", "sts", "ldg", "stg")))
    for label, cell in first["cells"].items():
        fl = _floor(first["sass"], cell, clock)
        floor = "not found" if fl is None else (
            f"{fl[0]:.4f} ms ({fl[1]}; all instructions {fl[2]:.4f})")
        route = f"; route {cell['route']}" if cell.get("route") else ""
        unit = "ms a step" if cell["kind"] == "rollout" else "ms a launch"
        print(f"  {label}: byte bound {cell['bytes_ms']:.4f} ms; issue floor "
              f"{floor}{route}")
        for state in cell["runs"]:
            times = [r["cells"][label]["runs"][state]["ms"] for r in runs]
            print(f"    {state}: " + ", ".join(f"{t:.4f}" for t in times)
                  + f" {unit}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", default=None,
                    help="another checkout of the repo, timed in turns")
    ap.add_argument("--reps", type=int, default=40)
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
        print("trace_cavity_torch: no CUDA device", file=sys.stderr)
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
