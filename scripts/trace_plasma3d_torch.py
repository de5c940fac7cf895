#!/usr/bin/env python
"""Time the port's D3Q19 collide+stream kernels on one CUDA card, for this
checkout and, in turns, for another one.

    python scripts/trace_plasma3d_torch.py [--other DIR] [--reps N]
        [--cells TEXT ...] [--variant NAME ...]

For each checkout (this script's, and DIR: another checkout of the repo,
for example a `git archive` of the parent commit unpacked under
build/output/) it builds the kernels from that checkout's sources and
prints:

  * kernels.fused_step3d.collide_stream3d's device ms a call (CUDA events
    over N calls after a warm-up) at 256^3 f32, 256^3 bf16 + neutral-delta
    storage and 128^3 f64, on the state after one fused step, and at 256^3
    bf16 + delta and 128^3 f32 + delta after 8 (the kernel's time depends
    on the state);
  * the halo entry's (kernels.fused_panel3d.collide_stream_shard3d) at the
    shard shapes of a 256^3 column on one card (z, y and (dz, dy) tile
    geometry, 256^3 each) and on four (64x256x256 z, 256x64x256 y,
    128x128x256 tile), f32 and bf16 + delta;
  * each row's byte bound (928 / 472 / 1856 B a shard site plus the
    strips' 117 values a site, at 3.35 TB/s) and its issue floor;
  * ptxas's registers, spills and shared memory of every kernel of
    csrc/fused_step3d.cu (the build log), and each kernel's SASS
    instruction counts (cuobjdump -sass of the built library) by class:
    FP32, FP64 and MUFU (the transcendental unit: reciprocals), shared and
    global loads and stores, and all.

The issue floor of a row is a model, not a measurement: the static SASS
counts of the kernel's body by class, taken as the instructions that each
thread issues for its site (one thread a site) or its (site, species)
task (the tile program: 3 W + 6 tasks a run of W sites, W = 64, f64 32),
over the SMs' issue rates at the card's maximum SM clock: 4
warp-instructions a clock an SM for FP32, 2 for FP64, 0.5 for MUFU; the
floor is the largest of those three times, and the same count of all
instructions at 4 a clock is printed beside it. Branches not taken (the
division's slow path; in the tile program, whose species is known only at
run time, the other species' forms and the unaligned route) make the
counts high, loops that run more than once (the tile's copies and stores)
low.

With --other, the checkouts run in the order other, this, this, other, each
in its own process, so that a difference between them shows beside the
spread of one checkout's two runs. Each --variant is this checkout built
from a copy of its csrc/ with the edits VARIANTS names (the direction loop
rolled, the collision or the divisions taken out, other block shapes),
timed between this checkout's two runs; --cells limits the rows to those
whose label holds the text. Needs no
JAX. Writes nothing but its output (and each checkout's kernel build).
"""
from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
from collections import Counter

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HBM_BYTES_PER_S = 3.35e12
SMS = 132
# warp-instructions a clock an SM (Hopper): FP32, FP64, MUFU, and all
ISSUE_RATES = {"fp32": 4.0, "fp64": 2.0, "mufu": 0.5, "all": 4.0}
CLASSES = {
    "fp32": {"FADD", "FMUL", "FFMA", "FSETP", "FSET", "FMNMX", "FSEL", "FCHK"},
    "fp64": {"DADD", "DMUL", "DFMA", "DSETP", "DMNMX"},
    "mufu": {"MUFU"},
    "lds": {"LDS", "LDSM"},
    "sts": {"STS"},
    "ldg": {"LDG", "LDGSTS", "UBLKCP", "UTMALDG"},
    "stg": {"STG"},
}
N = 256
# (label, shape (NZ, NY, NX), mode, geometry: None the periodic step, else
# (slices, rows) of the 256^3 column, None for a whole axis; fused steps
# from the initial state: 1, or 8 where the label says so, as chip_smoke.py
# phase 8c times its cells after 2 + 6)
CELLS = [
    ("collide_stream3d 256^3 f32", (N, N, N), "f32", None),
    ("collide_stream3d 256^3 bf16+delta", (N, N, N), "bf16+delta", None),
    ("collide_stream3d 128^3 f64", (128, 128, 128), "f64", None),
    ("collide_stream3d 256^3 bf16+delta, 8 steps in", (N, N, N), "bf16+delta",
     None),
    ("collide_stream3d 128^3 f32+delta, 8 steps in", (128, 128, 128),
     "f32+delta", None),
    ("halo z 256^3 f32", (N, N, N), "f32", ((0, N), None)),
    ("halo y 256^3 f32", (N, N, N), "f32", (None, (0, N))),
    ("halo tile 256^3 f32", (N, N, N), "f32", ((0, N), (0, N))),
    ("halo z 64x256x256 f32", (N, N, N), "f32", ((0, N // 4), None)),
    ("halo y 256x64x256 f32", (N, N, N), "f32", (None, (0, N // 4))),
    ("halo tile 128x128x256 f32", (N, N, N), "f32",
     ((0, N // 2), (0, N // 2))),
    ("halo z 64x256x256 bf16+delta", (N, N, N), "bf16+delta",
     ((0, N // 4), None)),
    ("halo y 256x64x256 bf16+delta", (N, N, N), "bf16+delta",
     (None, (0, N // 4))),
    ("halo tile 128x128x256 bf16+delta", (N, N, N), "bf16+delta",
     ((0, N // 2), (0, N // 2))),
]
# build variants of this checkout, for finding what holds the kernel: each
# a list of (file in csrc/, text, replacement) applied to a copy of the
# sources; the variants that change the arithmetic are for timing only
_LOOP = ("plasma3d_site.cuh", "#pragma unroll\n  for (int i = 0; i < kQ3; ++i) {\n"
         "    if (!need(i)) continue;\n")
VARIANTS = {
    # the direction loop rolled: ~1/6 of the code, more instructions run
    "unroll1": [(_LOOP[0], _LOOP[1], _LOOP[1].replace("unroll", "unroll 1"))],
    # pass 2 copies f and g through: staging, pass 1, barriers and stores
    "no-collide": [(_LOOP[0], _LOOP[1],
                    "for (int i = 0; i < kQ3; ++i)\n    if (need(i)) emit(i, "
                    "Io<S, T>::load(fs + i * pitch), Io<S, T>::load(gs + i * "
                    "pitch));\n  for (int i = 0; i < 0; ++i) {\n")],
    # the x-neighbours' values not loaded (zeros)
    "no-neighbours": [("plasma3d_tile.cuh", "nb.pop[k] = pop_src3(u, q)[x];",
                       "nb.pop[k] = S();"),
                      ("plasma3d_tile.cuh",
                       "nb.fld[k] = fld_src3(u, q - kPlanes3)[x];",
                       "nb.fld[k] = T();")],
    # the divisions of pass 2's loop as products
    "no-divide": [("plasma3d_site.cuh", "cu * cE / cs2", "cu * cE * cs2"),
                  ("plasma3d_site.cuh", "recip(qf[k] + dk[k])",
                   "(qf[k] + dk[k])"),
                  ("plasma3d_site.cuh", ") / (d12 * ds[2]);",
                   ") * (d12 * ds[2]);")],
    # 7 warps a block in every mode (f32 and f64 take 8: the 8th idle in
    # the passes)
    "224-threads": [("plasma3d_tile.cuh",
                     "kThreads3 = sizeof(S) == 2 ? 3 * kRun3<S> + 32 : 4 * kRun3<S>;",
                     "kThreads3 = 3 * kRun3<S> + 32;")],
    # one division at a time as a product: the force term's cu cE / cs2,
    # the thermal terms' 1 / (qf + 2r) (bf16) or n / d, and -(rho u^2) / kb
    "no-force-divide": [("plasma3d_site.cuh", "cu * cE / cs2", "cu * cE * cs2")],
    # the reciprocals 1 / x as divisions
    "divide": [("plasma_site.cuh", "  return __frcp_rn(x);", "  return 1.0f / x;"),
               ("plasma_site.cuh", "  return __drcp_rn(x);", "  return 1.0 / x;")],
    # the register cap of 2 blocks of 224 threads (144), not
    # __launch_bounds__'s 128
    "maxnreg": [("fused_step3d.cu",
                 "template <typename S, typename T, bool DELTA, bool FAST>\n"
                 "__global__ void __launch_bounds__(kThreads3<S>, 2)",
                 "template <typename S>\nconstexpr int kMaxReg3 = 65536 / (2 * "
                 "kThreads3<S>) / 8 * 8 < 255 ? 65536 / (2 * kThreads3<S>) / 8 "
                 "* 8 : 255;\ntemplate <typename S, typename T, bool DELTA, "
                 "bool FAST>\n__global__ void __maxnreg__(kMaxReg3<S>)")],
    # runs of 32 sites in every mode: 128 threads, 4 blocks an SM (f64 2)
    "run32": [("plasma3d_tile.cuh",
               "constexpr int kRun3 = sizeof(S) == 8 ? 32 : 64;",
               "constexpr int kRun3 = 32;"),
              ("fused_step3d.cu", "__launch_bounds__(kThreads3<S>, 2)",
               "__launch_bounds__(kThreads3<S>, sizeof(S) == 8 ? 2 : 4)")],
    # no branch a direction: every direction collided, the store guarded
    "no-need": [("plasma3d_site.cuh", "    if (!need(i)) continue;\n", ""),
                ("plasma3d_tile.cuh",
                 "          Io<S, T>::store(out + (s * kQ3 + i) * W + o, fo);\n"
                 "          Io<S, T>::store(out + ((kS + s) * kQ3 + i) * W + o, go);",
                 "          if (o >= 0 && o < w) {\n"
                 "          Io<S, T>::store(out + (s * kQ3 + i) * W + o, fo);\n"
                 "          Io<S, T>::store(out + ((kS + s) * kQ3 + i) * W + o, go);}")],
    # one block an SM: no register cap
    "1-block": [("fused_step3d.cu", "__launch_bounds__(kThreads3<S>, 2)",
                 "__launch_bounds__(kThreads3<S>, 1)")],
}
# the SASS template arguments of each mode: storage, compute
MANGLED = {"f64": "Idd", "f32": "Iff", "f32+delta": "Iff",
           "bf16+delta": "I13__nv_bfloat16f"}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def max_sm_clock_hz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.split()[0]
    return float(out) * 1e6


def _kernel_names(name):
    return "plasma3d" in name or "collide_stream3d" in name or \
        "halo3d" in name


def ptxas(log: str, keep=_kernel_names):
    """{entry: 'N registers, S B shared, spills'} of the kernels whose
    mangled names `keep` accepts (default: the 3-D kernels)."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = m.group(1) if keep(m.group(1)) else None
            continue
        if cur is None:
            continue
        info = line.split("ptxas info    :")[-1].strip()
        if "spill" in line:
            out.setdefault(cur, []).append(info)
        elif re.search(r"Used \d+ registers", line):
            out.setdefault(cur, []).append(info)
    return {k: "; ".join(v) for k, v in out.items()}


def sass_counts(lib: str, keep=_kernel_names):
    """{function: Counter of opcode classes} from cuobjdump -sass, for the
    functions whose mangled names `keep` accepts."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    text = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True, timeout=600).stdout
    out, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = m.group(1) if keep(m.group(1)) else None
            if cur:
                out[cur] = Counter()
            continue
        if cur is None:
            continue
        m = re.search(
            r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if not m:
            continue
        op = m.group(1).split(".")[0]
        out[cur]["all"] += 1
        for cls, ops in CLASSES.items():
            if op in ops:
                out[cur][cls] += 1
    return out


def issue_ms(counts: Counter, per_site: float, sites: int, clock: float):
    """{class: ms}: sites x per_site x count warp-instructions of each class
    over its issue rate."""
    return {cls: sites * per_site * counts.get(cls, 0) / (rate * SMS * clock)
            * 1e3 for cls, rate in ISSUE_RATES.items()}


def patched_csrc(name: str, variants=None):
    """A copy of this checkout's csrc/ with variants[name] applied (default
    VARIANTS; '+' combines), under the build directory."""
    variants = VARIANTS if variants is None else variants
    from lbm_tpu_torch.kernels import build
    out = build.BUILD_ROOT / "variants" / name
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(build.CSRC, out)
    for fname, old, new in (e for v in name.split("+")
                            for e in variants[v]):
        path = out / fname
        text = path.read_text()
        if text.count(old) != 1:
            raise RuntimeError(f"variant {name}: {old!r} not found once in "
                               f"{fname}")
        path.write_text(text.replace(old, new))
    return out


def device_ms(fn, reps: int) -> float:
    """CUDA events over reps calls of fn after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def measure(reps: int, cells, variant):
    """This process's checkout, or its variant: the cells' ms, the build's
    ptxas and SASS."""
    import torch
    from lbm_tpu_torch.config import PlasmaConfig
    from lbm_tpu_torch.kernels import build, fused_panel3d, fused_step3d
    from lbm_tpu_torch.models import plasma3d

    dev = torch.device("cuda")
    if variant:
        build.CSRC = patched_csrc(variant)
    lib = str(build.build())
    log = open(os.path.join(os.path.dirname(lib), "build.log")).read()
    res = {"ptxas": ptxas(log), "sass": {k: dict(v) for k, v in
                                         sass_counts(lib).items()},
           "cells": {}}

    state = {}
    for label, (nz, ny, nx), mode, geom in CELLS:
        if cells and not any(c in label for c in cells):
            continue
        steps = 8 if label.endswith("8 steps in") else 1
        key = (nz, mode, steps)
        if key not in state:
            state.clear()
            torch.cuda.empty_cache()
            storage = "bf16" if mode.startswith("bf16") else "native"
            cfg = PlasmaConfig(
                NX=nx, NY=ny, NZ=nz, storage=storage,
                dtype=torch.float64 if mode == "f64" else torch.float32,
                neutral_delta=mode.endswith("delta"), backend="fused")
            u = cfg.units()
            phys = dict(taus=cfg.taus, q_e=u.q_e, q_i=u.q_i, m_e=u.m_e,
                        m_i=u.m_i, cs2=u.cs2, kb=u.kb,
                        neutral_ref=u.rho_n_init if cfg.neutral_delta
                        else 0.0)
            st = plasma3d.init_state(cfg, dev)
            step = plasma3d.make_step(cfg)
            for _ in range(steps):
                st = step(st)
            state[key] = ((st.f, st.g, st.Ex, st.Ey, st.Ez), phys)
        arrays, phys = state[key]
        f, ex = arrays[0], arrays[2]
        p, e = f.element_size(), ex.element_size()
        if geom is None:
            ms = device_ms(lambda: fused_step3d.collide_stream3d(*arrays,
                                                                 **phys),
                           reps)
            sites, edge, ext = nz * ny * nx, 0, nz * ny * nx
        else:
            zs, ys = (None if c is None else slice(*c) for c in geom)
            strips = fused_step3d.halo_inputs3d(arrays, zs, ys)
            ms = device_ms(lambda: fused_panel3d.collide_stream_shard3d(
                *strips, **phys), reps)
            shard, zhalo, yrows, corners = strips
            sites = shard[2].numel()
            edge = sum(grp[2].numel() for grp in (*(zhalo or ()),
                                                  *(yrows or ()),
                                                  *(corners or ())))
            ext = sites + edge
            del strips, shard, zhalo, yrows, corners
            torch.cuda.empty_cache()
        nbytes = sites * (228 * p + 4 * e) + edge * (114 * p + 3 * e)
        res["cells"][label] = {"ms": ms, "sites": sites, "ext": ext,
                               "bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                               "mode": mode,
                               "halo": geom is not None}
    return res


def run_checkout(path: str, reps: int, cells, variant=None, script=__file__):
    """`script --measure` (its measure()) in a process of its own,
    importing `path`'s package; returns its JSON."""
    r = subprocess.run([sys.executable, os.path.abspath(script),
                        "--measure", "--reps", str(reps),
                        *(f"--cells={c}" for c in cells),
                        *([f"--variant={variant}"] if variant else [])],
                       cwd=path, capture_output=True, text=True,
                       timeout=1800,
                       env=dict(os.environ, PYTHONPATH=path))
    if r.returncode != 0:
        raise RuntimeError(f"{path}: measure failed:\n{r.stderr[-3000:]}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def report(name: str, runs, clock: float):
    first = runs[0]
    print(f"== {name}")
    for fn, info in sorted(first["ptxas"].items()):
        print(f"  ptxas {fn[:80]}: {info}")
    for fn, c in sorted(first["sass"].items()):
        print(f"  SASS {fn[:80]}: " + ", ".join(
            f"{k} {c.get(k, 0)}" for k in ("all", "fp32", "fp64", "mufu",
                                           "lds", "sts", "ldg", "stg")))
    for label, cell in first["cells"].items():
        times = [r["cells"][label]["ms"] for r in runs]
        mangled = MANGLED[cell["mode"]]
        delta = "Lb1E" if cell["mode"].endswith("delta") else "Lb0E"
        fns = [fn for fn in first["sass"]
               if mangled + delta in fn and (
                   "tiles" in fn or ("halo" in fn) == cell["halo"])]
        floor = "not found"
        if fns:
            # threads a site: one, or the tile's (3 W + 6) tasks a run of W
            run = 32 if cell["mode"] == "f64" else 64
            per_site = ((3 * run + 6) / run if "tiles" in fns[0] else 1) / 32
            t = issue_ms(Counter(first["sass"][fns[0]]), per_site,
                         cell["ext"], clock)
            cls = max(("fp32", "fp64", "mufu"), key=t.get)
            floor = (f"{t[cls]:.4f} ms ({cls}; all instructions "
                     f"{t['all']:.4f})")
        print(f"  {label}: " + ", ".join(f"{t:.4f}" for t in times)
              + f" ms; byte bound {cell['bytes_ms']:.4f} ms; issue floor "
              f"{floor}")


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
        print("trace_plasma3d_torch: no CUDA device", file=sys.stderr)
        return 1
    if args.measure:
        print(json.dumps(measure(args.reps, args.cells,
                                 args.variant[0] if args.variant else None)))
        return 0
    print(card_line())
    clock = max_sm_clock_hz()
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
            runs.setdefault(name, []).append(
                run_checkout(path, args.reps, args.cells, variant))
        except RuntimeError as e:
            if not variant:
                raise
            print(f"== {name}: {str(e)[-1500:]}")
    for name, found in runs.items():
        if found:
            report(name, found, clock)
    print(card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
