#!/usr/bin/env python
"""Trace the port's two Poisson-solve kernels on one CUDA card.

    python scripts/trace_poisson_torch.py

Imports lbm_tpu_torch from the checkout that holds this script (copy it
into another checkout's scripts/ to trace that one), builds its kernels and
prints, for the spectral solve (kernels.fft_tpu.solve_fft_efield_tpu) at
2048^2 and 4096^2 f32 and for the iterative solve
(kernels.poisson_iter.solve_iter) at 1024^2 f32 SOR, 256^2 f32 GS, 1024^2
f64 SOR and 2048^2 f32 SOR (interior-only, 2000 sweeps, tol 0):

  * each device kernel's time a call, from torch.profiler;
  * each kernel's registers, spills and static shared memory, from the
    build log's ptxas -v lines;
  * the hardware counters (DRAM and L2 bytes, global sectors per request,
    shared-memory bank conflicts, achieved occupancy) through
    torch.profiler's CUPTI metrics, where the machine allows them, else
    "not measured";
  * the library route (solve_fft + efield_periodic, cuFFT) timed the same
    way, and each solve's bound;
  * a model of both designs of the spectral solve (the one before and
    the radix-16 one), computed from their code's shapes, not measured:
    the bytes each pass moves, the shared-memory bank conflicts a
    warp-wide access meets in each round of a line, and the theoretical
    occupancy from the registers, threads and shared memory of a block;
  * the card's name and power limit.

Needs no JAX. Writes nothing but its output.
"""
from __future__ import annotations

import os
import re
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

METRICS = ["dram__bytes_read.sum", "dram__bytes_write.sum",
           "lts__t_bytes.sum",
           "l1tex__t_sectors_pipe_lsu_mem_global_op_ld.sum",
           "l1tex__t_requests_pipe_lsu_mem_global_op_ld.sum",
           "l1tex__data_bank_conflicts_pipe_lsu_mem_shared.sum",
           "sm__warps_active.avg.pct_of_peak_sustained_active"]


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def per_kernel_ms(fn, reps):
    """{device kernel name: ms a call} from a torch.profiler trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", 0) or 0
        if us and ev.count:
            out[ev.key[:90]] = us / 1e3 / reps
    return out


def counters(fn):
    """{kernel: {metric: value}} from CUPTI's range profiler, or the error
    that kept it from running."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    try:
        cfg = torch.profiler._ExperimentalConfig(
            profiler_metrics=METRICS, profiler_measure_per_kernel=True)
        with profile(activities=[ProfilerActivity.CUDA],
                     experimental_config=cfg) as prof:
            fn()
            torch.cuda.synchronize()
    except Exception as e:  # noqa: BLE001 - any refusal means "not measured"
        return f"not measured ({type(e).__name__}: {str(e)[:120]})"
    found = {}
    for ev in prof.events():
        extra = getattr(ev, "extra_fields", None) or {}
        vals = {m: extra[m] for m in METRICS if m in extra}
        if vals:
            found[ev.name[:60]] = vals
    return found or "not measured (the trace holds no counter values)"


def _rounds(n, max_m):
    """(lq, M) of each forward round of a 2^n-point line."""
    out, lh = [], n - 1
    while lh >= 0:
        m = min(lh + 1, max_m)
        out.append((lh - m + 1, m))
        lh -= m
    return out


def bank_conflicts(N, lines, max_m):
    """[(q, M, worst, mean)]: the ways a warp's shared-memory access of one
    element of its work items is split into, in each round of an N-point
    transform held as `lines` lines (pad one word every 32, odd line
    stride: the layout of both designs)."""
    n = N.bit_length() - 1
    pad = lambda p: p + (p >> 5)  # noqa: E731
    ls = pad(N) + 1
    res = []
    for lq, M in _rounds(n, max_m):
        P, q, litems = 1 << M, 1 << lq, n - M
        items = lines << litems
        degs = []
        for w0 in range(0, items, 32):
            for k in range(P):
                banks = {}
                for t in range(w0, min(w0 + 32, items)):
                    l, j = t >> litems, t & ((1 << litems) - 1)
                    a = l * ls + pad(((j >> lq) << (lq + M)) + (j & (q - 1))
                                     + k * q)
                    banks.setdefault(a % 32, set()).add(a)
                degs.append(max(len(v) for v in banks.values()))
        res.append((q, M, max(degs), sum(degs) / len(degs)))
    return res


def occupancy(regs, threads, smem):
    """Blocks an SM and the share of its 64 warps they hold (regs rounded
    to 8 a thread, 1 KB of shared memory reserved a block)."""
    regs = -(-regs // 8) * 8
    blocks = min(32, 2048 // threads, 65536 // (regs * threads),
                 (228 * 1024) // (smem + 1024) if smem else 32)
    return blocks, blocks * threads / 2048


def model_fft(n):
    """The two designs' passes at n x n f32, from their code."""
    def lines_bytes(lines, N):
        return 2 * lines * (N + N // 32 + 1) * 4
    sites = n * n
    print(f"model, spectral solve {n}^2 (computed from the code, not "
          f"measured):")
    # before: radix 2, three stages a round, 512 threads; K1 R rows of
    # complex lines, K2 P-column panels of a row-major scratch; after:
    # radix 16, 256 threads, K1 2R rows a block in R complex lines
    def panel(min_panel):
        p = 1
        while 2 * p <= n and 2 * p <= 16 and lines_bytes(2 * p, n) <= 68 * 1024:
            p *= 2
        while p < min_panel and lines_bytes(2 * p, n) <= 227 * 1024:
            p *= 2
        return p
    r = 1
    while 2 * r <= n and 2 * r * n <= 4096:
        r *= 2
    p, p_new = panel(4), panel(2)
    r_new = 1
    while 4 * r_new <= n and 2 * r_new * n <= 8192:
        r_new *= 2
    for name, pas in (
            ("before", [("rows_forward", 4 + 8, lines_bytes(r, n), 64, 512,
                         n // r, r, 3),
                        ("cols_solve", 8 + 8, lines_bytes(p, n), 63, 512,
                         n // p, p, 3),
                        ("rows_inverse", 8 + 8, lines_bytes(r, n), 52, 512,
                         n // r, r, 3)]),
            ("radix 16", [("rows_forward_pair", 4 + 8,
                           lines_bytes(r_new, n), 88, 256, n // (2 * r_new),
                           r_new, 4),
                          ("panel_solve", 8 + 8, lines_bytes(p_new, n), 85,
                           256, n // p_new, p_new, 4),
                          ("rows_inverse_tiled", 8 + 8,
                           lines_bytes(r_new, n), 80, 256, n // r_new, r_new,
                           4)])):
        for kname, bps, smem, regs, threads, blocks, lines, max_m in pas:
            bl, occ = occupancy(regs, threads, smem)
            conf = bank_conflicts(n, lines, max_m)
            print(f"  {name} {kname}: {bps} B/site = "
                  f"{bps * sites / 1e6:.1f} MB ({bps * sites / 3.35e12 * 1e3:.4f}"
                  f" ms at 3.35 TB/s); {blocks} blocks of {threads} threads,"
                  f" {smem} B shared, {regs} registers (ptxas): {bl} blocks "
                  f"an SM, occupancy {100 * occ:.0f}%, "
                  f"{blocks / (bl * 132):.2f} waves; bank conflicts a round "
                  f"(q, radix, worst, mean ways): "
                  + ", ".join(f"({q}, {1 << m}, {w}, {a:.2f})"
                              for q, m, w, a in conf))
    print(f"  before, cols_solve: a warp's load covers {32 // p} rows x {p}"
          f" columns of the row-major complex scratch: {32 // p} sectors a "
          f"request, {4 * p} B of each 32-B sector used by one of its two "
          f"4-byte loads (re, im); radix 16, panel_solve: one contiguous "
          f"run, 8 sectors of 32 B a request of 8-byte loads, all used")


def ptxas_lines(names):
    from lbm_tpu_torch.kernels import build
    log = (build.build().parent / "build.log").read_text().splitlines()
    keep, cur = [], None
    for line in log:
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = m.group(1)
            continue
        if cur and any(n in cur for n in names) and re.search(
                r"Used \d+ registers|spill", line):
            keep.append(f"{cur[:70]}: {line.split('ptxas info    :')[-1].strip()}")
    return keep


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("trace_poisson_torch: no CUDA device", file=sys.stderr)
        return 1
    from lbm_tpu_torch.kernels import fft_tpu, poisson_iter
    from lbm_tpu_torch.ops import poisson
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(card_line())
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, checkout "
          f"{HERE}")
    for line in ptxas_lines(("rows_", "cols_", "panel_", "solve_iter_kernel",
                             "solve_tiled_kernel", "fft")):
        print("  ptxas:", line)
    for n in (2048, 4096):
        rng = np.random.default_rng(n)
        rho = torch.as_tensor(rng.standard_normal((n, n)) * 1e-8,
                              dtype=torch.float32, device=dev)
        fn = lambda: fft_tpu.solve_fft_efield_tpu(rho)  # noqa: E731
        ks = per_kernel_ms(fn, 20)
        lib = per_kernel_ms(lambda: poisson.efield_periodic(
            poisson.solve_fft(rho)), 20)
        print(f"spectral solve {n}^2 f32: " + "; ".join(
            f"{k} {v:.4f} ms" for k, v in ks.items())
            + f" (sum {sum(ks.values()):.4f} ms; bound "
            f"{12 * n * n / 3.35e12 * 1e3:.4f} ms by 12 B/site); library "
            f"solve_fft + efield_periodic {sum(lib.values()):.4f} ms in "
            f"{len(lib)} kernels")
        print(f"  counters: {counters(fn)}")
        model_fft(n)
    cells = [("1024^2 f32 SOR", 1024, torch.float32, ("gs", 1.8)),
             ("256^2 f32 GS", 256, torch.float32, ("gs", None)),
             ("1024^2 f64 SOR", 1024, torch.float64, ("gs", 1.8)),
             ("2048^2 f32 SOR", 2048, torch.float32, ("gs", 1.8))]
    for label, n, dtype, (kind, omega) in cells:
        rng = np.random.default_rng(n)
        rho = 0.1 * rng.random((n, n))
        rho = torch.as_tensor(rho - rho.mean(), dtype=dtype, device=dev)
        phi0 = torch.zeros_like(rho)
        sweeps = 2000
        spec = (kind, omega, sweeps, 0.0, True)
        fn = lambda: poisson_iter.solve_iter(phi0, rho, spec=spec)  # noqa
        ks = per_kernel_ms(fn, 3)
        total = sum(ks.values())
        flop = (11 if omega is not None else 8) * n * n * sweeps
        rate = 67e12 if dtype == torch.float32 else 34e12
        print(f"iterative solve {label}, {sweeps} sweeps: " + "; ".join(
            f"{k} {v:.4f} ms" for k, v in ks.items())
            + f" ({1e3 * total / sweeps:.3f} us a sweep; flop bound "
            f"{1e6 * flop / rate / sweeps:.3f} us a sweep)")
        if hasattr(poisson_iter, "path"):
            way = poisson_iter.path(n, n, dtype, True, kind)
            line = f"  path: {way}"
            if way == "tiled":
                floor = per_kernel_ms(lambda: poisson_iter.sweep_floor(
                    n, n, dtype, kind, True, sweeps, dev), 3)
                line += (f"; barrier floor (the loop's grid barriers, no "
                         f"stencil) {1e3 * sum(floor.values()) / sweeps:.3f}"
                         f" us a sweep")
            print(line)
        print(f"  counters: {counters(fn)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
