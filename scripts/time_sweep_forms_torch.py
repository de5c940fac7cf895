#!/usr/bin/env python
"""Time the two forms of the iterative Poisson sweeps' neighbour sums on
one CUDA card: four (eight for the 9-point stencil) torch.roll copies of
phi, against one padded copy of phi (ops/poisson._wrap) read through
strided slices (_nb5_padded, _nb_diag_padded).

    python scripts/time_sweep_forms_torch.py            # 2048^2 f32
    python scripts/time_sweep_forms_torch.py --device cpu --n 64 --sweeps 20

For each single-device solve of ops/poisson (GS and SOR interior-only, the
bounce-back case, and NPS periodic), both forms run the same colour passes
(_gs_pass, _nps_pass) and the same host loop (_iterate) for a fixed number
of sweeps (tol 0), in turns roll, padded, padded, roll, --pairs times
over, after one warm-up solve of each. Prints each solve's ms, the median
ms a solve of each form, whether the two forms' phi agree bit for bit, and
the card's name and power limit. Needs no JAX. Writes nothing but its
output.
"""
from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def roll_nb5(phi):
    """JAX's four rolls, summed in their order."""
    import torch
    return (torch.roll(phi, 1, dims=1) + torch.roll(phi, -1, dims=1)
            + torch.roll(phi, 1, dims=0) + torch.roll(phi, -1, dims=0))


def roll_diag(phi):
    """JAX's four diagonal rolls, summed in their order."""
    import torch
    return (torch.roll(phi, (1, 1), dims=(0, 1))
            + torch.roll(phi, (1, -1), dims=(0, 1))
            + torch.roll(phi, (-1, 1), dims=(0, 1))
            + torch.roll(phi, (-1, -1), dims=(0, 1)))


def solvers(rho_q, sweeps):
    """{(solver, form): solve(phi0) -> phi}."""
    import torch
    from lbm_tpu_torch.ops import poisson as P

    NY, NX = rho_q.shape
    dev = rho_q.device
    red, black = (torch.as_tensor(m, device=dev)
                  for m in P._checker_masks(NX, NY, True))
    colours = [torch.as_tensor(m, device=dev)
               for m in P._four_color_masks(NX, NY, False)]
    twenty = torch.tensor(20.0, dtype=rho_q.dtype, device=dev)

    def padded_nb5(phi):
        return P._nb5_padded(P._wrap(phi))

    def gs(nb5, omega):
        def sweep(phi):
            phi, e1 = P._gs_pass(phi, nb5(phi), rho_q, red, omega)
            phi, e2 = P._gs_pass(phi, nb5(phi), rho_q, black, omega)
            return phi, torch.maximum(e1, e2)
        return lambda phi0: P._iterate(phi0, sweep, sweeps, 0.0)

    def nps(padded):
        def sweep(phi):
            err = torch.zeros((), dtype=phi.dtype, device=dev)
            for mask in colours:
                if padded:
                    p = P._wrap(phi)
                    nb5, diag = P._nb5_padded(p), P._nb_diag_padded(p)
                else:
                    nb5, diag = roll_nb5(phi), roll_diag(phi)
                phi, e = P._nps_pass(phi, nb5, diag, rho_q, mask, twenty)
                err = torch.maximum(err, e)
            return phi, err
        return lambda phi0: P._iterate(phi0, sweep, sweeps, 0.0)

    return {("GS", "roll"): gs(roll_nb5, None),
            ("GS", "padded"): gs(padded_nb5, None),
            ("SOR", "roll"): gs(roll_nb5, 1.8),
            ("SOR", "padded"): gs(padded_nb5, 1.8),
            ("NPS", "roll"): nps(False),
            ("NPS", "padded"): nps(True)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=2048)
    ap.add_argument("--f64", action="store_true")
    ap.add_argument("--sweeps", type=int, default=200)
    ap.add_argument("--pairs", type=int, default=3)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    dtype = torch.float64 if args.f64 else torch.float32
    rng = np.random.default_rng(20)
    rho_q = torch.from_numpy(rng.standard_normal((args.n, args.n))).to(
        dtype=dtype, device=args.device)
    phi0 = torch.zeros_like(rho_q)
    sync = (torch.cuda.synchronize if args.device == "cuda"
            else (lambda: None))

    def timed(solve):
        sync()
        t0 = time.perf_counter()
        phi = solve(phi0)
        sync()
        return phi, 1e3 * (time.perf_counter() - t0)

    if args.device == "cuda":
        print(card_line())
    print(f"{args.n}^2 {str(dtype).split('.')[-1]}, {args.sweeps} sweeps a "
          f"solve, order roll, padded, padded, roll x {args.pairs}")
    table = solvers(rho_q, args.sweeps)
    for solver in ("GS", "SOR", "NPS"):
        out = {form: timed(table[(solver, form)])[0]    # warm-up
               for form in ("roll", "padded")}
        same = torch.equal(out["roll"], out["padded"])
        ms = {"roll": [], "padded": []}
        for _ in range(args.pairs):
            for form in ("roll", "padded", "padded", "roll"):
                ms[form].append(timed(table[(solver, form)])[1])
        med = {form: statistics.median(v) for form, v in ms.items()}
        print(f"{solver}: roll {' '.join(f'{t:.3f}' for t in ms['roll'])}"
              f" ms; padded {' '.join(f'{t:.3f}' for t in ms['padded'])}"
              f" ms; median roll {med['roll']:.3f}, padded "
              f"{med['padded']:.3f} ms a solve (padded/roll "
              f"{med['padded'] / med['roll']:.3f}); bitwise equal {same}")
        if not same:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
