#!/usr/bin/env python
"""Field plots from a checkpoint of the port (counterpart of
scripts/visualize_fields.py): heatmaps, quiver and streamline plots.

Reads a final_state.npz or ckpt_*.npz of any of the port's CLIs (or of the
JAX package's: the files share one layout) through
lbm_tpu_torch/io/checkpoint onto --device (cuda unless --device cpu is
given) and computes the macros there with the port's models; only the
2-D arrays handed to matplotlib come back to the host. 2-D plasma
checkpoints (classic or delta neutrals,
native or bf16 populations: the layout metadata is honoured, so delta
neutrals plot as full densities and bf16 populations are upcast before
the moment sums), 3-D ones at --z-slice (default the midplane), and cavity
ones (f, rho, ux, uy). The plots need matplotlib; without it the script
exits with a message.

    python scripts/visualize_fields_torch.py \
        build/output/torch/final_state.npz --out plots/
    python scripts/visualize_fields_torch.py --device cpu ckpt.npz
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
from typing import Optional

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import torch  # noqa: E402

from lbm_tpu_torch.config import PlasmaConfig  # noqa: E402
from lbm_tpu_torch.io import checkpoint as ckpt  # noqa: E402
from lbm_tpu_torch.models import plasma, plasma3d  # noqa: E402


def _keys(path: str) -> set:
    with np.load(path) as z:
        return set(z.keys())


def _config(path: str, shape, **extra) -> PlasmaConfig:
    """A config of the checkpoint's grid and layout; its dtype is the
    fields' (f64 files compute in f64, bf16 populations in f32)."""
    meta = ckpt.load_meta(path)
    if not meta:
        print("note: pre-metadata checkpoint: assuming the classic neutral "
              "layout, native storage")
    with np.load(path) as z:
        dtype = (torch.float64 if "Ex" in z and z["Ex"].dtype == np.float64
                 else torch.float32)
    NY, NX = shape[-2:]
    return dataclasses.replace(
        PlasmaConfig(), NX=NX, NY=NY, dtype=dtype,
        neutral_delta=bool(meta.get("neutral_delta", False)),
        storage=meta.get("storage", "native"), **extra)


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def _load_macros(path: str, z_slice: Optional[int], device):
    """(rho[s], ux[s], uy[s], rho_q, step) as 2-D float numpy arrays, as
    scripts/visualize_fields.py:_load_macros returns them; the macros are
    computed on `device`."""
    keys = _keys(path)
    if "Ez" in keys or "Ez__bf16" in keys:
        state = ckpt.load3d(path, device)
        NZ = state.Ex.shape[0]
        cfg = _config(path, state.Ex.shape, NZ=NZ)
        mac = plasma3d.compute_macros(cfg, state)
        k = NZ // 2 if z_slice is None else z_slice
        if not 0 <= k < NZ:
            raise SystemExit(f"--z-slice {k} out of range [0, {NZ})")
        print(f"3-D checkpoint {NZ}x{cfg.NY}x{cfg.NX}: plotting z-slice {k}")
        return ([_numpy(r[k]) for r in mac.rho],
                [_numpy(a[k]) for a in mac.ux],
                [_numpy(a[k]) for a in mac.uy], _numpy(mac.rho_q[k]),
                state.step)
    state = ckpt.load(path, device)
    cfg = _config(path, state.Ex.shape)
    mac = plasma.compute_macros(cfg, state)
    return ([_numpy(r) for r in mac.rho], [_numpy(a) for a in mac.ux],
            [_numpy(a) for a in mac.uy], _numpy(mac.rho_q), state.step)


def _load_cavity(path: str, device):
    """(rho, ux, uy, step) of a cavity checkpoint loaded onto `device`,
    numpy."""
    state = ckpt.load_cavity(path, device)
    return (_numpy(state.rho), _numpy(state.ux), _numpy(state.uy),
            state.step)


def _plot_flow(plt, out: str, rho, ux, uy, titles, names, label) -> None:
    """Density heatmap, speed heatmap with a quiver, streamlines."""
    NY, NX = rho.shape
    fig, ax = plt.subplots(figsize=(6, 5), dpi=110)
    im = ax.imshow(rho, origin="lower", cmap="viridis")
    fig.colorbar(im, ax=ax, label=f"rho{label}")
    ax.set_title(titles[0])
    fig.tight_layout()
    fig.savefig(os.path.join(out, names[0]))
    plt.close(fig)

    speed = np.sqrt(ux ** 2 + uy ** 2)
    step_q = max(1, NX // 32)
    Y, X = np.mgrid[0:NY:step_q, 0:NX:step_q]
    fig, ax = plt.subplots(figsize=(6, 5), dpi=110)
    im = ax.imshow(speed, origin="lower", cmap="magma")
    fig.colorbar(im, ax=ax, label=f"|u{label}|")
    ax.quiver(X, Y, ux[::step_q, ::step_q], uy[::step_q, ::step_q],
              color="w", scale_units="xy", angles="xy")
    ax.set_title(titles[1])
    fig.tight_layout()
    fig.savefig(os.path.join(out, names[1]))
    plt.close(fig)

    fig, ax = plt.subplots(figsize=(6, 5), dpi=110)
    ax.streamplot(np.arange(NX), np.arange(NY), ux, uy,
                  color=speed, cmap="magma", density=1.2)
    ax.set_title(titles[2])
    fig.tight_layout()
    fig.savefig(os.path.join(out, names[2]))
    plt.close(fig)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("checkpoint")
    p.add_argument("--out", default="field_plots")
    p.add_argument("--species", default="e,i,n")
    p.add_argument("--z-slice", type=int, default=None,
                   help="z-slice to plot for 3-D checkpoints "
                        "(default: midplane)")
    p.add_argument("--device", default="cuda",
                   help="torch device for the load and the macros: cuda "
                        "or cpu")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available "
                           "(pass --device cpu to run on the CPU)")
    try:
        import matplotlib
    except ImportError:
        raise SystemExit("visualize_fields_torch: the plots need "
                         "matplotlib, which is absent on this host")
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(args.out, exist_ok=True)
    keys = _keys(args.checkpoint)
    if not ("Ex" in keys or "Ex__bf16" in keys):
        # no field arrays: the cavity's single population
        rho, ux, uy, step = _load_cavity(args.checkpoint, device)
        storage = ckpt.load_meta(args.checkpoint).get("storage", "native")
        print(f"cavity checkpoint {rho.shape[0]}x{rho.shape[1]} (storage "
              f"{storage}), step {step}")
        _plot_flow(plt, args.out, rho.astype(np.float32),
                   ux.astype(np.float32), uy.astype(np.float32),
                   [f"cavity density (step {step})", "cavity velocity",
                    "cavity streamlines"],
                   ["density.png", "velocity.png", "streamlines.png"], "")
        print(f"wrote 3 plots to {args.out}")
        return 0

    rho_s, ux_s, uy_s, rho_q, step = _load_macros(args.checkpoint,
                                                  args.z_slice, device)
    names = {"e": 0, "i": 1, "n": 2}
    for s in args.species.split(","):
        k = names[s]
        _plot_flow(plt, args.out, rho_s[k], ux_s[k], uy_s[k],
                   [f"density {s} (step {step})", f"velocity {s}",
                    f"streamlines {s}"],
                   [f"density_{s}.png", f"velocity_{s}.png",
                    f"streamlines_{s}.png"], f"_{s}")
    fig, ax = plt.subplots(figsize=(6, 5), dpi=110)
    im = ax.imshow(rho_q, origin="lower", cmap="RdBu_r")
    fig.colorbar(im, ax=ax, label="rho_q")
    ax.set_title("charge density")
    fig.tight_layout()
    fig.savefig(os.path.join(args.out, "rho_q.png"))
    plt.close(fig)
    print(f"plots in {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
