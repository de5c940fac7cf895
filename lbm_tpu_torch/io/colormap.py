"""Device-side field -> colour-index rendering (counterpart of
lbm_tpu/io/colormap.py; the reference's OpenCV JET pipeline,
src/visualize.cpp:318-333).

The normalisation, the JET quantisation, the vertical flip and the mosaic
run with torch ops on the fields' device, in the fields' own dtype (f32 for
native f32 and bf16 storage, whose macros are f32; f64 under --f64), and
give uint8 palette-index frames, which expand() turns into RGB through
JET_PALETTE on their device. The fixed ranges are the
reference's (src/visualize.cpp:34-48), so frames compare across time and
across implementations.

The frames equal lbm_tpu's uint8 for uint8 on the same fields: each
operation rounds once, as JAX's op-by-op evaluation does, and the
normalisation divides by the range's width as a tensor (each rounded once
to the fields' dtype, as JAX's weak-typed scalars are), since CUDA torch
turns a division by a Python scalar into a product with its reciprocal and
one ulp moves a pixel across a band edge. lbm_tpu's colorize and its three
frame functions are index_panels' rows: one tile each, normalised
together.

A sharded run renders each rank's block with index_panels (unflipped, so
blocks join in mesh order) and rank 0 assembles the frames with
frames_of_panels; render_all is the same two calls on one device.
"""
from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import torch

# Fixed ranges (reference: src/visualize.cpp:34-48)
RANGES = {
    "rho_e": (0.0, 1.0),
    "rho_i": (0.0, 1822.0),
    "rho_q": (0.0, 1.5),
    "ux_e": (-1e-7, 1e-7),
    "uy_e": (-1e-7, 1e-7),
    "u_mag_e": (0.0, 1e-7),
    "ux_i": (-1e-7, 1e-7),
    "uy_i": (-1e-7, 1e-7),
    "u_mag_i": (0.0, 1e-7),
    "T_e": (0.0, 1.0),
    "T_i": (0.0, 0.5),
    "T_n": (0.0, 0.5),
}

# index_panels' order: the density frame's tiles (the reference's
# rho_e | rho_q | rho_i, src/visualize.cpp:243-245), the velocity frame's
# two rows, the temperature frame's tiles
PANELS = ("rho_e", "rho_q", "rho_i",
          "ux_e", "uy_e", "u_mag_e", "ux_i", "uy_i", "u_mag_i",
          "T_e", "T_i", "T_n")


def jet(v: torch.Tensor) -> torch.Tensor:
    """Classic JET colormap: v in [0,1] -> uint8 RGB (..., 3)."""
    v = torch.clamp(v, 0.0, 1.0)
    r = torch.clamp(1.5 - torch.abs(4.0 * v - 3.0), 0.0, 1.0)
    g = torch.clamp(1.5 - torch.abs(4.0 * v - 2.0), 0.0, 1.0)
    b = torch.clamp(1.5 - torch.abs(4.0 * v - 1.0), 0.0, 1.0)
    rgb = torch.stack([r, g, b], dim=-1)
    return (rgb * 255.0 + 0.5).to(torch.uint8)


def jet_index(v: torch.Tensor) -> torch.Tensor:
    """Quantized colormap index (uint8): 1/3 the bytes of an RGB frame
    (what a sharded run gathers); expand() gives its RGB."""
    return (torch.clamp(v, 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)


def _palette() -> np.ndarray:
    v = np.linspace(0.0, 1.0, 256)
    r = np.clip(1.5 - np.abs(4 * v - 3), 0, 1)
    g = np.clip(1.5 - np.abs(4 * v - 2), 0, 1)
    b = np.clip(1.5 - np.abs(4 * v - 1), 0, 1)
    return (np.stack([r, g, b], -1) * 255 + 0.5).astype("uint8")


JET_PALETTE = _palette()


@functools.lru_cache(maxsize=8)
def _palette_on(device: torch.device) -> torch.Tensor:
    """JET_PALETTE on a device, copied once (the copy waits for the
    stream)."""
    return torch.from_numpy(JET_PALETTE).to(device)


def expand(idx: torch.Tensor) -> torch.Tensor:
    """A palette-index frame (H, W) uint8 as RGB (H, W, 3) uint8 on its
    device: JET_PALETTE[idx]."""
    return _palette_on(idx.device)[idx.long()]


def mosaic(panels: Sequence[torch.Tensor], ncols: int) -> torch.Tensor:
    """Tile (H, W) panels into a grid, row-major."""
    rows = [torch.cat(list(panels[i:i + ncols]), dim=1)
            for i in range(0, len(panels), ncols)]
    return torch.cat(rows, dim=0)


@functools.lru_cache(maxsize=8)
def _panel_ranges(dtype: torch.dtype, device: torch.device):
    """(vmin, vmax - vmin) of every panel as (12, 1, 1) tensors on the
    device, each rounded once to dtype as a Python scalar would be. Made
    once per (dtype, device): the copy from the host waits for the
    stream."""
    lo = [RANGES[k][0] for k in PANELS]
    width = [RANGES[k][1] - RANGES[k][0] for k in PANELS]
    return tuple(torch.tensor(v, dtype=dtype).view(-1, 1, 1).to(device)
                 for v in (lo, width))


def index_panels(rho_e, rho_i, rho_q, ux_e, uy_e, ux_i, uy_i, T_e, T_i,
                 T_n) -> torch.Tensor:
    """The 12 palette-index tiles of the three frames, in PANELS order and
    unflipped: (12, NY, NX) uint8. The tiles are normalised together, one
    launch an operation; each element goes through lbm_tpu's colorize
    operations (lbm_tpu/io/colormap.py:65-71) with the same roundings, and
    the magnitudes are velocity_frame's (:93-94). On a block of a sharded
    lattice each pixel is the one the full grid gives (every operation is
    per site)."""
    fields = {"rho_e": rho_e, "rho_q": rho_q, "rho_i": rho_i,
              "ux_e": ux_e, "uy_e": uy_e,
              "u_mag_e": torch.sqrt(ux_e * ux_e + uy_e * uy_e),
              "ux_i": ux_i, "uy_i": uy_i,
              "u_mag_i": torch.sqrt(ux_i * ux_i + uy_i * uy_i),
              "T_e": T_e, "T_i": T_i, "T_n": T_n}
    tiles = torch.stack([fields[k] for k in PANELS])
    lo, width = _panel_ranges(tiles.dtype, tiles.device)
    return jet_index((tiles - lo) / width)


def frames_of_panels(panels: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The density, velocity and temperature frames of index_panels' (12,
    NY, NX) tiles: each tile flipped, then tiled as the reference does."""
    tiles = list(torch.flip(panels, dims=(1,)))
    return (mosaic(tiles[0:3], ncols=3), mosaic(tiles[3:9], ncols=3),
            mosaic(tiles[9:12], ncols=3))


def macro_fields(mac) -> tuple:
    """render_all's arguments from a Macros (ops/macros.py) of the 2-D
    plasma: species 0 electrons, 1 ions, 2 neutrals."""
    return (mac.rho[0], mac.rho[1], mac.rho_q,
            mac.ux[0], mac.uy[0], mac.ux[1], mac.uy[1],
            mac.T[0], mac.T[1], mac.T[2])


def render_all(rho_e, rho_i, rho_q, ux_e, uy_e, ux_i, uy_i, T_e, T_i, T_n):
    """All three video frames (uint8 palette indices) on the fields'
    device."""
    return frames_of_panels(index_panels(rho_e, rho_i, rho_q, ux_e, uy_e,
                                         ux_i, uy_i, T_e, T_i, T_n))


def speed2(ux: torch.Tensor, uy: torch.Tensor) -> torch.Tensor:
    """|u|^2, the cavity video's field (scripts/run_cavity.py:145)."""
    return ux * ux + uy * uy


def cavity_rgb(m: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor
               ) -> torch.Tensor:
    """JET RGB of m normalised by (lo, hi), unflipped: (NY, NX, 3) uint8.
    lo and hi are 0-dim tensors on m's device, the extrema of the whole
    grid (an all-reduce of each rank's on a sharded run)."""
    return jet((m - lo) / torch.clamp_min(hi - lo, 1e-30))


def cavity_frame(ux: torch.Tensor, uy: torch.Tensor) -> torch.Tensor:
    """The cavity video's frame (scripts/run_cavity.py:140-147): the JET
    RGB of |u|^2 normalised by its own min and max, flipped (y up)."""
    m = speed2(ux, uy)
    lo, hi = torch.aminmax(m)
    return torch.flip(cavity_rgb(m, lo, hi), dims=(0,))
