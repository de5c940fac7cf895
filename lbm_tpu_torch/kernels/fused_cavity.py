"""The cavity step kernels (counterpart of lbm_tpu/kernels/fused_cavity.py):

  collide_stream_cavity            collide (stored macros) + pull stream +
                                   walls + lid + guarded macros;
  collide_stream_cavity_lean       the same with the macros recomputed from
                                   f, populations only in and out;
  collide_stream_cavity_multistep  K lean steps in one launch, the lid ramp
                                   evaluated from step0 in the kernel;
  collide_stream_cavity_halo       the stored step on a y-shard: the rows
  collide_stream_cavity_halo_lean  beside it arrive as strips, and the
                                   bottom wall and the lid apply only where
                                   the flags say the shard holds them;
  collide_stream_cavity_multistep_gated
                                   the K-step window on a shard extended by
                                   K ghost rows a side: periodic in y within
                                   the block, the bottom wall and the lid at
                                   the rows wall_rows names (-1: none).

On CUDA tensors each wrapper checks its inputs and launches its entry of
csrc/fused_cavity.cu (the block programs of csrc/cavity_tile.cuh) into
fresh output buffers, or raises; the windows take the resident route (each
block's band of rows in shared memory for all K steps) where the grid fits
the card's shared memory and K >= 2, else the streaming route (a step a
pass through device memory): window_route says which. On CPU tensors it
runs its plain version (the *_reference functions: ops/cavity collide,
ops/stream.stream_cavity_gated, macros_guarded in eager torch), which the
kernels equal bit for bit. LAUNCHES counts each kernel's launches by the
name of its TPU counterpart.

Unlike the TPU kernels, which alias their outputs onto their inputs and
need NY % 8 == 0 (banded) or a grid that fits VMEM (multistep), these take
any grid that fits the card. The halo kernels read only the strips' rows
next to the shard (the last row of f_up, the first of f_dn), so JAX's 8-row
strips and 1-row strips give one result.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from ..ops.cavity import (Q, collide_dirs, decode, encode, lid_speed,
                          macros_guarded)
from ..ops.stream import stream_cavity_gated
from . import build

LAUNCHES = {"collide_stream_cavity": 0, "collide_stream_cavity_lean": 0,
            "collide_stream_cavity_multistep": 0,
            "collide_stream_cavity_halo": 0,
            "collide_stream_cavity_halo_lean": 0,
            "collide_stream_cavity_multistep_gated": 0}

# (storage dtype, compute dtype) -> the C interface's mode
_MODES = {
    (torch.float64, torch.float64): 0,
    (torch.float32, torch.float32): 1,
    (torch.bfloat16, torch.float32): 2,
}


def compute_dtype(f: torch.Tensor) -> torch.dtype:
    """The arithmetic dtype of populations stored as f (f32 for bf16)."""
    return torch.float32 if f.dtype == torch.bfloat16 else f.dtype


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _halo_block(f: torch.Tensor, f_up: torch.Tensor, f_dn: torch.Tensor
                ) -> torch.Tensor:
    """The shard's full populations between the row below it (f_up's last
    row) and the row above it (f_dn's first row): (Q, NYl + 2, NX)."""
    return torch.cat([decode(f_up[:, -1:]), decode(f), decode(f_dn[:, :1])],
                     dim=1)


def _halo_walls(rows: int, bottom: bool, top: bool) -> Tuple[int, int]:
    """(bottom-wall row, lid row) of a shard's halo block; -1: none."""
    return (1 if bottom else -1), (rows if top else -1)


def _stored_step(ff, macros, u_lid_dyn, tau, b_row, l_row, dtype, cut=None):
    """Collide the full populations ff against the stored macros, stream
    with the walls at b_row and l_row, keep the rows `cut` (all: None), and
    take the guarded macros of the new full populations (before the bf16
    rounding)."""
    post = collide_dirs([ff[i] for i in range(Q)], *macros, tau)
    fn = stream_cavity_gated(torch.stack(post), u_lid_dyn, b_row, l_row)
    if cut is not None:
        fn = fn[:, cut].contiguous()
    rho, ux, uy = macros_guarded([fn[i] for i in range(Q)])
    return encode(fn, dtype), rho, ux, uy


def collide_stream_cavity_reference(
        f: torch.Tensor, rho: torch.Tensor, ux: torch.Tensor,
        uy: torch.Tensor, u_lid_dyn: float, *, tau: float
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Collide against the stored macros, stream_cavity, then the guarded
    macros of the new full populations."""
    return _stored_step(decode(f), (rho, ux, uy), u_lid_dyn, tau, 0,
                        f.shape[1] - 1, f.dtype)


def collide_stream_cavity_halo_reference(
        f: torch.Tensor, rho: torch.Tensor, ux: torch.Tensor,
        uy: torch.Tensor, f_up: torch.Tensor, mac_up: torch.Tensor,
        f_dn: torch.Tensor, mac_dn: torch.Tensor, u_lid_dyn: float,
        bottom: bool, top: bool, *, tau: float
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The stored step of a y-shard: the strips' edge rows collide against
    their own stored macros, then the block streams with the bottom wall
    only if bottom and the lid only if top."""
    mac = torch.cat([mac_up[:, -1:], torch.stack([rho, ux, uy]),
                     mac_dn[:, :1]], dim=1)
    return _stored_step(_halo_block(f, f_up, f_dn), tuple(mac), u_lid_dyn,
                        tau, *_halo_walls(f.shape[1], bottom, top), f.dtype,
                        cut=slice(1, -1))


def _lean_step(ff: torch.Tensor, u_lid_dyn: float, tau: float, b_row: int,
               l_row: int) -> torch.Tensor:
    dirs = [ff[i] for i in range(Q)]
    rho, ux, uy = macros_guarded(dirs)
    return stream_cavity_gated(
        torch.stack(collide_dirs(dirs, rho, ux, uy, tau)), u_lid_dyn, b_row,
        l_row)


def collide_stream_cavity_lean_reference(f: torch.Tensor, u_lid_dyn: float,
                                         *, tau: float) -> torch.Tensor:
    """One lean step: macros from f, collide, stream_cavity."""
    return encode(_lean_step(decode(f), u_lid_dyn, tau, 0, f.shape[1] - 1),
                  f.dtype)


def collide_stream_cavity_halo_lean_reference(
        f: torch.Tensor, f_up: torch.Tensor, f_dn: torch.Tensor,
        u_lid_dyn: float, bottom: bool, top: bool, *, tau: float
) -> torch.Tensor:
    """The lean step of a y-shard; the strips' macros are recomputed from
    their populations, as the shard's own."""
    fn = _lean_step(_halo_block(f, f_up, f_dn), u_lid_dyn, tau,
                    *_halo_walls(f.shape[1], bottom, top))
    return encode(fn[:, 1:-1].contiguous(), f.dtype)


def collide_stream_cavity_multistep_gated_reference(
        f: torch.Tensor, step0: int, wall_rows: Sequence[int], *, tau: float,
        k_steps: int, u_lid: float, sigma: float) -> torch.Tensor:
    """k_steps lean steps in the compute dtype from trajectory step step0,
    periodic in y within the block, the bottom wall and the lid at
    wall_rows = (b_row, l_row) (-1: none); decoded once and rounded to the
    storage dtype once, at the end."""
    b_row, l_row = (int(r) for r in wall_rows)
    ff = decode(f)
    for k in range(k_steps):
        u = lid_speed(step0 + k, u_lid=u_lid, sigma=sigma, dtype=ff.dtype)
        ff = _lean_step(ff, u, tau, b_row, l_row)
    return encode(ff, f.dtype)


def collide_stream_cavity_multistep_reference(
        f: torch.Tensor, step0: int, *, tau: float, k_steps: int,
        u_lid: float, sigma: float) -> torch.Tensor:
    """k_steps lean steps on the whole grid: the gated window with the
    walls at the grid's edge rows."""
    return collide_stream_cavity_multistep_gated_reference(
        f, step0, (0, f.shape[1] - 1), tau=tau, k_steps=k_steps, u_lid=u_lid,
        sigma=sigma)


def _rows_of(t: torch.Tensor, y0: int, y1: int) -> torch.Tensor:
    """Rows y0 .. y1 - 1 of t (..., NY, NX), wrapping around the grid, as a
    contiguous copy."""
    iy = torch.arange(y0, y1, device=t.device) % t.shape[-2]
    return t.index_select(-2, iy).contiguous()


def halo_inputs(f: torch.Tensor, macros: Optional[Sequence[torch.Tensor]],
                rows: slice, depth: int = 1) -> tuple:
    """One y-shard's arguments of collide_stream_cavity_halo (macros =
    (rho, ux, uy)) or _halo_lean (macros None) up to the lid speed, cut from
    the full grid: the shard, its `depth`-row strips wrapped around the grid
    as the ring exchange delivers them, and the wall flags. Every tensor is
    a contiguous copy."""
    y0, y1 = rows.start, rows.stop
    walls = (y0 == 0, y1 == f.shape[-2])
    if macros is None:
        return (_rows_of(f, y0, y1), _rows_of(f, y0 - depth, y0),
                _rows_of(f, y1, y1 + depth)), walls
    mac = torch.stack(list(macros))
    return ((_rows_of(f, y0, y1), *(_rows_of(m, y0, y1) for m in macros),
             _rows_of(f, y0 - depth, y0), _rows_of(mac, y0 - depth, y0),
             _rows_of(f, y1, y1 + depth), _rows_of(mac, y1, y1 + depth)),
            walls)


def window_inputs(f: torch.Tensor, rows: slice, k: int
                  ) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """One y-shard's block and wall_rows for collide_stream_cavity_
    multistep_gated, cut from the full grid: the shard extended by k rows a
    side (wrapped around the grid, as the ring exchange delivers them), the
    bottom wall at row k where the shard holds y = 0 and the lid at its
    last row where it holds the top."""
    y0, y1 = rows.start, rows.stop
    return _rows_of(f, y0 - k, y1 + k), (
        k if y0 == 0 else -1, k + y1 - y0 - 1 if y1 == f.shape[-2] else -1)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check(name: str, f: torch.Tensor, *fields: torch.Tensor) -> int:
    """Validate what the kernel takes; returns its mode."""
    tensors = (f, *fields)
    devices = {t.device for t in tensors}
    if len(devices) != 1 or f.device.type != "cuda":
        raise ValueError(f"{name}: the tensors must lie on one CUDA device "
                         f"(or all on the CPU), got "
                         f"{sorted(map(str, devices))}")
    mode = _MODES.get((f.dtype, compute_dtype(f)))
    if mode is None or any(t.dtype != compute_dtype(f) for t in fields):
        raise TypeError(f"{name}: unsupported dtypes f={f.dtype} fields="
                        f"{[str(t.dtype) for t in fields]}; the kernel "
                        f"takes (storage, compute) dtypes "
                        f"{sorted(map(str, _MODES))}")
    if f.dim() != 3 or f.shape[0] != Q or any(t.shape != f.shape[1:]
                                              for t in fields):
        raise ValueError(f"{name}: shapes f={tuple(f.shape)} fields="
                         f"{[tuple(t.shape) for t in fields]}; want "
                         f"(9, NY, NX) and (NY, NX)")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: inputs must be contiguous")
    return mode


def _check_strips(name: str, f: torch.Tensor, f_up: torch.Tensor,
                  mac_up: Optional[torch.Tensor], f_dn: torch.Tensor,
                  mac_dn: Optional[torch.Tensor]) -> None:
    """Strips (9, d, NX) of f's dtype, d >= 1, and in stored mode macro
    strips (3, d, NX) of the compute dtype, on f's device (on any device:
    the plain versions take what the kernels take)."""
    NX = f.shape[-1]
    for fs, ms in ((f_up, mac_up), (f_dn, mac_dn)):
        want = [(fs, f.dtype, Q)] + ([] if ms is None else
                                     [(ms, compute_dtype(f), 3)])
        for t, dtype, planes in want:
            if (t.device != f.device or t.dtype != dtype or t.dim() != 3
                    or t.shape[0] != planes or t.shape[1] < 1
                    or t.shape[2] != NX or t.shape[1] != fs.shape[1]):
                raise ValueError(
                    f"{name}: strip {tuple(t.shape)} {t.dtype} on "
                    f"{t.device}; want ({planes}, d >= 1, {NX}) {dtype} on "
                    f"{f.device}, populations and macros of one depth")


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _launch_step(name: str, f: torch.Tensor, macros: tuple, strips: tuple,
                 u_lid_dyn: float, tau: float, b_row: int, l_row: int):
    """One launch of lbm_cavity_collide_stream: stored mode when macros
    (rho, ux, uy) are given, lean when they are (); strips (f_up, mac_up,
    f_dn, mac_dn) or four Nones. Returns the fresh outputs (f, *macros)."""
    mode = _check(name, f, *macros)
    if not all(s is None or s.is_contiguous() for s in strips):
        raise ValueError(f"{name}: strips must be contiguous")
    lib = build.load()
    _, NY, NX = f.shape
    out = [torch.empty_like(f)] + [torch.empty_like(t) for t in macros]
    depth = [0 if s is None else s.shape[1] for s in strips[::2]]
    none3 = (None,) * 3
    stream = torch.cuda.current_stream(f.device).cuda_stream
    with torch.cuda.device(f.device):
        err = lib.lbm_cavity_collide_stream(
            mode, int(not macros), f.data_ptr(),
            *map(_ptr, macros or none3), *map(_ptr, strips),
            *map(_ptr, out + [None] * (4 - len(out))), float(u_lid_dyn),
            float(tau), NY, NX, *depth, b_row, l_row, stream)
    _raise_on(err, name)
    LAUNCHES[name] += 1
    return out


def collide_stream_cavity(
        f: torch.Tensor,      # (Q, NY, NX)
        rho: torch.Tensor,    # (NY, NX) stored macros, compute dtype
        ux: torch.Tensor,
        uy: torch.Tensor,
        u_lid_dyn: float,     # lid speed at this step (lid_speed)
        *, tau: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One cavity step; returns (f_new, rho, ux, uy)."""
    if f.device.type == "cpu":
        return collide_stream_cavity_reference(f, rho, ux, uy, u_lid_dyn,
                                               tau=tau)
    return tuple(_launch_step("collide_stream_cavity", f, (rho, ux, uy),
                              (None,) * 4, u_lid_dyn, tau, 0,
                              f.shape[1] - 1))


def collide_stream_cavity_lean(f: torch.Tensor, u_lid_dyn: float, *,
                               tau: float) -> torch.Tensor:
    """One cavity step, populations only; the macros on demand with
    ops.cavity.macros_guarded."""
    if f.device.type == "cpu":
        return collide_stream_cavity_lean_reference(f, u_lid_dyn, tau=tau)
    return _launch_step("collide_stream_cavity_lean", f, (), (None,) * 4,
                        u_lid_dyn, tau, 0, f.shape[1] - 1)[0]


def collide_stream_cavity_halo(
        f: torch.Tensor,        # (Q, NYl, NX) this rank's y-shard
        rho: torch.Tensor,      # (NYl, NX) its stored macros
        ux: torch.Tensor,
        uy: torch.Tensor,
        f_up: torch.Tensor,     # (Q, d, NX) the rows below the shard
        mac_up: torch.Tensor,   # (3, d, NX) their stored rho, ux, uy
        f_dn: torch.Tensor,     # (Q, d, NX) the rows above the shard
        mac_dn: torch.Tensor,
        u_lid_dyn: float,
        bottom: bool,           # the shard holds y = 0
        top: bool,              # the shard holds y = NY - 1 (the lid)
        *, tau: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One stored cavity step of a y-shard; returns (f_new, rho, ux, uy).
    f_up holds the rows of lower y (the previous shard's last rows), f_dn
    those of higher y; a wall shard ignores the strip beyond its wall, so
    ring-wrapped strips are fine."""
    name = "collide_stream_cavity_halo"
    _check_strips(name, f, f_up, mac_up, f_dn, mac_dn)
    if f.device.type == "cpu":
        return collide_stream_cavity_halo_reference(
            f, rho, ux, uy, f_up, mac_up, f_dn, mac_dn, u_lid_dyn, bottom,
            top, tau=tau)
    NY = f.shape[1]
    return tuple(_launch_step(
        name, f, (rho, ux, uy),
        (f_up, mac_up, f_dn, mac_dn), u_lid_dyn, tau, 0 if bottom else -1,
        NY - 1 if top else -1))


def collide_stream_cavity_halo_lean(
        f: torch.Tensor, f_up: torch.Tensor, f_dn: torch.Tensor,
        u_lid_dyn: float, bottom: bool, top: bool, *, tau: float
) -> torch.Tensor:
    """One lean cavity step of a y-shard (strips as collide_stream_cavity_
    halo's, populations only)."""
    name = "collide_stream_cavity_halo_lean"
    _check_strips(name, f, f_up, None, f_dn, None)
    if f.device.type == "cpu":
        return collide_stream_cavity_halo_lean_reference(
            f, f_up, f_dn, u_lid_dyn, bottom, top, tau=tau)
    NY = f.shape[1]
    return _launch_step(name, f, (),
                        (f_up, None, f_dn, None), u_lid_dyn, tau,
                        0 if bottom else -1, NY - 1 if top else -1)[0]


def window_route(f: torch.Tensor, k_steps: int) -> str:
    """The route a window of k_steps on f (9, NY, NX) takes: "resident" or
    "streaming" on a CUDA tensor (the current device's shared memory
    decides), "plain" on the CPU."""
    if f.device.type == "cpu":
        return "plain"
    return ("resident" if _resident_blocks("window_route", f, k_steps)
            else "streaming")


def _resident_blocks(name: str, f: torch.Tensor, k_steps: int) -> int:
    """The resident route's blocks for a window of k_steps on the CUDA
    tensor f; 0: the streaming route."""
    mode = _check(name, f)
    with torch.cuda.device(f.device):
        r = build.load().lbm_cavity_multistep_route(mode, int(k_steps),
                                                    *f.shape[1:])
    if r < 0:
        raise RuntimeError(f"{name}: cudaError_t {-r}")
    return r


def _launch_window(name: str, f: torch.Tensor, step0: int, k_steps: int,
                   u_lid: float, sigma: float, tau: float, b_row: int,
                   l_row: int) -> torch.Tensor:
    mode = _check(name, f)
    lib = build.load()
    _, NY, NX = f.shape
    f_out = torch.empty_like(f)
    # the resident route's edge-row exchange (2 parities x 6 rows a block),
    # or the streaming route's two work buffers (one for K = 2, none for 1)
    blocks = _resident_blocks(name, f, k_steps)
    shapes = ([(12 * blocks, NX)] if blocks
              else [f.shape] * min(k_steps - 1, 2))
    work = [torch.empty(s, dtype=compute_dtype(f), device=f.device)
            for s in shapes]
    ptrs = [w.data_ptr() for w in work] + [None] * (2 - len(work))
    stream = torch.cuda.current_stream(f.device).cuda_stream
    with torch.cuda.device(f.device):
        err = lib.lbm_cavity_multistep(
            mode, f.data_ptr(), *ptrs, f_out.data_ptr(), int(step0),
            int(k_steps), float(u_lid), float(sigma), float(tau), NY, NX,
            b_row, l_row, stream)
    _raise_on(err, name)
    LAUNCHES[name] += 1
    return f_out


def collide_stream_cavity_multistep(
        f: torch.Tensor, step0: int, *, tau: float, k_steps: int,
        u_lid: float, sigma: float) -> torch.Tensor:
    """k_steps cavity steps in one launch (lean semantics), starting at
    trajectory step step0 (a host int)."""
    if k_steps < 1:
        raise ValueError("k_steps must be >= 1")
    if f.device.type == "cpu":
        return collide_stream_cavity_multistep_reference(
            f, step0, tau=tau, k_steps=k_steps, u_lid=u_lid, sigma=sigma)
    return _launch_window("collide_stream_cavity_multistep", f, step0,
                          k_steps, u_lid, sigma, tau, 0, f.shape[1] - 1)


def collide_stream_cavity_multistep_gated(
        f: torch.Tensor,            # (Q, rows + 2K, NX) an extended shard
        step0: int,                 # trajectory step at the window's start
        wall_rows: Sequence[int],   # (bottom-wall row, lid row); -1: none
        *, tau: float, k_steps: int, u_lid: float, sigma: float
) -> torch.Tensor:
    """k_steps lean steps in one launch on a block that is periodic in y,
    with the bottom wall and the lid at the rows wall_rows names (host
    ints). The caller slices the shard out of the result."""
    if k_steps < 1:
        raise ValueError("k_steps must be >= 1")
    b_row, l_row = (int(r) for r in wall_rows)
    if not all(-1 <= r < f.shape[1] for r in (b_row, l_row)):
        raise ValueError(f"wall_rows {tuple(wall_rows)}: each must be -1 or "
                         f"a row of the block's {f.shape[1]}")
    if f.device.type == "cpu":
        return collide_stream_cavity_multistep_gated_reference(
            f, step0, (b_row, l_row), tau=tau, k_steps=k_steps, u_lid=u_lid,
            sigma=sigma)
    return _launch_window("collide_stream_cavity_multistep_gated", f, step0,
                          k_steps, u_lid, sigma, tau, b_row, l_row)
