"""Push streaming with periodic wrap or bounce-back walls, and the cavity's
pull streaming (counterpart of lbm_tpu/ops/stream.py: stream_periodic, the
bounce-back fixups and their flat-gather test oracle, stream_cavity).

Bounce-back is applied as the periodic push plus edge-row and edge-column
fixups (src/streaming.cpp:70-105). Unlike the JAX functions, which return
new arrays, bounceback_from_periodic writes its fixups into the tensor it
is given (the periodic result, always a fresh buffer here) and returns it:
that saves a copy of the populations every step.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..constants import D2Q9
from .cavity import lid_deltas, sum_dirs

CX = D2Q9.CX
CY = D2Q9.CY
OPP = D2Q9.OPP
Q = D2Q9.Q


def stream_periodic(f: torch.Tensor) -> torch.Tensor:
    """Push-periodic streaming of (..., Q, NY, NX) populations:
    temp[y+cy, x+cx, i] = f[y, x, i] with wraparound
    (reference: src/streaming.cpp:35-59)."""
    parts = [
        torch.roll(f[..., i, :, :], shifts=(int(CY[i]), int(CX[i])),
                   dims=(-2, -1))
        for i in range(Q)
    ]
    return torch.stack(parts, dim=-3)


@functools.lru_cache(maxsize=None)
def _bounceback_gather_map(NX: int, NY: int):
    """Flat gather indices of the reference's push bounce-back, built from
    its 4-case write logic in its serial (x, y, i) order: later writes win
    the duplicated corner slots, and the slots never written (the holes)
    keep the destination buffer's stale contents. Returns (src, hole):
    the flat source of each destination (holes map to themselves) and the
    hole mask; flat index (i*NY + y)*NX + x. Test oracle only."""
    size = Q * NY * NX
    src = np.full(size, -1, dtype=np.int64)

    def flat(i, y, x):
        return (i * NY + y) * NX + x

    for x in range(NX):
        for y in range(NY):
            for i in range(Q):
                dx, dy = int(CX[i]), int(CY[i])
                o = int(OPP[i])
                xs, ys = x + dx, y + dy
                x_in = 0 <= xs < NX
                y_in = 0 <= ys < NY
                if x_in and y_in:
                    d = flat(i, ys, xs)
                elif x_in:            # y blocked: slide in x, reflect
                    d = flat(o, y, xs)
                elif y_in:            # x blocked: slide in y, reflect
                    d = flat(o, ys, x)
                else:                 # corner: reflect in place
                    d = flat(o, y, x)
                src[d] = flat(i, y, x)

    hole = src < 0
    src = np.where(hole, np.arange(size), src)
    return src, hole


def stream_bounceback_gather(f: torch.Tensor,
                             stale: torch.Tensor | None = None
                             ) -> torch.Tensor:
    """Flat-gather push bounce-back (test oracle for the fixup path)."""
    NY, NX = f.shape[-2], f.shape[-1]
    src_np, hole_np = _bounceback_gather_map(NX, NY)
    src = torch.as_tensor(src_np, device=f.device)
    hole = torch.as_tensor(hole_np, device=f.device)
    lead = f.shape[:-3]
    flat = f.reshape(lead + (Q * NY * NX,))
    out = flat[..., src]
    stale_flat = flat if stale is None else stale.reshape(flat.shape)
    return torch.where(hole, stale_flat, out).reshape(f.shape)


# The 8 corner slots the reference's serial write loop never reaches (two
# per corner); they keep the destination temp buffer's stale contents.
# Entries are (i, y, x) with -1 meaning the last row/column.
HOLE_SLOTS = (
    (6, 0, 0), (8, 0, 0),           # bottom-left
    (5, 0, -1), (7, 0, -1),         # bottom-right
    (5, -1, 0), (7, -1, 0),         # top-left
    (6, -1, -1), (8, -1, -1),       # top-right
)


def hole_values(a: torch.Tensor) -> list:
    """The 8 stale values bounce-back leaves at the corner holes, read from
    the buffer the reference's recycled temp would hold (pre-collision f
    for the f pass, post-collision f for the g pass). Copies, so a later
    in-place fixup of `a` leaves them be."""
    return [a[..., i, y, x].clone() for (i, y, x) in HOLE_SLOTS]


def hole_values_from_periodic(out_p: torch.Tensor) -> list:
    """hole_values(f_post) recovered from the periodic streaming result:
    f_post[i, y, x] = out_p[i, (y+cy_i) % NY, (x+cx_i) % NX]. Lets the fused
    kernel, which never materialises f_post, supply the g pass's stale
    corner values. Copies, as hole_values."""
    NY, NX = out_p.shape[-2], out_p.shape[-1]
    vals = []
    for (i, y, x) in HOLE_SLOTS:
        yy = (y % NY + int(CY[i])) % NY
        xx = (x % NX + int(CX[i])) % NX
        vals.append(out_p[..., i, yy, xx].clone())
    return vals


def bounceback_from_periodic(out: torch.Tensor, hole_vals: list
                             ) -> torch.Tensor:
    """Turn a push-periodic streamed lattice into the reference's push
    bounce-back result by edge fixups, IN PLACE; returns `out`.

    Bounce-back differs from periodic only where the push crossed a wall.
    Every reflected value is a post-collision population, which the
    periodic result holds at a shifted index
    (f_post[i,y,x] = out[i, y+cy, x+cx]), so the fixups read rows and
    columns of `out` itself. Every source is copied before the first
    write (torch slices are views). The write order, plus the (7,-1,-1)
    override, encodes the reference's serial corner winners; the 8 holes
    take `hole_vals` (HOLE_SLOTS order).

    out: (..., Q, NY, NX) periodic push-streaming result."""
    lead = out.shape[:-3]

    def one(v):
        """A hole/corner value as a length-1 slice broadcast over lead."""
        v = torch.as_tensor(v, dtype=out.dtype, device=out.device)
        return v.broadcast_to(lead)[..., None]

    def cat(*parts):
        return torch.cat(parts, dim=-1)

    src_1 = out[..., 3, :, -1].clone()       # f_post[3][:, 0]
    src_3 = out[..., 1, :, 0].clone()        # f_post[1][:, -1]
    src_2 = out[..., 4, -1, :].clone()       # f_post[4][0, :]
    src_4 = out[..., 2, 0, :].clone()        # f_post[2][-1, :]
    NYd, NXd = out.shape[-2], out.shape[-1]
    (h6a, h8a, h5b, h7a, h5a, h7b, h6b, h8b) = [one(v) for v in hole_vals]
    src_5col = cat(out[..., 7, : NYd - 1, -1], h5a)  # + hole (5, -1, 0)
    src_5row = cat(out[..., 7, -1, : NXd - 1], h5b)  # + hole (5, 0, -1)
    src_6row = cat(h6a, out[..., 8, -1, 1:])         # hole (6, 0, 0) +
    src_6col = cat(out[..., 8, : NYd - 1, 0], h6b)   # + hole (6, -1, -1)
    src_7col = cat(h7a, out[..., 5, 1:, 0])          # hole (7, 0, -1) +
    # hole (7, -1, 0) + row + the (7,-1,-1) corner winner f_post[5][-1,-1]
    src_7row = cat(h7b, out[..., 5, 0, 1: NXd - 1], out[..., 5, 0, 0][..., None])
    src_8col = cat(h8a, out[..., 6, 1:, -1])         # hole (8, 0, 0) +
    src_8row = cat(out[..., 6, 0, : NXd - 1], h8b)   # + hole (8, -1, -1)

    # Axis directions: one column/row each.
    out[..., 1, :, 0] = src_1
    out[..., 3, :, -1] = src_3
    out[..., 2, 0, :] = src_2
    out[..., 4, -1, :] = src_4
    # Diagonals: column/row order encodes the serial-corner winner.
    out[..., 5, :, 0] = src_5col
    out[..., 5, 0, :] = src_5row     # row wins (5,0,0)
    out[..., 6, 0, :] = src_6row
    out[..., 6, :, -1] = src_6col    # col wins (6,0,-1)
    out[..., 7, :, -1] = src_7col
    out[..., 7, -1, :] = src_7row    # row wins (7,-1,-1)
    out[..., 8, :, 0] = src_8col
    out[..., 8, -1, :] = src_8row    # row wins (8,-1,0)
    return out


def stream_bounceback(f: torch.Tensor, stale: torch.Tensor | None = None
                      ) -> torch.Tensor:
    """Push streaming with bounce-back walls on all four edges. `stale`
    supplies the values kept at the corner holes (the reference's recycled
    temp buffer), f itself by default. The same operator serves the
    thermal populations g, where it is a zero-flux Neumann condition
    (reference: include/streaming.hpp:55)."""
    holes = hole_values(f if stale is None else stale)
    return bounceback_from_periodic(stream_periodic(f), holes)


# ---------------------------------------------------------------------------
# Cavity: pull streaming + 3 bounce-back walls + moving lid (top row)
# ---------------------------------------------------------------------------

def stream_cavity(f: torch.Tensor, u_lid_dyn: float) -> torch.Tensor:
    """Pull streaming with the lid-driven-cavity boundary handling
    (old codes/LBM_classic/LBM.cpp:105-159):
      * interior: f_new[i, y, x] = f[i, y-cy, x-cx] (a roll by +c);
      * left/right walls: reflect (1<-3, 8<-6, 5<-7) / (3<-1, 7<-5, 6<-8);
      * bottom wall: (2<-4, 5<-7, 6<-8);
      * moving lid: f_new[4] = f[2]; f_new[7] = f[5] + d5;
        f_new[8] = f[6] + d6, with d_k = -6 w_k rho_top (cx_k u_lid_dyn)
        and rho_top the 0..8 sum of the pre-streaming top row;
      * the walls are written sides -> bottom -> lid (the reference's loop
        order), so the lid wins the two top corners.

    f: (Q, NY, NX) post-collision populations, y = 0 the bottom wall and
    y = NY-1 the lid. Every wall source is read from f, which is never
    written: the rolls build a fresh tensor, and only that one is updated
    in place.
    """
    fn = torch.stack([torch.roll(f[i], shifts=(int(CY[i]), int(CX[i])),
                                 dims=(0, 1)) for i in range(Q)])
    # left wall x=0: incoming +x directions reflect from their opposites
    fn[1, :, 0] = f[3, :, 0]
    fn[8, :, 0] = f[6, :, 0]
    fn[5, :, 0] = f[7, :, 0]
    # right wall x=NX-1
    fn[3, :, -1] = f[1, :, -1]
    fn[7, :, -1] = f[5, :, -1]
    fn[6, :, -1] = f[8, :, -1]
    # bottom wall y=0
    fn[2, 0, :] = f[4, 0, :]
    fn[5, 0, :] = f[7, 0, :]
    fn[6, 0, :] = f[8, 0, :]

    # top moving lid y=NY-1 (written last: wins the two top corners)
    rho_top = sum_dirs([f[i, -1, :] for i in range(Q)])
    d5, d6 = lid_deltas(rho_top, u_lid_dyn)
    fn[4, -1, :] = f[2, -1, :]          # d2 = 0 since cx[2] = 0
    fn[7, -1, :] = f[5, -1, :] + d5
    fn[8, -1, :] = f[6, -1, :] + d6
    return fn
