"""Push streaming with periodic wrap or bounce-back walls, and the cavity's
pull streaming (counterpart of lbm_tpu/ops/stream.py: stream_periodic, the
bounce-back fixups and their flat-gather test oracle,
bounceback_fix_dirs_gated as stream_bounceback_gated, stream_cavity; and
stream_cavity_gated, the gated step_planes of the cavity window kernel).
A block of a sharded lattice streams from its one-cell ring
(stream_padded), then takes the walls it holds (bounceback_block,
cavity_walls): what the partitioner makes of lbm_tpu's rolls and edge
updates under its GSPMD steps.

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


def stream_bounceback_gated(f: torch.Tensor, stale: torch.Tensor,
                            b_row: int, t_row: int) -> torch.Tensor:
    """Push bounce-back with the bottom wall at row b_row and the top wall
    at row t_row (-1: none), periodic in y elsewhere: the plain counterpart
    of lbm_tpu/ops/stream.bounceback_fix_dirs_gated, on a band extended by
    ghost rows.

    The periodic push wraps in y within the band. The x-wall columns apply
    on every row; the y-wall reflections and corner holes only on the wall
    rows. Every wall source is a same-row post-collision value, so a wall
    row overwrites every slot that a push from beyond it would fill: the
    walls keep the ghost rows out. The 8 corner holes read `stale` in place,
    slot (i, y, x) taking stale[i, y, x]. The write order is JAX's, which
    encodes the reference's serial corner winners (src/streaming.cpp:
    70-105): column then row for directions 5, 7 and 8, row then column for
    6. With the rows at (0, NY-1) this is stream_bounceback(f, stale).

    f: (..., Q, NY, NX) post-collision populations; stale: the same shape
    (pre-collision f for the f pass, post-collision f plus the neutral's
    delta background for the g pass); only directions 5-8 are read."""
    out = stream_periodic(f)
    b, t = int(b_row), int(t_row)
    # axis directions: the x walls on every row, the y walls on theirs
    out[..., 1, :, 0] = f[..., 3, :, 0]
    out[..., 3, :, -1] = f[..., 1, :, -1]
    if b >= 0:
        out[..., 2, b, :] = f[..., 4, b, :]
    if t >= 0:
        out[..., 4, t, :] = f[..., 2, t, :]
    # 5 (+1, +1) <- 7: the column (hole at the top row), then the bottom
    # row (hole at its last column), which wins (5, b, 0)
    col = torch.roll(f[..., 7, :, 0], -1, dims=-1)        # f7[y + 1, 0]
    if t >= 0:
        col[..., t] = stale[..., 5, t, 0]
    out[..., 5, :, 0] = col
    if b >= 0:
        out[..., 5, b, :-1] = f[..., 7, b, 1:]
        out[..., 5, b, -1] = stale[..., 5, b, -1]
    # 6 (-1, +1) <- 8: the bottom row (hole at column 0), then the column
    # (hole at the top row), which wins (6, b, NX-1)
    if b >= 0:
        out[..., 6, b, 0] = stale[..., 6, b, 0]
        out[..., 6, b, 1:] = f[..., 8, b, :-1]
    col = torch.roll(f[..., 8, :, -1], -1, dims=-1)       # f8[y + 1, NX-1]
    if t >= 0:
        col[..., t] = stale[..., 6, t, -1]
    out[..., 6, :, -1] = col
    # 7 (-1, -1) <- 5: the column (hole at the bottom row), then the top
    # row (hole at column 0; (7, t, NX-1) reflects f5[t, NX-1] in place)
    col = torch.roll(f[..., 5, :, -1], 1, dims=-1)        # f5[y - 1, NX-1]
    if b >= 0:
        col[..., b] = stale[..., 7, b, -1]
    out[..., 7, :, -1] = col
    if t >= 0:
        out[..., 7, t, 0] = stale[..., 7, t, 0]
        out[..., 7, t, 1:-1] = f[..., 5, t, :-2]
        out[..., 7, t, -1] = f[..., 5, t, -1]
    # 8 (+1, -1) <- 6: the column (hole at the bottom row), then the top
    # row (hole at its last column), which wins (8, t, 0)
    col = torch.roll(f[..., 6, :, 0], 1, dims=-1)         # f6[y - 1, 0]
    if b >= 0:
        col[..., b] = stale[..., 8, b, 0]
    out[..., 8, :, 0] = col
    if t >= 0:
        out[..., 8, t, :-1] = f[..., 6, t, 1:]
        out[..., 8, t, -1] = stale[..., 8, t, -1]
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


def stream_padded(p: torch.Tensor) -> torch.Tensor:
    """stream_periodic of a block from its one-cell ring: p is the block
    (..., Q, n, m) padded to (..., Q, n + 2, m + 2) by its neighbours'
    edge rows, columns and corners; out[i, y, x] = p[i, 1 + y - cy,
    1 + x - cx], the same values the roll of the whole lattice moves
    there (the cavity's pull streaming moves them alike)."""
    n, m = p.shape[-2] - 2, p.shape[-1] - 2
    return torch.stack([
        p[..., i, 1 - int(CY[i]):1 - int(CY[i]) + n,
          1 - int(CX[i]):1 - int(CX[i]) + m] for i in range(Q)], dim=-3)


def bounceback_block(out: torch.Tensor, p: torch.Tensor, hole_vals: list,
                     walls) -> torch.Tensor:
    """bounceback_from_periodic on one block of a sharded lattice, IN
    PLACE; returns `out`.

    out: the block's periodic streaming (stream_padded(p)); p: its
    post-collision populations with their one-cell ring, so that every
    reflected source, f_post[i, y, x] = p[i, y + 1, x + 1] for y in
    [-1, n], x in [-1, m], is at hand. walls: (bottom, top, left, right),
    whether the block holds row 0, row NY-1, column 0, column NX-1 of the
    lattice; only those edges are fixed. hole_vals: the 8 corner-hole
    values in HOLE_SLOTS order, read from the block (a slot is used only
    where the block holds both of its walls). The writes keep
    bounceback_from_periodic's order and so its corner winners: the axis
    directions, then for 5 the column and the row (which wins), for 6 the
    row and the column (which wins), for 7 the column and the row (which
    wins), for 8 the column and the row (which wins)."""
    bottom, top, left, right = walls
    n, m = out.shape[-2], out.shape[-1]
    hole = dict(zip(HOLE_SLOTS, hole_vals))
    # axis directions
    if left:
        out[..., 1, :, 0] = p[..., 3, 1:n + 1, 1]
    if right:
        out[..., 3, :, -1] = p[..., 1, 1:n + 1, m]
    if bottom:
        out[..., 2, 0, :] = p[..., 4, 1, 1:m + 1]
    if top:
        out[..., 4, -1, :] = p[..., 2, n, 1:m + 1]
    # 5 (+1, +1) <- 7: f7[y + 1, 0] down the left wall, f7[0, x + 1] along
    # the bottom
    if left:
        out[..., 5, :, 0] = p[..., 7, 2:n + 2, 1]
        if top:
            out[..., 5, -1, 0] = hole[(5, -1, 0)]
    if bottom:
        out[..., 5, 0, :] = p[..., 7, 1, 2:m + 2]
        if right:
            out[..., 5, 0, -1] = hole[(5, 0, -1)]
    # 6 (-1, +1) <- 8: f8[0, x - 1] along the bottom, f8[y + 1, NX-1] up
    # the right wall
    if bottom:
        out[..., 6, 0, :] = p[..., 8, 1, 0:m]
        if left:
            out[..., 6, 0, 0] = hole[(6, 0, 0)]
    if right:
        out[..., 6, :, -1] = p[..., 8, 2:n + 2, m]
        if top:
            out[..., 6, -1, -1] = hole[(6, -1, -1)]
    # 7 (-1, -1) <- 5: f5[y - 1, NX-1] up the right wall, f5[NY-1, x - 1]
    # along the top, whose last site reflects f5 in place
    if right:
        out[..., 7, :, -1] = p[..., 5, 0:n, m]
        if bottom:
            out[..., 7, 0, -1] = hole[(7, 0, -1)]
    if top:
        out[..., 7, -1, :] = p[..., 5, n, 0:m]
        if left:
            out[..., 7, -1, 0] = hole[(7, -1, 0)]
        if right:
            out[..., 7, -1, -1] = p[..., 5, n, m]
    # 8 (+1, -1) <- 6: f6[y - 1, 0] up the left wall, f6[NY-1, x + 1]
    # along the top
    if left:
        out[..., 8, :, 0] = p[..., 6, 0:n, 1]
        if bottom:
            out[..., 8, 0, 0] = hole[(8, 0, 0)]
    if top:
        out[..., 8, -1, :] = p[..., 6, n, 2:m + 2]
        if right:
            out[..., 8, -1, -1] = hole[(8, -1, -1)]
    return out


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
    y = NY-1 the lid: stream_cavity_gated with the walls at the grid's
    edge rows, which overwrite every direction the roll wraps.
    """
    return stream_cavity_gated(f, u_lid_dyn, 0, f.shape[-2] - 1)


def stream_cavity_gated(f: torch.Tensor, u_lid_dyn: float, b_row: int,
                        l_row: int) -> torch.Tensor:
    """stream_cavity with the bottom wall at row b_row and the lid at row
    l_row (-1: none), periodic in y elsewhere: the step_planes of
    lbm_tpu/kernels/fused_cavity._make_multistep_kernel (gated=True), which
    runs on a shard extended by ghost rows. The rolls wrap in y within the
    block, the side walls span every row, then the bottom wall and the lid
    are written in that order. Every wall source is read from f, which is
    never written: the rolls build a fresh tensor, and only that one is
    updated in place.
    """
    fn = torch.stack([torch.roll(f[i], shifts=(int(CY[i]), int(CX[i])),
                                 dims=(0, 1)) for i in range(Q)])
    return cavity_walls(fn, f, u_lid_dyn, b_row, l_row)


def cavity_walls(fn: torch.Tensor, f: torch.Tensor, u_lid_dyn: float,
                 b_row: int, l_row: int, left: bool = True,
                 right: bool = True) -> torch.Tensor:
    """The cavity's walls written IN PLACE into the streamed fn from the
    post-collision f (both (Q, n, m)); returns fn. The side walls span
    every row of the columns held (left: x = 0, right: x = NX-1; a block
    of a sharded lattice holds them only at the lattice's edge), then the
    bottom wall at row b_row and the lid at row l_row (-1: none). Every
    source is a site's own population."""
    if left:
        # left wall x=0: incoming +x directions reflect from their opposites
        fn[1, :, 0] = f[3, :, 0]
        fn[8, :, 0] = f[6, :, 0]
        fn[5, :, 0] = f[7, :, 0]
    if right:
        # right wall x=NX-1
        fn[3, :, -1] = f[1, :, -1]
        fn[7, :, -1] = f[5, :, -1]
        fn[6, :, -1] = f[8, :, -1]
    if b_row >= 0:
        fn[2, b_row, :] = f[4, b_row, :]
        fn[5, b_row, :] = f[7, b_row, :]
        fn[6, b_row, :] = f[8, b_row, :]
    if l_row >= 0:
        # the moving lid, written last: wins the two top corners
        rho_top = sum_dirs([f[i, l_row, :] for i in range(Q)])
        d5, d6 = lid_deltas(rho_top, u_lid_dyn)
        fn[4, l_row, :] = f[2, l_row, :]      # d2 = 0 since cx[2] = 0
        fn[7, l_row, :] = f[5, l_row, :] + d5
        fn[8, l_row, :] = f[6, l_row, :] + d6
    return fn
