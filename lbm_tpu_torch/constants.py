"""Lattice stencils (counterpart of lbm_tpu/constants.py): D2Q9 for the
2-D models, D3Q19 for the 3-D plasma column.

    index:   0  1  2  3  4  5  6  7  8
    cx:      0  1  0 -1  0  1 -1 -1  1
    cy:      0  0  1  0 -1  1  1 -1 -1
    w:     4/9, 1/9 x4, 1/36 x4
    opp:     0  3  4  1  2  7  8  5  6

Plain numpy, so the values reach torch code and the CUDA kernel's host
parameters as Python scalars, never as tensors.
"""
from __future__ import annotations

import numpy as np


class D2Q9:
    """Two-dimensional, nine-velocity lattice."""

    Q = 9
    DIM = 2

    CX = np.array([0, 1, 0, -1, 0, 1, -1, -1, 1], dtype=np.int32)
    CY = np.array([0, 0, 1, 0, -1, 1, 1, -1, -1], dtype=np.int32)
    W = np.array(
        [4.0 / 9.0]
        + [1.0 / 9.0] * 4
        + [1.0 / 36.0] * 4,
        dtype=np.float64,
    )
    OPP = np.array([0, 3, 4, 1, 2, 7, 8, 5, 6], dtype=np.int32)

    # Ideal-stencil cs^2. The plasma model recomputes cs2 from the SI unit
    # scales (units.py), which equals 1/3 only up to rounding.
    CS2 = 1.0 / 3.0


class D3Q19:
    """Three-dimensional, nineteen-velocity lattice: the rest particle, 6
    face neighbours, 12 edge neighbours; w0 = 1/3, face 1/18, edge 1/36."""

    Q = 19
    DIM = 3

    _c = [
        (0, 0, 0),
        (1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1),
        (1, 1, 0), (-1, -1, 0), (1, -1, 0), (-1, 1, 0),
        (1, 0, 1), (-1, 0, -1), (1, 0, -1), (-1, 0, 1),
        (0, 1, 1), (0, -1, -1), (0, 1, -1), (0, -1, 1),
    ]
    CX = np.array([c[0] for c in _c], dtype=np.int32)
    CY = np.array([c[1] for c in _c], dtype=np.int32)
    CZ = np.array([c[2] for c in _c], dtype=np.int32)
    W = np.array(
        [1.0 / 3.0]
        + [1.0 / 18.0] * 6
        + [1.0 / 36.0] * 12,
        dtype=np.float64,
    )
    # the opposite of direction i: each non-rest pair (2k-1, 2k) is (c, -c)
    OPP = np.array([0] + [i + 1 if i % 2 else i - 1 for i in range(1, 19)],
                   dtype=np.int32)
    CS2 = 1.0 / 3.0
