"""solve_fft_efield_tpu: the spectral Poisson solve with E from k-space in
one CUDA kernel call (counterpart of
lbm_tpu/kernels/fft_tpu.py:solve_fft_efield_tpu).

rho_q (NY, NX) float32 -> (Ex, Ey) float32: the periodic Poisson equation
with the 5-point eigenvalue 4 (sin^2(pi ky/NY) + sin^2(pi kx/NX)), the k = 0
mode zeroed, and E from the central-difference symbol (sy - i sx), scaled
by 1/(NY NX), so that Ex = Re and Ey = Im of one complex inverse transform;
phi is never formed. Both axes are (power of two) * 128.

On CUDA tensors the wrapper launches csrc/fft_solve.cu (three passes of
radix-16 FFTs in shared memory, four stages a barrier, two real rows a
line in the first, x bit-reversed between them in a scratch tiled by
column panels; LAUNCHES counts one a solve) or raises. On CPU tensors it
runs the plain version, solve_fft_efield_reference: the JAX package's
permuted four-step (solve_fft_efield_xla) in torch. Per axis, N = A * 128:
radix-2 Stockham stages over A, a twiddle multiply, and a 128-point DFT as
four real products; the spectrum stays permuted (position a*128 + q holds
wavenumber A*q + a) and the symbols come in the same order. The host
tables are made in float64 and cast once.
"""
from __future__ import annotations

import contextlib
import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

from . import build

LAUNCHES = 0

_LANES = 128
# the longest axis the kernel takes: one line of it in shared memory (two
# float planes of N + N/32 + 1) must fit a block's 227 KB
MAX_AXIS = 16384


class AxisPlan(NamedTuple):
    """Host constants for one axis of length N = A * 128, in float64."""

    N: int
    A: int
    stage_wr: np.ndarray   # (nstages, A//2) Stockham multipliers
    stage_wi: np.ndarray
    tw_r: np.ndarray       # (A, 128) four-step twiddle w_N^{c0*s}, [s, c0]
    tw_i: np.ndarray
    m_r: np.ndarray        # (128, 128) DFT matrix w_128^{c0*q}, [c0, q]
    m_i: np.ndarray


@functools.lru_cache(maxsize=None)
def make_axis_plan(N: int) -> AxisPlan:
    """lbm_tpu/kernels/fft_tpu.py:make_axis_plan, without its cast to
    float32 (the plain version casts once, to the dtype it computes in)."""
    if N % _LANES or (N // _LANES) & (N // _LANES - 1):
        raise ValueError(f"axis length {N} is not (power of two) * 128")
    A = N // _LANES
    swr, swi = [], []
    l, m = A // 2, 1
    while l >= 1:
        j = np.arange(l)
        w = np.repeat(np.exp(-1j * np.pi * j / l), m)   # granularity m
        swr.append(w.real)
        swi.append(w.imag)
        l //= 2
        m *= 2
    # A == 1 (axis length 128) has no Stockham stage: a 1-element
    # placeholder, never read
    stage_wr = np.stack(swr) if swr else np.zeros((1, 1))
    stage_wi = np.stack(swi) if swi else np.zeros((1, 1))
    s = np.arange(A)[:, None]
    c0 = np.arange(_LANES)[None, :]
    tw = np.exp(-2j * np.pi * (s * c0) / N)
    mm = np.exp(-2j * np.pi
                * (np.arange(_LANES)[:, None] * np.arange(_LANES)[None, :])
                / _LANES)
    return AxisPlan(N, A, stage_wr, stage_wi, tw.real, tw.imag,
                    mm.real, mm.imag)


def perm_indices(N: int) -> np.ndarray:
    """k held at flat spectrum position p = a*128 + q is perm[p] = A*q + a."""
    A = N // _LANES
    a, q = divmod(np.arange(N), _LANES)
    return A * q + a


def bitrev_indices(N: int) -> np.ndarray:
    """k held at position p of the kernel's layout: p's bits reversed."""
    bits = int(N).bit_length() - 1
    p = np.arange(N)
    k = np.zeros(N, dtype=np.int64)
    for b in range(bits):
        k |= ((p >> b) & 1) << (bits - 1 - b)
    return k


def _symbols(k: np.ndarray, N: int) -> Tuple[np.ndarray, np.ndarray]:
    """(sin^2(pi k/N), sin(2 pi k/N)) in float64, for wavenumbers k."""
    k = k.astype(np.float64)
    return np.sin(np.pi * k / N) ** 2, np.sin(2.0 * np.pi * k / N)


@functools.lru_cache(maxsize=None)
def grad_vectors(NY: int, NX: int):
    """Permuted-order symbol vectors (siny2, sy) over ky rows and (sinx2,
    sx) over kx columns, in float64 (lbm_tpu/kernels/fft_tpu.py:251)."""
    return (*_symbols(perm_indices(NY), NY), *_symbols(perm_indices(NX), NX))


def supports(NY: int, NX: int) -> bool:
    """True when both axes are (power of two) * 128."""
    def ok(n):
        return n % _LANES == 0 and (n // _LANES) & (n // _LANES - 1) == 0
    return ok(NY) and ok(NX) and NY // _LANES >= 1 and NX // _LANES >= 1


# ---------------------------------------------------------------------------
# The plain version: the permuted four-step of solve_fft_efield_xla
# ---------------------------------------------------------------------------

class _Tables(NamedTuple):
    stage_wr: torch.Tensor   # (nstages, A//2)
    stage_wi: torch.Tensor
    tw_r: torch.Tensor       # (A, 128)
    tw_i: torch.Tensor
    m_r: torch.Tensor        # (128, 128)
    m_i: torch.Tensor


@functools.lru_cache(maxsize=16)
def _tables(N: int, dtype: torch.dtype, device: torch.device) -> _Tables:
    plan = make_axis_plan(N)
    return _Tables(*(torch.as_tensor(t, dtype=dtype, device=device)
                     for t in plan[2:]))


def _stages(xr, xi, A: int, tb: _Tables, axis: int, conj: bool):
    """Radix-2 Stockham DIF over the length-A dim `axis`: DFT_A, or with
    conj its unnormalised inverse."""
    if A == 1:
        return xr, xi
    trail = [1] * (xr.dim() - axis - 1)
    l, m = A // 2, 1
    for st in range(int(np.log2(A))):
        wr = tb.stage_wr[st].reshape(-1, *trail)
        wi = tb.stage_wi[st].reshape(-1, *trail)
        if conj:
            wi = -wi
        a1r, a1i = xr.narrow(axis, 0, l * m), xi.narrow(axis, 0, l * m)
        a2r, a2i = xr.narrow(axis, l * m, l * m), xi.narrow(axis, l * m, l * m)
        sr, si = a1r + a2r, a1i + a2i
        dr, di = a1r - a2r, a1i - a2i
        tr = dr * wr - di * wi
        ti = dr * wi + di * wr

        def inter(s_, t_, l=l, m=m):
            sh = list(s_.shape)
            view = sh[:axis] + [l, m] + sh[axis + 1:]
            st_ = torch.stack([s_.reshape(view), t_.reshape(view)],
                              dim=axis + 1)              # (..., l, 2, m, ...)
            return st_.reshape(sh[:axis] + [2 * l * m] + sh[axis + 1:])

        xr, xi = inter(sr, tr), inter(si, ti)
        l //= 2
        m *= 2
    return xr, xi


def _dft128(xr, xi, tb: _Tables, conj: bool):
    """128-point DFT over the last dim as four real products."""
    mr, mi = tb.m_r, (-tb.m_i if conj else tb.m_i)
    zr = torch.matmul(xr, mr) - torch.matmul(xi, mi)
    zi = torch.matmul(xr, mi) + torch.matmul(xi, mr)
    return zr, zi


def _twiddle(xr, xi, tw_r, tw_i):
    return xr * tw_r - xi * tw_i, xr * tw_i + xi * tw_r


def fft_x_permuted(xr, xi, A: int, tb: _Tables, conj: bool = False):
    """Length-N transform along the last dim of (..., N) -> permuted
    spectrum; conj runs the unnormalised inverse from the same layout."""
    sh = xr.shape
    v = (*sh[:-1], A, _LANES)
    xr, xi = xr.reshape(v), xi.reshape(v)
    ax = xr.dim() - 2
    tw_i = -tb.tw_i if conj else tb.tw_i
    if not conj:
        xr, xi = _stages(xr, xi, A, tb, axis=ax, conj=False)
        zr, zi = _dft128(*_twiddle(xr, xi, tb.tw_r, tw_i), tb, conj=False)
    else:
        zr, zi = _dft128(xr, xi, tb, conj=True)
        zr, zi = _stages(*_twiddle(zr, zi, tb.tw_r, tw_i), A, tb, axis=ax,
                         conj=True)
    return zr.reshape(sh), zi.reshape(sh)


def fft_y_permuted(xr, xi, A: int, tb: _Tables, conj: bool = False):
    """Length-N transform along dim 0 of (N, C) -> permuted spectrum along
    dim 0; the 128-point DFT contracts the inner row dim."""
    N, C = xr.shape
    xr, xi = xr.reshape(A, _LANES, C), xi.reshape(A, _LANES, C)
    tw_r = tb.tw_r[:, :, None]
    tw_i = (-tb.tw_i if conj else tb.tw_i)[:, :, None]

    def dft_rows(zr, zi):
        zr, zi = _dft128(zr.transpose(1, 2), zi.transpose(1, 2), tb, conj)
        return zr.transpose(1, 2), zi.transpose(1, 2)

    if not conj:
        xr, xi = _stages(xr, xi, A, tb, axis=0, conj=False)
        zr, zi = dft_rows(*_twiddle(xr, xi, tw_r, tw_i))
    else:
        zr, zi = dft_rows(xr, xi)
        zr, zi = _stages(*_twiddle(zr, zi, tw_r, tw_i), A, tb, axis=0,
                         conj=True)
    return zr.reshape(N, C), zi.reshape(N, C)


def _apply_grad(zr, zi, siny2, sy, sinx2, sx, scale: float):
    """C_hat = phi_hat (sy - i sx), phi_hat = rho_hat * inv_eig * scale;
    y-vectors (NY, 1), x-vectors (1, NX). The k = 0 guard is on the
    denominator in the working dtype."""
    denom = 4.0 * (siny2 + sinx2)
    live = denom > 1e-15
    safe = torch.where(live, denom, torch.ones_like(denom))
    inv = torch.where(live, torch.full_like(safe, scale) / safe,
                      torch.zeros_like(denom))
    a = inv * sy                      # Re G
    b = inv * sx                      # -Im G  (G = a - i b)
    return zr * a + zi * b, zi * a - zr * b


@contextlib.contextmanager
def _full_precision_matmul():
    """float32 products in full float32 (no TF32), as JAX's
    Precision.HIGHEST."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def solve_fft_efield_reference(rho_q: torch.Tensor,
                               dtype: torch.dtype = torch.float32
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: the permuted four-step solve in `dtype` (float32, as
    the JAX oracle; float64 holds the same algebra to 1e-12 in the tests),
    returned in rho_q's dtype."""
    NY, NX = rho_q.shape
    dev = rho_q.device
    tbx, tby = _tables(NX, dtype, dev), _tables(NY, dtype, dev)
    v4 = grad_vectors(NY, NX)
    sy2, sy = (torch.as_tensor(v.reshape(NY, 1), dtype=dtype, device=dev)
               for v in v4[:2])
    sx2, sx = (torch.as_tensor(v.reshape(1, NX), dtype=dtype, device=dev)
               for v in v4[2:])
    zr = rho_q.to(dtype)
    zi = torch.zeros_like(zr)
    ax, ay = NX // _LANES, NY // _LANES
    with _full_precision_matmul():
        zr, zi = fft_x_permuted(zr, zi, ax, tbx)
        zr, zi = fft_y_permuted(zr, zi, ay, tby)
        cr, ci = _apply_grad(zr, zi, sy2, sy, sx2, sx, 1.0 / (NY * NX))
        cr, ci = fft_y_permuted(cr, ci, ay, tby, conj=True)
        cr, ci = fft_x_permuted(cr, ci, ax, tbx, conj=True)
    return cr.to(rho_q.dtype), ci.to(rho_q.dtype)


# ---------------------------------------------------------------------------
# The kernel
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def kernel_tables(NY: int, NX: int) -> Tuple[np.ndarray, ...]:
    """The kernel's float32 tables (float64 cast once): the twiddles
    exp(-2 pi i k/N), k < N, of x and y as (N, 2) (re, im), and the
    symbols (sin^2(pi k/N), sin(2 pi k/N)) of x and y as (N, 2), each row
    for the wavenumber that the kernel's bit-reversed layout holds there."""
    def twiddles(N):
        w = np.exp(-2j * np.pi * np.arange(N) / N)
        return np.stack([w.real, w.imag], axis=1).astype(np.float32)

    def symbols(N):
        return np.stack(_symbols(bitrev_indices(N), N),
                        axis=1).astype(np.float32)

    return twiddles(NX), twiddles(NY), symbols(NX), symbols(NY)


@functools.lru_cache(maxsize=8)
def _device_tables(NY: int, NX: int, device: torch.device):
    return tuple(torch.as_tensor(t, device=device)
                 for t in kernel_tables(NY, NX))


def _check(rho_q: torch.Tensor) -> None:
    if rho_q.dtype != torch.float32:
        raise TypeError(f"solve_fft_efield_tpu: rho_q must be float32, got "
                        f"{rho_q.dtype}")
    if rho_q.dim() != 2 or not supports(*rho_q.shape):
        raise ValueError(f"solve_fft_efield_tpu: rho_q of shape "
                         f"{tuple(rho_q.shape)}; want (NY, NX) with both "
                         f"axes (power of two) * 128")
    if not rho_q.is_contiguous():
        raise ValueError("solve_fft_efield_tpu: rho_q must be contiguous")


def solve_fft_efield_tpu(rho_q: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """rho_q (NY, NX) float32, contiguous -> (Ex, Ey) float32."""
    global LAUNCHES
    _check(rho_q)
    if rho_q.device.type == "cpu":
        return solve_fft_efield_reference(rho_q)
    if rho_q.device.type != "cuda":
        raise ValueError(f"solve_fft_efield_tpu: rho_q on {rho_q.device}; "
                         f"want a CUDA device (or the CPU)")
    NY, NX = rho_q.shape
    if max(NY, NX) > MAX_AXIS:
        raise ValueError(f"solve_fft_efield_tpu: axis length {max(NY, NX)} "
                         f"exceeds {MAX_AXIS}, the longest line a block of "
                         f"the kernel holds in shared memory")
    tw_x, tw_y, sym_x, sym_y = _device_tables(NY, NX, rho_q.device)
    scratch = torch.empty((NY, NX, 2), dtype=torch.float32,
                          device=rho_q.device)
    ex, ey = torch.empty_like(rho_q), torch.empty_like(rho_q)
    lib = build.load()
    stream = torch.cuda.current_stream(rho_q.device).cuda_stream
    err = lib.lbm_fft_solve_efield(
        *(t.data_ptr() for t in (rho_q, tw_x, tw_y, sym_x, sym_y, scratch,
                                 ex, ey)), NY, NX, stream)
    if err:
        raise RuntimeError(f"solve_fft_efield_tpu: CUDA error {err} at "
                           f"launch ({NY}x{NX})")
    LAUNCHES += 1
    return ex, ey
