"""The 3-D, 2-D and cavity kernels' tile programs, the halo kernels'
per-site code and the spectral solve's transforms, built for the CPU,
against their plain versions.

lbm_tpu_torch/kernels/csrc/plasma3d_tile.cuh is the block program of
csrc/fused_step3d.cu (both entries: the periodic step and the halo step of
a shard), with its arithmetic in plasma3d_site.cuh. With host stand-ins for
its two CUDA headers (_STUBS) it compiles with the host's C++ compiler,
without fused multiply-adds (-ffp-contract=off, as the card's build uses
-fmad=false); its thread loops become serial loops and tile3_host runs the
runs one after another, staging and storing them with the same indices as
the card (the aligned route's copies and vector stores as memcpy). Every
float operation is IEEE-rounded on both sides, so the result must equal
kernels.fused_step3d.collide_stream3d_reference bit for bit, in f64, f32 and
bf16 storage, with and without neutral-delta storage, on seeded warm states
at 12x16x8, 16x16x1 and 17x13x2 (x, y, z) with the card's run widths; and,
built with runs of 8 sites, at a ragged last run (NX = 12), NX < W (3),
NX = 1 and NX = W + 1 (9), for the periodic step and for a z-shard, a
y-shard and a tile of each. chip_smoke.py phase 8a holds the CUDA build.

lbm_tpu_torch/kernels/csrc/plasma_tile.cuh is the block program of the
2-D plasma's collide: csrc/fused_step.cu's periodic step and collide
without the stream, and every collide stage of csrc/fused_multistep.cu's
window (the whole grid, periodic or walled, and the gated window's bands),
with its arithmetic in plasma_site.cuh and its wall rules in
multistep_site.cuh. Built the same way with runs of 8 sites (one build),
the per-step modes must equal fused_step.collide_stream_reference and
collide_reference bit for bit in every mode at the run edges NX = 1, 3,
9, 17 and 24 (the aligned route); and a K = 3 constant-E window of it
(decode, K stages ping-ponging in the compute type, odd stages walking the
runs backwards, encode) must equal
fused_multistep.collide_stream_multistep_reference and
_gated_reference bit for bit on seven bands of a 20-row grid, at NX = 11
and 24. Copies of the header with one line changed (a reflected slot, a
corner hole's value, the x wrap, a ragged run's last site) must fail that
(chip_smoke.py phases 3, 3c, 7a and 13a hold the CUDA build).

lbm_tpu_torch/kernels/csrc/halo_site.cuh holds the per-site work of the
halo kernels (csrc/fused_step.cu's halo mode): which strip a site of the
extended block reads, and which of its pushes land in the shard. Built the
same way, a loop over the extended block's sites must equal
kernels.fused_step.collide_stream_halo_reference (a y-shard) and
collide_stream_halo2d_reference (a tile) bit for bit, at an 8x16 shard and
a ragged 13x11 one that wraps around the grid's corner (chip_smoke.py phase
10a holds the CUDA build).

The same host build of plasma3d_tile.cuh must equal
fused_step3d.halo3d_reference bit for bit on a z-shard, a y-shard, a
(dz, dy) tile and a tile that is the whole grid (its strips the grid's own
wrap), in f64 and bf16 storage: which strip a run reads (the shard, a
slice, a row or a corner line), with which plane stride, and which of its
destination rows lie in the shard; and copies of the header with one line
changed (the corner line taken, the axis that wraps, a strip's plane
stride, the x-neighbour collided again at the row's wrap) must fail that
(chip_smoke.py phase 12a holds the CUDA build).

lbm_tpu_torch/kernels/csrc/cavity_tile.cuh holds the block programs of the
cavity kernels (csrc/fused_cavity.cu), with their per-site work in
cavity_site.cuh: the step program (strips by spans of rows, a ring of four
collided rows; where a halo row comes from: a strip, the block's other
end, or nowhere behind a wall; the pull with its walls and lid) and the
window's resident route (bands of rows kept across the window, their edge
rows exchanged between two phases a step). Built the same way with blocks
of 8 sites and resident blocks of 8 threads holding 4 sites (one build),
the step program must equal the plain versions of the stored and lean
halo steps and of the single-device steps bit for bit, with ragged spans
and strips, on ragged shards that hold the bottom wall, neither wall and
the lid, on the whole grid and at its run edges (NX = 1, 3, 7, 9, 10, 21,
a grid of 3 rows), from a seeded state and from rest; both window routes
(the streaming route's passes, and the resident route's blocks played
phase by phase with the barrier between them) must equal the gated
window's plain version on those shards and on periodic and walled blocks
cut into 1-row, ragged and single bands, K = 1, 2, 3 and 17; div_pos must
give the IEEE quotient for zero, subnormal, tiny and ordinary dividends;
and copies of the headers with one line changed (a reflected slot, the
ring's row lag, a published edge row, the lid's row) must fail
(chip_smoke.py phases 6a and 11a hold the CUDA build).

lbm_tpu_torch/kernels/csrc/fft_solve.cuh holds the three per-block programs
of csrc/fft_solve.cu (two real rows a line forward, column panel solve, row
inverse, through a scratch tiled by column panels), whose block-stride loops
become serial loops on the host; a loop over the blocks then does what the
grid does. Its radix-16 transforms sum in another order than the plain
version's permuted four-step, so the host build is held at 1e-5 of scale
(chip_smoke.py phase 9a's gate for the CUDA build) at 128x256, 256x128,
128x128 and 512x256, on seeded charge densities.

lbm_tpu_torch/kernels/csrc/poisson_tile.cuh holds the per-tile program of
the tiled iterative solve (csrc/poisson_iter.cu): the colour passes in place
on a tile and the part of its ring they reach, in shared memory, the border
and ring exchange through two planes, the error. The host build runs every tile of a cut of the plane one after
another, sweep by sweep, with the exchange between sweeps, and must equal
kernels.poisson_iter.solve_iter_reference (the plain sweeps) bit for bit,
sweep count included: GS, SOR and NPS, periodic and interior-only, f64 and
f32, at 16x24, 10x140 and (interior-only: odd periodic planes take the
streaming loop) 15x21, on cuts into one tile and into tiles that do not divide the
plane, for 60 sweeps, to tol 1e-8, from a phi0 holding a NaN (one sweep)
and with max_iter 0. Copies of the header with one line changed (a row's
colour, the order of the neighbour sum, the ring's side columns) must fail
that
(chip_smoke.py phase 3b holds the CUDA build).
"""
import ctypes
import dataclasses
import shutil
import subprocess

import numpy as np
import pytest
import torch

from lbm_tpu_torch.config import CavityConfig, PlasmaConfig
from lbm_tpu_torch.kernels import (fft_tpu, fused_cavity, fused_step,
                                   fused_step3d, poisson_iter)
from lbm_tpu_torch.kernels.build import CSRC
from lbm_tpu_torch.kernels.fused_step import _MODES, host_params
from lbm_tpu_torch.models import cavity, plasma, plasma3d

torch.set_num_threads(1)

# host stand-ins for the two CUDA headers the site code includes: the
# execution-space keywords vanish, bf16 converts as CUDA's intrinsics do
# (round to nearest even, NaN kept quiet)
_STUBS = {
    "cuda_bf16.h": r"""
#pragma once
#include <cstdint>
#include <cstring>

#define __host__
#define __device__
#define __forceinline__ inline
#define __global__

struct __nv_bfloat16 {
  uint16_t x;
};

inline float __bfloat162float(__nv_bfloat16 b) {
  const uint32_t u = static_cast<uint32_t>(b.x) << 16;
  float f;
  std::memcpy(&f, &u, sizeof f);
  return f;
}

inline __nv_bfloat16 __float2bfloat16(float f) {
  uint32_t u;
  std::memcpy(&u, &f, sizeof u);
  __nv_bfloat16 b;
  if ((u & 0x7fffffffu) > 0x7f800000u) {
    b.x = static_cast<uint16_t>((u >> 16) | 0x40u);
    return b;
  }
  u += 0x7fffu + ((u >> 16) & 1u);
  b.x = static_cast<uint16_t>(u >> 16);
  return b;
}
""",
    "cuda_runtime.h": r"""
#pragma once
typedef int cudaError_t;
const cudaError_t cudaErrorInvalidValue = 1;
typedef void* cudaStream_t;
""",
}
_HOST_LOOP = r"""
#include "halo_site.cuh"

template <typename S, typename T, bool DELTA, bool FAST>
void run_halo(const void* const* ptr, void* fo, void* go, void* rq,
              const HaloGeom& gm, const HostParams& hp) {
  const Params<T> p = cast_params<T>(hp);
  const auto pop = [&](int k) { return static_cast<const S*>(ptr[k]); };
  const auto fld = [&](int k) { return static_cast<const T*>(ptr[k]); };
  const HaloIn<S, T> in{pop(0),  pop(1),  fld(2),  fld(3),  pop(4),
                        pop(5),  fld(6),  fld(7),  pop(8),  pop(9),
                        fld(10), fld(11), pop(12), pop(13), fld(14),
                        fld(15), pop(16), pop(17), fld(18), fld(19)};
  for (int64_t site = 0; site < halo_sites(gm); ++site)
    collide_stream_halo_site<S, T, DELTA, FAST>(
        in, static_cast<S*>(fo), static_cast<S*>(go), static_cast<T*>(rq),
        gm, site, p);
}

#define RUN_HALO(S, T, FAST)                                           \
  (delta ? run_halo<S, T, true, FAST>(ptr, fo, go, rq, gm, *hp)        \
         : run_halo<S, T, false, FAST>(ptr, fo, go, rq, gm, *hp))

extern "C" int host_collide_stream_halo(int mode, int delta,
                                        const void* const* ptr, void* fo,
                                        void* go, void* rq, const int* geom,
                                        const HostParams* hp) {
  const HaloGeom gm{geom[0], geom[1], geom[2], geom[3],
                    geom[4], geom[5], geom[6]};
  if (mode == 0) RUN_HALO(double, double, false);
  else if (mode == 1) RUN_HALO(float, float, false);
  else RUN_HALO(__nv_bfloat16, float, true);
  return 0;
}
"""


def _build_host(tmp_path_factory, name, source, stubs, csrc=CSRC,
                flags=(), opt="-O0"):
    """Build `source` with the host's C++ compiler against the headers in
    `csrc` (and the header stand-ins) into a library; skip without a
    compiler. Unoptimised unless `opt` says otherwise: most builds run
    for less time than -O1 takes to compile them (the rounding is IEEE's
    at either level, no contraction)."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the site code with")
    d = tmp_path_factory.mktemp(name)
    for header, text in stubs.items():
        (d / header).write_text(text)
    src, lib = d / f"{name}.cpp", d / f"lib{name}.so"
    src.write_text(source)
    r = subprocess.run([cxx, opt, "-std=c++17", "-ffp-contract=off",
                        "-fno-fast-math", "-fPIC", "-shared",
                        "-Wno-unknown-pragmas", *flags, f"-I{d}",
                        f"-I{csrc}", str(src), "-o", str(lib)],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return ctypes.CDLL(str(lib))


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    so = _build_host(tmp_path_factory, "host_loop", _HOST_LOOP, _STUBS)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    so.host_collide_stream_halo.argtypes = [ci, ci, *[vp] * 6]
    so.host_collide_stream_halo.restype = ci
    return so


def _seeded(cfg, seed):
    """The initial state after 2 plain steps with a seeded relative
    perturbation of ~1e-3 (numpy, float64), Ey and Ez additive."""
    state = plasma3d.init_state(cfg, "cpu")
    step = plasma3d.make_step(dataclasses.replace(cfg, backend="plain"))
    for _ in range(2):
        state = step(state)
    rng = np.random.default_rng(seed)
    e = 1e-3 * float(state.Ex.abs().max())

    def perturb(t, additive=0.0):
        a = t.double().numpy()
        noise = rng.standard_normal(a.shape)
        return torch.from_numpy(a * (1 + 1e-3 * noise)
                                + additive * noise).to(t.dtype).contiguous()

    return state._replace(f=perturb(state.f), g=perturb(state.g),
                          Ex=perturb(state.Ex), Ey=perturb(state.Ey, e),
                          Ez=perturb(state.Ez, e))


def _phys3d(cfg, delta):
    u = cfg.units()
    return dict(taus=cfg.taus, q_e=u.q_e, q_i=u.q_i, m_e=u.m_e, m_i=u.m_i,
                cs2=u.cs2, kb=u.kb,
                neutral_ref=u.rho_n_init if delta else 0.0)


def _periodic3d_mismatches(so, st, dtype, delta, phys):
    """[(output, differing elements)] of the host build's periodic step
    against collide_stream3d_reference on the state st."""
    want = fused_step3d.collide_stream3d_reference(
        st.f, st.g, st.Ex, st.Ey, st.Ez, **phys)
    got = (torch.empty_like(st.f), torch.empty_like(st.g),
           torch.empty_like(st.Ex))
    hp = host_params(**phys)
    so.host_collide_stream3d(
        _MODES[(st.f.dtype, dtype)], int(delta),
        *(t.data_ptr() for t in (st.f, st.g, st.Ex, st.Ey, st.Ez)),
        *(t.data_ptr() for t in got), *st.Ex.shape, ctypes.addressof(hp))
    return [(name, int((a != b).sum())) for name, a, b
            in zip(("f", "g", "rho_q"), got, want) if not torch.equal(a, b)]


_MODES3D = [(torch.float64, "native", False), (torch.float64, "native", True),
            (torch.float32, "native", False), (torch.float32, "native", True),
            (torch.float32, "bf16", False), (torch.float32, "bf16", True)]


@pytest.mark.parametrize("shape", [(12, 16, 8), (16, 16, 1), (17, 13, 2)],
                         ids=lambda s: "x".join(map(str, s)))
def test_site_code_matches_plain_version_bitwise(host_tile3, shape):
    """plasma3d_tile.cuh's periodic step with the card's run widths (one run
    a row here: NX < W) against collide_stream3d_reference, bit for bit."""
    nx, ny, nz = shape
    for dtype, storage, delta in _MODES3D:
        cfg = PlasmaConfig(NX=nx, NY=ny, NZ=nz, dtype=dtype, storage=storage,
                           neutral_delta=delta)
        st = _seeded(cfg, nz * 10000 + ny * 100 + nx)
        bad = _periodic3d_mismatches(host_tile3, st, dtype, delta,
                                     _phys3d(cfg, delta))
        assert bad == [], f"{storage} {dtype} delta={delta}: {bad}"


# the run edges with runs of 8 sites (x, y, z): a ragged last run, a row
# shorter than a run, a row of one site, a row one site longer than a run;
# each also cut into a z-shard, a y-shard and a tile across the corner
_RUN_EDGES = {"ragged": (12, 5, 4), "nx<w": (3, 5, 4), "nx=1": (1, 5, 4),
              "nx=w+1": (9, 5, 4)}
_EDGE_CUTS = {"z-shard": (slice(1, 3), None), "y-shard": (None, slice(1, 4)),
              "tile": (slice(3, 5), slice(4, 7))}


@pytest.mark.parametrize("edge", list(_RUN_EDGES))
def test_tile_program_run_edges_bitwise(host_tile3_w8, edge):
    """plasma3d_tile.cuh built with 8-site runs at the run's edges, the
    periodic step against collide_stream3d_reference and three shards
    against halo3d_reference, bit for bit, in every mode (f32 at NX = 12
    takes the aligned route: TMA copies and vector stores, here memcpy)."""
    nx, ny, nz = _RUN_EDGES[edge]
    bad = []
    for dtype, storage, delta in _MODES3D:
        cfg = PlasmaConfig(NX=nx, NY=ny, NZ=nz, dtype=dtype, storage=storage,
                           neutral_delta=delta)
        phys = _phys3d(cfg, delta)
        st = _seeded(cfg, nz * 10000 + ny * 100 + nx)
        where = f"{storage} {dtype} delta={delta}"
        bad += [(where, "periodic", m) for m in _periodic3d_mismatches(
            host_tile3_w8, st, dtype, delta, phys)]
        bad += [(where, cut, m) for cut, m in _halo3d_outputs(
            host_tile3_w8, st, dtype, delta, phys, _EDGE_CUTS)]
    assert bad == []


def _seeded2d(cfg, seed):
    """(f, g, Ex, Ey) after 2 plain steps, with a seeded relative
    perturbation of ~1e-3 (numpy, float64), Ey additive."""
    state = plasma.init_state(cfg, "cpu")
    step = plasma.make_step(dataclasses.replace(cfg, backend="plain"))
    for _ in range(2):
        state = step(state)
    rng = np.random.default_rng(seed)
    e = 1e-3 * float(state.Ex.abs().max())

    def perturb(t, additive=0.0):
        a = t.double().numpy()
        noise = rng.standard_normal(a.shape)
        return torch.from_numpy(a * (1 + 1e-3 * noise)
                                + additive * noise).to(t.dtype).contiguous()

    return (perturb(state.f), perturb(state.g), perturb(state.Ex),
            perturb(state.Ey, e))


# (shard rows, shard columns, strip depth, corner extension) of a 24x32
# grid (NY x NX): a y-shard or tile of 8x16, and a ragged 13x11 one
_HALO_CUTS = [(slice(8, 16), slice(16, 32), 1, 1),
              (slice(19, 32), slice(27, 38), 3, 2)]


@pytest.mark.parametrize("cut", _HALO_CUTS, ids=["8x16", "13x11"])
@pytest.mark.parametrize("tile", [False, True], ids=["y-shard", "tile"])
def test_halo_site_code_matches_plain_version_bitwise(host_kernel, cut,
                                                      tile):
    """csrc/halo_site.cuh (the halo kernels' per-site code) against
    collide_stream_halo_reference / _halo2d_reference, bit for bit, on a
    y-shard (periodic in x) and a tile (x strips, corners), at an aligned
    and a ragged shape; the 13x11 cut wraps around the grid's corner."""
    rows, cols, depth, ext = cut
    for dtype, storage, delta in [(torch.float64, "native", False),
                                  (torch.float64, "native", True),
                                  (torch.float32, "bf16", True)]:
        cfg = PlasmaConfig(NX=32, NY=24, dtype=dtype, storage=storage,
                           neutral_delta=delta)
        u = cfg.units()
        phys = dict(taus=cfg.taus, q_e=u.q_e, q_i=u.q_i, m_e=u.m_e,
                    m_i=u.m_i, cs2=u.cs2, kb=u.kb,
                    neutral_ref=u.rho_n_init if delta else 0.0)
        full = _seeded2d(cfg, rows.stop * 100 + cols.stop)
        args = fused_step.halo_inputs(full, rows, cols if tile else None,
                                      depth, ext)
        plain = (fused_step.collide_stream_halo2d_reference if tile
                 else fused_step.collide_stream_halo_reference)
        want = plain(*args, **phys)
        f, g, ex = args[:3]
        got = (torch.empty_like(f), torch.empty_like(g), torch.empty_like(ex))
        ptrs = (ctypes.c_void_p * 20)(*(a.data_ptr() for a in args))
        geom = (ctypes.c_int * 7)(
            *ex.shape, args[6].shape[0], args[10].shape[0], ext if tile else 0,
            args[14].shape[-1] if tile else 0,
            args[18].shape[-1] if tile else 0)
        hp = host_params(**phys)
        host_kernel.host_collide_stream_halo(
            _MODES[(f.dtype, dtype)], int(delta), ctypes.addressof(ptrs),
            *(t.data_ptr() for t in got), ctypes.addressof(geom),
            ctypes.addressof(hp))
        for name, a, b in zip(("f", "g", "rho_q"), got, want):
            assert torch.equal(a, b), (
                f"{storage} {dtype} delta={delta} {name}: "
                f"{int((a != b).sum())} of {a.numel()} elements differ")


_TILE3_HOST = r"""
#include "plasma3d_tile.cuh"

template <typename S, typename T, bool DELTA, bool FAST>
void run_tiles(const void* const* ptr, void* fo, void* go, void* rq,
               const Geom3& gm, const HostParams& hp) {
  Tile3Args<S, T> a{};
  for (int k = 0; k < 9; ++k)
    a.src[k] = {static_cast<const S*>(ptr[5 * k]),
                static_cast<const S*>(ptr[5 * k + 1]),
                static_cast<const T*>(ptr[5 * k + 2]),
                static_cast<const T*>(ptr[5 * k + 3]),
                static_cast<const T*>(ptr[5 * k + 4])};
  a.f_out = static_cast<S*>(fo);
  a.g_out = static_cast<S*>(go);
  a.rho_q = static_cast<T*>(rq);
  a.gm = gm;
  a.aligned = tile3_aligned(a);
  tile3_host<S, T, DELTA, FAST>(a, hp);
}

#define RUN_TILES(S, T, FAST)                                       \
  (delta ? run_tiles<S, T, true, FAST>(ptr, fo, go, rq, gm, *hp)   \
         : run_tiles<S, T, false, FAST>(ptr, fo, go, rq, gm, *hp))

static int run_mode(int mode, int delta, const void* const* ptr, void* fo,
                    void* go, void* rq, const Geom3& gm,
                    const HostParams* hp) {
  if (mode == 0) RUN_TILES(double, double, false);
#ifndef F64_ONLY
  else if (mode == 1) RUN_TILES(float, float, false);
  else RUN_TILES(__nv_bfloat16, float, true);
#endif
  return 0;
}

extern "C" int host_collide_stream3d(int mode, int delta, const void* f,
                                     const void* g, const void* Ex,
                                     const void* Ey, const void* Ez, void* fo,
                                     void* go, void* rq, int NZ, int NY,
                                     int NX, const HostParams* hp) {
  const void* ptr[45] = {f, g, Ex, Ey, Ez};
  return run_mode(mode, delta, ptr, fo, go, rq, Geom3{NZ, NY, NX, 0, 0}, hp);
}

extern "C" int host_collide_stream_halo3d(int mode, int delta,
                                          const void* const* ptr, void* fo,
                                          void* go, void* rq,
                                          const int* geom,
                                          const HostParams* hp) {
  const Geom3 gm{geom[0], geom[1], geom[2], geom[3], geom[4]};
  return run_mode(mode, delta, ptr, fo, go, rq, gm, hp);
}
"""


def _host_tile3(tmp_path_factory, name, csrc=CSRC, flags=()):
    so = _build_host(tmp_path_factory, name, _TILE3_HOST, _STUBS, csrc,
                     flags)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    so.host_collide_stream3d.argtypes = [ci, ci, *[vp] * 8, ci, ci, ci, vp]
    so.host_collide_stream3d.restype = ci
    so.host_collide_stream_halo3d.argtypes = [ci, ci, *[vp] * 6]
    so.host_collide_stream_halo3d.restype = ci
    return so


@pytest.fixture(scope="module")
def host_tile3(tmp_path_factory):
    """The tile program with the card's run widths (64 sites, f64 32)."""
    return _host_tile3(tmp_path_factory, "host_tile3")


@pytest.fixture(scope="module")
def host_tile3_w8(tmp_path_factory):
    """The tile program with runs of 8 sites."""
    return _host_tile3(tmp_path_factory, "host_tile3_w8",
                       flags=["-DPLASMA3D_RUN=8"])


# (slices, rows) of a 6x12x6 grid (NZ x NY x NX), None for an axis that
# stays whole and wraps: a z-shard, a y-shard, a tile across the grid's
# corner, and the whole grid as a tile; NZl != NYl on every shard, so a
# strip read with another strip's plane stride shows
_HALO3D_CUTS = {"z-shard": (slice(2, 5), None),
                "y-shard": (None, slice(3, 8)),
                "tile": (slice(4, 7), slice(9, 14)),
                "whole-tile": (slice(0, 6), slice(0, 12))}
_HALO3D_MODES = [(torch.float64, "native", False),
                 (torch.float64, "native", True),
                 (torch.float32, "bf16", True)]


def _halo3d_outputs(so, st, dtype, delta, phys, cuts):
    """[(cut, output)] where the host build's halo step differs from
    halo3d_reference on the cuts of the state st."""
    bad = []
    arrays = (st.f, st.g, st.Ex, st.Ey, st.Ez)
    for cut, (zs, ys) in cuts.items():
        shard, zhalo, yrows, corners = fused_step3d.halo_inputs3d(
            arrays, zs, ys)
        want = fused_step3d.halo3d_reference(shard, zhalo, yrows, corners,
                                             **phys)
        groups = [shard, *(zhalo or (None,) * 2), *(yrows or (None,) * 2),
                  *(corners or (None,) * 4)]
        tensors = [t for grp in groups for t in (grp or (None,) * 5)]
        ptrs = (ctypes.c_void_p * 45)(
            *(None if t is None else t.data_ptr() for t in tensors))
        geom = (ctypes.c_int * 5)(*shard[2].shape, int(zhalo is not None),
                                  int(yrows is not None))
        got = [torch.empty_like(w) for w in want]
        hp = host_params(**phys)
        so.host_collide_stream_halo3d(
            _MODES[(shard[0].dtype, dtype)], int(delta), ptrs,
            *(t.data_ptr() for t in got), geom, ctypes.addressof(hp))
        bad += [(cut, name) for name, a, b in zip(("f", "g", "rho_q"), got,
                                                  want)
                if not torch.equal(a, b)]
    return bad


def _halo3d_mismatches(so, modes):
    """[(mode, cut, output)] where the host build differs from
    halo3d_reference on _HALO3D_CUTS."""
    bad = []
    for dtype, storage, delta in modes:
        cfg = PlasmaConfig(NX=6, NY=12, NZ=6, dtype=dtype, storage=storage,
                           neutral_delta=delta)
        st = _seeded(cfg, 6126)
        bad += [(f"{storage} {dtype} delta={delta}", cut, name)
                for cut, name in _halo3d_outputs(
                    so, st, dtype, delta, _phys3d(cfg, delta), _HALO3D_CUTS)]
    return bad


def test_halo3d_site_code_matches_plain_versions_bitwise(host_tile3):
    """plasma3d_tile.cuh's halo step on every geometry against
    halo3d_reference (the plain versions of collide_stream_halo3d, _panel3d
    with halo_rows and _panel3d_zhalo), bit for bit."""
    assert _halo3d_mismatches(host_tile3, _HALO3D_MODES) == []


# one-line changes of plasma3d_tile.cuh, each of which the bitwise hold must
# catch: (what it breaks, the line as it is, the line changed)
_HALO3D_MUTATIONS = {
    "corner row": ("a.src[u.z < 0 ? (u.y < 0 ? 5 : 6)",
                   "a.src[u.z < 0 ? (u.y < 0 ? 6 : 5)"),
    "wrap axis": ("  if (gm.yh) {", "  if (gm.zh) {"),
    "strip stride": ("    u.vol = static_cast<int64_t>(NZ) * NX;",
                     "    u.vol = static_cast<int64_t>(NY) * NX;"),
    "x edge": ("(u.x0 == 0 ? NX - 1 : u.x0 - 1)", "(u.x0 == 0 ? 0 : u.x0 - 1)"),
}


@pytest.mark.parametrize("what", list(_HALO3D_MUTATIONS))
def test_halo3d_site_code_mutations_fail(tmp_path_factory, what):
    before, after = _HALO3D_MUTATIONS[what]
    csrc = tmp_path_factory.mktemp("csrc_" + what.replace(" ", "_"))
    for header in CSRC.glob("*.cuh"):
        text = header.read_text()
        if header.name == "plasma3d_tile.cuh":
            assert text.count(before) == 1, f"{what}: line not found"
            text = text.replace(before, after)
        (csrc / header.name).write_text(text)
    so = _host_tile3(tmp_path_factory, "mutant", csrc, ["-DF64_ONLY"])
    assert _halo3d_mismatches(so, _HALO3D_MODES[:2]), (
        f"the '{what}' mutation passed the bitwise hold")


_CAVITY_HOST = r"""
#include <vector>

#include "cavity_tile.cuh"

using namespace cavity;

// one step of the block: the step program's tasks one after another, the
// plan made for `resident` blocks (odd counts walk the tasks backwards)
template <typename S, typename T>
void run_step(int lean, const void* const* p, void* const* o, double u, double tau,
              const Geom& g, int resident) {
  const StepIn<S, T> in{static_cast<const S*>(p[0]), static_cast<const T*>(p[1]),
                        static_cast<const T*>(p[2]), static_cast<const T*>(p[3]),
                        static_cast<const S*>(p[4]), static_cast<const T*>(p[5]),
                        static_cast<const S*>(p[6]), static_cast<const T*>(p[7])};
  const StepPlan plan = step_plan<T>(g.NY, g.NX, resident);
  const bool rev = resident & 1;
  if (lean) {
    const StepTask<S, S, T, true> a{in, static_cast<S*>(o[0]), nullptr, nullptr,
                                    nullptr};
    step_host(a, g, plan, static_cast<T>(tau), static_cast<T>(u), rev);
  } else {
    const StepTask<S, S, T, false> a{in, static_cast<S*>(o[0]), static_cast<T*>(o[1]),
                                     static_cast<T*>(o[2]), static_cast<T*>(o[3])};
    step_host(a, g, plan, static_cast<T>(tau), static_cast<T>(u), rev);
  }
}

template <typename In, typename Out, typename T>
void pass(const In* src, Out* dst, const Geom& g, const StepPlan& plan, T tau, T u,
          bool rev) {
  const StepTask<In, Out, T, true> a{
      {src, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr},
      dst, nullptr, nullptr, nullptr};
  step_host(a, g, plan, tau, u, rev);
}

// the window: the resident route on `blocks` bands (route 1), or the
// streaming route's passes ping-ponging in T (route 0); returns 1 if the
// resident route refuses the grid
template <typename S, typename T>
int run_window(const void* f, void* fo, const Geom& g, const Window<T>& w, int route,
               int blocks) {
  const S* fs = static_cast<const S*>(f);
  S* fd = static_cast<S*>(fo);
  if (route == 1) {
    const ResPlan p = res_plan<T>(g.NY, g.NX, w.K, blocks, INT64_MAX);
    if (p.blocks == 0) return 1;
    res_host(fs, fd, g, w, p);
    return 0;
  }
  std::vector<T> a(static_cast<size_t>(kQ) * g.NY * g.NX), b(a.size());
  const StepPlan plan = step_plan<T>(g.NY, g.NX, blocks);
  for (int k = 0; k < w.K; ++k) {
    const T u = lid_ramp(w, k);
    T* prev = (k & 1) ? a.data() : b.data();
    T* next = (k & 1) ? b.data() : a.data();
    const bool rev = k & 1;
    if (w.K == 1)
      pass<S, S, T>(fs, fd, g, plan, w.tau, u, rev);
    else if (k == 0)
      pass<S, T, T>(fs, next, g, plan, w.tau, u, rev);
    else if (k == w.K - 1)
      pass<T, S, T>(prev, fd, g, plan, w.tau, u, rev);
    else
      pass<T, T, T>(prev, next, g, plan, w.tau, u, rev);
  }
  return 0;
}

template <typename S, typename T>
int window_of(const void* f, void* fo, const Geom& g, int t0, int K, double u_lid,
              double sigma, double tau, int route, int blocks) {
  return run_window<S, T>(f, fo, g, make_window<T>(t0, K, u_lid, sigma, tau), route,
                          blocks);
}

#ifdef F64_ONLY
#define BY_MODE(fn, ...) fn<double, double>(__VA_ARGS__)
#else
#define BY_MODE(fn, ...)                                              \
  (mode == 0   ? fn<double, double>(__VA_ARGS__)                      \
   : mode == 1 ? fn<float, float>(__VA_ARGS__)                        \
               : fn<__nv_bfloat16, float>(__VA_ARGS__))
#endif

extern "C" int host_cavity_step(int mode, int lean, const void* const* p, void* const* o,
                                double u, double tau, const int* geom, int resident) {
  const Geom g{geom[0], geom[1], geom[2], geom[3], geom[4], geom[5]};
  BY_MODE(run_step, lean, p, o, u, tau, g, resident);
  return 0;
}

// div_pos element by element: out = x / d (f64 or f32 by mode)
extern "C" void host_div_pos(int mode, const void* x, double d, void* out, int n) {
  for (int k = 0; k < n; ++k) {
    if (mode == 0)
      static_cast<double*>(out)[k] = div_pos(static_cast<const double*>(x)[k], d);
    else
      static_cast<float*>(out)[k] =
          div_pos(static_cast<const float*>(x)[k], static_cast<float>(d));
  }
}

extern "C" int host_cavity_window(int mode, const void* f, void* fo, int t0, int K,
                                  double u_lid, double sigma, double tau, const int* geom,
                                  int route, int blocks) {
  const Geom g{geom[0], geom[1], 0, 0, geom[2], geom[3]};
  return BY_MODE(window_of, f, fo, g, t0, K, u_lid, sigma, tau, route, blocks);
}
"""

# the card's build is W = 128 (64 in f64) sites a strip and resident blocks
# of 1,024 threads holding 4 sites each (f64: 512 holding 2); the host's
# strips of 8 sites and blocks of 8 threads holding 4 walk the same code on
# small grids, a chunk a row
_CAVITY_FLAGS = ["-DCAVITY_RUN=8", "-DCAVITY_RES_THREADS=8",
                 "-DCAVITY_HOLD=4"]


def _host_cavity(tmp_path_factory, name, csrc=CSRC, flags=()):
    so = _build_host(tmp_path_factory, name, _CAVITY_HOST, _STUBS, csrc,
                     [*_CAVITY_FLAGS, *flags])
    vp, ci, cd = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    so.host_cavity_step.argtypes = [ci, ci, vp, vp, cd, cd, vp, ci]
    so.host_cavity_window.argtypes = [ci, vp, vp, ci, ci, cd, cd, cd, vp,
                                      ci, ci]
    so.host_cavity_window.restype = ci
    so.host_div_pos.argtypes = [ci, vp, cd, vp, ci]
    so.host_div_pos.restype = None
    return so


@pytest.fixture(scope="module")
def host_cavity(tmp_path_factory):
    return _host_cavity(tmp_path_factory, "host_cavity")


def _cavity_warm(cfg, seed):
    """A cavity state 12 plain steps in (past the sigma = 10 lid ramp), with
    a seeded relative perturbation of ~1e-3 of the full populations and the
    stored macros (numpy, float64; the velocities additive)."""
    plain = dataclasses.replace(cfg, backend="plain")
    st = cavity.make_rollout(plain, 12)(cavity.init_state(plain, "cpu"))
    rng = np.random.default_rng(seed)

    def perturb(t, additive=0.0):
        a = t.double().numpy()
        noise = rng.standard_normal(a.shape)
        return torch.from_numpy(a * (1 + 1e-3 * noise) + additive * noise
                                ).to(cfg.dtype)

    f = cavity.encode_f(cfg, perturb(cavity.decode_f(cfg, st.f)))
    return st._replace(f=f.contiguous(), rho=perturb(st.rho),
                       ux=perturb(st.ux, 1e-4), uy=perturb(st.uy, 1e-4))


_CAVITY_DTYPES = [(torch.float64, "native"), (torch.float32, "native"),
                  (torch.float32, "bf16")]


def _host_step(so, st, cfg, u, lean, rows=None, resident=7):
    """(got, want): the host build's step and the plain version's, on the
    whole grid (rows None: the single-device kernels) or on the shard
    `rows` with 3-deep strips (the halo kernels); the plan made for
    `resident` blocks."""
    tau, dtype = cfg.tau, cfg.dtype
    mode = fused_cavity._MODES[(st.f.dtype, dtype)]
    macros = None if lean else (st.rho, st.ux, st.uy)
    if rows is None:
        args = (st.f,) + (() if lean else macros)
        strips, walls = (None,) * 4, (0, st.f.shape[1] - 1)
        want = (fused_cavity.collide_stream_cavity_lean_reference(
            st.f, u, tau=tau) if lean else
                fused_cavity.collide_stream_cavity_reference(
                    st.f, *macros, u, tau=tau))
    else:
        args, (bottom, top) = fused_cavity.halo_inputs(st.f, macros, rows,
                                                       depth=3)
        strips = (args[1], None, args[2], None) if lean else args[4:]
        NYl = rows.stop - rows.start
        walls = (0 if bottom else -1, NYl - 1 if top else -1)
        want = (fused_cavity.collide_stream_cavity_halo_lean_reference
                if lean else
                fused_cavity.collide_stream_cavity_halo_reference)(
            *args, u, bottom, top, tau=tau)
        args = args[:1] if lean else args[:4]
    want = [want] if lean else list(want)
    got = [torch.empty_like(w) for w in want]
    ins = (ctypes.c_void_p * 8)(
        *(None if t is None else t.data_ptr()
          for t in (args + (None,) * 3)[:4] + tuple(strips)))
    outs = (ctypes.c_void_p * 4)(
        *[t.data_ptr() for t in got] + [None] * (4 - len(got)))
    depth = [0 if s is None else s.shape[1] for s in strips[::2]]
    geom = (ctypes.c_int * 6)(args[0].shape[1], args[0].shape[2], *depth,
                              *walls)
    so.host_cavity_step(mode, int(lean), ins, outs, u, tau, geom, resident)
    return got, want


def _host_window(so, block, wall_rows, cfg, k, route, blocks, step0=4):
    """(got, want): the host build's window of k steps on block from step0
    by `route` (1: resident on `blocks` bands; 0: streaming, the plan made
    for `blocks` blocks) and the gated plain version's; got is None if the
    resident route refuses the grid."""
    kw = dict(tau=cfg.tau, k_steps=k, u_lid=cfg.u_lid, sigma=cfg.sigma)
    want = fused_cavity.collide_stream_cavity_multistep_gated_reference(
        block, step0, wall_rows, **kw)
    got = torch.empty_like(want)
    mode = fused_cavity._MODES[(block.dtype, cfg.dtype)]
    geom = (ctypes.c_int * 4)(*block.shape[1:], *wall_rows)
    refused = so.host_cavity_window(mode, block.data_ptr(), got.data_ptr(),
                                    step0, k, cfg.u_lid, cfg.sigma, cfg.tau,
                                    geom, route, blocks)
    return (None if refused else got), want


def _differ(tag, got, want):
    return [f"{tag}: {int((a != b).sum())} of {a.numel()} elements differ"
            for a, b in zip(got, want) if not torch.equal(a, b)]


# rows of a 45x20 grid (NY x NX): ragged shards that hold the bottom wall,
# neither wall, and the lid, and the whole grid (the single-device kernels)
_CAVITY_CUTS = {"bottom": slice(0, 13), "interior": slice(13, 30),
                "lid": slice(30, 45), "whole": slice(0, 45)}


def _cavity_cut_mismatches(so, where, dtypes=_CAVITY_DTYPES):
    """The stored and lean steps and the K = 3 window (both routes) of the
    cut `where`, against the plain versions: the list of differences."""
    rows = _CAVITY_CUTS[where]
    whole = where == "whole"
    bad = []
    for dtype, storage in dtypes:
        cfg = CavityConfig(NX=20, NY=45, dtype=dtype, storage=storage)
        st = _cavity_warm(cfg, rows.start * 100 + rows.stop)
        u = cavity._lid_speed(cfg, 15)
        tag = f"{where} {storage} {dtype}"
        for lean in (False, True):
            got, want = _host_step(so, st, cfg, u, lean,
                                   None if whole else rows)
            bad += _differ(f"{tag} {'lean' if lean else 'stored'}", got,
                           want)
        k = 3
        block, wall_rows = ((st.f, (0, 44)) if whole else
                            fused_cavity.window_inputs(st.f, rows, k))
        for route, blocks in ((0, 7), (1, 4)):
            got, want = _host_window(so, block, wall_rows, cfg, k, route,
                                     blocks)
            assert got is not None, f"{tag}: the resident route refused"
            bad += _differ(f"{tag} window route {route}", [got], [want])
    return bad


@pytest.mark.parametrize("where", list(_CAVITY_CUTS))
def test_cavity_site_code_matches_plain_versions_bitwise(host_cavity, where):
    """csrc/cavity_tile.cuh (with cavity_site.cuh) against the plain
    versions of the stored and lean steps (the halo kernels on a shard with
    3-deep strips; the single-device kernels on the whole grid), on strips
    of 8 sites and ragged spans, and of the K = 3 window from step 4,
    inside the lid ramp, by both routes (the gated window on the shard
    extended by 3 rows, the single-device one on the whole grid; resident
    on 4 ragged bands of one-row chunks), in f64, f32 and bf16 storage, bit
    for bit."""
    assert _cavity_cut_mismatches(host_cavity, where) == []


def _cavity_seeded(ny, nx, dtype, storage, seed):
    """A random cavity state (f a ~5% seeded perturbation of the rest
    state, the stored macros its own, ~1e-3 perturbed; numpy float64), or
    the rest state itself (seed None: exact zeros in every velocity and
    f - feq)."""
    cfg = CavityConfig(NX=nx, NY=ny, dtype=dtype, storage=storage)
    st = cavity.init_state(cfg, "cpu")
    if seed is None:
        return cfg, st
    rng = np.random.default_rng(seed)
    full = cavity.decode_f(cfg, st.f).double().numpy()
    full = full * (1 + 5e-2 * rng.standard_normal(full.shape))
    ff = torch.from_numpy(full).to(dtype)
    mac = [m.double().numpy() for m in cavity.macros_of(
        cfg, cavity.encode_f(cfg, ff))]
    rho, ux, uy = (torch.from_numpy(m * (1 + 1e-3 * rng.standard_normal(
        m.shape))).to(dtype) for m in mac)
    return cfg, st._replace(f=cavity.encode_f(cfg, ff).contiguous(), rho=rho,
                            ux=ux, uy=uy)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_div_pos_is_the_ieee_quotient(host_cavity, dtype):
    """div_pos (the quotient behind a zero test) against the IEEE
    quotient, bit for bit: zeros of both signs, subnormal, tiny and
    ordinary dividends, by the divisors a cavity divides by (densities near
    1, tau in [0.5, 2]) and by small and large ones."""
    info = torch.finfo(dtype)
    rng = np.random.default_rng(7)
    lo, hi = np.log2(float(info.smallest_normal)) - 30, 8.0
    mag = np.exp2(rng.uniform(lo, hi, 20000))
    x = torch.tensor(np.concatenate([mag, -mag, [0.0, -0.0]]), dtype=dtype)
    x = torch.cat([x, torch.tensor([float(info.tiny) * k for k in
                                    (0.5, 1, 2, 3.7)], dtype=dtype),
                   torch.tensor([2.0 ** e for e in (-32, -33, -256, -257,
                                                    -62, -126, -127, -149,
                                                    -422, -1022, -1074)],
                                dtype=dtype)])
    mode = 0 if dtype == torch.float64 else 1
    bad = []
    for d in (1.0, 0.99999994, 1.0000001, 0.5, 0.887, 1.3, 2.0, 1e-10,
              3.0e5, 7.0e30):
        want = x / torch.tensor(d, dtype=dtype)
        got = torch.empty_like(x)
        host_cavity.host_div_pos(mode, x.data_ptr(), d, got.data_ptr(),
                                 x.numel())
        same = got.view(torch.int64 if mode == 0 else torch.int32) == \
            want.view(torch.int64 if mode == 0 else torch.int32)
        if not bool(same.all()):
            bad.append(f"d={d}: {int((~same).sum())} quotients differ, "
                       f"e.g. x={float(x[~same][0])!r}")
    assert bad == []


# the step program's run edges, with strips of W = 8 sites: (NY, NX, plan's
# blocks): NX = 1, 3, W - 1, W + 1 and W + 2 (the card's 127, 129, 130), a
# ragged strip, NY = 3, shorter than the span the plan asks for (cut to
# the grid's rows), and ragged last spans
_CAVITY_RUN_EDGES = [(11, 1, 5), (11, 3, 3), (13, 7, 4), (9, 9, 5),
                     (10, 10, 3), (3, 12, 1), (17, 21, 5)]


def test_cavity_tile_run_edges_bitwise(host_cavity):
    """The step program at its run edges, stored and lean, single-device
    and on a walled and a wall-free shard, on a seeded state and on the
    rest state (exact zero dividends), in f64, f32 and bf16 storage, bit
    for bit."""
    bad = []
    for ny, nx, resident in _CAVITY_RUN_EDGES:
        for dtype, storage in _CAVITY_DTYPES:
            for seed in (ny * 100 + nx, None):
                cfg, st = _cavity_seeded(ny, nx, dtype, storage, seed)
                u = cavity._lid_speed(cfg, 15)
                for rows in (None, slice(0, ny - 1), slice(1, ny - 1)):
                    for lean in (False, True):
                        got, want = _host_step(host_cavity, st, cfg, u, lean,
                                               rows, resident)
                        bad += _differ(
                            f"{ny}x{nx} {storage} {dtype} seed {seed} rows "
                            f"{rows} lean {lean}", got, want)
    assert bad == []


# the window's routes: (NY, NX, wall rows (None: the grid's edges), K,
# resident bands, capped by the plan at 2 NY / 3); 1-row bands, one band
# that is its own neighbour, ragged bands, walls inside the block and none
# (periodic in y), K = 1 (the streaming route alone), 2 and 17
_CAVITY_ROUTES = [(12, 6, None, 2, 9), (12, 6, None, 17, 1),
                  (14, 5, (3, 10), 2, 4), (14, 5, (-1, -1), 17, 5),
                  (15, 9, (2, -1), 2, 11), (13, 8, (-1, 7), 17, 3),
                  (9, 3, None, 1, 2)]


def _cavity_route_mismatches(so, dtypes=_CAVITY_DTYPES, cases=_CAVITY_ROUTES):
    bad = []
    for ny, nx, walls, k, blocks in cases:
        for dtype, storage in dtypes:
            cfg, st = _cavity_seeded(ny, nx, dtype, storage, ny * nx + k)
            wall_rows = (0, ny - 1) if walls is None else walls
            for route in (0, 1):
                got, want = _host_window(so, st.f, wall_rows, cfg, k, route,
                                         blocks)
                tag = f"{ny}x{nx} walls {wall_rows} K={k} {storage} {dtype}"
                if got is None:
                    assert route == 1 and k == 1, f"{tag}: resident refused"
                    continue
                bad += _differ(f"{tag} route {route} on {blocks}", [got],
                               [want])
    return bad


def test_cavity_window_routes_bitwise(host_cavity):
    """Both window routes on periodic and walled blocks, the resident one on
    1-row, ragged and single bands, against the gated plain version, bit
    for bit; K = 1 is the streaming route's alone."""
    assert _cavity_route_mismatches(host_cavity) == []


# one-line changes of the cavity block programs, each of which the bitwise
# holds must catch: (what it breaks, file, the line as it is, the line
# changed)
_CAVITY_MUTATIONS = {
    "reflected slot": ("cavity_site.cuh",
                       "    out[i] = blocked ? post(opp_of(i), 0, 0) : "
                       "post(i, -cy, -cx);",
                       "    out[i] = blocked ? post(i, 0, 0) : "
                       "post(i, -cy, -cx);"),
    "ring's row lag": ("cavity_tile.cuh",
                       "    const T* rows[3] = {ring + ((y - 1) & 3) * SLOT,"
                       " ring + (y & 3) * SLOT,",
                       "    const T* rows[3] = {ring + ((y - 2) & 3) * SLOT,"
                       " ring + (y & 3) * SLOT,"),
    "published edge row": ("cavity_tile.cuh",
                           "      ex[4 * NX + x] = post[5];",
                           "      ex[4 * NX + x] = post[6];"),
    "lid's row": ("cavity_site.cuh",
                  "bottom = y == g.b_row, top = y == g.l_row;",
                  "bottom = y == g.b_row, top = y == g.l_row - 1;"),
}


@pytest.mark.parametrize("what", list(_CAVITY_MUTATIONS))
def test_cavity_tile_mutations_fail(tmp_path_factory, what):
    fname, before, after = _CAVITY_MUTATIONS[what]
    csrc = tmp_path_factory.mktemp("csrc_" + what.replace(" ", "_")
                                   .replace("'", ""))
    for header in CSRC.glob("*.cuh"):
        text = header.read_text()
        if header.name == fname:
            assert text.count(before) == 1, f"{what}: line not found"
            text = text.replace(before, after)
        (csrc / header.name).write_text(text)
    so = _host_cavity(tmp_path_factory, "cavity_mutant", csrc, ["-DF64_ONLY"])
    f64 = _CAVITY_DTYPES[:1]
    assert (_cavity_cut_mismatches(so, "whole", f64)
            or _cavity_route_mismatches(so, f64, _CAVITY_ROUTES[:3])), (
        f"the '{what}' mutation passed the bitwise hold")


_FFT_HOST = r"""
#include <vector>

#include "fft_solve.cuh"

using namespace fftsolve;

extern "C" int host_fft_solve(const float* rho, const float* tw_x,
                              const float* tw_y, const float* sym_x,
                              const float* sym_y, float* scratch, float* ex,
                              float* ey, int NY, int NX) {
  const Tables tb{tw_x, tw_y, sym_x, sym_y,
                  1.0f / (static_cast<float>(NY) * static_cast<float>(NX))};
  const int R = rows_per_block(NY, NX), P = cols_per_panel(NY, NX);
  std::vector<float> row(2 * plane_floats(R, NX));
  std::vector<float> col(2 * plane_floats(P, NY));
  float* row_im = row.data() + plane_floats(R, NX);
  float* col_im = col.data() + plane_floats(P, NY);
  for (int b = 0; b < NY / (2 * R); ++b)
    rows_forward_pair_block(b, rho, scratch, tb, row.data(), row_im, NY, NX, R, P);
  for (int b = 0; b < NX / P; ++b)
    panel_solve_block(b, scratch, tb, col.data(), col_im, NY, NX, P);
  for (int b = 0; b < NY / R; ++b)
    rows_inverse_block(b, scratch, ex, ey, tb, row.data(), row_im, NY, NX, R, P);
  return 0;
}
"""


@pytest.fixture(scope="module")
def host_fft(tmp_path_factory):
    so = _build_host(tmp_path_factory, "host_fft", _FFT_HOST, {})
    so.host_fft_solve.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 2
    so.host_fft_solve.restype = ctypes.c_int
    return so


@pytest.mark.parametrize("shape", [(128, 256), (256, 128), (128, 128),
                                   (512, 256)],
                         ids=lambda s: "x".join(map(str, s)))
def test_fft_solve_header_matches_plain_version(host_fft, shape):
    NY, NX = shape
    for seed, amp in ((1, 1e-8), (2, 1.0)):
        rho = (np.random.default_rng(seed).standard_normal(shape)
               * amp).astype(np.float32)
        tables = fft_tpu.kernel_tables(NY, NX)
        scratch = np.empty((NY, NX, 2), np.float32)
        ex, ey = np.empty(shape, np.float32), np.empty(shape, np.float32)
        assert host_fft.host_fft_solve(
            *(a.ctypes.data for a in (rho, *tables, scratch, ex, ey)),
            NY, NX) == 0
        want = fft_tpu.solve_fft_efield_reference(torch.from_numpy(rho))
        scale = max(float(w.abs().max()) for w in want)
        err = max(float(np.abs(g - w.numpy()).max())
                  for g, w in zip((ex, ey), want))
        assert err < 1e-5 * scale, f"seed {seed}: {err / scale:.3e} of scale"


_TILE_HOST = r"""
#include <vector>

#include "poisson_tile.cuh"

using namespace ptile;

// csrc/poisson_iter.cu's tiled loop with the tiles run one after another:
// each tile reads its ring from the plane of the previous sweep's borders,
// runs the colour passes and writes its border to the other plane; the
// sweep's error is the tiles' maximum
template <typename T, int KIND, bool INTERIOR>
int run(const T* phi0, const T* rho, T* out, int NY, int NX, int ty, int tx,
        int max_iter, double tol, double omega) {
  using U = typename Bits<T>::U;
  const Tiling g{NY, NX, ty, tx};
  const int d = ring_depth(KIND);
  // odd tiles read rho from the plane, even ones from a tiled copy
  std::vector<Tile> tiles;
  std::vector<Layout> L;
  std::vector<std::vector<T>> S, R;
  for (int id = 0; id < ty * tx; ++id) {
    tiles.push_back(tile_of(g, id));
    L.push_back(layout_of(tiles[id], d));
    S.emplace_back(tile_floats(tiles[id], L[id]));
    R.emplace_back(S[id].size());
    load_tile(phi0, S[id].data(), tiles[id], L[id], NY, NX);
    load_tile(rho, R[id].data(), tiles[id], L[id], NY, NX);
  }
  std::vector<T> scratch(static_cast<size_t>(NY) * NX);
  T* planes[2] = {scratch.data(), out};
  const Coeffs<T> k{static_cast<T>(omega), static_cast<T>(1.0 - omega)};
  T err = Bits<T>::val(Bits<T>::kInf);
  int it = 0;
  while (it < max_iter && err >= static_cast<T>(tol)) {
    U m = 0;
    for (int id = 0; id < ty * tx; ++id) {
      if (it > 0) read_ring(planes[(it - 1) & 1], S[id].data(), tiles[id], L[id], NY, NX);
      for (int c = 0; c < d; ++c)
        m = colour_pass<T, KIND, INTERIOR>(S[id].data(), id & 1 ? rho : R[id].data(),
                                           (id & 1) == 0, tiles[id], L[id], d - 1 - c, NY, NX,
                                           c, k, m);
      publish_border(planes[it & 1], S[id].data(), tiles[id], L[id], NX);
    }
    err = Bits<T>::val(m);
    ++it;
  }
  for (int id = 0; id < ty * tx; ++id) store_tile(out, S[id].data(), tiles[id], L[id], NX);
  return it;
}

template <typename T>
int run_kind(int kind, int interior, const void* phi0, const void* rho, void* out, int NY,
             int NX, int ty, int tx, int max_iter, double tol, double omega) {
  const T* p = static_cast<const T*>(phi0);
  const T* r = static_cast<const T*>(rho);
  T* o = static_cast<T*>(out);
#define RUN_TILE(K, I) return run<T, K, I>(p, r, o, NY, NX, ty, tx, max_iter, tol, omega)
  switch (kind * 2 + (interior ? 1 : 0)) {
    case 0: RUN_TILE(kGS, false);
    case 1: RUN_TILE(kGS, true);
    case 2: RUN_TILE(kSOR, false);
    case 3: RUN_TILE(kSOR, true);
    case 4: RUN_TILE(kNPS, false);
    default: RUN_TILE(kNPS, true);
  }
#undef RUN_TILE
}

extern "C" int host_solve_tiles(int dtype, int kind, int interior, double omega, int max_iter,
                                double tol, const void* phi0, const void* rho, void* out,
                                int NY, int NX, int ty, int tx) {
  if (dtype == 0)
    return run_kind<double>(kind, interior, phi0, rho, out, NY, NX, ty, tx, max_iter, tol,
                            omega);
  return run_kind<float>(kind, interior, phi0, rho, out, NY, NX, ty, tx, max_iter, tol, omega);
}

extern "C" int host_in_place(int interior, int NY, int NX) {
  return in_place_equals_plain(interior != 0, NY, NX) ? 1 : 0;
}
"""


def _host_tiles(tmp_path_factory, name, csrc=CSRC, opt="-O0"):
    so = _build_host(tmp_path_factory, name, _TILE_HOST, {}, csrc, opt=opt)
    ci, cd, vp = ctypes.c_int, ctypes.c_double, ctypes.c_void_p
    so.host_solve_tiles.argtypes = [ci, ci, ci, cd, ci, cd, vp, vp, vp, ci,
                                    ci, ci, ci]
    so.host_solve_tiles.restype = ci
    so.host_in_place.argtypes = [ci, ci, ci]
    so.host_in_place.restype = ci
    return so


@pytest.fixture(scope="module")
def host_tiles(tmp_path_factory):
    # optimised: its sweeps run up to 5000 times on each cut
    return _host_tiles(tmp_path_factory, "host_tiles", opt="-O1")


_TILE_KINDS = {"gs": ("gs", None), "sor": ("gs", 1.8), "nps": ("nps", None)}
# (NY, NX): the cuts into (ty, tx) tiles held on each; 16 / 3, 24 / 5,
# 21 / 4 and 140 / 3 leave ragged tiles, (2, 1) and (1, 2) a ring from the
# tile itself on one axis; 10x140 gives rows of more than 32 sites of a
# colour (a warp's run)
_TILE_CUTS = {(16, 24): [(1, 1), (3, 5), (2, 1), (1, 2), (4, 4)],
              (15, 21): [(1, 1), (2, 4), (3, 3)],
              (10, 140): [(1, 1), (2, 1), (1, 3)]}


def _tile_runs(ny, nx, dtype):
    """[(label, phi0, rho, max_iter, tol)] on a seeded plane."""
    rng = np.random.default_rng(ny * nx)
    rho = 0.1 * rng.random((ny, nx))
    rho -= rho.mean()
    phi0 = torch.as_tensor(0.05 * rng.random((ny, nx)), dtype=dtype)
    rho = torch.as_tensor(rho, dtype=dtype)
    nan_phi = phi0.clone()
    nan_phi[ny // 2, nx // 2] = float("nan")
    return [("60 sweeps", phi0, rho, 60, 0.0),
            ("tol 1e-8", phi0, rho, 5000, 1e-8),
            ("NaN", nan_phi, rho, 5000, 1e-8),
            ("max_iter 0", phi0, rho, 0, 1e-8)]


def _tile_mismatches(so, shape, kinds, dtypes=(torch.float64,
                                                torch.float32)):
    """[(case, what)] where the host build of the tiled loop differs from
    the plain sweeps."""
    from lbm_tpu_torch.ops import poisson
    ny, nx = shape
    bad = []
    for dtype in dtypes:
        for label, phi0, rho, max_iter, tol in _tile_runs(ny, nx, dtype):
            for name in kinds:
                kind, omega = _TILE_KINDS[name]
                for interior in (False, True):
                    if not so.host_in_place(int(interior), ny, nx):
                        continue   # the streaming loop's case
                    spec = (kind, omega, max_iter, tol, interior)
                    want = poisson_iter.solve_iter_reference(phi0, rho,
                                                             spec=spec)
                    n_want = poisson.LAST_SWEEPS
                    for ty, tx in _TILE_CUTS[shape]:
                        got = torch.empty_like(phi0)
                        n_got = so.host_solve_tiles(
                            0 if dtype == torch.float64 else 1,
                            {"gs": 0, "nps": 2}[kind] + (omega is not None),
                            int(interior), omega or 0.0, max_iter, tol,
                            phi0.data_ptr(), rho.data_ptr(), got.data_ptr(),
                            ny, nx, ty, tx)
                        case = (f"{dtype} {label} {name} "
                                f"{'int' if interior else 'per'} {ty}x{tx}")
                        if n_got != n_want:
                            bad.append((case, f"{n_got} sweeps vs {n_want}"))
                        elif not torch.equal(_bits(got), _bits(want)):
                            bad.append((case, "phi"))
    return bad


def _bits(t):
    return t.view(torch.int64 if t.element_size() == 8 else torch.int32)


@pytest.mark.parametrize("kind", list(_TILE_KINDS))
@pytest.mark.parametrize("shape", list(_TILE_CUTS),
                         ids=lambda s: "x".join(map(str, s)))
def test_tile_program_matches_plain_sweeps_bitwise(host_tiles, shape, kind):
    """csrc/poisson_tile.cuh's tiled loop on every cut against the plain
    sweeps, phi and the sweep count bit for bit, in f64 and f32."""
    assert host_tiles.host_in_place(1, 15, 21) == 1
    assert host_tiles.host_in_place(0, 15, 21) == 0
    assert host_tiles.host_in_place(0, 16, 24) == 1
    assert _tile_mismatches(host_tiles, shape, [kind]) == []


# one-line changes of poisson_tile.cuh, each of which the bitwise hold must
# catch: (what it breaks, the line as it is, the line changed)
_TILE_MUTATIONS = {
    "row colour": (
        "((c >> 1) - xa) & 1 : (c - xa - yu) & 1;",
        "((c >> 1) - xa) & 1 : (c - yu) & 1;"),
    "sum order": (
        "const T nb5 = ((S[o] + S[o + 1]) + S[s - rs]) + S[s + rs];",
        "const T nb5 = ((S[s - rs] + S[o + 1]) + S[o]) + S[s + rs];"),
    "ring depth": (
        "      const int f = e - 2 * band, g = f / (2 * d), k = f % (2 * d);",
        "      const int f = e - 2 * band, g = f / (2 * d), k = f % d;"),
}


@pytest.mark.parametrize("what", list(_TILE_MUTATIONS))
def test_tile_program_mutations_fail(tmp_path_factory, what):
    before, after = _TILE_MUTATIONS[what]
    csrc = tmp_path_factory.mktemp("csrc_" + what.replace(" ", "_"))
    for header in CSRC.glob("*.cuh"):
        text = header.read_text()
        if header.name == "poisson_tile.cuh":
            assert text.count(before) == 1, f"{what}: line not found"
            text = text.replace(before, after)
        (csrc / header.name).write_text(text)
    so = _host_tiles(tmp_path_factory, "tile_mutant", csrc)
    assert _tile_mismatches(so, (16, 24), list(_TILE_KINDS),
                            (torch.float64,)), (
        f"the '{what}' mutation passed the bitwise hold")


_TILE2_HOST = r"""
#include <utility>
#include <vector>

#include "plasma_tile.cuh"

template <typename S, typename T, bool DELTA, bool FAST>
void run_step(const void* f, const void* g, const void* Ex, const void* Ey,
              void* fo, void* go, void* rq, int NY, int NX, int stream,
              const HostParams& hp) {
  Tile2Args<S, T> a{};
  a.f = static_cast<const S*>(f);
  a.g = static_cast<const S*>(g);
  a.ex = static_cast<const T*>(Ex);
  a.ey = static_cast<const T*>(Ey);
  a.f_out = static_cast<S*>(fo);
  a.g_out = static_cast<S*>(go);
  a.rho_q = static_cast<T*>(rq);
  a.band = {NY, NX, 0, -1, -1};
  a.stream = stream;
  a.aligned = tile2_aligned(a);
  tile2_host<S, T, DELTA, FAST>(a, hp);
}

// fused_multistep.cu's constant-E window: decode, K collide stages of the
// tile program ping-ponging in T, encode. The blocks of a stage run in no
// order on the card; here odd steps walk the runs backwards, so a slot
// that two runs write shows whichever order lets the wrong one win.
template <typename S, typename T, bool DELTA, bool FAST>
void run_window(const void* f, const void* g, const void* Ex, const void* Ey,
                void* fo, void* go, const window::Band& band, int K, int kill,
                const HostParams& hp) {
  const int64_t n = static_cast<int64_t>(kS) * kQ * band.NY * band.NX;
  std::vector<T> a(n), b(n), c(n), d(n);
  for (int64_t e = 0; e < n; ++e) {
    a[e] = Io<S, T>::load(static_cast<const S*>(f) + e);
    b[e] = Io<S, T>::load(static_cast<const S*>(g) + e);
  }
  for (int k = 0; k < K; ++k) {
    Tile2Args<T, T> t{};
    t.f = a.data();
    t.g = b.data();
    t.ex = static_cast<const T*>(Ex);
    t.ey = static_cast<const T*>(Ey);
    t.f_out = c.data();
    t.g_out = d.data();
    t.band = band;
    t.stream = 1;
    t.zero_E = kill && k > 0;
    t.aligned = tile2_aligned(t);
    tile2_host<T, T, DELTA, FAST>(t, hp, k & 1);
    std::swap(a, c);
    std::swap(b, d);
  }
  for (int64_t e = 0; e < n; ++e) {
    Io<S, T>::store(static_cast<S*>(fo) + e, a[e]);
    Io<S, T>::store(static_cast<S*>(go) + e, b[e]);
  }
}

#define BY_DELTA(fn, S, T, FAST, ...)                 \
  (delta ? fn<S, T, true, FAST>(__VA_ARGS__)         \
         : fn<S, T, false, FAST>(__VA_ARGS__))
#ifdef F64_ONLY
#define BY_MODE(fn, ...) BY_DELTA(fn, double, double, false, __VA_ARGS__)
#else
#define BY_MODE(fn, ...)                                               \
  (mode == 0   ? BY_DELTA(fn, double, double, false, __VA_ARGS__)      \
   : mode == 1 ? BY_DELTA(fn, float, float, false, __VA_ARGS__)        \
               : BY_DELTA(fn, __nv_bfloat16, float, true, __VA_ARGS__))
#endif

extern "C" int host_collide_stream2d(int mode, int delta, int stream,
                                     const void* f, const void* g,
                                     const void* Ex, const void* Ey, void* fo,
                                     void* go, void* rq, int NY, int NX,
                                     const HostParams* hp) {
  BY_MODE(run_step, f, g, Ex, Ey, fo, go, rq, NY, NX, stream, *hp);
  return 0;
}

extern "C" int host_window(int mode, int delta, const void* f, const void* g,
                           const void* Ex, const void* Ey, void* fo, void* go,
                           const int* geom, int K, int kill,
                           const HostParams* hp) {
  const window::Band band{geom[0], geom[1], geom[2], geom[3], geom[4]};
  BY_MODE(run_window, f, g, Ex, Ey, fo, go, band, K, kill, *hp);
  return 0;
}
"""


def _host_tile2(tmp_path_factory, name, csrc=CSRC, flags=()):
    """plasma_tile.cuh built with runs of 8 sites."""
    so = _build_host(tmp_path_factory, name, _TILE2_HOST, _STUBS, csrc,
                     ["-DPLASMA_RUN=8", *flags])
    vp, ci = ctypes.c_void_p, ctypes.c_int
    so.host_collide_stream2d.argtypes = [ci, ci, ci, *[vp] * 7, ci, ci, vp]
    so.host_collide_stream2d.restype = ci
    so.host_window.argtypes = [ci, ci, *[vp] * 7, ci, ci, vp]
    so.host_window.restype = ci
    return so


@pytest.fixture(scope="module")
def host_window(tmp_path_factory):
    return _host_tile2(tmp_path_factory, "host_tile2")


def _phys2d(cfg, delta):
    u = cfg.units()
    return dict(taus=cfg.taus, q_e=u.q_e, q_i=u.q_i, m_e=u.m_e, m_i=u.m_i,
                cs2=u.cs2, kb=u.kb,
                neutral_ref=u.rho_n_init if delta else 0.0)


# the run edges with runs of 8 sites (NX): a row of one site, a row
# shorter than a run, a row one site longer than a run, two runs and a
# ragged one, and three whole runs (NX * itemsize a multiple of 16 in every
# mode: the aligned route, TMA copies and vector stores, here memcpy)
_RUN_EDGES2 = (1, 3, 9, 17, 24)


@pytest.mark.parametrize("nx", _RUN_EDGES2, ids=lambda n: f"nx={n}")
def test_tile2_step_matches_plain_versions_bitwise(host_window, nx):
    """plasma_tile.cuh's per-step modes at a run edge (NY = 5): the
    periodic collide + stream against collide_stream_reference in f64, f32
    and bf16 storage, with and without neutral-delta storage, and the
    collide without the stream against collide_reference (f64, f32), bit
    for bit."""
    bad = []
    for dtype, storage, delta in _MODES3D:
        cfg = PlasmaConfig(NX=nx, NY=5, dtype=dtype, storage=storage,
                           neutral_delta=delta)
        phys = _phys2d(cfg, delta)
        f, g, ex, ey = _seeded2d(cfg, 500 + nx)
        hp = host_params(**phys)
        streams = (1, 0) if storage == "native" else (1,)
        for stream in streams:
            plain = (fused_step.collide_stream_reference if stream
                     else fused_step.collide_reference)
            want = plain(f, g, ex, ey, **phys)
            got = [torch.empty_like(w) for w in want]
            host_window.host_collide_stream2d(
                _MODES[(f.dtype, dtype)], int(delta), stream,
                *(t.data_ptr() for t in (f, g, ex, ey, *got)), 5, nx,
                ctypes.addressof(hp))
            bad += [(f"{storage} {dtype} delta={delta} stream={stream}", nm)
                    for nm, a, b in zip(("f", "g", "rho_q"), got, want)
                    if not torch.equal(a, b)]
    assert bad == []


_WINDOW_MODES = [(torch.float64, "native", False),
                 (torch.float64, "native", True),
                 (torch.float32, "native", True),
                 (torch.float32, "bf16", True)]
# (label, shards, shard) of a 20-row bounce-back grid (NY x NX): the whole
# grid (walls at rows 0 and NY-1), the one rank's band that holds both
# walls, the bottom and top shards of a cut in 2 and the middle shard of a
# cut in 3 (neither wall: periodic in y with the x walls); "periodic" is
# the whole grid without walls, "one row" the whole grid with both walls
# on row 5
_WINDOW_BANDS = [("whole", 1, None), ("both", 1, 0), ("bottom", 2, 0),
                 ("top", 2, 1), ("middle", 3, 1), ("periodic", 1, None),
                 ("one row", 1, None)]
_WINDOW_K = 3
# the widths, with runs of 8 sites: a ragged last run (element copies and
# stores), and three whole runs of which the middle one no x wall touches
# (the aligned route)
_WINDOW_NX = (11, 24)


def _window_mismatches(so, modes):
    """[(mode, width, band, kill, output)] where the host build of a K = 3
    window differs from its plain version: collide_stream_multistep_gated_
    reference on each band (ghost rows included), and on the whole grid
    collide_stream_multistep_reference, bounce-back or periodic."""
    from lbm_tpu_torch.config import BC
    from lbm_tpu_torch.kernels import fused_multistep as fm
    bad = []
    K = _WINDOW_K
    for dtype, storage, delta in modes:
        for nx in _WINDOW_NX:
            cfg = PlasmaConfig(NX=nx, NY=20, dtype=dtype, storage=storage,
                               neutral_delta=delta, bc=BC.BOUNCE_BACK)
            phys = _phys2d(cfg, delta)
            full = _seeded2d(cfg, 2000 + nx)
            for label, n, shard in _WINDOW_BANDS:
                if shard is None:
                    arrays = full
                    walls = (5, 5) if label == "one row" else (0, 19)
                else:
                    R = 20 // n
                    arrays, walls = fm.window_inputs(
                        full, slice(shard * R, (shard + 1) * R), K)
                f, g, ex, ey = arrays
                for kill in (True, False):
                    kw = dict(**phys, k_steps=K, kill_field=kill)
                    if label in ("whole", "periodic"):
                        want = fm.collide_stream_multistep_reference(
                            *arrays, bounce=label == "whole", **kw)
                    else:
                        want = fm.collide_stream_multistep_gated_reference(
                            *arrays, walls, **kw)
                    got = (torch.empty_like(f), torch.empty_like(g))
                    geom = (ctypes.c_int * 5)(
                        *ex.shape, int(label != "periodic"), *walls)
                    hp = host_params(**phys)
                    so.host_window(
                        _MODES[(f.dtype, dtype)], int(delta),
                        *(t.data_ptr() for t in (f, g, ex, ey, *got)), geom,
                        K, int(kill), ctypes.addressof(hp))
                    bad += [(f"{storage} {dtype} delta={delta}", nx, label,
                             kill, nm)
                            for nm, a, b in zip(("f", "g"), got, want)
                            if not torch.equal(a, b)]
    return bad


def test_window_site_code_matches_plain_versions_bitwise(host_window):
    """plasma_tile.cuh as the window kernel's collide stage, one K = 3
    window of the constant-E mode, against the plain versions, bit for bit,
    in f64, f32 and bf16 storage, with and without neutral-delta storage
    and the kill quirk, at a ragged and an aligned width: the gated window
    on bands that hold both walls, one wall or neither (the whole extended
    band, ghost rows included) and both walls on one row, and the
    whole-grid window with walls at rows 0 and NY-1 and without walls."""
    assert _window_mismatches(host_window, _WINDOW_MODES) == []


# one-line changes of plasma_tile.cuh, each of which the bitwise hold must
# catch: (what it breaks, the line as it is, the line changed)
_WINDOW_MUTATIONS = {
    "wall slot": ("                                 base + row[cy_of(i) + 1] + x};",
                  "                                 base + row[1] + x};"),
    "corner hole": (
        "(DELTA && s == 2) ? fo + hole_bg[i] : fo);",
        "(DELTA && s == 2) ? fo + hole_bg[i] : go);"),
    "x wrap": ("const int col[3] = {x == 0 ? NX - 1 : x - 1, x, "
               "x == NX - 1 ? 0 : x + 1};",
               "const int col[3] = {x == 0 ? NX - 1 : x - 1, x, "
               "x == NX - 1 ? NX - 1 : x + 1};"),
    "run's last site": ("  u.w = NX - u.x0 < W ? NX - u.x0 : W;",
                        "  u.w = NX - u.x0 < W ? NX - u.x0 - 1 : W;"),
}


@pytest.mark.parametrize("what", list(_WINDOW_MUTATIONS))
def test_window_site_code_mutations_fail(tmp_path_factory, what):
    before, after = _WINDOW_MUTATIONS[what]
    csrc = tmp_path_factory.mktemp("csrc_" + what.replace(" ", "_")
                                   .replace("'", ""))
    for header in CSRC.glob("*.cuh"):
        text = header.read_text()
        if header.name == "plasma_tile.cuh":
            assert text.count(before) == 1, f"{what}: line not found"
            text = text.replace(before, after)
        (csrc / header.name).write_text(text)
    so = _host_tile2(tmp_path_factory, "window_mutant", csrc, ["-DF64_ONLY"])
    assert _window_mismatches(so, _WINDOW_MODES[:2]), (
        f"the '{what}' mutation passed the bitwise hold")
