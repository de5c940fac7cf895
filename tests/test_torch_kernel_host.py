"""The 3-D kernel's per-site code, the halo kernels', the cavity kernels' and
the spectral solve's transforms, built for the CPU, against their plain
versions.

lbm_tpu_torch/kernels/csrc/plasma3d_site.cuh holds all the arithmetic of
csrc/fused_step3d.cu (moments, guards, collide, push-stream stores). With
host stand-ins for its two CUDA headers (_STUBS) it compiles with the host's
C++ compiler, without fused multiply-adds (-ffp-contract=off, as the card's
build uses -fmad=false); a loop over the sites then does what the kernel's
threads do. Every float operation is IEEE-rounded on both sides, so the
result must equal kernels.fused_step3d.collide_stream3d_reference bit for
bit, in f64, f32 and bf16 storage, with and without neutral-delta storage,
on seeded warm states at 12x16x8, 16x16x1 and 17x13x2 (x, y, z). This holds
the kernel's expression trees on every change here; chip_smoke.py phase 8a
holds the CUDA build on the card.

lbm_tpu_torch/kernels/csrc/halo_site.cuh holds the per-site work of the
halo kernels (csrc/fused_step.cu's halo mode): which strip a site of the
extended block reads, and which of its pushes land in the shard. Built the
same way, a loop over the extended block's sites must equal
kernels.fused_step.collide_stream_halo_reference (a y-shard) and
collide_stream_halo2d_reference (a tile) bit for bit, at an 8x16 shard and
a ragged 13x11 one that wraps around the grid's corner (chip_smoke.py phase
10a holds the CUDA build).

lbm_tpu_torch/kernels/csrc/halo3d_site.cuh holds the per-site work of the
3-D halo kernel (csrc/fused_step3d.cu's halo entry): which strip a site of
a shard's extended block reads (the shard, a slice, a row or a corner
line), with which plane stride, and which of its pushes land in the shard.
A loop over the extended block must equal fused_step3d.halo3d_reference
bit for bit on a z-shard, a y-shard, a (dz, dy) tile and a tile that is
the whole grid (its strips the grid's own wrap), in f64 and bf16 storage;
and copies of the header with one line changed (the corner line taken,
the axis that wraps, a strip's plane stride) must fail that (chip_smoke.py
phase 12a holds the CUDA build).

lbm_tpu_torch/kernels/csrc/cavity_site.cuh holds the per-site work of the
cavity kernels (csrc/fused_cavity.cu): where a halo row comes from (a
strip, the block's other end, or nowhere behind a wall), the collision, the
pull with its walls and lid, and the window's lid ramp. A loop over the
block's sites, built the same way, must equal the plain versions of the
stored and lean halo steps and of the gated window bit for bit on ragged
shards that hold the bottom wall, neither wall and the lid, and those of the
single-device steps on the whole grid (chip_smoke.py phases 6a and 11a hold
the CUDA build).

lbm_tpu_torch/kernels/csrc/fft_solve.cuh holds the three per-block programs
of csrc/fft_solve.cu (row forward, column solve, row inverse), whose
block-stride loops become serial loops on the host; a loop over the blocks
then does what the grid does. Its radix-2 transforms sum in another order
than the plain version's permuted four-step, so the host build is held at
1e-5 of scale (chip_smoke.py phase 9a's gate for the CUDA build) at 128x256
and 256x128, on seeded charge densities.
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
                                   fused_step3d)
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
#include "plasma3d_site.cuh"

template <typename S, typename T, bool DELTA, bool FAST>
void run(const void* f, const void* g, const void* Ex, const void* Ey,
         const void* Ez, void* fo, void* go, void* rq, int NZ, int NY, int NX,
         const HostParams& hp) {
  const Params<T> p = cast_params<T>(hp);
  const int64_t vol = static_cast<int64_t>(NZ) * NY * NX;
  for (int64_t site = 0; site < vol; ++site)
    collide_stream_site3d<S, T, DELTA, FAST>(
        static_cast<const S*>(f), static_cast<const S*>(g),
        static_cast<const T*>(Ex), static_cast<const T*>(Ey),
        static_cast<const T*>(Ez), static_cast<S*>(fo), static_cast<S*>(go),
        static_cast<T*>(rq), NZ, NY, NX, site, p);
}

#define RUN(S, T, FAST)                                                     \
  (delta ? run<S, T, true, FAST>(f, g, Ex, Ey, Ez, fo, go, rq, NZ, NY, NX,  \
                                 *hp)                                       \
         : run<S, T, false, FAST>(f, g, Ex, Ey, Ez, fo, go, rq, NZ, NY, NX, \
                                  *hp))

extern "C" int host_collide_stream3d(int mode, int delta, const void* f,
                                     const void* g, const void* Ex,
                                     const void* Ey, const void* Ez, void* fo,
                                     void* go, void* rq, int NZ, int NY,
                                     int NX, const HostParams* hp) {
  if (mode == 0) RUN(double, double, false);
  else if (mode == 1) RUN(float, float, false);
  else RUN(__nv_bfloat16, float, true);
  return 0;
}

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
                flags=()):
    """Build `source` with the host's C++ compiler against the headers in
    `csrc` (and the header stand-ins) into a library; skip without a
    compiler."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the site code with")
    d = tmp_path_factory.mktemp(name)
    for header, text in stubs.items():
        (d / header).write_text(text)
    src, lib = d / f"{name}.cpp", d / f"lib{name}.so"
    src.write_text(source)
    r = subprocess.run([cxx, "-O1", "-std=c++17", "-ffp-contract=off",
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
    so.host_collide_stream3d.argtypes = [ci, ci, *[vp] * 8, ci, ci, ci, vp]
    so.host_collide_stream3d.restype = ci
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


@pytest.mark.parametrize("shape", [(12, 16, 8), (16, 16, 1), (17, 13, 2)],
                         ids=lambda s: "x".join(map(str, s)))
def test_site_code_matches_plain_version_bitwise(host_kernel, shape):
    nx, ny, nz = shape
    for dtype, storage, delta in [
            (torch.float64, "native", False), (torch.float64, "native", True),
            (torch.float32, "native", False), (torch.float32, "native", True),
            (torch.float32, "bf16", False), (torch.float32, "bf16", True)]:
        cfg = PlasmaConfig(NX=nx, NY=ny, NZ=nz, dtype=dtype, storage=storage,
                           neutral_delta=delta)
        u = cfg.units()
        phys = dict(taus=cfg.taus, q_e=u.q_e, q_i=u.q_i, m_e=u.m_e,
                    m_i=u.m_i, cs2=u.cs2, kb=u.kb,
                    neutral_ref=u.rho_n_init if delta else 0.0)
        st = _seeded(cfg, nz * 10000 + ny * 100 + nx)
        want = fused_step3d.collide_stream3d_reference(
            st.f, st.g, st.Ex, st.Ey, st.Ez, **phys)
        got = (torch.empty_like(st.f), torch.empty_like(st.g),
               torch.empty_like(st.Ex))
        hp = host_params(**phys)
        host_kernel.host_collide_stream3d(
            _MODES[(st.f.dtype, dtype)], int(delta),
            *(t.data_ptr() for t in (st.f, st.g, st.Ex, st.Ey, st.Ez)),
            *(t.data_ptr() for t in got), nz, ny, nx, ctypes.addressof(hp))
        for name, a, b in zip(("f", "g", "rho_q"), got, want):
            assert torch.equal(a, b), (
                f"{storage} {dtype} delta={delta} {name}: "
                f"{int((a != b).sum())} of {a.numel()} elements differ")


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


_HALO3D_HOST = r"""
#include "halo3d_site.cuh"

template <typename S, typename T, bool DELTA, bool FAST>
void run_halo3d(const void* const* ptr, void* fo, void* go, void* rq,
                const Halo3Geom& gm, const HostParams& hp) {
  const Params<T> p = cast_params<T>(hp);
  Src3<S, T> src[9];
  for (int k = 0; k < 9; ++k)
    src[k] = {static_cast<const S*>(ptr[5 * k]),
              static_cast<const S*>(ptr[5 * k + 1]),
              static_cast<const T*>(ptr[5 * k + 2]),
              static_cast<const T*>(ptr[5 * k + 3]),
              static_cast<const T*>(ptr[5 * k + 4])};
  const Halo3In<S, T> in{src[0], src[1], src[2], src[3], src[4],
                         src[5], src[6], src[7], src[8]};
  for (int64_t site = 0; site < halo3d_sites(gm); ++site)
    collide_stream_halo3d_site<S, T, DELTA, FAST>(
        in, static_cast<S*>(fo), static_cast<S*>(go), static_cast<T*>(rq),
        gm, site, p);
}

#define RUN_HALO3D(S, T, FAST)                                       \
  (delta ? run_halo3d<S, T, true, FAST>(ptr, fo, go, rq, gm, *hp)   \
         : run_halo3d<S, T, false, FAST>(ptr, fo, go, rq, gm, *hp))

extern "C" int host_collide_stream_halo3d(int mode, int delta,
                                          const void* const* ptr, void* fo,
                                          void* go, void* rq,
                                          const int* geom,
                                          const HostParams* hp) {
  const Halo3Geom gm{geom[0], geom[1], geom[2], geom[3], geom[4]};
  if (mode == 0) RUN_HALO3D(double, double, false);
#ifndef F64_ONLY
  else RUN_HALO3D(__nv_bfloat16, float, true);
#endif
  return 0;
}
"""


def _host_halo3d(tmp_path_factory, name, csrc=CSRC, flags=()):
    so = _build_host(tmp_path_factory, name, _HALO3D_HOST, _STUBS, csrc,
                     flags)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    so.host_collide_stream_halo3d.argtypes = [ci, ci, *[vp] * 6]
    so.host_collide_stream_halo3d.restype = ci
    return so


@pytest.fixture(scope="module")
def host_halo3d(tmp_path_factory):
    return _host_halo3d(tmp_path_factory, "host_halo3d")


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


def _halo3d_mismatches(so, modes):
    """[(mode, cut, output)] where the host build differs from
    halo3d_reference."""
    bad = []
    for dtype, storage, delta in modes:
        cfg = PlasmaConfig(NX=6, NY=12, NZ=6, dtype=dtype, storage=storage,
                           neutral_delta=delta)
        u = cfg.units()
        phys = dict(taus=cfg.taus, q_e=u.q_e, q_i=u.q_i, m_e=u.m_e,
                    m_i=u.m_i, cs2=u.cs2, kb=u.kb,
                    neutral_ref=u.rho_n_init if delta else 0.0)
        st = _seeded(cfg, 6126)
        arrays = (st.f, st.g, st.Ex, st.Ey, st.Ez)
        for cut, (zs, ys) in _HALO3D_CUTS.items():
            shard, zhalo, yrows, corners = fused_step3d.halo_inputs3d(
                arrays, zs, ys)
            want = fused_step3d.halo3d_reference(shard, zhalo, yrows,
                                                 corners, **phys)
            groups = [shard, *(zhalo or (None,) * 2),
                      *(yrows or (None,) * 2), *(corners or (None,) * 4)]
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
            bad += [(f"{storage} {dtype} delta={delta}", cut, name)
                    for name, a, b in zip(("f", "g", "rho_q"), got, want)
                    if not torch.equal(a, b)]
    return bad


def test_halo3d_site_code_matches_plain_versions_bitwise(host_halo3d):
    """csrc/halo3d_site.cuh on every geometry against halo3d_reference (the
    plain versions of collide_stream_halo3d, _panel3d with halo_rows and
    _panel3d_zhalo), bit for bit."""
    assert _halo3d_mismatches(host_halo3d, _HALO3D_MODES) == []


# one-line changes of halo3d_site.cuh, each of which the bitwise hold must
# catch: (what it breaks, the line as it is, the line changed)
_HALO3D_MUTATIONS = {
    "corner row": ("src = z < 0 ? (y < 0 ? in.up_above : in.up_below)",
                   "src = z < 0 ? (y < 0 ? in.up_below : in.up_above)"),
    "wrap axis": ("        if (gm.yh) {", "        if (gm.zh) {"),
    "strip stride": ("    vol = static_cast<int64_t>(NZ) * NX;",
                     "    vol = static_cast<int64_t>(NY) * NX;"),
}


@pytest.mark.parametrize("what", list(_HALO3D_MUTATIONS))
def test_halo3d_site_code_mutations_fail(tmp_path_factory, what):
    before, after = _HALO3D_MUTATIONS[what]
    csrc = tmp_path_factory.mktemp("csrc_" + what.replace(" ", "_"))
    for header in CSRC.glob("*.cuh"):
        text = header.read_text()
        if header.name == "halo3d_site.cuh":
            assert text.count(before) == 1, f"{what}: line not found"
            text = text.replace(before, after)
        (csrc / header.name).write_text(text)
    so = _host_halo3d(tmp_path_factory, "mutant", csrc, ["-DF64_ONLY"])
    assert _halo3d_mismatches(so, _HALO3D_MODES[:2]), (
        f"the '{what}' mutation passed the bitwise hold")


_CAVITY_HOST = r"""
#include <type_traits>
#include <vector>

#include "cavity_site.cuh"

using namespace cavity;

// one step of the block: what the tiles of cavity_step_kernel do, site by
// site: collide the block and its y-halo rows, then pull each site
template <typename In, typename Out, typename T, bool LEAN>
void host_step(const StepIn<In, T>& in, Out* fo, T* ro, T* xo, T* yo, const Geom& g, T tau,
               T u) {
  const int NY = g.NY, NX = g.NX;
  std::vector<T> P(static_cast<size_t>(NY + 2) * NX * kQ);
  const auto at = [&](int y, int x, int i) -> T& {
    return P[(static_cast<size_t>(y + 1) * NX + x) * kQ + i];
  };
  for (int y = -1; y <= NY; ++y)
    for (int x = 0; x < NX; ++x) {
      T post[kQ];
      if (!collide_source_site<In, T, LEAN>(in, g, y, x, tau, post)) continue;
      for (int i = 0; i < kQ; ++i) at(y, x, i) = post[i];
    }
  for (int y = 0; y < NY; ++y)
    for (int x = 0; x < NX; ++x) {
      T out[kQ];
      pull_site<T>([&](int i, int dy, int dx) { return at(y + dy, x + dx, i); }, g, y, x, u,
                   out);
      store_site<Out, T, LEAN>(out, fo, ro, xo, yo, static_cast<int64_t>(NY) * NX,
                               static_cast<int64_t>(y) * NX + x);
    }
}

template <typename S, typename T>
void run_step(int lean, const void* const* p, void* const* o, double u, double tau,
              const Geom& g) {
  const StepIn<S, T> in{static_cast<const S*>(p[0]), static_cast<const T*>(p[1]),
                        static_cast<const T*>(p[2]), static_cast<const T*>(p[3]),
                        static_cast<const S*>(p[4]), static_cast<const T*>(p[5]),
                        static_cast<const S*>(p[6]), static_cast<const T*>(p[7])};
  if (lean)
    host_step<S, S, T, true>(in, static_cast<S*>(o[0]), nullptr, nullptr, nullptr, g,
                             static_cast<T>(tau), static_cast<T>(u));
  else
    host_step<S, S, T, false>(in, static_cast<S*>(o[0]), static_cast<T*>(o[1]),
                              static_cast<T*>(o[2]), static_cast<T*>(o[3]), g,
                              static_cast<T>(tau), static_cast<T>(u));
}

// the window: cavity_multistep_kernel's steps, ping-ponging in T
template <typename S, typename T>
void run_window(const void* f, void* fo, const Geom& g, const Window<T>& w) {
  std::vector<T> a(static_cast<size_t>(kQ) * g.NY * g.NX), b(a.size());
  const auto in = [](const auto* src) {
    using In = std::remove_cv_t<std::remove_pointer_t<decltype(src)>>;
    return StepIn<In, T>{src, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr};
  };
  const S* fs = static_cast<const S*>(f);
  S* fd = static_cast<S*>(fo);
  for (int k = 0; k < w.K; ++k) {
    const T u = lid_ramp(w, k);
    T* prev = (k & 1) ? a.data() : b.data();
    T* next = (k & 1) ? b.data() : a.data();
    if (w.K == 1)
      host_step<S, S, T, true>(in(fs), fd, nullptr, nullptr, nullptr, g, w.tau, u);
    else if (k == 0)
      host_step<S, T, T, true>(in(fs), next, nullptr, nullptr, nullptr, g, w.tau, u);
    else if (k == w.K - 1)
      host_step<T, S, T, true>(in(prev), fd, nullptr, nullptr, nullptr, g, w.tau, u);
    else
      host_step<T, T, T, true>(in(prev), next, nullptr, nullptr, nullptr, g, w.tau, u);
  }
}

extern "C" int host_cavity_step(int mode, int lean, const void* const* p, void* const* o,
                                double u, double tau, const int* geom) {
  const Geom g{geom[0], geom[1], geom[2], geom[3], geom[4], geom[5]};
  if (mode == 0) run_step<double, double>(lean, p, o, u, tau, g);
  else if (mode == 1) run_step<float, float>(lean, p, o, u, tau, g);
  else run_step<__nv_bfloat16, float>(lean, p, o, u, tau, g);
  return 0;
}

extern "C" int host_cavity_window(int mode, const void* f, void* fo, int t0, int K,
                                  double u_lid, double sigma, double tau, const int* geom) {
  const Geom g{geom[0], geom[1], 0, 0, geom[2], geom[3]};
  if (mode == 0)
    run_window<double, double>(f, fo, g, make_window<double>(t0, K, u_lid, sigma, tau));
  else if (mode == 1)
    run_window<float, float>(f, fo, g, make_window<float>(t0, K, u_lid, sigma, tau));
  else
    run_window<__nv_bfloat16, float>(f, fo, g, make_window<float>(t0, K, u_lid, sigma, tau));
  return 0;
}
"""


@pytest.fixture(scope="module")
def host_cavity(tmp_path_factory):
    so = _build_host(tmp_path_factory, "host_cavity", _CAVITY_HOST, _STUBS)
    vp, ci, cd = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    so.host_cavity_step.argtypes = [ci, ci, vp, vp, cd, cd, vp]
    so.host_cavity_window.argtypes = [ci, vp, vp, ci, ci, cd, cd, cd, vp]
    return so


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


# rows of a 45x20 grid (NY x NX): ragged shards that hold the bottom wall,
# neither wall, and the lid, and the whole grid (the single-device kernels)
_CAVITY_CUTS = {"bottom": slice(0, 13), "interior": slice(13, 30),
                "lid": slice(30, 45), "whole": slice(0, 45)}


@pytest.mark.parametrize("where", list(_CAVITY_CUTS))
def test_cavity_site_code_matches_plain_versions_bitwise(host_cavity, where):
    """csrc/cavity_site.cuh against the plain versions of the stored and
    lean steps (the halo kernels on a shard with 3-deep strips; the single-
    device kernels on the whole grid) and of the K = 3 window from step 4,
    inside the lid ramp (the gated window on the shard extended by 3 rows,
    the single-device one on the whole grid), in f64, f32 and bf16
    storage, bit for bit."""
    rows = _CAVITY_CUTS[where]
    whole = where == "whole"
    for dtype, storage in [(torch.float64, "native"),
                           (torch.float32, "native"),
                           (torch.float32, "bf16")]:
        cfg = CavityConfig(NX=20, NY=45, dtype=dtype, storage=storage)
        st = _cavity_warm(cfg, rows.start * 100 + rows.stop)
        u = cavity._lid_speed(cfg, 15)
        tau, mode = cfg.tau, fused_cavity._MODES[(st.f.dtype, dtype)]
        NYl = rows.stop - rows.start
        tag = f"{where} {storage} {dtype}"
        for lean in (False, True):
            macros = None if lean else (st.rho, st.ux, st.uy)
            if whole:
                args = (st.f,) + (() if lean else macros)
                strips, walls = (None,) * 4, (0, NYl - 1)
                want = (fused_cavity.collide_stream_cavity_lean_reference(
                    st.f, u, tau=tau) if lean else
                        fused_cavity.collide_stream_cavity_reference(
                            st.f, *macros, u, tau=tau))
            else:
                args, (bottom, top) = fused_cavity.halo_inputs(
                    st.f, macros, rows, depth=3)
                strips = ((args[1], None, args[2], None) if lean
                          else args[4:])
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
            geom = (ctypes.c_int * 6)(NYl, 20, *depth, *walls)
            host_cavity.host_cavity_step(mode, int(lean), ins, outs, u, tau,
                                         geom)
            for name, a, b in zip(("f", "rho", "ux", "uy"), got, want):
                assert torch.equal(a, b), (
                    f"{tag} {'lean' if lean else 'stored'} {name}: "
                    f"{int((a != b).sum())} of {a.numel()} elements differ")
        k = 3
        block, wall_rows = ((st.f, (0, 44)) if whole else
                            fused_cavity.window_inputs(st.f, rows, k))
        kw = dict(tau=tau, k_steps=k, u_lid=cfg.u_lid, sigma=cfg.sigma)
        want = fused_cavity.collide_stream_cavity_multistep_gated_reference(
            block, 4, wall_rows, **kw)
        got = torch.empty_like(want)
        geom = (ctypes.c_int * 4)(block.shape[1], 20, *wall_rows)
        host_cavity.host_cavity_window(mode, block.data_ptr(),
                                       got.data_ptr(), 4, k, cfg.u_lid,
                                       cfg.sigma, tau, geom)
        assert torch.equal(got, want), (
            f"{tag} window: {int((got != want).sum())} of {got.numel()} "
            f"elements differ")


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
  for (int b = 0; b < NY / R; ++b)
    rows_forward_block(b, rho, scratch, tb, row.data(), row_im, NY, NX, R);
  for (int b = 0; b < NX / P; ++b)
    cols_solve_block(b, scratch, tb, col.data(), col_im, NY, NX, P);
  for (int b = 0; b < NY / R; ++b)
    rows_inverse_block(b, scratch, ex, ey, tb, row.data(), row_im, NY, NX, R);
  return 0;
}
"""


@pytest.fixture(scope="module")
def host_fft(tmp_path_factory):
    so = _build_host(tmp_path_factory, "host_fft", _FFT_HOST, {})
    so.host_fft_solve.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 2
    so.host_fft_solve.restype = ctypes.c_int
    return so


@pytest.mark.parametrize("shape", [(128, 256), (256, 128)],
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
