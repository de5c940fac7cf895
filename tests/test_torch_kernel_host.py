"""The 3-D kernel's per-site code, built for the CPU, against its plain
version.

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
"""
import ctypes
import dataclasses
import shutil
import subprocess

import numpy as np
import pytest
import torch

from lbm_tpu_torch.config import PlasmaConfig
from lbm_tpu_torch.kernels import fused_step3d
from lbm_tpu_torch.kernels.build import CSRC
from lbm_tpu_torch.kernels.fused_step import _MODES, host_params
from lbm_tpu_torch.models import plasma3d

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
"""


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the site code with")
    d = tmp_path_factory.mktemp("host_kernel")
    for name, text in _STUBS.items():
        (d / name).write_text(text)
    src, lib = d / "host_loop.cpp", d / "libhost3d.so"
    src.write_text(_HOST_LOOP)
    r = subprocess.run([cxx, "-O1", "-std=c++17", "-ffp-contract=off",
                        "-fno-fast-math", "-fPIC", "-shared",
                        "-Wno-unknown-pragmas", f"-I{d}", f"-I{CSRC}",
                        str(src), "-o", str(lib)],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    so = ctypes.CDLL(str(lib))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    so.host_collide_stream3d.argtypes = [ci, ci, *[vp] * 8, ci, ci, ci, vp]
    so.host_collide_stream3d.restype = ci
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
