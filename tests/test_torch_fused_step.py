"""lbm_tpu_torch.kernels.fused_step on the CPU: the wrapper's plain version
against the JAX package's Pallas kernel (interpret mode), the launch count,
the input checks, and the nvcc build helper.

The CUDA kernel itself runs only on a GPU; chip_smoke.py holds it against
this plain version there (this machine's tests import JAX, which the GPU
machine does not have).
"""
import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from lbm_tpu.kernels.fused_step import collide_stream as jax_collide_stream
from lbm_tpu_torch.kernels import build
from lbm_tpu_torch.kernels import fused_step
from lbm_tpu_torch.models import plasma as tplasma

from torch_parity import (as_numpy, assert_close, configs, jax_state_after,
                          perturb, to_jax, to_torch)

torch.set_num_threads(1)


def _phys(cfg, delta):
    u = cfg.units()
    return dict(taus=cfg.taus, q_e=u.q_e, q_i=u.q_i, m_e=u.m_e, m_i=u.m_i,
                cs2=u.cs2, kb=u.kb,
                neutral_ref=u.rho_n_init if delta else 0.0)


@pytest.mark.parametrize("delta", [False, True], ids=["native", "delta"])
@pytest.mark.parametrize("ny, nx", [(16, 24), (32, 24)])
def test_collide_stream_matches_jax_kernel(ny, nx, delta):
    cfg_j, cfg_t = configs(NX=nx, NY=ny, neutral_delta=delta)
    arrays = perturb(as_numpy(jax_state_after(cfg_j, 2)), seed=ny * nx)
    sj, st = to_jax(arrays), to_torch(arrays)
    phys = _phys(cfg_t, delta)
    want = jax_collide_stream(sj.f, sj.g, sj.Ex, sj.Ey, interpret=True,
                              band=8, **phys)
    got = fused_step.collide_stream(st.f, st.g, st.Ex, st.Ey, **phys)
    for name, g, w in zip(("f", "g", "rho_q"), got, want):
        assert_close(g, w, rtol=1e-12, atol_rel=1e-14, name=name)


def test_launches_stay_zero_on_cpu():
    before = fused_step.LAUNCHES
    _, cfg = configs(NX=12, NY=10, backend="fused")
    state = tplasma.init_state(cfg, "cpu")
    step = tplasma.make_step(cfg)
    for _ in range(2):
        state = step(state)
    assert state.step == 2
    assert fused_step.LAUNCHES == before == 0


def test_non_cpu_tensors_never_take_the_plain_version():
    """A tensor that is not on the CPU goes to the kernel or raises: here
    (meta tensors) the input check refuses it before any build."""
    f = torch.empty((3, 9, 8, 8), device="meta", dtype=torch.float64)
    e = torch.empty((8, 8), device="meta", dtype=torch.float64)
    _, cfg = configs(NX=8, NY=8)
    with pytest.raises(ValueError, match="CUDA"):
        fused_step.collide_stream(f, f, e, e, **_phys(cfg, False))


def test_build_raises_without_nvcc(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    with pytest.raises(build.KernelBuildError, match="nvcc"):
        build.build(tmp_path / "build")
    assert not any((tmp_path / "build").rglob("*.so"))


def test_host_params_mirror_matches_the_cuda_struct():
    """The ctypes HostParams lists the fields of the C struct in order,
    with the same array shapes, so the byte layouts agree."""
    src = (Path(build.CSRC) / "plasma_site.cuh").read_text()
    body = re.search(r"struct HostParams \{(.*?)\};", src, re.S).group(1)
    c_fields = []
    for decl in re.findall(r"double ([^;]+);", body):
        for item in decl.split(","):
            m = re.fullmatch(r"\s*(\w+)((?:\[\d+\])*)\s*", item)
            dims = tuple(int(d) for d in re.findall(r"\[(\d+)\]", m.group(2)))
            c_fields.append((m.group(1), dims))

    def dims_of(ct):
        dims = []
        while hasattr(ct, "_length_"):
            dims.append(ct._length_)
            ct = ct._type_
        assert ct is ctypes.c_double
        return tuple(dims)

    py_fields = [(n, dims_of(t)) for n, t in fused_step.HostParams._fields_]
    assert py_fields == c_fields
    n_doubles = sum(int(np.prod(d)) if d else 1 for _, d in c_fields)
    assert ctypes.sizeof(fused_step.HostParams) == 8 * n_doubles


def test_host_params_fold_like_the_plain_version():
    _, cfg = configs()
    u = cfg.units()
    hp = fused_step.host_params(**_phys(cfg, True))
    assert hp.neutral_ref == u.rho_n_init
    assert hp.half_qom[0] == 0.5 * (u.q_e / u.m_e)
    assert hp.half_inv_cs2_sq == 0.5 * (1.0 / u.cs2) * (1.0 / u.cs2)
    # tau_n = 1: the neutral's self pair has r = 0 and is inactive
    assert list(hp.active[2]) == [0.0, 1.0, 1.0]
    assert hp.keep[0] == 1.0 - (1 / 5.0 + 1 / 6.0 + 1 / 4.0)
    assert list(hp.charged) == [1.0, 1.0, 0.0]


def test_load_declares_every_exported_function():
    """build.SIGNATURES lists each extern "C" function of csrc/*.cu with
    its parameters' ctypes (an undeclared pointer is cut to 32 bits)."""
    kinds = {"int": ctypes.c_int, "double": ctypes.c_double}
    exported = {}
    for src in sorted(Path(build.CSRC).glob("*.cu")):
        for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)',
                                       src.read_text()):
            types = []
            for p in filter(None, (p.strip() for p in params.split(","))):
                types.append(ctypes.c_void_p if "*" in p
                             else kinds[p.rsplit(None, 1)[0]])
            exported[name] = types
    assert exported.keys() == build.SIGNATURES.keys()
    for name, types in exported.items():
        assert build.SIGNATURES[name] == types, name
