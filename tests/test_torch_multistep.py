"""Temporal blocking in the port (kernels/fused_multistep.py and the
multistep rollout of models/plasma.py) on the CPU, where the window
kernel's wrapper runs its plain version.

  * the multistep rollout, 11 steps (7 or 9 for the odd shapes) as K-step
    windows plus a remainder, f64 at 16^2, against the JAX package's
    per-step jnp rollout (its own reference for this kernel,
    tests/test_fused_multistep.py), at 1e-11 of scale in f, g, Ex, Ey and
    phi: NONE periodic (K = 1, 4, 16), and with the quirk off and neutral
    delta at NY = 20; NONE bounce-back (K = 1, 4, 16) with and
    without delta; FFT + bounce-back (the no-op solve); FFT + periodic
    (K = 1, 4, 16), and with delta at odd NX = 15; GS periodic, SOR
    bounce-back, NPS periodic (60 sweeps) and GS with the Dirichlet-sweep
    quirk off. Each case's JAX reference is compiled once, serially on the
    worker, and shared by its K values. Against the jitted JAX rollout an
    elementwise gate would fail on the f64 neutral's g channel, where XLA's
    fusion moves last bits that the thermal term amplifies (~1e-9 of that
    species' scale, 4e-16 of g's); so every window that has no DFT is also
    held BITWISE against the port's per-step plain rollout, which
    tests/test_torch_plasma.py and tests/test_torch_bounceback.py hold
    against the JAX step run op by op;
  * bf16 storage, rounded once a window, against the f32 jnp path at the
    JAX package's gates (f 3e-2, g 0.3 of each species' scale);
  * the plain version against the JAX kernel itself in interpret mode, one
    K = 4 window each of FFT + periodic and NONE bounce-back, f64, at
    1e-12 of scale;
  * dft_solve_mats bitwise equal to the JAX package's, NX even and odd;
  * the CLI under --device cpu --multistep 4: 10 steps, 3 probe rows;
  * the wrapper's refusals and its ctypes mirror of the CUDA struct.
"""
import ctypes
import dataclasses
import functools
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from lbm_tpu.kernels import fused_multistep as jfm
from lbm_tpu.models import plasma as jplasma
from lbm_tpu_torch import run_plasma
from lbm_tpu_torch.config import BC, CompatFlags, PoissonSolver
from lbm_tpu_torch.kernels import build
from lbm_tpu_torch.kernels import fused_multistep as tfm
from lbm_tpu_torch.models import plasma as tplasma

from torch_parity import as_numpy, configs, np_of, perturb, to_jax, to_torch

torch.set_num_threads(1)

FIELDS = ("f", "g", "Ex", "Ey", "phi")
BASE = dict(NX=16, NY=16, poisson=PoissonSolver.NONE, bc=BC.PERIODIC)
FFT, BB = PoissonSolver.FFT, BC.BOUNCE_BACK
# name -> (steps, fields over BASE)
CASES = {
    "none": (11, {}),
    "none-quirk-off-delta-ny20": (9, {
        "neutral_delta": True, "NY": 20, "compat": CompatFlags(
            none_solver_kills_external_field=False)}),
    "none-bb": (11, {"bc": BB}),
    "none-bb-delta": (11, {"bc": BB, "neutral_delta": True}),
    "fft-bb": (11, {"poisson": FFT, "bc": BB}),
    "fft": (11, {"poisson": FFT}),
    "fft-delta-odd-nx": (7, {"poisson": FFT, "neutral_delta": True,
                             "NX": 15}),
    "gs": (11, {"poisson": PoissonSolver.GS, "poisson_max_iter": 60}),
    "sor-bb": (11, {"poisson": PoissonSolver.SOR, "bc": BB,
                    "poisson_max_iter": 60}),
    "nps": (11, {"poisson": PoissonSolver.NPS, "poisson_max_iter": 60}),
    "gs-quirk-off": (7, {"poisson": PoissonSolver.GS, "poisson_max_iter": 40,
                         "compat": CompatFlags(
                             dirichlet_iterative_under_periodic=False)}),
}
# every case's JAX reference is one XLA compile; its K values reuse it
RUNS = [("none", 1), ("none", 4), ("none", 16),
        ("none-quirk-off-delta-ny20", 4), ("none-quirk-off-delta-ny20", 5),
        ("none-quirk-off-delta-ny20", 16), ("none-bb", 1),
        ("none-bb", 4), ("none-bb", 16), ("none-bb-delta", 4),
        ("fft-bb", 4), ("fft", 1), ("fft", 4), ("fft", 16),
        ("fft-delta-odd-nx", 4), ("fft-delta-odd-nx", 5), ("gs", 4),
        ("sor-bb", 4), ("nps", 4), ("gs-quirk-off", 4)]


def _configs(case, dtype="float64", **extra):
    steps, fields = CASES[case]
    cj, ct = configs(dtype, **{**BASE, **fields, **extra}, nsteps=steps)
    return steps, cj, ct


def _jax_rollout_of(cj, steps):
    """The JAX package's jnp rollout, jitted, as numpy arrays."""
    return as_numpy(jax.jit(jplasma.make_rollout(cj, steps))(
        jplasma.init_state(cj)))


@functools.lru_cache(maxsize=None)
def _jax_ref(case):
    """The case's JAX rollout, one XLA compile, shared by its K values."""
    steps, cj, _ = _configs(case)
    return _jax_rollout_of(cj, steps)


@functools.lru_cache(maxsize=None)
def _port_per_step(case):
    steps, _, ct = _configs(case)
    return tplasma.make_rollout(ct, steps)(tplasma.init_state(ct, "cpu"))


def _port_multistep(ct, steps, K):
    cfg = dataclasses.replace(ct, backend="fused", multistep=K)
    return tplasma.make_rollout(cfg, steps)(tplasma.init_state(cfg, "cpu"))


def _scale_err(got, want):
    a, b = np_of(want), np_of(got)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-300))


@pytest.mark.parametrize("case, K", RUNS, ids=[f"{c}-K{k}" for c, k in RUNS])
def test_multistep_rollout_matches_jax_f64(case, K):
    steps, _, ct = _configs(case)
    s = _port_multistep(ct, steps, K)
    assert s.step == steps
    ref = _jax_ref(case)
    solves = case.startswith(("fft", "gs", "sor", "nps")) and case != "fft-bb"
    assert (float(np.abs(ref["phi"]).max()) > 0) == solves
    for name in FIELDS:
        err = _scale_err(getattr(s, name), ref[name])
        assert err < 1e-11, (name, err)
    if CASES[case][1].get("poisson") == FFT and ct.bc == BC.PERIODIC:
        return   # the window's DFT and the per-step rfft2 round differently
    per_step = _port_per_step(case)
    for name in FIELDS:
        assert torch.equal(getattr(s, name), getattr(per_step, name)), name


def test_multistep_state_moves_and_keeps_the_field_without_the_quirk():
    """Flow develops, and without the NONE quirk the external field
    survives every window."""
    steps, _, ct = _configs("none-quirk-off-delta-ny20")
    s = _port_multistep(ct, steps, 4)
    s0 = tplasma.init_state(ct, "cpu")
    assert float((s.f - s0.f).abs().max()) > 0
    assert torch.equal(s.Ex, s0.Ex) and float(s.Ex.abs().max()) > 0
    steps, _, ct = _configs("none")
    assert float(_port_multistep(ct, steps, 4).Ex.abs().max()) == 0.0


def test_bf16_window_rounding_tracks_the_f32_path():
    """bf16 storage rounds once a window; the trajectory tracks the f32
    jnp path (delta layout) within the JAX package's gates."""
    cj, ct = configs("float32", **BASE, nsteps=12, neutral_delta=True)
    ref = _jax_rollout_of(cj, 12)
    cfg = dataclasses.replace(ct, backend="fused", multistep=4,
                              storage="bf16")
    s = tplasma.make_rollout(cfg, 12)(tplasma.init_state(cfg, "cpu"))
    assert s.f.dtype == torch.bfloat16 and s.step == 12
    for name, tol in (("f", 3e-2), ("g", 0.3)):
        for sp in range(3):
            a = np_of(ref[name])[sp]
            b = np_of(getattr(s, name))[sp]
            assert np.isfinite(b).all()
            assert np.abs(a - b).max() / max(np.abs(a).max(), 1e-30) < tol, \
                (name, sp)


@pytest.mark.parametrize("case", ["fft", "none-bb"])
def test_plain_version_matches_jax_interpret_kernel(case):
    """One K = 4 window of the plain version against the JAX kernel in
    interpret mode, from a seeded perturbation of a warm state (two plain
    steps of the port, which equal the JAX step run op by op), f64. The
    interpret kernel compiles its body, whose fused multiply-adds move last
    bits: 1e-12 of scale."""
    _, _, ct = _configs(case)
    warm = tplasma.make_rollout(ct, 2)(tplasma.init_state(ct, "cpu"))
    arrays = perturb({k: v.numpy() if isinstance(v, torch.Tensor) else v
                      for k, v in warm._asdict().items()}, seed=7)
    u = ct.units()
    kw = dict(taus=ct.taus, q_e=u.q_e, q_i=u.q_i, m_e=u.m_e, m_i=u.m_i,
              cs2=u.cs2, kb=u.kb, neutral_ref=0.0, k_steps=4,
              kill_field=case == "none-bb", bounce=ct.bc == BB,
              solve_fft=case == "fft")
    js, ts = to_jax(arrays), to_torch(arrays)
    want = jfm.collide_stream_multistep(js.f, js.g, js.Ex, js.Ey,
                                        interpret=True, **kw)
    got = tfm.collide_stream_multistep(ts.f, ts.g, ts.Ex, ts.Ey, **kw)
    assert len(got) == len(want) == (5 if case == "fft" else 2)
    for name, g, w in zip(FIELDS, got, want):
        err = _scale_err(g, np.asarray(w))
        assert err < 1e-12, (name, err)


@pytest.mark.parametrize("NY, NX", [(12, 16), (12, 15)])
def test_dft_solve_mats_match_jax_bitwise(NY, NX):
    got = tfm.dft_solve_mats(NY, NX)
    want = jfm._dft_solve_mats(NY, NX)
    assert tfm.pad_half(NX) == jfm._pad_half(NX)
    assert len(got) == len(want) == 7
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float64
        np.testing.assert_array_equal(g, w)


def test_cli_multistep_on_cpu(tmp_path):
    """10 steps as windows of 4, 4 and 2: one probe row a window (the
    macros before it, E after it), no kernel launches on the CPU."""
    summary = run_plasma.main([
        "--device", "cpu", "--nx", "16", "--ny", "12", "--steps", "10",
        "--multistep", "4", "--out", str(tmp_path)])
    assert summary["finite"] and summary["steps"] == 10
    assert summary["state"].step == 10
    assert (summary["backend"], summary["multistep"]) == ("fused", 4)
    assert summary["launches"] == dict.fromkeys(run_plasma.KERNELS, 0)
    rows = np.loadtxt(tmp_path / "graphs" / "ts_rho_q.csv", delimiter=",")
    assert rows.shape == (3, 9)
    assert all(v.shape == (3, 9) for v in summary["probes"].values())
    with open(tmp_path / "simulation_time_plasma_details.csv") as fh:
        assert fh.read().splitlines()[1].startswith("16x12,10,1,3,0,")


def _phys():
    _, _, ct = _configs("none")
    u = ct.units()
    return dict(taus=ct.taus, q_e=u.q_e, q_i=u.q_i, m_e=u.m_e, m_i=u.m_i,
                cs2=u.cs2, kb=u.kb)


@pytest.mark.parametrize("bad, match", [
    (dict(solve_fft=True, bounce=True), "no-op solve"),
    (dict(solve_fft=True, solve_iter=("gs", None, 5, 0.0, True, False)),
     "exclusive"),
    (dict(solve_iter=("gs", None, 5, 0.0, True, False)), "warm-start phi"),
    (dict(k_steps=0), "k_steps"),
], ids=["fft-bounce", "fft-iter", "iter-no-phi", "k0"])
def test_refuses_what_the_jax_kernel_refuses(bad, match):
    f = torch.zeros((3, 9, 8, 8), dtype=torch.float64)
    e = torch.zeros((8, 8), dtype=torch.float64)
    kw = {**_phys(), "k_steps": 2, **bad}
    with pytest.raises(ValueError, match=match):
        tfm.collide_stream_multistep(f, f, e, e, **kw)


def test_non_cpu_tensors_never_take_the_plain_version():
    """A tensor that is not on the CPU goes to the kernel or raises: here
    (meta tensors) the input check refuses it before any build."""
    f = torch.empty((3, 9, 8, 8), device="meta", dtype=torch.float64)
    e = torch.empty((8, 8), device="meta", dtype=torch.float64)
    before = tfm.LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        tfm.collide_stream_multistep(f, f, e, e, k_steps=2, **_phys())
    assert tfm.LAUNCHES == before == 0


def test_multistep_host_mirror_matches_the_cuda_struct():
    """The ctypes MultistepHost lists the fields of the C struct in order,
    with the same kinds and array lengths."""
    src = (Path(build.CSRC) / "fused_multistep.cu").read_text()
    body = re.search(r"struct MultistepHost \{(.*?)\};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    c_fields = []
    for decl in body.split(";"):
        decl = decl.strip()
        if not decl:
            continue
        kind = ("ptr" if "*" in decl else decl.split()[0])
        names = decl.split(None, 2)[-1] if "*" in decl else decl.split(
            None, 1)[1]
        for item in names.replace("*", "").split(","):
            m = re.fullmatch(r"\s*(\w+)(?:\[(\d+)\])?\s*", item)
            c_fields.append((m.group(1), kind, int(m.group(2) or 0)))
    kinds = {ctypes.c_void_p: "ptr", ctypes.c_int: "int",
             ctypes.c_double: "double"}
    py_fields = []
    for n, t in tfm.MultistepHost._fields_:
        length = t._length_ if issubclass(t, ctypes.Array) else 0
        py_fields.append((n, kinds[t._type_ if length else t], length))
    assert py_fields == c_fields
