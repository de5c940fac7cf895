"""lbm_tpu_torch config and units against lbm_tpu's, field by field."""
import dataclasses

import jax.numpy as jnp
import pytest
import torch

from lbm_tpu import config as jcfg
from lbm_tpu_torch import config as tcfg
from lbm_tpu_torch.models import plasma as tplasma

torch.set_num_threads(1)

PRESETS = ["preset_golden_plasma", "preset_plasma_1024", "preset_plasma_4096"]
# fields whose values are spelled differently in the two packages
_MAPPED = {"dtype", "backend", "kernel_interpret"}


@pytest.mark.parametrize("preset", PRESETS)
def test_preset_fields_match(preset):
    j, t = getattr(jcfg, preset)(), getattr(tcfg, preset)()
    jf = {f.name for f in dataclasses.fields(j)}
    tf = {f.name for f in dataclasses.fields(t)}
    assert jf - tf == {"kernel_interpret"}   # no interpret mode in CUDA
    assert tf <= jf
    for name in sorted(tf - _MAPPED):
        want = getattr(j, name)
        if name == "compat":
            want = dataclasses.asdict(want)
            got = dataclasses.asdict(t.compat)
        elif name in ("poisson", "bc"):
            want, got = want.name, getattr(t, name).name
        else:
            got = getattr(t, name)
        assert got == want, name
    assert t.dtype == torch.float32 and jnp.dtype(j.dtype).name == "float32"
    assert (j.backend, t.backend) == ("jnp", "plain")
    assert t.taus == j.taus


@pytest.mark.parametrize("fields", [
    {},
    {"Z_ion": 2, "A_ion": 4},
    {"n_e_SI": 3e12, "T_e_SI": 2.5e4, "Ex_SI": 0.3, "Ey_SI": -0.1},
    {"n_n_SI": 1e16, "T_i_SI": 450.0, "T_n_SI": 280.0},
])
def test_lattice_units_match_bit_for_bit(fields):
    j = dataclasses.replace(jcfg.PlasmaConfig(), **fields).units()
    t = dataclasses.replace(tcfg.PlasmaConfig(), **fields).units()
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


@pytest.mark.parametrize("bad", [
    {"storage": "bfloat16"},
    {"fft_engine": "cufft"},
    {"iter_engine": "gpu"},
    {"multistep": -1, "backend": "fused"},
    {"multistep": 4},            # multistep needs the fused backend
])
def test_validation_matches(bad):
    with pytest.raises(ValueError):
        dataclasses.replace(jcfg.PlasmaConfig(), **bad)
    with pytest.raises(ValueError):
        dataclasses.replace(tcfg.PlasmaConfig(), **bad)


def test_backend_names():
    with pytest.raises(ValueError):
        tcfg.PlasmaConfig(backend="jnp")
    for b in ("plain", "fused", "pallas"):
        assert tcfg.PlasmaConfig(backend=b).backend == b


@pytest.mark.parametrize("fields, item", [
    ({"multistep": 4, "backend": "fused", "NZ": 16,
      "poisson": tcfg.PoissonSolver.NONE}, "Queue 1 item 12"),
    ({"fft_engine": "pallas"}, "Queue 2 item 11"),
    ({"compat": tcfg.CompatFlags(debug_variant=True)}, "Queue 1 item 9"),
    ({"NZ": 16}, "Queue 1 item 12"),
])
def test_unsupported_configs_raise(fields, item):
    cfg = dataclasses.replace(tcfg.PlasmaConfig(NX=8, NY=8), **fields)
    with pytest.raises(NotImplementedError, match=item):
        tplasma.make_step(cfg)
    with pytest.raises(NotImplementedError, match=item):
        tplasma.init_state(cfg, "cpu")


@pytest.mark.parametrize("fields", [
    {"bc": tcfg.BC.BOUNCE_BACK},
    {"poisson": tcfg.PoissonSolver.GS},
    {"poisson": tcfg.PoissonSolver.SOR},
    {"poisson": tcfg.PoissonSolver.NPS},
    {"poisson": tcfg.PoissonSolver.NONE},
    {"backend": "pallas"},
    {"backend": "fused", "multistep": 4},
], ids=["bounceback", "GS", "SOR", "NPS", "NONE", "pallas", "multistep"])
def test_configs_refused_before_the_solvers_and_walls_now_run(fields):
    cfg = dataclasses.replace(tcfg.PlasmaConfig(NX=8, NY=8,
                                                poisson_max_iter=5), **fields)
    state = tplasma.make_rollout(cfg, 1)(tplasma.init_state(cfg, "cpu"))
    assert state.step == 1
    assert all(bool(torch.isfinite(t).all())
               for t in (state.f, state.g, state.Ex, state.Ey, state.phi))


# ---------------------------------------------------------------------------
# CavityConfig
# ---------------------------------------------------------------------------

def test_cavity_preset_fields_match():
    j, t = jcfg.preset_cavity_ghia(), tcfg.preset_cavity_ghia()
    jf = {f.name for f in dataclasses.fields(j)}
    tf = {f.name for f in dataclasses.fields(t)}
    assert jf - tf == {"kernel_interpret"}   # no interpret mode in CUDA
    assert tf <= jf
    for name in sorted(tf - _MAPPED):
        assert getattr(t, name) == getattr(j, name), name
    assert t.dtype == torch.float32 and jnp.dtype(j.dtype).name == "float32"
    assert (j.backend, t.backend) == ("jnp", "plain")
    assert (t.NX, t.NY, t.nsteps, t.Re, t.u_lid) == (129, 129, 10_000, 100.0,
                                                     0.1)
    assert t.tau == j.tau


@pytest.mark.parametrize("fields", [
    {},
    {"NX": 64, "NY": 48, "Re": 400.0, "u_lid": 0.05},
    {"NX": 1000, "NY": 1000, "u_lid": 0.3},      # tau > 2: resized
    {"NX": 10, "NY": 10, "u_lid": 0.01},         # tau = 0.503: kept
    {"NX": 200, "NY": 200, "u_lid": 0.001, "Re": 1000.0},  # tau = 0.5006
])
def test_cavity_tau_and_stability_guard_match(fields):
    j = dataclasses.replace(jcfg.CavityConfig(), **fields)
    t = dataclasses.replace(tcfg.CavityConfig(), **fields)
    assert t.tau == j.tau
    jg, tg = j.with_stability_guard(), t.with_stability_guard()
    assert (tg.NX, tg.NY, tg.tau) == (jg.NX, jg.NY, jg.tau)
    assert (tg is t) == (jg is j)


@pytest.mark.parametrize("bad", [
    {"storage": "fp8"},
    {"storage": "bf16", "dtype": "float64"},
    {"lean_macros": True},               # lean needs the fused backend
    {"multistep": 8},                    # so does multistep
    {"multistep": -1, "backend": "fused"},
    {"backend": "cuda"},
])
def test_cavity_validation_matches(bad):
    j_kw, t_kw = dict(bad), dict(bad)
    if "dtype" in bad:
        j_kw["dtype"], t_kw["dtype"] = jnp.float64, torch.float64
    with pytest.raises(ValueError):
        jcfg.CavityConfig(**j_kw)
    with pytest.raises(ValueError):
        tcfg.CavityConfig(**t_kw)


def test_cavity_backend_names():
    with pytest.raises(ValueError):
        tcfg.CavityConfig(backend="jnp")
    cfg = tcfg.CavityConfig(backend="fused", lean_macros=True, multistep=4,
                            storage="bf16")
    assert (cfg.backend, cfg.lean_macros, cfg.multistep) == ("fused", True, 4)
