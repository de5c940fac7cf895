"""lbm_tpu_torch.ops against lbm_tpu.ops on the same seeded state.

Inputs: the JAX package's state after 2 steps at 16x24, plus a seeded
relative perturbation of 1e-3, fed to both packages. Tolerances: f64 at
1e-12 relative (the two packages evaluate the same expression trees, so
they differ by a few ulp at most); the bf16-mode thermal forms in f32 at
rtol 1e-6.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lbm_tpu.ops import collide as jcollide
from lbm_tpu.ops import equilibrium as jeq
from lbm_tpu.ops import macros as jmacros
from lbm_tpu.ops import poisson as jpoisson
from lbm_tpu.ops import stream as jstream
from lbm_tpu_torch.ops import collide as tcollide
from lbm_tpu_torch.ops import equilibrium as teq
from lbm_tpu_torch.ops import macros as tmacros
from lbm_tpu_torch.ops import poisson as tpoisson
from lbm_tpu_torch.ops import stream as tstream

from torch_parity import (as_numpy, assert_close, configs, jax_state_after,
                          perturb, to_jax, to_torch)

torch.set_num_threads(1)

NY, NX = 16, 24
MODES = ["native", "delta"]


def _inputs(mode, dtype="float64"):
    cfg_j, cfg_t = configs(dtype=dtype, NX=NX, NY=NY,
                           neutral_delta=(mode == "delta"))
    arrays = perturb(as_numpy(jax_state_after(cfg_j, 2)), seed=7)
    u = cfg_t.units()
    phys = dict(q_e=u.q_e, q_i=u.q_i, m_e=u.m_e, m_i=u.m_i,
                neutral_ref=u.rho_n_init if mode == "delta" else 0.0)
    return to_jax(arrays), to_torch(arrays), u, cfg_t.taus, phys


def _macros(mode, dtype="float64"):
    sj, st, u, taus, phys = _inputs(mode, dtype)
    mj = jmacros.update_macro(sj.f, sj.g, sj.Ex, sj.Ey, **phys)
    mt = tmacros.update_macro(st.f, st.g, st.Ex, st.Ey, **phys)
    return sj, st, u, taus, phys, mj, mt


@pytest.mark.parametrize("mode", MODES)
def test_update_macro_matches(mode):
    *_, mj, mt = _macros(mode)
    for name in tmacros.Macros._fields:
        want, got = getattr(mj, name), getattr(mt, name)
        if want is None:
            assert got is None, name
            continue
        assert_close(got, want, rtol=1e-12, atol_rel=1e-12, name=name)
    # the guards fire on the same cells
    np.testing.assert_array_equal(np.asarray(mt.rho.numpy() == 0),
                                  np.asarray(mj.rho) == 0)


def test_momentum_guard_fires_on_the_same_cells():
    """A cell whose x-momentum equals +rho exactly (all mass in direction
    1) gets u_x = 0 from both packages, before the half-step force."""
    sj, st, u, taus, phys = _inputs("native")
    f = np.asarray(sj.f).copy()
    f[0, :, 3, 5] = 0.0
    f[0, 1, 3, 5] = 0.7
    mj = jmacros.update_macro(jnp.asarray(f), sj.g, sj.Ex, sj.Ey, **phys)
    mt = tmacros.update_macro(torch.from_numpy(f), st.g, st.Ex, st.Ey, **phys)
    half = 0.5 * u.q_e / u.m_e * float(np.asarray(sj.Ex)[3, 5])
    assert float(mt.ux[0, 3, 5]) == pytest.approx(half, rel=1e-12)
    assert_close(mt.ux, mj.ux, rtol=1e-12, atol_rel=1e-12, name="ux")


@pytest.mark.parametrize("fn", ["equilibrium_polys", "equilibrium_wpolys",
                                "equilibrium_wpolys_dev"])
def test_equilibrium_matches(fn):
    *_, u, taus, phys, mj, mt = _macros("native")
    for p in range(3):
        want = getattr(jeq, fn)(mj.ux_pair[p], mj.uy_pair[p], u.cs2)
        got = getattr(teq, fn)(mt.ux_pair[p], mt.uy_pair[p], u.cs2)
        for i in range(9):
            assert_close(got[i], want[i], rtol=1e-12, atol_rel=1e-12,
                         name=f"{fn} pair {p} dir {i}")


@pytest.mark.parametrize("mode", MODES)
def test_collide_matches(mode):
    sj, st, u, taus, phys, mj, mt = _macros(mode)
    kw = dict(taus=taus, q_e=u.q_e, q_i=u.q_i, m_e=u.m_e, m_i=u.m_i,
              cs2=u.cs2, kb=u.kb, neutral_ref=phys["neutral_ref"])
    fj, gj = jcollide.collide(sj.f, sj.g, mj, sj.Ex, sj.Ey, **kw)
    ft, gt = tcollide.collide(st.f, st.g, mt, st.Ex, st.Ey, **kw)
    assert_close(ft, fj, rtol=1e-12, atol_rel=1e-12, name="f_post")
    assert_close(gt, gj, rtol=1e-12, atol_rel=1e-12, name="g_post")


@pytest.mark.parametrize("mode", MODES)
def test_collide_bf16_fast_thermal_forms_match(mode):
    """The bf16-storage mode's partial-fraction thermal forms
    (collide_species_dirs_fused_fast / collide_species_g_dirs_fast) in
    f32, with the exact reciprocal both plain paths use."""
    sj, st, u, taus, phys, mj, mt = _macros(mode, dtype="float32")
    kw = dict(taus=taus, q_e=u.q_e, q_i=u.q_i, m_e=u.m_e, m_i=u.m_i,
              cs2=u.cs2, kb=u.kb, neutral_ref=phys["neutral_ref"])
    fj, gj = jcollide.collide(sj.f, sj.g, mj, sj.Ex, sj.Ey,
                              g_recip=lambda x: 1.0 / x, **kw)
    ft, gt = tcollide.collide(st.f, st.g, mt, st.Ex, st.Ey,
                              g_recip=lambda x: 1.0 / x, **kw)
    assert ft.dtype == torch.float32
    assert_close(ft, fj, rtol=1e-6, atol_rel=1e-6, name="f_post")
    assert_close(gt, gj, rtol=1e-6, atol_rel=1e-6, name="g_post")


def test_stream_periodic_matches():
    sj, st, *_ = _inputs("native")
    assert_close(tstream.stream_periodic(st.f), jstream.stream_periodic(sj.f),
                 rtol=0, name="f")
    assert_close(tstream.stream_periodic(st.g), jstream.stream_periodic(sj.g),
                 rtol=0, name="g")


@pytest.mark.parametrize("shape", [(16, 24), (15, 21), (24, 32)])
def test_solve_fft_and_efield_match(shape):
    rng = np.random.default_rng(shape[0] * 100 + shape[1])
    rho_q = rng.standard_normal(shape) * 1e-3
    phi_j = jpoisson.solve_fft(jnp.asarray(rho_q))
    phi_t = tpoisson.solve_fft(torch.from_numpy(rho_q))
    assert phi_t.dtype == torch.float64
    assert_close(phi_t, phi_j, rtol=0, atol_rel=1e-12, name="phi")
    for name, got, want in zip(("Ex", "Ey"),
                               tpoisson.efield_periodic(phi_t),
                               jpoisson.efield_periodic(phi_j)):
        assert_close(got, want, rtol=0, atol_rel=1e-12, name=name)
