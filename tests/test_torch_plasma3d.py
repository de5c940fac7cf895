"""lbm_tpu_torch's 3-D plasma column against lbm_tpu's, on the CPU.

  * D3Q19 and preset_plasma_3d equal the JAX package's;
  * ops/d3 against lbm_tpu.ops.d3 op by op in f64 (update_macro3 and
    collide_species_dirs3 in the classic, delta and g_recip forms):
    bitwise expected, gate 1e-12 relative and 1e-12 of scale;
  * solve_fft3d and efield_periodic3d in f64 within 1e-12 of scale, at a
    small grid and at 128^3, where the JAX package takes its packed-halves
    transform;
  * init_state bitwise, and the plain step against the JAX package's jnp
    step (run op by op, unjitted) over 3 steps at 12x16x8: f64 classic and
    delta, FFT and NONE with the quirk on and off, within 1e-11 of scale
    (per species for the populations, the largest E component for E);
    f32 + delta within 1e-5 of scale; bf16 + delta f and g within one bf16
    ulp, E and phi within 1e-5 of scale;
  * the kernel's plain version against the JAX package's jnp collide +
    stream at NZ = 1, 2 and 8, bitwise expected, gate 1e-12 of scale
    (JAX's own tests hold its interpret-mode kernel bitwise to jnp,
    tests/test_plasma3d.py, so interpret mode is not run here);
  * interop round trips, the CLI and the refusals.

Inputs are the JAX package's states plus a seeded relative perturbation
made with numpy, so both packages see the same numbers.
"""
import dataclasses
import os
import runpy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu import config as jcfg
from lbm_tpu.constants import D3Q19 as JD3Q19
from lbm_tpu.models import plasma3d as jp3
from lbm_tpu.ops import d3 as jd3
from lbm_tpu_torch import config as tcfg
from lbm_tpu_torch import interop, run_plasma3d
from lbm_tpu_torch.constants import D3Q19 as TD3Q19
from lbm_tpu_torch.kernels import fused_step3d
from lbm_tpu_torch.models import plasma as tplasma
from lbm_tpu_torch.models import plasma3d as tp3
from lbm_tpu_torch.ops import d3 as td3

from torch_parity import (as_numpy, assert_close, assert_within_bf16_ulp,
                          configs, np_of)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OP_SHAPE = dict(NX=12, NY=16, NZ=8)


def _phys(cfg_t):
    u = cfg_t.units()
    return u, dict(taus=cfg_t.taus, q_e=u.q_e, q_i=u.q_i, m_e=u.m_e,
                   m_i=u.m_i, cs2=u.cs2, kb=u.kb,
                   neutral_ref=u.rho_n_init if cfg_t.neutral_delta else 0.0)


def _jax_states(cfg_j, n_steps):
    """The JAX package's init state and its n_steps jnp steps, op by op."""
    state = jp3.init_state(cfg_j)
    step = jp3.make_step(dataclasses.replace(cfg_j, backend="jnp"))
    out = [state]
    for _ in range(n_steps):
        out.append(step(out[-1]))
    return out


def _perturbed(arrays, seed, rel=1e-3):
    """A seeded relative perturbation of f, g and Ex, made in float64 and
    cast back; Ey and Ez get additive ones at rel * max|Ex|."""
    rng = np.random.default_rng(seed)
    out = dict(arrays)
    ex_scale = float(np.abs(arrays["Ex"].astype(np.float64)).max())
    for k in ("f", "g", "Ex", "Ey", "Ez"):
        a = arrays[k].astype(np.float64)
        noise = rng.standard_normal(a.shape)
        a = a * (1.0 + rel * noise)
        if k in ("Ey", "Ez"):
            a = a + rel * ex_scale * noise
        out[k] = a.astype(arrays[k].dtype)
    return out


def _op_inputs(delta, dtype="float64"):
    cfg_j, cfg_t = configs(dtype=dtype, **OP_SHAPE, neutral_delta=delta)
    arrays = _perturbed(as_numpy(_jax_states(cfg_j, 2)[-1]), seed=11)
    sj = jp3.Plasma3DState(**{k: jnp.asarray(v) for k, v in arrays.items()})
    return sj, interop.plasma3d_state_from_numpy(arrays, "cpu"), cfg_t


def _bits(a):
    return np.ascontiguousarray(a).reshape(-1).view(np.uint8)


def _close_populations(got, want, tol, name):
    for s in range(3):
        assert_close(np_of(got)[s], np_of(want)[s], rtol=0, atol_rel=tol,
                     name=f"{name}[{s}]")


def _close_state(got, want, tol, bf16=False):
    """Populations per species, E against the largest E component, phi
    against its own scale."""
    for name in ("f", "g"):
        g, w = getattr(got, name), getattr(want, name)
        if bf16:
            nx = w.shape[-1]
            assert_within_bf16_ulp(np_of(g).reshape(3, 19, -1, nx),
                                   np_of(w).reshape(3, 19, -1, nx), name=name)
        else:
            _close_populations(g, w, tol, name)
    e_scale = max(float(np.abs(np_of(getattr(want, k))).max())
                  for k in ("Ex", "Ey", "Ez"))
    for k in ("Ex", "Ey", "Ez"):
        err = np.abs(np_of(getattr(got, k)) - np_of(getattr(want, k))).max()
        assert err <= tol * e_scale, f"{k}: {err} > {tol} * {e_scale}"
    assert_close(got.phi, want.phi, rtol=0, atol_rel=tol, name="phi")
    assert got.step == int(want.step)


# ---------------------------------------------------------------------------
# constants and config
# ---------------------------------------------------------------------------

def test_d3q19_and_preset_match():
    for k in ("Q", "DIM", "CX", "CY", "CZ", "W", "OPP", "CS2"):
        a, b = getattr(TD3Q19, k), getattr(JD3Q19, k)
        assert np.array_equal(a, b) and np.asarray(a).dtype == \
            np.asarray(b).dtype, k
    for args in ((), (32, 16)):
        j, t = jcfg.preset_plasma_3d(*args), tcfg.preset_plasma_3d(*args)
        for field in ("NX", "NY", "NZ", "nsteps", "poisson", "bc", "taus",
                      "storage", "neutral_delta", "multistep"):
            want, got = getattr(j, field), getattr(t, field)
            if hasattr(want, "name"):
                want, got = want.name, got.name
            assert got == want, field


@pytest.mark.parametrize("dtype, storage, delta", [
    ("float64", "native", False), ("float32", "native", True),
    ("float32", "bf16", True)])
def test_init_state_matches(dtype, storage, delta):
    cfg_j, cfg_t = configs(dtype=dtype, NX=12, NY=16, NZ=3, storage=storage,
                           neutral_delta=delta)
    want = as_numpy(jp3.init_state(cfg_j))
    got = interop.plasma3d_state_to_numpy(tp3.init_state(cfg_t, "cpu"))
    for k, w in want.items():
        assert got[k].dtype == w.dtype, k
        np.testing.assert_array_equal(_bits(got[k]), _bits(w), err_msg=k)


# ---------------------------------------------------------------------------
# ops/d3, op by op in f64
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("delta", [False, True], ids=["classic", "delta"])
def test_update_macro3_matches(delta):
    sj, st, cfg_t = _op_inputs(delta)
    u, phys = _phys(cfg_t)
    kw = dict(q_e=u.q_e, q_i=u.q_i, m_e=u.m_e, m_i=u.m_i,
              neutral_ref=phys["neutral_ref"])
    mj = jd3.update_macro3(sj.f, sj.g, sj.Ex, sj.Ey, sj.Ez, **kw)
    mt = td3.update_macro3(st.f, st.g, st.Ex, st.Ey, st.Ez, **kw)
    for name in td3.Macros3D._fields:
        want, got = getattr(mj, name), getattr(mt, name)
        if want is None:
            assert got is None, name
            continue
        assert_close(got, want, rtol=1e-12, atol_rel=1e-12, name=name)
    np.testing.assert_array_equal(mt.rho.numpy() == 0, np.asarray(mj.rho) == 0)
    # the px == +rho guard: all of an electron cell's mass in direction 1
    f = np.asarray(sj.f).copy()
    f[0, :, 1, 6, 5] = 0.0
    f[0, 1, 1, 6, 5] = 0.7
    mj = jd3.update_macro3(jnp.asarray(f), sj.g, sj.Ex, sj.Ey, sj.Ez, **kw)
    mt = td3.update_macro3(torch.from_numpy(f), st.g, st.Ex, st.Ey, st.Ez,
                           **kw)
    half = 0.5 * u.q_e / u.m_e * float(np.asarray(sj.Ex)[1, 6, 5])
    assert float(mt.ux[0, 1, 6, 5]) == pytest.approx(half, rel=1e-12)
    assert_close(mt.ux, mj.ux, rtol=1e-12, atol_rel=1e-12, name="ux guard")


@pytest.mark.parametrize("delta, recip", [(False, False), (True, False),
                                          (True, True)],
                         ids=["classic", "delta", "g_recip"])
def test_collide_species_dirs3_matches(delta, recip):
    """Every species' 19 + 19 post-collision planes; g_recip is the bf16
    mode's partial-fraction form (here in f64), which covers the
    delta-stored neutral too."""
    sj, st, cfg_t = _op_inputs(delta)
    u, phys = _phys(cfg_t)
    mkw = dict(q_e=u.q_e, q_i=u.q_i, m_e=u.m_e, m_i=u.m_i,
               neutral_ref=phys["neutral_ref"])
    mj = jd3.update_macro3(sj.f, sj.g, sj.Ex, sj.Ey, sj.Ez, **mkw)
    mt = td3.update_macro3(st.f, st.g, st.Ex, st.Ey, st.Ez, **mkw)
    kw = dict(phys, g_recip=(lambda x: 1.0 / x) if recip else None)
    for s in range(3):
        fj, gj = jd3.collide_species_dirs3(s, sj.f[s], sj.g[s], mj, sj.Ex,
                                           sj.Ey, sj.Ez, **kw)
        ft, gt = td3.collide_species_dirs3(s, st.f[s], st.g[s], mt, st.Ex,
                                           st.Ey, st.Ez, **kw)
        for i in range(19):
            assert_close(ft[i], fj[i], rtol=1e-12, atol_rel=1e-12,
                         name=f"f[{s}][{i}]")
            assert_close(gt[i], gj[i], rtol=1e-12, atol_rel=1e-12,
                         name=f"g[{s}][{i}]")


@pytest.mark.parametrize("shape", [(8, 12, 16), (128, 128, 128)])
def test_solve_fft3d_and_efield_match(shape):
    """At 128^3 the JAX package takes its packed-halves transform."""
    nz, ny, nx = shape
    assert np.array_equal(tp3.spectral_inv3d(*shape),
                          jp3.spectral_inv3d(*shape))
    packed = nz * ny * nx >= jp3._PACKED_FFT3_MIN_SITES
    assert packed == (shape == (128, 128, 128))
    rho = np.random.default_rng(nz * 7 + nx).standard_normal(shape) * 1e-3
    phi_j = jp3.solve_fft3d(jnp.asarray(rho))
    phi_t = tp3.solve_fft3d(torch.from_numpy(rho))
    assert phi_t.dtype == torch.float64
    assert_close(phi_t, phi_j, rtol=0, atol_rel=1e-12, name="phi")
    for name, got, want in zip(("Ex", "Ey", "Ez"),
                               tp3.efield_periodic3d(phi_t),
                               jp3.efield_periodic3d(phi_j)):
        assert_close(got, want, rtol=0, atol_rel=1e-12, name=name)


# ---------------------------------------------------------------------------
# the plain step against the JAX package's jnp step
# ---------------------------------------------------------------------------

STEP_CASES = {
    "f64-FFT": ("float64", "native", False, "FFT", True, 1e-11),
    "f64-delta-FFT": ("float64", "native", True, "FFT", True, 1e-11),
    "f64-NONE-quirk": ("float64", "native", False, "NONE", True, 1e-11),
    "f64-NONE-noquirk": ("float64", "native", False, "NONE", False, 1e-11),
    "f32-delta-FFT": ("float32", "native", True, "FFT", True, 1e-5),
    "bf16-delta-FFT": ("float32", "bf16", True, "FFT", True, 1e-5),
}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_plain_step_matches_jnp_step(case):
    dtype, storage, delta, poisson, quirk, tol = STEP_CASES[case]
    cfg_j, cfg_t = configs(
        dtype=dtype, **OP_SHAPE, storage=storage,
        neutral_delta=delta, poisson=tcfg.PoissonSolver[poisson],
        compat=tcfg.CompatFlags(none_solver_kills_external_field=quirk))
    want = _jax_states(cfg_j, 3)
    state = interop.plasma3d_state_from_numpy(as_numpy(want[0]), "cpu")
    step = tp3.make_step(cfg_t)
    for t in range(1, 4):
        state = step(state)
        _close_state(state, want[t], tol, bf16=storage == "bf16")
    assert state.f.dtype == (torch.bfloat16 if storage == "bf16"
                             else cfg_t.dtype)


@pytest.mark.parametrize("nz, ny, nx, dtype, storage, delta", [
    (1, 16, 12, "float64", "native", False),
    (2, 13, 11, "float64", "native", True),
    (8, 16, 12, "float32", "bf16", True)])
def test_collide_stream3d_reference_matches_jnp(nz, ny, nx, dtype, storage,
                                                delta):
    """The kernel's plain version (its only version on CPU tensors) against
    update_macro + collide + stream_periodic of the JAX model, on a slab of
    a perturbed warm 12x16x8 state: NZ = 1 and 2 are the degenerate z
    wraps, 13x11 an odd cross-section. The collision is per site, so the
    JAX side collides the whole state once and streams the slab."""
    sj, st, cfg_t = _op_inputs(delta, dtype=dtype)
    u, phys = _phys(cfg_t)
    if storage == "bf16":
        sj = sj._replace(f=sj.f.astype(jnp.bfloat16),
                         g=sj.g.astype(jnp.bfloat16))
        st = st._replace(f=st.f.to(torch.bfloat16), g=st.g.to(torch.bfloat16))
    fc, gc = sj.f.astype(sj.Ex.dtype), sj.g.astype(sj.Ex.dtype)
    mj = jp3.update_macro(fc, gc, sj.Ex, sj.Ey, sj.Ez, q_e=u.q_e, q_i=u.q_i,
                          m_e=u.m_e, m_i=u.m_i,
                          neutral_ref=phys["neutral_ref"])
    fj, gj = jp3.collide(fc, gc, mj, sj.Ex, sj.Ey, sj.Ez, **phys,
                         g_recip=(lambda x: 1.0 / x) if storage == "bf16"
                         else None)
    box = (slice(0, nz), slice(0, ny), slice(0, nx))
    pbox = (slice(None), slice(None)) + box
    # streaming moves values only, so jit cannot change them
    stream = jax.jit(lambda a: jp3.stream_periodic(a).astype(sj.f.dtype))
    want = (stream(np.asarray(fj)[pbox]), stream(np.asarray(gj)[pbox]),
            np.asarray(mj.rho_q)[box])
    slab = [t[pbox].contiguous() for t in (st.f, st.g)] + [
        t[box].contiguous() for t in (st.Ex, st.Ey, st.Ez)]
    launches = fused_step3d.LAUNCHES
    got = fused_step3d.collide_stream3d(*slab, **phys)
    assert fused_step3d.LAUNCHES == launches   # CPU tensors: no kernel
    for name, g, w in zip(("f", "g"), got, want):
        assert g.dtype == st.f.dtype and g.shape == (3, 19, nz, ny, nx)
        _close_populations(g, w, 1e-12, name)
    assert_close(got[2], want[2], rtol=0, atol_rel=1e-12, name="rho_q")


# ---------------------------------------------------------------------------
# interop, CLI, refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("storage", ["native", "bf16"])
def test_interop_round_trip(storage):
    cfg_j, cfg_t = configs(dtype="float32", **OP_SHAPE, storage=storage,
                           neutral_delta=True)
    arrays = as_numpy(_jax_states(cfg_j, 1)[-1])
    state = interop.plasma3d_state_from_numpy(arrays, "cpu")
    assert state.step == 1 and state.f.shape == (3, 19, 8, 16, 12)
    assert state.f.dtype == (torch.bfloat16 if storage == "bf16"
                             else torch.float32)
    back = interop.plasma3d_state_to_numpy(state)
    assert set(back) == set(arrays)
    for k, v in arrays.items():
        assert back[k].dtype == v.dtype, k
        np.testing.assert_array_equal(_bits(back[k]), _bits(v), err_msg=k)


def test_cli_writes_timing_and_slice(tmp_path, monkeypatch, capsys):
    out = tmp_path / "run3d"
    monkeypatch.setattr(sys, "argv", [
        "run_plasma3d_torch.py", "--device", "cpu", "--n", "16", "--nz", "8",
        "--steps", "3", "--slice-every", "3", "--backend", "plain",
        "--out", str(out)])
    runpy.run_path(os.path.join(REPO, "scripts", "run_plasma3d_torch.py"),
                   run_name="__main__")
    assert "3D column done: 16^2x8, 3 steps" in capsys.readouterr().out
    rows = (out / "simulation_time_3d.csv").read_text().splitlines()
    assert rows[0].startswith("Grid_Dimension,") and rows[1].startswith(
        "16x128,3,1,3,0,")
    sl = np.load(out / "slice_00003.npz")
    assert int(sl["step"]) == 3
    assert sl["rho_e"].shape == sl["rho_q"].shape == (16, 16)
    # the slice is the observation of the CLI's end state
    summary = run_plasma3d.main(["--device", "cpu", "--n", "16", "--nz", "8",
                                 "--steps", "3", "--slice-every", "0",
                                 "--out", str(tmp_path / "again")])
    assert summary["finite"] and summary["launches"] == dict.fromkeys(
        ["collide_stream3d", *fused_step3d.HALO_LAUNCHES], 0)
    mac = tp3.compute_macros(tcfg.preset_plasma_3d(16, 8), summary["state"])
    np.testing.assert_array_equal(sl["rho_e"], mac.rho[0, 4].numpy())
    np.testing.assert_array_equal(sl["rho_q"], mac.rho_q[4].numpy())


# --checkpoint-every and --resume were refused until checkpoints came
# (ROADMAP Queue 1 item 13): those cases keep their ids and now hold the
# refusal of a checkpoint that is not there
@pytest.mark.parametrize("flags, message", [
    (["--backend", "pallas"], None),
    (["--multistep", "4"], "multi-chip only in 3-D"),
    (["--shard", "2"], "torchrun --nproc-per-node 2"),
    pytest.param(["--checkpoint-every", "5", "--resume", "missing.npz"],
                 "--resume: [Errno 2] No such file",
                 id="flags3-Queue 1 item 13"),
    pytest.param(["--resume", "ckpt.npz"], "--resume: [Errno 2] No such file",
                 id="flags4-Queue 1 item 13"),
    (["--storage", "bf16", "--f64"], "drop --f64")])
def test_cli_refuses(flags, message, tmp_path):
    with pytest.raises(SystemExit) as e:
        run_plasma3d.main(["--device", "cpu", "--n", "8", "--nz", "2",
                           "--steps", "1", "--out", str(tmp_path), *flags])
    if message is not None:
        assert message in str(e.value)


def test_cli_cuda_without_gpu_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device runs")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_plasma3d.main(["--n", "8", "--nz", "2", "--steps", "1",
                           "--out", str(tmp_path)])


@pytest.mark.parametrize("fields, error, match", [
    ({"backend": "pallas"}, ValueError, "pallas"),
    ({"backend": "fused", "multistep": 4,
      "poisson": tcfg.PoissonSolver.NONE}, ValueError, "multi-chip only"),
    ({"poisson": tcfg.PoissonSolver.SOR}, ValueError, "FFT/NONE"),
    ({"bc": tcfg.BC.BOUNCE_BACK}, ValueError, "periodic"),
    ({"NZ": 0}, ValueError, "NZ > 0")])
def test_make_step_refuses(fields, error, match):
    cfg = dataclasses.replace(tcfg.preset_plasma_3d(8, 2), **fields)
    with pytest.raises(error, match=match):
        tp3.make_step(cfg)


def test_2d_model_points_to_plasma3d():
    with pytest.raises(NotImplementedError, match="models/plasma3d"):
        tplasma.make_step(tcfg.preset_plasma_3d(8, 2))
