"""The port's debug variant, staged step and debug dump against the compiled
C++ reference, lbm_tpu and the numpy oracle, on the CPU in float64.

  * The five tests of tests/test_reference_parity.py, rerun through the
    port (lbm_tpu_torch.models.plasma, plain backend, debug_variant) at 8x8
    over 5 steps against the C++ debug build's dumps
    tests/fixtures/ref_dump_solver{0..4}.txt.gz and _bb, at their own gates:
    f at rtol 3e-6 / atol 3e-6*scale; E at 3e-5 (codes 1-4); the macros
    (codes 0-1); bounce-back (codes 0, 1); and the --debug-dump CLI (FFT),
    all 25 (step, stage) pairs at rtol 3e-6 / atol max(3e-6*scale, 1e-15).
  * The same runs against lbm_tpu's jnp step, run op by op (unjitted): f,
    g, Ex and Ey within 1e-12 of scale. SOR and NPS under periodic walls
    hold E at 1e-10 of scale: JAX compiles its iterative solvers'
    lax.while_loop even outside jax.jit, and XLA's CPU backend contracts the
    SOR blend and the 9-point sum into fused multiply-adds there, which 5000
    sweeps on a drifting periodic potential grow to ~3e-11 of E's scale
    (measured; NONE, GS and FFT are bitwise or within 1e-15). The port's
    periodic SOR and NPS sweeps are held bitwise against JAX run with
    jax.disable_jit in tests/test_torch_poisson_iter.py.
  * The port's plain step held stage by stage against the numpy oracle
    tests/oracle.Oracle (macros, the 9 equilibrium sets, collide, stream,
    the solve), as tests/test_plasma_parity.py holds lbm_tpu, over its
    solver x wall cases at 12x12 for 5 steps, at that file's gates; the
    staged step's state equal to the plain step's, bitwise.
  * DebugDumper's bytes equal to lbm_tpu's, given the same snapshot.

Each configuration's runs are made once and shared between the tests.
"""
import dataclasses
import filecmp
import functools
import os

import numpy as np
import pytest
import torch

from lbm_tpu import config as jcfg
from lbm_tpu.io import debug_dump as jdebug_dump
from lbm_tpu.models import plasma as jplasma
from lbm_tpu.models import plasma_staged as jstaged
from lbm_tpu.ops import macros as jmacros
from lbm_tpu_torch import config as tcfg
from lbm_tpu_torch import run_plasma
from lbm_tpu_torch.io import debug_dump
from lbm_tpu_torch.models import plasma as tplasma
from lbm_tpu_torch.models import plasma_staged
from lbm_tpu_torch.ops import macros as tmacros

import oracle
from test_reference_parity import FIXDIR, _f_array, parse_dump
from torch_parity import assert_close, configs, np_of

torch.set_num_threads(1)

SOLVERS = {0: tcfg.PoissonSolver.NONE, 1: tcfg.PoissonSolver.GS,
           2: tcfg.PoissonSolver.SOR, 3: tcfg.PoissonSolver.FFT,
           4: tcfg.PoissonSolver.NPS}
DEBUG = tcfg.CompatFlags(none_solver_kills_external_field=False,
                         dirichlet_iterative_under_periodic=False,
                         debug_variant=True)


@functools.lru_cache(maxsize=None)
def _configs(code: int, bc: str):
    return configs("float64", NX=8, NY=8, nsteps=5, poisson=SOLVERS[code],
                   bc=tcfg.BC[bc], compat=DEBUG)


@functools.lru_cache(maxsize=None)
def _port_run(code: int, bc: str = "PERIODIC"):
    """The port's states 0..5 of the debug variant."""
    _, ct = _configs(code, bc)
    states = [tplasma.init_state(ct, "cpu")]
    step = tplasma.make_step(ct)
    for _ in range(5):
        states.append(step(states[-1]))
    return states


@functools.lru_cache(maxsize=None)
def _dump(name: str):
    return parse_dump(os.path.join(FIXDIR, f"ref_dump_{name}.txt.gz"))


@pytest.mark.parametrize("code", [0, 1, 2, 3, 4])
def test_f_trajectory_matches_cpp_reference(code):
    dump = _dump(f"solver{code}")
    states = _port_run(code)
    for t in range(5):
        ref = dump[(t, "Streaming")]
        for k, s in enumerate("ein"):
            got = np_of(states[t + 1].f[k])
            want = _f_array(ref[f"f_{s}"])
            np.testing.assert_allclose(
                got, want, rtol=3e-6, atol=3e-6 * np.abs(want).max(),
                err_msg=f"f_{s} after step {t} (solver {code})")


@pytest.mark.parametrize("code", [1, 2, 3, 4])
def test_efield_matches_cpp_reference(code):
    dump = _dump(f"solver{code}")
    states = _port_run(code)
    for t in range(5):
        ref = dump[(t, "SolvePoisson")]
        mine = states[t + 1]
        scale = max(np.abs(ref["Ex"]).max(), np.abs(ref["Ey"]).max(), 1e-12)
        for name in ("Ex", "Ey"):
            np.testing.assert_allclose(
                np_of(getattr(mine, name)), ref[name], rtol=3e-5,
                atol=3e-5 * scale, err_msg=f"{name} after step {t}")


@pytest.mark.parametrize("code", [0, 1])
def test_macros_match_cpp_reference(code):
    dump = _dump(f"solver{code}")
    _, ct = _configs(code, "PERIODIC")
    states = _port_run(code)
    for t in range(5):
        ref = dump[(t, "UpdateMacro")]
        mac = tplasma.compute_macros(ct, states[t])
        for k, s in enumerate("ein"):
            rscale = np.abs(ref[f"rho_{s}"]).max()
            np.testing.assert_allclose(
                np_of(mac.rho[k]), ref[f"rho_{s}"], rtol=3e-6,
                atol=3e-6 * rscale, err_msg=f"rho_{s} at step {t}")
            # atol floor 1e-15: cancellation noise where the C++ sums
            # cancel exactly to 0
            uscale = np.abs(ref[f"ux_{s}"]).max()
            np.testing.assert_allclose(
                np_of(mac.ux[k]), ref[f"ux_{s}"], rtol=3e-5,
                atol=max(1e-4 * uscale, 1e-15), err_msg=f"ux_{s} at step {t}")
        qscale = np.abs(ref["rho_q"]).max()
        np.testing.assert_allclose(
            np_of(mac.rho_q), ref["rho_q"], rtol=3e-5,
            atol=max(1e-4 * qscale, 1e-15), err_msg=f"rho_q at step {t}")


@pytest.mark.parametrize("code", [0, 1])
def test_bounceback_trajectory_matches_cpp_reference(code):
    """Bounce-back walls, the reference's corner-hole quirks included (the
    debug build's g holes keep the pre-collision g)."""
    dump = _dump(f"solver{code}_bb")
    states = _port_run(code, "BOUNCE_BACK")
    for t in range(5):
        ref = dump[(t, "Streaming")]
        for k, s in enumerate("ein"):
            want = _f_array(ref[f"f_{s}"])
            np.testing.assert_allclose(
                np_of(states[t + 1].f[k]), want, rtol=3e-6,
                atol=3e-6 * np.abs(want).max(),
                err_msg=f"f_{s} after step {t} (bounce-back, solver {code})")


def test_cli_debug_dump_matches_cpp_reference(tmp_path):
    """--debug-variant --debug-dump writes all 5 pipeline stages of every
    step in the C++ debug build's format; every field of every (step,
    stage) matches the reference fixture (FFT, 8x8, 5 steps)."""
    out = tmp_path / "dbg"
    summary = run_plasma.main(
        ["--device", "cpu", "--f64", "--nx", "8", "--ny", "8", "--steps",
         "5", "--poisson", "FFT", "--debug-variant", "--debug-dump",
         "--out", str(out)])
    assert summary["finite"] and summary["backend"] == "plain"
    assert summary["state"].step == 5
    mine = parse_dump(str(out / "debug_dump.txt"))
    ref = _dump("solver3")
    assert set(mine) == set(ref)            # same (step, stage) coverage
    assert len(ref) == 25                   # 5 steps x 5 stages
    for key in sorted(ref):
        for field in ref[key]:
            want, got = ref[key][field], mine[key][field]
            if isinstance(want, dict):      # population set: dir -> grid
                want, got = _f_array(want), _f_array(got)
            scale = np.abs(want).max()
            np.testing.assert_allclose(
                got, want, rtol=3e-6, atol=max(3e-6 * scale, 1e-15),
                err_msg=f"{field} at {key}")
    with pytest.raises(SystemExit, match="per-step marching"):
        run_plasma.main(["--device", "cpu", "--debug-dump", "--multistep",
                         "2", "--out", str(tmp_path / "ms")])


@pytest.mark.parametrize("code, bc", [
    (0, "PERIODIC"), (1, "PERIODIC"), (2, "PERIODIC"), (3, "PERIODIC"),
    (4, "PERIODIC"), (0, "BOUNCE_BACK"), (1, "BOUNCE_BACK")])
def test_debug_runs_match_lbm_tpu(code, bc):
    cj, _ = _configs(code, bc)
    state = jplasma.init_state(cj)
    step = jplasma.make_step(cj)                 # op by op, unjitted
    e_rel = 1e-10 if (code in (2, 4) and bc == "PERIODIC") else 1e-12
    for t, mine in enumerate(_port_run(code, bc)[1:]):
        state = step(state)
        for k in range(3):
            for name in ("f", "g"):
                assert_close(getattr(mine, name)[k], getattr(state, name)[k],
                             rtol=1e-12, atol_rel=1e-12,
                             name=f"{name}[{k}] after step {t}")
        scale = max(np.abs(np_of(state.Ex)).max(),
                    np.abs(np_of(state.Ey)).max())
        for name in ("Ex", "Ey"):
            err = np.abs(np_of(getattr(mine, name))
                         - np_of(getattr(state, name))).max()
            assert err <= e_rel * scale, (
                f"{name} after step {t}: {err / scale:.3e} of scale")


# ---------------------------------------------------------------------------
# The plain step against the numpy oracle, stage by stage
# ---------------------------------------------------------------------------

def _close(got, want, rtol=1e-9, atol=None, name=""):
    want = np.asarray(want)
    if atol is None:
        atol = 1e-12 * max(np.abs(want).max(), 1.0)
    np.testing.assert_allclose(np_of(got), want, rtol=rtol, atol=atol,
                               err_msg=name)


_ORACLE_EQ = {"f_eq_e": "e", "f_eq_i": "i", "f_eq_n": "n",
              "f_eq_e_i": "ei", "f_eq_i_e": "ie", "f_eq_e_n": "en",
              "f_eq_n_e": "ne", "f_eq_i_n": "in", "f_eq_n_i": "ni"}


@pytest.mark.parametrize("bc", ["PERIODIC", "BOUNCE_BACK"])
@pytest.mark.parametrize("code", [0, 3, 1, 2, 4],
                         ids=["NONE", "FFT", "GS", "SOR", "NPS"])
def test_plain_step_matches_oracle_stage_by_stage(code, bc):
    cj, ct = configs("float64", NX=12, NY=12, nsteps=5, poisson=SOLVERS[code],
                     bc=tcfg.BC[bc], poisson_max_iter=60)
    o = oracle.Oracle(cj)
    state = tplasma.init_state(ct, "cpu")
    staged = plasma_staged.make_staged_step(ct)
    step = tplasma.make_step(ct)
    feq = plasma_staged.init_feq(ct, "cpu")
    for t in range(5):
        plain = step(state)
        state, feq, stages = staged(state, feq)
        for name in ("f", "g", "Ex", "Ey", "phi"):
            assert torch.equal(getattr(state, name), getattr(plain, name)), (
                f"staged vs plain step {name} at step {t}")
        o.update_macro()
        mac = stages["UpdateMacro"].mac
        for k, s in enumerate("ein"):
            _close(mac.rho[k], o.rho[s], name=f"rho_{s} at {t}")
            _close(mac.T[k], o.T[s], name=f"T_{s} at {t}")
            _close(mac.ux[k], o.ux[s], rtol=1e-8, atol=1e-13,
                   name=f"ux_{s} at {t}")
            _close(mac.uy[k], o.uy[s], rtol=1e-8, atol=1e-13,
                   name=f"uy_{s} at {t}")
        _close(mac.rho_q, o.rho_q, rtol=1e-8, atol=1e-14, name=f"rho_q {t}")
        o.compute_equilibria()
        for label, key in _ORACLE_EQ.items():
            _close(stages["ComputeEquilibrium"].feq[label], o.feq[key],
                   name=f"{label} at {t}")
        f_pre = {s: o.f[s].copy() for s in "ein"}
        o.collide()
        for k, s in enumerate("ein"):
            _close(stages["Collisions"].f[k], o.f[s],
                   name=f"collided f_{s} at {t}")
        o.stream(f_pre_collide=f_pre)
        for k, s in enumerate("ein"):
            _close(stages["Streaming"].f[k], o.f[s],
                   name=f"streamed f_{s} at {t}")
            _close(state.g[k], o.g[s], name=f"g_{s} at {t}")
        o.solve_poisson()
        e_atol = 1e-12 * max(np.abs(o.Ex).max(), np.abs(o.Ey).max(), 1e-3)
        for name in ("Ex", "Ey"):
            _close(getattr(stages["SolvePoisson"], name), getattr(o, name),
                   atol=e_atol, name=f"{name} at {t}")


# ---------------------------------------------------------------------------
# The dumper's bytes
# ---------------------------------------------------------------------------

def test_dumper_output_matches_jax_byte_for_byte(tmp_path):
    """One 8x8 stage of seeded values spanning 60 decades, signs and zeros,
    written by both packages' dumpers from the same numpy arrays."""
    rng = np.random.default_rng(7)

    def field(*shape):
        a = rng.standard_normal(shape) * 10.0 ** rng.integers(-30, 30, shape)
        a[rng.random(shape) < 0.1] = 0.0
        return a

    planes = {k: field(3, 8, 8) for k in ("rho", "ux", "uy", "T", "ux_pair",
                                          "uy_pair", "rho_raw")}
    planes["rho_q"] = field(8, 8)
    f = field(3, 9, 8, 8)
    Ex, Ey = field(8, 8), field(8, 8)
    feq = {label: field(9, 8, 8) for label in plasma_staged.EQ_LABELS}
    assert plasma_staged.EQ_LABELS == jstaged.EQ_LABELS
    assert plasma_staged.STAGES == jstaged.STAGES

    mine_path, ref_path = tmp_path / "mine.txt", tmp_path / "ref.txt"
    mine = debug_dump.DebugDumper(tcfg.PlasmaConfig(NX=8, NY=8),
                                  str(mine_path))
    mine.dump_stage(3, "Streaming", plasma_staged.StageSnapshot(
        tmacros.Macros(**{k: torch.from_numpy(v) for k, v in planes.items()}),
        torch.from_numpy(Ex), torch.from_numpy(Ey), torch.from_numpy(f),
        {k: torch.from_numpy(v) for k, v in feq.items()}))
    mine.close()
    ref = jdebug_dump.DebugDumper(jcfg.PlasmaConfig(NX=8, NY=8),
                                  str(ref_path))
    ref.dump_stage(3, "Streaming", jstaged.StageSnapshot(
        jmacros.Macros(**planes), Ex, Ey, f, feq))
    ref.close()
    assert filecmp.cmp(mine_path, ref_path, shallow=False)
    assert mine_path.stat().st_size > 50_000
    # NX >= 11: both dumpers stay off and write nothing
    off = debug_dump.DebugDumper(dataclasses.replace(
        tcfg.PlasmaConfig(), NX=11, NY=8), str(tmp_path / "off.txt"))
    assert not off.enabled and not (tmp_path / "off.txt").exists()
