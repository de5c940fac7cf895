"""Bounce-back walls and the solver x wall matrix of the port, on the CPU.

  * lbm_tpu_torch.ops.stream's bounce-back (bounceback_from_periodic,
    stream_bounceback, hole_values_from_periodic and the flat-gather
    oracle) against lbm_tpu.ops.stream at 8x8 and 7x9, bitwise in f64;
  * the step, f64, 3 steps at 24x32 with a fixed sweep count
    (poisson_tol=0, poisson_max_iter=30: a last-bit difference in rho_q
    could move a tol-stopped solve by one sweep), at the step gate of
    tests/test_torch_plasma.py, 1e-11 relative:
      - every solver x wall pair on the plain backend, against the JAX
        package's jnp step run op by op (torch_parity.op_by_op);
      - the fused backend with delta storage (SOR) and the pallas backend
        (GS) under bounce-back, against the JAX package's interpret-mode
        kernels, from a seeded perturbation of a warm state (from the
        initial state rho_q is rounding noise, which the solve amplifies
        past the gate);
  * bf16 + delta storage under bounce-back, plain and fused, within one
    bf16 ulp of the JAX step (the fused path rounds the 8 g corner holes
    twice);
  * collide_pallas.fused_collide's plain version against the JAX Pallas
    kernel in interpret mode, inside the pallas step test;
  * the CLI with --poisson SOR --bc bounceback on --device cpu, and
    check_supported admitting every solver x wall pair on every backend
    (what it still refuses: tests/test_torch_config.py).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu.kernels.collide_pallas import fused_collide as jax_fused_collide
from lbm_tpu.models import plasma as jplasma
from lbm_tpu.ops import stream as jstream
from lbm_tpu_torch import interop, run_plasma
from lbm_tpu_torch.config import BC, PoissonSolver
from lbm_tpu_torch.kernels import collide_pallas, fused_step, poisson_iter
from lbm_tpu_torch.models import plasma as tplasma
from lbm_tpu_torch.ops import stream as tstream

from torch_parity import (as_numpy, assert_close, assert_within_bf16_ulp,
                          configs, op_by_op, perturb, to_jax, to_torch)

torch.set_num_threads(1)

SHAPES = [(8, 8), (7, 9)]
FIELDS = ("f", "g", "Ex", "Ey", "phi")


def _lattice(ny, nx, seed):
    return np.random.default_rng(seed).standard_normal((3, 9, ny, nx))


def _holes(seed):
    return [np.random.default_rng(seed + k).standard_normal(3)
            for k in range(8)]


@pytest.mark.parametrize("ny, nx", SHAPES)
def test_bounceback_from_periodic_matches_jax(ny, nx):
    f, holes = _lattice(ny, nx, 1), _holes(2)
    out = tstream.stream_periodic(torch.as_tensor(f))
    got = tstream.bounceback_from_periodic(out, [torch.as_tensor(h)
                                                 for h in holes])
    assert got is out   # the fixups are written in place
    want = jstream.bounceback_from_periodic(
        jstream.stream_periodic(jnp.asarray(f)), [jnp.asarray(h) for h in holes])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("stale", [False, True], ids=["self", "stale"])
@pytest.mark.parametrize("ny, nx", SHAPES)
def test_stream_bounceback_matches_jax_and_the_gather_oracle(ny, nx, stale):
    f = _lattice(ny, nx, 3)
    st = _lattice(ny, nx, 4) if stale else None
    t_st = None if st is None else torch.as_tensor(st)
    j_st = None if st is None else jnp.asarray(st)
    got = tstream.stream_bounceback(torch.as_tensor(f), stale=t_st).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jstream.stream_bounceback(jnp.asarray(f), stale=j_st)))
    oracle = tstream.stream_bounceback_gather(torch.as_tensor(f), stale=t_st)
    np.testing.assert_array_equal(oracle.numpy(), got)
    np.testing.assert_array_equal(
        oracle.numpy(),
        np.asarray(jstream.stream_bounceback_gather(jnp.asarray(f), j_st)))


@pytest.mark.parametrize("ny, nx", SHAPES)
def test_hole_values_from_periodic_match_jax(ny, nx):
    f_post = _lattice(ny, nx, 5)
    out = tstream.stream_periodic(torch.as_tensor(f_post))
    got = tstream.hole_values_from_periodic(out)
    want = jstream.hole_values_from_periodic(
        jstream.stream_periodic(jnp.asarray(f_post)))
    direct = tstream.hole_values(torch.as_tensor(f_post))
    for g, w, d in zip(got, want, direct):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(g.numpy(), d.numpy())
    out[...] = 0.0   # the values are copies, not views of out
    assert all(torch.equal(g, d) for g, d in zip(got, direct))


def _step_both(cfg_j, cfg_t, state_arrays, n_steps, jax_op_by_op=True):
    """(JAX state, port state) after n_steps from the same arrays."""
    sj, st = to_jax(state_arrays), to_torch(state_arrays)
    step_j = jplasma.make_step(cfg_j)
    if jax_op_by_op:
        step_j = op_by_op(step_j)
    step_t = tplasma.make_step(cfg_t)
    for _ in range(n_steps):
        sj, st = step_j(sj), step_t(st)
    return sj, st


ITER = dict(NX=32, NY=24, poisson_tol=0.0, poisson_max_iter=30)


@pytest.mark.parametrize("bc", [BC.PERIODIC, BC.BOUNCE_BACK],
                         ids=["periodic", "bounceback"])
@pytest.mark.parametrize("solver", list(PoissonSolver),
                         ids=[s.name for s in PoissonSolver])
def test_plain_step_matches_jax(solver, bc):
    cfg_j, cfg_t = configs(poisson=solver, bc=bc, **ITER)
    arrays = as_numpy(jplasma.init_state(cfg_j))
    sj, st = _step_both(cfg_j, cfg_t, arrays, 3)
    for k in FIELDS:
        assert_close(getattr(st, k), getattr(sj, k), rtol=1e-11,
                     atol_rel=1e-11, name=k)
    assert st.step == 3


def _phys(cfg):
    u = cfg.units()
    return dict(taus=cfg.taus, q_e=u.q_e, q_i=u.q_i, m_e=u.m_e, m_i=u.m_i,
                cs2=u.cs2, kb=u.kb,
                neutral_ref=u.rho_n_init if cfg.neutral_delta else 0.0)


@pytest.mark.parametrize("backend, solver, delta", [
    ("fused", PoissonSolver.SOR, True),
    ("pallas", PoissonSolver.GS, False),
])
def test_kernel_backend_bounceback_step_matches_jax(backend, solver, delta):
    """On CPU tensors the port's kernels run their plain versions, so no
    launch is counted. The pallas case first holds collide_pallas's
    fused_collide alone against the JAX Pallas kernel."""
    cfg_j, cfg_t = configs(backend=backend, poisson=solver,
                           bc=BC.BOUNCE_BACK, neutral_delta=delta, **ITER)
    # the warm state from the port's plain steps (both sides start from the
    # same arrays, so it need not come from JAX)
    plain = tplasma.make_step(dataclasses.replace(cfg_t, backend="plain"))
    warm = tplasma.init_state(cfg_t, "cpu")
    for _ in range(2):
        warm = plain(warm)
    arrays = perturb(interop.state_to_numpy(warm), seed=5)
    if backend == "pallas":
        sj, st = to_jax(arrays), to_torch(arrays)
        phys = _phys(cfg_t)
        want = jax_fused_collide(sj.f, sj.g, sj.Ex, sj.Ey, interpret=True,
                                 **phys)
        got = collide_pallas.fused_collide(st.f, st.g, st.Ex, st.Ey, **phys)
        for name, g, w in zip(("f_post", "g_post", "rho_q"), got, want):
            assert_close(g, w, rtol=1e-12, atol_rel=1e-14, name=name)
    before = (fused_step.LAUNCHES, collide_pallas.LAUNCHES,
              poisson_iter.LAUNCHES)
    sj, st = _step_both(cfg_j, cfg_t, arrays, 3, jax_op_by_op=False)
    for k in FIELDS:
        assert_close(getattr(st, k), getattr(sj, k), rtol=1e-11,
                     atol_rel=1e-11, name=k)
    assert before == (fused_step.LAUNCHES, collide_pallas.LAUNCHES,
                      poisson_iter.LAUNCHES) == (0, 0, 0)


@pytest.mark.parametrize("backend", ["plain", "fused"])
def test_bf16_delta_bounceback_within_one_ulp(backend):
    cfg_j, cfg_t = configs(dtype="float32", storage="bf16",
                           neutral_delta=True, poisson=PoissonSolver.GS,
                           bc=BC.BOUNCE_BACK, **ITER)
    cfg_t = dataclasses.replace(cfg_t, backend=backend)
    # GS has no product to contract, so the JAX step may run compiled
    sj, st = _step_both(cfg_j, cfg_t, as_numpy(jplasma.init_state(cfg_j)), 3,
                        jax_op_by_op=False)
    assert st.f.dtype == st.g.dtype == torch.bfloat16
    for k in ("f", "g"):
        assert_within_bf16_ulp(getattr(st, k), getattr(sj, k), name=k)
    for k in ("Ex", "Ey", "phi"):
        assert_close(getattr(st, k), getattr(sj, k), rtol=1e-5,
                     atol_rel=1e-5, name=k)


def test_fused_collide_refuses_non_cpu_tensors():
    """A tensor that is not on the CPU goes to the kernel or raises: here
    (meta tensors) the input check refuses it before any build."""
    _, cfg = configs()
    meta = torch.empty((3, 9, 8, 8), device="meta", dtype=torch.float64)
    e = torch.empty((8, 8), device="meta", dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA"):
        collide_pallas.fused_collide(meta, meta, e, e, **_phys(cfg))


def test_cli_runs_sor_bounceback_on_cpu(tmp_path):
    summary = run_plasma.main([
        "--device", "cpu", "--nx", "32", "--ny", "24", "--steps", "3",
        "--poisson", "SOR", "--bc", "bounceback", "--out", str(tmp_path)])
    assert summary["finite"] and summary["steps"] == 3
    assert (summary["poisson"], summary["bc"]) == ("SOR", "BOUNCE_BACK")
    assert summary["launches"] == {"collide_stream": 0, "fused_collide": 0,
                                   "solve_iter": 0,
                                   "collide_stream_multistep": 0,
                                   "collide_stream_multistep_gated": 0,
                                   "fft_solve": 0, "collide_stream_halo": 0,
                                   "collide_stream_halo2d": 0}
    with open(tmp_path / "simulation_time_plasma_details.csv") as fh:
        row = fh.read().splitlines()[1]
    assert row.startswith("32x24,3,1,2,1,")


def test_check_supported_runs_every_2d_solver_and_wall():
    for backend in ("plain", "fused", "pallas"):
        for solver in PoissonSolver:
            for bc in BC:
                _, cfg = configs(backend=backend, poisson=solver, bc=bc)
                tplasma.make_step(cfg)
    _, cfg = configs(dtype="float32", backend="pallas", storage="bf16")
    with pytest.raises(ValueError, match="bf16"):
        tplasma.make_step(cfg)
