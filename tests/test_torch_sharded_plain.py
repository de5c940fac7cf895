"""The sharded plain steps of lbm_tpu_torch.parallel.sharding on gloo ranks:
make_sharded_step for every solver and wall type, and
make_sharded_cavity_step (counterparts of the GSPMD steps of
lbm_tpu/parallel/sharding.py).

One module-scoped 4-rank spawn of tests/torch_dist_ranks.py (its "plain"
scenario, no JAX in the children) runs every case of PLAIN_CASES and
PLAIN_CAVITY on its (dy, dx) mesh, the iterative solves capped at 40
sweeps as tests/test_sharding.py:57-59 caps them. The gathered states are
held:

  * against the port's single-device plain step bit for bit, apart from
    the periodic FFT solve (the slab transform rounds otherwise than
    rfft2), which holds at 1e-12 of each field's scale; every rank's sweep
    count after each step equals the single-device count;
  * in f64 against the JAX package's single-device jnp step run op by op:
    f and g rtol 1e-12, E rtol 1e-10 (tests/test_sharding.py:46-51), the
    cavity's f rtol 1e-14 and ux atol 1e-14 u_lid (:127-130);
  * bf16 storage bit for bit against the port's single-device step, as
    tests/test_bf16_sharded.py:171-186 holds the GSPMD bf16 step.

Each JAX reference is computed once per module, while the ranks run.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu.config import CavityConfig as JCavityConfig
from lbm_tpu.models import cavity as jcavity
from lbm_tpu.models import plasma as jplasma
from lbm_tpu_torch.config import BC, CavityConfig, PlasmaConfig, PoissonSolver
from lbm_tpu_torch.models import cavity, plasma
from lbm_tpu_torch.ops import poisson as poisson_ops
from lbm_tpu_torch.parallel import sharding

import torch_dist_ranks as ranks
from torch_parity import as_numpy, assert_close, configs, np_of, op_by_op

torch.set_num_threads(1)

FIELDS = ("f", "g", "Ex", "Ey", "phi")
ITERATIVE = ("GS", "SOR", "NPS")


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    """The 4-rank spawn, left running while the references are made."""
    procs = ranks.Ranks("plain", 4, tmp_path_factory.mktemp("plain"))
    yield procs
    procs.close()


@pytest.fixture(scope="module")
def runs(started, port_runs, jax_runs):
    return started.result()


def _fields(case):
    label, shape, ny, nx, solver, bc, dtype, storage, delta, tol = case
    return dict(NX=nx, NY=ny, poisson=PoissonSolver[solver], bc=BC[bc],
                poisson_max_iter=ranks.PLAIN_MAX_ITER, poisson_tol=tol)


@pytest.fixture(scope="module")
def port_runs():
    """The port's single-device plain state after PLAIN_STEPS steps, and
    the sweep count after each step, for each case."""
    out = {}
    for case in ranks.PLAIN_CASES:
        cfg = ranks.plain_config(*case[2:])
        state = plasma.init_state(cfg, "cpu")
        step = plasma.make_step(cfg)
        sweeps = []
        for _ in range(ranks.PLAIN_STEPS):
            state = step(state)
            sweeps.append(poisson_ops.LAST_SWEEPS)
        out[case[0]] = (state, sweeps)
    for label, _, n, dtype, steps in ranks.PLAIN_CAVITY:
        cfg = CavityConfig(NX=n, NY=n, dtype=dtype)
        out["cavity_" + label] = cavity.make_rollout(cfg, steps)(
            cavity.init_state(cfg, "cpu"))
    return out


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX package's single-device jnp state, op by op, for each f64
    case, and its cavity after each f64 cavity case's steps."""
    out = {}
    for case in ranks.PLAIN_CASES:
        if case[6] != torch.float64:
            continue
        cfg, _ = configs(**_fields(case))
        step = op_by_op(jplasma.make_step(cfg))
        state = jplasma.init_state(cfg)
        for _ in range(ranks.PLAIN_STEPS):
            state = step(state)
        out[case[0]] = as_numpy(state)
    for label, _, n, dtype, steps in ranks.PLAIN_CAVITY:
        if dtype != torch.float64:
            continue
        cfg = JCavityConfig(NX=n, NY=n, dtype=jnp.float64)
        step = op_by_op(jcavity.make_step(cfg))
        state = jcavity.init_state(cfg)
        for _ in range(steps):
            state = step(state)
        out["cavity_" + label] = {k: np.asarray(getattr(state, k))
                                  for k in ("f", "ux", "uy")}
    return out


@pytest.mark.parametrize("case", ranks.PLAIN_CASES, ids=lambda c: c[0])
def test_sharded_step_matches_single_device(runs, port_runs, jax_runs, case):
    label, shape, ny, nx, solver, bc, dtype = case[:7]
    got = runs[label]
    want, sweeps = port_runs[label]
    for name in FIELDS:
        if solver == "FFT" and bc == "PERIODIC":
            assert_close(got[name], getattr(want, name), rtol=0.0,
                         atol_rel=1e-12, name=f"{label} {name} vs the port")
        else:
            assert torch.equal(got[name], getattr(want, name)), (
                f"{label} {name} differs from the port's single-device step")
    if solver in ITERATIVE:
        assert got["sweeps"] == [sweeps] * 4, label
    if dtype != torch.float64:
        return
    ref = jax_runs[label]
    for name, rtol, atol in (("f", 1e-12, 1e-20), ("g", 1e-12, 1e-20),
                             ("Ex", 1e-10, 1e-16), ("Ey", 1e-10, 1e-16)):
        np.testing.assert_allclose(np_of(got[name]), ref[name], rtol=rtol,
                                   atol=atol, err_msg=f"{label} {name}")


def test_iterative_solve_stops_early_on_every_rank(runs, port_runs):
    """At poisson_tol 1e-4 the periodic GS stops before its 40 sweeps, on
    every rank at the single-device sweep."""
    _, sweeps = port_runs["yx22_gs_tol"]
    assert min(sweeps) < ranks.PLAIN_MAX_ITER, sweeps
    assert runs["yx22_gs_tol"]["sweeps"] == [sweeps] * 4


@pytest.mark.parametrize("case", ranks.PLAIN_CAVITY, ids=lambda c: c[0])
def test_sharded_cavity_matches_single_device(runs, port_runs, jax_runs,
                                              case):
    label, shape, n, dtype, steps = case
    got = runs["cavity_" + label]
    want = port_runs["cavity_" + label]
    for name in ("f", "rho", "ux", "uy"):
        assert torch.equal(getattr(got, name), getattr(want, name)), (
            f"cavity {label} {name}")
    assert got.step == steps
    if dtype != torch.float64:
        return
    ref = jax_runs["cavity_" + label]
    np.testing.assert_allclose(np_of(got.f), ref["f"], rtol=1e-14, atol=0)
    u_lid = CavityConfig().u_lid
    for name in ("ux", "uy"):
        np.testing.assert_allclose(np_of(getattr(got, name)), ref[name],
                                   rtol=0, atol=1e-14 * u_lid)


class _Mesh:
    """A stand-in for a (dy, dx) DeviceMesh: the step makers read its
    sizes (and the rank's coordinates) before any exchange."""

    mesh_dim_names = ("dy", "dx")

    def __init__(self, ny, nx):
        self._shape = (ny, nx)

    def size(self, dim=None):
        return self._shape[dim]

    def get_local_rank(self, axis):
        return 0


def test_sharded_cavity_refuses_the_indivisible_ghia_grid():
    """tests/test_sharding.py:131-141: 129^2 on more than one rank; and the
    sharded step refuses bf16 storage on the pallas backend, as the
    single-device make_step does."""
    with pytest.raises(ValueError, match="not divisible"):
        sharding.make_sharded_cavity_step(CavityConfig(), _Mesh(2, 2))
    with pytest.raises(ValueError, match="not divisible"):
        sharding.make_sharded_step(
            dataclasses.replace(PlasmaConfig(), NX=30, NY=30,
                                bc=BC.BOUNCE_BACK), _Mesh(4, 1))
    bf16 = PlasmaConfig(NX=32, NY=32, dtype=torch.float32, storage="bf16",
                        neutral_delta=True, backend="pallas")
    for make in (plasma.make_step,
                 lambda cfg: sharding.make_sharded_step(cfg, _Mesh(1, 1))):
        with pytest.raises(ValueError, match="plain and fused backends"):
            make(bf16)
