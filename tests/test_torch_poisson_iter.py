"""The port's iterative Poisson solvers against lbm_tpu's, on the CPU.

  * lbm_tpu_torch.ops.poisson.solve_gs (GS, SOR) and solve_9point (NPS),
    periodic and interior-only, at 16x24 and 15x21 (odd: the periodic wrap
    gives a site a neighbour of its own colour), against lbm_tpu.ops.poisson
    run op by op, bitwise in f64: a fixed 60 sweeps, tol-stopped solves
    (equal phi means an equal sweep count, since phi changes every sweep),
    and a phi0 holding a NaN (one sweep, as jnp.max propagates NaN);
  * efield_neumann, bitwise;
  * the kernel wrapper kernels/poisson_iter.solve_iter on CPU tensors (its
    plain version) against lbm_tpu's solve_iter_tpu in interpret mode: GS
    bitwise; SOR and NPS at 1e-13 of scale, because XLA compiles the
    interpret kernel's body with fused multiply-adds (torch_parity.op_by_op);
  * the wrapper's input checks on non-CPU tensors.

The CUDA kernel itself runs only on a GPU: chip_smoke.py holds it bitwise
against these plain sweeps there.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu.kernels import poisson_iter as jpoisson_iter
from lbm_tpu.ops import poisson as jpoisson
from lbm_tpu_torch.kernels import poisson_iter
from lbm_tpu_torch.ops import poisson as tpoisson

from torch_parity import op_by_op

torch.set_num_threads(1)

SOLVERS = [("gs", None), ("gs", 1.7), ("nps", None)]
SOLVER_IDS = ["gs", "sor", "nps"]


def _fields(ny, nx, seed):
    rng = np.random.default_rng(seed)
    rho = 0.01 * rng.random((ny, nx))
    rho -= rho.mean()
    return 0.005 * rng.random((ny, nx)), rho


@op_by_op
def _jax_solve(kind, omega, phi0, rho, **kw):
    args = (jnp.asarray(phi0), jnp.asarray(rho))
    if kind == "gs":
        return np.asarray(jpoisson.solve_gs(*args, omega=omega, **kw))
    return np.asarray(jpoisson.solve_9point(*args, **kw))


def _torch_solve(kind, omega, phi0, rho, **kw):
    args = (torch.as_tensor(phi0), torch.as_tensor(rho))
    if kind == "gs":
        return tpoisson.solve_gs(*args, omega=omega, **kw).numpy()
    return tpoisson.solve_9point(*args, **kw).numpy()


@pytest.mark.parametrize("periodic", [True, False],
                         ids=["periodic", "interior"])
@pytest.mark.parametrize("kind, omega", SOLVERS, ids=SOLVER_IDS)
@pytest.mark.parametrize("ny, nx", [(16, 24), (15, 21)])
def test_sweeps_match_jax_bitwise(ny, nx, kind, omega, periodic):
    phi0, rho = _fields(ny, nx, seed=ny * nx)
    kw = dict(periodic=periodic, max_iter=60, tol=0.0)
    np.testing.assert_array_equal(_torch_solve(kind, omega, phi0, rho, **kw),
                                  _jax_solve(kind, omega, phi0, rho, **kw))
    assert tpoisson.LAST_SWEEPS == 60
    counts = []
    for tol in (1e-3, 1e-5, 1e-7):
        kw = dict(periodic=periodic, max_iter=5000, tol=tol)
        got = _torch_solve(kind, omega, phi0, rho, **kw)
        counts.append(tpoisson.LAST_SWEEPS)
        np.testing.assert_array_equal(
            got, _jax_solve(kind, omega, phi0, rho, **kw), err_msg=f"tol {tol}")
    # the tolerance, not max_iter, ended each solve
    assert 1 < counts[0] < counts[1] < counts[2] < 5000, counts


@pytest.mark.parametrize("kind, omega", SOLVERS, ids=SOLVER_IDS)
def test_nan_phi0_stops_after_one_sweep(kind, omega):
    phi0, rho = _fields(15, 21, seed=1)
    phi0[7, 10] = np.nan
    kw = dict(periodic=False, max_iter=5000, tol=1e-8)
    got = _torch_solve(kind, omega, phi0, rho, **kw)
    assert tpoisson.LAST_SWEEPS == 1
    assert np.isnan(got).any()
    np.testing.assert_array_equal(got, _jax_solve(kind, omega, phi0, rho, **kw))


def test_zero_max_iter_returns_the_warm_start():
    phi0, rho = _fields(8, 8, seed=2)
    got = _torch_solve("gs", None, phi0, rho, periodic=True, max_iter=0,
                       tol=0.0)
    assert tpoisson.LAST_SWEEPS == 0
    np.testing.assert_array_equal(got, phi0)


@pytest.mark.parametrize("ny, nx", [(16, 24), (15, 21)])
def test_efield_neumann_matches_jax_bitwise(ny, nx):
    phi = np.random.default_rng(ny).standard_normal((ny, nx))
    got = tpoisson.efield_neumann(torch.as_tensor(phi))
    want = jpoisson.efield_neumann(jnp.asarray(phi))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("spec", [
    ("gs", None, 60, 0.0, False),
    ("gs", None, 5000, 1e-5, True),
    ("gs", 1.7, 5000, 1e-5, True),
    ("nps", None, 40, 0.0, True),
], ids=["gs-periodic", "gs-tol", "sor-tol", "nps-interior"])
def test_wrapper_matches_jax_kernel_interpret(spec):
    phi0, rho = _fields(16, 24, seed=3)
    want = np.asarray(jpoisson_iter.solve_iter_tpu(
        jnp.asarray(phi0), jnp.asarray(rho), spec=spec, interpret=True))
    before = poisson_iter.LAUNCHES
    got = poisson_iter.solve_iter(torch.as_tensor(phi0), torch.as_tensor(rho),
                                  spec=spec).numpy()
    assert poisson_iter.LAUNCHES == before == 0
    assert poisson_iter.LAST_SWEEPS == tpoisson.LAST_SWEEPS
    if spec[0] == "gs" and spec[1] is None:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-13 * np.abs(want).max())


def test_wrapper_refuses_non_cpu_tensors_and_unknown_kinds():
    """A tensor that is not on the CPU goes to the kernel or raises: here
    (meta tensors) the input check refuses it before any build."""
    phi = torch.empty((8, 8), device="meta", dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA"):
        poisson_iter.solve_iter(phi, phi, spec=("gs", None, 10, 0.0, False))
    cpu = torch.zeros((8, 8), dtype=torch.float64)
    with pytest.raises(ValueError, match="kind"):
        poisson_iter.solve_iter(cpu, cpu, spec=("nps", 1.5, 10, 0.0, False))
