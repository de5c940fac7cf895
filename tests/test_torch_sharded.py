"""lbm_tpu_torch.parallel on the CPU: the mesh factorisation, the step
builders' refusals and the auto picker against the JAX package's, and the
sharded steps and the --shard CLI on gloo process groups.

The ranks are processes of their own (tests/torch_dist_ranks.py, which
imports no JAX), joined through file:// stores under tmp_path: one 4-rank
spawn runs every mesh case, one 2-rank spawn holds ring_shift and the CLI.
The f64 runs are held against the JAX package's single-device jnp step run
op by op, at the JAX package's own sharded tolerances (f, g rtol 1e-11; E
rtol 1e-9, atol 1e-16; tests/test_fused_sharded.py:41-48): jitted, XLA's
fusion moves the port's single-device step's g by 1.4e-10 relative at one
neutral site, sharding aside. Against the port's own single-device plain
step they hold at 1e-12 of scale, and under NONE bit for bit.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from lbm_tpu.models import plasma as jplasma
from lbm_tpu.parallel import fused_sharded as jfused
from lbm_tpu.parallel import mesh as jmesh
from lbm_tpu_torch import run_plasma
from lbm_tpu_torch.config import BC, PlasmaConfig, PoissonSolver
from lbm_tpu_torch.models import plasma
from lbm_tpu_torch.parallel import fused_sharded, mesh

import torch_dist_ranks as ranks
from torch_parity import as_numpy, assert_close, configs, np_of, op_by_op

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    return ranks.spawn("steps", 4, tmp_path_factory.mktemp("steps"))


@pytest.fixture(scope="module")
def jax_steps():
    """The JAX package's single-device jnp state after ranks.STEPS steps,
    op by op, for each f64 case's (NY, NX, solver)."""
    out = {}
    for label, _, ny, nx, solver, dtype, _, _ in ranks.STEP_CASES:
        key = (ny, nx, solver)
        if dtype != torch.float64 or key in out:
            continue
        cfg, _ = configs(NX=nx, NY=ny, poisson=PoissonSolver[solver])
        step = op_by_op(jplasma.make_step(cfg))
        state = jplasma.init_state(cfg)
        for _ in range(ranks.STEPS):
            state = step(state)
        out[key] = as_numpy(state)
    return out


def _port_steps(cfg):
    state = plasma.init_state(cfg, "cpu")
    step = plasma.make_step(cfg)
    for _ in range(ranks.STEPS):
        state = step(state)
    return state


def test_factor_2d_matches_jax():
    for n in range(1, 17):
        assert mesh.factor_2d(n) == jmesh.factor_2d(n), n


@pytest.mark.parametrize("case", ranks.STEP_CASES, ids=lambda c: c[0])
def test_sharded_step_matches_single_device(mesh_runs, jax_steps, case):
    label, shape, ny, nx, solver, dtype, storage, delta = case
    got = mesh_runs[label]
    cfg = ranks.case_config(ny, nx, solver, dtype, storage, delta)
    port = _port_steps(cfg)
    for name in ("f", "g", "Ex", "Ey", "phi"):
        want = getattr(port, name)
        if solver == "NONE":
            assert torch.equal(got[name], want), f"{label} {name}"
        else:
            assert_close(got[name], want, rtol=1e-12, atol_rel=1e-12,
                         name=f"{label} {name} vs the port")
    if dtype != torch.float64:
        return
    ref = jax_steps[(ny, nx, solver)]
    for name, rtol, atol in (("f", 1e-11, 0.0), ("g", 1e-11, 0.0),
                             ("Ex", 1e-9, 1e-16), ("Ey", 1e-9, 1e-16)):
        np.testing.assert_allclose(np_of(got[name]), ref[name], rtol=rtol,
                                   atol=atol, err_msg=f"{label} {name}")


def _cfg(**kw):
    return dataclasses.replace(PlasmaConfig(), **kw)


class _Mesh:
    """A stand-in for a (dy, dx) DeviceMesh: the builders read its sizes
    before any exchange."""

    mesh_dim_names = (mesh.AXIS_Y, mesh.AXIS_X)

    def __init__(self, ny, nx):
        self._shape = (ny, nx)

    def size(self, dim):
        return self._shape[dim]


@pytest.mark.parametrize("make, cfg, shape, match", [
    # tests/test_fused_sharded.py:51-75
    (fused_sharded.make_fused_sharded_step, _cfg(NX=32, NY=64), (2, 2),
     "1-D"),
    (fused_sharded.make_fused_sharded_step, _cfg(NX=32, NY=40), (4, 1),
     "divisible"),
    (fused_sharded.make_fused_sharded_step,
     _cfg(NX=32, NY=64, bc=BC.BOUNCE_BACK), (4, 1), "periodic"),
    (fused_sharded.make_fused_sharded_step,
     _cfg(NX=32, NY=64, poisson=PoissonSolver.SOR), (4, 1), "FFT/NONE"),
    # tests/test_fused_sharded_2d.py:46-49
    (fused_sharded.make_fused_sharded_step_2d, _cfg(NX=40, NY=64), (2, 2),
     "divisible"),
    (fused_sharded.make_fused_sharded_step_2d,
     _cfg(NX=64, NY=64, poisson=PoissonSolver.GS), (2, 2), "FFT/NONE"),
    (fused_sharded.make_fused_sharded_step_2d,
     _cfg(NX=64, NY=64, bc=BC.BOUNCE_BACK), (2, 2), "periodic"),
], ids=["1d-2x2-mesh", "1d-NY40", "1d-bounceback", "1d-SOR", "2d-NX40",
        "2d-GS", "2d-bounceback"])
def test_step_builders_refuse_what_jax_refuses(make, cfg, shape, match):
    with pytest.raises(ValueError, match=match):
        make(cfg, _Mesh(*shape))


@pytest.mark.parametrize("cfg, n, want", [
    # tests/test_fused_sharded.py:320-360
    (_cfg(NX=32, NY=64), 4, (4, 1)),
    (_cfg(NX=16, NY=16), 4, (2, 2)),
    (_cfg(NX=64, NY=16), 8, (2, 4)),
    (_cfg(NX=16, NY=16, bc=BC.BOUNCE_BACK), 4, NotImplementedError),
    (_cfg(NX=64, NY=64, poisson=PoissonSolver.NPS), 4, NotImplementedError),
    (_cfg(NX=12, NY=12), 4, NotImplementedError),
    (_cfg(NX=17, NY=13), 4, ValueError),
    (_cfg(NX=32, NY=64), 1, ValueError),
], ids=["1d", "2d", "2x4", "bounceback-gspmd", "nps-gspmd",
        "no-8-multiple-gspmd", "indivisible", "one-rank"])
def test_pick_mesh_picks_what_jax_picks(cfg, n, want):
    if isinstance(want, tuple):
        assert fused_sharded.pick_mesh(cfg, n) == want
        # the JAX picker, on the virtual CPU devices (it builds, but does
        # not compile, its step)
        cfg_j, _ = configs(NX=cfg.NX, NY=cfg.NY)
        _, jax_mesh, _ = jfused.make_fused_sharded_step_auto(
            cfg_j, jax.devices()[:n])
        assert tuple(jax_mesh.devices.shape) == want
        return
    with pytest.raises(want, match="ROADMAP Queue 1 item 17"
                       if want is NotImplementedError else "devices"):
        fused_sharded.pick_mesh(cfg, n)


def test_shard_refusals_before_any_group(tmp_path):
    for argv in (["--shard", "2", "--multistep", "4"], ["--shard", "1"]):
        with pytest.raises(SystemExit):
            run_plasma.main(["--device", "cpu", *argv, "--out",
                             str(tmp_path)])


def test_ring_shift_and_cli_on_two_ranks(tmp_path):
    out = ranks.spawn("ring_cli", 2, tmp_path)
    # the peer ahead is the peer behind: each rank holds the other's
    for r, got in enumerate(out["received"]):
        other = 1 - r
        for step in (1, -1):
            assert got[step] == [[float(other)] * 3,
                                 [10.0 * other + i for i in range(4)],
                                 [[float(other)] * 2] * 2], (r, step)
    assert "2 ranks" in out["refused"] and "3" in out["refused"]
    assert out["mesh"] == {"dy": 2, "dx": 1}
    assert out["launches"]["collide_stream_halo"] == 0   # plain on the CPU
    single = run_plasma.main([
        "--device", "cpu", "--nx", "32", "--ny", "32", "--steps", "3",
        "--f64", "--poisson", "FFT", "--no-video", "--no-plots", "--out",
        str(tmp_path / "single")])
    for q, want in single["probes"].items():
        got = out["probes"][q]
        assert got.shape == want.shape == (3, 9), q
        scale = max(float(np.abs(want).max()), 1e-300)
        assert float(np.abs(got - want).max()) <= 1e-12 * scale, q
    assert_close(out["f"], single["state"].f, rtol=1e-12, atol_rel=1e-12,
                 name="f")
    with open(tmp_path / "cli" / "simulation_time_plasma_details.csv") as fh:
        rows = fh.read().splitlines()
    assert len(rows) == 2 and rows[1].split(",")[2] == "2", rows
