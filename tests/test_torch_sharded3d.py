"""The 3-D column's multi-device path on the CPU: the z-, y- and (dz, dy)
steps, the auto picker and the K-slice windows on gloo process groups, the
picker against the JAX package's, the builders' refusals, and --shard on
the 3-D CLI.

The ranks are processes of their own (tests/torch_dist_ranks.py's "column"
scenario, which imports no JAX), joined through file:// stores under
tmp_path: one 4-rank spawn and one 2-rank spawn, the CLI on the two. Each
case starts from a seeded perturbed column and is held against the port's
single-device plain step (itself held against the JAX package by
tests/test_torch_plasma3d.py): bit for bit under NONE, and under FFT within
the JAX package's sharded tolerances of the scale (1e-11; 1e-12 on the
degenerate (1, 2) and (2, 1) meshes: tests/test_fused_sharded.py:99-190),
because the sharded spectral solves transform in another order than
rfftn.
"""
import dataclasses

import jax
import pytest
import torch

from lbm_tpu.parallel import fused_sharded as jfused
from lbm_tpu_torch import run_plasma3d
from lbm_tpu_torch.config import PlasmaConfig, PoissonSolver
from lbm_tpu_torch.models import plasma3d
from lbm_tpu_torch.parallel import fused_sharded, mesh

import torch_dist_ranks as ranks
from torch_parity import assert_close, configs

torch.set_num_threads(1)

FIELDS = ("f", "g", "Ex", "Ey", "Ez", "phi")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Rank 0's results of the 4-rank and the 2-rank spawn (run at once)."""
    started = ranks.start_worlds("column", (4, 2), tmp_path_factory)
    try:
        yield {n: {**r.result(), "dir": r.tmp} for n, r in started.items()}
    finally:
        for r in started.values():
            r.close()


def _single(cfg, label, steps):
    state = ranks.seeded_state3d(cfg, label)
    step = plasma3d.make_step(dataclasses.replace(cfg, backend="plain",
                                                  multistep=0))
    for _ in range(steps):
        state = step(state)
    return state


def _hold(got, want, exact, atol_rel, what):
    for name in FIELDS:
        g, w = getattr(got, name), getattr(want, name)
        if exact:
            assert torch.equal(g, w), (
                f"{what} {name}: {int((g != w).sum())} elements differ")
        else:
            assert_close(g, w, rtol=0, atol_rel=atol_rel,
                         name=f"{what} {name}")
    assert got.step == want.step, what


CASES = [(n, c) for n in (4, 2) for c in ranks.STEP3D_CASES[n]]


@pytest.mark.parametrize("n, case", CASES, ids=[c[0] for _, c in CASES])
def test_sharded_step_matches_single_device(runs, n, case):
    label, kind, shape, *grid = case
    solver = grid[3]
    cfg = ranks.config3d(*grid)
    want = _single(cfg, label, ranks.STEPS3D)
    degenerate = shape is not None and 1 in shape and kind == "yz"
    _hold(runs[n][label], want, solver == "NONE",
          1e-12 if degenerate else 1e-11, label)
    if kind == "auto":
        assert runs[n][label + "_mesh"] == fused_sharded.pick_mesh3d(cfg, n)


WINDOWS = [(n, c) for n in (4, 2) for c in ranks.WINDOW3D_CASES[n]]


@pytest.mark.parametrize("n, case", WINDOWS,
                         ids=[f"{n}ranks_{c[0]}" for n, c in WINDOWS])
def test_windows_match_single_device_bitwise(runs, n, case):
    """K-slice windows (with a remainder window) on an (n, 1) mesh equal
    the single-device NONE step bit for bit, either kill setting."""
    label, NZ, K, steps, kill = case
    cfg = ranks.config3d(NZ, 8, 8, "NONE", torch.float64, "native", False,
                         K, kill)
    _hold(runs[n]["window_" + label], _single(cfg, label, steps), True, 0,
          label)


# the single-device CLI runs that CLI3D's sharded runs are held against
SINGLE_CLI = {"fft": ["--steps", "3", "--f64", "--slice-every", "0"],
              "window": ["--steps", "5", "--poisson", "NONE",
                         "--slice-every", "0"]}


def test_cli_on_two_ranks(runs, tmp_path):
    """--shard 2 (FFT, the auto mesh) and --shard 2 --multistep 2 --poisson
    NONE: rank 0 writes the timing CSV and the slices, and the gathered
    state matches the single-device CLI's; a world of 2 refuses --shard 3,
    and K = 5 on 4-slice shards."""
    out = runs[2]
    assert "2 ranks" in out["refused", "3"]
    assert "one-hop" in out["refused", "2"]
    for (label, _), slice_file in zip(ranks.CLI3D, ("slice_00003.npz",
                                                    "slice_00004.npz")):
        got = out["cli3d_" + label]
        assert got["n_devices"] == 2 and got["finite"], label
        assert got["mesh"] == {"dz": 2, "dy": 1}, label
        assert all(v == 0 for v in got["launches"].values())  # CPU: plain
        single = run_plasma3d.main([*ranks.CLI3D_ARGS, *SINGLE_CLI[label],
                                    "--out", str(tmp_path / label)])
        _hold(got["state"], single["state"], label == "window", 1e-11,
              label)
        d = out["dir"] / f"cli3d_{label}"
        assert [p.name for p in d.glob("slice_*.npz")] == [slice_file]
        rows = (d / "simulation_time_3d.csv").read_text().splitlines()
        assert len(rows) == 2 and rows[1].split(",")[2] == "2", rows


class _Mesh:
    """A stand-in for a DeviceMesh: the builders read its names and sizes
    before any exchange."""

    def __init__(self, shape, names=(mesh.AXIS_Z, mesh.AXIS_Y)):
        self.mesh_dim_names = names
        self._shape = shape

    def size(self, dim):
        return self._shape[dim]


def _cfg(**kw):
    return dataclasses.replace(PlasmaConfig(NX=16, NY=16, NZ=8), **kw)


@pytest.mark.parametrize("make, cfg, shape, match", [
    # lbm_tpu/parallel/fused_sharded.py:225-235, 334-347, 452-470
    (fused_sharded.make_fused_sharded_step3d, _cfg(), (2, 2), "1-D \\(dz\\)"),
    (fused_sharded.make_fused_sharded_step3d, _cfg(NZ=6), (4, 1),
     "NZ=6 must be divisible by 4"),
    (fused_sharded.make_fused_sharded_step3d,
     _cfg(poisson=PoissonSolver.SOR), (2, 1), "FFT/NONE"),
    (fused_sharded.make_fused_sharded_step3d_y, _cfg(), (2, 2),
     "1-D \\(dy\\)"),
    (fused_sharded.make_fused_sharded_step3d_y, _cfg(NY=33), (1, 2),
     "NY=33 must be divisible by 2"),
    (fused_sharded.make_fused_sharded_step3d_y, _cfg(NY=30), (1, 2),
     "no feasible 3-D panel height"),
    (fused_sharded.make_fused_sharded_step3d_yz, _cfg(NZ=5), (2, 2),
     "divisible by dz=2"),
    (fused_sharded.make_fused_sharded_step3d_yz, _cfg(NY=33, NZ=4), (2, 2),
     "divisible by dy=2"),
    (fused_sharded.make_fused_sharded_step3d_yz, _cfg(NY=30, NZ=4), (2, 2),
     "feasible"),
], ids=["z-2x2-mesh", "z-NZ6", "z-SOR", "y-2x2-mesh", "y-NY33", "y-NY30",
        "yz-NZ5", "yz-NY33", "yz-NY30"])
def test_step_builders_refuse_what_jax_refuses(make, cfg, shape, match):
    with pytest.raises(ValueError, match=match):
        make(cfg, _Mesh(shape))


def test_builders_need_their_axes():
    with pytest.raises(ValueError, match="must have a 'dz' axis"):
        fused_sharded.make_fused_sharded_step3d(
            _cfg(), _Mesh((2, 1), (mesh.AXIS_Y, mesh.AXIS_X)))
    with pytest.raises(ValueError, match="must have a 'dz' axis"):
        fused_sharded.make_fused_sharded_step3d_yz(
            _cfg(), _Mesh((2, 1), (mesh.AXIS_Y, mesh.AXIS_X)))


def test_window_builder_refuses_what_jax_refuses():
    """lbm_tpu/parallel/fused_sharded.py:1152-1171 (tests/
    test_fused_sharded.py:223-243 and the 1-D mesh rule)."""
    base = dict(backend="fused", poisson=PoissonSolver.NONE)
    make = fused_sharded.make_fused_sharded_multistep_rollout_3d
    with pytest.raises(ValueError, match="multistep"):
        make(_cfg(**base), _Mesh((4, 1)), 4)
    with pytest.raises(ValueError, match="NONE"):
        # refused by the configuration already, as in the JAX package
        make(_cfg(**{**base, "poisson": PoissonSolver.FFT}, multistep=2),
             _Mesh((4, 1)), 4)
    with pytest.raises(ValueError, match="one-hop"):
        make(_cfg(**base, multistep=4), _Mesh((4, 1)), 4)
    with pytest.raises(ValueError, match="1-D \\(dz\\)"):
        make(_cfg(**base, multistep=2), _Mesh((2, 2)), 4)
    with pytest.raises(ValueError, match="NZ=8 must be divisible by 3"):
        make(_cfg(**base, multistep=2), _Mesh((3, 1)), 4)


# (n, NZ, NY, NX): cross-sections where the JAX picker's VMEM budgets do
# not bind, so the picks must agree (tests/test_fused_sharded.py:265-317)
PICKS = [(8, 16, 8, 16), (4, 16, 16, 16), (4, 4, 32, 16), (4, 4, 16, 16),
         (8, 2, 64, 16), (8, 12, 32, 16), (8, 4, 32, 16), (2, 8, 8, 8),
         (8, 4, 16, 16), (8, 7, 7, 16), (1, 8, 8, 8)]


@pytest.mark.parametrize("pick", PICKS, ids=lambda p: "x".join(map(str, p)))
def test_pick_mesh3d_picks_what_jax_picks(pick):
    """The JAX picker on the virtual CPU devices builds, and does not
    trace, its step; its 1-D meshes are (n, 1) (dz) or (1, n) (dy) here."""
    n, NZ, NY, NX = pick
    cfg_j, cfg = configs(NX=NX, NY=NY, NZ=NZ)
    try:
        _, jmesh, _ = jfused.make_fused_sharded_step3d_auto(
            cfg_j, jax.devices()[:n])
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            fused_sharded.pick_mesh3d(cfg, n)
        assert str(got.value).split(":")[0] == str(e).split(":")[0]
        return
    shape = dict(jmesh.shape)
    assert fused_sharded.pick_mesh3d(cfg, n) == (
        shape.get(mesh.AXIS_Z, 1), shape.get(mesh.AXIS_Y, 1))


@pytest.mark.parametrize("flags, message", [
    (["--multistep", "2"], "multi-chip only in 3-D: add --shard N"),
    (["--shard", "2", "--multistep", "2"], "needs --poisson NONE"),
    (["--shard", "2"], "torchrun --nproc-per-node 2"),
    (["--shard", "1"], "auto 3-D sharding needs >= 2 devices")])
def test_cli_shard_refusals_before_any_group(flags, message, tmp_path):
    with pytest.raises(SystemExit) as e:
        run_plasma3d.main(["--device", "cpu", "--n", "8", "--nz", "4",
                           "--steps", "1", "--out", str(tmp_path), *flags])
    assert message in str(e.value)
