"""The 2-D plasma's sharded windows on the CPU: the gated wall fixup
(ops/stream.stream_bounceback_gated), the gated window's plain version
(kernels/fused_multistep.collide_stream_multistep_gated_reference), the
window rollouts on y-shards and tiles over gloo ranks
(parallel/fused_sharded.make_fused_sharded_multistep_rollout, _2d), their
refusals and --shard N --multistep K on the plasma CLI.

  * the fixup bit for bit against JAX's bounceback_fix_dirs_gated on bands
    that hold both walls, one, none and both on one row; at the walls
    (0, NY-1) bit for bit the port's whole-grid bounce-back;
  * the plain gated window against JAX's collide_stream_multistep_gated in
    interpret mode, one K = 3 window on each of two bands of a seeded warm
    16x12 f64 state, at 1e-12 of scale (the interpret kernel compiles its
    body, whose fused multiply-adds move last bits);
  * one 4-rank and one 2-rank spawn of tests/torch_dist_ranks.py's
    "windows" scenario (K = 8, the JAX package's 64x24 and 32x16 grids):
    every f64 case within 1e-13 of each field's scale of the JAX package's
    single-device jnp rollout (its own gate, tests/test_fused_multistep.py:
    269-297, 559-620), and every case bit for bit the port's single-device
    window rollout, bf16 storage included;
  * the CLI with --shard 2 --multistep 4 on two ranks against the
    single-device --multistep 4 CLI.
Each JAX reference is one march of the JAX step jitted at O0 (within
~1e-15 of scale of the step run op by op, which the port matches bit for
bit; the default jit's fused multiply-adds move last bits), shared by the
cases that need its state.
"""
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu.kernels import fused_multistep as jfm
from lbm_tpu.models import plasma as jplasma
from lbm_tpu.ops import stream as jstream
from lbm_tpu_torch import run_plasma
from lbm_tpu_torch.config import BC, PlasmaConfig, PoissonSolver
from lbm_tpu_torch.constants import D2Q9
from lbm_tpu_torch.kernels import fused_multistep as tfm
from lbm_tpu_torch.models import plasma
from lbm_tpu_torch.ops import stream
from lbm_tpu_torch.parallel import fused_sharded, mesh

import torch_dist_ranks as ranks
from torch_parity import configs, jit_o0, np_of, perturb, to_torch

torch.set_num_threads(1)

FIELDS = ("f", "g", "Ex", "Ey", "phi")


# ---------------------------------------------------------------------------
# the fixup and the window's plain version against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("NY, NX", [(8, 8), (9, 11), (14, 6)])
def test_gated_fixup_matches_jax_bitwise(NY, NX):
    rng = np.random.default_rng(NY * 100 + NX)
    for b, t in [(0, NY - 1), (3, NY - 4), (2, -1), (-1, NY - 3), (-1, -1),
                 (4, 4)]:
        fd = rng.standard_normal((9, NY, NX))
        st = rng.standard_normal((9, NY, NX))
        out = [jnp.roll(jnp.asarray(fd[q]), (int(D2Q9.CY[q]),
                                             int(D2Q9.CX[q])), (0, 1))
               for q in range(9)]
        iy = np.broadcast_to(np.arange(NY)[:, None], (NY, NX))
        want = jstream.bounceback_fix_dirs_gated(
            out, [jnp.asarray(a) for a in fd],
            {i: jnp.asarray(st[i]) for i in (5, 6, 7, 8)},
            jnp.asarray(iy == b), jnp.asarray(iy == t))
        got = stream.stream_bounceback_gated(
            torch.from_numpy(fd), torch.from_numpy(st), b, t)
        np.testing.assert_array_equal(got.numpy(),
                                      np.stack([np.asarray(w) for w in want]),
                                      err_msg=f"walls {(b, t)}")
    f = torch.from_numpy(rng.standard_normal((3, 9, NY, NX)))
    stale = torch.from_numpy(rng.standard_normal((3, 9, NY, NX)))
    assert torch.equal(stream.stream_bounceback_gated(f, stale, 0, NY - 1),
                       stream.stream_bounceback(f, stale))


@functools.lru_cache(maxsize=None)
def _warm_band_state():
    """A seeded perturbation of a 16x12 f64 bounce-back state two plain
    steps in (numpy arrays)."""
    _, ct = configs("float64", NX=12, NY=16, bc=BC.BOUNCE_BACK,
                    poisson=PoissonSolver.NONE)
    warm = plasma.make_rollout(ct, 2)(plasma.init_state(ct, "cpu"))
    return ct, perturb({k: v.numpy() if isinstance(v, torch.Tensor) else v
                        for k, v in warm._asdict().items()}, seed=16)


@pytest.mark.parametrize("rows, delta, kill", [
    (slice(0, 8), False, True), (slice(8, 16), True, False)],
    ids=["bottom-kill", "top-delta-keep"])
def test_gated_plain_window_matches_jax_interpret(rows, delta, kill):
    """One K = 3 window on the band of rows extended by 3 a side (the
    bottom wall at its row 3, or the top wall at its row 10)."""
    ct, arrays = _warm_band_state()
    u = ct.units()
    kw = dict(taus=ct.taus, q_e=u.q_e, q_i=u.q_i, m_e=u.m_e, m_i=u.m_i,
              cs2=u.cs2, kb=u.kb, neutral_ref=u.rho_n_init if delta else 0.0,
              k_steps=3, kill_field=kill)
    ts = to_torch(arrays)
    band, walls = tfm.window_inputs((ts.f, ts.g, ts.Ex, ts.Ey), rows, 3)
    assert walls == ((3, -1) if rows.start == 0 else (-1, 10))
    got = tfm.collide_stream_multistep_gated(*band, walls, **kw)
    want = jfm.collide_stream_multistep_gated(
        *(jnp.asarray(t.numpy()) for t in band), jnp.asarray(walls),
        interpret=True, **kw)
    for name, g, w in zip(("f", "g"), got, want):
        w = np.asarray(w)
        err = float(np.abs(np_of(g) - w).max() / np.abs(w).max())
        assert err < 1e-12, (name, err)


def _phys():
    cfg = PlasmaConfig()
    u = cfg.units()
    return dict(taus=cfg.taus, q_e=u.q_e, q_i=u.q_i, m_e=u.m_e, m_i=u.m_i,
                cs2=u.cs2, kb=u.kb)


@pytest.mark.parametrize("bad, match", [
    (dict(k_steps=0), "k_steps"), (dict(wall_rows=(8, 3)), "wall_rows"),
    (dict(wall_rows=(-2, 3)), "wall_rows")], ids=["k0", "row8", "row-2"])
def test_gated_wrapper_refuses(bad, match):
    f = torch.zeros((3, 9, 8, 8), dtype=torch.float64)
    e = torch.zeros((8, 8), dtype=torch.float64)
    kw = {"k_steps": 2, "wall_rows": (0, 7), **_phys(), **bad}
    with pytest.raises(ValueError, match=match):
        tfm.collide_stream_multistep_gated(f, f, e, e, kw.pop("wall_rows"),
                                           **kw)


def test_gated_wrapper_never_takes_the_plain_version_off_the_cpu():
    """A tensor that is not on the CPU goes to the kernel or raises: here
    (meta tensors) the input check refuses it before any build."""
    f = torch.empty((3, 9, 8, 8), device="meta", dtype=torch.float64)
    e = torch.empty((8, 8), device="meta", dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA"):
        tfm.collide_stream_multistep_gated(f, f, e, e, (0, 7), k_steps=2,
                                           **_phys())
    assert tfm.GATED_LAUNCHES == 0


# ---------------------------------------------------------------------------
# the rollouts on gloo ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{world: rank 0's results} of the 4-rank and the 2-rank spawn, with
    the directory they wrote to under "out_dir". Both run at once, and the
    f64 cases' JAX marches are made meanwhile."""
    started = ranks.start_worlds("windows", (4, 2), tmp_path_factory)
    try:
        for _, (_, _, NY, NX, solver, bc, dtype, _, delta, kill,
                _) in _cases():
            if dtype == torch.float64:
                _jax_states(NY, NX, solver, bc, delta, kill)
        yield {n: dict(r.result(), out_dir=r.tmp)
               for n, r in started.items()}
    finally:
        for r in started.values():
            r.close()


def _cases():
    return [(n, c) for n in (4, 2) for c in ranks.WINDOW_CASES[n]]


def _jax_cfg(NY, NX, solver, bc, delta, kill):
    cj, _ = configs("float64", NX=NX, NY=NY, poisson=PoissonSolver[solver],
                    bc=BC.PERIODIC if bc == "periodic" else BC.BOUNCE_BACK,
                    neutral_delta=delta)
    return dataclasses.replace(cj, compat=dataclasses.replace(
        cj.compat, none_solver_kills_external_field=kill))


@functools.lru_cache(maxsize=None)
def _jax_states(NY, NX, solver, bc, delta, kill):
    """The JAX package's single-device jnp states after 16 and 19 steps of
    its step, jitted at O0 (torch_parity.jit_o0: within 5e-16 of scale of
    the step run op by op here; the default jit's fused multiply-adds move
    the f64 neutral's g by ~4e-13 of g's scale in 19 steps)."""
    cj = _jax_cfg(NY, NX, solver, bc, delta, kill)
    step = jit_o0(jplasma.make_step(cj))
    state, out = jplasma.init_state(cj), {}
    for t in range(1, 20):
        state = step(state)
        if t in (16, 19):
            out[t] = {k: np.asarray(getattr(state, k)) for k in FIELDS}
    return out


def _port_single(case):
    """The port's single-device window rollout (the window kernel's plain
    version on CPU tensors) of a WINDOW_CASES case."""
    _, _, *grid, steps = case
    cfg = ranks.window_config(*grid)
    return plasma.make_rollout(cfg, steps)(plasma.init_state(cfg, "cpu"))


@pytest.mark.parametrize("world, case", _cases(),
                         ids=[f"{n}-{c[0]}" for n, c in _cases()])
def test_windows_match_jax_and_the_port(runs, world, case):
    label, shape, NY, NX, solver, bc, dtype, storage, delta, kill, steps = \
        case
    got = runs[world][label]
    assert got.step == steps
    want = _port_single(case)
    for k in FIELDS:
        assert torch.equal(getattr(got, k), getattr(want, k)), (
            f"{label} {k}: not bitwise the single-device window rollout")
    assert float((got.f.double() - plasma.init_state(
        ranks.window_config(NY, NX, solver, bc, dtype, storage, delta, kill),
        "cpu").f.double()).abs().max()) > 0
    if solver == "FFT":
        assert float(got.Ex.abs().max()) > 0   # the no-op solve keeps E
    if dtype != torch.float64:
        return
    ref = _jax_states(NY, NX, solver, bc, delta, kill)[steps]
    for k in ("f", "g", "Ex", "Ey"):
        a, b = ref[k].astype(np.float64), np_of(getattr(got, k))
        scale = max(float(np.abs(a).max()), 1e-300)
        assert float(np.abs(a - b).max()) / scale < 1e-13, (label, k)


class _Mesh:
    """A stand-in for a (dy, dx) DeviceMesh: the builders read its sizes
    before any exchange."""

    mesh_dim_names = (mesh.AXIS_Y, mesh.AXIS_X)

    def __init__(self, ny, nx):
        self._shape = (ny, nx)

    def size(self, dim):
        return self._shape[dim]


def _cfg(**kw):
    return dataclasses.replace(PlasmaConfig(
        NX=24, NY=64, multistep=8, backend="fused",
        poisson=PoissonSolver.NONE), **kw)


ROLL_1D = fused_sharded.make_fused_sharded_multistep_rollout
ROLL_2D = fused_sharded.make_fused_sharded_multistep_rollout_2d


@pytest.mark.parametrize("make, cfg, shape, match", [
    (ROLL_1D, _cfg(), (2, 2), "1-D \\(dy\\) only"),
    (ROLL_1D, _cfg(multistep=40), (2, 1), "one-hop"),
    (ROLL_1D, _cfg(NY=66), (4, 1), "divisible"),
    (ROLL_1D, _cfg(poisson=PoissonSolver.SOR), (2, 1), "window-constant E"),
    (ROLL_1D, _cfg(poisson=PoissonSolver.GS, bc=BC.BOUNCE_BACK), (2, 1),
     "window-constant E"),
    (ROLL_1D, _cfg(poisson=PoissonSolver.NPS), (2, 1), "window-constant E"),
    (ROLL_1D, _cfg(poisson=PoissonSolver.FFT), (2, 1), "window-constant E"),
    (ROLL_1D, _cfg(multistep=0), (2, 1), "multistep"),
    (ROLL_2D, _cfg(bc=BC.BOUNCE_BACK), (2, 2), "NONE \\+ periodic only"),
    (ROLL_2D, _cfg(poisson=PoissonSolver.FFT), (2, 2),
     "NONE \\+ periodic only"),
    (ROLL_2D, _cfg(NX=25), (2, 2), "divisible"),
    (ROLL_2D, _cfg(NX=16), (2, 4), "cols/shard"),
], ids=["1d-2x2-mesh", "1d-K-beyond-rows", "1d-NY66", "1d-SOR", "1d-GS-bb",
        "1d-NPS", "1d-FFT-periodic", "1d-K0", "2d-bounceback", "2d-FFT",
        "2d-NX25", "2d-K-beyond-cols"])
def test_window_builders_refuse_what_jax_refuses(make, cfg, shape, match):
    with pytest.raises(ValueError, match=match):
        make(cfg, _Mesh(*shape), 19)


def test_cli_shard_multistep_on_two_ranks(runs, tmp_path):
    """`--shard 2 --multistep 4 --device cpu` at 32^2 f64, NONE +
    bounce-back, 10 steps (windows 4, 4, 2) against the single-device
    --multistep 4 CLI: the probes within 1e-12 of each series' scale, the
    mesh line printed, no kernel launch on the CPU, rank 0 alone wrote the
    CSVs; and a K deeper than a shard is refused."""
    r = runs[2]
    assert "one-hop" in r["refused"] and "--multistep" in r["refused"]
    got = r["cli"]
    assert "sharded multistep over mesh {'dy': 2, 'dx': 1}" in got["printed"]
    assert got["mesh"] == {"dy": 2, "dx": 1} and got["n_devices"] == 2
    assert got["finite"] and got["state"].step == 10
    assert set(got["launches"].values()) == {0}
    assert "collide_stream_multistep_gated" in got["launches"]
    single = run_plasma.main([*ranks.WINDOW_CLI, "--out",
                              str(tmp_path / "single")])
    for q, want in single["probes"].items():
        have = got["probes"][q]
        assert have.shape == want.shape == (3, 9), q
        scale = max(float(np.abs(want).max()), 1e-300)
        assert float(np.abs(have - want).max()) <= 1e-12 * scale, q
    with open(r["out_dir"] / "cli" / "simulation_time_plasma_details.csv"
              ) as fh:
        rows = fh.read().splitlines()
    assert len(rows) == 2 and rows[1].split(",")[2] == "2", rows
