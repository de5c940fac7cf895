"""The lid-driven cavity sharded over gloo ranks on the CPU: the stored and
lean sharded steps, the lean rollout, the windowed rollout, their refusals
and the --shard CLI (lbm_tpu_torch.parallel.fused_sharded, run_cavity).

One 4-rank and one 2-rank spawn of tests/torch_dist_ranks.py (no JAX in the
children) run every case at the JAX package's shapes. Each gathered state
is held against the JAX package's single-device path at its own gates
(tests/test_fused_cavity.py): f64 f rtol 1e-11 / atol 1e-16, ux and uy
rtol 1e-11 / atol 1e-14 (:125-131); bf16 storage within one bf16 quantum
of the decoded populations' scale (:192-196); the windows within 1e-13 of
each field's scale (:473-497). And each is bit for bit the port's own
single-device rollout: the plain step for stored mode, the lean kernel's
plain version for lean mode, the window's for the windows.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu.config import CavityConfig as JCavityConfig
from lbm_tpu.models import cavity as jcavity
from lbm_tpu_torch import run_cavity
from lbm_tpu_torch.config import CavityConfig
from lbm_tpu_torch.models import cavity
from lbm_tpu_torch.parallel import fused_sharded, mesh

import torch_dist_ranks as ranks
from torch_parity import np_of

torch.set_num_threads(1)

FIELDS = ("f", "rho", "ux", "uy")


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    """The 4-rank and the 2-rank spawn, running at once while the JAX
    references are made."""
    procs = ranks.start_worlds("cavity", (4, 2), tmp_path_factory)
    yield procs
    for r in procs.values():
        r.close()


@pytest.fixture(scope="module")
def runs(started, jax_refs):
    """{world: rank 0's results} of the 4-rank and the 2-rank spawn, with
    the directory they wrote to under "out_dir"."""
    return {n: dict(r.result(), out_dir=r.tmp) for n, r in started.items()}


def _jax_run(cfg, steps, keep=()):
    """The JAX package's single-device state after `steps` steps of its
    jitted make_step (tests/test_fused_cavity.py:_run), and after each step
    count in `keep`."""
    s = jcavity.init_state(cfg)
    step = jax.jit(jcavity.make_step(cfg))
    out = {}
    for t in range(1, steps + 1):
        s = step(s)
        if t in keep:
            out[t] = s
    out[steps] = s
    return out


@pytest.fixture(scope="module")
def jax_refs(started):
    """The JAX references, each computed once: f64 64x48 after 30 steps,
    bf16 64x48 after 20 (jnp, and its lean kernel in interpret mode, as
    tests/test_fused_cavity.py:test_lean_sharded_bf16 holds it), f64 32x48
    after 16 and 23."""
    f64 = JCavityConfig(NX=48, NY=64, nsteps=0, dtype=jnp.float64)
    bf16 = JCavityConfig(NX=48, NY=64, nsteps=20, storage="bf16")
    lean = dataclasses.replace(bf16, backend="fused", kernel_interpret=True,
                               lean_macros=True)
    win = JCavityConfig(NX=48, NY=32, nsteps=0, dtype=jnp.float64)
    return {"f64": _jax_run(f64, 30)[30],
            "bf16_stored": _jax_run(bf16, 20)[20],
            "bf16_lean": jax.jit(jcavity.make_rollout(lean))(
                jcavity.init_state(lean)),
            "window": _jax_run(win, 23, keep=(16,)), "bf16_cfg": bf16}


def _port_single(label, n_world):
    """The port's single-device rollout of a CAVITY_CASES case: plain for
    stored mode, the lean kernel's and the window's plain versions (the
    fused backend on CPU tensors) for lean mode and the windows."""
    case = next(c for c in ranks.CAVITY_CASES[n_world] if c[0] == label)
    _, NY, NX, dtype, storage, path, steps, K = case
    cfg = ranks.cavity_config(NY, NX, dtype, storage, path, K)
    if path == "stored":
        cfg = dataclasses.replace(cfg, backend="plain")
    return cavity.make_rollout(cfg, steps)(cavity.init_state(cfg, "cpu"))


def _assert_bitwise(got, want, label):
    assert got.step == want.step, label
    for k in FIELDS:
        g, w = getattr(got, k), getattr(want, k)
        assert torch.equal(g, w), (
            f"{label} {k}: {int((g != w).sum())} of {g.numel()} differ")


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("path", ["stored", "lean"])
def test_sharded_f64_matches_jax_and_the_port(runs, jax_refs, path, world):
    """64x48 f64, 30 steps across the lid ramp (sigma = 10)."""
    label = f"f64_{path}"
    got = runs[world][label]
    _assert_bitwise(got, _port_single(label, world), label)
    ref = jax_refs["f64"]
    np.testing.assert_allclose(np_of(got.f), np.asarray(ref.f), rtol=1e-11,
                               atol=1e-16, err_msg="f")
    for k in ("ux", "uy"):
        np.testing.assert_allclose(np_of(getattr(got, k)),
                                   np.asarray(getattr(ref, k)), rtol=1e-11,
                                   atol=1e-14, err_msg=k)
    assert float(got.ux.abs().max()) > 1e-5   # developed flow


@pytest.mark.parametrize("path", ["stored", "lean"])
def test_sharded_bf16_within_one_quantum(runs, jax_refs, path):
    """64x48 bf16 storage on 4 ranks, 20 steps: the stored step against
    the JAX jnp path, the lean rollout against the JAX lean kernel's."""
    label = f"bf16_{path}"
    got = runs[4][label]
    _assert_bitwise(got, _port_single(label, 4), label)
    assert got.f.dtype == torch.bfloat16 and got.rho.dtype == torch.float32
    cfg = jax_refs["bf16_cfg"]
    ref = jax_refs[label]
    fr = np.asarray(jcavity.decode_f(cfg, ref.f))
    ff = np_of(cavity.decode(got.f))
    q = float(np.abs(fr.astype(np.float32)).max()) * 2 ** -7
    np.testing.assert_allclose(ff, fr, rtol=0, atol=max(q, 1e-6))


def test_lean_rollout_equals_per_step_marching(runs):
    """32x32 f32 on 2 ranks, 12 steps: the rollout carries f alone and
    computes the macros at the end; per-step marching computes them every
    step. One state (tests/test_fused_cavity.py:425-441)."""
    r = runs[2]
    _assert_bitwise(r["f32_lean_rollout"], r["f32_lean_marching"], "lean")
    assert r["f32_lean_rollout"].step == 12


@pytest.mark.parametrize("world, label, steps", [
    (2, "window_23_5", 23), (4, "window_16_8", 16)])
def test_sharded_windows_match_jax_and_the_port(runs, jax_refs, world, label,
                                                steps):
    """32x48 f64: 23 steps in windows of 5 (4 + a remainder of 3) on 2
    ranks, 16 in windows of 8 on 4, across the lid ramp."""
    got = runs[world][label]
    _assert_bitwise(got, _port_single(label, world), label)
    ref = jax_refs["window"][steps]
    assert float(got.ux.abs().max()) > 1e-4   # developed flow
    for k in FIELDS:
        a = np.asarray(getattr(ref, k), np.float64)
        b = np_of(getattr(got, k))
        scale = max(float(np.abs(a).max()), 1e-300)
        assert float(np.abs(a - b).max()) / scale < 1e-13, k


class _Mesh:
    """A stand-in for a (dy, dx) DeviceMesh: the step makers read its sizes
    before any exchange."""

    mesh_dim_names = (mesh.AXIS_Y, mesh.AXIS_X)

    def __init__(self, ny, nx):
        self._shape = (ny, nx)

    def size(self, dim):
        return self._shape[dim]


def _window_cfg(NY, K):
    return CavityConfig(NX=32, NY=NY, dtype=torch.float64, backend="fused",
                        multistep=K)


@pytest.mark.parametrize("make, cfg, shape, match", [
    (fused_sharded.make_fused_sharded_cavity_step,
     CavityConfig(NX=48, NY=64), (2, 2), "1-D"),
    # tests/test_fused_cavity.py:134-139: the Ghia 129^2 default
    (fused_sharded.make_fused_sharded_cavity_step, CavityConfig(), (2, 1),
     "divisible"),
    (fused_sharded.make_fused_sharded_cavity_rollout,
     CavityConfig(NX=48, NY=40, lean_macros=True, backend="fused"), (4, 1),
     "divisible"),
    # tests/test_fused_cavity.py:500-519
    (fused_sharded.make_fused_sharded_cavity_multistep_rollout,
     CavityConfig(NX=32, NY=32, dtype=torch.float64), (2, 1), "multistep"),
    (fused_sharded.make_fused_sharded_cavity_multistep_rollout,
     _window_cfg(33, 8), (2, 1), "divisible"),
    (fused_sharded.make_fused_sharded_cavity_multistep_rollout,
     _window_cfg(32, 24), (2, 1), "one-hop"),
    (fused_sharded.make_fused_sharded_cavity_multistep_rollout,
     _window_cfg(32, 8), (2, 2), "1-D"),
], ids=["step-2x2-mesh", "step-ghia-129", "rollout-NY40", "window-K0",
        "window-NY33", "window-K24", "window-2x2-mesh"])
def test_makers_refuse_what_jax_refuses(make, cfg, shape, match):
    args = (cfg, _Mesh(*shape))
    if make is not fused_sharded.make_fused_sharded_cavity_step:
        args += (8,)
    with pytest.raises(ValueError, match=match):
        make(*args)


def _single_cli(tmp_path, label, flags):
    return run_cavity.main([*ranks.CAVITY_CLI_ARGS, "--out",
                            str(tmp_path / label), *flags])


@pytest.mark.parametrize("label, flags", ranks.CAVITY_CLI,
                         ids=[c[0] for c in ranks.CAVITY_CLI])
def test_cli_shard_on_two_ranks(runs, tmp_path, label, flags):
    """`--shard 2 --device cpu` (the halo kernels' plain versions, and with
    --multistep 4 the gated window's) against the single-device CLI on
    --device cpu (the plain backend), 32^2 f64, 30 steps: the stored run
    writes the same centerline CSVs, the windowed run (lean semantics) the
    same within 1e-12 of the profiles' scale; rank 0 alone wrote them."""
    r = runs[2]
    assert "2 ranks" in r["refused"] and "3" in r["refused"]
    got = r["cli_" + label]
    assert got["n_devices"] == 2 and got["finite"]
    assert set(got["launches"].values()) == {0}   # plain on the CPU
    single = _single_cli(tmp_path, "single", [])
    cli_dir = r["out_dir"] / f"cli_{label}"
    for name in ("centerline_u.csv", "centerline_v.csv"):
        want = np.loadtxt(tmp_path / "single" / name, delimiter=",")
        have = np.loadtxt(cli_dir / name, delimiter=",")
        if label == "stored":
            np.testing.assert_array_equal(have, want, err_msg=name)
        else:
            scale = float(np.abs(want[:, 1]).max())
            np.testing.assert_allclose(have, want, rtol=0,
                                       atol=1e-12 * scale, err_msg=name)
    if label == "stored":
        _assert_bitwise(got["state"], single["state"], "CLI")
    assert got["mass_drift"] < 1e-12
    with open(cli_dir / "simulation_time_details.csv") as fh:
        rows = fh.read().splitlines()
    assert len(rows) == 2 and rows[1].split(",")[2] == "2", rows


def test_shard_refusals_before_any_group(tmp_path):
    """--shard without a world of that size, and --device cuda without a
    GPU, raise before a process group starts."""
    with pytest.raises(SystemExit, match="torchrun"):
        run_cavity.main(["--device", "cpu", "--shard", "2", "--out",
                         str(tmp_path)])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run_cavity.main(["--shard", "1", "--out", str(tmp_path)])
    assert not torch.distributed.is_initialized()
