"""lbm_tpu_torch's lid-driven cavity against lbm_tpu's, on the CPU.

  * the ops (feq/collide, macros_guarded, lid_deltas, stream_cavity, the lid
    ramp, the bf16 delta code) against lbm_tpu.ops.cavity / ops.stream, f64
    and f32, bit for bit (JAX run op by op);
  * the plain step against lbm_tpu.models.cavity's jnp step, 25 steps
    across the lid ramp at 48x32 and 33x33: f64 within 1e-12 relative, f32
    within a few ulp, bf16 storage within one bf16 ulp;
  * the three kernels' plain versions against the JAX kernels in interpret
    mode (the stored and lean kernels at 48x32 with band=16; multistep at
    32x32, K=4 from step 8, f64 and bf16); interpret mode compiles the
    kernel bodies, whose fused multiply-adds move last bits, so these hold
    at 1e-12 relative and 1e-12 of scale in f64 (the JAX package's own
    kernel tests: rtol 1e-12, atol 1e-14), and bf16 at one bf16 ulp a
    window plus the f32 noise of those fused multiply-adds;
  * mass conservation, the lid ramp, the rollout modes and the CLI.

Ghia at 129^2 x 10k is not run here: the JAX package's tests/test_cavity.py
holds the physics on the CPU, and chip_smoke.py phase 6 holds the port's
kernels to the same gate on the card.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu import config as jcfg
from lbm_tpu.kernels import fused_cavity as jfc
from lbm_tpu.models import cavity as jcav
from lbm_tpu.ops import cavity as jops
from lbm_tpu.ops import stream as jstream
from lbm_tpu_torch import config as tcfg
from lbm_tpu_torch import interop, run_cavity
from lbm_tpu_torch.kernels import fused_cavity as tfc
from lbm_tpu_torch.models import cavity as tcav
from lbm_tpu_torch.ops import cavity as tops
from lbm_tpu_torch.ops import stream as tstream

from torch_parity import (DTYPES, assert_close, assert_within_bf16_ulp,
                          bf16_ulp, np_of, op_by_op)

torch.set_num_threads(1)

Q = 9


def configs(dtype="float64", backend="plain", **fields):
    """(lbm_tpu CavityConfig, lbm_tpu_torch CavityConfig) with the same
    fields; "plain" maps to the JAX package's "jnp", "fused" to its
    interpret-mode kernels."""
    jdt, tdt = DTYPES[dtype]
    jax_kw = dict(fields, dtype=jdt, backend="jnp")
    if backend == "fused":
        jax_kw.update(backend="fused", kernel_interpret=True)
    return (jcfg.CavityConfig(**jax_kw),
            tcfg.CavityConfig(**fields, dtype=tdt, backend=backend))


def to_torch(state_j) -> tcav.CavityState:
    return interop.cavity_state_from_numpy(
        {k: np.asarray(v) for k, v in state_j._asdict().items()}, "cpu")


def assert_bitwise(got, want, name=""):
    g = interop.tensor_to_numpy(got) if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    w = np.asarray(want)
    assert g.dtype == w.dtype and g.shape == w.shape, name
    np.testing.assert_array_equal(g.view(np.uint8), w.view(np.uint8),
                                  err_msg=name)


def _random_inputs(dtype, NY=12, NX=10, seed=3):
    """f, rho, ux, uy from a numpy seed, with a dead column (f = 0) for the
    rho < 1e-10 guard."""
    rng = np.random.default_rng(seed)
    npdt = np.float64 if dtype == "float64" else np.float32
    f = rng.uniform(0.01, 0.5, (Q, NY, NX))
    f[:, :, 3] = 0.0
    fields = [rng.uniform(0.5, 1.5, (NY, NX)),
              rng.uniform(-0.1, 0.1, (NY, NX)),
              rng.uniform(-0.1, 0.1, (NY, NX))]
    return [a.astype(npdt) for a in (f, *fields)]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_ops_match_jax_bitwise(dtype):
    f, rho, ux, uy = _random_inputs(dtype)
    tdt = DTYPES[dtype][1]
    u_j = jcav._lid_speed(configs(dtype)[0], jnp.asarray(7, jnp.int32))
    u_t = tops.lid_speed(7, u_lid=0.1, sigma=10.0, dtype=tdt)
    jf, tf = jnp.asarray(f), torch.from_numpy(f)
    j_args = [jnp.asarray(a) for a in (rho, ux, uy)]
    t_args = [torch.from_numpy(a) for a in (rho, ux, uy)]

    @op_by_op
    def jax_side():
        post = jops.collide_dirs([jf[i] for i in range(Q)], *j_args, 0.887)
        streamed = jstream.stream_cavity(jnp.stack(post), u_j)
        d = jops.lid_deltas(j_args[0], u_j)
        return post, streamed, jops.macros_guarded([jf[i] for i in range(Q)]), d

    post_j, stream_j, mac_j, d_j = jax_side()
    post_t = tops.collide_dirs([tf[i] for i in range(Q)], *t_args, 0.887)
    stream_t = tstream.stream_cavity(torch.stack(post_t), u_t)
    mac_t = tops.macros_guarded([tf[i] for i in range(Q)])
    d_t = tops.lid_deltas(t_args[0], u_t)
    assert float(u_j) == u_t and u_t != 0.0
    for i in range(Q):
        assert_bitwise(post_t[i], post_j[i], f"collide {i}")
    assert_bitwise(stream_t, stream_j, "stream_cavity")
    for name, g, w in zip(("rho", "ux", "uy", "d5", "d6"),
                          (*mac_t, *d_t), (*mac_j, *d_j)):
        assert_bitwise(g, w, name)
    assert float(mac_t[0][0, 3]) == 0.0   # the guard fired on the dead column


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_lid_speed_matches_jax(dtype):
    cfg_j, cfg_t = configs(dtype, u_lid=0.07, sigma=6.0)
    for t in range(12):
        want = jcav._lid_speed(cfg_j, jnp.asarray(t, jnp.int32))
        got = tcav._lid_speed(cfg_t, t)
        assert np.asarray(want).item() == got, t


def test_bf16_delta_code_matches_jax():
    rng = np.random.default_rng(5)
    full = (np.asarray(jcav._w_bg(jnp.float32))
            + rng.normal(0, 1e-2, (Q, 6, 7)).astype(np.float32))
    cfg_j, cfg_t = configs("float32", storage="bf16")
    enc_j = jcav.encode_f(cfg_j, jnp.asarray(full))
    enc_t = tcav.encode_f(cfg_t, torch.from_numpy(full))
    assert_bitwise(enc_t, enc_j, "encode")
    assert_bitwise(tcav.decode_f(cfg_t, enc_t), jcav.decode_f(cfg_j, enc_j),
                   "decode")


@pytest.mark.parametrize("dtype, storage", [
    ("float64", "native"), ("float32", "native"), ("float32", "bf16")])
def test_init_state_matches_jax(dtype, storage):
    cfg_j, cfg_t = configs(dtype, NX=10, NY=7, storage=storage)
    want = jcav.init_state(cfg_j)
    got = tcav.init_state(cfg_t, "cpu")
    for k in ("f", "rho", "ux", "uy"):
        assert_bitwise(getattr(got, k), getattr(want, k), k)
    assert got.step == int(want.step) == 0


@pytest.mark.parametrize("storage", ["f64", "f32", "bf16"])
@pytest.mark.parametrize("nx, ny", [(48, 32), (33, 33)])
def test_plain_step_matches_jax(nx, ny, storage):
    """25 plain steps across the lid ramp (sigma = 10) against the JAX
    package's jnp step run op by op."""
    dtype = "float64" if storage == "f64" else "float32"
    cfg_j, cfg_t = configs(dtype, NX=nx, NY=ny,
                           storage="bf16" if storage == "bf16" else "native")
    sj = jcav.init_state(cfg_j)
    st = to_torch(sj)
    step_j = op_by_op(jcav.make_step(cfg_j))
    step_t = tcav.make_step(cfg_t)
    for _ in range(25):
        sj, st = step_j(sj), step_t(st)
    assert st.step == int(sj.step) == 25
    assert float(st.ux.abs().max()) > 1e-4   # the flow developed
    for k in ("f", "rho", "ux", "uy"):
        g, w = getattr(st, k), getattr(sj, k)
        if storage == "f64":
            assert_close(g, w, rtol=1e-12, atol_rel=1e-14, name=k)
        elif storage == "f32" or k != "f":
            # a few f32 ulp (the macros of bf16 storage are f32 too)
            assert_close(g, w, rtol=4 * 2.0 ** -23, atol_rel=4 * 2.0 ** -23,
                         name=k)
        else:
            assert g.dtype == torch.bfloat16
            assert_within_bf16_ulp(g, w, name=k)


def _jax_kernel_run(cfg_j, steps, kernel):
    s = jcav.init_state(cfg_j)
    for _ in range(steps):
        u = jcav._lid_speed(cfg_j, s.step)
        if kernel == "stored":
            f, rho, ux, uy = jfc.collide_stream_cavity(
                s.f, s.rho, s.ux, s.uy, u, tau=cfg_j.tau, interpret=True,
                band=16)
        else:
            f = jfc.collide_stream_cavity_lean(s.f, u, tau=cfg_j.tau,
                                               interpret=True, band=16)
            rho, ux, uy = jcav.macros_of(cfg_j, f)
        s = jcav.CavityState(f, rho, ux, uy, s.step + 1)
    return s


@pytest.mark.parametrize("kernel", ["stored", "lean"])
def test_kernel_plain_versions_match_jax_kernels(kernel):
    """12 steps at 48x32 in f64 across the lid ramp: the port's plain
    version of each single-step kernel against the JAX kernel (interpret
    mode, band=16, two bands)."""
    cfg_j, cfg_t = configs("float64", NX=48, NY=32)
    want = _jax_kernel_run(cfg_j, 12, kernel)
    st = tcav.init_state(cfg_t, "cpu")
    for _ in range(12):
        u = tcav._lid_speed(cfg_t, st.step)
        if kernel == "stored":
            f, rho, ux, uy = tfc.collide_stream_cavity_reference(
                st.f, st.rho, st.ux, st.uy, u, tau=cfg_t.tau)
        else:
            f = tfc.collide_stream_cavity_lean_reference(st.f, u,
                                                         tau=cfg_t.tau)
            rho, ux, uy = tcav.macros_of(cfg_t, f)
        st = tcav.CavityState(f, rho, ux, uy, st.step + 1)
    assert float(st.ux.abs().max()) > 1e-4
    for k in ("f", "rho", "ux", "uy"):
        # near-zero velocities differ by an ulp of the scale (1.7e-16 of
        # 0.015 measured), as in the JAX package's own kernel test
        assert_close(getattr(st, k), getattr(want, k), rtol=1e-12,
                     atol_rel=1e-12, name=k)


@pytest.mark.parametrize("storage", ["f64", "bf16"])
def test_multistep_plain_version_matches_jax_kernel(storage):
    """Two K=4 windows from step 8 at 32x32 (across the lid ramp at 10),
    from a seeded perturbation of the initial populations."""
    dtype = "float64" if storage == "f64" else "float32"
    cfg_j, cfg_t = configs(dtype, NX=32, NY=32)
    rng = np.random.default_rng(11)
    f0 = np.asarray(jcav.init_state(cfg_j).f, np.float64)
    f0 = f0 * (1.0 + 1e-3 * rng.standard_normal(f0.shape))
    if storage == "bf16":
        f0 = np.asarray(jcav.encode_f(
            dataclasses.replace(cfg_j, storage="bf16"),
            jnp.asarray(f0, jnp.float32)))
    else:
        f0 = f0.astype(np.float64)
    kw = dict(tau=cfg_t.tau, u_lid=cfg_t.u_lid, sigma=cfg_t.sigma)
    fj = jnp.asarray(f0)
    for t0 in (8, 12):
        # each window from the same input: a bf16 rounding that flips in
        # one window would be carried and grown by the next
        ft = tfc.collide_stream_cavity_multistep_reference(
            interop.tensor_from_numpy(np.asarray(fj), "cpu"), t0, k_steps=4,
            **kw)
        fj = jfc.collide_stream_cavity_multistep(fj, jnp.asarray(t0), k_steps=4,
                                                 interpret=True, **kw)
        if storage == "f64":
            assert_close(ft, fj, rtol=1e-12, atol_rel=1e-12, name=f"f {t0}")
            continue
        # one bf16 ulp of the stored delta, plus the f32 noise of the
        # compiled interpret kernel in the full populations (~0.45 at most):
        # its fused multiply-adds move them by up to 8 f32 ulp in 4 steps
        # (2.4e-7 measured on the same input in f32), which flips roundings
        # of deltas far smaller than the populations
        assert ft.dtype == torch.bfloat16
        g, w = np_of(ft), np_of(fj)
        allowed = (bf16_ulp(np.maximum(np.abs(g), np.abs(w)))
                   + 8 * 2.0 ** -23 * 0.5)
        assert (np.abs(g - w) <= allowed).all(), float(np.abs(g - w).max())


@pytest.mark.parametrize("mode", ["plain", "stored", "lean", "multistep"])
def test_mass_conservation_f64(mode):
    fields = {"plain": {}, "stored": {"backend": "fused"},
              "lean": {"backend": "fused", "lean_macros": True},
              "multistep": {"backend": "fused", "multistep": 8}}[mode]
    cfg = tcfg.CavityConfig(NX=32, NY=32, nsteps=100, dtype=torch.float64,
                            **fields)
    s = tcav.init_state(cfg, "cpu")
    m0 = float(s.f.sum())
    s = tcav.make_rollout(cfg)(s)
    assert s.step == 100
    assert abs(float(s.f.sum()) - m0) / m0 < 1e-12


def test_lid_ramp():
    """At rest after step 0 (lid speed 0); after step 1 the flow moves, in
    the lid row only (tests/test_cavity.py:41-51)."""
    cfg = tcfg.CavityConfig(NX=17, NY=17, nsteps=3, dtype=torch.float64)
    step = tcav.make_step(cfg)
    s1 = step(tcav.init_state(cfg, "cpu"))
    assert float(s1.ux.abs().max()) == 0.0
    s2 = step(s1)
    assert float(s2.ux.abs().max()) > 0.0
    assert float(s2.ux[:-1].abs().max()) == 0.0


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_rollout_modes_agree_bitwise(dtype):
    """On CPU tensors the fused modes run the kernels' plain versions: the
    lean rollout equals the lean step loop, and the multistep rollout
    (windows of 4 plus a remainder of 3) and its k=1 step equal both, bit
    for bit, in native storage."""
    tdt = DTYPES[dtype][1]
    base = tcfg.CavityConfig(NX=20, NY=14, nsteps=11, dtype=tdt,
                             backend="fused")
    lean = dataclasses.replace(base, lean_macros=True)
    ms = dataclasses.replace(base, multistep=4)
    runs = {"lean rollout": tcav.make_rollout(lean)(
        tcav.init_state(lean, "cpu")),
        "multistep rollout": tcav.make_rollout(ms)(tcav.init_state(ms, "cpu"))}
    for name, cfg in (("lean step", lean), ("multistep step", ms)):
        s, step = tcav.init_state(cfg, "cpu"), tcav.make_step(cfg)
        for _ in range(11):
            s = step(s)
        runs[name] = s
    want = runs.pop("lean rollout")
    for name, s in runs.items():
        assert s.step == want.step == 11, name
        for k in ("f", "rho", "ux", "uy"):
            assert torch.equal(getattr(s, k), getattr(want, k)), (name, k)


def test_launches_stay_zero_on_cpu():
    before = dict(tfc.LAUNCHES)
    cfg = tcfg.CavityConfig(NX=12, NY=9, nsteps=3, backend="fused")
    tcav.make_rollout(cfg)(tcav.init_state(cfg, "cpu"))
    assert tfc.LAUNCHES == before == dict.fromkeys(before, 0)


def test_non_cpu_tensors_never_take_the_plain_version():
    """A tensor that is not on the CPU goes to the kernel or raises: here
    (meta tensors) the input check refuses it before any build."""
    f = torch.empty((Q, 8, 8), device="meta")
    m = torch.empty((8, 8), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tfc.collide_stream_cavity(f, m, m, m, 0.0, tau=0.6)
    with pytest.raises(ValueError, match="CUDA"):
        tfc.collide_stream_cavity_lean(f, 0.0, tau=0.6)
    with pytest.raises(ValueError, match="CUDA"):
        tfc.collide_stream_cavity_multistep(f, 0, tau=0.6, k_steps=2,
                                            u_lid=0.1, sigma=10.0)


def test_interop_round_trip_is_bitwise():
    cfg = tcfg.CavityConfig(NX=10, NY=8, storage="bf16")
    state = tcav.make_step(cfg)(tcav.make_step(cfg)(
        tcav.init_state(cfg, "cpu")))
    arrays = interop.cavity_state_to_numpy(state)
    assert arrays["f"].dtype.name == "bfloat16"
    back = interop.cavity_state_from_numpy(arrays, "cpu")
    for k in ("f", "rho", "ux", "uy"):
        a, b = getattr(state, k), getattr(back, k)
        assert a.dtype == b.dtype, k
        assert_bitwise(b, interop.tensor_to_numpy(a), k)
    assert back.step == state.step == 2
    assert bool((state.f != 0).any())   # the bf16 deltas are not trivial


def test_cli_on_cpu(tmp_path):
    out = run_cavity.main(["--device", "cpu", "--nx", "17", "--steps", "5",
                           "--out", str(tmp_path)])
    assert out["steps"] == 5 and out["finite"] and out["backend"] == "plain"
    assert out["launches"] == dict.fromkeys(tfc.LAUNCHES, 0)
    assert out["ghia"] is None and out["mass_drift"] < 1e-5
    assert out["state"].step == 5
    u = np.loadtxt(tmp_path / "centerline_u.csv", delimiter=",")
    assert u.shape == (17, 2)
    with open(tmp_path / "simulation_time_details.csv") as fh:
        header, row = fh.read().splitlines()
    assert header.startswith("Grid_Dimension,Number_of_Steps")
    assert row.startswith("17x17,5,1,-1,-1,")
    # the JAX package's step gives the same profile
    cfg_j = jcfg.CavityConfig(NX=17, NY=17, dtype=jnp.float32)
    sj = jax.jit(jcav.make_rollout(cfg_j, 5))(jcav.init_state(cfg_j))
    (_, up_j), _ = jcav.centerline_profiles(sj, cfg_j.u_lid)
    np.testing.assert_allclose(u[:, 1], np_of(up_j), rtol=1e-5, atol=1e-7)


def test_cli_refuses_cuda_without_a_gpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_cavity.main(["--steps", "1", "--out", str(tmp_path)])
