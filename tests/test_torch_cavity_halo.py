"""The cavity's y-shard kernels of kernels/fused_cavity on the CPU:
collide_stream_cavity_halo (stored macros), _halo_lean and
collide_stream_cavity_multistep_gated (the window on a shard extended by
ghost rows).

Their plain versions are held against the JAX package's Pallas kernels in
interpret mode, f64, at rtol 1e-12 / atol 1e-15 of the populations' scale
(interpret mode compiles the kernel bodies, whose fused multiply-adds move
last bits of f; the macros are sums of f, and their atol is f's too): one
compile a kernel, for a shard holding the bottom wall, an interior shard
and the lid's shard, with JAX's 8-row strips. Without JAX, every shard of a
cut of a full grid (2 and 4 shards, and a ragged 3 x 43 of 129 rows), in
f64, f32 and bf16 storage, is bit for bit what the single-device plain
versions give on the full grid at its rows. The CUDA kernels run only on a
GPU; chip_smoke.py phase 11a holds them there against both.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu.kernels import fused_cavity as jfc
from lbm_tpu_torch import interop
from lbm_tpu_torch.config import CavityConfig
from lbm_tpu_torch.kernels import fused_cavity as fc
from lbm_tpu_torch.models import cavity

from torch_parity import assert_close

torch.set_num_threads(1)

MODES = [("f64", torch.float64, "native"), ("f32", torch.float32, "native"),
         ("bf16", torch.float32, "bf16")]
WHERE = {"bottom": slice(0, 16), "interior": slice(16, 32),
         "lid": slice(32, 48)}


def _warm(cfg, seed):
    """A state 12 plain steps in (past the sigma = 10 lid ramp), with a
    seeded relative perturbation of ~1e-3 of the full populations and of
    the stored macros (numpy, float64; the velocities additive)."""
    plain = dataclasses.replace(cfg, backend="plain")
    st = cavity.make_rollout(plain, 12)(cavity.init_state(plain, "cpu"))
    rng = np.random.default_rng(seed)

    def perturb(t, additive=0.0):
        a = t.double().numpy()
        noise = rng.standard_normal(a.shape)
        return torch.from_numpy(a * (1 + 1e-3 * noise) + additive * noise
                                ).to(cfg.dtype)

    f = cavity.encode_f(cfg, perturb(cavity.decode_f(cfg, st.f)))
    return st._replace(f=f.contiguous(), rho=perturb(st.rho),
                       ux=perturb(st.ux, 1e-4), uy=perturb(st.uy, 1e-4))


@pytest.fixture(scope="module")
def f64_48x32():
    """A warm f64 state of 48x32 (NY x NX): three 16-row shards."""
    cfg = CavityConfig(NX=32, NY=48, dtype=torch.float64)
    return cfg, _warm(cfg, seed=4832)


@pytest.mark.parametrize("where", list(WHERE))
@pytest.mark.parametrize("lean", [False, True], ids=["stored", "lean"])
def test_halo_matches_jax_kernel(f64_48x32, lean, where):
    """A 16x32 shard with the neighbours' 8-row strips (ring-wrapped on the
    wall shards, as the exchange delivers them), at a step of the lid ramp."""
    cfg, st = f64_48x32
    u = cavity._lid_speed(cfg, 7)
    args, walls = fc.halo_inputs(st.f, None if lean else
                                 (st.rho, st.ux, st.uy), WHERE[where],
                                 depth=8)
    jax_kernel = (jfc.collide_stream_cavity_halo_lean if lean
                  else jfc.collide_stream_cavity_halo)
    port = (fc.collide_stream_cavity_halo_lean if lean
            else fc.collide_stream_cavity_halo)
    want = jax_kernel(*(a.numpy() for a in args), u, *walls, tau=cfg.tau,
                      interpret=True)
    got = port(*args, u, *walls, tau=cfg.tau)
    if lean:
        got, want = [got], [want]
    # the macros are sums of populations (over rho): their rounding is the
    # populations', so their absolute gate is 1e-15 of f's scale
    f_scale = float(np.abs(np.asarray(want[0])).max())
    for name, g, w in zip(("f", "rho", "ux", "uy"), got, want):
        np.testing.assert_allclose(interop.tensor_to_numpy(g),
                                   np.asarray(w), rtol=1e-12,
                                   atol=1e-15 * f_scale,
                                   err_msg=f"{where} {name}")


@pytest.mark.parametrize("where", list(WHERE))
def test_gated_window_matches_jax_kernel(f64_48x32, where):
    """K = 3 steps from step 4 (inside the lid ramp) on a 16-row shard
    extended to 22 rows: wall_rows (3, -1) on the bottom shard, (-1, 18)
    on the lid's, (-1, -1) between."""
    cfg, st = f64_48x32
    k = 3
    block, wall_rows = fc.window_inputs(st.f, WHERE[where], k)
    assert wall_rows == {"bottom": (3, -1), "interior": (-1, -1),
                         "lid": (-1, 18)}[where]
    kw = dict(tau=cfg.tau, k_steps=k, u_lid=cfg.u_lid, sigma=cfg.sigma)
    want = jfc.collide_stream_cavity_multistep_gated(
        block.numpy(), 4, jnp.asarray(wall_rows, jnp.float64),
        interpret=True, **kw)
    got = fc.collide_stream_cavity_multistep_gated(block, 4, wall_rows, **kw)
    assert_close(got, np.asarray(want), rtol=1e-12, atol_rel=1e-15,
                 name=f"{where} window")


# (label, NY, shards, strip depth): 48 rows of 24 cut in 2 and in 4, and
# 129 rows cut in 3 ragged 43-row shards
CUTS = [("2x24", 48, 2, 1), ("4x12", 48, 4, 8), ("3x43", 129, 3, 3)]


@pytest.mark.parametrize("kernel", ["stored", "lean", "window"])
@pytest.mark.parametrize("cut", CUTS, ids=lambda c: c[0])
@pytest.mark.parametrize("mode", MODES, ids=lambda m: m[0])
def test_shards_equal_the_full_grid_bitwise(mode, cut, kernel):
    """Every shard of the cut through its plain version equals the
    single-device plain version on the full grid (NX = 24) at its rows,
    bit for bit: collide_stream_cavity, _lean, and the window of K = 5
    steps from step 8 (across the end of the lid ramp) in its interior."""
    _, dtype, storage = mode
    label, NY, n, depth = cut
    cfg = CavityConfig(NX=24, NY=NY, dtype=dtype, storage=storage)
    st = _warm(cfg, seed=NY * 10 + n)
    u, tau = cavity._lid_speed(cfg, 9), cfg.tau
    macros = (st.rho, st.ux, st.uy)
    k = 5
    kw = dict(tau=tau, k_steps=k, u_lid=cfg.u_lid, sigma=cfg.sigma)
    if kernel == "stored":
        want = fc.collide_stream_cavity_reference(st.f, *macros, u, tau=tau)
    elif kernel == "lean":
        want = [fc.collide_stream_cavity_lean_reference(st.f, u, tau=tau)]
    else:
        want = [fc.collide_stream_cavity_multistep_reference(st.f, 8, **kw)]
    rows = NY // n
    for r in range(n):
        ys = slice(r * rows, (r + 1) * rows)
        if kernel == "window":
            block, wall_rows = fc.window_inputs(st.f, ys, k)
            got = [fc.collide_stream_cavity_multistep_gated(
                block, 8, wall_rows, **kw)[:, k:-k]]
        else:
            args, walls = fc.halo_inputs(st.f, None if kernel == "lean"
                                         else macros, ys, depth)
            got = (fc.collide_stream_cavity_halo(*args, u, *walls, tau=tau)
                   if kernel == "stored" else
                   [fc.collide_stream_cavity_halo_lean(*args, u, *walls,
                                                       tau=tau)])
        for name, g, w in zip(("f", "rho", "ux", "uy"), got, want):
            assert torch.equal(g, w[..., ys, :]), (
                f"{label} shard {r} {name}: "
                f"{int((g != w[..., ys, :]).sum())} elements differ")


def test_gated_window_with_walls_at_the_edges_is_the_window(f64_48x32):
    """On the whole grid, wall_rows (0, NY - 1) is the single-device
    window, whose plain version it is."""
    cfg, st = f64_48x32
    kw = dict(tau=cfg.tau, k_steps=4, u_lid=cfg.u_lid, sigma=cfg.sigma)
    assert torch.equal(
        fc.collide_stream_cavity_multistep_gated(st.f, 6, (0, 47), **kw),
        fc.collide_stream_cavity_multistep(st.f, 6, **kw))


def _bad_strips(args, lean):
    """(what, arguments) with one strip malformed."""
    f, f_up = args[0], args[1 if lean else 4]
    i = 1 if lean else 4
    narrow = f_up[..., :-1].contiguous()
    yield "up strip narrower", [*args[:i], narrow, *args[i + 1:]]
    yield "up strip dtype", [*args[:i], f_up.float(), *args[i + 1:]]
    zero = f_up[:, :0]
    yield "zero-depth up strip", [*args[:i], zero, *args[i + 1:]]
    if not lean:
        mac = args[5]
        yield "macro strip of another depth", [*args[:5], mac[:, :1],
                                               *args[6:]]
        yield "macro strip dtype", [*args[:5], mac.float(), *args[6:]]
        yield "macro strip of 2 planes", [*args[:5], mac[:2], *args[6:]]


@pytest.mark.parametrize("lean", [False, True], ids=["stored", "lean"])
def test_bad_strips_raise(f64_48x32, lean):
    cfg, st = f64_48x32
    args, walls = fc.halo_inputs(st.f, None if lean else
                                 (st.rho, st.ux, st.uy), slice(0, 16),
                                 depth=2)
    kernel = (fc.collide_stream_cavity_halo_lean if lean
              else fc.collide_stream_cavity_halo)
    for what, bad in _bad_strips(args, lean):
        with pytest.raises((ValueError, TypeError)):
            kernel(*bad, 0.01, *walls, tau=cfg.tau)
            pytest.fail(what)


def test_gated_window_refusals(f64_48x32):
    cfg, st = f64_48x32
    kw = dict(tau=cfg.tau, u_lid=cfg.u_lid, sigma=cfg.sigma)
    for wall_rows in ((48, -1), (-2, 5), (0, 48)):
        with pytest.raises(ValueError, match="wall_rows"):
            fc.collide_stream_cavity_multistep_gated(st.f, 0, wall_rows,
                                                     k_steps=2, **kw)
    with pytest.raises(ValueError, match="k_steps"):
        fc.collide_stream_cavity_multistep_gated(st.f, 0, (0, 47),
                                                 k_steps=0, **kw)


def test_launches_stay_zero_on_cpu(f64_48x32):
    cfg, st = f64_48x32
    before = dict(fc.LAUNCHES)
    args, walls = fc.halo_inputs(st.f, (st.rho, st.ux, st.uy), slice(0, 16))
    fc.collide_stream_cavity_halo(*args, 0.01, *walls, tau=cfg.tau)
    args, walls = fc.halo_inputs(st.f, None, slice(0, 16))
    fc.collide_stream_cavity_halo_lean(*args, 0.01, *walls, tau=cfg.tau)
    block, wall_rows = fc.window_inputs(st.f, slice(0, 16), 2)
    fc.collide_stream_cavity_multistep_gated(
        block, 0, wall_rows, tau=cfg.tau, k_steps=2, u_lid=cfg.u_lid,
        sigma=cfg.sigma)
    assert fc.LAUNCHES == before


def test_non_cpu_tensors_never_take_the_plain_version(f64_48x32):
    """A tensor that is not on the CPU goes to the kernel or raises: here
    (meta tensors) the input check refuses it before any build."""
    cfg, st = f64_48x32
    meta = st._replace(**{k: getattr(st, k).to("meta")
                          for k in ("f", "rho", "ux", "uy")})
    args, walls = fc.halo_inputs(meta.f, (meta.rho, meta.ux, meta.uy),
                                 slice(0, 16))
    with pytest.raises(ValueError, match="CUDA"):
        fc.collide_stream_cavity_halo(*args, 0.01, *walls, tau=cfg.tau)
    args, walls = fc.halo_inputs(meta.f, None, slice(0, 16))
    with pytest.raises(ValueError, match="CUDA"):
        fc.collide_stream_cavity_halo_lean(*args, 0.01, *walls, tau=cfg.tau)
    with pytest.raises(ValueError, match="CUDA"):
        fc.collide_stream_cavity_multistep_gated(
            meta.f, 0, (0, 47), tau=cfg.tau, k_steps=2, u_lid=cfg.u_lid,
            sigma=cfg.sigma)
