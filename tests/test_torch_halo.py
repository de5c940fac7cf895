"""The halo variants of kernels/fused_step on the CPU: collide_stream_halo
(a y-shard) and collide_stream_halo2d (a (y, x) tile).

Their plain versions are held against the JAX package's Pallas kernels in
interpret mode (one call each: an interpret call costs 10-15 s here), and,
without JAX, shards cut from a full grid and concatenated are held bit for
bit against collide_stream_reference on that grid. The CUDA kernels run
only on a GPU; chip_smoke.py phase 10a holds them there against both.
"""
import dataclasses

import numpy as np
import pytest
import torch

from lbm_tpu.kernels.fused_step import collide_stream_halo as jax_halo
from lbm_tpu.kernels.fused_step import collide_stream_halo2d as jax_halo2d
from lbm_tpu_torch.config import PlasmaConfig
from lbm_tpu_torch.kernels import fused_step
from lbm_tpu_torch.models import plasma

from torch_parity import assert_close

torch.set_num_threads(1)

# (label, dtype, storage, neutral_delta)
MODES = [("f64", torch.float64, "native", False),
         ("f32", torch.float32, "native", False),
         ("bf16+delta", torch.float32, "bf16", True)]


def _phys(cfg):
    u = cfg.units()
    return dict(taus=cfg.taus, q_e=u.q_e, q_i=u.q_i, m_e=u.m_e, m_i=u.m_i,
                cs2=u.cs2, kb=u.kb,
                neutral_ref=u.rho_n_init if cfg.neutral_delta else 0.0)


def _warm(cfg, seed):
    """(f, g, Ex, Ey) after 2 plain steps, with a seeded relative
    perturbation of ~1e-3 made in float64 (Ey additive: it starts at 0)."""
    state = plasma.init_state(cfg, "cpu")
    step = plasma.make_step(dataclasses.replace(cfg, backend="plain"))
    for _ in range(2):
        state = step(state)
    rng = np.random.default_rng(seed)
    ex_scale = float(state.Ex.abs().max())

    def perturb(t, additive=0.0):
        a = t.double().numpy()
        noise = rng.standard_normal(a.shape)
        return torch.from_numpy(a * (1 + 1e-3 * noise) + additive * noise
                                ).to(t.dtype).contiguous()

    return (perturb(state.f), perturb(state.g), perturb(state.Ex),
            perturb(state.Ey, 1e-3 * ex_scale))


@pytest.fixture(scope="module")
def f64_32x32():
    cfg = PlasmaConfig(NX=32, NY=32, dtype=torch.float64)
    return cfg, _warm(cfg, seed=3232)


def test_halo_matches_jax_kernel(f64_32x32):
    """A 16-row shard of the 32x16 grid (NY x NX) with its neighbours'
    8-row strips, f64."""
    cfg, full = f64_32x32
    arrays = [a[..., :16] for a in full]          # a 32x16 periodic grid
    args = fused_step.halo_inputs(arrays, slice(8, 24), depth=8)
    phys = _phys(cfg)
    want = jax_halo(*(a.numpy() for a in args), interpret=True, **phys)
    got = fused_step.collide_stream_halo(*args, **phys)
    for name, g, w in zip(("f", "g", "rho_q"), got, want):
        assert_close(g, np.asarray(w), rtol=1e-12, atol_rel=1e-14,
                     name=name)


def test_halo2d_matches_jax_kernel(f64_32x32):
    """A 16x16 tile of the 32x32 grid with 8-deep strips, the y strips
    corner-extended by 8 columns, f64."""
    cfg, full = f64_32x32
    args = fused_step.halo_inputs(full, slice(16, 32), slice(8, 24), depth=8,
                                  ext=8)
    phys = _phys(cfg)
    want = jax_halo2d(*(a.numpy() for a in args), interpret=True, **phys)
    got = fused_step.collide_stream_halo2d(*args, **phys)
    for name, g, w in zip(("f", "g", "rho_q"), got, want):
        assert_close(g, np.asarray(w), rtol=1e-12, atol_rel=1e-14,
                     name=name)


@pytest.mark.parametrize("cut", [(2, 1), (4, 1), (2, 2), (2, 4)],
                         ids=lambda c: f"{c[0]}x{c[1]}")
@pytest.mark.parametrize("mode", MODES, ids=lambda m: m[0])
def test_shards_concatenate_to_the_full_grid_bitwise(mode, cut):
    """Every shard of a (ny, nx) cut of a 32x24 grid (NY x NX) through its
    halo plain version; the shards concatenated equal the full grid's
    collide_stream_reference bit for bit (nx = 1: the y-shard variant)."""
    _, dtype, storage, delta = mode
    ny, nx = cut
    cfg = PlasmaConfig(NX=24, NY=32, dtype=dtype, storage=storage,
                       neutral_delta=delta)
    full = _warm(cfg, seed=ny * 10 + nx)
    phys = _phys(cfg)
    want = fused_step.collide_stream_reference(*full, **phys)
    rows, cols = 32 // ny, 24 // nx
    grid = []
    for by in range(ny):
        ys = slice(by * rows, (by + 1) * rows)
        if nx == 1:
            grid.append([fused_step.collide_stream_halo(
                *fused_step.halo_inputs(full, ys), **phys)])
            continue
        grid.append([fused_step.collide_stream_halo2d(
            *fused_step.halo_inputs(full, ys, slice(bx * cols,
                                                    (bx + 1) * cols)),
            **phys) for bx in range(nx)])
    for k, name in enumerate(("f", "g", "rho_q")):
        got = torch.cat([torch.cat([t[k] for t in row], dim=-1)
                         for row in grid], dim=-2)
        assert torch.equal(got, want[k]), (
            f"{name}: {int((got != want[k]).sum())} elements differ")


def test_strip_depth_and_extension_do_not_matter(f64_32x32):
    """Only the strips' edge rows and columns are read: 1-deep strips with
    a 1-column corner extension give what 8-deep strips with 8 give."""
    cfg, full = f64_32x32
    phys = _phys(cfg)
    one = fused_step.collide_stream_halo(
        *fused_step.halo_inputs(full, slice(0, 8)), **phys)
    eight = fused_step.collide_stream_halo(
        *fused_step.halo_inputs(full, slice(0, 8), depth=8), **phys)
    assert all(torch.equal(a, b) for a, b in zip(one, eight))
    one = fused_step.collide_stream_halo2d(
        *fused_step.halo_inputs(full, slice(8, 16), slice(0, 8)), **phys)
    eight = fused_step.collide_stream_halo2d(
        *fused_step.halo_inputs(full, slice(8, 16), slice(0, 8), depth=8,
                                ext=8), **phys)
    assert all(torch.equal(a, b) for a, b in zip(one, eight))


def _bad_1d(args):
    up = args[4]
    yield "up strip narrower", [*args[:4], up[..., :-1], *args[5:]]
    yield "strip dtype", [*args[:4], up.float(), *args[5:]]
    yield "zero-depth dn strip", [*args[:8], *(a[..., :0, :] if a.dim() == 4
                                                else a[:0]
                                                for a in args[8:])]


def _bad_2d(args):
    yield "y strips not corner-extended", [
        *args[:4], *(a[..., 1:-1] for a in args[4:12]), *args[12:]]
    yield "odd extension", [*args[:4], *(a[..., :-1] for a in args[4:12]),
                            *args[12:]]
    yield "lt strip of other rows", [*args[:12],
                                     *(a[..., :-1, :] for a in args[12:16]),
                                     *args[16:]]


def test_bad_shapes_raise(f64_32x32):
    cfg, full = f64_32x32
    phys = _phys(cfg)
    args = fused_step.halo_inputs(full, slice(0, 8))
    for what, bad in _bad_1d(args):
        with pytest.raises((ValueError, TypeError)):
            fused_step.collide_stream_halo(*bad, **phys)
            pytest.fail(what)
    args = fused_step.halo_inputs(full, slice(0, 8), slice(0, 8))
    for what, bad in _bad_2d(args):
        with pytest.raises((ValueError, TypeError)):
            fused_step.collide_stream_halo2d(*bad, **phys)
            pytest.fail(what)


def test_halo_launches_stay_zero_on_cpu(f64_32x32):
    cfg, full = f64_32x32
    phys = _phys(cfg)
    fused_step.collide_stream_halo(
        *fused_step.halo_inputs(full, slice(0, 8)), **phys)
    fused_step.collide_stream_halo2d(
        *fused_step.halo_inputs(full, slice(0, 8), slice(0, 8)), **phys)
    assert fused_step.HALO_LAUNCHES == {"collide_stream_halo": 0,
                                        "collide_stream_halo2d": 0}


def test_non_cpu_tensors_never_take_the_plain_version(f64_32x32):
    """A tensor that is not on the CPU goes to the kernel or raises: here
    (meta tensors) the input check refuses it before any build."""
    cfg, full = f64_32x32
    phys = _phys(cfg)
    meta = [a.to("meta") for a in full]
    with pytest.raises(ValueError, match="CUDA"):
        fused_step.collide_stream_halo(
            *fused_step.halo_inputs(meta, slice(0, 8)), **phys)
    with pytest.raises(ValueError, match="CUDA"):
        fused_step.collide_stream_halo2d(
            *fused_step.halo_inputs(meta, slice(0, 8), slice(0, 8)), **phys)
