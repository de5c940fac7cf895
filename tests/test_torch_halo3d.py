"""The 3-D halo kernel's three geometries on the CPU: collide_stream_halo3d
(a z-shard), collide_stream_panel3d with halo_rows (a y-shard) and
collide_stream_panel3d_zhalo (a (dz, dy) tile).

The plain versions of collide_stream_halo3d and _zhalo are held against the
JAX package's Pallas kernels in interpret mode (one call each, 25-50 s
apiece here), and, without JAX, shards cut from a full grid are held bit
for bit against collide_stream3d_reference on that grid. The CUDA kernel
runs only on a GPU; chip_smoke.py phase 12a holds it there against both.
"""
import dataclasses

import numpy as np
import pytest
import torch

from lbm_tpu.kernels.fused_panel3d import (
    collide_stream_panel3d_zhalo as jax_zhalo)
from lbm_tpu.kernels.fused_step3d import collide_stream_halo3d as jax_halo3d
from lbm_tpu_torch.config import PlasmaConfig
from lbm_tpu_torch.kernels import fused_panel3d, fused_step3d
from lbm_tpu_torch.models import plasma3d

from torch_parity import assert_close

torch.set_num_threads(1)

# (label, dtype, storage, neutral_delta)
MODES = [("f64", torch.float64, "native", False),
         ("f32", torch.float32, "native", False),
         ("bf16+delta", torch.float32, "bf16", True)]
# (dz, dy) cuts of an 8x32x8 grid (NZ x NY x NX): None leaves the axis
# whole and wrapping (z-shards, y-shards); a number, tiles of it
CUTS = [(2, None), (4, None), (8, None), (None, 2), (None, 4), (2, 2),
        (1, 2), (2, 1)]


def _phys(cfg):
    u = cfg.units()
    return dict(taus=cfg.taus, q_e=u.q_e, q_i=u.q_i, m_e=u.m_e, m_i=u.m_i,
                cs2=u.cs2, kb=u.kb,
                neutral_ref=u.rho_n_init if cfg.neutral_delta else 0.0)


def warm3d(cfg, seed):
    """(f, g, Ex, Ey, Ez) after 2 plain steps, with a seeded relative
    perturbation of ~1e-3 made in float64 (Ey and Ez additive: the column
    starts uniform in z with Ey = Ez = 0)."""
    state = plasma3d.init_state(cfg, "cpu")
    step = plasma3d.make_step(dataclasses.replace(cfg, backend="plain"))
    for _ in range(2):
        state = step(state)
    rng = np.random.default_rng(seed)
    e = 1e-3 * float(state.Ex.abs().max())

    def perturb(t, additive=0.0):
        a = t.double().numpy()
        noise = rng.standard_normal(a.shape)
        return torch.from_numpy(a * (1 + 1e-3 * noise) + additive * noise
                                ).to(t.dtype).contiguous()

    return (perturb(state.f), perturb(state.g), perturb(state.Ex),
            perturb(state.Ey, e), perturb(state.Ez, e))


@pytest.fixture(scope="module")
def f64_grid():
    """A warm f64 8x32x16 grid (NZ x NY x NX)."""
    cfg = PlasmaConfig(NX=16, NY=32, NZ=8, dtype=torch.float64)
    return cfg, warm3d(cfg, seed=83216)


def _numpy(tensors):
    return [t.numpy() for t in tensors]


def test_halo3d_matches_jax_kernel(f64_grid):
    """A 4-slice z-shard of the first 16 rows of the grid, taken as a
    periodic 8x16x16 grid, with its neighbours' slices, f64."""
    cfg, full = f64_grid
    arrays = [a[..., :16, :] for a in full]
    shard, (up, dn), _, _ = fused_step3d.halo_inputs3d(arrays, slice(2, 6),
                                                       None)
    args = [*shard, *(t.unsqueeze(-3) for t in up + dn)]
    phys = _phys(cfg)
    want = jax_halo3d(*_numpy(args), interpret=True, **phys)
    got = fused_step3d.collide_stream_halo3d(*args, **phys)
    for name, g, w in zip(("f", "g", "rho_q"), got, want):
        assert_close(g, np.asarray(w), rtol=1e-12, atol_rel=1e-14,
                     name=name)


def test_zhalo_matches_jax_kernel(f64_grid):
    """A 4x8 (z, y) tile of the grid with its slices, rows and corner
    lines, f64."""
    cfg, full = f64_grid
    shard, zhalo, yrows, corners = fused_step3d.halo_inputs3d(
        full, slice(2, 6), slice(8, 16))
    groups = [zhalo[0] + zhalo[1], yrows[0] + yrows[1],
              corners[0] + corners[1], corners[2] + corners[3]]
    phys = _phys(cfg)
    want = jax_zhalo(*_numpy(shard), *(_numpy(g) for g in groups),
                     interpret=True, **phys)
    got = fused_panel3d.collide_stream_panel3d_zhalo(*shard, *groups, **phys)
    for name, g, w in zip(("f", "g", "rho_q"), got, want):
        assert_close(g, np.asarray(w), rtol=1e-12, atol_rel=1e-14,
                     name=name)


def _cut_slices(n, cut):
    if cut is None:
        return [None]
    size = n // cut
    return [slice(b * size, (b + 1) * size) for b in range(cut)]


@pytest.mark.parametrize("cut", CUTS, ids=lambda c: f"{c[0]}x{c[1]}")
@pytest.mark.parametrize("mode", MODES, ids=lambda m: m[0])
def test_shards_match_the_full_grid_bitwise(mode, cut):
    """Every shard of a (dz, dy) cut of an 8x32x8 grid through its
    geometry's public function (collide_stream_halo3d, _panel3d with
    halo_rows, _panel3d_zhalo) equals collide_stream3d_reference on the
    full grid at its sites, bit for bit, and so does the halo form's plain
    version."""
    _, dtype, storage, delta = mode
    cfg = PlasmaConfig(NX=8, NY=32, NZ=8, dtype=dtype, storage=storage,
                       neutral_delta=delta)
    full = warm3d(cfg, seed=10 * (cut[0] or 0) + (cut[1] or 0))
    phys = _phys(cfg)
    want = fused_step3d.collide_stream3d_reference(*full, **phys)
    for zs in _cut_slices(8, cut[0]):
        for ys in _cut_slices(32, cut[1]):
            strips = fused_step3d.halo_inputs3d(full, zs, ys)
            got = fused_panel3d.collide_stream_shard3d(*strips, **phys)
            plain = fused_step3d.halo3d_reference(*strips, **phys)
            at = (..., zs or slice(None), ys or slice(None), slice(None))
            for k, name in enumerate(("f", "g", "rho_q")):
                w = want[k][at[1:] if name == "rho_q" else at]
                for what, g in (("public", got[k]), ("plain", plain[k])):
                    assert torch.equal(g, w), (
                        f"{what} {name} z {zs} y {ys}: "
                        f"{int((g != w).sum())} elements differ")


def test_plain_versions_take_jax_layouts(f64_grid):
    """Each JAX-named plain version on its layout of one shard's strips is
    the halo form's plain version, bit for bit."""
    cfg, full = f64_grid
    phys = _phys(cfg)
    shard, zhalo, _, _ = fused_step3d.halo_inputs3d(full, slice(2, 6), None)
    cases = [(fused_step3d.collide_stream_halo3d_reference(
        *shard, *(t.unsqueeze(-3) for t in zhalo[0] + zhalo[1]), **phys),
        (shard, zhalo, None, None))]
    shard, _, yrows, _ = fused_step3d.halo_inputs3d(full, None, slice(8, 16))
    cases.append((fused_panel3d.collide_stream_panel3d_reference(
        *shard, halo_rows=yrows[0] + yrows[1], **phys),
        (shard, None, yrows, None)))
    strips = fused_step3d.halo_inputs3d(full, slice(6, 8), slice(24, 32))
    shard, zhalo, yrows, corners = strips
    cases.append((fused_panel3d.collide_stream_panel3d_zhalo_reference(
        *shard, zhalo[0] + zhalo[1], yrows[0] + yrows[1],
        corners[0] + corners[1], corners[2] + corners[3], **phys), strips))
    for got, strips in cases:
        want = fused_step3d.halo3d_reference(*strips, **phys)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_panel3d_without_rows_is_collide_stream3d(f64_grid):
    cfg, full = f64_grid
    phys = _phys(cfg)
    got = fused_panel3d.collide_stream_panel3d(*full, **phys)
    want = fused_step3d.collide_stream3d_reference(*full, **phys)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("ny, panel, match", [
    (20, 0, "no feasible 3-D panel height for 20x16"),
    (4, 0, "no feasible"),
    (16, 12, "panel height 12 invalid for NY=16"),
    (16, 32, "must divide NY")])
def test_panel_rule_refuses_what_jax_refuses(ny, panel, match):
    """JAX's panel kernels need a panel height that is a multiple of 8 and
    divides the shard's NY (lbm_tpu/kernels/fused_panel3d.py:425-431)."""
    with pytest.raises(ValueError, match=match):
        fused_panel3d.check_panel(ny, 16, panel)
    assert fused_panel3d.check_panel(24, 16) == 8
    assert fused_panel3d.check_panel(64, 16) == 64


def test_bad_strips_raise(f64_grid):
    cfg, full = f64_grid
    phys = _phys(cfg)
    shard, zhalo, yrows, corners = fused_step3d.halo_inputs3d(
        full, slice(0, 4), slice(0, 16))
    up, dn = zhalo
    bad = {
        "slice two deep": lambda: fused_step3d.collide_stream_halo3d(
            *shard, *(torch.stack([t, t], dim=-3) for t in up),
            *(t.unsqueeze(-3) for t in dn), **phys),
        "row of other slices": lambda: fused_panel3d.collide_stream_panel3d(
            *shard, halo_rows=[t[..., :-1, :] if t.dim() == 4 else t[:-1]
                               for t in yrows[0] + yrows[1]], **phys),
        "corner dtype": lambda: fused_panel3d.collide_stream_panel3d_zhalo(
            *shard, up + dn, yrows[0] + yrows[1],
            tuple(t.float() for t in corners[0] + corners[1]),
            corners[2] + corners[3], **phys),
        "nine yrows": lambda: fused_panel3d.collide_stream_panel3d_zhalo(
            *shard, up + dn, (yrows[0] + yrows[1])[:9],
            corners[0] + corners[1], corners[2] + corners[3], **phys),
    }
    for what, call in bad.items():
        with pytest.raises((ValueError, TypeError)):
            call()
            pytest.fail(what)


def test_launches_stay_zero_on_cpu(f64_grid):
    cfg, full = f64_grid
    phys = _phys(cfg)
    for zs, ys in ((slice(0, 4), None), (None, slice(0, 16)),
                   (slice(0, 4), slice(0, 16))):
        fused_panel3d.collide_stream_shard3d(
            *fused_step3d.halo_inputs3d(full, zs, ys), **phys)
    assert fused_step3d.HALO_LAUNCHES == {
        "collide_stream_halo3d": 0, "collide_stream_panel3d": 0,
        "collide_stream_panel3d_zhalo": 0}


def test_non_cpu_tensors_never_take_the_plain_version(f64_grid):
    """A tensor that is not on the CPU goes to the kernel or raises: here
    (meta tensors) the input check refuses it before any build."""
    cfg, full = f64_grid
    phys = _phys(cfg)
    meta = [a.to("meta") for a in full]
    for zs, ys in ((slice(0, 4), None), (None, slice(0, 16)),
                   (slice(0, 4), slice(0, 16))):
        strips = fused_step3d.halo_inputs3d(meta, zs, ys)
        with pytest.raises(ValueError, match="CUDA"):
            fused_panel3d.collide_stream_shard3d(*strips, **phys)
