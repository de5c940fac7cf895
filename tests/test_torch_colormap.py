"""lbm_tpu_torch.io.colormap against lbm_tpu.io.colormap on the CPU (Hold 1).

The same numpy-seeded fields, f64 and f32, in range, out of range, and
placed one ulp either side of the quantisation edges (the index's
(k - 1/2)/255 and the JET channels' k/255 of the normalised value), go
through both packages. The port's frames are uint8-equal to JAX's
expressions evaluated op by op (jax.disable_jit, each operation rounded
once, a true division by the range's width), and so are the cavity's
frame and JET's ends and shapes (tests/test_io.py:17-47).

Against the jitted lbm_tpu.io.colormap.render_all (what lbm_tpu's
VideoRecorder runs), XLA's CPU compiler rewrites two expressions: the
division by the constant width becomes a product with its reciprocal, and
the velocity magnitude's ux*ux + uy*uy is contracted into an FMA. Pixels
whose value lies within an ulp of a band edge then move by one index;
test_jitted_render_all_moves_edge_pixels_by_one_index counts them and
holds every other pixel equal (ROADMAP Queue 3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu.io import colormap as jcm
from lbm_tpu_torch.io import colormap as tcm

torch.set_num_threads(1)

NY, NX = 24, 32
ARGS = ("rho_e", "rho_i", "rho_q", "ux_e", "uy_e", "ux_i", "uy_i",
        "T_e", "T_i", "T_n")
DTYPES = {"f64": np.float64, "f32": np.float32}


def _edge_values(rng, lo, hi, dt, shape):
    """Field values one ulp either side of the normalised value's edges:
    (k - 1/2)/255 (the index) and k/255 (the JET channels)."""
    k = rng.integers(0, 257, size=shape)
    u = np.where(rng.random(shape) < 0.5, (k - 0.5) / 255.0, k / 255.0)
    x = (lo + u * (hi - lo)).astype(dt)
    step = np.where(rng.random(shape) < 0.5, np.inf, -np.inf).astype(dt)
    return np.nextafter(x, step).astype(dt)


def _fields(dt, seed=0):
    """{name: (NY, NX)} of dtype dt: the left half uniform over the range
    widened by 10% each way, the right half on the edges."""
    rng = np.random.default_rng(seed)
    out = {}
    for name in ARGS:
        lo, hi = jcm.RANGES[name]
        w = hi - lo
        a = (lo - 0.1 * w + 1.2 * w * rng.random((NY, NX))).astype(dt)
        a[:, NX // 2:] = _edge_values(rng, lo, hi, dt, (NY, NX - NX // 2))
        out[name] = a
    return out


@pytest.fixture(scope="module")
def fields():
    return {k: _fields(dt, seed=i)
            for i, (k, dt) in enumerate(DTYPES.items())}


@pytest.fixture(scope="module")
def jax_frames(fields):
    """{dtype: (op-by-op frames, jitted frames)} of lbm_tpu's render_all."""
    out = {}
    for key, f in fields.items():
        args = [jnp.asarray(f[k]) for k in ARGS]
        jitted = [np.asarray(a) for a in jcm.render_all(*args)]
        with jax.disable_jit():
            op = [np.asarray(a) for a in jcm.render_all(*args)]
        out[key] = (op, jitted)
    return out


def _port(f):
    return [t.numpy() for t in tcm.render_all(
        *[torch.from_numpy(f[k]) for k in ARGS])]


@pytest.mark.parametrize("key", list(DTYPES))
def test_render_all_equals_jax_op_by_op(fields, jax_frames, key):
    port = _port(fields[key])
    for name, got, want in zip(("density", "velocity", "temperature"),
                               port, jax_frames[key][0]):
        assert got.dtype == np.uint8 and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=f"{key} {name}")


@pytest.mark.parametrize("key", list(DTYPES))
def test_each_tile_equals_jax_colorize(fields, key):
    """Each of index_panels' 12 tiles, flipped, equals lbm_tpu's colorize
    (called unjitted, op by op) on that field's own range; the magnitudes
    are velocity_frame's expression."""
    f = fields[key]
    j = {k: jnp.asarray(v) for k, v in f.items()}
    for s in ("e", "i"):
        j[f"u_mag_{s}"] = jnp.sqrt(j[f"ux_{s}"] * j[f"ux_{s}"]
                                   + j[f"uy_{s}"] * j[f"uy_{s}"])
    panels = tcm.index_panels(*[torch.from_numpy(f[k]) for k in ARGS])
    assert panels.shape == (len(tcm.PANELS), NY, NX)
    for tile, k in zip(panels, tcm.PANELS):
        np.testing.assert_array_equal(
            torch.flip(tile, dims=(0,)).numpy(),
            np.asarray(jcm.colorize(j[k], *jcm.RANGES[k])),
            err_msg=f"{key} {k}")


@pytest.mark.parametrize("key", list(DTYPES))
def test_jitted_render_all_moves_edge_pixels_by_one_index(fields, jax_frames,
                                                          key):
    """Every pixel equal to the jitted render_all's, or one index away on
    the edge (right) half of each tile; the uniform (left) half equal. The
    counts go to ROADMAP Queue 3."""
    port = _port(fields[key])
    counts = {}
    for name, got, want in zip(("density", "velocity", "temperature"),
                               port, jax_frames[key][1]):
        d = got.astype(int) - want.astype(int)
        assert np.abs(d).max() <= 1, (key, name)
        tiles = d.reshape(d.shape[0], 3, NX)
        counts[name] = (int((tiles[:, :, :NX // 2] != 0).sum()),
                        int((tiles[:, :, NX // 2:] != 0).sum()), d.size)
        assert counts[name][0] == 0, (key, name, counts)
    print(key, "pixels unequal to the jitted render_all (uniform half, "
          "edge half, all):", counts)


def test_palette_and_jet_match_jax():
    np.testing.assert_array_equal(tcm.JET_PALETTE, jcm.JET_PALETTE)
    for dt in DTYPES.values():
        v = np.concatenate([np.linspace(-0.5, 1.5, 401),
                            _edge_values(np.random.default_rng(3), 0.0, 1.0,
                                         dt, (400,))]).astype(dt)
        np.testing.assert_array_equal(
            tcm.jet(torch.from_numpy(v)).numpy(),
            np.asarray(jax.jit(jcm.jet)(jnp.asarray(v))))
        np.testing.assert_array_equal(
            tcm.jet_index(torch.from_numpy(v)).numpy(),
            np.asarray(jax.jit(jcm.jet_index)(jnp.asarray(v))))


def test_expand_is_the_palette():
    idx = torch.from_numpy(np.random.default_rng(4).integers(
        0, 256, (7, 9), dtype=np.uint8))
    np.testing.assert_array_equal(tcm.expand(idx).numpy(),
                                  tcm.JET_PALETTE[idx.numpy()])


def test_jet_colormap_endpoints():
    """tests/test_io.py::test_jet_colormap_endpoints on the port."""
    v = torch.tensor([0.0, 0.25, 0.5, 0.75, 1.0])
    rgb = tcm.jet(v).numpy()
    assert rgb.shape == (5, 3)
    assert rgb[0, 2] > 100 and rgb[0, 0] == 0       # cold end: blue
    assert rgb[2, 1] == 255                          # middle: green
    assert rgb[4, 0] > 100 and rgb[4, 2] == 0        # hot end: red
    over = tcm.jet(torch.tensor([2.0, -1.0])).numpy()
    np.testing.assert_array_equal(over[0], rgb[4])
    np.testing.assert_array_equal(over[1], rgb[0])
    idx = tcm.jet_index(v).numpy()
    diff = tcm.JET_PALETTE[idx].astype(int) - rgb.astype(int)
    assert np.abs(diff).max() <= 2


def test_frames_shapes():
    """tests/test_io.py::test_frames_shapes on the port, and the sharded
    path's tiles: index_panels + frames_of_panels is render_all."""
    z = torch.zeros((12, 16), dtype=torch.float64)
    frames = tcm.render_all(*[z] * 10)
    assert [f.shape for f in frames] == [(12, 48), (24, 48), (12, 48)]
    assert all(f.dtype == torch.uint8 for f in frames)
    panels = tcm.index_panels(*[z] * 10)
    assert panels.shape == (12, 12, 16) and panels.dtype == torch.uint8
    assert [f.shape for f in tcm.frames_of_panels(panels)] == [
        (12, 48), (24, 48), (12, 48)]


def _jax_cavity_frame(ux, uy):
    """scripts/run_cavity.py:145-147."""
    m = ux * ux + uy * uy
    lo, hi = m.min(), m.max()
    return jcm.jet((m - lo) / jnp.maximum(hi - lo, 1e-30))[::-1]


@pytest.mark.parametrize("key", list(DTYPES))
def test_cavity_frame_equals_jax(key):
    """The cavity's |u|^2 frame: op by op equal; jitted, XLA's FMA in the
    sum of squares moves edge pixels by one level of a channel."""
    dt = DTYPES[key]
    rng = np.random.default_rng(7)
    ux = (0.1 * rng.standard_normal((NY, NX))).astype(dt)
    uy = (0.1 * rng.standard_normal((NY, NX))).astype(dt)
    uy[0, 0] = ux[0, 0] = 0.0
    got = tcm.cavity_frame(torch.from_numpy(ux), torch.from_numpy(uy))
    assert got.dtype == torch.uint8 and got.shape == (NY, NX, 3)
    with jax.disable_jit():
        want = np.asarray(_jax_cavity_frame(jnp.asarray(ux),
                                            jnp.asarray(uy)))
    np.testing.assert_array_equal(got.numpy(), want)
    jitted = np.asarray(jax.jit(_jax_cavity_frame)(jnp.asarray(ux),
                                                   jnp.asarray(uy)))
    assert np.abs(got.numpy().astype(int) - jitted).max() <= 1
    # a constant field: hi - lo = 0 takes the 1e-30 floor, all blue
    flat = tcm.cavity_frame(torch.zeros(4, 5, dtype=torch.float64),
                            torch.zeros(4, 5, dtype=torch.float64))
    np.testing.assert_array_equal(flat.numpy(), np.broadcast_to(
        tcm.jet(torch.zeros(1, dtype=torch.float64)).numpy(), (4, 5, 3)))
