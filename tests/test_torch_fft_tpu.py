"""The port's spectral solve (kernels/fft_tpu.py, ops/poisson.solve_fft_efield)
and its FFT-engine dispatch against lbm_tpu's, on the CPU.

  * the plain four-step solve_fft_efield_reference in f32 against
    lbm_tpu.kernels.fft_tpu.solve_fft_efield_xla at 1e-5 of scale (measured:
    at most ~5e-7 of scale, transform roundoff of two summation orders);
  * the same algebra in f64 against lbm_tpu.ops.poisson.solve_fft_efield in
    f64 at 1e-12 of scale, which a wrong symbol at the Nyquist row or column
    would fail (1e-5 would not show it);
  * ops.poisson.solve_fft_efield against JAX's in f64 at 1e-12 of scale;
  * the host tables against JAX's, exactly, and the kernel's bit-reversed
    tables against the same float64 values;
  * _use_pallas_fft's refusals, reconstruct_phi at 1e-12 in f64;
  * the wrapper: the plain version on CPU tensors, no launch counted, and
    its input checks;
  * the slice: the port's plain step with fft_engine="pallas" against JAX's
    jnp step with fft_engine="pallas" (the Pallas kernels in interpret
    mode), 3 steps at 128x256 in f32, f, g and E within 1e-5 of scale.

The CUDA kernel itself runs only on a GPU: chip_smoke.py phase 9 holds it
against the plain version there; tests/test_torch_kernel_host.py holds its
arithmetic (csrc/fft_solve.cuh), built for the CPU.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu.kernels import fft_tpu as jfft
from lbm_tpu.models import plasma as jplasma
from lbm_tpu.ops import poisson as jpoisson
from lbm_tpu_torch import interop
from lbm_tpu_torch.kernels import fft_tpu
from lbm_tpu_torch.models import plasma as tplasma
from lbm_tpu_torch.ops import poisson as tpoisson

from torch_parity import configs, np_of

torch.set_num_threads(1)

SHAPES = [(128, 128), (128, 256), (256, 128), (256, 512)]
SHAPE_IDS = ["x".join(map(str, s)) for s in SHAPES]


def _rho(shape, seed=3):
    """Seeded white-noise charge density at the JAX tests' amplitude."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape) * 1e-8


def _rel_err(got, want) -> float:
    """max |got - want| over both fields, over the larger field's scale."""
    scale = max(np.abs(np_of(w)).max() for w in want)
    return max(np.abs(np_of(g) - np_of(w)).max()
               for g, w in zip(got, want)) / scale


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_plain_four_step_matches_jax_oracle_f32(shape):
    rho = _rho(shape).astype(np.float32)
    want = jax.jit(jfft.solve_fft_efield_xla)(jnp.asarray(rho))
    got = fft_tpu.solve_fft_efield_reference(torch.from_numpy(rho))
    assert all(g.dtype == torch.float32 for g in got)
    assert _rel_err(got, want) < 1e-5


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_plain_four_step_f64_matches_spectral_solve(shape):
    rho = _rho(shape, seed=4)
    want = jax.jit(jpoisson.solve_fft_efield)(jnp.asarray(rho))
    got = fft_tpu.solve_fft_efield_reference(torch.from_numpy(rho),
                                             dtype=torch.float64)
    assert all(g.dtype == torch.float64 for g in got)
    assert _rel_err(got, want) < 1e-12


@pytest.mark.parametrize("shape", [(12, 16), (9, 15), (128, 256)],
                         ids=["12x16", "9x15", "128x256"])
def test_solve_fft_efield_matches_jax_f64(shape):
    rho = _rho(shape, seed=5)
    want = jax.jit(jpoisson.solve_fft_efield)(jnp.asarray(rho))
    got = tpoisson.solve_fft_efield(torch.from_numpy(rho))
    assert _rel_err(got, want) < 1e-12
    # and the phi route of the same package, E = -grad phi
    phi_route = tpoisson.efield_periodic(tpoisson.solve_fft(
        torch.from_numpy(rho)))
    assert _rel_err(got, phi_route) < 1e-12


def test_host_tables_match_jax():
    for n in (128, 256, 1024, 4096):
        np.testing.assert_array_equal(fft_tpu.perm_indices(n),
                                      jfft.perm_indices(n))
        mine, ref = fft_tpu.make_axis_plan(n), jfft.make_axis_plan(n)
        assert (mine.N, mine.A) == (ref.N, ref.A)
        for a, b in zip(mine[2:], ref[2:]):
            assert a.dtype == np.float64
            np.testing.assert_array_equal(a.astype(np.float32), b)
    for ny, nx in ((128, 256), (512, 128), (2048, 2048)):
        for a, b in zip(fft_tpu.grad_vectors(ny, nx),
                        jfft.grad_vectors(ny, nx)):
            assert a.dtype == b.dtype == np.float64
            np.testing.assert_array_equal(a, b)
    for shape in ((2048, 2048), (1024, 4096), (128, 256), (128, 128),
                  (200, 200), (2048, 1536), (128, 100), (64, 128),
                  (384, 128)):
        assert fft_tpu.supports(*shape) == jfft.supports(*shape), shape
    assert not fft_tpu.supports(200, 200)
    assert not fft_tpu.supports(2048, 1536)


@pytest.mark.parametrize("shape", [(128, 256), (256, 128)],
                         ids=["128x256", "256x128"])
def test_kernel_tables_hold_the_symbols_in_bit_reversed_order(shape):
    NY, NX = shape
    tw_x, tw_y, sym_x, sym_y = fft_tpu.kernel_tables(NY, NX)
    for tw, n in ((tw_x, NX), (tw_y, NY)):
        w = np.exp(-2j * np.pi * np.arange(n) / n)
        np.testing.assert_array_equal(tw, np.stack(
            [w.real, w.imag], 1).astype(np.float32))
    siny2, sy, sinx2, sx = jfft.grad_vectors(NY, NX)
    for sym, n, sin2, s in ((sym_x, NX, sinx2, sx), (sym_y, NY, siny2, sy)):
        k = fft_tpu.bitrev_indices(n)
        assert sorted(k) == list(range(n))
        # JAX's table holds wavenumber perm[p] at p: index it by k
        by_k = np.empty(n, np.int64)
        by_k[jfft.perm_indices(n)] = np.arange(n)
        np.testing.assert_array_equal(sym[:, 0], sin2[by_k[k]].astype(
            np.float32))
        np.testing.assert_array_equal(sym[:, 1], s[by_k[k]].astype(
            np.float32))
        # the Nyquist wavenumber's sine is the float64 value, ~1e-16
        nyq = np.flatnonzero(k == n // 2)[0]
        assert 0 < abs(sym[nyq, 1]) < 1e-15


@pytest.mark.parametrize("engine, shape, dtype, raises", [
    ("pallas", (200, 200), "float32", True),
    ("pallas", (2048, 1536), "float32", True),
    ("pallas", (128, 256), "float64", True),
    ("pallas", (128, 256), "float32", False),
    ("auto", (128, 256), "float32", False),
    ("xla", (200, 200), "float64", False),
])
def test_use_pallas_fft_matches_jax(engine, shape, dtype, raises):
    cj, ct = configs(dtype, NY=shape[0], NX=shape[1], fft_engine=engine)
    if raises:
        with pytest.raises(ValueError):
            jplasma._use_pallas_fft(cj, shape)
        with pytest.raises(ValueError):
            tplasma._use_pallas_fft(ct, shape)
    else:
        assert (tplasma._use_pallas_fft(ct, shape)
                == jplasma._use_pallas_fft(cj, shape)
                == (engine == "pallas"))


def test_reconstruct_phi_matches_jax_f64():
    cj, ct = configs("float64", NX=16, NY=12)
    state = tplasma.init_state(ct, "cpu")
    step = tplasma.make_step(ct)
    arrays = interop.state_to_numpy(step(step(state)))
    want = jax.jit(functools.partial(jplasma.reconstruct_phi, cj))(
        jplasma.PlasmaState(**{k: jnp.asarray(v) for k, v in arrays.items()}))
    got = tplasma.reconstruct_phi(ct, interop.state_from_numpy(arrays, "cpu"))
    scale = np.abs(np_of(want)).max()
    assert np.abs(np_of(got) - np_of(want)).max() < 1e-12 * scale


def test_wrapper_runs_the_plain_version_on_cpu_and_checks_its_inputs():
    rho = torch.from_numpy(_rho((128, 256)).astype(np.float32))
    launches = fft_tpu.LAUNCHES
    got = fft_tpu.solve_fft_efield_tpu(rho)
    want = fft_tpu.solve_fft_efield_reference(rho)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert fft_tpu.LAUNCHES == launches          # no kernel launched
    with pytest.raises(TypeError, match="float32"):
        fft_tpu.solve_fft_efield_tpu(rho.double())
    with pytest.raises(ValueError, match="power of two"):
        fft_tpu.solve_fft_efield_tpu(torch.zeros((200, 200)))
    with pytest.raises(ValueError, match="power of two"):
        fft_tpu.solve_fft_efield_tpu(torch.zeros((128,)))
    with pytest.raises(ValueError, match="contiguous"):
        fft_tpu.solve_fft_efield_tpu(torch.zeros((256, 128)).t())
    with pytest.raises(ValueError, match="CUDA"):
        fft_tpu.solve_fft_efield_tpu(torch.zeros((128, 128), device="meta"))


def test_pallas_engine_step_matches_jax_interpret_kernels():
    """The slice: 3 plain steps at 128x256 f32 with fft_engine="pallas"
    (the port's wrapper, on CPU tensors its plain version) against JAX's
    jnp step through its Pallas kernels in interpret mode; phi stays stale
    on both."""
    cj, ct = configs("float32", NX=256, NY=128, fft_engine="pallas")
    cj = dataclasses.replace(cj, kernel_interpret=True)
    js = jplasma.init_state(cj)
    jstep = jplasma.make_step(cj)
    ts = tplasma.init_state(ct, "cpu")
    tstep = tplasma.make_step(ct)
    for _ in range(3):
        js, ts = jstep(js), tstep(ts)
    assert ts.step == 3
    for k in range(3):
        for name in ("f", "g"):
            want = np_of(getattr(js, name)[k])
            got = np_of(getattr(ts, name)[k])
            np.testing.assert_allclose(
                got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max(),
                err_msg=f"{name}[{k}]")
    assert _rel_err((ts.Ex, ts.Ey), (js.Ex, js.Ey)) < 1e-5
    assert not ts.phi.any() and not np.asarray(js.phi).any()
