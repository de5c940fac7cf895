"""scripts/visualize_fields_torch.py against scripts/visualize_fields.py.

The same checkpoint files, written by the JAX package from seeded states
(2-D classic f64, delta f64, bf16 populations with delta neutrals, a 3-D
f64 column, a cavity), go through JAX's _load_macros and the port's: the
macros agree within 1e-12 of each field's scale in f64 (1e-6 for the
bf16 file, whose moments are f32), the cavity's fields are equal, and the
port's plots are written (or refused without matplotlib).
"""
import dataclasses
import importlib.util
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu.config import CavityConfig, PlasmaConfig
from lbm_tpu.io import checkpoint as jckpt
from lbm_tpu.models import cavity, plasma, plasma3d

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
torch.set_num_threads(1)
CPU = torch.device("cpu")


def _script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "scripts", f"{name}.py"))
    m = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(m)
    return m


@pytest.fixture(scope="module")
def scripts():
    return _script("visualize_fields"), _script("visualize_fields_torch")


def _noisy(a, rng, rel=1e-3):
    a = np.asarray(a, np.float64)
    return a * (1 + rel * rng.standard_normal(a.shape))


def _plasma_file(path, delta, storage, dtype, nz=0):
    """A seeded state of the JAX package saved with its layout metadata."""
    rng = np.random.default_rng(5 + nz + 2 * delta)
    cfg = dataclasses.replace(PlasmaConfig(), NX=12, NY=10, NZ=nz,
                              dtype=dtype, neutral_delta=delta,
                              storage=storage)
    if nz:
        s = plasma3d.init_state(cfg)
        fields = ("Ex", "Ey", "Ez")
    else:
        s = plasma.init_state(cfg)
        fields = ("Ex", "Ey")
    pop = jnp.bfloat16 if storage == "bf16" else dtype
    s = s._replace(
        f=jnp.asarray(_noisy(s.f, rng), dtype).astype(pop),
        g=jnp.asarray(_noisy(s.g, rng), dtype).astype(pop),
        **{k: jnp.asarray(1e-3 * rng.standard_normal(getattr(s, k).shape),
                          dtype) for k in fields}, step=7)
    save = jckpt.save3d if nz else jckpt.save
    save(path, s, neutral_delta=delta, storage=storage)
    return path


CASES = {
    "classic_f64": (False, "native", jnp.float64, 0, 1e-12),
    "delta_f64": (True, "native", jnp.float64, 0, 1e-12),
    "bf16_delta": (True, "bf16", jnp.float32, 0, 1e-6),
    "column_f64": (True, "native", jnp.float64, 4, 1e-12),
}


@pytest.mark.parametrize("case", list(CASES))
def test_macros_equal_jax(tmp_path, scripts, case):
    delta, storage, dtype, nz, tol = CASES[case]
    path = _plasma_file(str(tmp_path / "ck.npz"), delta, storage, dtype, nz)
    jv, tv = scripts
    want = jv._load_macros(path, None)
    got = tv._load_macros(path, None, CPU)
    assert got[4] == want[4] == 7
    for name, g, w in (("rho", got[0], want[0]), ("ux", got[1], want[1]),
                       ("uy", got[2], want[2])):
        for s in range(3):
            w_s = np.asarray(w[s], np.float64)
            scale = np.abs(w_s).max()
            assert g[s].shape == (10, 12)
            assert np.abs(g[s] - w_s).max() <= tol * scale, (case, name, s)
    w_q = np.asarray(want[3], np.float64)
    assert np.abs(got[3] - w_q).max() <= tol * np.abs(w_q).max(), case
    if nz:
        with pytest.raises(SystemExit):
            tv._load_macros(path, nz, CPU)


def test_cavity_and_plots(tmp_path, scripts, monkeypatch):
    """A cavity file's fields equal JAX's load; the port's plots of it and
    of a 2-D file are written; without matplotlib the script exits."""
    rng = np.random.default_rng(9)
    cfg = CavityConfig(NX=16, NY=16, nsteps=0, dtype=jnp.float64)
    s = cavity.init_state(cfg)
    s = s._replace(f=jnp.asarray(_noisy(s.f, rng)),
                   ux=jnp.asarray(0.01 * rng.standard_normal((16, 16))),
                   uy=jnp.asarray(0.01 * rng.standard_normal((16, 16))),
                   step=40)
    path = str(tmp_path / "cav.npz")
    jckpt.save_cavity(path, s, storage="native")
    _, tv = scripts
    rho, ux, uy, step = tv._load_cavity(path, CPU)
    js = jckpt.load_cavity(path)
    assert step == 40
    for got, want in ((rho, js.rho), (ux, js.ux), (uy, js.uy)):
        np.testing.assert_array_equal(got, np.asarray(want))
    out = tmp_path / "plots"
    assert tv.main([path, "--device", "cpu", "--out", str(out)]) == 0
    assert sorted(os.listdir(out)) == ["density.png", "streamlines.png",
                                       "velocity.png"]
    two_d = _plasma_file(str(tmp_path / "p.npz"), True, "native",
                         jnp.float64)
    assert tv.main([two_d, "--device", "cpu", "--out", str(out / "p"),
                    "--species", "e"]) == 0
    assert sorted(os.listdir(out / "p")) == [
        "density_e.png", "rho_q.png", "streamlines_e.png", "velocity_e.png"]
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(SystemExit, match="matplotlib"):
        tv.main([path, "--device", "cpu", "--out", str(tmp_path / "none")])


def test_default_device_is_cuda(tmp_path, scripts, monkeypatch):
    """Without --device the script loads onto the GPU, and says so where
    there is none."""
    path = _plasma_file(str(tmp_path / "ck.npz"), True, "native",
                        jnp.float64)
    _, tv = scripts
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cuda"):
        tv.main([path, "--out", str(tmp_path / "plots")])
