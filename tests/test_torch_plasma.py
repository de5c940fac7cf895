"""lbm_tpu_torch.models.plasma against lbm_tpu's, and the golden run.

  * the step, 5 steps at 24x32 in f64, against the JAX package's jnp step
    (f, g, Ex, Ey, phi at 1e-11 relative). The JAX step runs op by op, not
    under jax.jit: the port evaluates the same expression trees op by op
    and agrees with that bit for bit (up to the FFT library), while XLA's
    fusion moves last bits, and the golden configuration amplifies those
    above 1e-11 (rho_q is pure rounding noise at step 2, and the f64 neutral
    velocity cancels against rho_n ~ 1.8e10);
  * bf16 storage in f32 with neutral-delta storage, 3 steps, within one
    bf16 ulp;
  * the golden 200x200x200 f64 run through the port's CLI against the C++
    release build's 19 probe series (the gate of
    tests/test_reference_parity.py: rtol 1e-5, atol 1e-5*scale).
"""
import csv
import dataclasses
import gzip
import os

import numpy as np
import pytest
import torch

from lbm_tpu.models import plasma as jplasma
from lbm_tpu_torch import interop, run_plasma
from lbm_tpu_torch.io import probes as tprobes
from lbm_tpu_torch.models import plasma as tplasma

from torch_parity import (as_numpy, assert_close, assert_within_bf16_ulp,
                          configs, to_torch)

torch.set_num_threads(1)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "ref_probes_200x200_200steps_fft.csv.gz")


@pytest.mark.parametrize("fields", [
    {"dtype": "float64"},
    {"dtype": "float32", "neutral_delta": True},
    {"dtype": "float32", "neutral_delta": True, "storage": "bf16"},
], ids=["f64", "f32-delta", "bf16-delta"])
def test_init_state_matches(fields):
    cfg_j, cfg_t = configs(NX=20, NY=12, **fields)
    want = as_numpy(jplasma.init_state(cfg_j))
    got = interop.state_to_numpy(tplasma.init_state(cfg_t, "cpu"))
    for k in ("f", "g", "Ex", "Ey", "phi"):
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k].view(np.uint8),
                                      want[k].view(np.uint8), err_msg=k)
    assert int(got["step"]) == int(want["step"]) == 0


@pytest.mark.parametrize("delta", [False, True], ids=["native", "delta"])
@pytest.mark.parametrize("backend", ["plain", "fused"])
def test_step_matches_jax_f64(backend, delta):
    """backend="fused" on CPU tensors runs the kernel's plain version."""
    cfg_j, cfg_t = configs(NX=32, NY=24, neutral_delta=delta,
                           backend=backend)
    cfg_j = dataclasses.replace(cfg_j, backend="jnp", kernel_interpret=False)
    sj = jplasma.init_state(cfg_j)
    st = to_torch(as_numpy(sj))
    step_j = jplasma.make_step(cfg_j)
    step_t = tplasma.make_step(cfg_t)
    for t in range(5):
        sj, st = step_j(sj), step_t(st)
        for k in ("f", "g", "Ex", "Ey", "phi"):
            assert_close(getattr(st, k), getattr(sj, k), rtol=1e-11,
                         atol_rel=1e-11, name=f"{k} after step {t + 1}")
    assert st.step == int(sj.step) == 5


def test_bf16_storage_matches_jax_within_one_ulp():
    cfg_j, cfg_t = configs(dtype="float32", NX=32, NY=24, storage="bf16",
                           neutral_delta=True, backend="plain")
    sj = jplasma.init_state(cfg_j)
    st = to_torch(as_numpy(sj))
    step_j = jplasma.make_step(cfg_j)   # op by op, see the module docstring
    step_t = tplasma.make_step(cfg_t)
    for t in range(3):
        sj, st = step_j(sj), step_t(st)
        assert st.f.dtype == torch.bfloat16
        for k in ("f", "g"):
            assert_within_bf16_ulp(getattr(st, k), getattr(sj, k),
                                   name=f"{k} after step {t + 1}")
        for k in ("Ex", "Ey"):
            assert_close(getattr(st, k), getattr(sj, k), rtol=1e-5,
                         atol_rel=1e-5, name=f"{k} after step {t + 1}")


def test_rollout_is_n_steps():
    _, cfg = configs(NX=16, NY=12, backend="fused", nsteps=3)
    state = tplasma.init_state(cfg, "cpu")
    step = tplasma.make_step(cfg)
    want = step(step(step(state)))
    got = tplasma.make_rollout(cfg)(state)
    assert got.step == want.step == 3
    for k in ("f", "g", "Ex", "Ey", "phi"):
        assert torch.equal(getattr(got, k), getattr(want, k)), k
    assert tplasma.make_rollout(cfg, 1)(state).step == 1


def test_interop_round_trip_is_bitwise():
    _, cfg = configs(dtype="float32", NX=10, NY=8, storage="bf16",
                     neutral_delta=True)
    state = tplasma.make_step(cfg)(tplasma.init_state(cfg, "cpu"))
    back = interop.state_from_numpy(interop.state_to_numpy(state), "cpu")
    for k in ("f", "g", "Ex", "Ey", "phi"):
        a, b = getattr(state, k), getattr(back, k)
        assert a.dtype == b.dtype and torch.equal(a.view(torch.int16)
                                                  if a.dtype == torch.bfloat16
                                                  else a, b.view(torch.int16)
                                                  if b.dtype == torch.bfloat16
                                                  else b), k
    assert back.step == state.step == 1


def _parse_probe_fixture(path):
    series = {}
    with gzip.open(path, "rt") as fh:
        rd = csv.reader(fh)
        next(rd)
        for row in rd:
            series.setdefault(row[0], []).append([float(v) for v in row[2:]])
    return {k: np.asarray(v) for k, v in series.items()}


def test_golden_probe_series_match_cpp_reference(tmp_path):
    """The port's CLI on the CPU (plain backend), f64, the full golden
    window; same alignment and gate as the JAX package's test."""
    ref = _parse_probe_fixture(FIXTURE)
    summary = run_plasma.main(["--preset", "golden", "--f64", "--device",
                               "cpu", "--out", str(tmp_path)])
    assert summary["steps"] == 200 and summary["finite"]
    for k in ref:
        got = summary["probes"][k]
        scale = np.abs(ref[k]).max()
        np.testing.assert_allclose(got, ref[k], rtol=1e-5, atol=1e-5 * scale,
                                   err_msg=f"probe series {k}")
    # the CSV layout of the JAX package's run_plasma
    assert sorted(os.listdir(tmp_path / "graphs")) == sorted(
        f"ts_{q}.csv" for q in tprobes.QUANTITIES)
    rows = np.loadtxt(tmp_path / "graphs" / "ts_rho_q.csv", delimiter=",")
    assert rows.shape == (200, 9)
    with open(tmp_path / "simulation_time_plasma_details.csv") as fh:
        header, row = fh.read().splitlines()
    assert header.startswith("Grid_Dimension,Number_of_Steps")
    assert row.startswith("200x200,200,1,3,0,")


def test_cli_refuses_cuda_without_a_gpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_plasma.main(["--steps", "1", "--out", str(tmp_path)])
