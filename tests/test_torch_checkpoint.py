"""lbm_tpu_torch.io.checkpoint against lbm_tpu.io.checkpoint, and the three
CLIs' checkpoints and resumes on the CPU.

Files cross both ways bit for bit (2-D at 16^2, 3-D at 8^3, the cavity;
f64, f32 and bf16; classic and delta), metadata included; the layout and
storage conversions (convert_neutral_layout, reconcile_resumed_state,
reconcile_cavity_state) equal JAX's on the same files. The states are
seeded numpy arrays, so no JAX step is compiled except for the one
trajectory a port resume is held against. A straight CLI run and a
checkpoint-and-resume run give bitwise equal final_state.npz files.
"""
import dataclasses
import os

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from lbm_tpu import config as jcfg
from lbm_tpu.io import checkpoint as jckpt
from lbm_tpu.models import cavity as jcavity
from lbm_tpu.models import plasma as jplasma
from lbm_tpu.models import plasma3d as jplasma3d
from lbm_tpu_torch import config as tcfg
from lbm_tpu_torch import interop
from lbm_tpu_torch import run_cavity, run_plasma, run_plasma3d
from lbm_tpu_torch.constants import D2Q9, D3Q19
from lbm_tpu_torch.io import checkpoint as ckpt

import torch_dist_ranks as ranks
from torch_parity import assert_close, op_by_op

torch.set_num_threads(1)

RHO_N = tcfg.PlasmaConfig().units().rho_n_init
NP_DTYPES = {"f64": np.float64, "f32": np.float32}


def _bits(x) -> np.ndarray:
    """The raw bits of a torch tensor, a JAX array or a numpy array."""
    if isinstance(x, torch.Tensor):
        x = interop.tensor_to_numpy(x)
    a = np.ascontiguousarray(np.asarray(x))
    return a.view({2: np.uint16, 4: np.uint32, 8: np.uint64}[a.itemsize])


def _dtype_name(x) -> str:
    return (str(x.dtype).split(".")[-1] if isinstance(x, torch.Tensor)
            else str(np.asarray(x).dtype))


def _assert_bitwise(got, want, fields):
    for k in fields:
        g, w = getattr(got, k), getattr(want, k)
        if k == "step":
            assert int(g) == int(w), k
            continue
        assert tuple(g.shape) == tuple(w.shape), k
        assert _dtype_name(g) == _dtype_name(w), k
        np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=k)


def plasma_arrays(grid, dtype, storage, delta, seed, Q=9):
    """Seeded numpy arrays of a PlasmaState (or Plasma3DState: a 3-D grid,
    Q = 19), with populations of the layout's magnitudes: f[2] full
    neutral populations rho_n_init w_i (1 + 1e-3 noise), or their 1e-3
    deltas."""
    rng = np.random.default_rng(seed)
    W = np.asarray(D2Q9.W if Q == 9 else D3Q19.W).reshape(
        (Q,) + (1,) * len(grid))
    noise = rng.standard_normal((3, Q) + grid)
    f = np.stack([W * 1e3 * (1 + 0.1 * noise[0]),
                  W * 1e3 * (1 + 0.1 * noise[1]),
                  W * RHO_N * (1e-3 * noise[2] if delta
                               else 1 + 1e-3 * noise[2])])
    g = W * 50.0 * (1 + 0.1 * rng.standard_normal((3, Q) + grid))
    pop = ml_dtypes.bfloat16 if storage == "bf16" else NP_DTYPES[dtype]
    out = dict(f=f.astype(pop), g=g.astype(pop))
    fields = ("Ex", "Ey", "Ez", "phi") if len(grid) == 3 else ("Ex", "Ey",
                                                                "phi")
    for k in fields:
        out[k] = rng.standard_normal(grid).astype(NP_DTYPES[dtype])
    out["step"] = np.int32(seed % 1000)
    return out


def cavity_arrays(storage, dtype, seed, grid=(16, 16)):
    rng = np.random.default_rng(seed)
    W = np.asarray(D2Q9.W)[:, None, None]
    dev = 1e-3 * rng.standard_normal((9,) + grid)
    f = (dev.astype(ml_dtypes.bfloat16) if storage == "bf16"
         else (W + dev).astype(NP_DTYPES[dtype]))
    cd = np.float32 if storage == "bf16" else NP_DTYPES[dtype]
    out = dict(f=f, rho=(1 + dev[0]).astype(cd),
               ux=dev[1].astype(cd), uy=dev[2].astype(cd))
    out["step"] = np.int32(seed % 1000)
    return out


# (label, grid, compute dtype, storage, neutral delta)
PLASMA_CASES = [("2d-f64-classic", (16, 16), "f64", "native", False),
                ("2d-f64-delta", (16, 16), "f64", "native", True),
                ("2d-f32-delta", (16, 16), "f32", "native", True),
                ("2d-f32-classic", (16, 16), "f32", "native", False),
                ("2d-bf16-delta", (16, 16), "f32", "bf16", True),
                ("3d-f32-delta", (8, 8, 8), "f32", "native", True),
                ("3d-bf16-delta", (8, 8, 8), "f32", "bf16", True),
                ("3d-f64-classic", (8, 8, 8), "f64", "native", False)]


@pytest.mark.parametrize("case", PLASMA_CASES, ids=lambda c: c[0])
def test_plasma_files_cross_both_ways_bitwise(tmp_path, case):
    label, grid, dtype, storage, delta = case
    three = len(grid) == 3
    arrays = plasma_arrays(grid, dtype, storage, delta, seed=len(label),
                           Q=19 if three else 9)
    jcls = jplasma3d.Plasma3DState if three else jplasma.PlasmaState
    jstate = jcls(**{k: jnp.asarray(v) for k, v in arrays.items()})
    tstate = (interop.plasma3d_state_from_numpy if three
              else interop.state_from_numpy)(arrays, "cpu")
    jsave, jload = ((jckpt.save3d, jckpt.load3d) if three
                    else (jckpt.save, jckpt.load))
    tsave, tload = ((ckpt.save3d, ckpt.load3d) if three
                    else (ckpt.save, ckpt.load))
    meta = dict(neutral_delta=delta, storage=storage)
    # JAX writes, the port reads
    jsave(str(tmp_path / "j.npz"), jstate, **meta)
    assert ckpt.load_meta(str(tmp_path / "j.npz")) == meta
    _assert_bitwise(tload(str(tmp_path / "j.npz"), "cpu"), jstate,
                    jcls._fields)
    # the port writes, JAX reads: the same keys, dtypes and bits
    tsave(str(tmp_path / "t.npz"), tstate, **meta)
    assert jckpt.load_meta(str(tmp_path / "t.npz")) == meta
    _assert_bitwise(tstate, jload(str(tmp_path / "t.npz")), jcls._fields)
    with np.load(tmp_path / "j.npz") as zj, np.load(tmp_path / "t.npz") as zt:
        assert sorted(zj.files) == sorted(zt.files)
        for k in zj.files:
            assert zj[k].dtype == zt[k].dtype and zj[k].shape == zt[k].shape
            np.testing.assert_array_equal(zj[k], zt[k], err_msg=k)
        assert zt["step"].dtype == np.int32 and zt["step"].shape == ()
        if storage == "bf16":
            assert zt["f__bf16"].dtype == np.uint16 and "f" not in zt.files


@pytest.mark.parametrize("storage, dtype", [("native", "f64"),
                                            ("native", "f32"),
                                            ("bf16", "f32")])
def test_cavity_files_cross_both_ways_bitwise(tmp_path, storage, dtype):
    arrays = cavity_arrays(storage, dtype, seed=11)
    jstate = jcavity.CavityState(**{k: jnp.asarray(v)
                                    for k, v in arrays.items()})
    tstate = interop.cavity_state_from_numpy(arrays, "cpu")
    jckpt.save_cavity(str(tmp_path / "j.npz"), jstate, storage=storage)
    _assert_bitwise(ckpt.load_cavity(str(tmp_path / "j.npz"), "cpu"), jstate,
                    jcavity.CavityState._fields)
    ckpt.save_cavity(str(tmp_path / "t.npz"), tstate, storage=storage)
    assert jckpt.load_meta(str(tmp_path / "t.npz")) == {"storage": storage}
    _assert_bitwise(tstate, jckpt.load_cavity(str(tmp_path / "t.npz")),
                    jcavity.CavityState._fields)


def test_load_with_dtype_and_schema_checks(tmp_path):
    """An explicit dtype converts every floating field as JAX's load does
    (bf16 widens exactly, f64 rounds to f32 once); the step stays an int;
    a state of the wrong schema is refused."""
    arrays = plasma_arrays((16, 16), "f64", "native", False, seed=5)
    path = str(tmp_path / "s.npz")
    jckpt.save(path, jplasma.PlasmaState(**{k: jnp.asarray(v)
                                            for k, v in arrays.items()}))
    assert ckpt.load_meta(path) == {}
    got = ckpt.load(path, "cpu", dtype=torch.float32)
    want = jckpt.load(path, dtype=jnp.float32)
    _assert_bitwise(got, want, jplasma.PlasmaState._fields)
    assert isinstance(got.step, int)
    bf = plasma_arrays((16, 16), "f32", "bf16", True, seed=6)
    jckpt.save(path, jplasma.PlasmaState(**{k: jnp.asarray(v)
                                            for k, v in bf.items()}))
    _assert_bitwise(ckpt.load(path, "cpu", dtype=torch.float64),
                    jckpt.load(path, dtype=jnp.float64),
                    jplasma.PlasmaState._fields)
    three = interop.plasma3d_state_from_numpy(
        plasma_arrays((4, 4, 4), "f32", "native", True, seed=7, Q=19), "cpu")
    with pytest.raises(ValueError, match="7 fields"):
        ckpt.save(path, three)


def _near_ties(n, seed):
    """float64 values within a float32 ulp of bf16 rounding ties (where
    rounding straight to bf16 and rounding through float32 differ), and
    random ones, over the magnitudes of the neutral channel."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(1, 2, n).astype(ml_dtypes.bfloat16).astype(np.float64)
    ulp = 2.0 ** -7
    tie = base + ulp / 2 + ulp * 2.0 ** -30 * rng.choice([-1, 1], n)
    scale = 2.0 ** rng.integers(-40, 40, n)
    return np.concatenate([tie * scale, rng.standard_normal(n) * scale])


def test_cast_to_bf16_rounds_as_numpy():
    x = _near_ties(20000, seed=3)
    got = ckpt.cast(torch.from_numpy(x), torch.bfloat16)
    np.testing.assert_array_equal(_bits(got),
                                  _bits(x.astype(ml_dtypes.bfloat16)))
    got32 = ckpt.cast(torch.from_numpy(x), torch.float32)
    np.testing.assert_array_equal(_bits(got32), _bits(x.astype(np.float32)))


@pytest.mark.parametrize("grid", [(16, 16), (8, 8, 8)],
                         ids=["2d", "3d"])
@pytest.mark.parametrize("pop", ["f64", "f32", "bf16"])
@pytest.mark.parametrize("to_delta", [True, False],
                         ids=["to_delta", "to_classic"])
def test_convert_neutral_layout_matches_jax(grid, pop, to_delta):
    three = len(grid) == 3
    dtype = "f32" if pop == "bf16" else pop
    arrays = plasma_arrays(grid, dtype, "bf16" if pop == "bf16" else
                           "native", not to_delta, seed=17,
                           Q=19 if three else 9)
    jcls = jplasma3d.Plasma3DState if three else jplasma.PlasmaState
    jstate = jcls(**{k: jnp.asarray(v) for k, v in arrays.items()})
    tstate = (interop.plasma3d_state_from_numpy if three
              else interop.state_from_numpy)(arrays, "cpu")
    want = jckpt.convert_neutral_layout(jstate, to_delta=to_delta,
                                        rho_n_ref=RHO_N)
    got = ckpt.convert_neutral_layout(tstate, to_delta=to_delta,
                                      rho_n_ref=RHO_N)
    _assert_bitwise(got, want, jcls._fields)
    assert got.f.data_ptr() != tstate.f.data_ptr()   # the input stays


# run configurations a checkpoint is resumed into: (neutral delta, storage)
RUNS = [(True, "bf16"), (False, "native")]
# checkpoints: (neutral delta, storage) - every layout x storage crossing
CKPTS = [(False, "native"), (True, "native"), (False, "bf16"), (True, "bf16")]


def _lay(delta, storage):
    return f"{'delta' if delta else 'classic'}-{storage}"


@pytest.mark.parametrize("run", RUNS, ids=lambda r: "run-" + _lay(*r))
@pytest.mark.parametrize("ck", CKPTS, ids=lambda c: "ckpt-" + _lay(*c))
def test_reconcile_resumed_state_matches_jax(tmp_path, ck, run):
    """As the CLIs resume: load at the run's compute dtype (f32), then
    reconcile the neutral layout and the population storage."""
    arrays = plasma_arrays((16, 16), "f32", ck[1], ck[0], seed=23)
    path = str(tmp_path / "c.npz")
    jckpt.save(path, jplasma.PlasmaState(**{k: jnp.asarray(v)
                                            for k, v in arrays.items()}),
               neutral_delta=ck[0], storage=ck[1])
    jc = dataclasses.replace(jcfg.PlasmaConfig(), NX=16, NY=16,
                             dtype=jnp.float32, neutral_delta=run[0],
                             storage=run[1])
    tc = dataclasses.replace(tcfg.PlasmaConfig(), NX=16, NY=16,
                             dtype=torch.float32, neutral_delta=run[0],
                             storage=run[1])
    quiet = dict(log=lambda *a, **k: None)
    want = jckpt.reconcile_resumed_state(
        jckpt.load(path, dtype=jnp.float32), path, jc, **quiet)
    got = ckpt.reconcile_resumed_state(
        ckpt.load(path, "cpu", dtype=torch.float32), path, tc, **quiet)
    _assert_bitwise(got, want, jplasma.PlasmaState._fields)
    assert got.f.dtype == (torch.bfloat16 if run[1] == "bf16"
                           else torch.float32)


def test_reconcile_pre_metadata_needs_a_declared_layout(tmp_path):
    arrays = plasma_arrays((16, 16), "f64", "native", False, seed=29)
    path = str(tmp_path / "old.npz")
    jckpt.save(path, jplasma.PlasmaState(**{k: jnp.asarray(v)
                                            for k, v in arrays.items()}))
    tc = dataclasses.replace(tcfg.PlasmaConfig(), NX=16, NY=16,
                             dtype=torch.float64, neutral_delta=True)
    jc = dataclasses.replace(jcfg.PlasmaConfig(), NX=16, NY=16,
                             dtype=jnp.float64, neutral_delta=True)
    state = ckpt.load(path, "cpu")
    for fn, st, cfg in ((ckpt.reconcile_resumed_state, state, tc),
                        (jckpt.reconcile_resumed_state, jckpt.load(path),
                         jc)):
        with pytest.raises(ValueError, match="predates layout metadata"):
            fn(st, path, cfg)
    got = ckpt.reconcile_resumed_state(state, path, tc,
                                       assume_layout="classic",
                                       log=lambda *a: None)
    want = jckpt.reconcile_resumed_state(jckpt.load(path), path, jc,
                                         assume_layout="classic",
                                         log=lambda *a: None)
    _assert_bitwise(got, want, jplasma.PlasmaState._fields)


# (label, checkpoint storage and dtype, run storage and dtype)
CAVITY_CROSSINGS = [("bf16-to-f32", "bf16", "f32", "native", "f32"),
                    ("bf16-to-f64", "bf16", "f32", "native", "f64"),
                    ("f32-to-bf16", "native", "f32", "bf16", "f32"),
                    ("f64-to-bf16", "native", "f64", "bf16", "f32"),
                    ("f64-to-f32", "native", "f64", "native", "f32")]


@pytest.mark.parametrize("case", CAVITY_CROSSINGS, ids=lambda c: c[0])
def test_reconcile_cavity_state_matches_jax(tmp_path, case):
    _, ck_storage, ck_dtype, storage, dtype = case
    arrays = cavity_arrays(ck_storage, ck_dtype, seed=31)
    path = str(tmp_path / "c.npz")
    jckpt.save_cavity(path, jcavity.CavityState(
        **{k: jnp.asarray(v) for k, v in arrays.items()}), storage=ck_storage)
    jdt = {"f32": jnp.float32, "f64": jnp.float64}[dtype]
    tdt = {"f32": torch.float32, "f64": torch.float64}[dtype]
    want = jckpt.reconcile_cavity_state(
        jckpt.load_cavity(path), path,
        jcfg.CavityConfig(NX=16, NY=16, dtype=jdt, storage=storage))
    got = ckpt.reconcile_cavity_state(
        ckpt.load_cavity(path, "cpu"), path,
        tcfg.CavityConfig(NX=16, NY=16, dtype=tdt, storage=storage))
    _assert_bitwise(got, want, jcavity.CavityState._fields)


def test_with_fresh_phi_stores_the_potential_the_pallas_engine_skips():
    cfg = dataclasses.replace(tcfg.PlasmaConfig(), NX=128, NY=128,
                              dtype=torch.float32, fft_engine="pallas")
    from lbm_tpu_torch.models import plasma
    state = plasma.make_rollout(cfg, 1)(plasma.init_state(cfg, "cpu"))
    fresh = ckpt.with_fresh_phi(cfg, state)
    assert torch.equal(fresh.phi, plasma.reconstruct_phi(cfg, state))
    assert not torch.equal(fresh.phi, state.phi)
    xla = dataclasses.replace(cfg, fft_engine="xla")
    assert ckpt.with_fresh_phi(xla, state) is state


# -- the CLIs ---------------------------------------------------------------

def _final(path, loader):
    return loader(str(path / "final_state.npz"), "cpu")


def _same_files(a, b, loader, fields):
    _assert_bitwise(_final(a, loader), _final(b, loader), fields)


PLASMA_CLI = [("f64", ["--f64"]), ("bf16", ["--storage", "bf16"]),
              ("multistep2", ["--multistep", "2"]),
              ("bounceback", ["--bc", "bounceback", "--poisson", "NONE"])]


@pytest.mark.parametrize("label, flags", PLASMA_CLI,
                         ids=[c[0] for c in PLASMA_CLI])
def test_plasma_cli_resume_is_bitwise(tmp_path, capsys, label, flags):
    base = ["--device", "cpu", "--nx", "16", "--ny", "16", "--no-video",
            "--no-plots", *flags]
    a = run_plasma.main(base + ["--steps", "6", "--out", str(tmp_path / "a")])
    run_plasma.main(base + ["--steps", "4", "--checkpoint-every", "2",
                            "--out", str(tmp_path / "b")])
    assert sorted(p for p in os.listdir(tmp_path / "b") if p.endswith(
        ".npz")) == ["ckpt_000002.npz", "ckpt_000004.npz", "final_state.npz"]
    c = run_plasma.main(base + ["--steps", "6", "--resume",
                                str(tmp_path / "b" / "ckpt_000004.npz"),
                                "--out", str(tmp_path / "c")])
    _same_files(tmp_path / "a", tmp_path / "c", ckpt.load,
                jplasma.PlasmaState._fields)
    assert c["start_step"] == 4 and c["steps"] == 2
    # the resumed run's probe rows are the straight run's last rows
    rows = 2 // (2 if "--multistep" in flags else 1)
    for k, series in a["probes"].items():
        np.testing.assert_array_equal(c["probes"][k], series[-rows:],
                                      err_msg=k)
    out = capsys.readouterr().out
    assert "2 steps from step 4" in out


def test_plasma_cli_step_accounting(tmp_path, capsys):
    """--steps is an absolute target (tests/test_cli3d.py's accounting)."""
    base = ["--device", "cpu", "--nx", "16", "--ny", "16", "--steps", "3",
            "--no-video", "--no-plots"]
    out = str(tmp_path / "run")
    run_plasma.main(base + ["--checkpoint-every", "2", "--out", out])
    assert "16x16, 3 steps" in capsys.readouterr().out
    run_plasma.main(base + ["--resume", os.path.join(out, "ckpt_000002.npz"),
                            "--out", out])
    assert "1 steps from step 2" in capsys.readouterr().out
    s = run_plasma.main(base + ["--resume",
                                os.path.join(out, "final_state.npz"),
                                "--out", out])
    text = capsys.readouterr().out
    assert "nothing to run" in text and "0 steps from step 3" in text
    assert s["steps"] == 0 and s["state"].step == 3
    with open(os.path.join(out, "simulation_time_plasma_details.csv")) as fh:
        assert [r.split(",")[1] for r in fh.read().split()[1:]] == \
            ["3", "1", "0"]


def test_plasma_cli_refuses_what_it_cannot_resume(tmp_path):
    base = ["--device", "cpu", "--nx", "16", "--ny", "16", "--steps", "2",
            "--no-video", "--no-plots"]
    arrays = plasma_arrays((16, 16), "f32", "native", True, seed=41)
    old = str(tmp_path / "old.npz")
    ckpt.save(old, interop.state_from_numpy(arrays, "cpu"))
    with pytest.raises(SystemExit, match="predates layout metadata"):
        run_plasma.main(base + ["--resume", old, "--out", str(tmp_path)])
    s = run_plasma.main(base + ["--steps", "9", "--resume", old,
                                "--assume-ckpt-layout", "delta",
                                "--watchdog-every", "0",
                                "--out", str(tmp_path / "ok")])
    assert s["start_step"] == 41 and s["steps"] == 0
    with pytest.raises(SystemExit, match="grid"):
        run_plasma.main(["--device", "cpu", "--nx", "8", "--ny", "16",
                         "--resume", old, "--out", str(tmp_path)])


def test_plasma3d_cli_resume_and_accounting(tmp_path, capsys):
    base = ["--device", "cpu", "--n", "8", "--nz", "8", "--slice-every", "0"]
    run_plasma3d.main(base + ["--steps", "3", "--out", str(tmp_path / "a")])
    out = str(tmp_path / "b")
    run_plasma3d.main(base + ["--steps", "2", "--checkpoint-every", "2",
                              "--out", out])
    s = run_plasma3d.main(base + ["--steps", "3", "--resume",
                                  os.path.join(out, "ckpt_000002.npz"),
                                  "--out", str(tmp_path / "c")])
    assert s["steps"] == 1 and s["start_step"] == 2
    _same_files(tmp_path / "a", tmp_path / "c", ckpt.load3d,
                jplasma3d.Plasma3DState._fields)
    run_plasma3d.main(base + ["--steps", "3", "--resume",
                              str(tmp_path / "c" / "final_state.npz"),
                              "--out", out])
    text = capsys.readouterr().out
    assert "1 steps from step 2" in text and "nothing to run" in text
    assert "0 steps from step 3" in text


@pytest.mark.parametrize("flags", [[], ["--storage", "bf16"], ["--f64"]],
                         ids=["f32", "bf16", "f64"])
def test_cavity_cli_resume_is_bitwise(tmp_path, flags):
    base = ["--device", "cpu", "--nx", "16", "--no-video", *flags]
    run_cavity.main(base + ["--steps", "20", "--checkpoint-every", "20",
                            "--out", str(tmp_path / "a")])
    run_cavity.main(base + ["--steps", "12", "--checkpoint-every", "6",
                            "--out", str(tmp_path / "b")])
    assert sorted(p for p in os.listdir(tmp_path / "b") if p.endswith(
        ".npz")) == ["ckpt_0000006.npz", "ckpt_0000012.npz",
                     "final_state.npz"]
    s = run_cavity.main(base + ["--steps", "20", "--checkpoint-every", "5",
                                "--resume",
                                str(tmp_path / "b" / "ckpt_0000012.npz"),
                                "--out", str(tmp_path / "c")])
    assert s["start_step"] == 12 and s["steps"] == 8
    _same_files(tmp_path / "a", tmp_path / "c", ckpt.load_cavity,
                jcavity.CavityState._fields)
    # the cadence counts steps done since the start: 5 after step 12
    assert os.path.exists(tmp_path / "c" / "ckpt_0000017.npz")


def test_cavity_cli_resumes_bf16_into_f64_and_refuses_another_grid(tmp_path):
    b = str(tmp_path / "b")
    run_cavity.main(["--device", "cpu", "--nx", "16", "--storage", "bf16",
                     "--steps", "4", "--checkpoint-every", "4", "--no-video",
                     "--out", b])
    s = run_cavity.main(["--device", "cpu", "--nx", "16", "--f64",
                         "--no-video", "--steps", "6", "--resume",
                         os.path.join(b, "final_state.npz"),
                         "--out", str(tmp_path / "c")])
    assert s["state"].f.dtype == torch.float64 and s["finite"]
    with pytest.raises(SystemExit, match="tau depends on NY"):
        run_cavity.main(["--device", "cpu", "--nx", "8", "--resume",
                         os.path.join(b, "final_state.npz"),
                         "--out", str(tmp_path / "d")])


def test_jax_checkpoint_resumed_by_the_port_meets_jax(tmp_path):
    """A JAX f64 state after 2 steps, saved by lbm_tpu, continued 2 steps
    by the port's CLI and by JAX's step run op by op: 1e-12 of scale."""
    jc = dataclasses.replace(jcfg.PlasmaConfig(), NX=16, NY=16,
                             dtype=jnp.float64, backend="jnp",
                             neutral_delta=False)
    step = op_by_op(jplasma.make_step(jc))
    state = jplasma.init_state(jc)
    for _ in range(2):
        state = step(state)
    path = str(tmp_path / "jax.npz")
    jckpt.save(path, state, neutral_delta=False, storage="native")
    for _ in range(2):
        state = step(state)
    s = run_plasma.main(["--device", "cpu", "--nx", "16", "--ny", "16",
                         "--f64", "--steps", "4", "--resume", path,
                         "--no-video", "--no-plots",
                         "--out", str(tmp_path / "port")])
    assert s["start_step"] == 2 and s["state"].step == 4
    for k in ("f", "g", "Ex", "Ey", "phi"):
        assert_close(getattr(s["state"], k), getattr(state, k), rtol=0,
                     atol_rel=1e-12, name=k)


def test_sharded_clis_resume_bitwise_on_two_ranks(tmp_path):
    """--shard 2 on gloo: every rank loads the checkpoint and rank 0 writes
    the gathered state; resumed runs equal straight ones bit for bit, the
    sharded windows equal the single-device CLI's, and a NaN in one rank's
    block raises BlowupError on both ranks at the first check."""
    procs = ranks.Ranks("checkpoint", 2, tmp_path)
    single = run_plasma.main(["--device", "cpu", "--nx", "32", "--ny", "32",
                              "--multistep", "2", "--poisson", "NONE",
                              "--steps", "6", "--no-video", "--no-plots",
                              "--out", str(tmp_path / "one")])
    res = procs.result()       # the ranks ran meanwhile
    for label, *_ in ranks.CHECKPOINT_CLI:
        a = res[label]["_a"]
        _assert_bitwise(res[label]["_c"], a, type(a)._fields)
    assert res["blowup_steps"] == [1, 1]
    _assert_bitwise(res["plasma_windows"]["_a"], single["state"],
                    jplasma.PlasmaState._fields)
