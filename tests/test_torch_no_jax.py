"""lbm_tpu_torch imports and runs without JAX and without ml_dtypes, and
renders its videos without cv2, PIL and matplotlib (the GPU machine has
none of them): every module, the 2-D, multistep, debug-dump, cavity and
3-D CLIs with their videos, plots and slices on (the native AVI writer;
the plots and PNG slices skipped with a message), a bf16 checkpoint and
its resume, the watchdog, scripts/measure_drift_torch.py, the sharded
cavity and 3-D window CLIs on a one-rank gloo group, and the Re sweep
(scripts/validate_cavity_re_torch.py, which leaves the JAX script's
tables alone)."""
import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = textwrap.dedent("""
    import sys
    sys.modules["jax"] = None          # any `import jax` now raises
    sys.modules["ml_dtypes"] = None
    for name in ("cv2", "PIL", "matplotlib"):
        sys.modules[name] = None
    import importlib, pkgutil
    import torch
    torch.set_num_threads(1)
    import lbm_tpu_torch
    for m in pkgutil.walk_packages(lbm_tpu_torch.__path__, "lbm_tpu_torch."):
        importlib.import_module(m.name)
    from lbm_tpu_torch.run_plasma import main
    from lbm_tpu_torch.io.avi import read_frames
    out = main(["--device", "cpu", "--nx", "16", "--ny", "12", "--steps",
                "2", "--out", sys.argv[1]])
    assert out["finite"] and out["steps"] == 2, out
    shapes = {k: read_frames(p).shape for k, p in out["video"].items()}
    assert shapes == {"density": (2, 42, 48, 3), "velocity": (2, 84, 48, 3),
                      "temperature": (2, 42, 48, 3)}, shapes
    import os
    assert os.path.exists(sys.argv[1] + "/graphs/ts_rho_q.csv")
    assert not os.path.exists(sys.argv[1] + "/graphs/plot_rho_q.png")
    out = main(["--device", "cpu", "--nx", "16", "--ny", "12", "--steps",
                "2", "--storage", "bf16", "--checkpoint-every", "1",
                "--no-video", "--no-plots", "--out", sys.argv[1] + "/bf16"])
    again = main(["--device", "cpu", "--nx", "16", "--ny", "12", "--steps",
                  "2", "--storage", "bf16", "--no-video", "--no-plots",
                  "--resume",
                  sys.argv[1] + "/bf16/ckpt_000001.npz",
                  "--out", sys.argv[1] + "/bf16_resumed"])
    assert torch.equal(again["state"].f, out["state"].f), "bf16 resume"
    sys.path.insert(0, sys.argv[2])
    import measure_drift_torch
    drift = measure_drift_torch.main(["--device", "cpu", "--n", "16",
                                      "--steps", "2"])
    assert set(drift) == set(measure_drift_torch.COLUMNS), drift
    out = main(["--device", "cpu", "--nx", "16", "--ny", "12", "--steps",
                "3", "--multistep", "2", "--out", sys.argv[1] + "/ms"])
    assert out["finite"] and out["state"].step == 3, out
    assert out["probes"]["rho_q"].shape == (2, 9), out
    assert read_frames(out["video"]["density"]).shape[0] == 2
    from lbm_tpu_torch.run_cavity import main as cavity_main
    out = cavity_main(["--device", "cpu", "--nx", "16", "--steps", "3",
                       "--video-every", "1", "--out", sys.argv[1] + "/cavity"])
    assert out["finite"] and out["state"].step == 3, out
    assert read_frames(out["video"]).shape == (3, 16, 16, 3), out["video"]
    from lbm_tpu_torch.run_plasma3d import main as plasma3d_main
    out = plasma3d_main(["--device", "cpu", "--n", "8", "--nz", "4",
                         "--steps", "2", "--slice-every", "2",
                         "--out", sys.argv[1] + "/3d"])
    assert out["finite"] and out["state"].step == 2, out
    assert os.path.exists(sys.argv[1] + "/3d/slice_00002.npz")
    assert not os.path.exists(sys.argv[1] + "/3d/slice_00002.png")
    out = main(["--device", "cpu", "--f64", "--nx", "8", "--ny", "8",
                "--steps", "2", "--poisson", "FFT", "--debug-variant",
                "--debug-dump", "--no-video", "--no-plots",
                "--out", sys.argv[1] + "/dbg"])
    assert out["finite"] and out["state"].step == 2, out
    with open(sys.argv[1] + "/dbg/debug_dump.txt") as fh:
        assert fh.read().count("stage = ") == 10
    import torch.distributed as dist
    from lbm_tpu_torch.parallel import mesh as pmesh
    pmesh.init_distributed("cpu", init_method="file://" + sys.argv[1]
                           + "/store", rank=0, world_size=1)
    for flags in ([], ["--lean"], ["--multistep", "2"]):
        out = cavity_main(["--device", "cpu", "--shard", "1", "--nx", "16",
                           "--steps", "3", "--video-every", "1", "--out",
                           sys.argv[1] + "/shard"] + flags)
        assert out["finite"] and out["state"].step == 3, out
        assert read_frames(out["video"]).shape == (3, 16, 16, 3), flags
    out = plasma3d_main(["--device", "cpu", "--shard", "1", "--multistep",
                         "2", "--poisson", "NONE", "--n", "8", "--nz", "4",
                         "--steps", "3", "--out", sys.argv[1] + "/3d_shard"])
    assert out["finite"] and out["state"].step == 3, out
    dist.destroy_process_group()
    import validate_cavity_re_torch
    import visualize_fields_torch  # noqa: F401
    sweep = validate_cavity_re_torch.main([
        "--device", "cpu", "--nx", "16", "--chunk", "10", "--max-steps",
        "20", "--re", "400", "--out", sys.argv[1] + "/re"])
    assert sweep["errors_vs_ghia"][400]["steps"] == 20, sweep
    assert "validate_cavity_re" not in sys.modules
    for m in ("ops.d3", "models.plasma3d", "kernels.fused_step3d",
              "run_plasma3d", "kernels.fft_tpu", "models.plasma_staged",
              "io.debug_dump", "parallel.mesh", "parallel.sharding",
              "parallel.poisson", "parallel.fused_sharded",
              "kernels.fused_cavity", "run_cavity", "kernels.fused_panel3d",
              "io.checkpoint", "io.profile", "utils.watchdog",
              "io.colormap", "io.video", "io.avi"):
        assert "lbm_tpu_torch." + m in sys.modules, m
    assert not any(n == "lbm_tpu" or n.startswith(("lbm_tpu.", "jax.",
                                                   "ml_dtypes.", "cv2.",
                                                   "PIL.", "matplotlib."))
                   for n in sys.modules), "JAX, ml_dtypes, an imaging " \
        "library or lbm_tpu came in"
    print("NO_JAX_OK")
""")


def test_port_runs_with_jax_blocked(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", _SCRIPT, str(tmp_path),
                        os.path.join(REPO, "scripts")],
                       cwd=tmp_path, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "NO_JAX_OK" in r.stdout
