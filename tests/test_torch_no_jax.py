"""lbm_tpu_torch imports and runs without JAX (the GPU machine has none):
every module, the 2-D, multistep, cavity and 3-D CLIs."""
import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = textwrap.dedent("""
    import sys
    sys.modules["jax"] = None          # any `import jax` now raises
    import importlib, pkgutil
    import torch
    torch.set_num_threads(1)
    import lbm_tpu_torch
    for m in pkgutil.walk_packages(lbm_tpu_torch.__path__, "lbm_tpu_torch."):
        importlib.import_module(m.name)
    from lbm_tpu_torch.run_plasma import main
    out = main(["--device", "cpu", "--nx", "16", "--ny", "12", "--steps",
                "2", "--out", sys.argv[1]])
    assert out["finite"] and out["steps"] == 2, out
    out = main(["--device", "cpu", "--nx", "16", "--ny", "12", "--steps",
                "3", "--multistep", "2", "--out", sys.argv[1] + "/ms"])
    assert out["finite"] and out["state"].step == 3, out
    assert out["probes"]["rho_q"].shape == (2, 9), out
    from lbm_tpu_torch.run_cavity import main as cavity_main
    out = cavity_main(["--device", "cpu", "--nx", "16", "--steps", "3",
                       "--out", sys.argv[1] + "/cavity"])
    assert out["finite"] and out["state"].step == 3, out
    from lbm_tpu_torch.run_plasma3d import main as plasma3d_main
    out = plasma3d_main(["--device", "cpu", "--n", "8", "--nz", "4",
                         "--steps", "2", "--slice-every", "2",
                         "--out", sys.argv[1] + "/3d"])
    assert out["finite"] and out["state"].step == 2, out
    for m in ("ops.d3", "models.plasma3d", "kernels.fused_step3d",
              "run_plasma3d"):
        assert "lbm_tpu_torch." + m in sys.modules, m
    assert not any(n == "lbm_tpu" or n.startswith(("lbm_tpu.", "jax."))
                   for n in sys.modules), "JAX or lbm_tpu was imported"
    print("NO_JAX_OK")
""")


def test_port_runs_with_jax_blocked(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", _SCRIPT, str(tmp_path)],
                       cwd=tmp_path, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "NO_JAX_OK" in r.stdout
