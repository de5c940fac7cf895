"""scripts/validate_cavity_re_torch.py on the CPU against the JAX package's
cavity rollout: at 24^2, Re 100, 300 steps in chunks of 100, the Ghia
stations' values agree within 1e-5 of u_lid, and summary.json has the
schema of artifacts/cavity_re/summary.json."""
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from lbm_tpu.config import CavityConfig
from lbm_tpu.models import cavity

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
torch.set_num_threads(1)
sys.path.insert(0, os.path.join(REPO, "scripts"))
import validate_cavity_re_torch as sweep  # noqa: E402


def test_sweep_matches_jax_rollout(tmp_path):
    out = sweep.main(["--device", "cpu", "--nx", "24", "--chunk", "100",
                      "--max-steps", "300", "--re", "100", "--out",
                      str(tmp_path)])
    r = out["errors_vs_ghia"][100]
    assert r["steps"] == 300 and out["backend"] == "plain"
    cfg = CavityConfig(NX=24, NY=24, u_lid=0.1, Re=100.0, nsteps=0,
                       dtype=jnp.float32, backend="jnp")
    s = jax.jit(cavity.make_rollout(cfg, 300))(cavity.init_state(cfg))
    (yp, up), (xp, vp) = cavity.centerline_profiles(s, cfg.u_lid)
    want = np.concatenate([np.interp(cavity.GHIA_Y, yp, up),
                           np.interp(cavity.GHIA_X, xp, vp)])
    got = np.array([st["sim"] for st in r["stations"]])
    assert np.abs(got - want).max() <= 1e-5
    with open(tmp_path / "summary.json") as fh:
        mine = json.load(fh)
    with open(os.path.join(REPO, "artifacts", "cavity_re",
                           "summary.json")) as fh:
        ref = json.load(fh)
    assert set(ref) <= set(mine)
    assert set(ref["errors_vs_ghia"]["100"]) <= set(
        mine["errors_vs_ghia"]["100"])
    assert [(st["axis"], st["pos"]) for st in
            mine["errors_vs_ghia"]["100"]["stations"]] == [
        (st["axis"], st["pos"]) for st in
        ref["errors_vs_ghia"]["100"]["stations"]]
    assert os.path.exists(tmp_path / "ghia_re100.png")


def test_ghia_tables_equal_the_jax_scripts():
    """The port's copies of Ghia's columns and of the suspected misprint
    equal scripts/validate_cavity_re.py's and lbm_tpu's Re 100 columns."""
    import validate_cavity_re as jax_sweep
    from lbm_tpu_torch.models import cavity as tcav

    for name in ("GHIA_Y", "GHIA_X", "GHIA_U_RE100", "GHIA_V_RE100"):
        np.testing.assert_array_equal(getattr(tcav, name),
                                      getattr(cavity, name), err_msg=name)
    for name in ("GHIA_U", "GHIA_V"):
        mine, want = getattr(tcav, name), getattr(jax_sweep, name)
        assert set(mine) == set(want), name
        for re_n in want:
            np.testing.assert_array_equal(mine[re_n], want[re_n],
                                          err_msg=f"{name}[{re_n}]")
    assert tcav.SUSPECT == jax_sweep.SUSPECT
