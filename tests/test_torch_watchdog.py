"""lbm_tpu_torch.utils.watchdog on the CPU: the cases of tests/test_utils.py
for lbm_tpu.utils.watchdog on the port's states, a bfloat16 state, the
snapshot as a copy, and the plasma CLI's --watchdog-every."""
import dataclasses

import pytest
import torch

from lbm_tpu_torch import run_plasma
from lbm_tpu_torch.config import PlasmaConfig
from lbm_tpu_torch.io import checkpoint
from lbm_tpu_torch.models import plasma
from lbm_tpu_torch.utils import watchdog

torch.set_num_threads(1)


def _state(with_nan=False, storage="native", field="f", value=float("nan")):
    cfg = dataclasses.replace(
        PlasmaConfig(), NX=8, NY=8, storage=storage,
        dtype=torch.float32 if storage == "bf16" else torch.float64)
    s = plasma.init_state(cfg, "cpu")
    if with_nan:
        t = getattr(s, field).clone()
        t.view(-1)[0] = value
        s = s._replace(**{field: t})
    return s


def test_state_is_finite():
    assert watchdog.state_is_finite(_state())
    assert not watchdog.state_is_finite(_state(with_nan=True))


@pytest.mark.parametrize("field, value", [("f", float("nan")),
                                          ("g", float("inf")),
                                          ("Ey", -float("inf")),
                                          ("phi", float("nan"))])
def test_bf16_states_are_checked_in_every_field(field, value):
    good = _state(storage="bf16")
    assert good.f.dtype == torch.bfloat16
    assert watchdog.state_is_finite(good)
    bad = _state(True, "bf16", field, value)
    flag = watchdog.finite_reduction(bad)
    assert flag.dtype == torch.bool and flag.dim() == 0 and not bool(flag)


def test_large_finite_values_stay_finite():
    """float64 values past float32's range are finite, and so are the
    state's extremes (the reduction widens them to float64)."""
    s = _state(True, "native", "phi", 1e300)
    assert watchdog.state_is_finite(s)
    assert not watchdog.state_is_finite(_state(True, "native", "Ex",
                                               float("inf")))


def test_watchdog_raises():
    wd = watchdog.Watchdog(every=1)
    good = _state()
    assert wd.check(0, good) is good
    with pytest.raises(watchdog.BlowupError) as e:
        wd.check(1, _state(with_nan=True))
    assert e.value.step == 1


def test_watchdog_rollback_hands_out_copies():
    """The snapshot survives a step that writes into its input's buffers,
    and every rollback hands out a fresh copy."""
    wd = watchdog.Watchdog(every=1, keep_snapshot=True, on_blowup="rollback")
    good = _state()
    want = good.f.clone()
    wd.check(0, good)
    good.f.fill_(float("nan"))          # an in-place step
    back = wd.check(1, _state(with_nan=True))
    assert torch.equal(back.f, want) and back.step == 0
    back.f.fill_(float("nan"))
    again = wd.check(2, _state(with_nan=True))
    assert torch.equal(again.f, want)
    assert again.f.data_ptr() != back.f.data_ptr()


def test_watchdog_cadence():
    wd = watchdog.Watchdog(every=10)
    bad = _state(with_nan=True)
    # off-cadence steps are not checked
    assert wd.check(0, bad) is bad
    with pytest.raises(watchdog.BlowupError):
        wd.check(9, bad)  # (9+1) % 10 == 0


def test_cli_watchdog_raises_at_its_first_check(tmp_path):
    """A NaN in g of a resumed state: --watchdog-every 2 raises at the
    loop's t = 1 (the first (t + 1) % 2 == 0), 0 turns the guard off."""
    s = _state()
    g = s.g.clone()
    g[0, 0, 3, 3] = float("nan")
    path = str(tmp_path / "nan.npz")
    checkpoint.save(path, s._replace(g=g), neutral_delta=False,
                    storage="native")
    base = ["--device", "cpu", "--nx", "8", "--ny", "8", "--f64", "--steps",
            "4", "--resume", path, "--no-video", "--no-plots"]
    with pytest.raises(watchdog.BlowupError) as e:
        run_plasma.main(base + ["--watchdog-every", "2",
                                "--out", str(tmp_path / "a")])
    assert e.value.step == 1
    out = run_plasma.main(base + ["--watchdog-every", "0",
                                  "--out", str(tmp_path / "b")])
    assert out["steps"] == 4 and not out["finite"]


def _checks(every, k, steps):
    """The window starts t at which Watchdog(every).check(t, bad, k)
    checks, over `steps` steps in windows of k."""
    wd = watchdog.Watchdog(every=every)
    bad = _state(with_nan=True)
    fired = []
    for t in range(0, steps, k):
        try:
            wd.check(t, bad, min(k, steps - t))
        except watchdog.BlowupError as e:
            assert e.step == t + min(k, steps - t) - 1
            fired.append(t)
    return fired


@pytest.mark.parametrize("every", [1, 2, 3, 10, 100])
def test_per_step_checks_are_the_jax_cadence(every):
    """k = 1 checks exactly where the JAX package's (t + 1) % every == 0
    does."""
    assert _checks(every, 1, 250) == [t for t in range(250)
                                      if (t + 1) % every == 0]


@pytest.mark.parametrize("every, k, steps, want", [
    (4, 2, 10, [2, 6]),           # windows [2, 4), [6, 8) reach 4 and 8
    (100, 8, 200, [96, 192]),     # the golden --multistep 8 run
    (100, 1, 200, [99, 199]),
    (3, 2, 9, [2, 4, 8]),         # odd cadence: 3, 6 and 9 crossed
    (10, 4, 10, [8]),             # a short last window that reaches 10
])
def test_windows_check_where_they_cross_the_cadence(every, k, steps, want):
    """A window [t, t + k) is checked when t + j, 1 <= j <= k, is a
    multiple of every. The rule before the repair, (t + 1) % every == 0 on
    the window's first step, never fires under an even k and cadence."""
    assert _checks(every, k, steps) == want
    if k % 2 == 0 and every % 2 == 0:
        assert not any((t + 1) % every == 0 for t in range(0, steps, k))


def test_cli_watchdog_checks_under_even_multistep(tmp_path):
    """--multistep 2 --watchdog-every 4 on a state holding a NaN: the
    window [2, 4) reaches step 4 and raises (its last step, 3)."""
    s = _state()
    g = s.g.clone()
    g[0, 0, 3, 3] = float("nan")
    path = str(tmp_path / "nan.npz")
    checkpoint.save(path, s._replace(g=g), neutral_delta=False,
                    storage="native")
    with pytest.raises(watchdog.BlowupError) as e:
        run_plasma.main(["--device", "cpu", "--nx", "8", "--ny", "8",
                         "--f64", "--steps", "8", "--multistep", "2",
                         "--watchdog-every", "4", "--resume", path,
                         "--no-video", "--no-plots",
                         "--out", str(tmp_path / "a")])
    assert e.value.step == 3
