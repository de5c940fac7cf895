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
            "4", "--resume", path]
    with pytest.raises(watchdog.BlowupError) as e:
        run_plasma.main(base + ["--watchdog-every", "2",
                                "--out", str(tmp_path / "a")])
    assert e.value.step == 1
    out = run_plasma.main(base + ["--watchdog-every", "0",
                                  "--out", str(tmp_path / "b")])
    assert out["steps"] == 4 and not out["finite"]
