"""NaN / blow-up watchdog (counterpart of lbm_tpu/utils/watchdog.py).

The reference's only failure handling is algebraic guards inside its macro
update and the cavity's tau auto-resize. Here a watchdog checks the state
for non-finite values on a cadence and either raises (fail fast) or rolls
back to the last good snapshot. On a sharded run every rank holds a block
of the lattice: the finite flag is all-reduced (MIN) over the group before
any rank decides, so all ranks raise or roll back together.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist


class BlowupError(RuntimeError):
    def __init__(self, step: int, what: str):
        super().__init__(f"non-finite {what} detected at step {step}")
        self.step = step


def finite_reduction(state) -> torch.Tensor:
    """A 0-dim bool tensor on the state's device: every element of every
    floating tensor of the state (bfloat16 storage included) is finite.
    One pass over each tensor: its min and max, which a NaN anywhere makes
    NaN and an infinity makes infinite, then one isfinite over those
    extremes (widened to float64, exactly). Non-tensor fields (the host
    step counter) are skipped."""
    ends = [end.double() for t in state
            if isinstance(t, torch.Tensor) and t.is_floating_point()
            for end in torch.aminmax(t)]
    return torch.isfinite(torch.stack(ends)).all()


def state_is_finite(state, group: Optional[dist.ProcessGroup] = None
                    ) -> bool:
    """finite_reduction read on the host; with a process group, the MIN of
    every rank's flag (each rank holds its block of the state)."""
    flag = finite_reduction(state)
    if group is not None:
        flag = flag.to(torch.int32)
        dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=group)
    return bool(flag)


def _copy(state):
    """A copy of every tensor of the state: a step that writes into its
    input's buffers must not overwrite a snapshot."""
    return type(state)(*(t.clone() if isinstance(t, torch.Tensor) else t
                         for t in state))


class Watchdog:
    """Check every `every` steps; keep a good snapshot for rollback.

    >>> wd = Watchdog(every=50, keep_snapshot=True)
    >>> for t in range(nsteps):
    ...     state = step(state)
    ...     state = wd.check(t, state)   # may raise or roll back

    A loop that advances k steps at a time (K-step windows) passes the
    window's first step t and its length k: the check runs when the step
    count crosses a multiple of `every` inside the window, some t + j with
    1 <= j <= k. For k = 1 that is the JAX package's test,
    (t + 1) % every == 0; its CLI passes only t, so under an even K with an
    even cadence it never checks. A BlowupError names the window's last
    step, t + k - 1 (t itself per step).
    """

    def __init__(self, every: int = 100, keep_snapshot: bool = False,
                 on_blowup: str = "raise",
                 group: Optional[dist.ProcessGroup] = None):
        assert on_blowup in ("raise", "rollback")
        self.every = max(every, 1)
        self.keep_snapshot = keep_snapshot
        self.on_blowup = on_blowup
        self.group = group
        self._good = None
        self._good_step: Optional[int] = None

    def check(self, t: int, state, k: int = 1):
        if (t + k) // self.every <= t // self.every:
            return state
        if state_is_finite(state, self.group):
            if self.keep_snapshot:
                self._good = _copy(state)
                self._good_step = t + k - 1
            return state
        if self.on_blowup == "rollback" and self._good is not None:
            # hand out a copy, so that a second rollback still has one
            return _copy(self._good)
        raise BlowupError(t + k - 1, "simulation state")
