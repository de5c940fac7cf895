"""--profile DIR of the CLIs: a torch.profiler trace of the timed loop
(the counterpart of scripts/run_plasma.py's jax.profiler trace).

    with profile.trace(args.profile, device, rank):
        ...   # the timed loop, synchronised before the block ends

records CPU and, on a CUDA device, CUDA activity (the hand-written kernels
included: they launch through the CUDA runtime), and writes one Chrome
trace a rank, DIR/trace_rank<rank>.json, when the block ends. With no DIR
it records nothing.
"""
from __future__ import annotations

import contextlib
import os
from typing import Iterator, Optional

import torch


def trace_path(out_dir: str, rank: int = 0) -> str:
    return os.path.join(out_dir, f"trace_rank{rank}.json")


@contextlib.contextmanager
def trace(out_dir: Optional[str], device: torch.device,
          rank: int = 0) -> Iterator[None]:
    if not out_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(out_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(trace_path(out_dir, rank))
