#!/usr/bin/env python
"""Split the golden CLI's video cost on one CUDA card: the 2-D CLI at its
golden defaults (200^2 f32, 200 steps, a frame set every step), run in
process with the video off and on, and on with parts of the recorder cut
away, in alternating rounds.

    python scripts/trace_video_torch.py [--rounds N] [--modes a,b,...]
        [--profile]

Modes (MODES below):
  off        --no-video;
  on         the recorder as it is: render, RGB and label strips on the
             device, non_blocking copies into pinned memory, the writer
             thread waiting on the copies' event and writing three AVIs;
  no-write   the same with the AVI writes replaced by no-ops (the thread
             still takes every frame set and waits on its event);
  no-thread  frames rendered, labelled and copied, then dropped on the
             loop's thread: nothing reaches the writer thread;
  render     frames rendered and labelled on the device, no copy;
  switch     "on" with the interpreter's thread switch interval at 0.1 ms
             (sys.setswitchinterval; 5 ms by default) for the run;
  spin       "on" with the copies' event made without blocking sync, so
             that the writer thread's wait spins on a core (the recorder's
             event blocks the thread instead); spin-no-write likewise
             without the writes.
The CPUs this process may use (its affinity and its cgroup's quota) are
printed first. With --profile, each mode also runs once under
torch.profiler (CPU and CUDA activities, every thread) after the rounds,
and the 30 rows of most self CPU time are printed.
Each round runs every mode once, in the given order in odd rounds and
reversed in even ones; the median of each mode's ms a step is printed
beside its runs and its excess over "off". Every run prints the CLI's own
line; --no-plots throughout. Needs no JAX; writes under
build/output/trace_video.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import torch  # noqa: E402

from lbm_tpu_torch import run_plasma  # noqa: E402
from lbm_tpu_torch.io import colormap, video  # noqa: E402

OUT = os.path.join("build", "output", "trace_video")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


@contextlib.contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def _no_write(self, frame):
    pass


def _no_thread(self, panels):
    frames = colormap.frames_of_panels(panels)
    video.to_host([self._label(kind, colormap.expand(frame))
                   for kind, frame in zip(video._LABELS, frames)])


def _to_host_spin(frames):
    host = [torch.empty(f.shape, dtype=f.dtype, pin_memory=True)
            for f in frames]
    for h, f in zip(host, frames):
        h.copy_(f, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done


def _spin():
    return _patched(video, "to_host", _to_host_spin)


@contextlib.contextmanager
def _both(*managers):
    with contextlib.ExitStack() as stack:
        for m in managers:
            stack.enter_context(m())
        yield


def cpu_line() -> str:
    """This process's CPU affinity and its cgroup's CPU quota."""
    quota = "unknown"
    for path in ("/sys/fs/cgroup/cpu.max",
                 "/sys/fs/cgroup/cpu/cpu.cfs_quota_us"):
        try:
            with open(path) as fh:
                quota = f"{path}: {fh.read().strip()}"
            break
        except OSError:
            pass
    return (f"CPUs: os.cpu_count() {os.cpu_count()}, affinity "
            f"{len(os.sched_getaffinity(0))}; {quota}")


def _render(self, panels):
    frames = colormap.frames_of_panels(panels)
    for kind, frame in zip(video._LABELS, frames):
        self._label(kind, colormap.expand(frame))


@contextlib.contextmanager
def _switch(seconds):
    old = sys.getswitchinterval()
    sys.setswitchinterval(seconds)
    try:
        yield
    finally:
        sys.setswitchinterval(old)


MODES = {
    "off": (["--no-video"], contextlib.nullcontext),
    "on": ([], contextlib.nullcontext),
    "no-write": ([], lambda: _patched(video._AviBackend, "write",
                                      _no_write)),
    "no-thread": ([], lambda: _patched(video.VideoRecorder,
                                       "record_panels", _no_thread)),
    "render": ([], lambda: _patched(video.VideoRecorder, "record_panels",
                                    _render)),
    "switch": ([], lambda: _switch(1e-4)),
    "spin": ([], _spin),
    "spin-no-write": ([], lambda: _both(_spin, lambda: _patched(
        video._AviBackend, "write", _no_write))),
}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--modes", default=",".join(MODES))
    p.add_argument("--profile", action="store_true")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("trace_video_torch: needs a CUDA card")
    os.environ["LBM_VIDEO_FORMAT"] = "avi"
    modes = args.modes.split(",")
    card = card_line()
    print(card)
    print(cpu_line())
    # build the kernels and the AVI writer, and warm the caches
    run_plasma.main(["--device", "cuda", "--steps", "20", "--no-plots",
                     "--out", os.path.join(OUT, "warm")])
    ms = {m: [] for m in modes}
    for r in range(args.rounds):
        for m in (modes if r % 2 == 0 else modes[::-1]):
            flags, ctx = MODES[m]
            with ctx():
                s = run_plasma.main(["--device", "cuda", "--no-plots",
                                     "--out", os.path.join(OUT, m)] + flags)
            ms[m].append(s["wall_ms"] / s["steps"])
    off = float(np.median(ms["off"])) if "off" in ms else None
    for m in modes:
        med = float(np.median(ms[m]))
        extra = "" if off is None else f" (+{med - off:.4f} over off)"
        print(f"[{card}] {m}: ms a step {', '.join(f'{v:.4f}' for v in ms[m])}"
              f"; median {med:.4f}{extra}")
    if args.profile:
        from torch.profiler import ProfilerActivity, profile
        for m in modes:
            flags, ctx = MODES[m]
            with ctx(), profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
                s = run_plasma.main(["--device", "cuda", "--no-plots",
                                     "--out", os.path.join(OUT, m)] + flags)
            print(f"== {m} under the profiler: "
                  f"{s['wall_ms'] / s['steps']:.4f} ms a step")
            print(prof.key_averages().table(sort_by="self_cpu_time_total",
                                            row_limit=30))
    return 0


if __name__ == "__main__":
    sys.exit(main())
