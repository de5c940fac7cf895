"""Asynchronous video recording (counterpart of lbm_tpu/io/video.py): the
device renders, a host thread encodes, and the step loop never waits on a
copy.

record() renders the three palette-index frames on the fields' device
(io/colormap), expands them through JET_PALETTE there and puts a label
strip above each row of tiles (the strips are copied to the device once),
so the frames leave the device whole; on a GPU it starts non_blocking
copies of them into pinned host buffers and records a CUDA event behind
the copies. The worker thread waits on that event and writes the frames.
FrameQueue is that hand-over for any writers: the recorder's three
streams, the cavity CLI's one.
(lbm_tpu's recorder copies the index frames, a third of the bytes, and
expands and labels them on the host thread, which at the golden 200^2
takes that thread longer than a step on the H100's host; PERF.md §6.)
The queue between the two holds at most 8 frames, so a slow encoder slows
the loop rather than filling memory.

Writer backends, in preference order (open_writer prints which one it
took):
  1. OpenCV mp4v MP4, the reference's format (src/visualize.cpp:26-28);
  2. the native uncompressed AVI (io/avi: native/aviwriter.cpp built with
     g++; no Python imaging library);
  3. animated GIF through PIL.
LBM_VIDEO_FORMAT=avi skips the MP4 backend, =gif the MP4 and the AVI
ones. Where none can be opened, open_writer raises and names what is
missing. The label strips name each tile and its fixed range over a JET
colourbar; their text is drawn with PIL, and where PIL is absent (the
card's machine) a strip keeps its size and its colourbar and its text
stays blank.
"""
from __future__ import annotations

import os
import queue
import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from . import avi, colormap


class _Mp4Backend:
    """MP4 via OpenCV's mp4v codec (matches the reference's writers)."""

    name = "mp4v (cv2)"

    def __init__(self, path: str, width: int, height: int, fps: int):
        import cv2

        self.path = os.path.splitext(path)[0] + ".mp4"
        self._w = cv2.VideoWriter(
            self.path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (width, height))
        if not self._w.isOpened():
            raise RuntimeError(f"cv2.VideoWriter cannot open {self.path}")

    def write(self, frame: np.ndarray) -> None:
        """frame: (H, W, 3) uint8 RGB (cv2 wants BGR)."""
        self._w.write(np.ascontiguousarray(frame[..., ::-1]))

    def close(self) -> None:
        self._w.release()


class _AviBackend(avi.AviWriter):
    name = "native AVI"


class _GifBackend:
    name = "GIF (PIL)"

    def __init__(self, path: str, fps: int):
        from PIL import Image  # noqa: F401  (fail here, not at close)

        self.path = os.path.splitext(path)[0] + ".gif"
        self.fps = fps
        self.frames: List[np.ndarray] = []

    def write(self, frame: np.ndarray) -> None:
        self.frames.append(frame)

    def close(self) -> None:
        if not self.frames:
            return
        from PIL import Image

        imgs = [Image.fromarray(f) for f in self.frames]
        imgs[0].save(self.path, save_all=True, append_images=imgs[1:],
                     duration=int(1000 / self.fps), loop=0)


def open_writer(path: str, width: int, height: int, fps: int, log=print):
    """The first backend that opens, in the module's order; .path is the
    file it writes (the extension follows the backend)."""
    fmt = os.environ.get("LBM_VIDEO_FORMAT", "mp4")
    missing = []
    if fmt == "mp4":
        try:
            w = _Mp4Backend(path, width, height, fps)
        except (ImportError, RuntimeError) as e:
            missing.append(f"mp4v: {e}")
        else:
            log(f"video: {w.name} writer, {w.path}")
            return w
    if fmt != "gif":
        try:
            w = _AviBackend(path, width, height, fps)
        except (avi.AviBuildError, OSError) as e:
            missing.append(f"native AVI: {e}")
        else:
            log(f"video: {w.name} writer, {w.path}")
            return w
    try:
        w = _GifBackend(path, fps)
    except ImportError as e:
        missing.append(f"GIF: {e}")
    else:
        log(f"video: {w.name} writer, {w.path}"
            + "".join(f" ({m.splitlines()[0]})" for m in missing))
        return w
    raise RuntimeError(f"no video writer opens {path} (LBM_VIDEO_FORMAT="
                       f"{fmt}): " + "; ".join(missing))


_LABELS = {
    "density": [["rho_e", "rho_q", "rho_i"]],
    "velocity": [["ux_e", "uy_e", "|u_e|"], ["ux_i", "uy_i", "|u_i|"]],
    "temperature": [["T_e", "T_i", "T_n"]],
}
_LABEL_H = 30  # pixels per label strip (name + value legend + colorbar)

# panel label -> io.colormap.RANGES key where they differ
_RANGE_KEYS = {"|u_e|": "u_mag_e", "|u_i|": "u_mag_i"}


def _fmt_value(v: float) -> str:
    """Compact legend number: fixed-point when readable, scientific for
    the tiny fixed ranges (|u| <= 1e-7)."""
    if v == 0:
        return "0"
    a = abs(v)
    return f"{v:.2f}" if 0.01 <= a < 1000 else f"{v:.0e}"


def _label_strip(labels, width: int) -> np.ndarray:
    """A strip naming each panel with its fixed range (min | mid | max) over
    a JET colorbar, as lbm_tpu/io/video.py:103-131 draws it. The text needs
    PIL; without it the strip keeps its background and its colorbars."""
    arr = np.empty((_LABEL_H, width, 3), np.uint8)
    arr[...] = (32, 32, 32)
    panel_w = width // len(labels)
    try:
        from PIL import Image, ImageDraw
    except ImportError:
        pass
    else:
        img = Image.fromarray(arr)
        d = ImageDraw.Draw(img)
        for i, text in enumerate(labels):
            vmin, vmax = colormap.RANGES[_RANGE_KEYS.get(text, text)]
            mid = 0.5 * (vmin + vmax)
            d.text((i * panel_w + 4, 0), text, fill=(255, 255, 255))
            d.text((i * panel_w + 4, 11),
                   f"{_fmt_value(vmin)} | {_fmt_value(mid)} | "
                   f"{_fmt_value(vmax)}", fill=(200, 200, 200))
        arr = np.asarray(img).copy()
    # horizontal JET colorbar (min -> max) along the bottom of each panel
    pal = colormap.JET_PALETTE
    for i in range(len(labels)):
        x0, x1 = i * panel_w + 4, min((i + 1) * panel_w - 4, width)
        if x1 - x0 > 8:
            idx = np.linspace(0.0, 255.0, x1 - x0).astype(np.uint8)
            arr[_LABEL_H - 6:_LABEL_H - 2, x0:x1] = pal[idx]
    return arr


def to_host(frames):
    """Start the host copies of device frames: (host tensors, event or
    None). On a GPU the copies go non_blocking into pinned buffers and the
    event marks their end; the caller's thread does not wait. CPU frames
    are handed over as they are."""
    if frames[0].device.type != "cuda":
        return list(frames), None
    host = [torch.empty(f.shape, dtype=f.dtype, pin_memory=True)
            for f in frames]
    for h, f in zip(host, frames):
        h.copy_(f, non_blocking=True)
    # a blocking-sync event: the thread that waits on it sleeps instead of
    # spinning on a core that the step loop may need
    done = torch.cuda.Event(blocking=True)
    done.record()
    return host, done


def from_host(item) -> List[np.ndarray]:
    """to_host's frames as numpy arrays, once their copies have ended."""
    host, done = item
    if done is not None:
        done.synchronize()
    return [h.numpy() for h in host]


class FrameQueue:
    """Writers fed by a host thread behind a queue of at most 8 frame
    sets. put(frames) starts the copies of device frames to the host
    (to_host) and returns; the thread waits for them and writes frame i
    through writer i. A writer's error is raised by close()."""

    def __init__(self, writers):
        self._writers = list(writers)
        self._q: "queue.Queue" = queue.Queue(maxsize=8)
        self._err: Optional[BaseException] = None
        self._worker = threading.Thread(target=self._drain, daemon=True)
        self._worker.start()

    def _drain(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            if self._err is not None:
                continue
            try:
                for w, frame in zip(self._writers, from_host(item)):
                    w.write(frame)
            except Exception as e:  # surfaced on close()
                self._err = e

    def put(self, frames) -> None:
        """frames: one (H, W, 3) uint8 RGB tensor a writer, on any
        device."""
        self._q.put(to_host(frames))

    def close(self) -> None:
        self._q.put(None)
        self._worker.join()
        for w in self._writers:
            w.close()
        if self._err is not None:
            raise self._err

    @property
    def paths(self) -> List[str]:
        return [w.path for w in self._writers]


class VideoRecorder:
    """Three-stream recorder (density / velocity / temperature).

    record(mac) renders a Macros' frames on its device, labels them there
    and hands them to a FrameQueue; record_panels takes
    colormap.index_panels' (12, NY, NX) tiles (rank 0 of a sharded run,
    after it gathered every block's).
    """

    def __init__(self, out_dir: str, NX: int, NY: int, fps: int = 1,
                 log=print):
        # fps=1 replicates the reference's writers (src/visualize.cpp:57)
        os.makedirs(out_dir, exist_ok=True)
        h_lbl = _LABEL_H
        sizes = {"density": (3 * NX, NY + h_lbl),
                 "velocity": (3 * NX, 2 * (NY + h_lbl)),
                 "temperature": (3 * NX, NY + h_lbl)}
        self._writers = {}
        try:
            for k, (w, h) in sizes.items():
                self._writers[k] = open_writer(
                    os.path.join(out_dir, f"video_{k}.avi"), w, h, fps,
                    log=log if not self._writers else (lambda *a: None))
        except BaseException:
            for w in self._writers.values():
                w.close()
            raise
        # backends may rewrite the extension (.mp4 / .gif)
        self._paths = {k: w.path for k, w in self._writers.items()}
        try:
            import PIL  # noqa: F401
        except ImportError:
            log("video: PIL is absent; the label strips keep their "
                "colorbars and carry no text")
        self._strips = {k: [torch.from_numpy(_label_strip(row, 3 * NX))
                            for row in rows]
                        for k, rows in _LABELS.items()}
        self._ny = NY
        self._out = FrameQueue(self._writers[k] for k in _LABELS)

    def _label(self, kind: str, rgb: torch.Tensor) -> torch.Tensor:
        """Interleave a label strip above each row of panels, on rgb's
        device (the strips move there once)."""
        strips = self._strips[kind]
        if strips[0].device != rgb.device:
            strips = self._strips[kind] = [t.to(rgb.device) for t in strips]
        rows = []
        for r, strip in enumerate(strips):
            rows.append(strip)
            rows.append(rgb[r * self._ny: (r + 1) * self._ny])
        return torch.cat(rows, dim=0)

    def record(self, mac) -> None:
        """mac: lbm_tpu_torch.ops.macros.Macros (tensors on any device)."""
        self.record_panels(colormap.index_panels(
            *colormap.macro_fields(mac)))

    def record_panels(self, panels: torch.Tensor) -> None:
        frames = colormap.frames_of_panels(panels)
        self._out.put([self._label(kind, colormap.expand(frame))
                       for kind, frame in zip(_LABELS, frames)])

    def close(self) -> None:
        self._out.close()

    @property
    def paths(self) -> Dict[str, str]:
        return dict(self._paths)
