"""The native uncompressed-AVI writer, bound by ctypes (counterpart of
lbm_tpu/io/avi.py), and a numpy reader of the files it writes.

native/aviwriter.cpp has no dependency beyond the C++ standard library, so
it writes the port's videos on a machine without cv2 or PIL (the card's).
It is compiled with g++ at first use (the flags of native/Makefile) into
build/torch_kernels/aviwriter/<hash>/libaviwriter.so under the repository
root, keyed by a hash of the source and the flags; the JAX binding's
native/libaviwriter.so is left alone. A build that fails raises
AviBuildError with the compiler's output.

read_frames parses the writer's RIFF layout (a 'movi' list of '00db'
chunks: bottom-up BGR rows padded to 4 bytes, the layout
tests/test_io.py:48-76 checks) back into top-down RGB frames.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import struct
import subprocess
import tempfile
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[2]
SOURCE = REPO / "native" / "aviwriter.cpp"
BUILD_ROOT = REPO / "build" / "torch_kernels" / "aviwriter"
CXXFLAGS = ["-O2", "-Wall", "-Wextra", "-std=c++17", "-fPIC", "-shared"]


class AviBuildError(RuntimeError):
    """No C++ compiler, or it refused native/aviwriter.cpp."""


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXXFLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / "libaviwriter.so"


def build() -> Path:
    """The shared library, compiled unless it is there. Concurrent builds
    (test workers) each compile into a file of their own and rename it into
    place, so a reader never sees half a library."""
    lib = library_path()
    if lib.exists():
        return lib
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise AviBuildError("no C++ compiler (g++ or $CXX) to build "
                            f"{SOURCE.relative_to(REPO)}")
    lib.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=lib.parent)
    os.close(fd)
    try:
        r = subprocess.run([cxx, *CXXFLAGS, "-o", tmp, str(SOURCE)],
                           capture_output=True, text=True, timeout=300)
        if r.returncode:
            raise AviBuildError(f"{cxx} failed on {SOURCE.relative_to(REPO)}"
                                f":\n{r.stdout}{r.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    lib.avi_open.restype = ctypes.c_void_p
    lib.avi_open.argtypes = [ctypes.c_char_p, ctypes.c_uint32,
                             ctypes.c_uint32, ctypes.c_uint32]
    lib.avi_write_frame.restype = ctypes.c_int
    lib.avi_write_frame.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.avi_close.restype = ctypes.c_int
    lib.avi_close.argtypes = [ctypes.c_void_p]
    return lib


class AviWriter:
    """Streaming RGB24 AVI writer backed by the native library."""

    def __init__(self, path: str, width: int, height: int, fps: int = 1):
        self._lib = load()
        self._handle = self._lib.avi_open(os.fsencode(path), width, height,
                                          fps)
        if not self._handle:
            raise OSError(f"cannot open {path}")
        self.path = path
        self.width, self.height = width, height

    def write(self, frame: np.ndarray) -> None:
        """frame: (H, W, 3) uint8 RGB, top-down."""
        if frame.shape != (self.height, self.width, 3) or \
                frame.dtype != np.uint8:
            raise ValueError(f"frame {frame.shape} {frame.dtype}: want "
                             f"({self.height}, {self.width}, 3) uint8")
        buf = np.ascontiguousarray(frame)
        if self._lib.avi_write_frame(self._handle,
                                     buf.ctypes.data_as(ctypes.c_char_p)):
            raise OSError(f"avi_write_frame failed on {self.path}")

    def close(self) -> None:
        if self._handle:
            self._lib.avi_close(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _chunks(data: bytes, start: int, end: int):
    """(fourcc, payload start, payload size, list type or None) of the RIFF
    chunks in data[start:end]; payloads are padded to even sizes."""
    pos = start
    while pos + 8 <= end:
        cc = data[pos:pos + 4]
        size = struct.unpack_from("<I", data, pos + 4)[0]
        kind = data[pos + 8:pos + 12] if cc in (b"LIST", b"RIFF") else None
        yield cc, pos + 8, size, kind
        pos += 8 + size + (size & 1)


def read_frames(path: str) -> np.ndarray:
    """Every frame of an AVI that AviWriter wrote: (n, H, W, 3) uint8 RGB,
    top-down."""
    data = Path(path).read_bytes()
    if data[:4] != b"RIFF" or data[8:12] != b"AVI ":
        raise ValueError(f"{path}: not a RIFF AVI file")
    width = height = None
    frames = []
    lists = [(12, len(data))]
    while lists:
        start, end = lists.pop(0)
        for cc, pos, size, kind in _chunks(data, start, end):
            if kind is not None:
                lists.append((pos + 4, pos + size))
            elif cc == b"strf":
                width, height, _, bpp = struct.unpack_from("<iiHH", data,
                                                           pos + 4)
                if bpp != 24:
                    raise ValueError(f"{path}: {bpp} bits a pixel, want 24")
            elif cc == b"00db":
                frames.append((pos, size))
    if width is None:
        raise ValueError(f"{path}: no stream format (strf) chunk")
    row = 3 * width
    padded = (row + 3) & ~3
    out = np.empty((len(frames), abs(height), width, 3), np.uint8)
    for i, (pos, size) in enumerate(frames):
        if size != padded * abs(height):
            raise ValueError(f"{path}: frame {i} holds {size} bytes, want "
                             f"{padded * abs(height)}")
        rows = np.frombuffer(data, np.uint8, size, pos).reshape(-1, padded)
        bgr = rows[:, :row].reshape(-1, width, 3)
        # a positive height is stored bottom-up
        out[i] = (bgr[::-1] if height > 0 else bgr)[..., ::-1]
    return out
