"""Build the port's CUDA kernels with nvcc into one shared library.

The sources csrc/*.cu export a plain C interface and are compiled by
hand (no torch headers, so a build takes seconds) into
build/torch_kernels/<hash>/liblbm_kernels.so under the repository root,
keyed by a hash of the sources and flags, at first use. The library is
loaded with ctypes. A missing nvcc or a failed build raises with the
compiler's output: there is no fallback.

Flags: sm_90a (Hopper), -O3, and -fmad=false without fast math, because the
moment sums feed exact-equality guards and the native-dtype rounding is
part of the golden trajectory.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
LIB_NAME = "liblbm_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


class KernelBuildError(RuntimeError):
    """nvcc is missing, or it refused the sources."""


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        candidate = Path(cuda_home) / "bin" / "nvcc"
        if candidate.is_file():
            nvcc = str(candidate)
    if nvcc is None:
        raise KernelBuildError(
            "nvcc not found on PATH or under $CUDA_HOME/bin: the CUDA "
            "kernels of lbm_tpu_torch are built from source at first use")
    return nvcc


def _sources():
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build(build_root: Path = BUILD_ROOT) -> Path:
    """Compile csrc/*.cu unless a library with the same hash exists;
    returns its path. The compiler's log lands beside it (build.log)."""
    out_dir = Path(build_root) / source_hash()
    lib = out_dir / LIB_NAME
    if lib.is_file():
        return lib
    nvcc = find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"{LIB_NAME}.{os.getpid()}.tmp"
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources())]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = (f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
           f"[{time.perf_counter() - t0:.1f} s, rc={proc.returncode}]\n")
    (out_dir / "build.log").write_text(log)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(f"nvcc failed (rc={proc.returncode}):\n{log}")
    os.replace(tmp, lib)   # atomic: a concurrent build sees all or nothing
    return lib


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The built library with every exported function's signature declared."""
    lib = ctypes.CDLL(str(build()))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.lbm_collide_stream.argtypes = [ci, ci, vp, vp, vp, vp, vp, vp, vp,
                                       ci, ci, vp, vp]
    lib.lbm_collide_stream.restype = ci
    lib.lbm_host_params_size.argtypes = []
    lib.lbm_host_params_size.restype = ci
    return lib
