"""Build the port's CUDA kernels with nvcc into one shared library.

The sources csrc/*.cu (with the headers csrc/*.cuh they share) export a
plain C interface and are compiled by hand (no torch headers, so a build
takes seconds), one nvcc per source, all started together, then linked
into build/torch_kernels/<hash>/liblbm_kernels.so under the repository
root, keyed by a hash of the sources, headers and flags, at first use. The library is
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
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH, "-O3", "-std=c++17", "-fmad=false", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]


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
    """Hash of the flags, the sources and the headers they include."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted([*_sources(), *CSRC.glob("*.cuh")]):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds):
    """Run the commands in parallel; returns (log, all succeeded)."""
    t0 = time.perf_counter()
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    log, ok = "", True
    for cmd, proc in zip(cmds, procs):
        out, _ = proc.communicate()
        log += (f"$ {' '.join(cmd)}\n{out}"
                f"[{time.perf_counter() - t0:.1f} s, rc={proc.returncode}]\n")
        ok = ok and proc.returncode == 0
    return log, ok


def build(build_root: Path = BUILD_ROOT) -> Path:
    """Compile csrc/*.cu unless a library with the same hash exists;
    returns its path. The compiler's log lands beside it (build.log)."""
    out_dir = Path(build_root) / source_hash()
    lib = out_dir / LIB_NAME
    if lib.is_file():
        return lib
    nvcc = find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = os.getpid()
    objs = [out_dir / f"{src.stem}.{tag}.o" for src in _sources()]
    tmp = out_dir / f"{LIB_NAME}.{tag}.tmp"
    log, ok = _run_all([[nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
                        for src, obj in zip(_sources(), objs)])
    if ok:
        link_log, ok = _run_all([[nvcc, *ARCH, "-shared", "-o", str(tmp),
                                  *map(str, objs)]])
        log += link_log
    (out_dir / "build.log").write_text(log)
    for obj in objs:
        obj.unlink(missing_ok=True)
    if not ok:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(f"nvcc failed:\n{log}")
    os.replace(tmp, lib)   # atomic: a concurrent build sees all or nothing
    return lib


_VP, _CI, _CD = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
# every function the library exports (all return int): an undeclared
# pointer argument would be cut to 32 bits
SIGNATURES = {
    # mode, delta, f, g, Ex, Ey, f_out, g_out, rho_q, NY, NX, params, stream
    "lbm_collide_stream": [_CI, _CI, *[_VP] * 7, _CI, _CI, _VP, _VP],
    "lbm_collide": [_CI, _CI, *[_VP] * 7, _CI, _CI, _VP, _VP],
    "lbm_host_params_size": [],
    # mode, delta, ptr[20], f_out, g_out, rho_q, geom[7], params, stream
    "lbm_collide_stream_halo": [_CI, _CI, *[_VP] * 7],
    # mode, delta, f, g, Ex, Ey, Ez, f_out, g_out, rho_q, NZ, NY, NX, params,
    # stream
    "lbm_plasma3d_collide_stream": [_CI, _CI, *[_VP] * 8, _CI, _CI, _CI, _VP,
                                    _VP],
    # mode, delta, ptr[45], f_out, g_out, rho_q, geom[5], params, stream
    "lbm_plasma3d_collide_stream_halo": [_CI, _CI, *[_VP] * 7],
    # dtype, kind, interior_only, omega, max_iter, tol, phi0, rho, scratch,
    # out, err_ring, sweeps, NY, NX, stream
    "lbm_solve_iter": [_CI, _CI, _CI, _CD, _CI, _CD, *[_VP] * 6, _CI, _CI,
                       _VP],
    # mode, lean, f, rho, ux, uy, f_up, mac_up, f_dn, mac_dn, f_out, rho_out,
    # ux_out, uy_out, u_lid_dyn, tau, NY, NX, du, dd, b_row, l_row, stream
    "lbm_cavity_collide_stream": [_CI, _CI, *[_VP] * 12, _CD, _CD,
                                  *[_CI] * 6, _VP],
    # mode, f, work_a, work_b, f_out, t0, k_steps, u_lid, sigma, tau, NY, NX,
    # b_row, l_row, stream
    "lbm_cavity_multistep": [_CI, *[_VP] * 4, _CI, _CI, _CD, _CD, _CD,
                             *[_CI] * 4, _VP],
    # mode, delta, solve_kind, window (MultistepHost*), params, stream
    "lbm_plasma_multistep": [_CI, _CI, _CI, _VP, _VP, _VP],
    "lbm_multistep_host_size": [],
    # rho, tw_x, tw_y, sym_x, sym_y, scratch, ex, ey, NY, NX, stream
    "lbm_fft_solve_efield": [*[_VP] * 8, _CI, _CI, _VP],
}


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The built library with every exported function's signature declared."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
