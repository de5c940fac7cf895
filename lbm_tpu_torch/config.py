"""Configuration dataclasses (counterpart of lbm_tpu/config.py).

Same fields, defaults and validation as the JAX package's PlasmaConfig,
with two differences: `dtype` is a torch.dtype, and `backend` is "plain"
(eager torch ops, the counterpart of "jnp"), "fused" (the hand-written
CUDA collide+stream kernel) or "pallas" (the collide-only CUDA kernel,
streaming in torch; the name is the JAX package's). The JAX-only
`kernel_interpret` switch has no counterpart: a CUDA kernel has no
interpret mode.

Configurations that the port does not run yet are still constructible;
models/plasma.check_supported refuses them with NotImplementedError naming
the ROADMAP item that brings them.

CavityConfig mirrors the JAX package's cavity configuration the same way:
"plain" for "jnp", and "fused" for the CUDA cavity kernels.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Tuple

import torch

from .units import LatticeUnits, compute_lattice_units


class PoissonSolver(enum.Enum):
    """Field-solver choices (reference: include/poisson.hpp PoissonType)."""

    NONE = 0
    GS = 1    # Gauss-Seidel, red-black
    SOR = 2   # successive over-relaxation, red-black
    FFT = 3   # spectral (periodic only)
    NPS = 4   # 9-point stencil, 4-color


class BC(enum.Enum):
    """Streaming boundary conditions (reference: include/streaming.hpp BCType)."""

    PERIODIC = 0
    BOUNCE_BACK = 1


@dataclasses.dataclass(frozen=True)
class CompatFlags:
    """Replicate-or-fix switches for the reference's behavioral quirks
    (see lbm_tpu/config.py for what each one replicates)."""

    none_solver_kills_external_field: bool = True
    dirichlet_iterative_under_periodic: bool = True
    macro_guards: bool = True
    debug_variant: bool = False


@dataclasses.dataclass(frozen=True)
class PlasmaConfig:
    """Three-population D2Q9 plasma configuration.

    Defaults are the reference golden run (src/main_plasma.cpp:16-51):
    200x200 grid, 200 steps, hydrogen ions, FFT Poisson, periodic BCs.
    """

    NX: int = 200
    NY: int = 200
    NZ: int = 0            # 0 => 2-D (D2Q9); >0 => 3-D column (D3Q19)
    nsteps: int = 200

    Z_ion: int = 1
    A_ion: int = 1
    n_e_SI: float = 1e11   # [m^-3]
    n_n_SI: float = 1e18   # [m^-3]
    T_e_SI: float = 1e4    # [K]
    T_i_SI: float = 300.0  # [K]
    T_n_SI: float = 300.0  # [K]
    Ex_SI: float = 1e-2    # [V/m]
    Ey_SI: float = 0.0     # [V/m]

    poisson: PoissonSolver = PoissonSolver.FFT
    bc: BC = BC.PERIODIC
    omega_sor: float = 1.8
    poisson_max_iter: int = 5000
    poisson_tol: float = 1e-8

    # BGK relaxation times, fixed (reference: src/collisions.cpp:6-7).
    tau_e: float = 5.0
    tau_i: float = 3.0
    tau_n: float = 1.0
    tau_ei: float = 6.0
    tau_en: float = 4.0
    tau_in: float = 2.0

    # compute dtype of the fields and of all arithmetic
    dtype: torch.dtype = torch.float32
    compat: CompatFlags = CompatFlags()

    # "plain": eager torch ops; "fused": one CUDA kernel for collide+stream;
    # "pallas": the collide-only CUDA kernel (on CPU tensors each kernel's
    # plain version runs instead)
    backend: str = "plain"

    # store the neutral mass populations as deltas from the uniform
    # background rho_n_init * w_i (rescues the f32 neutral channel)
    neutral_delta: bool = False

    fft_engine: str = "auto"  # "auto" | "xla" | "pallas"
    # iterative solve: "xla" = the plain sweeps, "pallas" = the CUDA
    # kernel, "auto" = the kernel on the fused and pallas backends
    iter_engine: str = "auto"
    multistep: int = 0

    # population STORAGE precision for f and g; arithmetic stays in dtype
    storage: str = "native"  # "native" | "bf16"

    def __post_init__(self):
        if self.storage not in ("native", "bf16"):
            raise ValueError(f"storage must be 'native' or 'bf16', "
                             f"got {self.storage!r}")
        if self.backend not in ("plain", "pallas", "fused"):
            raise ValueError(f"backend must be plain|pallas|fused, "
                             f"got {self.backend!r}")
        if self.fft_engine not in ("auto", "xla", "pallas"):
            raise ValueError(f"fft_engine must be auto|xla|pallas, "
                             f"got {self.fft_engine!r}")
        if self.iter_engine not in ("auto", "xla", "pallas"):
            raise ValueError(f"iter_engine must be auto|xla|pallas, "
                             f"got {self.iter_engine!r}")
        if self.multistep:
            if self.multistep < 0:
                raise ValueError(f"multistep must be >= 0, "
                                 f"got {self.multistep}")
            if self.backend != "fused":
                raise ValueError("multistep is a fused-kernel mode")
            if self.NZ and self.poisson != PoissonSolver.NONE:
                raise ValueError("3-D multistep supports the NONE solver "
                                 "only (window-constant E)")
            if self.compat.debug_variant:
                raise ValueError("multistep is incompatible with "
                                 "debug_variant (jnp-only mode)")

    def units(self) -> LatticeUnits:
        return compute_lattice_units(
            Z_ion=self.Z_ion, A_ion=self.A_ion,
            n_e_SI=self.n_e_SI, n_n_SI=self.n_n_SI,
            T_e_SI=self.T_e_SI, T_i_SI=self.T_i_SI, T_n_SI=self.T_n_SI,
            Ex_SI=self.Ex_SI, Ey_SI=self.Ey_SI,
        )

    @property
    def taus(self) -> Tuple[float, float, float, float, float, float]:
        return (self.tau_e, self.tau_i, self.tau_n,
                self.tau_ei, self.tau_en, self.tau_in)


@dataclasses.dataclass(frozen=True)
class CavityConfig:
    """Single-population lid-driven cavity (reference: old codes/LBM_classic).

    Defaults are the Ghia-validated configuration
    (old codes/LBM_classic/main.cpp:7-11): Re=100, 129^2, u_lid=0.1, 10k
    steps. The fields and rules are lbm_tpu.config.CavityConfig's, with a
    torch dtype and the backends "plain" (eager torch, the JAX package's
    "jnp") and "fused" (the hand-written CUDA cavity kernels; on CPU
    tensors their plain versions run). The CUDA kernels take any NY: the
    JAX package's banded kernels need NY % 8 == 0, these do not.
    """

    NX: int = 129
    NY: int = 129
    nsteps: int = 10_000
    u_lid: float = 0.1
    Re: float = 100.0
    # Lid ramp duration: u_lid_dyn = u_lid * t / sigma for t < sigma
    # (old codes/LBM_classic/LBM.hpp:30, LBM.cpp:180).
    sigma: float = 10.0
    dtype: torch.dtype = torch.float32

    backend: str = "plain"
    # fused only: the kernel recomputes the macros from f and moves the
    # populations only (72 B/site in f32, 36 in bf16); the stored macros
    # are always macros_guarded(f) anyway
    lean_macros: bool = False
    # fused only: K steps per kernel launch (lean semantics; bf16 storage
    # rounds once per window). 0 disables.
    multistep: int = 0
    # "native" keeps f in dtype; "bf16" stores f as bfloat16 deviations
    # from the uniform background w_i, with f32 arithmetic and f32 macros
    storage: str = "native"

    # Stability-guard mode replicating old codes/LBM_classic/Stability:
    # if tau falls outside [0.5, 2.0], resize NY (and NX to match).
    stability_autoresize: bool = False

    def __post_init__(self):
        if self.backend not in ("plain", "fused"):
            raise ValueError(
                f"cavity backend must be plain|fused, got {self.backend!r}")
        if self.storage not in ("native", "bf16"):
            raise ValueError(
                f"cavity storage must be native|bf16, got {self.storage!r}")
        if self.storage == "bf16" and self.dtype != torch.float32:
            raise ValueError("cavity bf16 storage computes in f32; set "
                             "dtype=float32 (f64 runs use native storage)")
        if self.lean_macros and self.backend != "fused":
            raise ValueError("lean_macros is a fused-kernel mode")
        if self.multistep:
            if self.backend != "fused":
                raise ValueError("multistep is a fused-kernel mode")
            if self.multistep < 0:
                raise ValueError(f"multistep must be >= 0, "
                                 f"got {self.multistep}")

    @property
    def tau(self) -> float:
        # tau = 3 nu + 1/2 with nu = u_lid * NY / Re
        # (old codes/LBM_classic/LBM.cpp:12).
        return 3.0 * (self.u_lid * self.NY / self.Re) + 0.5

    def with_stability_guard(self) -> "CavityConfig":
        """A config whose grid is resized so that tau is in [0.5, 2]
        (old codes/LBM_classic/Stability/LBM_f.cpp:31-53): tau too small
        -> NY = Re*0.1/(3*u_lid); tau too large -> NY = Re*1.5/(3*u_lid)."""
        tau = self.tau
        if 0.5 <= tau <= 2.0:
            return self
        if tau < 0.5:
            ny = int(self.Re * 0.1 / (3.0 * self.u_lid))
        else:
            ny = int(self.Re * 1.5 / (3.0 * self.u_lid))
        ny = max(ny, 2)
        return dataclasses.replace(self, NX=ny, NY=ny)


def preset_golden_plasma() -> PlasmaConfig:
    """Config #1: 200x200, 200 steps, FFT+Periodic (the C++ golden run)."""
    return PlasmaConfig()


def preset_cavity_ghia() -> CavityConfig:
    """Config #2: Ghia-validated lid-driven cavity."""
    return CavityConfig()


def preset_plasma_1024() -> PlasmaConfig:
    """Config #3: 1024^2 plasma, on-device FFT Poisson, single device."""
    return PlasmaConfig(NX=1024, NY=1024, nsteps=100)


def preset_plasma_4096() -> PlasmaConfig:
    """Config #4: 4096^2 plasma (the reference's multi-device size)."""
    return PlasmaConfig(NX=4096, NY=4096, nsteps=100)
