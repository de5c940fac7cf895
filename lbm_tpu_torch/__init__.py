"""lbm_tpu_torch — the plasma lattice-Boltzmann engine in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (H100).

A port of lbm_tpu (JAX/Pallas, the reference, which stays beside it):
same state layout, same physics expression trees, same guards. It imports
torch and numpy, never JAX. The 2-D plasma (D2Q9, three species with DDF
thermal populations) runs end to end under every Poisson solver and both
wall types, and so do the lid-driven cavity with its Ghia check and the
D3Q19 3-D plasma column (models/plasma3d) on one device; see ROADMAP.md
for the rest.
"""

from . import config, constants, units  # noqa: F401
from .config import (  # noqa: F401
    BC,
    CavityConfig,
    CompatFlags,
    PlasmaConfig,
    PoissonSolver,
    preset_cavity_ghia,
    preset_golden_plasma,
    preset_plasma_1024,
    preset_plasma_3d,
    preset_plasma_4096,
)
