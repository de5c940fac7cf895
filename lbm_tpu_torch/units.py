"""SI -> lattice-unit conversion for the three-population plasma.

A copy of lbm_tpu/units.py: pure Python, so both packages derive the same
LatticeUnits bit for bit (tests/test_torch_config.py holds them equal).

The scale choices replicate the reference's unit system exactly
(reference: include/plasma.hpp:78-133):

    M0 = m_e            (electron mass)
    T0 = T_e_init       (initial electron temperature)
    Q0 = e              (elementary charge)
    n0 = n_e_init       (initial electron number density)
    L0 = sqrt(eps0 kB T0 / (n0 e^2)) * 1e-2     (= lambda_Debye / 100)
    t0 = sqrt(eps0 m_e / (3 n0 e^2)) * 1e-2     (= sqrt(3)/omega_p / 100)

Derived:
    E0 = M0 L0 / (Q0 t0^2),  v0 = L0/t0,  F0 = M0 L0 / t0^2
    cs2     = kB T0 / M0 * t0^2 / L0^2   (analytically exactly 1/3)
    Kb_latt = kB t0^2 T0 / (L0^2 M0)     (numerically equals cs2)

Everything is computed in float64 Python scalars so the resulting numbers
match the C++ double-precision member initializers bit-for-bit; the caller
casts to the simulation dtype.
"""
from __future__ import annotations

import dataclasses
import math


# Physical constants (SI), identical values to reference include/plasma.hpp:78-84.
KB_SI = 1.380649e-23          # Boltzmann [J/K]
E_CHARGE_SI = 1.602176634e-19  # elementary charge [C]
EPSILON0_SI = 8.854187817e-12  # vacuum permittivity [F/m]
M_E_SI = 9.10938356e-31        # electron mass [kg]
U_SI = 1.66053906660e-27       # atomic mass unit [kg]
M_P_SI = 1.67262192595e-27     # proton mass [kg]
M_NE_SI = 1.67492749804e-27    # neutron mass [kg]


@dataclasses.dataclass(frozen=True)
class LatticeUnits:
    """All lattice-unit quantities derived from the SI inputs."""

    # fundamental scales (SI value of one lattice unit)
    L0: float
    t0: float
    M0: float
    T0: float
    Q0: float
    n0: float
    E0: float
    v0: float
    F0: float

    # lattice-unit physics constants
    cs2: float
    kb: float

    # per-species lattice-unit parameters
    m_e: float
    m_i: float
    m_n: float
    q_e: float
    q_i: float
    rho_e_init: float
    rho_i_init: float
    rho_n_init: float
    T_e_init: float
    T_i_init: float
    T_n_init: float
    Ex_ext: float
    Ey_ext: float


def compute_lattice_units(
    *,
    Z_ion: int,
    A_ion: int,
    n_e_SI: float,
    n_n_SI: float,
    T_e_SI: float,
    T_i_SI: float,
    T_n_SI: float,
    Ex_SI: float,
    Ey_SI: float,
) -> LatticeUnits:
    """Replicates the member-initializer math of include/plasma.hpp:86-133."""
    m_i_SI = A_ion * U_SI
    m_n_SI = A_ion * U_SI

    n0 = n_e_SI
    M0 = M_E_SI
    T0 = T_e_SI
    Q0 = E_CHARGE_SI
    L0 = math.sqrt(EPSILON0_SI * KB_SI * T0 / (n0 * Q0 * Q0)) * 1e-2
    t0 = math.sqrt(EPSILON0_SI * M0 / (3.0 * n0 * Q0 * Q0)) * 1e-2

    E0 = M0 * L0 / (Q0 * t0 * t0)
    v0 = L0 / t0
    F0 = M0 * L0 / (t0 * t0)

    cs2 = KB_SI * T0 / M0 * t0 * t0 / (L0 * L0)
    kb = KB_SI * (t0 * t0 * T0) / (L0 * L0 * M0)

    m_e = M_E_SI / M0
    m_i = m_i_SI / M0
    m_n = m_n_SI / M0

    q_e = -E_CHARGE_SI / Q0
    q_i = Z_ion * E_CHARGE_SI / Q0

    # Initial mass densities (lattice units). The ion density is divided by
    # Z so the plasma starts overall charge-neutral (plasma.hpp:132).
    rho_e_init = m_e * n_e_SI / n0
    rho_i_init = m_i * n_e_SI / n0 / Z_ion
    rho_n_init = m_n * n_n_SI / n0

    return LatticeUnits(
        L0=L0, t0=t0, M0=M0, T0=T0, Q0=Q0, n0=n0, E0=E0, v0=v0, F0=F0,
        cs2=cs2, kb=kb,
        m_e=m_e, m_i=m_i, m_n=m_n,
        q_e=q_e, q_i=q_i,
        rho_e_init=rho_e_init, rho_i_init=rho_i_init, rho_n_init=rho_n_init,
        T_e_init=T_e_SI / T0, T_i_init=T_i_SI / T0, T_n_init=T_n_SI / T0,
        Ex_ext=Ex_SI / E0, Ey_ext=Ey_SI / E0,
    )
