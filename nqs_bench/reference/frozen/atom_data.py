# Frozen copy of the port's host plan code (noisyquantumsimulator_tpu_torch/core/atom_data.py), kept so that the
# benchmark's reference rebuilds the gate from its configuration file without
# importing the program. Only the imports were changed, and what the reference
# never reaches was left out.
"""Atomic species data for Rb87 and Rydberg scaling laws.

Rebuild of the reference atom database
(reference: rydberg_gates/atom_database.py:104-1018). The design differs from
the reference: instead of a nested dict consumed ad-hoc, species data lives in
frozen dataclasses resolved on the host before any device work; the
scaling-law functions below are pure arithmetic.

Literature values (Li et al. PRA 67 052502; Saffman et al. RMP 82 2313;
Steck Rb87 data; Beterov et al. PRA 79 052504) are physical facts shared with
the reference:
  - quantum defects delta_S/P/D/F
  - C6(n_ref=70, Rb87) = 2*pi * 862.69 GHz um^6
  - tau(n=70, 300K) = 140 us ; tau(0K) = 280 us
  - scaling exponents: C6 ~ n*^11, tau0 ~ n*^3, tau_BBR ~ n*^2,
    alpha_r ~ n*^7, d(P->nS) ~ n*^-3/2
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

import numpy as np

from .constants import (
    A0, E_CHARGE, EPS0, HBAR, RY_JOULES, TWO_PI, G_I_RB87,
)

_AU_POL = 4.0 * np.pi * EPS0 * A0**3  # 1 a.u. polarizability in SI


@dataclass(frozen=True)
class IntermediateState:
    """P-state used as the virtual intermediate level of the two-photon ladder."""
    energy: float                # [J] relative to ground
    linewidth: float             # natural linewidth Gamma [rad/s]
    dipole_from_ground: float    # reduced dipole <P|er|ground> [C m]
    g_J: float


@dataclass(frozen=True)
class SpeciesData:
    name: str
    mass: float                  # [kg]
    nuclear_spin: float
    g_I: float
    E_ionization: float          # [J]
    quantum_defects: Dict[str, float]
    hyperfine_splitting_hz: float
    # (F=low, F=high) manifold energies rel. to hyperfine c.o.g. [J]
    hyperfine_energies: Dict[int, float]
    g_F: Dict[int, float]
    K_quad_clock: float          # quadratic Zeeman coeff for clock pair [Hz/G^2]
    intermediate_states: Dict[str, IntermediateState]
    default_intermediate: str
    n_ref: int
    C6_ref: float                # [ (rad/s) m^6 ]
    tau_ref: float               # lifetime at n_ref, 300 K [s]
    tau_0K_ref: float            # lifetime at n_ref, 0 K [s]
    alpha_ground: float          # ground polarizability at trap wavelength [SI]
    alpha_rydberg_ref: float     # Rydberg polarizability at n_ref [SI], negative
    alpha_hyperfine: Dict[int, float]
    dipole_intermediate_to_rydberg_ref: float  # <n_ref S|er|P> [C m]
    scaling_exponents: Dict[str, float] = field(default_factory=lambda: {
        "C6": 11.0, "lifetime_0K": 3.0, "lifetime_BBR": 2.0,
        "polarizability": 7.0, "dipole_to_rydberg": -1.5,
    })
    transitions: Dict[str, float] = field(default_factory=dict)  # [Hz]
    trap_wavelength: float = 1064e-9  # [m]
    magic_wavelengths: Dict[str, Dict[str, float]] = field(default_factory=dict)


RB87 = SpeciesData(
    name="Rb87",
    mass=1.443160648e-25,
    nuclear_spin=1.5,
    g_I=G_I_RB87,
    E_ionization=4.177128 * E_CHARGE,
    quantum_defects={"S": 3.1311807, "P": 2.6548849, "D": 1.3480917, "F": 0.0165192},
    hyperfine_splitting_hz=6.834682610904e9,
    hyperfine_energies={
        1: -4.271676631815181e9 * HBAR * TWO_PI,
        2: 2.563005979089109e9 * HBAR * TWO_PI,
    },
    g_F={1: -0.5, 2: +0.5},
    K_quad_clock=575.0,
    intermediate_states={
        "5P1/2": IntermediateState(
            energy=377.107385690e12 * HBAR * TWO_PI,
            linewidth=TWO_PI * 5.746e6,
            dipole_from_ground=2.99 * E_CHARGE * A0,
            g_J=2.0 / 3.0,
        ),
        "5P3/2": IntermediateState(
            energy=384.230484468e12 * HBAR * TWO_PI,
            linewidth=TWO_PI * 6.065e6,
            dipole_from_ground=4.23 * E_CHARGE * A0,
            g_J=4.0 / 3.0,
        ),
    },
    default_intermediate="5P3/2",
    n_ref=70,
    C6_ref=TWO_PI * 862.69e9 * (1e-6) ** 6,
    tau_ref=140e-6,
    tau_0K_ref=280e-6,
    alpha_ground=687.3 * _AU_POL,
    alpha_rydberg_ref=-200000.0 * _AU_POL,
    alpha_hyperfine={1: 686.1 * _AU_POL, 2: 688.5 * _AU_POL},
    dipole_intermediate_to_rydberg_ref=0.014 * E_CHARGE * A0,
    transitions={
        "ground_to_5P3/2": 384.230484468e12,
        "ground_to_5P1/2": 377.107385690e12,
    },
    trap_wavelength=1064e-9,
    magic_wavelengths={
        "hyperfine": {"scalar_magic_nm": 790.0, "1064nm_differential_Hz_per_mK": 70e3},
        "ground_rydberg": {"near_magic_nm": 1004.0},
    },
)

SPECIES: Dict[str, SpeciesData] = {"Rb87": RB87}


def get_species(name: str) -> SpeciesData:
    if name not in SPECIES:
        raise ValueError(f"Unknown species: {name}. Available: {list(SPECIES)}")
    return SPECIES[name]


# --------------------------------------------------------------------------
# scaling laws (reference: atom_database.py:538-1018)
# --------------------------------------------------------------------------

def effective_n(n: float, species: str | SpeciesData, orbital: str = "S") -> float:
    """n* = n - delta_L. (atom_database.py:538)"""
    sp = species if isinstance(species, SpeciesData) else get_species(species)
    return n - sp.quantum_defects.get(orbital, 0.0)


def get_rydberg_energy(n: int, species: str | SpeciesData, orbital: str = "S") -> float:
    """E_n = -Ry / n*^2  [J]. (atom_database.py:623)"""
    return -RY_JOULES / effective_n(n, species, orbital) ** 2


def get_C6(n: int, species: str | SpeciesData) -> float:
    """C6(n) = C6_ref (n*/n*_ref)^11  [(rad/s) m^6]. (atom_database.py:662)"""
    sp = species if isinstance(species, SpeciesData) else get_species(species)
    ns = effective_n(n, sp, "S")
    ns_ref = effective_n(sp.n_ref, sp, "S")
    return sp.C6_ref * (ns / ns_ref) ** sp.scaling_exponents["C6"]


def get_rydberg_lifetime(n: int, species: str | SpeciesData,
                         temperature: float = 300.0) -> float:
    """Total lifetime 1/tau = 1/tau_sp + 1/tau_BBR. (atom_database.py:722)

    tau_sp scales as n*^3; the BBR channel scales as n*^2 * (300/T)^4 from
    the reference values at n_ref.
    """
    sp = species if isinstance(species, SpeciesData) else get_species(species)
    ns = effective_n(n, sp, "S")
    ns_ref = effective_n(sp.n_ref, sp, "S")
    tau_0K = sp.tau_0K_ref * (ns / ns_ref) ** sp.scaling_exponents["lifetime_0K"]
    if temperature < 1.0:
        return tau_0K
    tau_bbr_ref = sp.tau_ref * sp.tau_0K_ref / (sp.tau_0K_ref - sp.tau_ref)
    tau_bbr = tau_bbr_ref * (ns / ns_ref) ** sp.scaling_exponents["lifetime_BBR"]
    tau_bbr *= (300.0 / temperature) ** 4
    return 1.0 / (1.0 / tau_0K + 1.0 / tau_bbr)
