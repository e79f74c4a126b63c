"""Physical constants (CODATA 2018) and unit conversions.

Rebuild of the reference constants module
(reference: src/qpu_simulator/micro_physics/neutral_atoms/rydberg_gates/constants.py:95-451).
All values SI. Conversion helpers are pure functions of scalars/arrays (they only
use arithmetic).
"""
from __future__ import annotations

import numpy as np

# --- fundamental constants (CODATA 2018) -----------------------------------
HBAR = 1.054571817e-34        # reduced Planck constant [J s]
EPS0 = 8.8541878128e-12       # vacuum permittivity [F/m]
C = 299792458.0               # speed of light [m/s]
E_CHARGE = 1.602176634e-19    # elementary charge [C]
A0 = 5.29177210903e-11        # Bohr radius [m]
KB = 1.380649e-23             # Boltzmann constant [J/K]
MU_B = 9.2740100783e-24       # Bohr magneton [J/T]

# --- derived ----------------------------------------------------------------
RY_JOULES = 2.1798723611035e-18   # Rydberg energy [J]
RY_EV = RY_JOULES / E_CHARGE      # Rydberg energy [eV]

# --- nuclear / electronic g-factors ------------------------------------------
G_I_RB87 = -0.0009951414
G_I_CS133 = -0.00039885395
G_E = 2.00231930436256

TWO_PI = 2.0 * np.pi


def frequency_to_energy(freq_hz):
    """E = h f = 2*pi*hbar*f  [J]. (constants.py:321)"""
    return TWO_PI * HBAR * freq_hz


def energy_to_frequency(energy_joules):
    """f = E / h  [Hz]. (constants.py:348)"""
    return energy_joules / (TWO_PI * HBAR)


def temperature_to_energy(temp_kelvin):
    """E = kB T  [J]. (constants.py:367)"""
    return KB * temp_kelvin


def wavelength_to_frequency(wavelength_m):
    """f = c / lambda  [Hz]. (constants.py:391)"""
    return C / wavelength_m


def au_to_si_polarizability(alpha_au):
    """1 a.u. of polarizability = 4*pi*eps0*a0^3. (constants.py:415)"""
    return alpha_au * 4.0 * np.pi * EPS0 * A0**3


def si_to_au_polarizability(alpha_si):
    """Inverse of :func:`au_to_si_polarizability`. (constants.py:437)"""
    return alpha_si / (4.0 * np.pi * EPS0 * A0**3)


__all__ = [
    "HBAR", "EPS0", "C", "E_CHARGE", "A0", "KB", "MU_B",
    "RY_JOULES", "RY_EV", "G_I_RB87", "G_I_CS133", "G_E", "TWO_PI",
    "frequency_to_energy", "energy_to_frequency", "temperature_to_energy",
    "wavelength_to_frequency", "au_to_si_polarizability",
    "si_to_au_polarizability",
]
