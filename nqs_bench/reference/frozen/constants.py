# Frozen copy of the port's host plan code (noisyquantumsimulator_tpu_torch/core/constants.py), kept so that the
# benchmark's reference rebuilds the gate from its configuration file without
# importing the program. Only the imports were changed, and what the reference
# never reaches was left out.
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
G_E = 2.00231930436256

TWO_PI = 2.0 * np.pi
