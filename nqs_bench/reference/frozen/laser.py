# Frozen copy of the port's host plan code (noisyquantumsimulator_tpu_torch/physics/laser.py), kept so that the
# benchmark's reference rebuilds the gate from its configuration file without
# importing the program. Only the imports were changed, and what the reference
# never reaches was left out.
"""Laser-atom interaction physics: Rabi frequencies, blockade, scattering.

Rebuild of the reference laser physics
(reference: rydberg_gates/laser_physics.py:111-946). Pure numpy
arithmetic on host scalars or arrays.
"""
from __future__ import annotations

# HOST-SIDE MODULE: numpy on purpose. Planning-path physics runs on the
# host in float64 (f32 flush-to-zero corrupts SI-unit scales). The device
# path consumes schedules, not these helpers.
import numpy as np

from .constants import C, EPS0, HBAR


def laser_intensity(power, waist):
    """Peak intensity of a Gaussian beam I0 = 2P/(pi w^2) [W/m^2].
    (laser_physics.py:161)"""
    return 2.0 * power / (np.pi * waist ** 2)


def laser_E0(power, waist):
    """Peak E-field E0 = sqrt(4P/(pi w^2 eps0 c)) [V/m]. (laser_physics.py:111)"""
    return np.sqrt(2.0 * laser_intensity(power, waist) / (EPS0 * C))


def single_photon_rabi(dipole, E0):
    """Omega = d E0 / hbar [rad/s]. (laser_physics.py:191)"""
    return dipole * E0 / HBAR


def two_photon_rabi(Omega1, Omega2, Delta_e):
    """Omega_eff = Omega1 Omega2 / (2 Delta_e) [rad/s]. (laser_physics.py:265)"""
    return Omega1 * Omega2 / (2.0 * Delta_e)


def rydberg_blockade(C6, R):
    """V(R) = C6 / R^6; with C6 in (rad/s) m^6 this is [rad/s].
    (laser_physics.py:427)"""
    return C6 / R ** 6


def intermediate_state_scattering_rate(Omega1, Delta_e, Gamma_e):
    """gamma = Gamma_e (Omega1/2)^2 / (Delta_e^2 + (Gamma_e/2)^2) [rad/s].
    (laser_physics.py:676; full Lorentzian per noise_models.py:561)"""
    return Gamma_e * (Omega1 / 2.0) ** 2 / (Delta_e ** 2 + (Gamma_e / 2.0) ** 2)


# ---------------------------------------------------------------------------
# Clebsch-Gordan coefficients for D2-line hyperfine transitions.
# These are exact angular-momentum algebra values (same table as
# laser_physics.py:791-827, which is itself standard Steck data).
# ---------------------------------------------------------------------------
