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

from ..core.constants import A0, C, E_CHARGE, EPS0, HBAR
from ..core.atom_data import SpeciesData, effective_n, get_species


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


def single_photon_rabi_from_power(dipole, power, waist):
    return single_photon_rabi(dipole, laser_E0(power, waist))


def two_photon_rabi(Omega1, Omega2, Delta_e):
    """Omega_eff = Omega1 Omega2 / (2 Delta_e) [rad/s]. (laser_physics.py:265)"""
    return Omega1 * Omega2 / (2.0 * Delta_e)


def required_powers_for_two_photon_rabi(Omega_eff_target, Delta_e, dipole_1,
                                        dipole_2, waist_1, waist_2,
                                        power_ratio: float = 1.0):
    """Invert Omega_eff for (P1, P2). (laser_physics.py:362)"""
    prefactor = (HBAR ** 2 * np.pi * EPS0 * C) / (4.0 * dipole_1 * dipole_2)
    P_product = (Omega_eff_target * 2.0 * Delta_e * prefactor) ** 2 * waist_1 ** 2 * waist_2 ** 2
    P1 = np.sqrt(P_product / power_ratio)
    return P1, power_ratio * P1


def rydberg_blockade(C6, R):
    """V(R) = C6 / R^6; with C6 in (rad/s) m^6 this is [rad/s].
    (laser_physics.py:427)"""
    return C6 / R ** 6


def blockade_shift_MHz(C6_GHz_um6, R_um):
    """V/h [MHz] = C6[GHz um^6] * 1000 / R^6[um^6]. (laser_physics.py:485)"""
    return C6_GHz_um6 * 1000.0 / R_um ** 6


def blockade_radius(C6, Omega):
    """R_b = (C6/Omega)^(1/6) with C6 in (rad/s) m^6. (laser_physics.py:512)"""
    return (C6 / Omega) ** (1.0 / 6.0)


def blockade_radius_um(C6_GHz_um6, Omega_MHz):
    return (C6_GHz_um6 * 1000.0 / Omega_MHz) ** (1.0 / 6.0)


def V_over_Omega(C6, R, Omega):
    """Blockade strength parameter. (laser_physics.py:582)"""
    return rydberg_blockade(C6, R) / Omega


def spacing_for_target_V_over_Omega(C6, Omega, target_ratio):
    """R = (C6/(Omega ratio))^(1/6). (laser_physics.py:635)"""
    return (C6 / (Omega * target_ratio)) ** (1.0 / 6.0)


def intermediate_state_scattering_rate(Omega1, Delta_e, Gamma_e):
    """gamma = Gamma_e (Omega1/2)^2 / (Delta_e^2 + (Gamma_e/2)^2) [rad/s].
    (laser_physics.py:676; full Lorentzian per noise_models.py:561)"""
    return Gamma_e * (Omega1 / 2.0) ** 2 / (Delta_e ** 2 + (Gamma_e / 2.0) ** 2)


def dark_state_mixing_factor(Omega1, Omega2):
    """S = Omega2^2/(Omega1^2+Omega2^2), the |g> weight in the dark state.
    (laser_physics.py:741)"""
    return Omega2 ** 2 / (Omega1 ** 2 + Omega2 ** 2)


# ---------------------------------------------------------------------------
# Clebsch-Gordan coefficients for D2-line hyperfine transitions.
# These are exact angular-momentum algebra values (same table as
# laser_physics.py:791-827, which is itself standard Steck data).
# ---------------------------------------------------------------------------
_S = np.sqrt
CLEBSCH_GORDAN_D2 = {
    (1, -1, 0): {"pi": 0.0, "sigma+": 0.0, "sigma-": 1 / _S(3)},
    (1, 0, 0): {"pi": 1 / _S(3), "sigma+": 0.0, "sigma-": 0.0},
    (1, +1, 0): {"pi": 0.0, "sigma+": 1 / _S(3), "sigma-": 0.0},
    (1, -1, 1): {"pi": 1 / _S(6), "sigma+": -1 / _S(2), "sigma-": 0.0},
    (1, 0, 1): {"pi": 0.0, "sigma+": 1 / _S(6), "sigma-": -1 / _S(6)},
    (1, +1, 1): {"pi": -1 / _S(6), "sigma+": 0.0, "sigma-": 1 / _S(2)},
    (1, -1, 2): {"pi": -1 / _S(2), "sigma+": 0.0, "sigma-": -1 / _S(10)},
    (1, 0, 2): {"pi": -_S(2 / 5), "sigma+": -1 / _S(2), "sigma-": 1 / _S(2)},
    (1, +1, 2): {"pi": -1 / _S(2), "sigma+": 1 / _S(10), "sigma-": 0.0},
    (2, -2, 1): {"pi": 0.0, "sigma+": 0.0, "sigma-": 1 / _S(2)},
    (2, -1, 1): {"pi": 1 / _S(6), "sigma+": 0.0, "sigma-": 1 / _S(6)},
    (2, 0, 1): {"pi": _S(2 / 5), "sigma+": 1 / _S(6), "sigma-": 1 / _S(6)},
    (2, +1, 1): {"pi": 1 / _S(6), "sigma+": 1 / _S(6), "sigma-": 0.0},
    (2, +2, 1): {"pi": 0.0, "sigma+": 1 / _S(2), "sigma-": 0.0},
    (2, -2, 2): {"pi": -1 / _S(3), "sigma+": 0.0, "sigma-": -1 / _S(30)},
    (2, -1, 2): {"pi": -1 / _S(12), "sigma+": -1 / _S(3), "sigma-": 1 / _S(20)},
    (2, 0, 2): {"pi": 0.0, "sigma+": -1 / _S(12), "sigma-": 1 / _S(12)},
    (2, +1, 2): {"pi": 1 / _S(12), "sigma+": -1 / _S(20), "sigma-": 1 / _S(3)},
    (2, +2, 2): {"pi": 1 / _S(3), "sigma+": 1 / _S(30), "sigma-": 0.0},
    (2, -2, 3): {"pi": -_S(2 / 5), "sigma+": 0.0, "sigma-": -1 / _S(15)},
    (2, -1, 3): {"pi": -_S(3 / 10), "sigma+": -_S(2 / 5), "sigma-": 1 / (2 * _S(5))},
    (2, 0, 3): {"pi": -_S(2 / 5), "sigma+": -_S(3 / 10), "sigma-": _S(3 / 10)},
    (2, +1, 3): {"pi": -_S(3 / 10), "sigma+": -1 / (2 * _S(5)), "sigma-": _S(2 / 5)},
    (2, +2, 3): {"pi": -_S(2 / 5), "sigma+": 1 / _S(15), "sigma-": 0.0},
}


def get_clebsch_gordan(F_i: int, mF_i: int, F_f: int, polarization: str) -> float:
    """Table lookup; 0 for disallowed transitions. (laser_physics.py:830)"""
    entry = CLEBSCH_GORDAN_D2.get((F_i, mF_i, F_f))
    if entry is None:
        return 0.0
    return entry.get(polarization, 0.0)


def compute_all_rabi_frequencies(species, n_rydberg, power_1, power_2,
                                 waist_1, waist_2, Delta_e,
                                 intermediate_state: str | None = None) -> dict:
    """One-call Rabi summary. (laser_physics.py:875)"""
    sp = species if isinstance(species, SpeciesData) else get_species(species)
    key = intermediate_state or sp.default_intermediate
    dipole_1 = sp.intermediate_states[key].dipole_from_ground
    ns = effective_n(n_rydberg, sp, "S")
    ns_ref = effective_n(sp.n_ref, sp, "S")
    dipole_2 = sp.dipole_intermediate_to_rydberg_ref * (ns / ns_ref) ** (-1.5)
    Omega1 = single_photon_rabi(dipole_1, laser_E0(power_1, waist_1))
    Omega2 = single_photon_rabi(dipole_2, laser_E0(power_2, waist_2))
    Omega_eff = two_photon_rabi(Omega1, Omega2, Delta_e)
    two_pi = 2.0 * np.pi
    return {
        "Omega1": Omega1, "Omega2": Omega2, "Omega_eff": Omega_eff,
        "Omega1_MHz": Omega1 / two_pi / 1e6,
        "Omega2_MHz": Omega2 / two_pi / 1e6,
        "Omega_eff_MHz": Omega_eff / two_pi / 1e6,
        "Delta_e_GHz": Delta_e / two_pi / 1e9,
    }


__all__ = [
    "laser_intensity", "laser_E0", "single_photon_rabi",
    "single_photon_rabi_from_power", "two_photon_rabi",
    "required_powers_for_two_photon_rabi", "rydberg_blockade",
    "blockade_shift_MHz", "blockade_radius", "blockade_radius_um",
    "V_over_Omega", "spacing_for_target_V_over_Omega",
    "intermediate_state_scattering_rate", "dark_state_mixing_factor",
    "CLEBSCH_GORDAN_D2", "get_clebsch_gordan", "compute_all_rabi_frequencies",
]
