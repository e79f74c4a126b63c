"""Optical tweezer trap physics and trap-dependent noise.

Rebuild of the reference trap module
(reference: rydberg_gates/trap_physics.py:85-2192). All formulas are
numpy arithmetic; `compute_trap_dependent_noise` is the unified
trap->rates pipeline consumed by gate/simulate.py.
"""
from __future__ import annotations

# HOST-SIDE MODULE: intentionally numpy, not torch. SI-unit inputs
# (polarizabilities ~1e-39 C^2 m^2/J, C6 ~1e-57 (rad/s) m^6) underflow /
# flush-to-zero in float32, so trap planning must always run in f64 on the
# host. The device path consumes only the resulting *rates*.
import numpy as np

from ..core.constants import A0, C, EPS0, HBAR, KB, MU_B, TWO_PI
from ..core.atom_data import SpeciesData, get_species, get_C6, get_rydberg_lifetime
from .laser import intermediate_state_scattering_rate, rydberg_blockade

_AU_POL = 4.0 * np.pi * EPS0 * A0 ** 3


# =============================================================================
# polarizability vs wavelength / magic wavelength
# =============================================================================

def get_polarizability_at_wavelength(species, state: str, wavelength_nm,
                                     n_rydberg: int = 70, L_rydberg: int = 0,
                                     F: int | None = None):
    """Two-level-model dynamic polarizability [SI]. (trap_physics.py:85-207)

    Ground state: static value with a D1-resonance correction below the D1
    line. Rydberg state: ponderomotive (free-electron) model, alpha ~ lambda^2,
    scaled from the n_ref reference value with the n*^7 law.
    """
    sp = species if isinstance(species, SpeciesData) else get_species(species)
    wavelength_m = wavelength_nm * 1e-9
    omega = TWO_PI * C / wavelength_m

    if state.lower() in ("ground", "5s", "6s"):
        alpha_static = sp.alpha_ground
        if sp.name == "Rb87":
            omega_D1 = TWO_PI * 377.107e12
        else:
            omega_D1 = TWO_PI * 335.116e12
        if omega < omega_D1:
            alpha = alpha_static * (1.0 + 0.3 * omega ** 2 / (omega_D1 ** 2 - omega ** 2))
        else:
            alpha = alpha_static
        if F is not None and F in sp.alpha_hyperfine:
            alpha = sp.alpha_hyperfine[F]
        return alpha

    # Rydberg branch
    if state[0].isdigit():
        n_rydberg = int("".join(filter(str.isdigit, state)))
    L_label = {0: "S", 1: "P", 2: "D", 3: "F"}.get(L_rydberg, "S")
    dq = sp.quantum_defects.get(L_label, 3.0)
    n_star = n_rydberg - dq
    n_star_ref = sp.n_ref - dq
    alpha_static = sp.alpha_rydberg_ref * (n_star / n_star_ref) ** sp.scaling_exponents["polarizability"]
    return alpha_static * (wavelength_m / 1064e-9) ** 2


def magic_trap_enhancement(species, wavelength_nm, n_rydberg: int = 70):
    """1 at magic wavelength (alpha_r == alpha_g), <1 otherwise.
    (trap_physics.py:210-258)"""
    a_g = get_polarizability_at_wavelength(species, "ground", wavelength_nm)
    a_r = get_polarizability_at_wavelength(species, "rydberg", wavelength_nm,
                                           n_rydberg=n_rydberg)
    ratio = a_r / a_g if abs(a_g) > 1e-50 else 0.0
    return 1.0 / (1.0 + abs(1.0 - ratio))


# =============================================================================
# geometry / trap depth / frequencies / thermal motion
# =============================================================================

def tweezer_spacing(wavelength, NA, factor: float = 1.0):
    """R = factor * lambda / (2 NA). (trap_physics.py:265)"""
    return factor * wavelength / (2.0 * NA)


def diffraction_limited_spot(wavelength, NA):
    """w0 ~ 0.82 lambda / NA (Gaussian input). (trap_physics.py:318)"""
    return 0.82 * wavelength / NA


def trap_depth(power, waist, alpha):
    """U0 = |alpha| I0 / (2 eps0 c), I0 = 2P/(pi w^2). (trap_physics.py:347)"""
    I0 = 2.0 * power / (np.pi * waist ** 2)
    return np.abs(alpha) * I0 / (2.0 * EPS0 * C)


def trap_temperature(U0):
    return U0 / KB


def trap_frequencies(U0, mass, waist, wavelength):
    """(omega_r, omega_z): omega_r = sqrt(4U0/m w^2),
    omega_z = sqrt(2U0/m z_R^2), z_R = pi w^2/lambda. (trap_physics.py:466)"""
    z_R = np.pi * waist ** 2 / wavelength
    omega_r = np.sqrt(4.0 * U0 / (mass * waist ** 2))
    omega_z = np.sqrt(2.0 * U0 / (mass * z_R ** 2))
    return omega_r, omega_z


def position_uncertainty(temperature, mass, omega):
    """sigma = sqrt(kB T / m omega^2). (trap_physics.py:579)"""
    return np.sqrt(KB * temperature / (mass * omega ** 2))


def quantum_ground_state_size(mass, omega):
    """sigma0 = sqrt(hbar / 2 m omega). (trap_physics.py:643)"""
    return np.sqrt(HBAR / (2.0 * mass * omega))


def thermal_de_broglie_wavelength(temperature, mass):
    """lambda_dB = h / sqrt(2 pi m kB T). (trap_physics.py:688)"""
    h = TWO_PI * HBAR
    return h / np.sqrt(2.0 * np.pi * mass * KB * temperature)


def thermal_velocity(temperature, mass):
    """v = sqrt(kB T / m). (trap_physics.py:835)"""
    return np.sqrt(KB * temperature / mass)


# =============================================================================
# Rydberg anti-trapping and loss
# =============================================================================

def anti_trap_potential(U0_ground, alpha_ratio):
    """U_anti = |alpha_r/alpha_g| U0. (trap_physics.py:721)"""
    return U0_ground * alpha_ratio


def anti_trap_frequency(U0_ground, alpha_ratio, mass, waist):
    """Exponential escape rate omega_anti = sqrt(4 U_anti / m w^2).
    (trap_physics.py:787)"""
    return np.sqrt(4.0 * alpha_ratio * U0_ground / (mass * waist ** 2))


def atom_loss_probability(gate_time, U0, alpha_ratio, mass, waist, temperature,
                          rydberg_fraction: float = 0.3,
                          trap_on_during_rydberg: bool = True):
    """Loss probability from anti-trapping (cosh/sinh growth) or ballistic
    flight if the trap is blanked. (trap_physics.py:865-995)"""
    t_r = rydberg_fraction * gate_time
    omega_trap = np.sqrt(4.0 * U0 / (mass * waist ** 2))
    v_th = thermal_velocity(temperature, mass)
    capture_range = 2.0 * waist

    if trap_on_during_rydberg:
        omega_anti = anti_trap_frequency(U0, alpha_ratio, mass, waist)
        sigma0 = np.sqrt(KB * temperature / (mass * omega_trap ** 2))
        # clip the exponent so cosh stays finite in f32/f64
        x = np.clip(omega_anti * t_r, 0.0, 40.0)
        final_sigma = np.sqrt((sigma0 * np.cosh(x)) ** 2
                               + (v_th / np.maximum(omega_anti, 1e-30) * np.sinh(x)) ** 2)
        # Gaussian tail outside the recapture range:
        # P(|x| > capture) = erfc(capture / (sqrt(2) sigma)).
        # NOTE: intentional fix vs the reference (trap_physics.py:978), whose
        # 1 - exp(-(c/sigma)^2/2) DECREASES with spreading — inverted
        # asymptotics. This erfc form is monotonic in sigma as physics demands.
        from scipy.special import erfc
        P = erfc(capture_range / (np.sqrt(2.0) * np.maximum(final_sigma, 1e-30)))
        P = np.where((omega_anti > 0) & (t_r > 0), P, 0.0)
    else:
        drift = v_th * t_r
        P = np.where(drift > 0,
                      1.0 - np.exp(-(capture_range / np.maximum(drift, 1e-30)) ** 2 / 2.0),
                      0.0)
    return np.clip(P, 0.0, 1.0)


def effective_loss_rate(gate_time, U0, alpha_ratio, mass, waist, temperature,
                        rydberg_fraction: float = 0.3):
    """gamma_loss = -ln(1-P)/t, capped at 1/t. (trap_physics.py:998-1057)"""
    P = atom_loss_probability(gate_time, U0, alpha_ratio, mass, waist,
                              temperature, rydberg_fraction)
    P = np.clip(P, 0.0, 1.0 - 1e-12)
    gamma = -np.log1p(-P) / gate_time
    max_rate = 1.0 / gate_time
    return np.minimum(np.where(P >= 0.99, 5.0 / gate_time, gamma), max_rate)


# =============================================================================
# blockade fluctuation / dephasing rates
# =============================================================================

def blockade_fluctuation(R0, sigma_r):
    """|dV/V| = 6 sqrt(2) sigma / R. (trap_physics.py:1064)"""
    return 6.0 * np.sqrt(2.0) * sigma_r / R0


def thermal_dephasing_rate(delta_V_over_V, V0, Omega=None):
    """Blockade-fluctuation dephasing, 3-regime in V/Omega with smoothstep
    interpolation, capped at 10 MHz. (trap_physics.py:1118-1203)"""
    if Omega is None:
        Omega = TWO_PI * 5e6
    Omega = np.abs(Omega)
    V_over_Om = np.abs(V0) / Omega

    gamma_weak = (delta_V_over_V ** 2) * (V_over_Om ** 2) * Omega / TWO_PI
    gamma_strong = (delta_V_over_V ** 2) * (Omega / np.abs(V0)) ** 2 * Omega / TWO_PI
    x = np.clip((V_over_Om - 3.0) / 7.0, 0.0, 1.0)
    smooth = 3.0 * x ** 2 - 2.0 * x ** 3
    gamma_mid = gamma_weak * (1.0 - smooth) + gamma_strong * smooth

    gamma = np.where(V_over_Om < 3.0, gamma_weak,
                      np.where(V_over_Om > 10.0, gamma_strong, gamma_mid))
    return np.minimum(gamma, 10e6)


def doppler_dephasing_rate(temperature, mass, k_eff, gate_time):
    """gamma = (k_eff v_rms)^2 t_gate [Hz]. (trap_physics.py:1206-1288)"""
    v_rms = thermal_velocity(temperature, mass)
    return (k_eff * v_rms) ** 2 * gate_time


def intensity_noise_dephasing_rate(trap_depth_J, intensity_noise_frac,
                                   gate_time: float = 200e-9,
                                   differential_stark_fraction: float = 0.01):
    """gamma = (U0/hbar) (dI/I) f_diff. (trap_physics.py:1291-1362)"""
    return (trap_depth_J / HBAR) * intensity_noise_frac * differential_stark_fraction


def thermal_infidelity_estimate(R0, sigma_r, V0, Omega, gate_time):
    """(dV/V * V * t)^2 naive estimate. (trap_physics.py:1365)"""
    dphi = blockade_fluctuation(R0, sigma_r) * V0 * gate_time
    return dphi ** 2


# =============================================================================
# heating
# =============================================================================

def photon_recoil_energy(mass, wavelength):
    """(hbar k)^2/2m. (trap_physics.py:1415)"""
    k = TWO_PI / wavelength
    return (HBAR * k) ** 2 / (2.0 * mass)


def recoil_temperature(mass, wavelength):
    return photon_recoil_energy(mass, wavelength) / KB


def trap_heating_rate_intensity_noise(omega_trap, relative_intensity_noise=1e-4,
                                      noise_bandwidth=1e6):
    """(omega/4)(dI/I)^2 BW [quanta/s]. (trap_physics.py:1472)"""
    return (omega_trap / 4.0) * relative_intensity_noise ** 2 * noise_bandwidth


def trap_heating_rate_pointing_noise(omega_trap, waist, pointing_noise_rad=1e-6):
    """omega (dx/w)^2 [quanta/s]. (trap_physics.py:1510)"""
    return omega_trap * (pointing_noise_rad * 1.0 / waist) ** 2


# =============================================================================
# coherent shifts
# =============================================================================

def calculate_zeeman_shift(B_field, qubit_0, qubit_1, species) -> float:
    """Differential Zeeman shift between qubit states [rad/s].
    Clock pair: quadratic K_quad B^2; else linear g_F mu_B B dmF / hbar.
    (trap_physics.py:1851-1965)"""
    sp = species if isinstance(species, SpeciesData) else get_species(species)
    F0, mF0 = qubit_0
    F1, mF1 = qubit_1
    if mF0 == 0 and mF1 == 0:
        B_gauss = B_field * 1e4
        K_quad = {"Rb87": 575.0, "Cs133": 2000.0}.get(sp.name, 1000.0)
        return K_quad * B_gauss ** 2 * TWO_PI
    g_F0 = sp.g_F.get(F0, 0.5 if F0 == max(sp.g_F) else -0.5)
    g_F1 = sp.g_F.get(F1, 0.5 if F1 == max(sp.g_F) else -0.5)
    return (g_F1 * mF1 - g_F0 * mF0) * MU_B * B_field / HBAR


def calculate_stark_shift(tweezer_power, tweezer_waist, tweezer_wavelength,
                          alpha_ground, alpha_excited):
    """Differential ground->excited AC Stark shift [rad/s].
    (trap_physics.py:1968-2047)"""
    I_center = 2.0 * tweezer_power / (np.pi * tweezer_waist ** 2)
    delta_alpha = np.abs(alpha_excited - alpha_ground)
    return delta_alpha * I_center / (4.0 * np.pi * EPS0 * C * HBAR) * TWO_PI


# hyperfine differential polarizability, atomic units (Arora et al. PRA 76 052509)
_HYPERFINE_DIFFERENTIAL_AU = {"Rb87": 2.4, "Cs133": 7.0}
_AU_TO_SI = 1.6488e-41
_STARK_HZ_PER_MK = {"Rb87": 70e3, "Cs133": 200e3}


def calculate_qubit_stark_shift(tweezer_power, tweezer_waist,
                                species: str = "Rb87",
                                trap_depth_mK=None):
    """Differential AC Stark shift between the two hyperfine qubit states
    [rad/s]. (trap_physics.py:2050-2142)"""
    name = species.name if isinstance(species, SpeciesData) else species
    if trap_depth_mK is not None:
        delta_Hz = _STARK_HZ_PER_MK.get(name, 70e3) * trap_depth_mK
    else:
        dau = _HYPERFINE_DIFFERENTIAL_AU.get(name, 2.4) * _AU_TO_SI
        I_center = 2.0 * tweezer_power / (np.pi * tweezer_waist ** 2)
        delta_Hz = dau * I_center / (4.0 * np.pi * EPS0 * C * HBAR)
    return delta_Hz * TWO_PI


# =============================================================================
# unified pipeline
# =============================================================================

def compute_trap_properties(power, waist, wavelength, alpha, mass, temperature) -> dict:
    """All trap numbers in one call. (trap_physics.py:1546-1611)"""
    U0 = trap_depth(power, waist, alpha)
    omega_r, omega_z = trap_frequencies(U0, mass, waist, wavelength)
    sigma_r = position_uncertainty(temperature, mass, omega_r)
    sigma_z = position_uncertainty(temperature, mass, omega_z)
    return {
        "U0": U0, "omega_r": omega_r, "omega_z": omega_z,
        "sigma_r": sigma_r, "sigma_z": sigma_z,
        "v_thermal": thermal_velocity(temperature, mass),
        "sigma_quantum": quantum_ground_state_size(mass, omega_r),
        "U0_mK": U0 / KB * 1e3,
        "omega_r_kHz": omega_r / TWO_PI / 1e3,
        "omega_z_kHz": omega_z / TWO_PI / 1e3,
        "sigma_r_nm": sigma_r * 1e9,
        "sigma_z_nm": sigma_z * 1e9,
    }


def compute_trap_dependent_noise(
    species,
    tweezer_power,
    tweezer_waist,
    temperature,
    spacing,
    gate_time,
    n_rydberg: int = 70,
    gamma_phi_laser: float = 1e4,
    Omega_1: float = 0.0,
    Delta_e: float = TWO_PI * 5e9,
    intermediate_state: str | None = None,
    Omega_eff=None,
    tweezer_wavelength_nm: float = 1064.0,
    include_doppler: bool = True,
    include_intensity_noise: bool = True,
    intensity_noise_frac: float = 0.01,
    rydberg_wavelength_1_nm: float = 780.0,
    rydberg_wavelength_2_nm: float = 480.0,
    counter_propagating: bool = True,
) -> dict:
    """Unified tweezer-parameters -> noise-rates pipeline.
    (trap_physics.py:1614-1848)

    Returns rates keyed identically to the reference so downstream noise
    budgets are directly comparable.
    """
    sp = species if isinstance(species, SpeciesData) else get_species(species)
    C6 = get_C6(n_rydberg, sp)

    U0 = trap_depth(tweezer_power, tweezer_waist, sp.alpha_ground)
    omega_r, omega_z = trap_frequencies(U0, sp.mass, tweezer_waist, sp.trap_wavelength)
    sigma_r = position_uncertainty(temperature, sp.mass, omega_r)
    V = rydberg_blockade(C6, spacing)

    delta_V_over_V = blockade_fluctuation(spacing, sigma_r)
    gamma_phi_thermal = thermal_dephasing_rate(delta_V_over_V, V, Omega_eff)

    key = intermediate_state or sp.default_intermediate
    Gamma_e = sp.intermediate_states[key].linewidth
    if Omega_1 > 0 and Delta_e > 0:
        gamma_scatter = intermediate_state_scattering_rate(Omega_1, Delta_e, Gamma_e)
    else:
        gamma_scatter = 0.0

    alpha_ground = get_polarizability_at_wavelength(sp, "ground", tweezer_wavelength_nm)
    alpha_rydberg = get_polarizability_at_wavelength(sp, "rydberg", tweezer_wavelength_nm,
                                                     n_rydberg=n_rydberg)
    alpha_ratio = abs(alpha_rydberg / alpha_ground) if abs(alpha_ground) > 1e-50 else 0.0

    if alpha_ratio > 0 and gate_time > 0:
        gamma_loss_antitrap = effective_loss_rate(gate_time, U0, alpha_ratio,
                                                  sp.mass, tweezer_waist, temperature)
    else:
        gamma_loss_antitrap = 0.0

    I_center = 2.0 * EPS0 * C * np.abs(U0) / abs(alpha_ground) if abs(alpha_ground) > 1e-50 else 0.0
    differential_shift = (abs(alpha_rydberg - alpha_ground) * I_center
                          / (2.0 * EPS0 * C * HBAR * TWO_PI))
    enhancement = magic_trap_enhancement(sp, tweezer_wavelength_nm, n_rydberg)

    if include_doppler and gate_time > 0:
        k1 = TWO_PI / (rydberg_wavelength_1_nm * 1e-9)
        k2 = TWO_PI / (rydberg_wavelength_2_nm * 1e-9)
        k_eff = abs(k1 - k2) if counter_propagating else (k1 + k2)
        gamma_doppler = doppler_dephasing_rate(temperature, sp.mass, k_eff, gate_time)
    else:
        gamma_doppler = 0.0
        k_eff = 0.0

    if include_intensity_noise and intensity_noise_frac > 0:
        diff_frac = min(float(enhancement), 0.1)
        gamma_intensity = intensity_noise_dephasing_rate(U0, intensity_noise_frac,
                                                         gate_time, diff_frac)
    else:
        gamma_intensity = 0.0

    gamma_r = 1.0 / get_rydberg_lifetime(n_rydberg, sp, temperature=300.0)

    return {
        "trap_depth_uK": U0 / KB * 1e6,
        "trap_freq_radial_kHz": omega_r / TWO_PI / 1e3,
        "position_uncertainty_nm": sigma_r * 1e9,
        "V_over_2pi_MHz": V / TWO_PI / 1e6,
        "gamma_r": gamma_r,
        "gamma_scatter_intermediate": gamma_scatter,
        "gamma_phi_laser": gamma_phi_laser,
        "gamma_phi_thermal": gamma_phi_thermal,
        "gamma_phi_doppler": gamma_doppler,
        "gamma_phi_intensity": gamma_intensity,
        "gamma_loss_antitrap": gamma_loss_antitrap,
        "gamma_loss_background": 1e3,
        "blockade_fluctuation_percent": delta_V_over_V * 100.0,
        "intermediate_linewidth_MHz": Gamma_e / TWO_PI / 1e6,
        "k_eff_rad_per_m": k_eff,
        "v_thermal_m_per_s": thermal_velocity(temperature, sp.mass),
        "alpha_ratio": alpha_ratio,
        "alpha_ground_au": alpha_ground / _AU_POL,
        "alpha_rydberg_au": alpha_rydberg / _AU_POL,
        "differential_shift_Hz": differential_shift,
        "magic_enhancement": enhancement,
        "wavelength_nm": tweezer_wavelength_nm,
    }


__all__ = [
    "get_polarizability_at_wavelength", "magic_trap_enhancement",
    "tweezer_spacing", "diffraction_limited_spot", "trap_depth",
    "trap_temperature", "trap_frequencies", "position_uncertainty",
    "quantum_ground_state_size", "thermal_de_broglie_wavelength",
    "thermal_velocity", "anti_trap_potential", "anti_trap_frequency",
    "atom_loss_probability", "effective_loss_rate", "blockade_fluctuation",
    "thermal_dephasing_rate", "doppler_dephasing_rate",
    "intensity_noise_dephasing_rate", "thermal_infidelity_estimate",
    "photon_recoil_energy", "recoil_temperature",
    "trap_heating_rate_intensity_noise", "trap_heating_rate_pointing_noise",
    "calculate_zeeman_shift", "calculate_stark_shift",
    "calculate_qubit_stark_shift", "compute_trap_properties",
    "compute_trap_dependent_noise",
]
