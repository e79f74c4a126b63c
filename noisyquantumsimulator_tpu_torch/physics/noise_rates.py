"""Noise rate calculators (Part 1 of the reference noise model).

Rebuild of the rate half of the reference noise module
(reference: rydberg_gates/noise_models.py:190-1150). Collapse-operator
construction lives in ops/lindblad.py (array-valued, no QuTiP).
"""
from __future__ import annotations

from dataclasses import dataclass, asdict

# HOST-SIDE MODULE: numpy on purpose (see physics/trap.py note).
import numpy as np

from ..core.constants import HBAR, KB, MU_B, TWO_PI
from .laser import intermediate_state_scattering_rate  # re-export path parity


@dataclass
class NoiseRates:
    """All Lindblad rates [rad/s or Hz per reference convention].
    (noise_models.py:190-303)"""
    gamma_r: float = 0.0
    gamma_bbr: float = 0.0
    gamma_phi_laser: float = 0.0
    gamma_phi_thermal: float = 0.0
    gamma_phi_zeeman: float = 0.0
    gamma_loss_antitrap: float = 0.0
    gamma_loss_bg: float = 0.0
    gamma_scatter: float = 0.0
    gamma_leakage: float = 0.0
    gamma_mJ: float = 0.0

    @property
    def total_decay_rate(self) -> float:
        return (self.gamma_r + self.gamma_bbr + self.gamma_loss_antitrap
                + self.gamma_loss_bg + self.gamma_scatter + self.gamma_leakage)

    @property
    def total_dephasing_rate(self) -> float:
        return (self.gamma_phi_laser + self.gamma_phi_thermal
                + self.gamma_phi_zeeman + self.gamma_mJ)

    @property
    def total_T2_rate(self) -> float:
        return 0.5 * self.total_decay_rate + self.total_dephasing_rate

    def to_dict(self) -> dict:
        d = asdict(self)
        d["total_decay"] = self.total_decay_rate
        d["total_dephasing"] = self.total_dephasing_rate
        return d

    def summary_table(self, gate_time: float = 1e-6) -> str:
        rows = [
            ("Rydberg decay", self.gamma_r), ("BBR decay", self.gamma_bbr),
            ("Laser dephasing", self.gamma_phi_laser),
            ("Thermal dephasing", self.gamma_phi_thermal),
            ("Zeeman dephasing", self.gamma_phi_zeeman),
            ("Anti-trap loss", self.gamma_loss_antitrap),
            ("Background loss", self.gamma_loss_bg),
            ("Int. state scatter", self.gamma_scatter),
            ("Rydberg leakage", self.gamma_leakage),
            ("mJ mixing", self.gamma_mJ),
        ]
        lines = ["=" * 60, "NOISE RATE SUMMARY", "=" * 60,
                 f"{'Source':<30} {'Rate (kHz)':<15} Error/gate (%)", "-" * 60]
        for name, rate in rows:
            lines.append(f"{name:<30} {rate / (TWO_PI * 1e3):<15.2f} "
                         f"{rate * gate_time * 100:.3f}")
        lines += ["-" * 60,
                  f"{'TOTAL DECAY':<30} {self.total_decay_rate / (TWO_PI * 1e3):<15.2f} "
                  f"{self.total_decay_rate * gate_time * 100:.3f}",
                  f"{'TOTAL DEPHASING':<30} {self.total_dephasing_rate / (TWO_PI * 1e3):<15.2f} "
                  f"{self.total_dephasing_rate * gate_time * 100:.3f}", "=" * 60]
        return "\n".join(lines)


# =============================================================================
# individual rate calculators
# =============================================================================

def rydberg_decay_rate(lifetime):
    """gamma_r = 1/tau. (noise_models.py:310)"""
    return np.where(lifetime > 0, 1.0 / np.maximum(lifetime, 1e-300), 0.0)


def bbr_decay_rate(lifetime_0K, lifetime_T):
    """gamma_bbr = 1/tau_T - 1/tau_0K (>= 0). (noise_models.py:364)"""
    g = 1.0 / np.maximum(lifetime_T, 1e-300) - 1.0 / np.maximum(lifetime_0K, 1e-300)
    valid = (lifetime_0K > 0) & (lifetime_T > 0)
    return np.where(valid, np.maximum(g, 0.0), 0.0)


def laser_dephasing_rate(linewidth_hz):
    """gamma_phi = 2 pi * linewidth. (noise_models.py:420)"""
    return TWO_PI * linewidth_hz


def zeeman_dephasing_rate(B_noise_gauss, qubit_type: str = "clock",
                          K_quad: float = 575.0):
    """Clock: df = 2 K_quad B_bias dB (B_bias = 1 G); stretched:
    df = 700 kHz/G * dB. Returns rad/s. (noise_models.py:483-554)"""
    if qubit_type == "clock":
        df_Hz = 2.0 * K_quad * 1.0 * B_noise_gauss
    elif qubit_type == "stretched":
        df_Hz = 700e3 * B_noise_gauss
    else:
        raise ValueError(f"Unknown qubit_type: {qubit_type}")
    return TWO_PI * df_Hz


def dark_state_suppression_factor(Delta_e, delta, Omega_1, Omega_2):
    """Empirical dark-state scattering suppression (~0.42 in the optimal
    regime, per the Bluvstein error budget). (noise_models.py:620-686)"""
    Omega_eff = Omega_1 * Omega_2 / (2.0 * abs(Delta_e))
    is_dark = (np.sign(Delta_e) == np.sign(delta)) and abs(delta) > 1e-6
    if not is_dark:
        return 1.0
    ratio = abs(delta) / (abs(Omega_eff) + 1e-10)
    if 0.1 < ratio < 2.0:
        s = 0.42
    else:
        s = 0.42 + 0.58 * (1.0 - np.exp(-abs(ratio - 0.377) / 0.5))
    return min(s, 1.5)


def enhanced_scattering_rate(Omega_1, Omega_2, Delta_e, delta, Gamma_e,
                             use_dark_state: bool = True):
    """Scattering with optional dark-state suppression. (noise_models.py:689)"""
    g = intermediate_state_scattering_rate(Omega_1, Delta_e, Gamma_e)
    if use_dark_state:
        g = g * dark_state_suppression_factor(Delta_e, delta, Omega_1, Omega_2)
    return g


def leakage_rate_to_adjacent_states(Omega, Delta_leak, pulse_shape: str = "square",
                                    tau: float = 1e-6,
                                    gamma_rydberg: float = 7143.0):
    """Incoherent leakage: (Omega/Delta)^2 * gamma_ryd * S(shape) [Hz].
    (noise_models.py:732-849)"""
    Omega = float(Omega)
    Delta_leak = float(Delta_leak)
    if abs(Delta_leak) < 1e-6 or abs(Omega) < 1e-6:
        return 0.0
    x = Delta_leak * tau / TWO_PI
    if abs(x) < 1e-10:
        S = 1.0
    elif pulse_shape == "square":
        S = (np.sin(np.pi * x) / (np.pi * x)) ** 2
    elif pulse_shape == "gaussian":
        S = np.exp(-(Delta_leak * tau / 8.0) ** 2)
    elif pulse_shape == "cosine":
        if abs(abs(x) - 0.5) < 1e-10:
            S = 0.25
        else:
            S = (np.sin(np.pi * x) / (np.pi * x * (1.0 - x ** 2))) ** 2
    elif pulse_shape == "blackman":
        S = np.exp(-3.0 * abs(x)) * 0.1
    elif pulse_shape == "drag":
        S = np.exp(-(Delta_leak * tau / 8.0) ** 2) * 0.1
    else:
        S = (np.sin(np.pi * x) / (np.pi * x + 1e-10)) ** 2
    S = float(np.clip(S, 0.0, 1.0))
    return (Omega / Delta_leak) ** 2 * gamma_rydberg * S


def mJ_mixing_rate(Omega_eff, polarization_purity, Delta_zeeman):
    """gamma_mJ = eps^2 Omega^2 / Delta_Z. (noise_models.py:856-910)"""
    eps = 1.0 - polarization_purity
    if abs(Delta_zeeman) < 1e-10:
        return eps ** 2 * abs(Omega_eff)
    return eps ** 2 * Omega_eff ** 2 / abs(Delta_zeeman)


def rydberg_zeeman_splitting(B_field, L: int = 0, J: float = 0.5):
    """g_J mu_B B / hbar (with QED correction for S states).
    (noise_models.py:913-959)"""
    S = 0.5
    g_J = 0.0 if J == 0 else 1.0 + (J * (J + 1) + S * (S + 1) - L * (L + 1)) / (2 * J * (J + 1))
    if L == 0:
        g_J += 0.002
    return g_J * MU_B * B_field / HBAR


def compute_noise_rates(
    species: str = "Rb87",
    n_rydberg: int = 70,
    rydberg_lifetime: float = 140e-6,
    rydberg_lifetime_0K: float = 280e-6,
    Omega_eff: float = TWO_PI * 5e6,
    Omega_1=None,
    Omega_2=None,
    Delta_e: float = TWO_PI * 1e9,
    delta: float = 0.0,
    Gamma_e: float = TWO_PI * 6.065e6,
    laser_linewidth_hz: float = 1e3,
    temperature: float = 20e-6,
    omega_trap: float = TWO_PI * 100e3,
    V: float = TWO_PI * 200e6,
    R: float = 3e-6,
    B_field: float = 0.5e-4,
    B_noise_gauss: float = 0.001,
    qubit_type: str = "clock",
    polarization_purity: float = 0.99,
    U0=None,
    alpha_ratio: float = 300.0,
    mass: float = 1.44e-25,
    waist: float = 1e-6,
    gate_time: float = 1e-6,
    rydberg_fraction: float = 0.3,
    pulse_shape: str = "square",
    use_dark_state: bool = True,
) -> NoiseRates:
    """One-call aggregate of all noise channels. (noise_models.py:966-1150)"""
    from .trap import effective_loss_rate

    if Omega_1 is None:
        Omega_1 = float(np.sqrt(2.0 * abs(Delta_e) * abs(Omega_eff)))
    if Omega_2 is None:
        Omega_2 = Omega_1

    gamma_r = float(rydberg_decay_rate(rydberg_lifetime_0K))
    gamma_bbr = float(bbr_decay_rate(rydberg_lifetime_0K, rydberg_lifetime))
    gamma_phi_laser = float(laser_dephasing_rate(laser_linewidth_hz))

    sigma_r = np.sqrt(KB * temperature / (mass * omega_trap ** 2))
    delta_V_over_V = 6.0 * np.sqrt(2.0) * sigma_r / R
    V_over_Om = abs(V) / abs(Omega_eff)
    if V_over_Om < 3:
        infid = delta_V_over_V ** 2 * V_over_Om ** 2
    elif V_over_Om > 10:
        infid = delta_V_over_V ** 2 * (Omega_eff / V) ** 2
    else:
        infid = delta_V_over_V ** 2
    gamma_phi_thermal = infid * abs(Omega_eff) / TWO_PI

    gamma_phi_zeeman = float(zeeman_dephasing_rate(B_noise_gauss, qubit_type))

    gamma_loss_antitrap = 0.0
    if U0 is not None and U0 > 0:
        gamma_loss_antitrap = float(effective_loss_rate(
            gate_time, U0, alpha_ratio, mass, waist, temperature, rydberg_fraction))

    gamma_loss_bg = TWO_PI * 0.1
    gamma_scatter = float(enhanced_scattering_rate(
        Omega_1, Omega_2, Delta_e, delta, Gamma_e, use_dark_state))
    gamma_leakage = leakage_rate_to_adjacent_states(
        Omega_eff, TWO_PI * 50e6, pulse_shape, gate_time)
    gamma_mJ = float(mJ_mixing_rate(Omega_eff, polarization_purity,
                                    rydberg_zeeman_splitting(B_field, L=0, J=0.5)))

    return NoiseRates(
        gamma_r=gamma_r, gamma_bbr=gamma_bbr,
        gamma_phi_laser=gamma_phi_laser,
        gamma_phi_thermal=float(gamma_phi_thermal),
        gamma_phi_zeeman=gamma_phi_zeeman,
        gamma_loss_antitrap=gamma_loss_antitrap,
        gamma_loss_bg=gamma_loss_bg, gamma_scatter=gamma_scatter,
        gamma_leakage=gamma_leakage, gamma_mJ=gamma_mJ,
    )


__all__ = [
    "NoiseRates", "rydberg_decay_rate", "bbr_decay_rate",
    "laser_dephasing_rate", "zeeman_dephasing_rate",
    "intermediate_state_scattering_rate", "dark_state_suppression_factor",
    "enhanced_scattering_rate", "leakage_rate_to_adjacent_states",
    "mJ_mixing_rate", "rydberg_zeeman_splitting", "compute_noise_rates",
]
