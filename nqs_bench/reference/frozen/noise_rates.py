# Frozen copy of the port's host plan code (noisyquantumsimulator_tpu_torch/physics/noise_rates.py), kept so that the
# benchmark's reference rebuilds the gate from its configuration file without
# importing the program. Only the imports were changed, and what the reference
# never reaches was left out.
"""Noise rate calculators (Part 1 of the reference noise model).

Rebuild of the rate half of the reference noise module
(reference: rydberg_gates/noise_models.py:190-1150). Collapse-operator
construction lives in ops/lindblad.py (array-valued, no QuTiP).
"""
from __future__ import annotations

# HOST-SIDE MODULE: numpy on purpose (see physics/trap.py note).
import numpy as np

from .constants import HBAR, MU_B, TWO_PI


# =============================================================================
# individual rate calculators
# =============================================================================

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
