"""Pulse envelopes and spectral leakage analysis (vectorized numpy).

Rebuild of the reference pulse-shaping module
(reference: rydberg_gates/pulse_shaping.py:83-922). Envelopes are pure
numpy functions of a time array, so an entire shaped-pulse schedule is built
in one vectorized call (the reference evaluates the envelope per step in a
Python loop).
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

# HOST-SIDE MODULE: numpy on purpose (see physics/laser.py note).
import numpy as np

from ..core.constants import HBAR, MU_B, RY_JOULES, TWO_PI


# =============================================================================
# envelopes
# =============================================================================

def pulse_envelope_square(t, tau, **kwargs):
    """Constant envelope. (pulse_shaping.py:83)"""
    return np.ones_like(np.asarray(t, dtype=float))


def pulse_envelope_gaussian(t, tau, sigma_factor: float = 3.0, **kwargs):
    """exp(-(t-tau/2)^2/2 sigma^2), sigma = tau/sigma_factor, peak-normalized.
    (pulse_shaping.py:127)"""
    sigma = tau / sigma_factor
    env = np.exp(-((t - tau / 2.0) ** 2) / (2.0 * sigma ** 2))
    return env / np.max(env)


def pulse_envelope_cosine(t, tau, **kwargs):
    """sin^2(pi t / tau) (Hann window). (pulse_shaping.py:191)"""
    return np.sin(np.pi * t / tau) ** 2


def pulse_envelope_blackman(t, tau, **kwargs):
    """0.42 - 0.5 cos(2pi t/tau) + 0.08 cos(4pi t/tau), peak-normalized.
    (pulse_shaping.py:239)"""
    env = (0.42 - 0.5 * np.cos(TWO_PI * t / tau)
           + 0.08 * np.cos(2.0 * TWO_PI * t / tau))
    return env / np.max(env)


def pulse_envelope_drag(t, tau, Delta_leak, lambda_drag: float = 1.0,
                        base_shape: str = "gaussian", sigma_factor: float = 4.0,
                        **kwargs):
    """DRAG: base + i lambda dbase/dt / Delta_leak (complex).
    (pulse_shaping.py:298)"""
    if base_shape == "gaussian":
        base = pulse_envelope_gaussian(t, tau, sigma_factor=sigma_factor)
    elif base_shape == "cosine":
        base = pulse_envelope_cosine(t, tau)
    elif base_shape == "blackman":
        base = pulse_envelope_blackman(t, tau)
    else:
        raise ValueError(f"Unknown base_shape: {base_shape}")
    t = np.asarray(t)
    dt = (t[1] - t[0]) if (t.ndim and t.size > 1) else tau / 100.0
    d_base = np.gradient(base, dt) if (t.ndim and t.size > 1) else np.zeros_like(base)
    return base + 1j * (lambda_drag / np.abs(Delta_leak)) * d_base


PULSE_SHAPES: Dict[str, Callable] = {
    "square": pulse_envelope_square,
    "gaussian": pulse_envelope_gaussian,
    "cosine": pulse_envelope_cosine,
    "blackman": pulse_envelope_blackman,
    "drag": pulse_envelope_drag,
}


def get_pulse_envelope(shape: str, t, tau, **kwargs):
    """Dispatch by name. (pulse_shaping.py:407)"""
    key = shape.lower()
    if key not in PULSE_SHAPES:
        raise ValueError(f"Unknown pulse shape: {shape}. "
                         f"Available: {list(PULSE_SHAPES)}")
    return PULSE_SHAPES[key](t, tau, **kwargs)


def list_available_shapes():
    return list(PULSE_SHAPES)


# =============================================================================
# spectra
# =============================================================================

def spectral_leakage_factor(pulse_shape: str, tau: float, Delta_leak: float) -> float:
    """Normalized spectral power S(Delta) of the envelope at the leakage
    detuning. (pulse_shaping.py:478-570)"""
    x = Delta_leak * tau / TWO_PI
    if abs(x) < 1e-10:
        return 1.0
    if pulse_shape == "square":
        S = (np.sin(np.pi * x) / (np.pi * x)) ** 2
    elif pulse_shape == "gaussian":
        sigma = tau / 3.0
        S = np.exp(-(Delta_leak * sigma) ** 2)
    elif pulse_shape == "cosine":
        if abs(abs(x) - 0.5) < 1e-10:
            S = 0.25
        else:
            S = (np.sin(np.pi * x) / (np.pi * x) / (1.0 - x ** 2)) ** 2
    elif pulse_shape == "blackman":
        S_sinc = (np.sin(np.pi * x) / (np.pi * x)) ** 2
        S = min(np.exp(-3.0 * abs(x)) * S_sinc, S_sinc * 0.1)
    elif pulse_shape == "drag":
        S = np.exp(-(Delta_leak * tau / 12.0) ** 2) * 0.1
    else:
        S = (np.sin(np.pi * x) / (np.pi * x)) ** 2
    return float(np.clip(S, 0.0, 1.0))


def compute_leakage_detuning(species: str, n_rydberg: int, L: int = 0,
                             leakage_target: str = "fine_structure",
                             quantum_defect_S: float = 3.13) -> float:
    """Detuning to the nearest leakage state [rad/s].
    (pulse_shaping.py:573-658)"""
    if leakage_target == "fine_structure":
        return TWO_PI * 50e6
    if leakage_target == "adjacent_n":
        n_star = n_rydberg - quantum_defect_S
        return 2.0 * RY_JOULES / HBAR / n_star ** 3
    if leakage_target == "zeeman":
        return 2.002 * MU_B * 1e-4 / HBAR
    raise ValueError(f"Unknown leakage_target: {leakage_target}")


def leakage_rate_to_adjacent_states(Omega: float, Delta_leak: float,
                                    pulse_shape: str, tau: float) -> float:
    """gamma = 0.5 Delta (Omega/Delta)^2 S(Delta) [rad/s].
    (pulse_shaping.py:661-724). NOTE: distinct from the incoherent-leakage
    version in physics/noise_rates.py (noise_models.py:732), which is the one
    the gate pipeline uses."""
    S = spectral_leakage_factor(pulse_shape, tau, Delta_leak)
    return 0.5 * Delta_leak * (Omega / Delta_leak) ** 2 * S


# =============================================================================
# area
# =============================================================================

def compute_pulse_area(envelope, t):
    """integral |env| dt. (pulse_shaping.py:731)"""
    return np.trapezoid(np.abs(envelope), t)


def normalize_pulse_area(envelope, t, target_area):
    """Scale to a target area. (pulse_shaping.py:762)"""
    area = compute_pulse_area(envelope, t)
    return np.where(area < 1e-15, envelope, envelope * (target_area / area))


def area_correction_factor(pulse_shape: str, tau: float = 1.0) -> float:
    """square-area / shaped-area, for peak-Omega scaling.
    (pulse_shaping.py:795-842)"""
    if pulse_shape == "square":
        return 1.0
    t = np.linspace(0.0, tau, 1000)
    kwargs = {"Delta_leak": TWO_PI * 50e6} if pulse_shape == "drag" else {}
    env = np.asarray(get_pulse_envelope(pulse_shape, t, tau, **kwargs))
    area = np.trapezoid(np.abs(env), t)
    return float(tau / area) if area > 1e-15 else 1.0


def prepare_pulse_for_evolution(pulse_shape: str, t_pulse, tau,
                                preserve_area: bool = True, **kwargs
                                ) -> Tuple[np.ndarray, dict]:
    """Envelope + normalization + numerical floor. (pulse_shaping.py:849-922)"""
    env = np.asarray(get_pulse_envelope(pulse_shape, t_pulse, tau, **kwargs))
    if preserve_area:
        area_factor = np.trapezoid(np.abs(env), t_pulse) / tau if tau > 0 else 1.0
        env_n = env / area_factor
    else:
        area_factor = 1.0
        env_n = env
    floor = 1e-6
    env_safe = np.abs(env_n) + floor
    area_safe = np.trapezoid(env_safe, t_pulse)
    if area_safe > 0:
        env_safe = env_safe * tau / area_safe
    info = {"pulse_shape": pulse_shape, "area_factor": float(area_factor),
            "peak_scaling": float(np.max(np.abs(env_n))),
            "envelope_floor": floor,
            "is_complex": bool(np.any(np.iscomplex(env)))}
    return np.real(env_safe), info


__all__ = [
    "pulse_envelope_square", "pulse_envelope_gaussian", "pulse_envelope_cosine",
    "pulse_envelope_blackman", "pulse_envelope_drag", "PULSE_SHAPES",
    "get_pulse_envelope", "list_available_shapes", "spectral_leakage_factor",
    "compute_leakage_detuning", "leakage_rate_to_adjacent_states",
    "compute_pulse_area", "normalize_pulse_area", "area_correction_factor",
    "prepare_pulse_for_evolution",
]
