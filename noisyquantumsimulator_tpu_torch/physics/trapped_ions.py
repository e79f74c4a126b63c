"""Trapped-ion micro-physics: analytic cross-checks + shuttling, readout.

Implements the reference's comment-only trapped-ion layer
(reference: src/qpu_simulator/micro_physics/trapped_ions/** — QCCD MS
gates / shuttling / motional modes / measurement / cooling specs, e.g.
qccd/gates.py:1-28 "MS gate -> CPTP map, duration, crosstalk").

NOTE — the engine-driven simulation in ``gate/ms_gate.py`` is the
authoritative MS-gate model: it evolves the spin (x) spin (x) motional
Lindbladian through the shared solver and extracts the CPTP map by
tomography. THIS module is the closed-form literature cross-check
(order-of-magnitude error budget; used for fast sweeps and as a sanity
pin in tests/test_ms_gate.py), not the oracle.

Analytic error models from the standard trapped-ion literature
(Soerensen & Moelmer PRA 62 022311; Ballance et al. PRL 117 060504):

  MS gate infidelity contributions:
    thermal (Debye-Waller):   eps_th ~ (pi^2/2) nbar eta^4 K^2  (spectator
                               mode carrier coupling; simplified)
    motional heating:         eps_heat ~ ndot * tau_gate / 2   (gate mode:
                               NOT eta^2-suppressed — heating displaces the
                               phase-space loop directly; Ballance thesis
                               §3.4, confirmed by the engine in
                               gate/ms_gate.py to the same prefactor)
    motional dephasing:       eps_mot ~ (tau_gate / tau_mot_coh)^2 /2
    laser dephasing:          eps_las ~ tau_gate / T2_laser
    off-resonant scattering:  eps_sc ~ gamma_sc * tau_gate

The outputs match the spec contract: CPTP map + duration + crosstalk.

Counterpart of the reference's `physics/trapped_ions.py`, copied; host
numpy and scipy.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np

from ..core.constants import HBAR, KB, TWO_PI

# common ion masses [kg]
ION_MASSES = {
    "Be9": 1.4965e-26, "Ca40": 6.6359e-26, "Sr88": 1.4600e-25,
    "Ba137": 2.2737e-25, "Yb171": 2.8384e-25,
}


def lamb_dicke_parameter(mass: float, omega_mode: float,
                         k_eff: float) -> float:
    """eta = k_eff * sqrt(hbar / (2 m omega))."""
    return k_eff * np.sqrt(HBAR / (2.0 * mass * omega_mode))


def axial_mode_frequencies(omega_z: float, n_ions: int) -> np.ndarray:
    """Lowest axial normal-mode frequencies of an n-ion chain (ratios from
    the standard harmonic-chain eigenproblem; exact for n<=3, asymptotic
    fit beyond)."""
    ratios = {1: [1.0], 2: [1.0, np.sqrt(3.0)],
              3: [1.0, np.sqrt(3.0), np.sqrt(5.8)]}
    if n_ions in ratios:
        return omega_z * np.asarray(ratios[n_ions])
    # James (1998) fit: mode k ~ sqrt of roughly linear spectrum
    ks = np.arange(1, n_ions + 1, dtype=float)
    return omega_z * np.sqrt(1.0 + 0.85 * (ks - 1) ** 1.7)


@dataclass
class MSGateResult:
    """Spec contract (micro_physics/trapped_ions/qccd/gates.py:20-28)."""
    duration: float
    fidelity: float
    error_map_pauli: np.ndarray     # (16,) twirled 2-qubit error probs
    crosstalk: float
    error_budget: Dict[str, float] = field(default_factory=dict)


def ms_gate(
    species: str = "Yb171",
    omega_mode: float = TWO_PI * 3e6,
    nbar: float = 0.05,
    heating_rate_quanta_per_s: float = 100.0,
    motional_coherence_time: float = 10e-3,
    laser_coherence_time: float = 1.0,
    scattering_rate: float = 1.0,
    detuning_from_mode: float = TWO_PI * 20e3,
    k_eff: float = 2.0 * TWO_PI / 355e-9,   # counter-propagating Raman
    n_loops: int = 1,
    neighbor_mode_splitting: float = TWO_PI * 1e6,
) -> MSGateResult:
    """Moelmer-Soerensen two-qubit gate error model.

    Gate time for K loops at detuning delta from the mode: tau = 2 pi K/delta.
    """
    mass = ION_MASSES[species]
    eta = lamb_dicke_parameter(mass, omega_mode, k_eff)
    tau = TWO_PI * n_loops / detuning_from_mode

    eps_th = (np.pi ** 2 / 2.0) * nbar * eta ** 4
    # gate-mode heating is NOT eta^2-suppressed: each quantum of heating
    # during the loop decoheres the spin-dependent displacement directly
    # (engine-verified in gate/ms_gate.py; Ballance thesis eq. 3.32)
    eps_heat = heating_rate_quanta_per_s * tau / 2.0
    eps_mot = 0.5 * (tau / motional_coherence_time) ** 2
    eps_las = tau / laser_coherence_time
    eps_sc = scattering_rate * tau
    # off-resonant coupling to the neighbouring mode
    eps_spect = (detuning_from_mode / neighbor_mode_splitting) ** 2 / 2.0

    budget = {"thermal": eps_th, "heating": eps_heat,
              "motional_dephasing": eps_mot, "laser_dephasing": eps_las,
              "scattering": eps_sc, "spectator_mode": eps_spect}
    eps = min(0.5, sum(budget.values()))
    fidelity = 1.0 - eps

    # twirled error decomposition: MS errors are dominated by collective
    # XX-type over/under-rotation + single-ion dephasing
    probs = np.zeros(16)
    probs[0] = 1.0 - eps
    xx = eps * 0.4                      # over/under rotation -> XX
    zi = eps * 0.2                      # dephasing on each ion
    dep = eps - xx - 2 * zi             # residual: uniform depolarizing
    labels = ["II", "IX", "IY", "IZ", "XI", "XX", "XY", "XZ",
              "YI", "YX", "YY", "YZ", "ZI", "ZX", "ZY", "ZZ"]
    probs[labels.index("XX")] += xx
    probs[labels.index("IZ")] += zi
    probs[labels.index("ZI")] += zi
    probs[1:] += dep / 15.0

    crosstalk = eps_spect + 0.1 * eps_th
    return MSGateResult(duration=tau, fidelity=fidelity,
                        error_map_pauli=probs, crosstalk=crosstalk,
                        error_budget=budget)


@dataclass
class ShuttleResult:
    """(micro_physics/trapped_ions/qccd/shuttling.py spec)"""
    duration: float
    heating_quanta: float
    loss_probability: float
    motional_phase: float


def shuttle(distance: float = 100e-6, omega_mode: float = TWO_PI * 3e6,
            speed_limit: float = 10.0, adiabatic_margin: float = 20.0,
            junction: bool = False) -> ShuttleResult:
    """QCCD ion transport: duration from adiabaticity (T >> 2pi/omega),
    heating from the standard diabatic excitation estimate."""
    T_min = adiabatic_margin * TWO_PI / omega_mode
    T_speed = distance / speed_limit
    T = max(T_min, T_speed) * (3.0 if junction else 1.0)
    wT = omega_mode * T
    n_heat = 1e4 / wT ** 2 + (0.5 if junction else 0.02)
    return ShuttleResult(duration=T, heating_quanta=n_heat,
                         loss_probability=1e-5 if not junction else 1e-4,
                         motional_phase=omega_mode * T % TWO_PI)


def fluorescence_readout(duration: float = 200e-6,
                         collection_efficiency: float = 0.02,
                         scatter_rate_bright: float = 1e7,
                         dark_leak_rate: float = 2.0,
                         threshold: Optional[int] = None
                         ) -> Tuple[np.ndarray, float]:
    """Ion-fluorescence confusion matrix from Poisson photon statistics.
    (micro_physics/trapped_ions/measurement spec)

    Bright state scatters ~scatter_rate*efficiency photons/s; the dark
    state leaks into the bright manifold at dark_leak_rate (off-resonant
    pumping)."""
    from scipy.stats import poisson
    mean_bright = scatter_rate_bright * collection_efficiency * duration
    thr = threshold if threshold is not None else max(1, int(mean_bright / 3))
    # P(dark read as bright): leak event then bright photons
    p_leak = 1.0 - np.exp(-dark_leak_rate * duration)
    p_dark_counts_above = p_leak * 0.5  # leak midway: ~half the photons
    eps_dark = p_dark_counts_above
    # P(bright read as dark): Poisson counts below threshold
    eps_bright = float(poisson.cdf(thr - 1, mean_bright))
    cm = np.array([[1 - eps_dark, eps_dark],
                   [eps_bright, 1 - eps_bright]])
    fid = 1.0 - 0.5 * (eps_dark + eps_bright)
    return cm, fid


def sideband_cooling_limit(omega_mode: float, linewidth: float) -> float:
    """Resolved-sideband cooling floor nbar ~ (Gamma / 2 omega)^2."""
    return (linewidth / (2.0 * omega_mode)) ** 2


# ---------------------------------------------------------------------------
# RF Paul trap micromotion (micro_physics/trapped_ions/paul spec)
# ---------------------------------------------------------------------------

def paul_stability(q: float, a: float = 0.0) -> dict:
    """Mathieu stability parameters of an RF Paul trap.

    Lowest stability region requires |a| small and q < ~0.908; the secular
    frequency in the pseudopotential approximation is
    omega_sec = (Omega_rf / 2) sqrt(a + q^2 / 2)."""
    stable = abs(q) < 0.908 and abs(a) < 0.237 and (a + q * q / 2.0) > 0
    beta = np.sqrt(max(a + q * q / 2.0, 0.0))
    return {"q": q, "a": a, "stable": bool(stable), "beta": float(beta)}


def paul_micromotion(
    omega_rf: float = TWO_PI * 30e6,
    q: float = 0.25,
    a: float = 0.0,
    excess_field: float = 0.0,        # stray DC field [V/m]
    charge: float = 1.602176634e-19,
    mass: float = ION_MASSES["Yb171"],
    wavelength: float = 369.5e-9,
) -> dict:
    """Micromotion amplitude and its error contributions.

    Intrinsic micromotion amplitude is (q/2) x_secular; excess micromotion
    from a stray field E displaces the ion by u0 = e E / (m omega_sec^2)
    and adds driven motion of amplitude (q/2) u0, producing second-order
    Doppler shifts and modulation-index sidebands on the drive lasers."""
    st = paul_stability(q, a)
    omega_sec = 0.5 * omega_rf * st["beta"]
    u0 = charge * excess_field / (mass * max(omega_sec, 1.0) ** 2)
    amp_excess = 0.5 * q * abs(u0)
    v_mm = amp_excess * omega_rf
    c = 299792458.0
    doppler_2nd = 0.5 * (v_mm / c) ** 2                # fractional shift
    k = TWO_PI / wavelength
    mod_index = k * amp_excess                         # laser phase mod
    return {"omega_secular": float(omega_sec), "stable": st["stable"],
            "excess_displacement": float(u0),
            "micromotion_amplitude": float(amp_excess),
            "second_order_doppler": float(doppler_2nd),
            "modulation_index": float(mod_index),
            "carrier_suppression": float(np.cos(mod_index) ** 2
                                         if mod_index < 2.4 else 0.0)}


# ---------------------------------------------------------------------------
# Penning trap rotating crystal (micro_physics/trapped_ions/penning spec)
# ---------------------------------------------------------------------------

def penning_frequencies(
    B: float = 4.5,                    # magnetic field [T]
    omega_z: float = TWO_PI * 800e3,   # axial frequency
    charge: float = 1.602176634e-19,
    mass: float = ION_MASSES["Be9"],
) -> dict:
    """Single-particle eigenfrequencies of a Penning trap: cyclotron
    omega_c = eB/m splits into modified cyclotron omega_+ and magnetron
    omega_- with omega_+/- = omega_c/2 +- sqrt(omega_c^2/4 - omega_z^2/2).
    Stability requires omega_c^2 > 2 omega_z^2."""
    omega_c = charge * B / mass
    disc = omega_c ** 2 / 4.0 - omega_z ** 2 / 2.0
    stable = disc > 0
    root = np.sqrt(max(disc, 0.0))
    return {"omega_cyclotron": float(omega_c),
            "omega_plus": float(omega_c / 2.0 + root),
            "omega_minus": float(omega_c / 2.0 - root),
            "omega_axial": float(omega_z),
            "stable": bool(stable)}


def penning_crystal(
    n_ions: int = 100,
    B: float = 4.5,
    omega_z: float = TWO_PI * 800e3,
    omega_rot: float = TWO_PI * 45e3,    # rotating-wall frequency (NIST-like)
    mass: float = 1.496e-26,             # Be9 [kg]
    charge: float = 1.602176634e-19,
) -> dict:
    """2D crystal properties in the rotating frame: effective radial
    confinement omega_r^2 = omega_rot (omega_c - omega_rot) - omega_z^2/2;
    planar for omega_r < omega_z; crystal radius from the Coulomb balance
    R ~ (N e^2 / (4 pi eps0 m omega_r^2))^(1/3)."""
    eps0 = 8.8541878128e-12
    omega_c = charge * B / mass
    wr2 = omega_rot * (omega_c - omega_rot) - omega_z ** 2 / 2.0
    planar = 0.0 < wr2 < omega_z ** 2
    wr2 = max(wr2, 1.0)
    R = (n_ions * charge ** 2 / (4 * np.pi * eps0 * mass * wr2)) ** (1 / 3)
    return {"omega_radial_eff": float(np.sqrt(wr2)),
            "planar": bool(planar), "radius": float(R),
            "spacing_estimate": float(R / max(np.sqrt(n_ions), 1.0) * 2.0),
            "n_ions": n_ions}


__all__ = ["ION_MASSES", "lamb_dicke_parameter", "axial_mode_frequencies",
           "MSGateResult", "ms_gate", "ShuttleResult", "shuttle",
           "fluorescence_readout", "sideband_cooling_limit",
           "paul_stability", "paul_micromotion", "penning_frequencies",
           "penning_crystal"]
