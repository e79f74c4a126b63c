"""Cavity-QED micro-physics: Jaynes-Cummings gates, Purcell physics.

Implements the reference's comment-only cavity layer
(reference: src/qpu_simulator/micro_physics/cavity_qed/** — Jaynes-
Cummings cavity gates, photon-mediated entangling specs).

Standard cavity-QED figures of merit (Reiserer & Rempe RMP 87 1379):
  cooperativity C = g^2 / (kappa gamma)
  photon-mediated gate error ~ 1/sqrt(C) (reflection gates) or ~ 1/C.

Counterpart of the reference's `physics/cavity_qed.py`, copied; host numpy.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Tuple

import numpy as np

from ..core.constants import TWO_PI


def cooperativity(g: float, kappa: float, gamma: float) -> float:
    """C = g^2 / (kappa gamma)."""
    return g ** 2 / (kappa * gamma)


def vacuum_rabi_splitting(g: float) -> float:
    """2g."""
    return 2.0 * g


def purcell_factor(g: float, kappa: float, gamma: float) -> float:
    """Purcell enhancement of emission into the cavity: F_P = 2C."""
    return 2.0 * cooperativity(g, kappa, gamma)


def purcell_decay_rate(g: float, kappa: float, gamma: float) -> float:
    """Cavity-enhanced decay gamma' = gamma (1 + 2C) in the fast-cavity
    regime."""
    return gamma * (1.0 + 2.0 * cooperativity(g, kappa, gamma))


def jaynes_cummings_hamiltonian(g: float, detuning: float,
                                n_fock: int = 5) -> np.ndarray:
    """JC Hamiltonian on {atom(2)} x {fock(n)} in the RWA:
    H = -Delta |e><e| + g (a sigma+ + a^dag sigma-). Dense array for the
    Lindblad engine (ops/lindblad consumes it directly)."""
    dim = 2 * n_fock
    H = np.zeros((dim, dim), dtype=complex)

    def idx(atom, n):
        return atom * n_fock + n

    for n in range(n_fock):
        H[idx(1, n), idx(1, n)] = -detuning
        if n + 1 < n_fock:
            # |g, n+1> <-> |e, n>
            c = g * np.sqrt(n + 1)
            H[idx(1, n), idx(0, n + 1)] = c
            H[idx(0, n + 1), idx(1, n)] = c
    return H


@dataclass
class CavityGateResult:
    """Spec contract: CPTP-grade error summary + duration."""
    duration: float
    fidelity: float
    error_budget: Dict[str, float] = field(default_factory=dict)


def photon_mediated_gate(g: float = TWO_PI * 10e6, kappa: float = TWO_PI * 1e6,
                         gamma: float = TWO_PI * 3e6,
                         technique: str = "reflection") -> CavityGateResult:
    """Photon-mediated two-qubit gate error model.

    reflection (Duan-Kimble): eps ~ 2/sqrt(C) + kappa-limited timing
    raman_virtual: eps ~ (kappa/g) + (gamma/g) with tau ~ 2pi/g_eff
    """
    C = cooperativity(g, kappa, gamma)
    if technique == "reflection":
        eps_C = 2.0 / np.sqrt(max(C, 1e-9))
        tau = 10.0 / kappa  # photon bandwidth-limited
        budget = {"cooperativity": eps_C, "photon_loss": 1.0 / max(C, 1e-9)}
    elif technique == "raman_virtual":
        g_eff = g ** 2 / (10.0 * g)  # virtual-photon effective coupling
        tau = TWO_PI / g_eff
        budget = {"cavity_decay": kappa * tau / 4.0,
                  "atomic_decay": gamma * tau / 4.0}
    else:
        raise ValueError(f"Unknown technique: {technique}")
    eps = min(0.9, sum(budget.values()))
    return CavityGateResult(duration=tau, fidelity=1.0 - eps,
                            error_budget=budget)


def atom_cavity_spectrum(g: float, kappa: float, gamma: float,
                         detunings: np.ndarray) -> np.ndarray:
    """Normalized cavity transmission vs probe detuning (vacuum-Rabi
    doublet) — the standard diagnostic curve."""
    chi = 1.0 / (1j * detunings + gamma / 2.0)
    t = (kappa / 2.0) / (1j * detunings + kappa / 2.0 + g ** 2 * chi)
    return np.abs(t) ** 2


__all__ = ["cooperativity", "vacuum_rabi_splitting", "purcell_factor",
           "purcell_decay_rate", "jaynes_cummings_hamiltonian",
           "CavityGateResult", "photon_mediated_gate", "atom_cavity_spectrum"]
