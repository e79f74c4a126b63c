"""Pauli channel library: standard channels, conversions, twirling.

Implements the stubbed shared noise-channel library of the reference
(reference: src/qpu_simulator/noise_models/pauli_channels.py:5-33,
leakage.py, loss.py — comment-only specs): depolarizing / dephasing /
asymmetric Pauli channels, the 15-rate two-qubit Pauli channel,
fidelity <-> rate and T1/T2 <-> rate conversions, and Pauli twirling of an
arbitrary channel (the bridge to the Layer-2 stochastic sampler).
Counterpart of the reference's `channels/pauli.py`, copied; host numpy.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .conversions import (pauli_basis, superop_to_ptm, unitary_superop)


# =============================================================================
# channel constructors (as Kraus lists / probability vectors)
# =============================================================================

def depolarizing_probs(p: float, n_qubits: int = 1) -> np.ndarray:
    """Probability vector over the 4^n Pauli basis for the depolarizing
    channel: identity with 1 - p + p/4^n, each non-identity with p/4^n."""
    k = 4 ** n_qubits
    probs = np.full(k, p / k)
    probs[0] = 1.0 - p + p / k
    return probs


def dephasing_probs(p: float) -> np.ndarray:
    """1-qubit phase-flip channel: [1-p/... ] I with prob 1-p/2? Standard:
    rho -> (1-p) rho + p Z rho Z."""
    return np.array([1.0 - p, 0.0, 0.0, p])


def bitflip_probs(p: float) -> np.ndarray:
    return np.array([1.0 - p, p, 0.0, 0.0])


def asymmetric_pauli_probs(px: float, py: float, pz: float) -> np.ndarray:
    return np.array([1.0 - px - py - pz, px, py, pz])


def two_qubit_pauli_probs(rates: Dict[str, float]) -> np.ndarray:
    """15-rate two-qubit Pauli channel: rates keyed by 'IX', 'ZZ', ...
    (pauli_channels.py:14 '2-qubit 15-rate')."""
    labels, _ = pauli_basis(2)
    probs = np.zeros(16)
    total = 0.0
    for k, v in rates.items():
        i = labels.index(k)
        if i == 0:
            raise ValueError("'II' is not an error; omit it")
        probs[i] = v
        total += v
    if total > 1.0:
        raise ValueError(f"total error probability {total} > 1")
    probs[0] = 1.0 - total
    return probs


def pauli_channel_superop(probs: Sequence[float], n_qubits: int) -> np.ndarray:
    """Superoperator of a Pauli channel from its probability vector."""
    _, P = pauli_basis(n_qubits)
    d = 2 ** n_qubits
    S = np.zeros((d * d, d * d), dtype=complex)
    for p, Pm in zip(probs, P):
        if p != 0:
            S += p * np.kron(Pm, Pm.conj())
    return S


def pauli_channel_kraus(probs: Sequence[float], n_qubits: int
                        ) -> List[np.ndarray]:
    _, P = pauli_basis(n_qubits)
    return [np.sqrt(p) * Pm for p, Pm in zip(probs, P) if p > 0]


# =============================================================================
# twirling
# =============================================================================

def pauli_twirl(S: np.ndarray) -> np.ndarray:
    """Pauli-twirl an arbitrary channel: probability of each Pauli error is
    the diagonal of the PTM mapped back, i.e. p_a = sum_b R[b,b] projections.

    For a channel with PTM R, the twirled channel's Pauli probabilities are
    p_a = (1/4^n) sum_b W[a,b] R[b,b] where W is the Walsh-Hadamard-like
    matrix W[a,b] = +1 if P_a, P_b commute else -1.
    """
    d2 = S.shape[0]
    n = int(round(np.log2(np.sqrt(d2))))
    R = superop_to_ptm(S)
    diag = np.real(np.diag(R))
    labels, P = pauli_basis(n)
    k = len(labels)
    W = np.empty((k, k))
    for a in range(k):
        for b in range(k):
            comm = np.allclose(P[a] @ P[b], P[b] @ P[a])
            W[a, b] = 1.0 if comm else -1.0
    probs = (W @ diag) / k
    probs = np.clip(probs, 0.0, None)
    s = probs.sum()
    if s > 0:
        probs = probs / s
    return probs


def twirled_error_probs(S: np.ndarray, U_target: np.ndarray) -> np.ndarray:
    """Twirl the error channel E_err = E o U_target^-1: the Pauli error
    probabilities Layer 2 injects after the ideal gate."""
    S_err = S @ unitary_superop(U_target).conj().T
    return pauli_twirl(S_err)


# =============================================================================
# rate conversions (pauli_channels.py:20-28 spec)
# =============================================================================

def fidelity_to_depolarizing_rate(avg_fidelity: float, d: int = 2) -> float:
    """p such that the depolarizing channel has the given average gate
    fidelity: F = 1 - p (d-1)/d ... using F_avg = 1 - p(1 - 1/d^2)(d/(d+1))."""
    # F_avg(depol p, dim d) = 1 - p * (d^2 - 1) / (d^2) * d / (d + 1)
    coeff = (d ** 2 - 1) / d ** 2 * d / (d + 1)
    return float(np.clip((1.0 - avg_fidelity) / coeff, 0.0, 1.0))


def depolarizing_rate_to_fidelity(p: float, d: int = 2) -> float:
    coeff = (d ** 2 - 1) / d ** 2 * d / (d + 1)
    return 1.0 - p * coeff


def t1_t2_to_pauli_rates(t1: float, t2: float, duration: float
                         ) -> Tuple[float, float, float]:
    """(px, py, pz) for an idle of `duration` with amplitude damping T1 and
    total dephasing T2 (Pauli-twirl of the combined channel).

    px = py = (1 - e^{-t/T1}) / 4
    pz = (1 - e^{-t/T2}) / 2 - (1 - e^{-t/T1}) / 4
    """
    ex1 = 1.0 - np.exp(-duration / t1) if t1 > 0 else 1.0
    ex2 = 1.0 - np.exp(-duration / t2) if t2 > 0 else 1.0
    px = py = ex1 / 4.0
    pz = max(0.0, ex2 / 2.0 - ex1 / 4.0)
    return float(px), float(py), float(pz)


def rates_to_t1_t2(px: float, py: float, pz: float, duration: float
                   ) -> Tuple[float, float]:
    """Inverse of t1_t2_to_pauli_rates (small-rate regime)."""
    ex1 = 4.0 * px
    ex2 = 2.0 * (pz + px)
    t1 = -duration / np.log(max(1e-15, 1.0 - ex1)) if ex1 > 0 else np.inf
    t2 = -duration / np.log(max(1e-15, 1.0 - ex2)) if ex2 > 0 else np.inf
    return float(t1), float(t2)


# =============================================================================
# leakage / loss channels (noise_models/leakage.py, loss.py specs)
# =============================================================================

def _check_prob(p: float, name: str):
    if not 0.0 <= p <= 1.0:
        raise ValueError(f"{name} must be in [0, 1], got {p}")


def leakage_extended_kraus(p_leak: float, d_comp: int = 2) -> List[np.ndarray]:
    """Kraus set on a (d_comp + 1)-dim space modeling leakage from the top
    computational level to a leakage level."""
    _check_prob(p_leak, "p_leak")
    d = d_comp + 1
    K0 = np.eye(d, dtype=complex)
    K0[d_comp - 1, d_comp - 1] = np.sqrt(1.0 - p_leak)
    K1 = np.zeros((d, d), dtype=complex)
    K1[d_comp, d_comp - 1] = np.sqrt(p_leak)
    return [K0, K1]


def loss_as_erasure_probs(gamma_loss: float, duration: float) -> float:
    """Erasure probability for an atom-loss rate over a duration
    (loss.py:13 'loss-as-erasure')."""
    return float(1.0 - np.exp(-gamma_loss * duration))


def seepage_kraus(p_seep: float, d_comp: int = 2,
                  branching: Optional[np.ndarray] = None
                  ) -> List[np.ndarray]:
    """Seepage: incoherent return from the leakage level into the
    computational subspace (leakage.py spec 'leakage/seepage').

    branching: probability distribution of the return level (default
    uniform over the computational levels)."""
    _check_prob(p_seep, "p_seep")
    d = d_comp + 1
    br = (np.full(d_comp, 1.0 / d_comp) if branching is None
          else np.asarray(branching, dtype=float))
    K0 = np.eye(d, dtype=complex)
    K0[d_comp, d_comp] = np.sqrt(1.0 - p_seep)
    ks = [K0]
    for lvl in range(d_comp):
        K = np.zeros((d, d), dtype=complex)
        K[lvl, d_comp] = np.sqrt(p_seep * br[lvl])
        ks.append(K)
    return ks


def leakage_reduction_unit(p_leaked: float, lru_fidelity: float = 0.999,
                           reset_error: float = 1e-3) -> Dict[str, float]:
    """Leakage Reduction Unit model (leakage.py spec 'LRU modeling'):
    a swap-with-fresh-ancilla (or optical-pumping) cycle that converts
    leakage population into computational-subspace depolarization.

    Returns the post-LRU leakage population and the Pauli error the LRU
    injects on non-leaked qubits."""
    residual = p_leaked * (1.0 - lru_fidelity)
    converted = p_leaked * lru_fidelity
    return {
        "leakage_before": p_leaked,
        "leakage_after": float(residual),
        "depolarizing_injected": float(converted + reset_error),
        "herald_probability": float(converted),   # LRUs herald conversions
    }


__all__ = [
    "depolarizing_probs", "dephasing_probs", "bitflip_probs",
    "asymmetric_pauli_probs", "two_qubit_pauli_probs",
    "pauli_channel_superop", "pauli_channel_kraus", "pauli_twirl",
    "twirled_error_probs", "fidelity_to_depolarizing_rate",
    "depolarizing_rate_to_fidelity", "t1_t2_to_pauli_rates",
    "rates_to_t1_t2", "leakage_extended_kraus", "loss_as_erasure_probs",
    "seepage_kraus", "leakage_reduction_unit",
]
