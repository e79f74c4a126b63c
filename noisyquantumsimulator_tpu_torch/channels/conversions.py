"""Quantum channel representation conversions: superop / Choi / Kraus / PTM / chi.

Implements the stubbed channel-conversion library of the reference
(reference: src/qpu_simulator/noise_models/pauli_channels.py:5-33 and
src/qpu_simulator/utils/math_utils.py:5-13 — comment-only specs), as
dense host numpy transforms. Counterpart of the reference's
`channels/conversions.py`, copied; it runs on the host in both packages.

Conventions:
  * superoperator: row-major vec, vec(A X B) = (A kron B^T) vec(X)
  * Choi matrix: C = sum_ij E(|i><j|) kron |i><j|  (unnormalized, trace d)
  * PTM: R[a,b] = Tr(P_a E(P_b)) / d over the n-qubit Pauli basis
  * chi: E(rho) = sum_mn chi[m,n] P_m rho P_n^dag
"""
from __future__ import annotations

from functools import lru_cache
from itertools import product
from typing import List, Sequence, Tuple

import numpy as np

_I2 = np.eye(2, dtype=complex)
_X = np.array([[0, 1], [1, 0]], dtype=complex)
_Y = np.array([[0, -1j], [1j, 0]], dtype=complex)
_Z = np.array([[1, 0], [0, -1]], dtype=complex)
PAULIS_1Q = {"I": _I2, "X": _X, "Y": _Y, "Z": _Z}


@lru_cache(maxsize=8)
def pauli_basis(n_qubits: int) -> Tuple[Tuple[str, ...], np.ndarray]:
    """All n-qubit Pauli strings and their matrices, shape (4^n, d, d)."""
    labels = []
    mats = []
    for combo in product("IXYZ", repeat=n_qubits):
        label = "".join(combo)
        m = np.array([[1.0]], dtype=complex)
        for c in combo:
            m = np.kron(m, PAULIS_1Q[c])
        labels.append(label)
        mats.append(m)
    return tuple(labels), np.stack(mats)


# --------------------------------------------------------------------------
# superoperator <-> Choi
# --------------------------------------------------------------------------

def superop_to_choi(S: np.ndarray) -> np.ndarray:
    """S: (d^2, d^2) row-major-vec superoperator -> Choi (d^2, d^2).

    With row-major vec, S[(i,j),(k,l)] = <i|E(|k><l|)|j>, and the Choi matrix
    (system-first convention) is C[(i,k),(j,l)] = <i|E(|k><l|)|j>.
    """
    d = int(round(np.sqrt(S.shape[0])))
    T = S.reshape(d, d, d, d)          # [i, j, k, l]
    C = T.transpose(0, 2, 1, 3)        # [i, k, j, l]
    return C.reshape(d * d, d * d)


def choi_to_superop(C: np.ndarray) -> np.ndarray:
    d = int(round(np.sqrt(C.shape[0])))
    T = C.reshape(d, d, d, d)          # [i, k, j, l]
    S = T.transpose(0, 2, 1, 3)        # [i, j, k, l]
    return S.reshape(d * d, d * d)


# --------------------------------------------------------------------------
# Choi <-> Kraus
# --------------------------------------------------------------------------

def choi_to_kraus(C: np.ndarray, tol: float = 1e-12) -> List[np.ndarray]:
    """Eigendecompose the Choi matrix into Kraus operators."""
    d = int(round(np.sqrt(C.shape[0])))
    evals, evecs = np.linalg.eigh((C + C.conj().T) / 2.0)
    kraus = []
    for lam, v in zip(evals[::-1], evecs.T[::-1]):
        if lam < tol:
            continue
        K = np.sqrt(lam) * v.reshape(d, d)
        kraus.append(K)
    return kraus


def kraus_to_superop(kraus: Sequence[np.ndarray]) -> np.ndarray:
    d = kraus[0].shape[0]
    S = np.zeros((d * d, d * d), dtype=complex)
    for K in kraus:
        S += np.kron(K, K.conj())
    return S


def kraus_to_choi(kraus: Sequence[np.ndarray]) -> np.ndarray:
    return superop_to_choi(kraus_to_superop(kraus))


# --------------------------------------------------------------------------
# PTM / chi
# --------------------------------------------------------------------------

def superop_to_ptm(S: np.ndarray) -> np.ndarray:
    """Pauli transfer matrix R[a,b] = Tr(P_a E(P_b)) / d."""
    d = int(round(np.sqrt(S.shape[0])))
    n = int(round(np.log2(d)))
    _, P = pauli_basis(n)
    d2 = d * d
    # vec each Pauli (row-major), E acts by S
    Pv = P.reshape(-1, d2)                       # (4^n, d^2)
    EP = Pv @ S.T                                # E(P_b) vec'd, rows b
    # Tr(P_a M) = vec(P_a^T) . vec(M)
    PT = np.transpose(P, (0, 2, 1)).reshape(-1, d2)
    return np.real(PT @ EP.T) / d                # (a, b)


def ptm_to_superop(R: np.ndarray) -> np.ndarray:
    n = int(round(np.log2(np.sqrt(R.shape[0]))))
    _, P = pauli_basis(n)
    d = 2 ** n
    d2 = d * d
    Pv = P.reshape(-1, d2)
    # E = (1/d) sum_ab R[a,b] |P_a>> <<P_b|  with <<P_b| = vec(P_b^T)^T?
    # rho = (1/d) sum_b Tr(P_b rho) P_b ; E(rho) = (1/d) sum_ab R[ab] Tr(P_b rho) P_a
    PT = np.transpose(P, (0, 2, 1)).reshape(-1, d2)
    return (Pv.T @ R @ PT) / d


def choi_to_chi(C: np.ndarray) -> np.ndarray:
    """chi matrix in the Pauli basis: chi = B C B^dag / d^... via basis change.

    E(rho) = sum_mn chi[mn] P_m rho P_n^dag. The Choi of that map is
    sum_mn chi[mn] vec'(P_m) vec'(P_n)^dag with vec'(K)[(i,k)] = K[i,k]
    matching superop_to_choi's (i,k) ordering.
    """
    d = int(round(np.sqrt(C.shape[0])))
    n = int(round(np.log2(d)))
    _, P = pauli_basis(n)
    B = P.reshape(-1, d * d)      # vec'(P_m) rows: P[m][i,k] flattened
    Binv = B.conj() / d           # orthogonality: Tr(Pm Pn) = d delta
    chi = Binv @ C @ Binv.conj().T
    return chi


def chi_to_choi(chi: np.ndarray) -> np.ndarray:
    d2 = chi.shape[0]
    n = int(round(np.log2(np.sqrt(d2))))
    _, P = pauli_basis(n)
    d = 2 ** n
    B = P.reshape(-1, d * d)
    return B.T @ chi @ B.conj()


# --------------------------------------------------------------------------
# metrics
# --------------------------------------------------------------------------

def unitary_superop(U: np.ndarray) -> np.ndarray:
    return np.kron(U, U.conj())


def average_gate_fidelity(S: np.ndarray, U_target: np.ndarray) -> float:
    """F_avg = (Tr(S_target^dag S)/d + 1) / (d + 1) for a CPTP S vs unitary
    target (Horodecki/Nielsen formula via process fidelity)."""
    d = U_target.shape[0]
    St = unitary_superop(U_target)
    F_pro = np.real(np.trace(St.conj().T @ S)) / d ** 2
    return float((d * F_pro + 1.0) / (d + 1.0))


def process_fidelity(S: np.ndarray, U_target: np.ndarray) -> float:
    d = U_target.shape[0]
    St = unitary_superop(U_target)
    return float(np.real(np.trace(St.conj().T @ S)) / d ** 2)


def is_cptp(S: np.ndarray, atol: float = 1e-7) -> Tuple[bool, bool]:
    """(completely_positive, trace_preserving) checks on a superoperator."""
    C = superop_to_choi(S)
    evals = np.linalg.eigvalsh((C + C.conj().T) / 2.0)
    cp = bool(evals.min() > -atol)
    d = int(round(np.sqrt(S.shape[0])))
    # TP: sum_k K^dag K = I  <=> partial trace of Choi over output = I
    Ct = C.reshape(d, d, d, d)  # [i,k,j,l]
    pt = np.einsum("ikil->kl", Ct)
    tp = bool(np.allclose(pt, np.eye(d), atol=atol * 10))
    return cp, tp


__all__ = [
    "PAULIS_1Q", "pauli_basis", "superop_to_choi", "choi_to_superop",
    "choi_to_kraus", "kraus_to_superop", "kraus_to_choi", "superop_to_ptm",
    "ptm_to_superop", "choi_to_chi", "chi_to_choi", "unitary_superop",
    "average_gate_fidelity", "process_fidelity", "is_cptp",
]
