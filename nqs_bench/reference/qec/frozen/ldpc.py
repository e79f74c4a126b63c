# Frozen copy of the port's host code (noisyquantumsimulator_tpu_torch/qec/ldpc.py), kept so that the
# benchmark's reference rebuilds the BB memory experiment from its configuration
# file without importing the program. Only the imports were changed, and what the
# reference never reaches was left out.
"""Bivariate bicycle (BB) codes and their circuit-level memory-Z experiment.

Bivariate bicycle codes (Bravyi et al., Nature 627, 778 (2024), public
construction): on the group Z_l x Z_m with cyclic shift matrices
x = S_l (x) I_m, y = I_l (x) S_m, pick polynomials

    A = x^a1 + y^a2 + y^a3      B = y^b1 + x^b2 + x^b3

then Hx = [A | B], Hz = [B^T | A^T] is a CSS code on n = 2 l m qubits.
The [[144, 12, 12]] "gross code" uses l=12, m=6,
A = x^3 + y + y^2, B = y^3 + x + x^2.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def _shift(n: int, k: int) -> np.ndarray:
    return np.roll(np.eye(n, dtype=np.uint8), k, axis=1)


def bb_code(l: int, m: int, a_powers: Tuple[int, int, int],
            b_powers: Tuple[int, int, int]) -> Tuple[np.ndarray, np.ndarray]:
    """Bivariate bicycle parity checks (Hx, Hz), each (l*m, 2*l*m) uint8.

    a_powers = (a1, a2, a3): A = x^a1 + y^a2 + y^a3
    b_powers = (b1, b2, b3): B = y^b1 + x^b2 + x^b3
    """
    Il, Im = np.eye(l, dtype=np.uint8), np.eye(m, dtype=np.uint8)
    x = np.kron(_shift(l, 1), Im)
    y = np.kron(Il, _shift(m, 1))

    def mpow(M, k):
        out = np.eye(l * m, dtype=np.uint8)
        for _ in range(k % (l * m)):
            out = (out @ M) % 2
        return out

    A = (mpow(x, a_powers[0]) ^ mpow(y, a_powers[1]) ^ mpow(y, a_powers[2]))
    B = (mpow(y, b_powers[0]) ^ mpow(x, b_powers[1]) ^ mpow(x, b_powers[2]))
    Hx = np.concatenate([A, B], axis=1) % 2
    Hz = np.concatenate([B.T, A.T], axis=1) % 2
    return Hx.astype(np.uint8), Hz.astype(np.uint8)


def gross_code() -> Tuple[np.ndarray, np.ndarray]:
    """The [[144, 12, 12]] bivariate bicycle code."""
    return bb_code(12, 6, (3, 1, 2), (3, 1, 2))


def small_bb_code() -> Tuple[np.ndarray, np.ndarray]:
    """[[72, 12, 6]] BB code (l=6, m=6, A=x^3+y+y^2, B=y^3+x+x^2)."""
    return bb_code(6, 6, (3, 1, 2), (3, 1, 2))


def logical_operators(Hx: np.ndarray, Hz: np.ndarray) -> np.ndarray:
    """Z-type logical operators: basis of ker(Hx) / rowspace(Hz).
    Returns (k, n) uint8."""
    n = Hx.shape[1]

    def row_reduce(M):
        M = M.copy() % 2
        pivots = []
        r = 0
        for c in range(M.shape[1]):
            piv = next((i for i in range(r, M.shape[0]) if M[i, c]), None)
            if piv is None:
                continue
            M[[r, piv]] = M[[piv, r]]
            for i in range(M.shape[0]):
                if i != r and M[i, c]:
                    M[i] ^= M[r]
            pivots.append(c)
            r += 1
        return M[:r], pivots

    # kernel of Hx
    R, piv = row_reduce(Hx)
    free = [c for c in range(n) if c not in piv]
    kernel = []
    for f in free:
        v = np.zeros(n, dtype=np.uint8)
        v[f] = 1
        for r_i, c in enumerate(piv):
            if R[r_i, f]:
                v[c] = 1
        kernel.append(v)
    kernel = np.array(kernel, dtype=np.uint8)
    # quotient by rowspace(Hz): keep kernel vectors independent of Hz rows
    Rz, _ = row_reduce(Hz)
    basis = list(Rz)
    logicals = []
    for v in kernel:
        aug = np.array(basis + [v], dtype=np.uint8)
        r_before = row_reduce(np.array(basis, dtype=np.uint8))[0].shape[0] \
            if basis else 0
        r_after = row_reduce(aug)[0].shape[0]
        if r_after > r_before:
            basis.append(v)
            logicals.append(v)
    return np.array(logicals, dtype=np.uint8)


def bb_memory_circuit(Hx: Optional[np.ndarray] = None,
                      Hz: Optional[np.ndarray] = None,
                      rounds: int = 3, p: float = 1e-3,
                      p_meas: Optional[float] = None) -> "Circuit":
    """Circuit-level memory-Z experiment for a CSS/BB code.

    Data qubits 0..n-1, one ancilla per Z check. Every round: reset
    ancillas, CX(data -> ancilla) over each check's (non-local) support
    with two-qubit depolarizing noise per gate, measure+reset ancillas
    with flip noise; detectors compare consecutive rounds. Final
    transversal Z measurement closes the boundary detectors; observables
    are the Z-logical operators.

    Non-locality is free in the Circuit IR — the movement cost of these
    long-range CXs is priced separately by ldpc_layout.plan_bb_extraction.
    """
    from .circuits import Circuit

    if Hx is None or Hz is None:
        Hx, Hz = small_bb_code()
    Hx = np.asarray(Hx, np.uint8)
    Hz = np.asarray(Hz, np.uint8)
    p_meas = p if p_meas is None else p_meas
    n = Hz.shape[1]
    mz = Hz.shape[0]
    anc = list(range(n, n + mz))
    supports = [np.nonzero(Hz[c])[0] for c in range(mz)]
    max_w = max(len(s) for s in supports)

    c = Circuit(n_qubits=n + mz)
    for r in range(rounds):
        # CX layers: leg k of every check fires together (the movement
        # planner's wave structure); noise on every gate
        for k in range(max_w):
            pairs = [(int(supports[ch][k]), anc[ch])
                     for ch in range(mz) if len(supports[ch]) > k]
            flat = np.asarray(pairs, dtype=np.int32)
            c.append("CX", flat)
            if p > 0:
                c.append("DEPOLARIZE2", flat, arg=p)
        if p > 0:
            c.append("DEPOLARIZE1", list(range(n)), arg=p / 10)
        c.append("MR", anc, arg=p_meas)
        for kk in range(mz):
            if r == 0:
                c.detector([-mz + kk])
            else:
                c.detector([-mz + kk, -2 * mz + kk])

    c.append("M", list(range(n)), arg=p_meas)
    for ch in range(mz):
        recs = [-n - mz + ch]
        recs += [-n + int(q) for q in supports[ch]]
        c.detector(recs)

    Lz = logical_operators(Hx, Hz)
    for oi, lz in enumerate(Lz):
        c.observable_include(oi, [-n + int(q)
                                  for q in np.nonzero(lz)[0]])
    return c
