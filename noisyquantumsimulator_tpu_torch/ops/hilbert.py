"""Single- and two-atom Hilbert-space operators as plain arrays.

Rebuild of the reference Hilbert-space layer
(reference: rydberg_gates/hamiltonians.py:380-577). No operator objects:
basis kets / projectors / transition operators are numpy complex arrays,
built once on the host and moved to the device by the solver. Two-atom
operators are Kronecker products.

Level ordering (matches reference basis() indices):
  dim=3: |0>, |1>, |r>
  dim=4: |0>, |1>, |r+>, |r->
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

import numpy as np


@dataclass(frozen=True)
class HilbertSpace:
    """Container of single-atom operators (numpy arrays, host-side)."""
    dim: int
    basis: Dict[str, np.ndarray] = field(default_factory=dict)
    projectors: Dict[str, np.ndarray] = field(default_factory=dict)
    transitions: Dict[str, np.ndarray] = field(default_factory=dict)
    identity: np.ndarray = None


def _ket(dim: int, i: int) -> np.ndarray:
    v = np.zeros((dim,), dtype=np.complex128)
    v[i] = 1.0
    return v


def build_hilbert_space(dim: int = 3) -> HilbertSpace:
    """Basis states, projectors, and transition operators for one atom.
    (hamiltonians.py:424-522)"""
    if dim == 3:
        labels = {"0": 0, "1": 1, "r": 2}
    elif dim == 4:
        labels = {"0": 0, "1": 1, "r+": 2, "r-": 3}
    else:
        raise ValueError(f"Unsupported Hilbert space dimension: {dim}. Use 3 or 4.")

    basis = {k: _ket(dim, i) for k, i in labels.items()}
    projectors = {k: np.outer(v, v.conj()) for k, v in basis.items()}

    def T(dst: str, src: str) -> np.ndarray:
        """|dst><src|"""
        return np.outer(basis[dst], basis[src].conj())

    if dim == 3:
        transitions = {
            "r->1": T("1", "r"), "r->0": T("0", "r"),
            "1->r": T("r", "1"), "1->0": T("0", "1"),
        }
    else:
        transitions = {
            "r+->1": T("1", "r+"), "r+->0": T("0", "r+"), "r+->r-": T("r-", "r+"),
            "r-->1": T("1", "r-"), "r-->0": T("0", "r-"), "r-->r+": T("r+", "r-"),
            "1->r+": T("r+", "1"), "1->r-": T("r-", "1"), "1->0": T("0", "1"),
        }

    return HilbertSpace(dim=dim, basis=basis, projectors=projectors,
                        transitions=transitions,
                        identity=np.eye(dim, dtype=np.complex128))


HS3 = build_hilbert_space(3)
HS4 = build_hilbert_space(4)


def op_two_atom(op1: np.ndarray, op2: np.ndarray) -> np.ndarray:
    """O1 (x) O2 on the two-atom space. (hamiltonians.py:540)"""
    return np.kron(op1, op2)


def sym_two_atom(op: np.ndarray) -> np.ndarray:
    """O (x) I + I (x) O — the same single-atom operator on both atoms."""
    I = np.eye(op.shape[0], dtype=op.dtype)
    return np.kron(op, I) + np.kron(I, op)


def two_atom_kets(hs: HilbertSpace) -> Dict[str, np.ndarray]:
    """Computational two-atom basis kets |00>, |01>, |10>, |11> plus the
    uniform superposition "++" used for controlled-phase extraction."""
    b0, b1 = hs.basis["0"], hs.basis["1"]
    kets = {
        "00": np.kron(b0, b0), "01": np.kron(b0, b1),
        "10": np.kron(b1, b0), "11": np.kron(b1, b1),
    }
    kets["++"] = 0.5 * (kets["00"] + kets["01"] + kets["10"] + kets["11"])
    return kets


def computational_indices(dim: int):
    """Indices of |00>, |01>, |10>, |11> in the kron-ordered two-atom basis."""
    return 0, 1, dim, dim + 1


def kets_to_density(kets: np.ndarray) -> np.ndarray:
    """|psi><psi| for a batch of kets (..., D) -> (..., D, D)."""
    return np.einsum("...i,...j->...ij", kets, kets.conj())


__all__ = [
    "HilbertSpace", "build_hilbert_space", "HS3", "HS4",
    "op_two_atom", "sym_two_atom", "two_atom_kets", "computational_indices",
    "kets_to_density",
]
