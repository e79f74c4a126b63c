"""Drive-phase rotating-frame factorization of segment propagators.

The segment Liouvillians of every piecewise-constant drive schedule differ
only by the drive phase:

    L(phi) = L0 + a e^{+i phi} C+ + a e^{-i phi} C-

In this framework the drive raises the two-atom Rydberg excitation count by
exactly one, every static Hamiltonian term (detuning, blockade, Zeeman,
Stark) is diagonal, and every collapse operator is an elementary transition
or projector (ops/lindblad.py) — so the diagonal superoperator rotation

    S(phi) = diag(exp(i phi g)),   g[(i,j)] = n_ryd[i] - n_ryd[j]

(n_ryd = Rydberg count of each two-atom basis state; (i,j) the row-major
vec(rho) index) satisfies *exactly*

    S(phi) L0 S(-phi) = L0,   S(phi) C+- S(-phi) = e^{+-i phi} C+-.

Hence for uniform (a, dt) segments

    exp(L(phi_k) dt) = S(phi_k) U_base S(-phi_k),  U_base = exp(L(0) dt)

and a whole n-segment schedule collapses to ONE matrix exponential plus a
tree of diagonally-rescaled copies of U_base — ~25x fewer matmuls than
exponentiating every segment (the reference's hot loop,
rydberg_gates/simulation.py:1698-1733, re-solves an ODE per segment
per basis state).

The algebraic preconditions are *verified numerically* per plan by
`phase_frame_generator` (integer support check, host-side, exact), so the
fast path can never silently produce wrong physics: callers fall back to
the general per-segment expm when the check fails.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from .hilbert import HilbertSpace


def rydberg_counts(hs: HilbertSpace) -> np.ndarray:
    """Rydberg-excitation count of each two-atom basis state, shape (D^2,)
    over the kron-ordered two-atom basis (a * dim + b)."""
    if hs.dim == 3:
        r1 = np.array([0, 0, 1])                # |0>, |1>, |r>
    elif hs.dim == 4:
        r1 = np.array([0, 0, 1, 1])             # |0>, |1>, |r+>, |r->
    else:
        raise ValueError(f"unsupported single-atom dim {hs.dim}")
    return (r1[:, None] + r1[None, :]).reshape(-1)


def phase_frame_generator(L0: np.ndarray, Cp: np.ndarray, Cm: np.ndarray,
                          hs: HilbertSpace, tol: float = 0.0
                          ) -> Optional[np.ndarray]:
    """The diagonal generator g over vec(rho) indices (length D^2 for the
    D-dim two-atom space) if the factorization is exact for these
    matrices, else None.

    Checks (exact integer support conditions, host-side numpy):
      L0[i,j] != 0  =>  g[i] == g[j]
      Cp[i,j] != 0  =>  g[i] - g[j] == +1
      Cm[i,j] != 0  =>  g[i] - g[j] == -1
    """
    n2 = rydberg_counts(hs)                      # (D,) with D = dim^2
    D = n2.shape[0]
    if L0.shape != (D * D, D * D):
        return None
    g = (n2[:, None] - n2[None, :]).reshape(-1).astype(np.int64)  # (D^2,)
    dg = g[:, None] - g[None, :]
    thresh = tol if tol > 0 else 0.0

    def _supported(M, want):
        mask = np.abs(M) > thresh
        return bool(np.all(dg[mask] == want))

    if (_supported(L0, 0) and _supported(Cp, +1) and _supported(Cm, -1)):
        return g.astype(np.float64)
    return None


__all__ = ["rydberg_counts", "phase_frame_generator"]
