"""CPU reference Lindblad integrator (parity oracle), host scipy.

Counterpart of the reference's `solver/reference.py`, copied: the original
project solves the master equation with QuTiP's mesolve (options atol=1e-10,
rtol=1e-8, zvode under the hood). QuTiP is not a dependency; for parity
testing this is an independent integrator built on SciPy's `zvode` — the
same adaptive complex ODE solver family mesolve uses — with the same
tolerances. The tests and `chip_smoke.py` compare the expm-propagator path
against it to 1e-8 state fidelity. Only the scipy import is deferred.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np


def ode(f):
    """scipy.integrate.ode, imported at the first solve: importing
    scipy.integrate starts a process (numpy.testing's CPU probe), and
    `solver/__init__` imports this module."""
    from scipy.integrate import ode as _ode
    return _ode(f)


def liouvillian_np(H: np.ndarray, c_ops: Sequence[np.ndarray]) -> np.ndarray:
    """Row-major-vec Liouvillian (numpy, complex128)."""
    D = H.shape[0]
    I = np.eye(D, dtype=np.complex128)
    L = -1j * (np.kron(H, I) - np.kron(I, H.T))
    for c in c_ops:
        cdc = c.conj().T @ c
        L += np.kron(c, c.conj())
        L -= 0.5 * (np.kron(cdc, I) + np.kron(I, cdc.T))
    return L


def mesolve_zvode(H_segments: Sequence[np.ndarray],
                  dts: Sequence[float],
                  rho0: np.ndarray,
                  c_ops: Sequence[np.ndarray] = (),
                  atol: float = 1e-10, rtol: float = 1e-8,
                  nsteps: int = 50000) -> np.ndarray:
    """Integrate d(vec rho)/dt = L_k vec(rho) segment by segment with zvode.

    Mirrors the reference evolve loops: each segment has a constant
    Hamiltonian; tolerances match simulation.py:687.
    """
    D = rho0.shape[0]
    vec = rho0.astype(np.complex128).reshape(-1).copy()

    for Hk, dt in zip(H_segments, dts):
        if dt <= 0:
            continue
        L = liouvillian_np(np.asarray(Hk, dtype=np.complex128), c_ops)

        def rhs(t, y, L=L):
            return L @ y

        r = ode(rhs)
        r.set_integrator("zvode", method="adams", atol=atol, rtol=rtol,
                         nsteps=nsteps)
        r.set_initial_value(vec, 0.0)
        vec = r.integrate(dt)
        if not r.successful():
            raise RuntimeError("zvode integration failed")

    return vec.reshape(D, D)


def mesolve_zvode_liouvillian(L_segments: Sequence[np.ndarray],
                              dts: Sequence[float],
                              rho0: np.ndarray,
                              atol: float = 1e-10, rtol: float = 1e-8,
                              nsteps: int = 50000) -> np.ndarray:
    """Like mesolve_zvode, but over precomputed Liouvillian matrices —
    dimension-agnostic oracle (works for the 4-level / 256x256 model
    where rebuilding H + c_ops by hand would duplicate the planner)."""
    D = rho0.shape[0]
    vec = rho0.astype(np.complex128).reshape(-1).copy()
    for Lk, dt in zip(L_segments, dts):
        if dt <= 0:
            continue
        L = np.asarray(Lk, dtype=np.complex128)

        def rhs(t, y, L=L):
            return L @ y

        r = ode(rhs)
        r.set_integrator("zvode", method="adams", atol=atol, rtol=rtol,
                         nsteps=nsteps)
        r.set_initial_value(vec, 0.0)
        vec = r.integrate(dt)
        if not r.successful():
            raise RuntimeError("zvode integration failed")
    return vec.reshape(D, D)


def sesolve_zvode(H_segments, dts, psi0, atol=1e-10, rtol=1e-8,
                  nsteps=50000) -> np.ndarray:
    """Schroedinger-equation reference for noiseless checks."""
    psi = np.asarray(psi0, dtype=np.complex128).copy()
    for Hk, dt in zip(H_segments, dts):
        if dt <= 0:
            continue
        Hk = np.asarray(Hk, dtype=np.complex128)

        def rhs(t, y, H=Hk):
            return -1j * (H @ y)

        r = ode(rhs)
        r.set_integrator("zvode", method="adams", atol=atol, rtol=rtol,
                         nsteps=nsteps)
        r.set_initial_value(psi, 0.0)
        psi = r.integrate(dt)
        if not r.successful():
            raise RuntimeError("zvode integration failed")
    return psi


__all__ = ["liouvillian_np", "mesolve_zvode", "mesolve_zvode_liouvillian",
           "sesolve_zvode"]
