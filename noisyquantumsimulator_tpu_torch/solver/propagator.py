"""Lindblad master-equation propagators (PyTorch).

Counterpart of the reference's `solver/propagator.py`:

    1. A pulse schedule is a set of segments (amp_k, phase_k, dt_k).
    2. Each segment Liouvillian is the linear combination
           Lmat_k = L0 + amp_k e^{+i phase_k} C+ + amp_k e^{-i phase_k} C-
       (ops/lindblad.drive_decomposition) — one broadcast add.
    3. All segment propagators exp(Lmat_k dt_k) come from ONE batched expm.
    4. The ordered product is contracted in log2(n) batched matmuls.

For uniform-(amp, dt) schedules the phase-frame identity
(ops/phase_frame.py) replaces step 3-4 by one expm (`uniform_base_propagator`)
and a scan of shared-weight matvecs (`evolve_rhos_phased*`).

Operator tensors (L0, C+, C-, rho0s, U) carry their device and dtype; the
schedule is host data (numpy) and is moved to the operators' device here.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops.expm import chained_product, expm


class Schedule(NamedTuple):
    """Pure-array pulse schedule (host numpy).

    amps   : (n,) drive amplitude scale per segment (1.0 = full Omega)
    phases : (n,) drive phase per segment [rad]
    dts    : (n,) segment durations [s]
    dets   : (n,) or None — extra per-segment detuning [rad/s] applied via
             the Cd channel
    """
    amps: np.ndarray
    phases: np.ndarray
    dts: np.ndarray
    dets: Optional[np.ndarray] = None


def real_dtype(dtype: torch.dtype) -> torch.dtype:
    """The real dtype matching a complex (or real) dtype."""
    return {torch.complex64: torch.float32,
            torch.complex128: torch.float64}.get(dtype, dtype)


def _host(x, like: torch.Tensor) -> torch.Tensor:
    """Host array (or tensor) -> real tensor on like's device."""
    return torch.as_tensor(x if torch.is_tensor(x) else np.asarray(x),
                           dtype=real_dtype(like.dtype), device=like.device)


def segment_liouvillians(L0, Cp, Cm, schedule: Schedule, Cd=None):
    """Stack of per-segment Liouvillian*dt matrices, shape (n, D^2, D^2)."""
    a = _host(schedule.amps, L0)
    ph = _host(schedule.phases, L0)
    dt = _host(schedule.dts, L0)
    ep = (a * torch.exp(1j * ph)).to(L0.dtype)
    Ls = (L0[None] + ep[:, None, None] * Cp[None]
          + ep.conj()[:, None, None] * Cm[None])
    if schedule.dets is not None and Cd is not None:
        Ls = Ls + _host(schedule.dets, L0)[:, None, None] * Cd[None]
    return Ls * dt[:, None, None]


def total_propagator(L0, Cp, Cm, schedule: Schedule, Cd=None,
                     max_squarings: int = 12, expm_method: str = "auto"):
    """exp(L_n dt_n) ... exp(L_1 dt_1) as one (D^2, D^2) matrix."""
    A = segment_liouvillians(L0, Cp, Cm, schedule, Cd)
    return chained_product(expm(A, max_squarings=max_squarings,
                                method=expm_method))


def evolve_rhos(L0, Cp, Cm, schedule: Schedule, rho0s, Cd=None,
                max_squarings: int = 12, expm_method: str = "auto"):
    """Evolve a batch of density matrices through the schedule.
    rho0s: (B, D, D) -> (B, D, D)."""
    B, D, _ = rho0s.shape
    U = total_propagator(L0, Cp, Cm, schedule, Cd,
                         max_squarings=max_squarings, expm_method=expm_method)
    return (rho0s.reshape(B, D * D) @ U.T).reshape(B, D, D)


# --------------------------------------------------------------------------
# phase-frame fast path (ops/phase_frame.py): uniform-(amp, dt) schedules
# --------------------------------------------------------------------------

def uniform_base_propagator(L0, Cp, Cm, amp: float, dt: float,
                            max_squarings: int = 12,
                            expm_method: str = "auto"):
    """U_base = exp((L0 + amp (C+ + C-)) dt): the single segment propagator
    every phase-rotated segment of a uniform schedule shares."""
    A = (L0 + amp * (Cp + Cm)) * dt
    return expm(A, max_squarings=max_squarings, method=expm_method)


def evolve_rhos_phased(U_base, g, phases, rho0s):
    """Phase-frame evolution of a batch of density matrices through one
    uniform schedule, as a scan of shared-weight matvecs:

        v <- U_base @ (e^{i (phi_{k-1} - phi_k) g} * v)

    g: (D^2,) integer-valued generator; phases: (n,); rho0s: (B, D, D)."""
    return evolve_rhos_phased_many(U_base, g, _host(phases, U_base)[None],
                                   rho0s)[0]


def evolve_rhos_phased_many(U_base, g, phases_bn, rho0s):
    """evolve_rhos_phased for a batch of schedules sharing one U_base.

    phases_bn: (B, n) per-sim phase schedules; rho0s: (S, D, D) initial
    states shared by every sim. Returns (B, S, D, D): one
    (B*S, D^2) @ (D^2, D^2) shared-weight matmul per segment."""
    S, D, _ = rho0s.shape
    g = _host(g, U_base)
    ph = _host(phases_bn, U_base)
    B = ph.shape[0]
    dphi = torch.cat([torch.zeros_like(ph[:, :1]), ph[:, :-1] - ph[:, 1:]],
                     dim=1)
    v = (rho0s.reshape(1, S, D * D)
         * torch.exp(-1j * ph[:, 0, None, None] * g)).to(U_base.dtype)
    UbT = U_base.T
    for k in range(ph.shape[1]):
        v = v * torch.exp(1j * dphi[:, k, None, None] * g).to(U_base.dtype)
        v = (v.reshape(B * S, D * D) @ UbT).reshape(B, S, D * D)
    v = v * torch.exp(1j * ph[:, -1, None, None] * g).to(U_base.dtype)
    return v.reshape(B, S, D, D)


__all__ = ["Schedule", "real_dtype", "segment_liouvillians",
           "total_propagator", "evolve_rhos", "uniform_base_propagator",
           "evolve_rhos_phased", "evolve_rhos_phased_many"]
