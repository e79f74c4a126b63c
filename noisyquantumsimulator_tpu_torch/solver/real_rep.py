"""Real Hermitian-basis (Pauli-transfer-style) phase-frame engine.

Counterpart of the reference's `solver/real_rep.py`. A density matrix is
Hermitian: its D^2 complex entries carry only D^2 real degrees of freedom,
and a Lindblad propagator is Hermiticity-preserving, so in an orthonormal
Hermitian operator basis the propagator is ONE real (D^2, D^2) matrix. The
phase-frame algorithm (ops/phase_frame.py) then runs in that basis:

  * the per-segment matvec is one real matmul instead of a complex one, and
  * the diagonal frame rotation S(phi) = diag(e^{i phi g}) becomes an exact
    block rotation: coordinates split into D diagonal entries (charge 0,
    untouched) and P = D(D-1)/2 (Re, Im) pairs that rotate by phi * q_ij
    with the integer charge q_ij = g[i*D + j].

Basis (layout [diag | re-pairs | im-pairs], pairs in lexicographic
(i < j) order):

  E_ii   = |i><i|                        -> x = rho_ii
  E^re_ij = (|i><j| + |j><i|) / sqrt2    -> x = sqrt2 Re rho_ij
  E^im_ij = (-i|i><j| + i|j><i|) / sqrt2 -> x = sqrt2 Im rho_ij

x = W vec(rho) with W unitary (rows vec(E_k)^dagger), so the change of basis
is exact.

The 300-step scan of a batch of schedules, `evolve_real_phased_many`, is the
hot loop of every gate simulation; it runs as CUDA kernel K1 on the card
(solver/scan_cuda.py).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class RealRep(NamedTuple):
    """Host-built tables for the real Hermitian-basis engine (dim D).

    Wr, Wi: (n, n) float planes of the unitary W, x = W vec(rho), n = D^2.
    cq:     (P,) float pair charges q_ij = n_ryd[i] - n_ryd[j] (i < j).
    D, P:   space dim and pair count (layout [D diag | P re | P im]).
    """
    Wr: np.ndarray
    Wi: np.ndarray
    cq: np.ndarray
    D: int
    P: int


def build_real_rep(g: np.ndarray, D: int) -> RealRep:
    """Tables for the D-dim two-atom space given the vec-index phase
    charges g (g[i*D + j] = n_ryd[i] - n_ryd[j], ops/phase_frame.py)."""
    n = D * D
    g = np.asarray(g).reshape(D, D)
    pairs = [(i, j) for i in range(D) for j in range(i + 1, D)]
    P = len(pairs)
    W = np.zeros((n, n), np.complex128)
    s = 1.0 / np.sqrt(2.0)
    for k in range(D):                       # diagonal coords
        W[k, k * D + k] = 1.0
    for k, (i, j) in enumerate(pairs):       # x_re = sqrt2 Re rho_ij
        W[D + k, i * D + j] = s
        W[D + k, j * D + i] = s
        # x_im = sqrt2 Im rho_ij = (rho_ij - rho_ji) / (sqrt2 i)
        W[D + P + k, i * D + j] = -1j * s
        W[D + P + k, j * D + i] = +1j * s
    assert np.allclose(W @ W.conj().T, np.eye(n), atol=1e-14)
    cq = np.array([float(g[i, j]) for (i, j) in pairs])
    return RealRep(np.ascontiguousarray(W.real), np.ascontiguousarray(W.imag),
                   cq, D, P)


def real_propagator_device(U_base, Wr, Wi):
    """U_real = Re(W U_base W^dagger) on U_base's device from a complex
    U_base, via real-plane matmuls (once per call)."""
    Ur, Ui = U_base.real, U_base.imag
    Ar = Wr @ Ur - Wi @ Ui
    Ai = Wr @ Ui + Wi @ Ur
    # Re(A (Wr^T - i Wi^T)) = Ar Wr^T + Ai Wi^T
    return Ar @ Wr.T + Ai @ Wi.T


def to_real_coords(rhos, Wr, Wi):
    """(..., D, D) Hermitian rhos -> (..., n) real coordinates x = W vec."""
    D = rhos.shape[-1]
    v = rhos.reshape(*rhos.shape[:-2], D * D)
    return v.real @ Wr.T - v.imag @ Wi.T


def from_real_coords(x, Wr, Wi):
    """(..., n) real coordinates -> (..., D, D) complex rhos
    (vec = W^dagger x)."""
    n = x.shape[-1]
    D = int(round(np.sqrt(n)))
    return torch.complex(x @ Wr, -(x @ Wi)).reshape(*x.shape[:-1], D, D)


def _rotate(x, theta, cq, D: int, P: int):
    """Frame rotation by angle theta on layout [D diag | P re | P im]:
    re' = c re - s im, im' = s re + c im, c/s = cos/sin(theta * cq).
    theta must broadcast against x's leading axes (the pair-coordinate axis
    is appended to it here)."""
    th = theta[..., None] * cq                # (..., P)
    c, s = torch.cos(th), torch.sin(th)
    lead = torch.broadcast_shapes(x.shape[:-1], th.shape[:-1])
    d = x[..., :D].expand(*lead, D)
    re = x[..., D:D + P]
    im = x[..., D + P:]
    return torch.cat([d, c * re - s * im, s * re + c * im], dim=-1)


def evolve_real_phased_many(U_real, cq, phases_bn, x0s, D: int, P: int):
    """Phase-frame evolution in the real basis for a batch of schedules
    sharing one propagator (the real twin of
    propagator.evolve_rhos_phased_many).

    U_real: (n, n) real; cq: (P,) pair charges; phases_bn: (B, n_seg);
    x0s: (S, n) shared initial coordinates. Returns (B, S, n).
    CUDA tensors run kernel K1; CPU tensors its plain twin."""
    from .scan_cuda import evolve_real_phased_many_cuda
    return evolve_real_phased_many_cuda(U_real, cq, phases_bn, x0s, D, P)


def evolve_real_phased(U_real, cq, phases, x0s, D: int, P: int):
    """Single-schedule real-basis phase-frame evolution (the real twin of
    propagator.evolve_rhos_phased). x0s: (B, n) states; phases: (n_seg,).
    Returns (B, n): the many-schedule scan with one schedule of B rows."""
    return evolve_real_phased_many(U_real, cq, phases[None], x0s, D, P)[0]


__all__ = ["RealRep", "build_real_rep", "real_propagator_device",
           "to_real_coords", "from_real_coords", "evolve_real_phased_many",
           "evolve_real_phased"]
