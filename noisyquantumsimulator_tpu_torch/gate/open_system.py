"""Shared open-system channel extraction for engine-driven gate sims.

Micro-physics gate engines (gate/ms_gate.py, trapped ions) share one
pipeline: assemble a rotating-frame Liouvillian stack on qubit (x) qubit (x)
bosonic-mode Hilbert space (dim D = 4 n_mode), exponentiate each member,
project onto the 16 two-qubit operator-basis probes |k><l| (x) rho_mode, and
weight-sum into a (16, 16) qubit superoperator. This module holds that
pipeline plus the small operator / statistics helpers the engines need.

Counterpart of the reference's `gate/open_system.py`. The operator helpers,
`propagators_host` (the scipy complex128 oracle) and `qubit_channel_host`
are copied; `qubit_channel_device` takes the place of the reference's
`qubit_channel_jax`. It runs the stack at complex128 on the device: one
host-to-device copy of Ls tau, the port's expm (Pade-13, its squaring chain
kernel K2 on the card) with `max_squarings` from the host 1-norm, the probe
projection, mode trace and weight sum on the device, and one (16, 16) copy
back. The reference splits each matrix into float64 planes because its TPU
has no complex128; the card has, so the split is not ported.
"""
from __future__ import annotations

from typing import Union

import numpy as np
import torch

from ..ops.expm import expm, squarings_for

__all__ = ["SX", "SY", "SZ", "I2", "kron3", "thermal_state", "gh_nodes",
           "qubit_channel_device", "qubit_channel_host", "propagators_host",
           "probe_basis"]

SX = np.array([[0.0, 1.0], [1.0, 0.0]], dtype=complex)
SY = np.array([[0.0, -1j], [1j, 0.0]], dtype=complex)
SZ = np.array([[1.0, 0.0], [0.0, -1.0]], dtype=complex)
I2 = np.eye(2, dtype=complex)


def kron3(op_q1: np.ndarray, op_q2: np.ndarray,
          op_m: np.ndarray) -> np.ndarray:
    """qubit1 (x) qubit2 (x) mode embedding."""
    return np.kron(np.kron(op_q1, op_q2), op_m)


def thermal_state(n_levels: int, nbar: float) -> np.ndarray:
    """Truncated thermal (geometric) mode state; vacuum at nbar <= 0."""
    if nbar <= 0:
        p = np.zeros(n_levels)
        p[0] = 1.0
    else:
        r = nbar / (1.0 + nbar)
        p = r ** np.arange(n_levels)
        p /= p.sum()
    return np.diag(p).astype(complex)


def gh_nodes(n: int, sigma: float):
    """Gauss-Hermite nodes/weights for averaging f(eps), eps~N(0,sigma^2)."""
    x, w = np.polynomial.hermite_e.hermegauss(n)
    return sigma * x, w / w.sum()


def probe_basis(rho_mode: np.ndarray, n_mode: int) -> np.ndarray:
    """Real (16, D^2) row-major vec of the inputs |k><l| (x) rho_mode
    (rho_mode is a real diagonal state, so every probe is real)."""
    D = 4 * n_mode
    rhos = np.zeros((16, D * D))
    for k in range(4):
        for l_ in range(4):
            q = np.zeros((4, 4))
            q[k, l_] = 1.0
            rhos[k * 4 + l_] = np.kron(q, rho_mode.real).reshape(-1)
    return rhos


def propagators_host(Ls: np.ndarray, tau: float) -> np.ndarray:
    """exp(L tau) for a stack of Liouvillians (M, D^2, D^2): the scipy
    complex128 oracle (engine="host")."""
    from scipy.linalg import expm as scipy_expm
    return np.stack([scipy_expm(L * tau) for L in Ls])


def qubit_channel_host(U_props: np.ndarray, weights: np.ndarray,
                       rho_mode: np.ndarray, n_mode: int) -> np.ndarray:
    """Average the propagator ensemble and project to the 2-qubit channel:
    S[:, 4k+l] = vec( Tr_mode[ U (|k><l| (x) rho_mode) ] ), row-major vec."""
    D = 4 * n_mode
    rhos = np.zeros((16, D, D), dtype=complex)
    for k in range(4):
        for l_ in range(4):
            q = np.zeros((4, 4), dtype=complex)
            q[k, l_] = 1.0
            rhos[k * 4 + l_] = np.kron(q, rho_mode)
    vec = rhos.reshape(16, D * D)
    S16 = np.zeros((16, 16), dtype=complex)
    for U, w in zip(U_props, weights):
        out = vec @ U.T                                 # (16, D^2)
        outm = out.reshape(16, 4, n_mode, 4, n_mode)
        q_out = np.einsum("binjn->bij", outm)            # trace mode
        S16 += w * q_out.reshape(16, 16).T               # column per input
    return S16


def qubit_channel_device(Ls: np.ndarray, w: np.ndarray, tau: float,
                         rho_mode: np.ndarray, n_mode: int,
                         device: Union[str, torch.device] = "cuda"
                         ) -> np.ndarray:
    """engine="device": the channel of the Liouvillian stack Ls (M, D^2,
    D^2) averaged with weights w, computed at complex128 on `device`.

    The stack crosses to the device once (as Ls tau); its expm is the
    port's Pade-13 with the squaring count the largest host 1-norm needs
    (on the card the chain is kernel K2, tiled at D^2 = 1600). The probe
    projection out[m, b, j] = (V U_m^T)[b, j], the mode trace and the weight
    sum run there too; only the (16, 16) channel comes back."""
    A_host = np.asarray(Ls, np.complex128) * tau
    ms = squarings_for(np.abs(A_host).sum(axis=-2).max(), "pade13")
    dev = torch.device(device)
    A = torch.as_tensor(A_host, device=dev)
    U = expm(A, max_squarings=ms, method="pade13")
    del A
    V = torch.as_tensor(probe_basis(rho_mode, n_mode), device=dev).to(U.dtype)
    wt = torch.as_tensor(np.asarray(w, np.float64), device=dev).to(U.dtype)
    M = U.shape[0]
    out = torch.einsum("bi,mji->mbj", V, U)
    del U
    out = out.reshape(M, 16, 4, n_mode, 4, n_mode)
    q = torch.diagonal(out, dim1=3, dim2=5).sum(-1)      # trace the mode
    S = torch.einsum("m,mbij->bij", wt, q).reshape(16, 16).T
    S = S.cpu().numpy()
    return S
