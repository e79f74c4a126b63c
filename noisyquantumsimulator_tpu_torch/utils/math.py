"""Quantum math utilities: fidelities, partial trace, norms, entropies.

Counterpart of the reference's `utils/math.py` (reference:
src/qpu_simulator/utils/math_utils.py:5-13 — "fidelity, partial trace,
Kraus->PTM, diamond-norm helpers"). The state functions take torch tensors
(numpy arrays are accepted and become CPU tensors), batch over leading
dimensions and return tensors on their input's device. The channel helpers
(`diamond_norm_upper_bound`, `kraus_to_ptm`, `process_fidelity_from_ptm`)
and `wilson_ci` are host numpy, copied.
"""
from __future__ import annotations

import numpy as np
import torch

from ..gate.fidelity import mixed_state_fidelity, state_fidelity
from ..channels.conversions import (kraus_to_superop, superop_to_choi,
                                    superop_to_ptm)


def _t(x) -> torch.Tensor:
    return x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))


def fidelity(rho, sigma):
    """Uhlmann fidelity; accepts kets or density matrices (last dims)."""
    rho, sigma = _t(rho), _t(sigma)
    if rho.ndim == sigma.ndim == 1:
        return torch.abs(torch.vdot(sigma, rho.to(sigma.dtype))) ** 2
    if rho.ndim == sigma.ndim - 1 or (rho.ndim == 1 and sigma.ndim == 2):
        return state_fidelity(sigma, rho)
    if sigma.ndim == rho.ndim - 1:
        return state_fidelity(rho, sigma)
    return mixed_state_fidelity(rho, sigma)


def purity(rho):
    """Tr(rho^2)."""
    rho = _t(rho)
    return torch.einsum("...ij,...ji->...", rho, rho).real


def partial_trace(rho, keep: int, dims):
    """Partial trace of a bipartite (or multipartite) density matrix.

    rho: (..., D, D) with D = prod(dims); keep: subsystem index to KEEP.
    """
    dims = tuple(dims)
    n = len(dims)
    rho = _t(rho)
    batch = tuple(rho.shape[:-2])
    r = rho.reshape(batch + dims + dims)
    # trace out everything but `keep`
    for k in reversed([i for i in range(n) if i != keep]):
        half = (r.ndim - len(batch)) // 2
        r = torch.diagonal(r, dim1=len(batch) + k,
                           dim2=len(batch) + half + k).sum(-1)
    d = dims[keep]
    return r.reshape(batch + (d, d))


def von_neumann_entropy(rho, base: float = 2.0):
    """S(rho) = -Tr rho log rho."""
    ev = torch.linalg.eigvalsh(_t(rho))
    ev = torch.clamp(ev, 1e-15, 1.0)
    return -torch.sum(ev * torch.log(ev), dim=-1) / np.log(base)


def concurrence_2q(rho):
    """Wootters concurrence of a two-qubit density matrix."""
    rho = _t(rho)
    sy = np.array([[0, -1j], [1j, 0]])
    YY = torch.as_tensor(np.kron(sy, sy), device=rho.device).to(
        torch.promote_types(rho.dtype, torch.complex64))
    rho = rho.to(YY.dtype)
    rt = YY @ rho.conj() @ YY
    ev = torch.linalg.eigvals(rho @ rt)
    lam = torch.sort(torch.sqrt(torch.clamp(ev.real, min=0.0)),
                     descending=True).values
    return torch.clamp(lam[0] - lam[1] - lam[2] - lam[3], min=0.0)


def trace_distance(rho, sigma):
    """T(rho, sigma) = 0.5 ||rho - sigma||_1."""
    ev = torch.linalg.eigvalsh(_t(rho) - _t(sigma))
    return 0.5 * torch.sum(torch.abs(ev), dim=-1)


def diamond_norm_upper_bound(S1: np.ndarray, S2: np.ndarray) -> float:
    """Cheap upper bound on the diamond distance between two channels:
    ||E1 - E2||_diamond <= d * ||C1 - C2||_1 (Choi trace-norm bound).

    Exact diamond norms need an SDP solver; this bound is the standard
    lightweight surrogate (utils/math_utils.py:11 spec 'diamond-norm
    helpers')."""
    d = int(round(np.sqrt(S1.shape[0])))
    C1 = superop_to_choi(np.asarray(S1)) / d
    C2 = superop_to_choi(np.asarray(S2)) / d
    ev = np.linalg.eigvalsh((C1 - C2 + (C1 - C2).conj().T) / 2)
    return float(d * np.sum(np.abs(ev)))


def kraus_to_ptm(kraus) -> np.ndarray:
    """Kraus operators -> Pauli transfer matrix. (math_utils.py:9)"""
    return superop_to_ptm(kraus_to_superop(kraus))


def process_fidelity_from_ptm(R: np.ndarray, R_target: np.ndarray) -> float:
    """F_pro = Tr(R_t^T R) / d^2 in PTM representation."""
    d2 = R.shape[0]
    return float(np.trace(R_target.T @ R) / d2)


def wilson_ci(k: int, n: int, z: float = 1.96):
    """95% Wilson score interval for a binomial proportion.

    Every published logical-error-rate cell carries this CI plus its raw
    error count. Well-behaved at k = 0, unlike the normal approximation.
    """
    if n <= 0:
        return (0.0, 1.0)
    p = k / n
    den = 1.0 + z * z / n
    ctr = (p + z * z / (2 * n)) / den
    hw = z * np.sqrt(p * (1 - p) / n + z * z / (4 * n * n)) / den
    return (max(0.0, ctr - hw), min(1.0, ctr + hw))


__all__ = ["fidelity", "purity", "partial_trace", "von_neumann_entropy",
           "concurrence_2q", "trace_distance", "diamond_norm_upper_bound",
           "kraus_to_ptm", "process_fidelity_from_ptm", "wilson_ci"]
