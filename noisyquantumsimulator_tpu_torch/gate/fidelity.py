"""CZ-gate fidelity and controlled-phase extraction (batched, PyTorch).

Counterpart of the reference's `gate/fidelity.py`. The controlled phase is
read from the evolved |++> = (|00>+|01>+|10>+|11>)/2 state's coherences
against the dark |00> component:

    phi_c = arg(rho[i11,i00]) - arg(rho[i01,i00]) - arg(rho[i10,i00])

which is exact for pure outputs and stays well-defined for mixed states.
Per-state fidelity against the phase-adjusted ideal targets reduces to the
population <target|rho|target>; the |11> fidelity is penalized by
cos^2(phase_err/2).

Every function takes any number of leading batch axes (the reference maps
one sim at a time with jax.vmap).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch


def state_fidelity(rho: torch.Tensor, target_ket: torch.Tensor) -> torch.Tensor:
    """<t|rho|t> — fidelity of rho (..., D, D) against a pure target (D,)."""
    t = target_ket.to(rho.dtype)
    return torch.einsum("i,...ij,j->...", t.conj(), rho, t).real


def controlled_phase_from_superposition(rho_plus: torch.Tensor, dim: int):
    """Controlled phase and single-state phases from the evolved |++> state
    (..., D, D). Returns (controlled, (phi01, phi10, phi11),
    (|c01|, |c10|, |c11|)), phases relative to |00>."""
    i00, i01, i10, i11 = 0, 1, dim, dim + 1
    c01 = rho_plus[..., i01, i00]
    c10 = rho_plus[..., i10, i00]
    c11 = rho_plus[..., i11, i00]
    phi01, phi10, phi11 = c01.angle(), c10.angle(), c11.angle()
    controlled = phi11 - phi01 - phi10
    controlled = torch.remainder(controlled + math.pi, 2.0 * math.pi) - math.pi
    return controlled, (phi01, phi10, phi11), (c01.abs(), c10.abs(), c11.abs())


def compute_cz_fidelity(rhos: torch.Tensor, kets: Dict[str, np.ndarray],
                        ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor, Dict]:
    """Fidelities + controlled-phase diagnostics.

    rhos: (..., 5, D, D) output density matrices ordered
          ["00", "01", "10", "11", "++"], any leading batch axes.
    kets: two-atom kets from ops.hilbert.two_atom_kets, as numpy arrays
          or as tensors; tensors already on rhos' device cost no host
          transfer (a transfer from pageable host memory waits for the
          device to drain).

    Returns (fidelities dict, avg_fidelity, phase_info), each value a tensor
    over the leading batch axes.
    """
    order = ["00", "01", "10", "11"]
    targets = torch.stack([
        torch.as_tensor(kets[k] if torch.is_tensor(kets[k])
                        else np.asarray(kets[k]), device=rhos.device)
        for k in order]).to(rhos.dtype)                          # (4, D)
    D = targets.shape[-1]
    dim = int(round(math.sqrt(D)))

    pops = torch.einsum("ki,...kij,kj->...k", targets.conj(), rhos[..., :4, :, :],
                        targets).real                            # (..., 4)
    p00, p01, p10, p11 = pops.unbind(-1)

    controlled, (phi01, phi10, phi11), (a01, a10, a11) = \
        controlled_phase_from_superposition(rhos[..., 4, :, :], dim)

    phase_err = torch.minimum((controlled - math.pi).abs(),
                              (controlled + math.pi).abs())
    cz_phase_fid = torch.cos(phase_err / 2.0) ** 2

    f11 = p11 * cz_phase_fid
    fids = {"00": p00, "01": p01, "10": p10, "11": f11}
    avg = (p00 + p01 + p10 + f11) / 4.0

    phase_info = {
        "phi_01_rad": phi01,
        "phi_01_deg": torch.rad2deg(phi01),
        "phi_10_rad": phi10,
        "phi_11_rad": phi11,
        "phi_11_deg": torch.rad2deg(phi11),
        "controlled_phase_rad": controlled,
        "controlled_phase_deg": torch.rad2deg(controlled),
        "phase_error_from_pi_rad": phase_err,
        "phase_error_from_pi_deg": torch.rad2deg(phase_err),
        "cz_phase_fidelity": cz_phase_fid,
        "amp_01": torch.sqrt(torch.clamp(p01, min=0.0)),
        "amp_11": torch.sqrt(torch.clamp(p11, min=0.0)),
        "coherence_01": a01, "coherence_10": a10, "coherence_11": a11,
        "pop_00": p00, "pop_01": p01, "pop_10": p10, "pop_11": p11,
        "F11_population": p11,
        "F11_with_phase": f11,
        "cz_phase_condition_met": phase_err < 0.2,
    }
    return fids, avg, phase_info


def mixed_state_fidelity(rho: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """Uhlmann fidelity F(rho, sigma) = (Tr sqrt(sqrt(rho) sigma sqrt(rho)))^2
    via eigendecompositions (batched)."""
    er, vr = torch.linalg.eigh(rho)
    er = torch.clamp(er, min=0.0)
    sq = (vr * torch.sqrt(er).to(vr.dtype)[..., None, :]) @ vr.mH
    em = torch.linalg.eigvalsh(sq @ sigma @ sq)
    return torch.sqrt(torch.clamp(em, min=0.0)).sum(dim=-1) ** 2


__all__ = ["state_fidelity", "controlled_phase_from_superposition",
           "compute_cz_fidelity", "mixed_state_fidelity"]
