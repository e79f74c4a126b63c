"""CPTP channel extraction from the Layer-0 gate engine.

This is the designed-but-never-built Layer-0 -> Layer-1 bridge of the
reference (reference: calibration_data/README.md, architecture docs
"emits calibrated parameters: CPTP maps, durations, loss/leak rates").

Because the engine already produces the FULL propagator superoperator
(solver/propagator.total_propagator), process tomography is a projection,
not 4^n separate experiments: the qubit-subspace channel is the
computational sub-block of the 81x81 propagator, and everything that
leaves the block is leakage/loss, folded into an explicit erasure flag.

Counterpart of the reference's `channels/tomography.py`. The propagator is
computed on the plan's device in the plan's (or the given) complex dtype:
one batched expm of every segment (kernel K2 on the card) and the ordered
product. One (81, 81) device-to-host copy follows; everything after it is
host complex128 numpy, as in the reference.

The expm is Pade-13 at every dtype. At complex64 Taylor-16 (the expm's
default there) rounds every segment's propagator the same way, and 300
segments add it up: the default gate's superop then lies close to the
1e-4 parity tolerance from its complex128 value. Pade-13 lies well inside
it and squares three times less (PERF.md, section 5). The reference takes
Taylor-16 at 32 bits only because batched LU solves are slow on the TPU.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np
import torch

from ..core.configs import SmoothJPSimulationInputs
from ..gate.simulate import GatePlan, plan_cz_gate
from ..solver.propagator import total_propagator
from ..ops.hilbert import computational_indices
from .conversions import (average_gate_fidelity, choi_to_chi, choi_to_kraus,
                          is_cptp, superop_to_choi, superop_to_ptm,
                          unitary_superop)

CZ_MATRIX = np.diag([1.0, 1.0, 1.0, -1.0]).astype(complex)


@dataclass
class ExtractedChannel:
    """A calibrated two-qubit channel with leakage bookkeeping."""
    superop: np.ndarray          # (16,16) qubit-subspace superoperator (raw)
    superop_aligned: np.ndarray  # same, with the single-qubit Z frame removed
    leakage_per_input: np.ndarray  # (4,) prob of leaving the qubit subspace
    duration: float              # gate time [s]
    avg_gate_fidelity: float     # vs ideal CZ (after single-qubit Z frame)
    process_fidelity: float
    completely_positive: bool
    trace_preserving: bool       # False when leakage > 0 (sub-normalized)
    metadata: Dict = field(default_factory=dict)

    @property
    def choi(self) -> np.ndarray:
        return superop_to_choi(self.superop)

    @property
    def ptm(self) -> np.ndarray:
        return superop_to_ptm(self.superop)

    @property
    def chi(self) -> np.ndarray:
        return choi_to_chi(self.choi)

    def kraus(self):
        return choi_to_kraus(self.choi)

    @property
    def mean_leakage(self) -> float:
        return float(np.mean(self.leakage_per_input))


def _subspace_superop(U_full: np.ndarray, dim: int) -> np.ndarray:
    """Restrict a two-atom superoperator to the 2-qubit computational
    subspace: rows/cols with both indices in {|00>,|01>,|10>,|11>}."""
    idx = np.array(computational_indices(dim))
    D = dim * dim
    # vec index (i, j) -> i*D + j; select i,j in computational set
    sel = (idx[:, None] * D + idx[None, :]).reshape(-1)
    return U_full[np.ix_(sel, sel)]


def _dephase_frame(S: np.ndarray) -> np.ndarray:
    """Remove the single-qubit Z frame: conjugate by diag phases so that the
    |01> and |10> outputs are phase-aligned with their inputs, matching the
    reference's global-phase extraction (simulation.py:483-561)."""
    # dominant transfer phases from the superoperator's action on
    # |k><00| coherences
    d = 4
    def phase_of(k):
        # E(|k><0|) ~ e^{i phi_k} |k><0| for a CZ-like channel
        E = S.reshape(d, d, d, d)  # [i,j,k,l] of E(|k><l|)[i,j]
        val = E[k, 0, k, 0]
        return np.angle(val) if abs(val) > 1e-12 else 0.0

    p01, p10 = phase_of(1), phase_of(2)
    # frame: Z-rotations undoing p01 on qubit B and p10 on qubit A
    ph = np.exp(-1j * np.array([0.0, p01, p10, p01 + p10]))
    W = np.diag(ph)
    return unitary_superop(W) @ S


def extract_channel(plan: GatePlan, dtype: Optional[torch.dtype] = None,
                    align_frame: bool = True) -> ExtractedChannel:
    """Extract the two-qubit CPTP channel of a planned gate. The propagator
    is computed on plan.device in `dtype` (default: plan.dtype)."""
    dtype = plan.dtype if dtype is None else dtype
    dev = torch.device(plan.device)

    def put(a):
        return torch.as_tensor(np.asarray(a, np.complex128), device=dev).to(dtype)

    with torch.no_grad():
        U = total_propagator(put(plan.L0), put(plan.Cp), put(plan.Cm),
                             plan.schedule, expm_method="pade13")
    U = U.cpu().numpy().astype(np.complex128)
    dim = plan.hilbert_space_dim
    S = _subspace_superop(U, dim)

    # leakage per computational input: 1 - Tr(E(|k><k|)) on the subspace
    d = 4
    leak = np.zeros(d)
    E = S.reshape(d, d, d, d)
    for k in range(d):
        out_trace = np.real(np.einsum("ii->", E[:, :, k, k]))
        leak[k] = max(0.0, 1.0 - out_trace)

    S_aligned = _dephase_frame(S) if align_frame else S
    cp, tp = is_cptp(S)
    f_avg = average_gate_fidelity(S_aligned, CZ_MATRIX)
    f_pro = float(np.real(np.trace(unitary_superop(CZ_MATRIX).conj().T
                                   @ S_aligned)) / 16.0)

    return ExtractedChannel(
        superop=S, superop_aligned=S_aligned, leakage_per_input=leak,
        duration=plan.tau_total,
        avg_gate_fidelity=f_avg, process_fidelity=f_pro,
        completely_positive=cp, trace_preserving=tp,
        metadata={
            "protocol": plan.protocol, "species": plan.config.species,
            "n_rydberg": plan.config.n_rydberg,
            "Omega_rad_s": plan.Omega, "V_rad_s": plan.V,
            "V_over_Omega": plan.V_over_Omega, "R_m": plan.R,
            "temperature_K": plan.temperature_K,
            "include_noise": plan.include_noise,
            "noise_breakdown": {k: v for k, v in plan.noise_breakdown.items()
                                if isinstance(v, (int, float, bool))},
        })


def extract_cz_channel(simulation_inputs=None, device="cuda",
                       dtype: torch.dtype = torch.complex64,
                       **plan_kwargs) -> ExtractedChannel:
    """One-call CZ channel extraction with default smooth-JP inputs, the
    propagator computed on `device` in complex `dtype`."""
    if simulation_inputs is None:
        simulation_inputs = SmoothJPSimulationInputs()
    plan = plan_cz_gate(simulation_inputs, device=device, dtype=dtype,
                        **plan_kwargs)
    return extract_channel(plan)


__all__ = ["CZ_MATRIX", "ExtractedChannel", "extract_channel",
           "extract_cz_channel"]
