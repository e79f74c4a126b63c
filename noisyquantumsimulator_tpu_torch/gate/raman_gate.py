"""Engine-driven two-photon Raman single-qubit gate (neutral atoms).

The reference stubs this simulation (reference:
src/qpu_simulator/micro_physics/neutral_atoms/single_qubit_gates.py:1-25
— "Raman transitions ... scattering from the intermediate state, Rabi
frequency / detuning trade-offs"); this module runs the neutral-atom 1Q
primitive through a real Lindblad simulation, as the MS gate is.

Counterpart of the reference's `gate/raman_gate.py`, copied; host numpy and
scipy. The reference itself exponentiates the 4-level Lambda system with
`scipy.linalg.expm` on the host (a (16, 16) Liouvillian), not on its
device, so the port keeps it there too: a kernel launch would cost more
than the product.

Model: the full Lambda system — no adiabatic elimination — on the
4-level space {|0>, |1>, |e>, |x>}:

  |0>, |1>  hyperfine qubit (two-photon resonance, Stark-compensated)
  |e>       intermediate P state (one-photon detuning Delta, linewidth
            Gamma from core.atom_data)
  |x>       sink: spontaneous decay out of the qubit manifold (F-changing
            Raman scattering) — leakage, not a qubit Pauli error

Rotating-frame Hamiltonian (after the two-photon frame transformation):

  H = -Delta |e><e| + delta2 |1><1|
      + (Omega1/2)(|e><0| + h.c.) + (Omega2/2)(|e><1| + h.c.)

delta2 compensates the differential AC Stark shift
(Omega1^2 - Omega2^2)/(4 Delta) by default — the tune-up every
experiment performs. Collapse operators:

  sqrt(Gamma b_0) |0><e|, sqrt(Gamma b_1) |1><e|, sqrt(Gamma b_x) |x><e|
      spontaneous emission with branching (Raman scattering when the
      final state differs from the initial; b_x models F-changing decay)
  sqrt(gamma_phi / 2) (|1><1| - |0><0|)
      differential laser/Rayleigh dephasing of the two-photon phase

The drive duration is one-shot Rabi-calibrated on the engine's own
noiseless run (the rotation angle is measured from the floor channel
and the duration rescaled once), exactly like a real Rabi calibration
and like the MS gate's n=0 sideband calibration. Everything else —
scattering during the pulse, non-adiabatic |e> population, dephasing —
is the Lindblad dynamics' own answer.

Emits CalibrationRecord(platform="neutral_atoms", operation="raman_1q")
consumed by primitives.SingleQubitGate(calibration=...).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from ..core.constants import TWO_PI
from ..core.atom_data import get_intermediate_state_linewidth
from ..ops.lindblad import dissipator_superop, hamiltonian_superop

_D = 4                                   # |0>, |1>, |e>, |x>


def build_raman_system(
    Omega1: float,
    Omega2: float,
    Delta: float,
    Gamma: float,
    branch_0: float = 1.0 / 3.0,
    branch_1: float = 1.0 / 3.0,
    gamma_phi: float = 0.0,
    compensate_stark: bool = True,
    delta2_error: float = 0.0,
    amplitude_error: float = 0.0,
):
    """(H, c_ops) for the rotating-frame Lambda system. branch_x is the
    remainder 1 - branch_0 - branch_1 (decay out of the qubit manifold)."""
    Omega1 = Omega1 * (1.0 + amplitude_error)
    Omega2 = Omega2 * (1.0 + amplitude_error)
    bx = 1.0 - branch_0 - branch_1
    if bx < -1e-12:
        raise ValueError("branching fractions exceed 1")
    delta2 = delta2_error
    if compensate_stark:
        delta2 += (Omega1 ** 2 - Omega2 ** 2) / (4.0 * Delta)

    H = np.zeros((_D, _D), dtype=complex)
    H[2, 2] = -Delta
    H[1, 1] = delta2
    H[2, 0] = Omega1 / 2.0
    H[0, 2] = Omega1 / 2.0
    H[2, 1] = Omega2 / 2.0
    H[1, 2] = Omega2 / 2.0

    c_ops: List[np.ndarray] = []
    for tgt, b in ((0, branch_0), (1, branch_1), (3, max(bx, 0.0))):
        if b > 0 and Gamma > 0:
            L = np.zeros((_D, _D), dtype=complex)
            L[tgt, 2] = np.sqrt(Gamma * b)
            c_ops.append(L)
    if gamma_phi > 0:
        Ldp = np.zeros((_D, _D), dtype=complex)
        Ldp[0, 0] = -1.0
        Ldp[1, 1] = 1.0
        c_ops.append(np.sqrt(gamma_phi / 2.0) * Ldp)
    return H, c_ops


def _qubit_channel(L: np.ndarray, tau: float) -> np.ndarray:
    """Propagate the 4-level Liouvillian for tau and project onto the
    qubit subspace: returns the (4, 4) qubit superop (row-major vec)."""
    from scipy.linalg import expm
    P = expm(L * tau)
    S = np.zeros((4, 4), dtype=complex)
    for col, (i, j) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
        rho = np.zeros((_D, _D), dtype=complex)
        rho[i, j] = 1.0
        out = (P @ rho.reshape(-1)).reshape(_D, _D)
        S[:, col] = out[:2, :2].reshape(-1)
    return S


def _rotation_target(theta: float, phi: float = 0.0) -> np.ndarray:
    axis = np.cos(phi) * np.array([[0, 1], [1, 0]], dtype=complex) \
        + np.sin(phi) * np.array([[0, -1j], [1j, 0]], dtype=complex)
    return (np.cos(theta / 2) * np.eye(2)
            - 1j * np.sin(theta / 2) * axis).astype(complex)


def _measured_angle(S_floor: np.ndarray) -> float:
    """Rotation angle of the (noiseless) qubit channel about x: the
    population transfer of |0> gives |sin(theta/2)|^2; phase read off
    the coherence fixes the quadrant within the calibration's use."""
    rho0 = np.zeros(4, dtype=complex)
    rho0[0] = 1.0                       # vec(|0><0|), row-major
    out = (S_floor @ rho0).reshape(2, 2)
    p1 = np.real(out[1, 1])
    p1 = min(max(p1, 0.0), 1.0)
    return 2.0 * np.arcsin(np.sqrt(p1))


@dataclass
class RamanGateSimResult:
    """Spec contract (single_qubit_gates.py:11-25) + engine extras."""
    duration: float
    fidelity: float                  # avg gate fidelity vs the rotation
    theta: float
    error_map_pauli: np.ndarray      # (4,) twirled 1-qubit error probs
    error_budget: Dict[str, float] = field(default_factory=dict)
    superop: Optional[np.ndarray] = None   # (4, 4) qubit channel
    process_fidelity: float = 0.0
    completely_positive: bool = True
    trace_preserving: bool = True
    leakage: float = 0.0             # population outside {|0>, |1>}
    parameters: Dict = field(default_factory=dict)

    def print_summary(self) -> None:
        print(f"Raman gate: theta = {self.theta:.4f}, "
              f"tau = {self.duration * 1e6:.3f} us, "
              f"F_avg = {self.fidelity:.8f}")
        for k, v in sorted(self.error_budget.items(), key=lambda kv: -kv[1]):
            print(f"  {k:>22s}: {v:.2e}")


def simulate_raman_gate(
    theta: float = np.pi / 2,
    species: str = "Rb87",
    Omega1: float = TWO_PI * 500e6,
    Omega2: float = TWO_PI * 500e6,
    Delta: float = TWO_PI * 100e9,
    Gamma: Optional[float] = None,
    branch_0: float = 1.0 / 3.0,
    branch_1: float = 1.0 / 3.0,
    gamma_phi: float = 0.0,
    delta2_error: float = 0.0,
    amplitude_error: float = 0.0,
    include_budget: bool = True,
) -> RamanGateSimResult:
    """Simulate a theta-rotation Raman pulse through the Lindblad engine
    and extract the CPTP qubit channel.

    Gamma defaults to the species' D2 intermediate-state linewidth
    (core.atom_data — the same table the two-photon Rydberg path uses)."""
    from ..channels.conversions import (average_gate_fidelity, is_cptp,
                                        process_fidelity)
    from ..channels.pauli import twirled_error_probs

    if Gamma is None:
        Gamma = get_intermediate_state_linewidth(species)

    Omega_R = Omega1 * Omega2 / (2.0 * Delta)
    tau0 = theta / Omega_R

    def channel(gm, gphi, d2err, amperr, tau):
        H, c_ops = build_raman_system(
            Omega1, Omega2, Delta, gm, branch_0, branch_1, gphi,
            compensate_stark=True, delta2_error=d2err,
            amplitude_error=amperr)
        L = hamiltonian_superop(H) + dissipator_superop(c_ops, _D)
        return _qubit_channel(L, tau)

    # one-shot Rabi calibration on the noiseless engine run: the exact
    # two-photon Rabi frequency differs from Omega1 Omega2 / 2 Delta at
    # order (Omega/Delta)^2 (non-adiabatic + Stark corrections); measure
    # the floor channel's rotation angle and rescale tau once
    th_meas = _measured_angle(channel(0.0, 0.0, 0.0, 0.0, tau0))
    tau = tau0 * (theta / th_meas) if th_meas > 1e-9 else tau0

    U_target = _rotation_target(theta)
    cases = {"full": (Gamma, gamma_phi, delta2_error, amplitude_error)}
    if include_budget:
        cases.update({
            "floor": (0.0, 0.0, 0.0, 0.0),
            "scattering": (Gamma, 0.0, 0.0, 0.0),
            "dephasing": (0.0, gamma_phi, 0.0, 0.0),
            "detuning_error": (0.0, 0.0, delta2_error, 0.0),
            "amplitude_error": (0.0, 0.0, 0.0, amplitude_error),
        })
    fids: Dict[str, float] = {}
    chan_full = None
    for name, (gm, gphi, d2, am) in cases.items():
        S = channel(gm, gphi, d2, am, tau)
        fids[name] = average_gate_fidelity(S, U_target)
        if name == "full":
            chan_full = S

    F = fids["full"]
    floor = 1.0 - fids.get("floor", 1.0)
    budget: Dict[str, float] = {}
    if include_budget:
        budget = {k: max(0.0, (1.0 - fids[k]) - floor)
                  for k in ("scattering", "dephasing", "detuning_error",
                            "amplitude_error")}
        budget["model_floor"] = floor

    cp, tp = is_cptp(chan_full)
    out_mm = (chan_full @ (np.eye(2).reshape(4) / 2.0)).reshape(2, 2)
    leakage = float(max(0.0, 1.0 - np.real(np.trace(out_mm))))
    probs = twirled_error_probs(chan_full, U_target)
    params = dict(theta=theta, species=species, Omega1=Omega1,
                  Omega2=Omega2, Delta=Delta, Gamma=Gamma,
                  branch_0=branch_0, branch_1=branch_1,
                  gamma_phi=gamma_phi, delta2_error=delta2_error,
                  amplitude_error=amplitude_error, Omega_R=Omega_R)
    return RamanGateSimResult(
        duration=float(tau), fidelity=float(F), theta=float(theta),
        error_map_pauli=np.asarray(probs, dtype=float),
        error_budget=budget, superop=chan_full,
        process_fidelity=float(process_fidelity(chan_full, U_target)),
        completely_positive=bool(cp), trace_preserving=bool(tp),
        leakage=leakage, parameters=params)


def raman_calibration_record(result: RamanGateSimResult, regime: str):
    """CalibrationRecord for the neutral-atom 1Q primitive (same
    store/schema as the CZ and MS paths, calibration_data/README.md)."""
    from ..channels.calibration import (CalibrationRecord,
                                        _complex_matrix_to_json)
    from ..channels.conversions import pauli_basis
    labels, _ = pauli_basis(1)
    return CalibrationRecord(
        platform="neutral_atoms",
        operation="raman_1q",
        regime=regime,
        parameters={k: v for k, v in result.parameters.items()
                    if isinstance(v, (int, float, str, bool))},
        error_rates={
            "avg_gate_infidelity": 1.0 - result.fidelity,
            "process_infidelity": 1.0 - result.process_fidelity,
            "leakage_mean": result.leakage,
        },
        duration=result.duration,
        pauli_error_probs=[float(p) for p in result.error_map_pauli],
        pauli_labels=list(labels),
        superop=_complex_matrix_to_json(result.superop),
        metadata={"generator": "noisyquantumsimulator_tpu_torch.gate.raman_gate",
                  "error_budget": {k: float(v) for k, v in
                                   result.error_budget.items()}},
    )


__all__ = ["build_raman_system", "simulate_raman_gate",
           "RamanGateSimResult", "raman_calibration_record"]
