"""Gate primitives (Layer 1): single-qubit rotations + entangling CZ.

Implements the reference's gate-primitive spec
(reference: src/qpu_simulator/primitives/gates.py:1-31, comment-only):
SingleQubitGate / TwoQubitGate returning GateResult(duration, fidelity,
error_map, leakage, crosstalk). Neutral-atom platform mapping
(docs/ARCHITECTURE.md:171-178): Raman single-qubit gates + Rydberg CZ.

Two-qubit error models come straight from Layer-0 calibration
(channels/calibration.py); single-qubit models are analytic Raman-gate
physics (scattering-limited, standard for neutral atoms).

Counterpart of the reference's `primitives/gates.py`, copied; host numpy. A
TwoQubitGate without a record calibrates one with the port's
`calibrate_cz` on `device` (the card by default).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from ..core.constants import TWO_PI
from ..channels.calibration import CalibrationRecord
from ..channels.conversions import unitary_superop
from ..channels.pauli import (depolarizing_probs, pauli_channel_superop)
from .base import GatePrimitive, GateResult

_X = np.array([[0, 1], [1, 0]], dtype=complex)
_Y = np.array([[0, -1j], [1j, 0]], dtype=complex)
_Z = np.array([[1, 0], [0, -1]], dtype=complex)
_H = np.array([[1, 1], [1, -1]], dtype=complex) / np.sqrt(2)
_S = np.diag([1, 1j]).astype(complex)
_T = np.diag([1, np.exp(1j * np.pi / 4)]).astype(complex)


def rotation_matrix(axis: str, angle: float) -> np.ndarray:
    P = {"x": _X, "y": _Y, "z": _Z}[axis.lower()]
    return (np.cos(angle / 2) * np.eye(2)
            - 1j * np.sin(angle / 2) * P).astype(complex)


def u3_matrix(theta: float, phi: float, lam: float) -> np.ndarray:
    return np.array([
        [np.cos(theta / 2), -np.exp(1j * lam) * np.sin(theta / 2)],
        [np.exp(1j * phi) * np.sin(theta / 2),
         np.exp(1j * (phi + lam)) * np.cos(theta / 2)],
    ], dtype=complex)


GATE_MATRICES: Dict[str, np.ndarray] = {
    "x": _X, "y": _Y, "z": _Z, "h": _H, "s": _S, "t": _T,
    "i": np.eye(2, dtype=complex),
}


class SingleQubitGate(GatePrimitive):
    """Raman single-qubit gate for hyperfine qubits.

    Error model: Raman Rabi frequency Omega_R sets duration (angle/Omega_R);
    off-resonant scattering during the drive gives a depolarizing error
    p ~ gamma_scatter * t; Rz gates are virtual (frame updates): zero
    duration, zero error, matching modern practice.
    """
    name = "single_qubit_gate"

    def __init__(self, omega_raman: float = TWO_PI * 1e6,
                 scattering_rate: float = 2.0,
                 rz_is_virtual: bool = True,
                 calibration: Optional[CalibrationRecord] = None):
        """calibration: an engine-driven raman_1q record
        (gate/raman_gate.py). When present, the drive Rabi frequency,
        the per-time error rate, and the X/Y/Z error COMPOSITION all
        come from the Lindblad-engine channel instead of the analytic
        defaults (errors scale linearly with pulse duration from the
        record's theta — exact for rate-dominated errors)."""
        self.calibration = calibration
        if calibration is not None:
            pars = calibration.parameters
            self.omega_raman = pars.get("Omega_R", omega_raman)
            infid = calibration.error_rates["avg_gate_infidelity"]
            # depolarizing-equivalent rate such that p_err * 1/2 (the
            # avg-fidelity factor below) reproduces the record at its
            # own duration
            self.scattering_rate = 2.0 * infid / max(
                calibration.duration, 1e-30)
            p = np.asarray(calibration.pauli_error_probs[1:], dtype=float)
            self._pauli_shape = p / max(p.sum(), 1e-30)
        else:
            self.omega_raman = omega_raman
            self.scattering_rate = scattering_rate
            self._pauli_shape = None
        self.rz_is_virtual = rz_is_virtual

    def __call__(self, qubit_id: int = 0, gate_type: str = "x",
                 angle: Optional[float] = None,
                 axis: Optional[str] = None,
                 u3: Optional[Tuple[float, float, float]] = None
                 ) -> GateResult:
        g = gate_type.lower()
        if u3 is not None:
            U = u3_matrix(*u3)
            eff_angle = abs(u3[0])
        elif g in ("rx", "ry", "rz"):
            if angle is None:
                raise ValueError(f"{gate_type} needs an angle")
            U = rotation_matrix(g[1], angle)
            eff_angle = abs(angle)
        elif g in GATE_MATRICES:
            U = GATE_MATRICES[g]
            eff_angle = {"x": np.pi, "y": np.pi, "z": 0.0, "h": np.pi,
                         "s": 0.0, "t": 0.0, "i": 0.0}[g]
        else:
            raise ValueError(f"Unknown gate_type: {gate_type}")

        is_virtual_z = self.rz_is_virtual and (
            g in ("rz", "z", "s", "t") or (u3 is None and eff_angle == 0.0))
        if is_virtual_z:
            duration, p_err = 0.0, 0.0
        else:
            duration = eff_angle / self.omega_raman
            p_err = min(1.0, self.scattering_rate * duration)

        if self._pauli_shape is not None and p_err > 0:
            # calibrated X/Y/Z composition from the engine channel
            probs = np.concatenate([[1.0 - p_err],
                                    p_err * self._pauli_shape])
        else:
            probs = depolarizing_probs(p_err, 1)
        error_map = pauli_channel_superop(probs, 1) @ unitary_superop(U)
        fidelity = 1.0 - p_err * 0.5  # avg fidelity of depol(p) on d=2
        return GateResult(duration=duration, fidelity=fidelity,
                          error_map=error_map, pauli_error_probs=probs,
                          leakage=0.0, crosstalk=0.0,
                          metadata={"gate": gate_type, "qubit": qubit_id,
                                    "unitary": U, "virtual": is_virtual_z})


class TwoQubitGate(GatePrimitive):
    """Entangling gate driven by Layer-0 calibration.

    gate_type "cz" is native (Rydberg blockade); "cx"/"cnot" is derived
    as H_t CZ H_t with the single-qubit costs added.
    """
    name = "two_qubit_gate"

    def __init__(self, calibration: Optional[CalibrationRecord] = None,
                 single_qubit: Optional[SingleQubitGate] = None,
                 crosstalk: float = 0.0, device="cuda"):
        if calibration is None:
            from ..channels.calibration import calibrate_cz
            calibration = calibrate_cz(device=device)
        self.calibration = calibration
        self.single_qubit = single_qubit or SingleQubitGate()
        self.crosstalk = crosstalk

    def _cz_result(self) -> GateResult:
        rec = self.calibration
        from .calibration_io import superop_from_record
        error_map = superop_from_record(rec)
        infid = rec.error_rates["avg_gate_infidelity"]
        leak = rec.error_rates["leakage_mean"]
        probs = (np.asarray(rec.pauli_error_probs)
                 if rec.pauli_error_probs is not None else None)
        return GateResult(duration=rec.duration, fidelity=1.0 - infid,
                          error_map=error_map, pauli_error_probs=probs,
                          leakage=leak, crosstalk=self.crosstalk,
                          loss_probability=leak,
                          metadata={"gate": "cz", "regime": rec.regime})

    def __call__(self, qubit_1: int = 0, qubit_2: int = 1,
                 gate_type: str = "cz",
                 distance: Optional[float] = None) -> GateResult:
        g = gate_type.lower()
        if g == "cz":
            return self._cz_result()
        if g in ("cx", "cnot"):
            cz = self._cz_result()
            h = self.single_qubit(qubit_2, "h")
            H2 = np.kron(np.eye(2), h.metadata["unitary"])
            era = unitary_superop(H2)
            error_map = era @ cz.error_map @ era
            # twirled probs of the derived channel vs the CX target (the
            # H conjugation permutes the CZ error Paulis X<->Z on the
            # target), plus the two wrapper-H depolarizing weights
            from ..channels.pauli import twirled_error_probs
            CX = np.array([[1, 0, 0, 0], [0, 1, 0, 0],
                           [0, 0, 0, 1], [0, 0, 1, 0]], dtype=complex)
            probs = twirled_error_probs(error_map, CX)
            p_h = 2.0 * max(0.0, 1.0 - h.fidelity)
            probs = (1.0 - p_h) * probs + p_h * depolarizing_probs(1.0, 2)
            return GateResult(
                duration=cz.duration + 2 * h.duration,
                fidelity=cz.fidelity * h.fidelity ** 2,
                error_map=error_map, pauli_error_probs=probs,
                leakage=cz.leakage,
                crosstalk=cz.crosstalk, loss_probability=cz.loss_probability,
                metadata={"gate": "cx", "derived_from": "cz"})
        raise ValueError(f"Unknown two-qubit gate: {gate_type}")


__all__ = ["rotation_matrix", "u3_matrix", "GATE_MATRICES",
           "SingleQubitGate", "TwoQubitGate"]
