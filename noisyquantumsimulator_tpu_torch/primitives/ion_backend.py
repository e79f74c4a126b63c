"""IonBackend: Layer-1 primitives for a trapped-ion (QCCD) machine.

Closes the L0->L1->L2 loop for platform #2. The reference's architecture
maps every primitive per platform (reference: docs/ARCHITECTURE.md:171-178
— TwoQubitGate -> Rydberg-CZ *or* MS *or* cavity-mediated; the compiler
spec names the ion native set {Rz, Raman, MS},
src/qpu_simulator/architecture/compiler/__init__.py:5-26). The
engine-driven MS gate (gate/ms_gate.py) emits calibration records; this
module is the consumer the reference's thesis requires:
"Level-0/1 tools inform the parameters. They do not execute the
computation." (reference README.md:117-127)

Primitive -> physics mapping (per the qccd stub specs,
src/qpu_simulator/micro_physics/trapped_ions/qccd/*.py):
  TwoQubitGate  MS gate from the Lindblad-engine calibration record
                (superop + twirled Pauli probs). CZ/CX are *derived*
                natively: CZ = e^{i pi/4} (Sdg (x) Sdg)(X (x) I)(H (x) H)
                . U_MS . (H (x) H)(X (x) I) — the Clifford wrappers
                conjugate the calibrated MS channel exactly (superop
                conjugation, then re-twirl), and the four physical pi/2
                Raman wrapper pulses add their own scattering cost.
  SingleQubitGate  Raman rotations (scattering-limited); Rz virtual.
  Measure       state-dependent fluorescence with a Poisson-statistics
                confusion matrix (physics/trapped_ions.fluorescence_readout,
                per micro_physics/trapped_ions/.../measurement spec).
  Move          QCCD shuttling (adiabaticity-limited duration, diabatic
                heating, junction penalty) — physics/trapped_ions.shuttle.
  Cool          resolved-sideband cooling to the nbar floor
                (physics/trapped_ions.sideband_cooling_limit).
  Idle          hyperfine qubit: T1 effectively infinite, T2 from the
                qubit coherence time (clock qubits: seconds).

Counterpart of the reference's `primitives/ion_backend.py`. The backend's
`device` (the card by default) runs the MS engine when no record is on disk
(`_default_ms_record`, n_fock = 8).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from ..core.constants import TWO_PI
from ..channels.calibration import CalibrationRecord, CalibrationStore
from ..channels.conversions import (average_gate_fidelity, unitary_superop)
from ..channels.pauli import depolarizing_probs, twirled_error_probs
from .base import (CoolPrimitive, CoolResult, GatePrimitive, GateResult,
                   IdleResult, MeasureResult, MovePrimitive, MoveResult)
from .calibration_io import superop_from_record
from .gates import SingleQubitGate
from .motion import Idle, Measure

_H = np.array([[1, 1], [1, -1]], dtype=complex) / np.sqrt(2)
_X = np.array([[0, 1], [1, 0]], dtype=complex)
_SDG = np.diag([1, -1j]).astype(complex)
CZ_MATRIX = np.diag([1, 1, 1, -1]).astype(complex)

# CZ = e^{i pi/4} L2 . U_MS . L1 with Clifford locals (verified in
# tests/test_primitives.py): exp(-i pi/4 ZZ) = (H(x)H) U_MS (H(x)H) and
# (Sdg(x)Sdg) exp(-i pi/4 ZZ) = e^{-i pi/4} CZ, so
# L1 = H (x) H, L2 = (Sdg H) (x) (Sdg H)
_L1 = np.kron(_H, _H)
_L2 = np.kron(_SDG @ _H, _SDG @ _H)


def _default_ms_record(species: str, device="cuda") -> CalibrationRecord:
    """Generate an MS calibration in-process on `device` (when no record is
    on disk). The small Fock space keeps it a short call."""
    from ..gate.ms_gate import ms_calibration_record, simulate_ms_gate
    res = simulate_ms_gate(species=species, n_fock=8, nbar=0.02,
                           device=device)
    return ms_calibration_record(res, regime=f"{species.lower()}_inprocess")


@dataclass
class IonTwoQubitGate(GatePrimitive):
    """MS-native entangler; cz/cx derived by exact Clifford conjugation
    of the calibrated MS channel + wrapper-pulse costs."""

    calibration: CalibrationRecord = None
    single_qubit: SingleQubitGate = None
    name = "two_qubit_gate"
    platform = "trapped_ions"

    def __post_init__(self):
        if self.single_qubit is None:
            self.single_qubit = SingleQubitGate()
        rec = self.calibration
        self._S_ms = superop_from_record(rec)       # full channel E.U_MS
        self._probs_ms = (np.asarray(rec.pauli_error_probs, dtype=float)
                          if rec.pauli_error_probs is not None else None)
        # derived CZ channel: conjugate by the Clifford locals once
        S_cz = unitary_superop(_L2) @ self._S_ms @ unitary_superop(_L1)
        self._S_cz = S_cz
        self._probs_cz = twirled_error_probs(S_cz, CZ_MATRIX)
        self._F_cz = average_gate_fidelity(S_cz, CZ_MATRIX)

    def _wrapper_cost(self, n_pulses: int = 4):
        """Physical pi/2 Raman pulses that realize the Clifford locals
        (Z factors are virtual). Returns (extra duration, extra infid)."""
        r = self.single_qubit(0, "rx", angle=np.pi / 2)
        return n_pulses * r.duration, n_pulses * (1.0 - r.fidelity)

    def __call__(self, qubit_1: int = 0, qubit_2: int = 1,
                 gate_type: str = "ms",
                 distance: Optional[float] = None) -> GateResult:
        rec = self.calibration
        g = gate_type.lower()
        infid = rec.error_rates["avg_gate_infidelity"]
        leak = rec.error_rates.get("leakage_mean", 0.0)
        xtalk = rec.error_rates.get("crosstalk", 0.0)
        if g in ("ms", "xx"):
            return GateResult(
                duration=rec.duration, fidelity=1.0 - infid,
                error_map=self._S_ms, pauli_error_probs=self._probs_ms,
                leakage=leak, crosstalk=xtalk, loss_probability=leak,
                metadata={"gate": "ms", "regime": rec.regime,
                          "error_budget": rec.metadata.get("error_budget")})
        if g in ("cz", "cx", "cnot"):
            dt_w, p_w = self._wrapper_cost(4)
            probs = np.array(self._probs_cz)
            # wrapper scattering as extra 2-qubit depolarizing weight
            probs = ((1.0 - p_w) * probs
                     + p_w * depolarizing_probs(1.0, 2))
            S = self._S_cz
            fid = (1.0 - p_w) * self._F_cz
            duration = rec.duration + dt_w
            if g in ("cx", "cnot"):
                Hs = unitary_superop(np.kron(np.eye(2), _H))
                S = Hs @ S @ Hs
                dt_h, p_h = self._wrapper_cost(2)
                duration += dt_h
                fid *= (1.0 - p_h)
            return GateResult(
                duration=duration, fidelity=fid, error_map=S,
                pauli_error_probs=probs, leakage=leak, crosstalk=xtalk,
                loss_probability=leak,
                metadata={"gate": g, "derived_from": "ms",
                          "regime": rec.regime})
        raise ValueError(f"Unknown two-qubit gate: {gate_type}")


@dataclass
class IonMove(MovePrimitive):
    """QCCD shuttling (qccd/shuttling spec)."""
    omega_mode: float = TWO_PI * 3e6
    speed_limit: float = 10.0
    name = "move"
    platform = "trapped_ions"

    def __call__(self, qubit_id: int = 0, start=0.0, end=100e-6,
                 junction: bool = False, **kw) -> MoveResult:
        from ..physics.trapped_ions import shuttle
        dist = float(np.linalg.norm(np.atleast_1d(end)
                                    - np.atleast_1d(start)))
        s = shuttle(distance=dist, omega_mode=self.omega_mode,
                    speed_limit=self.speed_limit, junction=junction)
        return MoveResult(duration=s.duration,
                          loss_probability=s.loss_probability,
                          heating_quanta=s.heating_quanta,
                          metadata={"distance": dist, "junction": junction,
                                    "motional_phase": s.motional_phase})


@dataclass
class IonCool(CoolPrimitive):
    """Resolved-sideband cooling to the (Gamma/2 omega)^2 floor."""
    omega_mode: float = TWO_PI * 3e6
    # EFFECTIVE linewidth of the (quenched) cooling transition; sideband
    # resolution requires Gamma_eff << omega_mode
    linewidth: float = TWO_PI * 20e3
    rate_quanta_per_s: float = 5e4         # sideband cooling speed
    name = "cool"
    platform = "trapped_ions"

    def __call__(self, qubit_id: int = 0, initial_nbar: float = 10.0,
                 target_nbar: Optional[float] = None, **kw) -> CoolResult:
        from ..physics.trapped_ions import sideband_cooling_limit
        floor = sideband_cooling_limit(self.omega_mode, self.linewidth)
        tgt = max(floor, target_nbar if target_nbar is not None else floor)
        # exponential approach: n(t) = floor + (n0 - floor) e^{-R t / n0}
        n0 = max(initial_nbar, tgt + 1e-12)
        t = (n0 / self.rate_quanta_per_s) * np.log(
            max((n0 - floor) / max(tgt - floor, 1e-12), 1.0))
        from ..core.constants import HBAR, KB
        return CoolResult(duration=float(t), final_nbar=float(tgt),
                          final_temperature=float(
                              HBAR * self.omega_mode / KB
                              / np.log(1.0 + 1.0 / max(tgt, 1e-12))),
                          success_probability=1.0,
                          metadata={"floor_nbar": float(floor)})


@dataclass
class IonBackend:
    """Bundle of trapped-ion Layer-1 primitives driven by the MS-gate
    Lindblad calibration (the trapped-ion sibling of NeutralAtomBackend).
    Duck-type compatible with qec/executor.py's backend interface
    (cz / rx / measure / T1 / T2)."""

    species: str = "Yb171"
    ms_regime: str = "yb171_default"
    ms_calibration: Optional[CalibrationRecord] = None
    calibration_store: Optional[CalibrationStore] = None
    omega_raman: float = TWO_PI * 250e3   # 1 us pi/2 pulses
    raman_scattering_rate: float = 1.0    # [1/s] during the drive
    T1: float = 1e4                       # hyperfine qubit: no decay
    T2: float = 2.0                       # clock-qubit dephasing [s]
    readout_duration: float = 200e-6
    device: str = "cuda"

    def __post_init__(self):
        if self.ms_calibration is None:
            store = self.calibration_store or CalibrationStore()
            try:
                self.ms_calibration = store.load(
                    "trapped_ions", "ms_gate", self.ms_regime)
            except FileNotFoundError:
                self.ms_calibration = _default_ms_record(self.species,
                                                         self.device)

        self.single_qubit = SingleQubitGate(
            omega_raman=self.omega_raman,
            scattering_rate=self.raman_scattering_rate)
        self.two_qubit = IonTwoQubitGate(
            calibration=self.ms_calibration, single_qubit=self.single_qubit)
        omega_mode = self.ms_calibration.parameters.get(
            "omega_mode", TWO_PI * 3e6)
        self.move = IonMove(omega_mode=omega_mode)
        self.cool = IonCool(omega_mode=omega_mode)
        self.idle = Idle(T1=self.T1, T2=self.T2)
        from ..physics.trapped_ions import fluorescence_readout
        cm, fid = fluorescence_readout(duration=self.readout_duration)
        # ion fluorescence readout keeps the ion trapped: non-destructive
        self.measure = Measure(fidelity_0=float(cm[0, 0]),
                               fidelity_1=float(cm[1, 1]),
                               duration=self.readout_duration,
                               loss_probability=1e-6, destructive=False)
        self._confusion = cm

    # convenience one-liners (executor interface)
    def ms(self, q1: int = 0, q2: int = 1) -> GateResult:
        return self.two_qubit(q1, q2, "ms")

    def cz(self, q1: int = 0, q2: int = 1) -> GateResult:
        return self.two_qubit(q1, q2, "cz")

    def rx(self, q: int, angle: float) -> GateResult:
        return self.single_qubit(q, "rx", angle=angle)

    def rz(self, q: int, angle: float) -> GateResult:
        return self.single_qubit(q, "rz", angle=angle)

    def summary(self) -> Dict:
        ms = self.ms()
        cz = self.cz()
        return {
            "species": self.species, "ms_regime": self.ms_regime,
            "ms_fidelity": ms.fidelity, "ms_duration_us": ms.duration * 1e6,
            "cz_fidelity": cz.fidelity, "cz_duration_us": cz.duration * 1e6,
            "sq_pi_duration_us": self.single_qubit(0, "x").duration * 1e6,
            "T1_s": self.T1, "T2_s": self.T2,
            "measure_fidelity": self.measure().fidelity,
            "measure_duration_us": self.readout_duration * 1e6,
        }


__all__ = ["IonBackend", "IonTwoQubitGate", "IonMove", "IonCool",
           "CZ_MATRIX"]
