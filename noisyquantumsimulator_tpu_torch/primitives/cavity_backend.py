"""CavityBackend: Layer-1 primitives for a cavity-QED machine.

Closes the L0->L1->L2 loop for platform #3. The reference's architecture
maps every primitive per platform (reference: docs/ARCHITECTURE.md:171-178
— TwoQubitGate -> Rydberg-CZ *or* MS *or* cavity-mediated). Round 4 built
the engine-driven photon-exchange gate (gate/cavity_gate.py: Tavis-
Cummings atom(x)atom(x)cavity Lindblad, closed exchange) and emitted
calibration records under calibration_data/cavity_qed/exchange_gate/;
this module is the consumer: "Level-0/1 tools inform the parameters.
They do not execute the computation." (reference README.md:117-127)

Primitive -> physics mapping (per the cavity_qed stub specs,
reference src/qpu_simulator/micro_physics/cavity_qed/*.py):
  TwoQubitGate  photon-exchange gate from the Lindblad-engine calibration
                record (superop + twirled Pauli probs). The native ideal
                is U_x = SWAP . (Z(x)Z) . CPHASE(phi_ee + pi) . CZ in the
                (gg, ge, eg, ee) basis — an exchange (swap-class)
                entangler, NOT a bare CZ. CZ is *derived* natively:
                  - the SWAP factor is absorbed by RELABELING the two
                    qubit wires in software (exact, free — the executor
                    tracks the permutation; reference compiler routing
                    does the same bookkeeping for movement),
                  - the Z(x)Z locals are virtual frame updates (free),
                  - the residual CPHASE(delta), delta = phi_ee + pi
                    (the closed-loop phase missing exact -pi), is an
                    IRREDUCIBLE coherent error — no local can remove a
                    ZZ rotation — and is priced by twirling the full
                    calibrated channel against the CZ target.
  SingleQubitGate  microwave / Raman rotations; Rz virtual.
  Measure       cavity-enhanced state readout: the qubit-state-dependent
                cavity reflection/transmission discriminates |0>/|1> with
                an error floor set by the cooperativity C (p_err ~ a/C +
                photon shot noise at finite integration time).
  Cool          not a native cavity primitive (atoms arrive cold /
                transmons thermalize); modeled as a reset to the qubit
                ground state with the measure duration.
  Idle          T1 (Purcell-limited or intrinsic) + T2 dephasing.

Pricing flow (mirrors primitives/ion_backend.py, platform #2):
calibration_data/cavity_qed/exchange_gate/<regime>.json -> superop ->
relabel+virtual-ZZ composition -> twirl vs CZ/CX -> qec memory circuit.

Counterpart of the reference's `primitives/cavity_backend.py`. The backend's
`device` (the card by default) runs the cavity engine when no record is on
disk (`_default_exchange_record`, n_fock = 4: K2 tiled at (1, 256)
complex128). Like the reference's package, `primitives/__init__.py` does not
export `CavityBackend`; import it from this module.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from ..core.constants import TWO_PI
from ..channels.calibration import CalibrationRecord, CalibrationStore
from ..channels.conversions import average_gate_fidelity, unitary_superop
from ..channels.pauli import depolarizing_probs, twirled_error_probs
from .base import GatePrimitive, GateResult
from .calibration_io import superop_from_record
from .gates import SingleQubitGate
from .motion import Idle, Measure

_H = np.array([[1, 1], [1, -1]], dtype=complex) / np.sqrt(2)
_ZZ = np.diag([1.0, -1.0, -1.0, 1.0]).astype(complex)
_SWAP = np.array([[1, 0, 0, 0], [0, 0, 1, 0],
                  [0, 1, 0, 0], [0, 0, 0, 1]], dtype=complex)
CZ_MATRIX = np.diag([1.0, 1.0, 1.0, -1.0]).astype(complex)
CX_MATRIX = np.array([[1, 0, 0, 0], [0, 1, 0, 0],
                      [0, 0, 0, 1], [0, 0, 1, 0]], dtype=complex)


def _default_exchange_record(regime: str, device="cuda") -> CalibrationRecord:
    """Generate an exchange-gate calibration in-process on `device` (when no
    record is on disk). The small Fock space keeps it a short call."""
    from ..gate.cavity_gate import (cavity_calibration_record,
                                    simulate_cavity_gate)
    res = simulate_cavity_gate(n_fock=4, device=device)
    return cavity_calibration_record(res, regime=f"{regime}_inprocess")


@dataclass
class CavityTwoQubitGate(GatePrimitive):
    """Photon-exchange-native entangler; cz/cx derived by exact software
    relabel + virtual Z(x)Z + twirl of the calibrated channel."""

    calibration: CalibrationRecord = None
    single_qubit: SingleQubitGate = None
    name = "two_qubit_gate"
    platform = "cavity_qed"

    def __post_init__(self):
        if self.single_qubit is None:
            self.single_qubit = SingleQubitGate()
        rec = self.calibration
        self._S_x = superop_from_record(rec)        # full channel E.U_x
        self._probs_x = (np.asarray(rec.pauli_error_probs, dtype=float)
                         if rec.pauli_error_probs is not None else None)
        # derived CZ channel: software relabel (exact SWAP superop) then
        # virtual Z(x)Z frame update; the residual CPHASE(delta) stays
        # inside and is twirled against the CZ target below
        S_cz = (unitary_superop(_ZZ) @ unitary_superop(_SWAP)) @ self._S_x
        self._S_cz = S_cz
        self._probs_cz = twirled_error_probs(S_cz, CZ_MATRIX)
        self._F_cz = average_gate_fidelity(S_cz, CZ_MATRIX)
        phi_ee = float(rec.parameters.get("phi_ee", -np.pi))
        # wrap to (-pi, pi]: the closed-loop phase error vs exact CZ
        self.residual_cphase = float(
            (phi_ee + np.pi + np.pi) % (2 * np.pi) - np.pi)

    def _wrapper_cost(self, n_pulses: int):
        """Physical pi/2 pulses realizing non-virtual locals (H for cx)."""
        r = self.single_qubit(0, "rx", angle=np.pi / 2)
        return n_pulses * r.duration, n_pulses * (1.0 - r.fidelity)

    def __call__(self, qubit_1: int = 0, qubit_2: int = 1,
                 gate_type: str = "exchange",
                 distance: Optional[float] = None) -> GateResult:
        rec = self.calibration
        g = gate_type.lower()
        infid = rec.error_rates["avg_gate_infidelity"]
        leak = rec.error_rates.get("leakage_mean", 0.0)
        xtalk = rec.error_rates.get("crosstalk", 0.0)
        if g in ("exchange", "xchg", "swap_cz"):
            return GateResult(
                duration=rec.duration, fidelity=1.0 - infid,
                error_map=self._S_x, pauli_error_probs=self._probs_x,
                leakage=leak, crosstalk=xtalk, loss_probability=leak,
                metadata={"gate": "exchange", "regime": rec.regime,
                          "error_budget": rec.metadata.get("error_budget")})
        if g in ("cz", "cx", "cnot"):
            probs = np.array(self._probs_cz)
            S = self._S_cz
            fid = self._F_cz
            duration = rec.duration
            if g in ("cx", "cnot"):
                Hs = unitary_superop(np.kron(np.eye(2), _H))
                S = Hs @ S @ Hs
                probs = twirled_error_probs(S, CX_MATRIX)
                dt_h, p_h = self._wrapper_cost(2)
                duration += dt_h
                fid *= (1.0 - p_h)
                probs = ((1.0 - p_h) * probs
                         + p_h * depolarizing_probs(1.0, 2))
            return GateResult(
                duration=duration, fidelity=fid, error_map=S,
                pauli_error_probs=probs, leakage=leak, crosstalk=xtalk,
                loss_probability=leak,
                metadata={"gate": g, "derived_from": "exchange",
                          "relabel": "qubit wires swap (tracked in "
                                     "software, exact)",
                          "residual_cphase_rad": self.residual_cphase,
                          "regime": rec.regime})
        raise ValueError(f"Unknown two-qubit gate: {gate_type}")


def cavity_readout_error(cooperativity: float, duration: float,
                         kappa_readout: float, eta: float = 0.5,
                         n_bar: float = 5.0,
                         T1: float = 100e-6) -> float:
    """Cavity-enhanced readout error (dispersive/reflection discrimination).

    Three terms (reference spec: micro_physics/cavity_qed measurement
    role; standard dispersive-readout analysis):
      - cooperativity floor ~ 2/C: the qubit-state-dependent cavity
        response overlaps by O(1/C) (bad-cavity reflection contrast),
      - photon shot noise: the readout resonator leaks n_bar photons at
        rate kappa_readout, of which a fraction eta is detected;
        distinguishing the two dispersed responses against Poisson
        noise gives p_shot ~ exp(-eta kappa_ro n_bar t / 4),
      - qubit decay during the (QND) readout window: |1> relaxing at T1
        mid-integration misassigns with p ~ (1 - e^{-t/2T1}) / 2.

    The duration tradeoff is real: longer windows kill shot noise but
    pay T1; the defaults sit near the optimum for the default T1.
    """
    c_floor = 2.0 / max(cooperativity, 1.0)
    rate = eta * kappa_readout * n_bar
    p_shot = float(np.exp(-rate * duration / 4.0))
    p_t1 = 0.5 * (1.0 - float(np.exp(-duration / (2.0 * T1))))
    return float(np.clip(c_floor + p_shot + p_t1, 0.0, 1.0))


@dataclass
class CavityBackend:
    """Bundle of cavity-QED Layer-1 primitives driven by the photon-
    exchange Lindblad calibration (platform #3 next to NeutralAtomBackend
    and IonBackend). Duck-type compatible with qec/executor.py's backend
    interface (cz / rx / measure / T1 / T2)."""

    regime: str = "circuit_qed_exchange"
    exchange_calibration: Optional[CalibrationRecord] = None
    calibration_store: Optional[CalibrationStore] = None
    omega_1q: float = TWO_PI * 2e6        # microwave/Raman 1Q Rabi
    scattering_rate_1q: float = 10.0      # [1/s] error rate during drive
    T1: float = 100e-6                    # Purcell-limited / intrinsic
    T2: float = 150e-6
    readout_duration: float = 1e-6
    readout_eta: float = 0.5              # detection efficiency
    # the readout probe uses its own fast (low-Q) resonator mode — the
    # high-Q GATE cavity in the calibration record is deliberately
    # narrow (small kappa) and would take ~ms to read through
    kappa_readout: float = TWO_PI * 5e6
    n_bar_readout: float = 5.0
    device: str = "cuda"

    def __post_init__(self):
        if self.exchange_calibration is None:
            store = self.calibration_store or CalibrationStore()
            try:
                self.exchange_calibration = store.load(
                    "cavity_qed", "exchange_gate", self.regime)
            except FileNotFoundError:
                self.exchange_calibration = _default_exchange_record(
                    self.regime, self.device)

        self.single_qubit = SingleQubitGate(
            omega_raman=self.omega_1q,
            scattering_rate=self.scattering_rate_1q)
        self.two_qubit = CavityTwoQubitGate(
            calibration=self.exchange_calibration,
            single_qubit=self.single_qubit)
        pars = self.exchange_calibration.parameters
        g = float(pars.get("g", TWO_PI * 50e6))
        kappa = float(pars.get("kappa", TWO_PI * 50e3))
        gamma = float(pars.get("gamma_spont", TWO_PI * 10e3))
        self.cooperativity = (g * g / (kappa * gamma)
                              if kappa > 0 and gamma > 0 else np.inf)
        p_ro = cavity_readout_error(self.cooperativity,
                                    self.readout_duration,
                                    self.kappa_readout,
                                    eta=self.readout_eta,
                                    n_bar=self.n_bar_readout,
                                    T1=self.T1)
        self.idle = Idle(T1=self.T1, T2=self.T2)
        # cavity readout is non-destructive (QND dispersive / reflection)
        self.measure = Measure(fidelity_0=1.0 - p_ro,
                               fidelity_1=1.0 - p_ro,
                               duration=self.readout_duration,
                               loss_probability=0.0, destructive=False)
        self._p_readout = p_ro

    # convenience one-liners (executor interface)
    def exchange(self, q1: int = 0, q2: int = 1) -> GateResult:
        return self.two_qubit(q1, q2, "exchange")

    def cz(self, q1: int = 0, q2: int = 1) -> GateResult:
        return self.two_qubit(q1, q2, "cz")

    def rx(self, q: int, angle: float) -> GateResult:
        return self.single_qubit(q, "rx", angle=angle)

    def rz(self, q: int, angle: float) -> GateResult:
        return self.single_qubit(q, "rz", angle=angle)

    def summary(self) -> Dict:
        xc = self.exchange()
        cz = self.cz()
        return {
            "regime": self.regime,
            "cooperativity": float(self.cooperativity),
            "exchange_fidelity": xc.fidelity,
            "exchange_duration_us": xc.duration * 1e6,
            "cz_fidelity": cz.fidelity,
            "cz_duration_us": cz.duration * 1e6,
            "residual_cphase_rad": self.two_qubit.residual_cphase,
            "sq_pi_duration_us": self.single_qubit(0, "x").duration * 1e6,
            "T1_s": self.T1, "T2_s": self.T2,
            "measure_fidelity": self.measure().fidelity,
            "measure_duration_us": self.readout_duration * 1e6,
        }


__all__ = ["CavityBackend", "CavityTwoQubitGate", "cavity_readout_error",
           "CZ_MATRIX", "CX_MATRIX"]
