"""NeutralAtomBackend: the bundle of Layer-1 primitives for one apparatus.

The reference specifies (primitives/__init__.py:1-24) a hardware-abstracted
operation API that "consumes outputs from the micro-physics layer"; this
class is that consumer: it loads (or generates) Layer-0 calibration and
exposes Move / SingleQubitGate / TwoQubitGate / Measure / Cool / Idle with
consistent parameters.

Counterpart of the reference's `primitives/backend.py`. The backend's
`device` (the card by default) goes to every generation call: the CZ
channel (`calibrate_cz`), the readout and cooling expms. The Raman record
is generated on the host (gate/raman_gate.py) and is saved only to an
explicit store, as in the reference; the default store is read, never
written.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

from ..core.constants import TWO_PI
from ..channels.calibration import (CalibrationRecord, CalibrationStore,
                                    calibrate_cz)
from .base import (CoolResult, GateResult, IdleResult, MeasureResult,
                   MoveResult)
from .gates import SingleQubitGate, TwoQubitGate
from .motion import Cool, Idle, Measure, Move


@dataclass
class NeutralAtomBackend:
    species: str = "Rb87"
    n_rydberg: int = 70
    trap_frequency: float = TWO_PI * 100e3
    trap_depth_K: float = 1e-3
    cz_calibration: Optional[CalibrationRecord] = None
    calibration_store: Optional[CalibrationStore] = None
    cz_regime: str = "n70_smooth_jp_default"
    raman_calibration: Optional[CalibrationRecord] = None
    raman_regime: str = "rb87_pi2_default"
    readout_calibration: Optional[CalibrationRecord] = None
    readout_regime: str = "rb87_highna_2ms"
    cooling_calibration: Optional[CalibrationRecord] = None
    cooling_regime: str = "rb87_rsc_100khz"
    T1: float = 4.0
    T2: float = 1.0
    device: str = "cuda"

    def __post_init__(self):
        if self.cz_calibration is None:
            # load the shipped record first (default repo store): the
            # in-process regeneration is a full Layer-0 channel
            # extraction and should only run for regimes without a
            # committed record
            store = self.calibration_store or CalibrationStore()
            try:
                self.cz_calibration = store.load(
                    "neutral_atoms", "rydberg_cz", self.cz_regime)
            except FileNotFoundError:
                self.cz_calibration = calibrate_cz(
                    regime=self.cz_regime, store=self.calibration_store,
                    species=self.species, n_rydberg=self.n_rydberg,
                    device=self.device)

        # engine-driven Raman 1Q calibration (gate/raman_gate.py): load
        # from the store, else generate in-process (host expm on the
        # 4-level Lambda system — sub-second)
        if self.raman_calibration is None:
            from ..gate.raman_gate import (raman_calibration_record,
                                           simulate_raman_gate)
            loaded = None
            if self.calibration_store is not None:
                try:
                    loaded = self.calibration_store.load(
                        "neutral_atoms", "raman_1q", self.raman_regime)
                except FileNotFoundError:
                    pass
            if loaded is None:
                res = simulate_raman_gate(theta=np.pi / 2,
                                          species=self.species)
                loaded = raman_calibration_record(res, self.raman_regime)
                if self.calibration_store is not None:
                    self.calibration_store.save(loaded)
            self.raman_calibration = loaded

        self.single_qubit = SingleQubitGate(
            calibration=self.raman_calibration)
        self.two_qubit = TwoQubitGate(calibration=self.cz_calibration,
                                      single_qubit=self.single_qubit)
        self.move = Move(species=self.species,
                         trap_frequency=self.trap_frequency,
                         trap_depth_K=self.trap_depth_K)

        # engine-driven sideband-cooling calibration (gate/cooling.py:
        # exact Fock-ladder master equation); load-else-generate like
        # the readout record above
        if self.cooling_calibration is None:
            from ..gate.cooling import (cooling_calibration_record,
                                        simulate_sideband_cooling)
            store = self.calibration_store or CalibrationStore()
            try:
                self.cooling_calibration = store.load(
                    "neutral_atoms", "cooling", self.cooling_regime)
            except FileNotFoundError:
                res = simulate_sideband_cooling(
                    omega_trap=self.trap_frequency, device=self.device)
                self.cooling_calibration = cooling_calibration_record(
                    res, self.cooling_regime)
                if self.calibration_store is not None:
                    self.calibration_store.save(self.cooling_calibration)
        self.cool = Cool(species=self.species,
                         trap_frequency=self.trap_frequency,
                         calibration=self.cooling_calibration)
        self.idle = Idle(T1=self.T1, T2=self.T2)

        # engine-driven readout calibration (gate/readout.py: exact
        # counting-master-equation confusion matrix): load from the
        # store, else generate in-process (one 540 x 540 expm)
        if self.readout_calibration is None:
            from ..gate.readout import (readout_calibration_record,
                                        simulate_fluorescence_readout)
            store = self.calibration_store or CalibrationStore()
            try:
                self.readout_calibration = store.load(
                    "neutral_atoms", "readout", self.readout_regime)
            except FileNotFoundError:
                res = simulate_fluorescence_readout(device=self.device)
                self.readout_calibration = readout_calibration_record(
                    res, self.readout_regime)
                if self.calibration_store is not None:
                    self.calibration_store.save(self.readout_calibration)
        rrec = self.readout_calibration
        cm = np.asarray(rrec.metadata["confusion_matrix"], dtype=float)
        self.measure = Measure(
            fidelity_0=float(cm[0, 0]), fidelity_1=float(cm[1, 1]),
            duration=rrec.duration,
            loss_probability=rrec.error_rates.get("loss_bright", 0.0),
            destructive=False)

    # convenience one-liners
    def cz(self, q1: int = 0, q2: int = 1) -> GateResult:
        return self.two_qubit(q1, q2, "cz")

    def rx(self, q: int, angle: float) -> GateResult:
        return self.single_qubit(q, "rx", angle=angle)

    def rz(self, q: int, angle: float) -> GateResult:
        return self.single_qubit(q, "rz", angle=angle)

    def summary(self) -> Dict:
        cz = self.cz()
        return {
            "species": self.species, "n_rydberg": self.n_rydberg,
            "cz_fidelity": cz.fidelity, "cz_duration_us": cz.duration * 1e6,
            "cz_leakage": cz.leakage,
            "sq_pi_duration_us": self.single_qubit(0, "x").duration * 1e6,
            "T1_s": self.T1, "T2_s": self.T2,
            "measure_fidelity": self.measure().fidelity,
        }


__all__ = ["NeutralAtomBackend"]
