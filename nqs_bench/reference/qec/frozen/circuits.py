# Frozen copy of the port's host code (noisyquantumsimulator_tpu_torch/qec/circuits.py), kept so that the
# benchmark's reference rebuilds the BB memory experiment from its configuration
# file without importing the program. Only the imports were changed, and what the
# reference never reaches was left out.
"""Stabilizer-circuit IR for the vectorized Pauli-frame sampler.

Host numpy, copied from the reference's `qec/circuits.py` unchanged, so the
port builds the same circuits without importing the JAX package.

This is the TPU replacement for the reference's planned Stim engine
(reference: src/qpu_simulator/architecture/simulator.py:5-21 — "Clifford
(Stim-based), Pauli frame tracking, detector error models" — comment-only).

A Circuit is a flat list of instructions over integer qubit indices:

  gates    : H, S, X, Z, CX, CZ, SWAP
  channels : X_ERROR(p), Z_ERROR(p), DEPOLARIZE1(p), DEPOLARIZE2(p),
             PAULI_CHANNEL_2(probs16), ERASE(p)  (heralded loss)
  readout  : M(p_flip) (Z-basis, records a bit), R (reset to |0>),
             MR(p_flip) (measure + reset)
  logic    : DETECTOR(rec indices), OBSERVABLE_INCLUDE(obs_id, rec indices)

rec indices are negative lookbacks (-1 = latest measurement), as in the
public Stim circuit language, or absolute non-negative indices.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

GATES_1Q = ("H", "S", "X", "Z", "Y", "I")
GATES_2Q = ("CX", "CZ", "SWAP")
CHANNELS = ("X_ERROR", "Z_ERROR", "DEPOLARIZE1", "DEPOLARIZE2",
            "PAULI_CHANNEL_2", "ERASE")
READOUT = ("M", "R", "MR")


@dataclass
class Instruction:
    name: str
    targets: np.ndarray                  # (k,) or (k, 2) int32
    arg: Optional[float] = None          # probability for channels / M
    probs: Optional[np.ndarray] = None   # (16,) for PAULI_CHANNEL_2


@dataclass
class Circuit:
    n_qubits: int
    instructions: List[Instruction] = field(default_factory=list)
    detectors: List[np.ndarray] = field(default_factory=list)   # abs rec idx
    observables: Dict[int, List[int]] = field(default_factory=dict)
    n_measurements: int = 0

    # ---- builders ----------------------------------------------------
    def append(self, name: str, targets, arg: Optional[float] = None,
               probs: Optional[np.ndarray] = None):
        name = name.upper()
        t = np.atleast_1d(np.asarray(targets, dtype=np.int32))
        if name in GATES_2Q or name in ("DEPOLARIZE2", "PAULI_CHANNEL_2"):
            t = t.reshape(-1, 2)
        if name == "M" or name == "MR":
            self.n_measurements += len(t)
        if name == "PAULI_CHANNEL_2" and probs is None:
            raise ValueError("PAULI_CHANNEL_2 needs a 16-entry probs vector")
        self.instructions.append(Instruction(name, t, arg, probs))
        return self

    def _resolve_rec(self, rec: Sequence[int]) -> np.ndarray:
        out = []
        for r in rec:
            out.append(self.n_measurements + r if r < 0 else r)
        a = np.asarray(out, dtype=np.int32)
        if np.any(a < 0) or np.any(a >= self.n_measurements):
            raise ValueError(f"detector rec out of range: {rec}")
        return a

    def detector(self, rec: Sequence[int]):
        """rec: measurement indices (negative = lookback)."""
        self.detectors.append(self._resolve_rec(rec))
        return self

    def observable_include(self, obs_id: int, rec: Sequence[int]):
        self.observables.setdefault(obs_id, []).extend(
            self._resolve_rec(rec).tolist())
        return self

    # ---- introspection -------------------------------------------------
    @property
    def n_detectors(self) -> int:
        return len(self.detectors)

    @property
    def n_observables(self) -> int:
        return len(self.observables)

    def counts(self) -> Dict[str, int]:
        c: Dict[str, int] = {}
        for ins in self.instructions:
            c[ins.name] = c.get(ins.name, 0) + len(ins.targets)
        return c

    def __repr__(self):
        return (f"Circuit(n_qubits={self.n_qubits}, "
                f"instructions={len(self.instructions)}, "
                f"measurements={self.n_measurements}, "
                f"detectors={self.n_detectors}, "
                f"observables={self.n_observables})")


def detector_matrix(circuit: Circuit) -> np.ndarray:
    """(n_detectors, n_measurements) uint8 parity-check of detectors."""
    D = np.zeros((circuit.n_detectors, circuit.n_measurements), dtype=np.uint8)
    for i, rec in enumerate(circuit.detectors):
        for r in rec:
            D[i, r] ^= 1
    return D


def observable_matrix(circuit: Circuit) -> np.ndarray:
    """(n_observables, n_measurements) uint8."""
    O = np.zeros((max(circuit.observables.keys(), default=-1) + 1,
                  circuit.n_measurements), dtype=np.uint8)
    for k, recs in circuit.observables.items():
        for r in recs:
            O[k, r] ^= 1
    return O


__all__ = ["Instruction", "Circuit", "detector_matrix", "observable_matrix",
           "GATES_1Q", "GATES_2Q", "CHANNELS", "READOUT"]
