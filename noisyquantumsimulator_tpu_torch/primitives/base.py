"""Primitive base classes and typed results (Layer 1).

Implements the reference's primitive interface contract, which exists there
only as a comment spec (reference: src/qpu_simulator/primitives/base.py:1-23,
docs/ARCHITECTURE.md:151-178):

  1. Same API across platforms — only parameters differ.
  2. Primitives return structured results (timing, errors, costs).
  3. Primitives are stateless.
  4. Error models are CPTP maps or equivalent representations.

Counterpart of the reference's `primitives/base.py`, copied; host numpy.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclass
class PrimitiveResult:
    """Common result fields (base.py:20-23 spec)."""
    duration: float                       # [s]
    loss_probability: float = 0.0
    error_map: Optional[np.ndarray] = None  # CPTP superoperator (d^2, d^2)
    pauli_error_probs: Optional[np.ndarray] = None
    metadata: Dict = field(default_factory=dict)


@dataclass
class GateResult(PrimitiveResult):
    """(gates.py:24-31 spec)"""
    fidelity: float = 1.0
    leakage: float = 0.0
    crosstalk: float = 0.0


@dataclass
class MoveResult(PrimitiveResult):
    """(move.py:20-29 spec)"""
    heating_quanta: float = 0.0           # motional quanta added
    heating_temperature: float = 0.0      # equivalent Delta-T [K]
    trajectory: Optional[np.ndarray] = None  # (n, 2): t [s], x [m]


@dataclass
class MeasureResult(PrimitiveResult):
    """(measurement.py:16-25 spec)"""
    outcome: Optional[int] = None         # 0/1, None for symbolic use
    fidelity: float = 1.0
    confusion_matrix: Optional[np.ndarray] = None  # [[P(0|0),P(1|0)],[P(0|1),P(1|1)]]
    post_state: Optional[np.ndarray] = None


@dataclass
class CoolResult(PrimitiveResult):
    """(cooling.py:17-27 spec)"""
    final_temperature: float = 0.0        # [K]
    final_nbar: float = 0.0               # mean motional quanta
    success_probability: float = 1.0


@dataclass
class IdleResult(PrimitiveResult):
    """(idle.py:12-28 spec)"""
    T1: float = np.inf
    T2: float = np.inf
    heating_quanta: float = 0.0


class Primitive:
    """Root of the primitive hierarchy. Subclasses implement __call__ and
    return the matching *Result. Stateless: all context is passed in."""

    name: str = "primitive"
    platform: str = "neutral_atoms"

    def __call__(self, *args, **kwargs) -> PrimitiveResult:
        raise NotImplementedError


class GatePrimitive(Primitive):
    name = "gate"


class MovePrimitive(Primitive):
    name = "move"


class MeasurePrimitive(Primitive):
    name = "measure"


class CoolPrimitive(Primitive):
    name = "cool"


class IdlePrimitive(Primitive):
    name = "idle"


__all__ = ["PrimitiveResult", "GateResult", "MoveResult", "MeasureResult",
           "CoolResult", "IdleResult", "Primitive", "GatePrimitive",
           "MovePrimitive", "MeasurePrimitive", "CoolPrimitive",
           "IdlePrimitive"]
