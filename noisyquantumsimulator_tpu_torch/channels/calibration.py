"""Calibration data store: durable JSON artifacts from Layer-0 runs.

Implements the reference's designed-but-empty calibration pipeline
(reference: calibration_data/README.md — JSON files keyed by platform /
regime containing parameter values, error rates, durations, metadata;
"generated by micro-physics simulations, loaded by the primitives layer").

Directory layout mirrors the reference:
    <root>/neutral_atoms/rydberg_cz/n70_<tag>.json
    <root>/neutral_atoms/single_qubit/...
    <root>/neutral_atoms/movement/...

Counterpart of the reference's `channels/calibration.py`; host code. The
default store root is the repository's `calibration_data/`, as the
reference's is. `calibrate_cz` extracts the channel on the device its plan
keywords name (`device`, `dtype`; the card by default).
"""
from __future__ import annotations

import datetime
import json
import os
from dataclasses import asdict, dataclass, field
from typing import Dict, List, Optional

import numpy as np

from .tomography import ExtractedChannel
from .pauli import twirled_error_probs
from .conversions import pauli_basis
from .tomography import CZ_MATRIX

SCHEMA_VERSION = 1


def _complex_matrix_to_json(m: np.ndarray) -> Dict:
    return {"re": np.real(m).tolist(), "im": np.imag(m).tolist(),
            "shape": list(m.shape)}


def _complex_matrix_from_json(d: Dict) -> np.ndarray:
    return (np.asarray(d["re"]) + 1j * np.asarray(d["im"])).reshape(d["shape"])


@dataclass
class CalibrationRecord:
    """One calibrated operation (schema per calibration_data/README.md)."""
    platform: str                 # "neutral_atoms" | "trapped_ions" | ...
    operation: str                # "rydberg_cz" | "single_qubit" | ...
    regime: str                   # e.g. "n70_smooth_jp_2uK"
    parameters: Dict              # inputs that produced this calibration
    error_rates: Dict             # scalar error metrics
    duration: float               # [s]
    pauli_error_probs: Optional[List[float]] = None  # twirled, 4^n entries
    pauli_labels: Optional[List[str]] = None
    superop: Optional[Dict] = None                   # full CPTP map (json)
    metadata: Dict = field(default_factory=dict)
    schema_version: int = SCHEMA_VERSION

    def to_json(self) -> Dict:
        return asdict(self)

    @staticmethod
    def from_json(d: Dict) -> "CalibrationRecord":
        return CalibrationRecord(**d)


def record_from_channel(channel: ExtractedChannel, regime: str,
                        include_superop: bool = True) -> CalibrationRecord:
    """Build a CZ calibration record from an extracted channel."""
    # twirl the frame-aligned channel: local Z phases are calibration
    # frame, not errors
    probs = twirled_error_probs(channel.superop_aligned, CZ_MATRIX)
    labels, _ = pauli_basis(2)
    return CalibrationRecord(
        platform="neutral_atoms",
        operation="rydberg_cz",
        regime=regime,
        parameters={k: v for k, v in channel.metadata.items()
                    if isinstance(v, (int, float, str, bool))},
        error_rates={
            "avg_gate_infidelity": 1.0 - channel.avg_gate_fidelity,
            "process_infidelity": 1.0 - channel.process_fidelity,
            "leakage_mean": channel.mean_leakage,
            "leakage_per_input": channel.leakage_per_input.tolist(),
        },
        duration=channel.duration,
        pauli_error_probs=[float(p) for p in probs],
        pauli_labels=list(labels),
        # store the frame-ALIGNED channel: local Z phases are calibration
        # frame, not errors — consumers (superop_from_record -> Layer-1
        # error maps, derived-gate conjugation) need the channel whose
        # target is the ideal CZ, matching pauli_error_probs above
        superop=(_complex_matrix_to_json(channel.superop_aligned)
                 if include_superop else None),
        metadata={
            "generated": datetime.datetime.now(datetime.timezone.utc).isoformat(),
            "generator": "noisyquantumsimulator_tpu_torch",
            "noise_breakdown": channel.metadata.get("noise_breakdown", {}),
        },
    )


class CalibrationStore:
    """File-backed calibration store (calibration_data/README.md layout)."""

    def __init__(self, root: str = None):
        if root is None:
            # resolve against the repo checkout, not the cwd: backends
            # constructed from a scratch dir must still find the shipped
            # records (silent fallback to in-process regeneration would
            # change the pricing)
            root = os.path.join(os.path.dirname(os.path.dirname(
                os.path.dirname(os.path.abspath(__file__)))),
                "calibration_data")
            if not os.path.isdir(root) and os.path.isdir("calibration_data"):
                root = "calibration_data"
        self.root = root

    def _path(self, rec_or: CalibrationRecord | tuple) -> str:
        if isinstance(rec_or, CalibrationRecord):
            platform, op, regime = rec_or.platform, rec_or.operation, rec_or.regime
        else:
            platform, op, regime = rec_or
        return os.path.join(self.root, platform, op, f"{regime}.json")

    def save(self, record: CalibrationRecord) -> str:
        path = self._path(record)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            json.dump(record.to_json(), f, indent=1)
        return path

    def load(self, platform: str, operation: str, regime: str
             ) -> CalibrationRecord:
        with open(self._path((platform, operation, regime))) as f:
            return CalibrationRecord.from_json(json.load(f))

    def load_superop(self, platform: str, operation: str, regime: str
                     ) -> np.ndarray:
        rec = self.load(platform, operation, regime)
        if rec.superop is None:
            raise ValueError(f"record {regime} has no stored superoperator")
        return _complex_matrix_from_json(rec.superop)

    def list_records(self) -> List[str]:
        out = []
        for dirpath, _, files in os.walk(self.root):
            for fn in files:
                if fn.endswith(".json"):
                    out.append(os.path.join(dirpath, fn))
        return sorted(out)


def calibrate_cz(regime: str = "n70_smooth_jp_default",
                 store: Optional[CalibrationStore] = None,
                 simulation_inputs=None, **plan_kwargs) -> CalibrationRecord:
    """One-call Layer-0 -> calibration-file pipeline."""
    from .tomography import extract_cz_channel
    ch = extract_cz_channel(simulation_inputs, **plan_kwargs)
    rec = record_from_channel(ch, regime)
    if store is not None:
        store.save(rec)
    return rec


__all__ = ["SCHEMA_VERSION", "CalibrationRecord", "record_from_channel",
           "CalibrationStore", "calibrate_cz"]
