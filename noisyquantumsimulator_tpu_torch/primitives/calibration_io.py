"""Bridge helpers: calibration records -> primitive error maps.

Counterpart of the reference's `primitives/calibration_io.py`, copied; host
numpy.
"""
from __future__ import annotations

import numpy as np

from ..channels.calibration import CalibrationRecord, _complex_matrix_from_json


def superop_from_record(rec: CalibrationRecord) -> np.ndarray:
    """Full CPTP superoperator if stored, else the twirled Pauli channel."""
    if rec.superop is not None:
        return _complex_matrix_from_json(rec.superop)
    from ..channels.pauli import pauli_channel_superop
    from ..channels.conversions import unitary_superop
    from ..channels.tomography import CZ_MATRIX
    n = int(round(np.log2(np.sqrt(len(rec.pauli_error_probs)))))
    S_err = pauli_channel_superop(rec.pauli_error_probs, n)
    return S_err @ unitary_superop(CZ_MATRIX)


__all__ = ["superop_from_record"]
