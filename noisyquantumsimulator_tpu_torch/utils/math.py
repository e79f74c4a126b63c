"""Numeric helpers (host numpy).

Counterpart of the reference's `utils/math.py`. Only `wilson_ci` is here so
far: the rest of that module depends on the channel and gate-fidelity code,
which later slices of the port bring over.
"""
from __future__ import annotations

import numpy as np


def wilson_ci(k: int, n: int, z: float = 1.96):
    """95% Wilson score interval for a binomial proportion.

    Every published logical-error-rate cell carries this CI plus its raw
    error count. Well-behaved at k = 0, unlike the normal approximation.
    """
    if n <= 0:
        return (0.0, 1.0)
    p = k / n
    den = 1.0 + z * z / n
    ctr = (p + z * z / (2 * n)) / den
    hw = z * np.sqrt(p * (1 - p) / n + z * z / (4 * n * n)) / den
    return (max(0.0, ctr - hw), min(1.0, ctr + hw))


__all__ = ["wilson_ci"]
