"""Cost function and metric extraction for CZ optimization.

Counterpart of the reference's `optimize/cost.py`
(optimize_cz_gate.py:362-457). `compute_cost_arrays` is the tensor version
used inside the batched objectives; `compute_cost` is the host/dict version
with identical semantics.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def compute_cost_arrays(avg_fidelity, f11, cz_phase_fidelity, gate_time_us,
                        time_weight: float = 0.01):
    """Tensor cost: percentage-infidelity quadratic penalties, element-wise
    over any batch shape. (optimize_cz_gate.py:362-433)

    cost = 10 (100(1-F))^2 + 5 (100(1-F11))^2 + 2 (100(1-Fphase))^2
           + time_weight * t_us,  with a 1e6 floor below F=0.5 and on NaN.
    """
    infid = (1.0 - avg_fidelity) * 100.0
    f11_infid = (1.0 - f11) * 100.0
    ph_infid = (1.0 - cz_phase_fidelity) * 100.0
    cost = (10.0 * infid ** 2 + 5.0 * f11_infid ** 2 + 2.0 * ph_infid ** 2
            + time_weight * gate_time_us)
    bad = (torch.isnan(avg_fidelity) | torch.isnan(f11)
           | torch.isnan(cz_phase_fidelity) | (avg_fidelity < 0.50))
    return torch.where(bad, torch.full_like(cost, 1e6), cost)


def compute_cost(metrics: Dict[str, float], gate_time_us: float = 0.0,
                 time_weight: float = 0.01) -> float:
    """Dict version, exact reference semantics. (optimize_cz_gate.py:362)"""
    avg = metrics.get("avg_fidelity", 0.0)
    f11 = metrics.get("f11", 0.0)
    czp = metrics.get("cz_phase_fidelity", 0.0)
    if any(np.isnan(x) for x in (avg, f11, czp)):
        return 1e6
    if avg < 0.50:
        return 1e6
    return float(10.0 * ((1 - avg) * 100) ** 2 + 5.0 * ((1 - f11) * 100) ** 2
                 + 2.0 * ((1 - czp) * 100) ** 2 + time_weight * gate_time_us)


def extract_metrics(result) -> Dict[str, float]:
    """From a GateResult. (optimize_cz_gate.py:434-457)"""
    pi_ = result.phase_info
    f = result.fidelities
    return {
        "controlled_phase_deg": pi_.get("controlled_phase_deg", np.nan),
        "phase_error_deg": pi_.get("phase_error_from_pi_deg", np.nan),
        "cz_phase_fidelity": pi_.get("cz_phase_fidelity", np.nan),
        "f00": f.get("00", np.nan), "f01": f.get("01", np.nan),
        "f10": f.get("10", np.nan), "f11": f.get("11", np.nan),
        "avg_fidelity": result.avg_fidelity,
        "gate_time_us": result.tau_total * 1e6,
        "V_over_Omega": result.V_over_Omega,
        "Omega_MHz": result.Omega / (2 * np.pi * 1e6),
    }


__all__ = ["compute_cost_arrays", "compute_cost", "extract_metrics"]
