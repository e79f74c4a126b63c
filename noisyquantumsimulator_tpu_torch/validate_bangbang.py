"""Bang-bang protocol validation on the port.

Counterpart of the repository's root `validate_bangbang.py`, three checks on
noiseless gates with the trap off at spacing factor 2.945:

  1. varying the switching times changes the result (dF > 1e-4)
  2. the validated 5-segment defaults reach F > 0.9 near V/Omega = 200
  3. bang-bang differs from smooth JP (dF > 1e-4)

The bang-bang gates run the per-segment engine (one batched expm of the 5
segments; kernel K2 squares on the card).

    python -m noisyquantumsimulator_tpu_torch.validate_bangbang
    python -m noisyquantumsimulator_tpu_torch.validate_bangbang --device cpu
"""
from __future__ import annotations

import argparse
from typing import List, Optional, Union

import torch

from .core.configs import (JPSimulationInputs, NoiseSourceConfig,
                           SmoothJPSimulationInputs)
from .gate.simulate import simulate_cz_gate

SWITCHING_B = [3.0, 9.5, 14.0, 20.5]


def run(device: Union[str, torch.device] = "cuda") -> dict:
    """The three checks' numbers at complex128: the fidelities of the
    default bang-bang gate (F_a), of the one with switching times
    SWITCHING_B (F_b) and of smooth JP (F_smooth), the default's V/Omega and
    controlled phase, the two differences and each check's verdict."""
    kw = dict(include_noise=False, trap_laser_on=False, spacing_factor=2.945,
              device=device)
    noiseless = NoiseSourceConfig.noiseless()
    r_a = simulate_cz_gate(JPSimulationInputs(noise=noiseless), **kw)
    r_b = simulate_cz_gate(JPSimulationInputs(noise=noiseless,
                                              switching_times=SWITCHING_B), **kw)
    r_s = simulate_cz_gate(SmoothJPSimulationInputs(noise=noiseless), **kw)
    d = abs(r_a.avg_fidelity - r_b.avg_fidelity)
    d2 = abs(r_a.avg_fidelity - r_s.avg_fidelity)
    return {"F_a": r_a.avg_fidelity, "F_b": r_b.avg_fidelity,
            "F_smooth": r_s.avg_fidelity,
            "V_over_Omega": r_a.V_over_Omega,
            "controlled_phase_deg": r_a.phase_info["controlled_phase_deg"],
            "dF_switching": d, "dF_vs_smooth": d2,
            "pass": [d > 1e-4, r_a.avg_fidelity > 0.9, d2 > 1e-4]}


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    r = run(ap.parse_args(argv).device)
    ok1, ok2, ok3 = r["pass"]
    print(f"[1] switching-time sensitivity: dF = {r['dF_switching']:.4f} "
          f"({'PASS' if ok1 else 'FAIL'})")
    print(f"[2] 5-seg defaults: F = {r['F_a']:.4f} at "
          f"V/Omega = {r['V_over_Omega']:.0f}, controlled phase = "
          f"{r['controlled_phase_deg']:.1f} deg ({'PASS' if ok2 else 'FAIL'})")
    print(f"[3] bang-bang vs smooth JP: dF = {r['dF_vs_smooth']:.4f} "
          f"({'PASS' if ok3 else 'FAIL'})")
    ok = all(r["pass"])
    print("ALL PASS" if ok else "FAILURES PRESENT")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
