"""Engine-driven MS-gate study: simulate, calibrate, cross-check.

Counterpart of `examples/ms_gate_engine_study.py`: the Lindblad-engine MS
gate (`gate/ms_gate.simulate_ms_gate`, engine "device": one complex128 expm
per noise case, kernel K2 on the card) at the two named operating points,
each written as a CPTP-map calibration record, beside the analytic
`physics/trapped_ions.ms_gate` as the cross-check column.

    python -m noisyquantumsimulator_tpu_torch.studies.ms_gate_engine_study
    python -m noisyquantumsimulator_tpu_torch.studies.ms_gate_engine_study \\
        --device cpu --out /tmp/ms.json

Writes `studies_out/ms_gate_engine_study.json` (or `--out`) with the
script's keys, and the records into a store of its own
(`studies_out/calibration_data/trapped_ions/ms_gate/<regime>.json`, or
`run(store_root=...)`), never into the repository's `calibration_data/`.
A record's `nbar` is the run's (0.05 / 0.02); the shipped records, made by
the reference, store 0.0 there (it keeps the last noise case's).
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path
from typing import Optional

import numpy as np

from ..bench import _device
from ..channels.calibration import CalibrationStore
from ..channels.conversions import pauli_basis
from ..core.constants import TWO_PI
from ..gate.ms_gate import ms_calibration_record, simulate_ms_gate
from ..physics.trapped_ions import ms_gate
from . import OUT_DIR, ROOT, add_common_args, out_path, stamp, write_json

NAME = "ms_gate_engine_study"
STORE = OUT_DIR / "calibration_data"
ENGINE = ("gate/ms_gate.py (Lindblad spin x spin x motional, "
          "rotating-frame exact expm)")

# Named operating points (Yb171 QCCD default; Ca40 high fidelity after
# Ballance PRL 117 060504, whose 397 nm Raman pair projects about one photon
# recoil onto the axial mode: eta ~ 0.126).
REGIMES = {
    "yb171_default": dict(
        species="Yb171", omega_mode=TWO_PI * 3e6, nbar=0.05,
        heating_rate_quanta_per_s=100.0, motional_coherence_time=10e-3,
        laser_coherence_time=1.0, scattering_rate=1.0,
        detuning_from_mode=TWO_PI * 20e3),
    "ca40_high_fidelity": dict(
        species="Ca40", omega_mode=TWO_PI * 2e6, nbar=0.02,
        heating_rate_quanta_per_s=10.0, motional_coherence_time=50e-3,
        laser_coherence_time=5.0, scattering_rate=0.3,
        detuning_from_mode=TWO_PI * 35e3, k_eff=TWO_PI / 397e-9),
}


def _top_paulis(probs, k: int = 3):
    """The k largest non-identity two-qubit Pauli error probabilities, as
    (label, p) pairs, largest first."""
    labels, _ = pauli_basis(2)
    pairs = [(lab, float(p)) for lab, p in zip(labels, probs) if lab != "II"]
    pairs.sort(key=lambda kv: -kv[1])
    return pairs[:k]


def record_path(path: str) -> str:
    """A record's path relative to the repository root when it lies under
    it (as the script writes it), else absolute."""
    p = Path(path).resolve()
    return str(p.relative_to(ROOT)) if p.is_relative_to(ROOT) else str(p)


def budget_top3(budget) -> list:
    return sorted(((k, float(v)) for k, v in budget.items()),
                  key=lambda kv: -kv[1])[:3]


def run(device="cuda", n_fock: int = 10, store_root: Optional[str] = None
        ) -> dict:
    """Both regimes at `n_fock` motional levels; records saved under
    `store_root` (default `studies_out/calibration_data`)."""
    dev = _device(device)
    store = CalibrationStore(str(store_root or STORE))
    out = {**stamp(dev), "engine": ENGINE, "n_fock": n_fock, "regimes": {}}
    for regime, kw in REGIMES.items():
        t0 = time.perf_counter()
        r = simulate_ms_gate(n_fock=n_fock, device=dev, **kw)
        wall = time.perf_counter() - t0
        a = ms_gate(**kw)
        path = store.save(ms_calibration_record(r, regime))
        out["regimes"][regime] = {
            "calibration_record": record_path(path),
            "engine_infidelity": 1.0 - r.fidelity,
            "engine_process_infidelity": 1.0 - r.process_fidelity,
            "analytic_infidelity_crosscheck": 1.0 - a.fidelity,
            "duration_s": r.duration,
            "leakage": r.leakage,
            "cptp": bool(r.completely_positive and r.trace_preserving),
            "budget_top3": budget_top3(r.error_budget),
            "dominant_pauli_errors": _top_paulis(np.asarray(r.error_map_pauli)),
            "sim_wall_s": round(wall, 2),
        }
        print(f"{regime}: 1-F={1 - r.fidelity:.3e} (analytic cross-check "
              f"{1 - a.fidelity:.3e}), tau={r.duration * 1e6:.1f} us, record "
              f"-> {path}", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_common_args(ap)
    a = ap.parse_args(argv)
    out = run(device=a.device)
    print(f"wrote {write_json(out_path(NAME, a.out), out)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
