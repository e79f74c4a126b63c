"""Bang-bang diagnosis on the port: sweep the pulse area to localize the
phase error.

Counterpart of the repository's root `diagnose_bb.py`: the noiseless
apparatus at spacing factor 2.945, the 5-segment bang-bang (Jandura-Pupillo)
defaults with the total pulse area Omega * tau swept over 17 points in
[18, 26] around the validated 22.08. The whole sweep is ONE call of the
population objective: one batched expm of 17 x 5 segments (kernel K2
squares them in one launch on the card). It runs at complex128, as the
root script does (it turns on 64-bit floats before it builds the problem).

    python -m noisyquantumsimulator_tpu_torch.diagnose_bb
    python -m noisyquantumsimulator_tpu_torch.diagnose_bb --device cpu
"""
from __future__ import annotations

import argparse
from typing import List, Optional, Union

import numpy as np
import torch

from .optimize.apparatus import ApparatusConstraints
from .optimize.engine import build_fixed_problem, make_population_objective
from .optimize.forward import get_jp_bangbang_bounds_and_x0

AREAS = np.linspace(18.0, 26.0, 17)
VALIDATED_AREA = 22.08
DTYPE = torch.complex128


def sweep(device: Union[str, torch.device] = "cuda") -> dict:
    """The sweep: V/Omega and Omega of the apparatus, the areas, and per
    area the average fidelity, F11, controlled phase and phase error
    (numpy arrays), with the best area."""
    app = ApparatusConstraints(spacing_factor=2.945)
    problem = build_fixed_problem(app, app.make_noiseless(),
                                  include_noise=False, device=device,
                                  dtype=DTYPE)
    _, x0 = get_jp_bangbang_bounds_and_x0(5)
    pop_obj = make_population_objective(problem, "jandura_pupillo",
                                        n_segments=5)
    pop = np.tile(x0, (len(AREAS), 1))
    pop[:, 0] = AREAS
    _, m = pop_obj(torch.as_tensor(pop))
    out = {k: m[k].detach().cpu().numpy().astype(np.float64)
           for k in ("avg_fidelity", "f11", "controlled_phase_deg",
                     "phase_error_deg")}
    best = int(np.argmax(out["avg_fidelity"]))
    out.update(areas=AREAS.copy(), V_over_Omega=float(problem.V_over_Omega),
               Omega=float(problem.Omega), best_area=float(AREAS[best]),
               best_fidelity=float(out["avg_fidelity"][best]))
    return out


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    r = sweep(ap.parse_args(argv).device)
    print(f"apparatus: V/Omega = {r['V_over_Omega']:.1f}, "
          f"Omega/2pi = {r['Omega'] / 2 / np.pi / 1e6:.2f} MHz")
    print(f"{'Omega*tau':>10} {'F':>9} {'F11':>9} {'ctrl_phase':>11} "
          f"{'phase_err':>10}")
    for i, a in enumerate(r["areas"]):
        print(f"{a:>10.2f} {r['avg_fidelity'][i]:>9.4f} {r['f11'][i]:>9.4f} "
              f"{r['controlled_phase_deg'][i]:>10.1f}d "
              f"{r['phase_error_deg'][i]:>9.1f}d")
    print(f"\nbest area: {r['best_area']:.2f} (F = {r['best_fidelity']:.4f}); "
          f"validated = {VALIDATED_AREA}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
