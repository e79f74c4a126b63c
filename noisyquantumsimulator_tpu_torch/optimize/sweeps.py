"""Vectorized parameter sweeps.

Counterpart of the reference's `optimize/sweeps.py`, the rebuild of the
original research sweeps (examples/research_parameter_sweeps.py:81-197
`run_sweep` — a Python loop of full simulate_CZ_gate calls per value). Two
tiers here:

  * protocol_sweep: values enter only the pulse schedule -> the whole sweep
    is ONE batched device call.
  * hardware_sweep: values change trap/noise resolution -> host loop over
    plan_cz_gate (still fast: each point is a single batched-expm call).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch

from ..core.configs import (JPSimulationInputs, LPSimulationInputs,
                            SmoothJPSimulationInputs)
from ..gate.simulate import simulate_cz_gate
from .apparatus import ApparatusConstraints
from .engine import build_fixed_problem, make_population_objective


@dataclass
class SweepResult:
    """Arrays of metrics along the sweep axis."""
    parameter: str
    values: np.ndarray
    fidelity: np.ndarray
    f11: np.ndarray
    gate_time_us: np.ndarray
    phase_error_deg: np.ndarray
    extras: Dict[str, np.ndarray] = field(default_factory=dict)

    def best(self) -> int:
        return int(np.argmax(self.fidelity))


def protocol_sweep(protocol: str, param_index: int, values: Sequence[float],
                   base_params: Sequence[float],
                   apparatus: Optional[ApparatusConstraints] = None,
                   include_noise: bool = True,
                   parameter_name: str = "",
                   device: Union[str, torch.device] = "cuda",
                   dtype: torch.dtype = torch.complex64) -> SweepResult:
    """Sweep one protocol parameter with everything else fixed — one
    batched call for the entire grid, on `device` in complex `dtype`."""
    if apparatus is None:
        apparatus = ApparatusConstraints()
    noise = (apparatus.make_full_noise() if include_noise
             else apparatus.make_noiseless())
    problem = build_fixed_problem(apparatus, noise, include_noise=include_noise,
                                  dtype=dtype, device=device)
    pop_obj = make_population_objective(problem, protocol)

    base = np.asarray(base_params, dtype=float)
    grid = np.tile(base, (len(values), 1))
    grid[:, param_index] = values
    costs, metrics = pop_obj(grid)
    metrics = {k: v.cpu().numpy() for k, v in metrics.items()}
    return SweepResult(
        parameter=parameter_name or f"param[{param_index}]",
        values=np.asarray(values),
        fidelity=metrics["avg_fidelity"],
        f11=metrics["f11"],
        gate_time_us=metrics["gate_time_us"],
        phase_error_deg=metrics["phase_error_deg"],
        extras={"cost": costs.cpu().numpy(),
                "controlled_phase_deg": metrics["controlled_phase_deg"]},
    )


_INPUT_BY_PROTOCOL = {
    "lp": LPSimulationInputs, "levine_pichler": LPSimulationInputs,
    "smooth_jp": SmoothJPSimulationInputs,
    "jandura_pupillo": JPSimulationInputs, "jp": JPSimulationInputs,
}


def hardware_sweep(parameter: str, values: Sequence[float],
                   protocol: str = "smooth_jp",
                   apparatus: Optional[ApparatusConstraints] = None,
                   include_noise: bool = True,
                   sim_kwargs: Optional[dict] = None,
                   device: Union[str, torch.device] = "cuda",
                   dtype: torch.dtype = torch.complex128) -> SweepResult:
    """Sweep an apparatus/environment knob (temperature, spacing_factor,
    n_rydberg, tweezer_power, B_field, NA, laser powers, Delta_e, ...).

    Mirrors the 13 sweep studies of research_parameter_sweeps.py.
    """
    if apparatus is None:
        apparatus = ApparatusConstraints()
    sim_kwargs = dict(sim_kwargs or {})
    fid, f11, t_us, perr, vo = [], [], [], [], []
    cls = _INPUT_BY_PROTOCOL[protocol.lower()]
    for v in values:
        app = ApparatusConstraints(**{**apparatus.__dict__, parameter: v}) \
            if hasattr(apparatus, parameter) else apparatus
        kw = app.sim_kwargs()
        kw.update(sim_kwargs)
        if not hasattr(apparatus, parameter):
            kw[parameter] = v
        noise = (app.make_full_noise() if include_noise
                 else app.make_noiseless())
        si = cls(excitation=app.make_excitation_config(), noise=noise)
        r = simulate_cz_gate(si, device=device, dtype=dtype,
                             include_noise=include_noise, **kw)
        fid.append(r.avg_fidelity)
        f11.append(r.fidelities["11"])
        t_us.append(r.gate_time_us)
        perr.append(r.phase_info["phase_error_from_pi_deg"])
        vo.append(r.V_over_Omega)
    return SweepResult(parameter=parameter, values=np.asarray(values),
                       fidelity=np.asarray(fid), f11=np.asarray(f11),
                       gate_time_us=np.asarray(t_us),
                       phase_error_deg=np.asarray(perr),
                       extras={"V_over_Omega": np.asarray(vo)})


def standard_research_sweeps(include_noise: bool = True, points: int = 5,
                             device: Union[str, torch.device] = "cuda"
                             ) -> Dict[str, SweepResult]:
    """The reference's headline sweep set (research_parameter_sweeps.py:644):
    temperature, linewidth (via apparatus), Delta_e, spacing, n_rydberg,
    tweezer power, NA."""
    app = ApparatusConstraints()
    out = {}
    out["temperature"] = hardware_sweep(
        "temperature", np.linspace(1e-6, 50e-6, points), apparatus=app,
        include_noise=include_noise, device=device)
    out["spacing_factor"] = hardware_sweep(
        "spacing_factor", np.linspace(2.5, 4.5, points), apparatus=app,
        include_noise=include_noise, device=device)
    out["n_rydberg"] = hardware_sweep(
        "n_rydberg", np.arange(50, 90, max(1, 40 // points)), apparatus=app,
        include_noise=include_noise, device=device)
    out["Delta_e"] = hardware_sweep(
        "Delta_e", 2 * np.pi * np.linspace(0.5e9, 5e9, points), apparatus=app,
        include_noise=include_noise, device=device)
    out["tweezer_power"] = hardware_sweep(
        "tweezer_power", np.linspace(5e-3, 50e-3, points), apparatus=app,
        include_noise=include_noise, device=device)
    out["NA"] = hardware_sweep(
        "NA", np.linspace(0.4, 0.7, points), apparatus=app,
        include_noise=include_noise, device=device)
    return out


__all__ = ["SweepResult", "protocol_sweep", "hardware_sweep",
           "standard_research_sweeps"]
