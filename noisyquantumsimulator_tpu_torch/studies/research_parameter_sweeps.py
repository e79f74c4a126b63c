"""Research parameter sweeps: the headline study set.

Counterpart of `examples/research_parameter_sweeps.py`: nine hardware
sweeps of the noisy smooth-JP CZ gate (`optimize/sweeps.hardware_sweep`,
one `simulate_cz_gate` per point at complex128), two protocol sweeps (one
batched population call each, complex64), the Rb87 / Cs133 temperature
comparison, the pulse-shape comparison, the protocol summary under named
conditions and the per-source noise breakdown, then the sweep grid plot
when matplotlib is there.

    python -m noisyquantumsimulator_tpu_torch.studies.research_parameter_sweeps --quick
    python -m noisyquantumsimulator_tpu_torch.studies.research_parameter_sweeps \\
        --quick --device cpu --out /tmp/sweeps.json

Writes `studies_out/research_parameter_sweeps.json` (or `--out`) with the
script's keys, and the PNG beside it.
"""
from __future__ import annotations

import argparse
import time
import warnings
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..bench import _device
from ..core.configs import LPSimulationInputs, SmoothJPSimulationInputs
from ..gate.simulate import simulate_cz_gate
from ..optimize.apparatus import ApparatusConstraints
from ..optimize.sweeps import hardware_sweep, protocol_sweep
from ..utils.observability import provenance_stamp
from . import add_common_args, out_path, write_json

NAME = "research_parameter_sweeps"


def hardware_studies(points: int):
    """(apparatus field, values) of the nine hardware sweeps."""
    return (
        ("temperature", np.linspace(1e-6, 50e-6, points)),
        ("laser_1_linewidth_hz", np.logspace(1, 4, points)),
        ("Delta_e", 2 * np.pi * np.linspace(0.5e9, 5e9, points)),
        ("spacing_factor", np.linspace(2.5, 4.5, points)),
        ("n_rydberg", np.linspace(55, 85, points).astype(int)),
        ("tweezer_power", np.linspace(5e-3, 50e-3, points)),
        ("NA", np.linspace(0.4, 0.7, points)),
        ("laser_2_power", np.linspace(0.1, 1.0, points)),
        ("B_field", np.linspace(0.5e-4, 5e-4, points)),
    )


# the protocol summary's named conditions (apparatus overrides)
CONDITIONS = (
    ("ideal", {}),
    ("hot_100uK", {"temperature": 100e-6}),
    ("noisy_laser_1kHz", {"laser_1_linewidth_hz": 1000.0,
                          "laser_2_linewidth_hz": 1000.0}),
    ("close_spacing_2.2x", {"spacing_factor": 2.2}),
    ("low_n_60", {"n_rydberg": 60}),
    ("high_n_85", {"n_rydberg": 85}),
    ("Cs133", {"species": "Cs133"}),
)
BREAKDOWN_CONDITIONS = (("default", {}),) + CONDITIONS[1:3]
PULSE_SHAPES = ("square", "gaussian", "blackman")


def _with(app: ApparatusConstraints, overrides: dict) -> ApparatusConstraints:
    return ApparatusConstraints(**{**app.__dict__, **overrides})


def _gate(cls, app: ApparatusConstraints, device, sim_kwargs, **inputs):
    return simulate_cz_gate(
        cls(excitation=app.make_excitation_config(),
            noise=app.make_full_noise(), **inputs),
        device=device, dtype=torch.complex128,
        **{**app.sim_kwargs(), **sim_kwargs})


def hardware_sweeps(app: ApparatusConstraints, points: int, device,
                    sim_kwargs: Optional[dict] = None,
                    names: Optional[Sequence[str]] = None) -> Dict[str, dict]:
    """The nine hardware sweeps (or those in `names`), smooth JP,
    complex128."""
    out = {}
    for name, values in hardware_studies(points):
        if names is not None and name not in names:
            continue
        print(f"sweep {name} ...", flush=True)
        r = hardware_sweep(name, values, protocol="smooth_jp", apparatus=app,
                           sim_kwargs=sim_kwargs, device=device)
        out[name] = {"values": np.asarray(values, dtype=float).tolist(),
                     "fidelity": r.fidelity.tolist(),
                     "gate_time_us": r.gate_time_us.tolist(),
                     "phase_error_deg": r.phase_error_deg.tolist()}
    return out


def protocol_sweeps(app: ApparatusConstraints, points: int, device
                    ) -> Dict[str, dict]:
    """LP's Delta/Omega and smooth JP's amplitude, one batched call each
    (the population objective, complex64)."""
    print("protocol sweeps ...", flush=True)
    lp = protocol_sweep("lp", 0, np.linspace(0.30, 0.45, 4 * points),
                        [0.377371, 4.29268], apparatus=app, device=device)
    sj = protocol_sweep("smooth_jp", 1,
                        np.linspace(0.2, 0.45, 4 * points) * np.pi,
                        [10.09, 0.311 * np.pi, 1.242, 4.696, 0.0205],
                        apparatus=app, device=device)
    return {"lp_delta_over_omega": {"values": lp.values.tolist(),
                                    "fidelity": lp.fidelity.tolist()},
            "smooth_jp_amplitude": {"values": sj.values.tolist(),
                                    "fidelity": sj.fidelity.tolist()}}


def species_comparison(app: ApparatusConstraints, points: int, device,
                       sim_kwargs: Optional[dict] = None) -> dict:
    """Temperature sweeps of LP and smooth JP for Rb87 and Cs133."""
    print("species comparison ...", flush=True)
    temps = np.array([10e-6, 20e-6, 40e-6, 80e-6])[:points]
    res = {}
    for species in ("Rb87", "Cs133"):
        app_s = _with(app, {"species": species})
        per = {}
        for proto in ("lp", "smooth_jp"):
            r = hardware_sweep("temperature", temps, protocol=proto,
                               apparatus=app_s, sim_kwargs=sim_kwargs,
                               device=device)
            per[proto] = {"fidelity": r.fidelity.tolist(),
                          "gate_time_us": r.gate_time_us.tolist()}
        res[species] = per
    return {"temperature_K": temps.tolist(), **res}


def pulse_shapes(app: ApparatusConstraints, device,
                 sim_kwargs: Optional[dict] = None) -> dict:
    """LP under three pulse shapes, and the smooth-JP pulse."""
    print("pulse shapes ...", flush=True)
    sim_kwargs = sim_kwargs or {}
    shapes = {}
    for ps in PULSE_SHAPES:
        r = _gate(LPSimulationInputs, app, device, sim_kwargs, pulse_shape=ps)
        shapes[ps] = {"fidelity": r.avg_fidelity,
                      "gate_time_us": r.gate_time_us,
                      "gamma_leakage": r.noise_breakdown.get("gamma_leakage",
                                                             0.0)}
    r = _gate(SmoothJPSimulationInputs, app, device, sim_kwargs)
    shapes["smooth_sinusoidal (JP)"] = {"fidelity": r.avg_fidelity,
                                        "gate_time_us": r.gate_time_us}
    return shapes


def protocol_summary(app: ApparatusConstraints, device,
                     sim_kwargs: Optional[dict] = None,
                     conditions=CONDITIONS) -> dict:
    """LP and smooth JP under each named condition."""
    print("protocol summary ...", flush=True)
    sim_kwargs = sim_kwargs or {}
    summary = {}
    for name, overrides in conditions:
        app_c = _with(app, overrides)
        summary[name] = {
            proto: {"fidelity": r.avg_fidelity, "gate_time_us": r.gate_time_us}
            for proto, r in (
                ("lp", _gate(LPSimulationInputs, app_c, device, sim_kwargs)),
                ("smooth_jp", _gate(SmoothJPSimulationInputs, app_c, device,
                                    sim_kwargs)))}
    return summary


def noise_breakdown(app: ApparatusConstraints, device,
                    sim_kwargs: Optional[dict] = None) -> dict:
    """The per-source rate and error budget at the default and two stressed
    points (the numbers of the gate's noise breakdown)."""
    print("noise breakdown ...", flush=True)
    sim_kwargs = sim_kwargs or {}
    nb = {}
    for name, overrides in BREAKDOWN_CONDITIONS:
        r = _gate(SmoothJPSimulationInputs, _with(app, overrides), device,
                  sim_kwargs)
        nb[name] = {
            k: v for k, v in r.noise_breakdown.items()
            if isinstance(v, (int, float))}
    return nb


def run(quick: bool = False, device="cuda", points: Optional[int] = None,
        sim_kwargs: Optional[dict] = None) -> dict:
    """The whole study: 3 points a sweep with `quick`, else 7 (or
    `points`). `sim_kwargs` go to every gate simulation (e.g.
    n_steps_smooth / n_steps_shaped for a cut run). `seconds` holds each
    part's wall time."""
    dev = _device(device)
    points = points or (3 if quick else 7)
    app = ApparatusConstraints()
    seconds = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        return out

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        results = timed("hardware_sweeps", hardware_sweeps, app, points, dev,
                        sim_kwargs)
        results.update(timed("protocol_sweeps", protocol_sweeps, app, points,
                             dev))
        for key, fn, args in (
                ("species_comparison", species_comparison, (points,)),
                ("pulse_shape_comparison", pulse_shapes, ()),
                ("protocol_summary", protocol_summary, ()),
                ("noise_breakdown", noise_breakdown, ())):
            results[key] = timed(key, fn, app, *args, dev, sim_kwargs)
    results["seconds"] = seconds
    results.update(provenance_stamp())
    return results


def plot(results: dict, png) -> Optional[str]:
    """The sweep grid, when matplotlib is installed (None otherwise)."""
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return None
    from ..utils.visualization import plot_sweep_grid
    plottable = {k: v for k, v in results.items()
                 if isinstance(v, dict) and "values" in v}
    return plot_sweep_grid(plottable, str(png))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="3 points a sweep (default 7)")
    add_common_args(ap)
    a = ap.parse_args(argv)
    results = run(quick=a.quick, device=a.device)
    path = write_json(out_path(NAME, a.out), results)
    print(f"wrote {path}")
    png = plot(results, path.with_suffix(".png"))
    print(f"wrote {png}" if png else "(no plots: matplotlib is not installed)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
