"""The six published research figures: their data on the device, then the
PNGs.

Counterpart of `examples/generate_figures.py`, split in two:
`figure_data` does all the device work (every gate at complex128, as the
script runs with x64 on) and returns the six series as plain lists; `plot`
draws them under the script's file names with matplotlib and
`utils/visualization`:

  1. blockade_importance: F against V / Omega through the spacing factor,
     noiseless (trap off) and with full noise (`hardware_sweep`);
  2. noise_breakdown: the default smooth-JP gate's Lindblad rates;
  3. protocol_comparison_optimal: LP, smooth JP and bang-bang at their
     validated parameters (1 - F and gate time);
  4. species_comparison: Rb87 and Cs133 against the Rydberg level n;
  5. temperature_sensitivity: the temperature sweep;
  6. pareto_true_fidelity_time: a short hardware exploration
     (`explore_parameter_space`, seed 3) and its Pareto front.

    python -m noisyquantumsimulator_tpu_torch.studies.generate_figures --quick
    python -m noisyquantumsimulator_tpu_torch.studies.generate_figures \\
        --quick --device cpu --out /tmp/figures.json

Writes the data to `studies_out/generate_figures.json` (or `--out`) and,
when matplotlib is installed, the PNGs to `studies_out/figures/` (or
`--figdir`), never to the repository's `figures/`.
"""
from __future__ import annotations

import argparse
import os
import time
import warnings
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..bench import _device
from ..core.configs import (JPSimulationInputs, LPSimulationInputs,
                            SmoothJPSimulationInputs)
from ..gate.simulate import simulate_cz_gate
from ..optimize.apparatus import ApparatusConstraints
from ..optimize.inverse import (EvaluatedPoint, ExplorationResult,
                                explore_parameter_space)
from ..optimize.sweeps import hardware_sweep
from . import OUT_DIR, add_common_args, out_path, stamp, write_json

NAME = "generate_figures"
FIGDIR = OUT_DIR / "figures"
PNGS = ("blockade_importance.png", "noise_breakdown.png",
        "protocol_comparison_optimal.png", "species_comparison.png",
        "temperature_sensitivity.png", "pareto_true_fidelity_time.png")
PROTOCOLS = (("Levine-\nPichler", LPSimulationInputs),
             ("smooth JP", SmoothJPSimulationInputs),
             ("bang-bang", JPSimulationInputs))
SPECIES = ("Rb87", "Cs133")
C128 = torch.complex128


def blockade_spacings(n_pts: int) -> np.ndarray:
    return np.linspace(2.2, 8.0, max(n_pts, 6))


def rydberg_levels(n_pts: int) -> np.ndarray:
    return np.linspace(55, 85, n_pts).astype(int)


def temperatures(n_pts: int) -> np.ndarray:
    return np.linspace(1e-6, 50e-6, n_pts)


def _gate(cls, dev, sim_kwargs, **kw):
    return simulate_cz_gate(cls(), device=dev, dtype=C128,
                            **{**sim_kwargs, **kw})


def figure_data(quick: bool = False, device="cuda",
                points: Optional[int] = None,
                sim_kwargs: Optional[dict] = None,
                pareto: Optional[Tuple[int, int]] = None) -> dict:
    """The six series: 4 points a sweep with `quick`, else 9 (or `points`);
    the exploration runs (maxiter, popsize) = `pareto` (default (3, 6)
    quick, (12, 10) else). `sim_kwargs` go to every gate simulation but the
    exploration's (e.g. n_steps_smooth for a cut run). `seconds` holds each
    part's wall time."""
    dev = _device(device)
    n_pts = points or (4 if quick else 9)
    maxiter, popsize = pareto or ((3, 6) if quick else (12, 10))
    sk = dict(sim_kwargs or {})
    app = ApparatusConstraints()
    data, seconds = {}, {}
    t = time.perf_counter()

    def lap(name):
        nonlocal t
        now = time.perf_counter()
        seconds[name] = now - t
        t = now
        print(f"{name}: {seconds[name]:.2f} s", flush=True)

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        spacings = blockade_spacings(n_pts)
        blockade = {"spacing_factor": spacings.tolist()}
        for label, noisy in (("noiseless", False), ("full noise", True)):
            sw = hardware_sweep("spacing_factor", spacings,
                                protocol="smooth_jp", apparatus=app,
                                include_noise=noisy,
                                sim_kwargs=sk if noisy
                                else {**sk, "trap_laser_on": False},
                                device=dev)
            blockade[label] = {
                "V_over_Omega": sw.extras["V_over_Omega"].tolist(),
                "fidelity": sw.fidelity.tolist()}
        data["blockade_importance"] = blockade
        lap("blockade_importance")

        r = _gate(SmoothJPSimulationInputs, dev, sk)
        data["noise_breakdown"] = {
            k: float(v) for k, v in r.noise_breakdown.items()
            if isinstance(v, (int, float)) and not isinstance(v, bool)}
        lap("noise_breakdown")

        rows = [_gate(cls, dev, sk) for _, cls in PROTOCOLS]
        data["protocol_comparison"] = {
            "names": [n for n, _ in PROTOCOLS],
            "fidelity": [rr.avg_fidelity for rr in rows],
            "gate_time_us": [rr.tau_total * 1e6 for rr in rows]}
        lap("protocol_comparison")

        ns = rydberg_levels(n_pts)
        data["species_comparison"] = {"n_rydberg": ns.tolist(), **{
            sp: [_gate(SmoothJPSimulationInputs, dev, sk, species=sp,
                       n_rydberg=int(n)).avg_fidelity for n in ns]
            for sp in SPECIES}}
        lap("species_comparison")

        temps = temperatures(n_pts)
        sw = hardware_sweep("temperature", temps, protocol="smooth_jp",
                            apparatus=app, sim_kwargs=sk, device=dev)
        data["temperature_sensitivity"] = {"temperature_K": temps.tolist(),
                                           "fidelity": sw.fidelity.tolist()}
        lap("temperature_sensitivity")

        ex = explore_parameter_space(protocol="smooth_jp", n_runs=1,
                                     maxiter=maxiter, popsize=popsize,
                                     seeds=[3], device=dev, dtype=C128)
        front = ex.compute_pareto_front()
        data["pareto"] = {
            "maxiter": maxiter, "popsize": popsize,
            "params": [np.asarray(p.params, float).tolist() for p in ex.points],
            "fidelity": [float(p.fidelity) for p in ex.points],
            "gate_time_us": [float(p.gate_time_us) for p in ex.points],
            "front_fidelity": [float(p.fidelity) for p in front],
            "front_gate_time_us": [float(p.gate_time_us) for p in front]}
        lap("pareto")
    data["points"] = n_pts
    data["seconds"] = seconds
    data.update(stamp(dev))
    return data


def plot(data: dict, figdir=FIGDIR) -> List[str]:
    """The six PNGs from `figure_data`'s output, into `figdir`. Needs
    matplotlib."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from ..utils.visualization import (plot_exploration_results,
                                       plot_noise_breakdown)
    os.makedirs(figdir, exist_ok=True)
    paths = [os.path.join(figdir, name) for name in PNGS]

    def figure():
        return plt.subplots(figsize=(6, 4))

    def save(fig, path):
        fig.tight_layout()
        fig.savefig(path, dpi=150)
        plt.close(fig)

    b = data["blockade_importance"]
    fig, ax = figure()
    for label in ("noiseless", "full noise"):
        ax.loglog(b[label]["V_over_Omega"],
                  1 - np.asarray(b[label]["fidelity"]), "o-", label=label)
    ax.set_xlabel("V / Omega")
    ax.set_ylabel("infidelity")
    ax.legend()
    ax.set_title("Blockade strength drives gate fidelity")
    save(fig, paths[0])

    plot_noise_breakdown(data["noise_breakdown"], paths[1])

    pc = data["protocol_comparison"]
    fig, ax = figure()
    bars = ax.bar(pc["names"], [1 - f for f in pc["fidelity"]],
                  color="tab:blue")
    for rect, t in zip(bars, pc["gate_time_us"]):
        ax.text(rect.get_x() + rect.get_width() / 2, rect.get_height(),
                f"{t:.2f} us", ha="center", va="bottom", fontsize=8)
    ax.set_ylabel("infidelity (full noise)")
    ax.set_yscale("log")
    save(fig, paths[2])

    sc = data["species_comparison"]
    fig, ax = figure()
    for sp in SPECIES:
        ax.plot(sc["n_rydberg"], 1 - np.asarray(sc[sp]), "o-", label=sp)
    ax.set_xlabel("principal quantum number n")
    ax.set_ylabel("infidelity")
    ax.set_yscale("log")
    ax.legend()
    save(fig, paths[3])

    ts = data["temperature_sensitivity"]
    fig, ax = figure()
    ax.plot(np.asarray(ts["temperature_K"]) * 1e6,
            1 - np.asarray(ts["fidelity"]), "o-")
    ax.set_xlabel("atom temperature [uK]")
    ax.set_ylabel("infidelity")
    save(fig, paths[4])

    pa = data["pareto"]
    ex = ExplorationResult(protocol="smooth_jp", points=[
        EvaluatedPoint(params=np.asarray(x), fidelity=f, gate_time_us=t)
        for x, f, t in zip(pa["params"], pa["fidelity"], pa["gate_time_us"])])
    plot_exploration_results(ex, paths[5])
    return paths


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="4 points a sweep and a 3 x 6 exploration (default "
                         "9 points, 12 x 10)")
    ap.add_argument("--figdir", default=None,
                    help="directory of the PNGs (default studies_out/figures)")
    add_common_args(ap)
    a = ap.parse_args(argv)
    data = figure_data(quick=a.quick, device=a.device)
    print(f"wrote {write_json(out_path(NAME, a.out), data)}")
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        print("(no plots: matplotlib is not installed)")
        return 0
    for path in plot(data, a.figdir or FIGDIR):
        print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
