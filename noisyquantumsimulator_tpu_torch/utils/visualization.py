"""Plotting helpers (matplotlib, imported when a plot is made).

Counterpart of the reference's `utils/visualization.py`, copied: the
exploration scatter with its Pareto front, Pareto comparisons, a parameter
heatmap, the noise breakdown, sweep grids, QEC scaling plots, the surface
code layout and a syndrome history. Tensors (on any device) are turned
into numpy arrays first. Host code only: nothing here runs on the card.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch


def _np(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def plot_exploration_results(exploration, path: str = "exploration.png"):
    """Fidelity vs gate-time scatter with the Pareto front highlighted.
    (visualization.py:24)"""
    plt = _plt()
    pts = exploration.points
    f = np.array([float(p.fidelity) for p in pts])
    t = np.array([float(p.gate_time_us) for p in pts])
    front = exploration.compute_pareto_front()
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.scatter(t, 1 - f, s=8, alpha=0.4, label="evaluations")
    if front:
        ax.plot([p.gate_time_us for p in front],
                [1 - p.fidelity for p in front], "r.-", label="Pareto front")
    ax.set_xlabel("gate time [us]")
    ax.set_ylabel("infidelity")
    ax.set_yscale("log")
    ax.legend()
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def plot_pareto_comparison(explorations: Dict[str, object],
                           path: str = "pareto_comparison.png"):
    """Overlayed Pareto fronts per protocol. (visualization.py:138)"""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(6, 4))
    for name, ex in explorations.items():
        front = ex.compute_pareto_front()
        if front:
            ax.plot([p.gate_time_us for p in front],
                    [1 - p.fidelity for p in front], ".-", label=name)
    ax.set_xlabel("gate time [us]")
    ax.set_ylabel("infidelity")
    ax.set_yscale("log")
    ax.legend()
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def plot_parameter_heatmap(x_vals, y_vals, fidelity_grid,
                           x_label: str = "", y_label: str = "",
                           path: str = "heatmap.png"):
    """2D fidelity heatmap. (visualization.py:199)"""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(6, 4.5))
    im = ax.pcolormesh(_np(x_vals), _np(y_vals), _np(fidelity_grid),
                       shading="auto", cmap="viridis")
    fig.colorbar(im, ax=ax, label="fidelity")
    ax.set_xlabel(x_label)
    ax.set_ylabel(y_label)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def plot_noise_breakdown(noise_breakdown: Dict[str, float],
                         path: str = "noise_breakdown.png"):
    """Horizontal bar chart of gamma rates. (visualization.py:314)"""
    plt = _plt()
    keys = [k for k, v in noise_breakdown.items()
            if k.startswith("gamma") and isinstance(v, (int, float)) and v > 0]
    vals = [float(noise_breakdown[k]) for k in keys]
    order = np.argsort(vals)
    fig, ax = plt.subplots(figsize=(6, 0.4 * len(keys) + 1.5))
    ax.barh([keys[i] for i in order], [vals[i] for i in order])
    ax.set_xscale("log")
    ax.set_xlabel("rate [1/s]")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def plot_sweep_grid(results: Dict[str, Dict], path: str = "sweeps.png"):
    """Grid of fidelity-vs-parameter curves from sweep_results dicts."""
    plt = _plt()
    names = list(results)
    n = len(names)
    cols = 3
    rows = (n + cols - 1) // cols
    fig, axes = plt.subplots(rows, cols, figsize=(4 * cols, 2.8 * rows))
    axes = np.atleast_1d(axes).ravel()
    for ax, name in zip(axes, names):
        r = results[name]
        ax.plot(_np(r["values"]), _np(r["fidelity"]), ".-")
        ax.set_title(name, fontsize=9)
        ax.set_ylabel("F")
    for ax in axes[n:]:
        ax.axis("off")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def plot_logical_error_scaling(results: Dict[tuple, float],
                               path: str = "qec_scaling.png"):
    """p_logical vs p for each distance (threshold plot)."""
    plt = _plt()
    ds = sorted({d for d, _ in results})
    fig, ax = plt.subplots(figsize=(5.5, 4))
    for d in ds:
        ps = sorted(p for dd, p in results if dd == d)
        ax.loglog(ps, [float(results[(d, p)]) for p in ps], "o-",
                  label=f"d={d}")
    ax.set_xlabel("physical error rate p")
    ax.set_ylabel("logical error rate / round")
    ax.legend()
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def plot_surface_code_layout(layout, path: str = "layout.png"):
    """Data/ancilla layout of a rotated surface code
    (reference utils spec: 'layout plotting'; qec/surface_code.build_layout
    provides the coordinates)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(5, 5))
    dx = np.array(list(layout.data))            # coord -> index dicts
    ax.scatter(dx[:, 0], dx[:, 1], s=90, marker="o", c="k", label="data")
    for kind, color in (("x_anc", "tab:red"), ("z_anc", "tab:blue")):
        anc = getattr(layout, kind)
        if len(anc):
            a = np.asarray(list(anc))
            ax.scatter(a[:, 0], a[:, 1], s=60, marker="s", c=color,
                       label=kind.replace("_anc", "").upper() + " ancilla")
    ax.set_aspect("equal")
    ax.legend(fontsize=8)
    ax.set_title(f"rotated surface code d={layout.d}")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def plot_syndrome_history(detectors, d: int, rounds: int,
                          shot: int = 0, path: str = "syndrome.png"):
    """Detector firings of one shot as a (round x ancilla) raster
    (reference utils spec: 'syndrome plotting')."""
    plt = _plt()
    det = _np(detectors)[shot]
    n_anc = det.shape[0] // max(rounds + 1, 1)
    grid = det[: n_anc * (rounds + 1)].reshape(rounds + 1, n_anc)
    fig, ax = plt.subplots(figsize=(6, 3))
    ax.imshow(grid, aspect="auto", cmap="Reds", interpolation="nearest")
    ax.set_xlabel("ancilla index")
    ax.set_ylabel("round")
    ax.set_title(f"syndrome history, shot {shot} (d={d})")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


__all__ = ["plot_exploration_results", "plot_pareto_comparison",
           "plot_parameter_heatmap", "plot_noise_breakdown",
           "plot_sweep_grid", "plot_logical_error_scaling",
           "plot_surface_code_layout", "plot_syndrome_history"]
