"""Inverse problem: hardware parameters for target fidelity / gate time.

Counterpart of the reference's `optimize/inverse.py`, the rebuild of the
original inverse optimizer (rydberg_gates/optimization.py:91-1016
`optimize_CZ_parameters`, `explore_parameter_space`,
ExplorationResult/EvaluatedPoint/Pareto front).

The 8-dimensional hardware space (optimization.py:826-831):
    [P2, P1, T, spacing_factor, n_rydberg, P_tweezer, w_tweezer, linewidth]

Every DE evaluation is one host plan and one `simulate_cz_gate` call on the
device (`device`, complex `dtype`), serially: each hardware point changes
every Liouvillian, so nothing batches across members. The DE itself is
host numpy on `default_rng(seed)`, the same stream as the reference's, so
at complex128 both packages take the same decisions. Points are cached in
an ExplorationResult with post-hoc Pareto extraction.
"""
from __future__ import annotations

import pickle
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.configs import (LPSimulationInputs, SmoothJPSimulationInputs,
                            JPSimulationInputs)
from ..gate.simulate import simulate_cz_gate
from .apparatus import ApparatusConstraints
from .cost import extract_metrics

HARDWARE_PARAM_NAMES = ["laser_2_power", "laser_1_power", "temperature",
                        "spacing_factor", "n_rydberg", "tweezer_power",
                        "tweezer_waist", "linewidth_hz"]

DEFAULT_HARDWARE_BOUNDS = [
    (0.05, 2.0),        # P2 [W]
    (10e-6, 500e-6),    # P1 [W]
    (1e-6, 50e-6),      # T [K]
    (2.5, 5.0),         # spacing_factor
    (50, 90),           # n_rydberg
    (5e-3, 60e-3),      # tweezer power [W]
    (0.6e-6, 1.5e-6),   # tweezer waist [m]
    (10.0, 10e3),       # linewidth [Hz]
]


@dataclass
class EvaluatedPoint:
    """(optimization.py:130-149)"""
    params: np.ndarray
    fidelity: float
    gate_time_us: float
    metrics: Dict[str, float] = field(default_factory=dict)


@dataclass
class HardwareOptimizationResult:
    """(optimization.py:91-129)"""
    success: bool
    best_params: np.ndarray
    param_names: List[str]
    best_fidelity: float
    best_gate_time_us: float
    n_evaluations: int
    runtime_s: float
    target_fidelity: float = 0.999


@dataclass
class ExplorationResult:
    """Point store with Pareto extraction. (optimization.py:151-278)"""
    protocol: str
    points: List[EvaluatedPoint] = field(default_factory=list)
    runtime_seconds: float = 0.0
    param_names: List[str] = field(default_factory=lambda: list(HARDWARE_PARAM_NAMES))

    def add(self, point: EvaluatedPoint):
        self.points.append(point)

    def compute_pareto_front(self) -> List[EvaluatedPoint]:
        """Non-dominated points: maximize fidelity, minimize gate time.
        (optimization.py:174-207)"""
        pts = self.points
        front = []
        for p in pts:
            dominated = any(
                (q.fidelity >= p.fidelity and q.gate_time_us <= p.gate_time_us
                 and (q.fidelity > p.fidelity or q.gate_time_us < p.gate_time_us))
                for q in pts)
            if not dominated:
                front.append(p)
        return sorted(front, key=lambda p: p.gate_time_us)

    def get_best_for_target(self, target_fidelity: float
                            ) -> Optional[EvaluatedPoint]:
        """Fastest point meeting the fidelity target. (optimization.py:208)"""
        ok = [p for p in self.points if p.fidelity >= target_fidelity]
        if not ok:
            return None
        return min(ok, key=lambda p: p.gate_time_us)

    def save(self, path: str):
        with open(path, "wb") as f:
            pickle.dump(self, f)

    @staticmethod
    def load(path: str) -> "ExplorationResult":
        with open(path, "rb") as f:
            return pickle.load(f)


def combine_explorations(*results: ExplorationResult) -> ExplorationResult:
    """(optimization.py:983-1016)"""
    out = ExplorationResult(protocol=results[0].protocol if results else "")
    for r in results:
        out.points.extend(r.points)
        out.runtime_seconds += r.runtime_seconds
    return out


def _apparatus_from_vector(x: np.ndarray,
                           base: ApparatusConstraints) -> ApparatusConstraints:
    kw = dict(base.__dict__)
    kw.update(laser_2_power=float(x[0]), laser_1_power=float(x[1]),
              temperature=float(x[2]), spacing_factor=float(x[3]),
              n_rydberg=int(round(float(x[4]))),
              tweezer_power=float(x[5]), tweezer_waist=float(x[6]),
              laser_1_linewidth_hz=float(x[7]),
              laser_2_linewidth_hz=float(x[7]))
    return ApparatusConstraints(**kw)


_INPUTS = {"lp": LPSimulationInputs, "levine_pichler": LPSimulationInputs,
           "smooth_jp": SmoothJPSimulationInputs,
           "jp": JPSimulationInputs, "jandura_pupillo": JPSimulationInputs}


def _evaluate_hardware(x: np.ndarray, protocol: str,
                       base: ApparatusConstraints,
                       include_noise: bool, device="cuda",
                       dtype: torch.dtype = torch.complex128) -> EvaluatedPoint:
    import warnings
    app = _apparatus_from_vector(x, base)
    cls = _INPUTS[protocol.lower()]
    si = cls(excitation=app.make_excitation_config(),
             noise=(app.make_full_noise() if include_noise
                    else app.make_noiseless()))
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            r = simulate_cz_gate(si, device=device, dtype=dtype,
                                 include_noise=include_noise,
                                 **app.sim_kwargs())
        m = extract_metrics(r)
        # a copy: x may be a row of the DE population, which selection
        # overwrites in place
        return EvaluatedPoint(params=np.array(x, float),
                              fidelity=float(m["avg_fidelity"]),
                              gate_time_us=float(m["gate_time_us"]),
                              metrics=m)
    except (ValueError, FloatingPointError):
        return EvaluatedPoint(params=np.array(x, float), fidelity=0.0,
                              gate_time_us=1e9, metrics={})


def optimize_cz_parameters(
    protocol: str = "smooth_jp",
    target_fidelity: float = 0.999,
    base_apparatus: Optional[ApparatusConstraints] = None,
    bounds: Optional[list] = None,
    include_noise: bool = True,
    maxiter: int = 30,
    popsize: int = 10,
    seed: int = 0,
    time_weight: float = 0.05,
    store: Optional[ExplorationResult] = None,
    device="cuda",
    dtype: torch.dtype = torch.complex128,
) -> HardwareOptimizationResult:
    """Search the 8-dim hardware space for the fastest gate at the target
    fidelity. (optimization.py:280-745)"""
    base = base_apparatus or ApparatusConstraints()
    bounds = bounds or DEFAULT_HARDWARE_BOUNDS
    rng = np.random.default_rng(seed)
    lo = np.array([b[0] for b in bounds])
    hi = np.array([b[1] for b in bounds])
    P = popsize
    pop = lo + rng.random((P, len(bounds))) * (hi - lo)

    def cost_of(pt: EvaluatedPoint) -> float:
        # constraint-penalty form (optimization.py:467-520): quadratic
        # shortfall below target + weak time pressure
        shortfall = max(0.0, target_fidelity - pt.fidelity)
        return 1e4 * shortfall ** 2 + time_weight * pt.gate_time_us

    t0 = time.time()
    evals = 0
    pts = [_evaluate_hardware(x, protocol, base, include_noise, device, dtype)
           for x in pop]
    evals += P
    if store is not None:
        for p in pts:
            store.add(p)
    costs = np.array([cost_of(p) for p in pts])

    for _ in range(maxiter):
        for i in range(P):
            idx = rng.choice(P, 3, replace=False)
            F = rng.uniform(0.5, 1.0)
            mutant = np.clip(pop[idx[0]] + F * (pop[idx[1]] - pop[idx[2]]),
                             lo, hi)
            cross = rng.random(len(bounds)) < 0.7
            cross[rng.integers(len(bounds))] = True
            trial = np.where(cross, mutant, pop[i])
            pt = _evaluate_hardware(trial, protocol, base, include_noise,
                                    device, dtype)
            evals += 1
            if store is not None:
                store.add(pt)
            c = cost_of(pt)
            if c < costs[i]:
                pop[i], costs[i], pts[i] = trial, c, pt

    ib = int(np.argmin(costs))
    best = pts[ib]
    return HardwareOptimizationResult(
        success=best.fidelity >= target_fidelity,
        best_params=pop[ib], param_names=list(HARDWARE_PARAM_NAMES),
        best_fidelity=best.fidelity, best_gate_time_us=best.gate_time_us,
        n_evaluations=evals, runtime_s=time.time() - t0,
        target_fidelity=target_fidelity)


def explore_parameter_space(
    protocol: str = "smooth_jp",
    n_runs: int = 3,
    maxiter: int = 30,
    popsize: int = 10,
    bounds: Optional[list] = None,
    include_noise: bool = True,
    base_apparatus: Optional[ApparatusConstraints] = None,
    seeds: Optional[Sequence[int]] = None,
    device="cuda",
    dtype: torch.dtype = torch.complex128,
) -> ExplorationResult:
    """Multi-seed exploration caching every DE evaluation, Pareto front
    post-hoc. (optimization.py:746-982)"""
    store = ExplorationResult(protocol=protocol)
    t0 = time.time()
    seeds = list(seeds) if seeds is not None else list(range(n_runs))
    for s in seeds:
        optimize_cz_parameters(protocol=protocol, bounds=bounds,
                               include_noise=include_noise,
                               base_apparatus=base_apparatus,
                               maxiter=maxiter, popsize=popsize, seed=s,
                               store=store, device=device, dtype=dtype)
    store.runtime_seconds = time.time() - t0
    return store


__all__ = ["HARDWARE_PARAM_NAMES", "DEFAULT_HARDWARE_BOUNDS",
           "EvaluatedPoint", "HardwareOptimizationResult",
           "ExplorationResult", "combine_explorations",
           "optimize_cz_parameters", "explore_parameter_space"]
