"""Differential evolution with whole-population device evaluation.

Counterpart of the reference's `optimize/de.py`. The original drives
scipy.optimize.differential_evolution with a serial Python objective
(optimize_cz_gate.py:1052-1114, maxiter=80, popsize=15 -> ~1200 sequential
gate sims). Here each generation is ONE batched call of the objective
(engine.make_population_objective), on the card; the proposal and the
selection are tiny updates of a (P, D) array and stay on the host, in CPU
tensors, drawn from an explicit torch.Generator made from `seed`.

Strategy: rand1bin (the scipy default), with best-member elitism.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import numpy as np
import torch



@dataclass
class DEResult:
    x: np.ndarray
    fun: float
    nfev: int
    nit: int
    history: np.ndarray  # best cost per generation
    population: np.ndarray
    energies: np.ndarray


def _de_propose(gen: torch.Generator, pop, lower, upper, mutation,
                recombination):
    """rand/1/bin trial population from `pop` (P, D), float64 CPU tensors.
    Separate from the cost so host-side cost functions — e.g. per-member
    spacing re-planning — can evaluate between propose and select."""
    P, D = pop.shape
    # rand/1: x_r1 + F (x_r2 - x_r3), three distinct random members per row
    # (the first three of a random permutation)
    idx = torch.rand((P, P), generator=gen).argsort(dim=1)[:, :3]
    r1, r2, r3 = pop[idx[:, 0]], pop[idx[:, 1]], pop[idx[:, 2]]
    F = mutation[0] + (mutation[1] - mutation[0]) * torch.rand(
        (P, 1), generator=gen, dtype=pop.dtype)
    mutant = torch.clamp(r1 + F * (r2 - r3), min=lower, max=upper)

    # binomial crossover with guaranteed one mutated coordinate
    cross = torch.rand((P, D), generator=gen) < recombination
    force = torch.nn.functional.one_hot(
        torch.randint(0, D, (P,), generator=gen), D).bool()
    return torch.where(cross | force, mutant, pop)


def _de_select(pop, energies, trial, trial_E):
    """Greedy selection: a trial replaces its parent when strictly better."""
    accept = trial_E < energies
    return (torch.where(accept[:, None], trial, pop),
            torch.where(accept, trial_E, energies))


def _energies(cost_fn, pop) -> torch.Tensor:
    """(P,) float64 CPU energies of a population (the one host sync of a
    generation)."""
    E, _ = cost_fn(pop.numpy())
    E = E.detach().cpu() if torch.is_tensor(E) else torch.as_tensor(np.asarray(E))
    return E.to(torch.float64)


def differential_evolution(
    cost_fn: Callable,           # (P, D) -> ((P,), aux)
    bounds,
    x0: Optional[np.ndarray] = None,
    popsize: int = 15,
    maxiter: int = 80,
    mutation: Tuple[float, float] = (0.5, 1.0),
    recombination: float = 0.7,
    tol: float = 0.0,
    seed: int = 42,
    init_population: Optional[np.ndarray] = None,
) -> DEResult:
    """Minimize cost_fn over box bounds. cost_fn takes the whole population
    as a (P, D) float64 numpy array and returns its (P,) costs (a tensor on
    any device, or an array) and anything else; it runs between propose and
    select, so host-side costs (per-member spacing re-planning) need no
    separate code path."""
    bounds = np.asarray(bounds, dtype=float)
    lower = torch.from_numpy(bounds[:, 0].copy())
    upper = torch.from_numpy(bounds[:, 1].copy())
    D = bounds.shape[0]
    P = max(popsize, 4)

    gen = torch.Generator()
    gen.manual_seed(int(seed))
    if init_population is not None:
        pop = torch.as_tensor(np.asarray(init_population, dtype=float))
        P = pop.shape[0]
    else:
        u = torch.rand((P, D), generator=gen, dtype=torch.float64)
        pop = lower + u * (upper - lower)
        if x0 is not None:
            pop[0] = torch.clamp(torch.as_tensor(np.asarray(x0, dtype=float)),
                                 min=lower, max=upper)

    energies = _energies(cost_fn, pop)

    history = []
    nfev = P
    for it in range(maxiter):
        trial = _de_propose(gen, pop, lower, upper, mutation, recombination)
        pop, energies = _de_select(pop, energies, trial,
                                   _energies(cost_fn, trial))
        nfev += P
        history.append(float(energies.min()))
        if tol > 0 and it > 5:
            spread = float(energies.std(unbiased=False))
            if spread <= tol * abs(float(energies.mean()) + 1e-12):
                break

    energies_np = energies.numpy()
    pop_np = pop.numpy()
    ib = int(np.argmin(energies_np))
    return DEResult(x=pop_np[ib], fun=float(energies_np[ib]), nfev=nfev,
                    nit=len(history), history=np.asarray(history),
                    population=pop_np, energies=energies_np)


__all__ = ["differential_evolution", "DEResult"]
