"""Movement-based non-local check scheduling for qLDPC codes.

Rebuild of the reference's ldpc spec item "movement-based non-local
checks" (reference: architecture/qec/ldpc_codes.py:5-23, comment-only):
bivariate-bicycle checks are long-range, and on a reconfigurable
neutral-atom array they are measured by SHUTTLING each check ancilla to
its (non-local) support qubits — the constant-overhead scheme of
reconfigurable-array QEC proposals.

The planner is host-side (this is compilation, not simulation): it places
data qubits on a grid and check ancillas in an interleaved lattice, tours
every ancilla through its support with minimum-jerk moves, groups tour
legs into parallel move waves (ancillas whose targets collide within the
blockade radius are serialized), and prices the whole extraction cycle
with the Layer-1 motion/gate models. Output feeds run_bb_memory-style
studies with a physically-derived syndrome cycle time and idle-error
budget instead of an assumed one.

Host numpy, copied from the reference's `qec/ldpc_layout.py` unchanged.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..physics.transport import simulate_transport


@dataclass
class ExtractionPlan:
    n_data: int
    n_checks: int
    n_legs: int                    # total (move, CZ) legs
    n_waves: int                   # parallel move waves
    cycle_time: float              # [s] full syndrome-extraction cycle
    total_move_distance: float     # [m] summed over all ancillas
    max_tour_distance: float       # [m] longest single-ancilla tour
    mean_parallelism: float        # legs per wave
    heating_quanta_per_move: float
    idle_error_budget: float       # T2-limited dephasing per data qubit

    def summary(self) -> str:
        return (f"ExtractionPlan: {self.n_checks} checks over "
                f"{self.n_data} data qubits, {self.n_legs} legs in "
                f"{self.n_waves} waves, cycle = {self.cycle_time*1e6:.0f} us"
                f", parallelism = {self.mean_parallelism:.1f}, "
                f"idle error/qubit = {self.idle_error_budget:.2e}")


def _grid_positions(n: int, spacing: float, y0: float = 0.0) -> np.ndarray:
    cols = int(np.ceil(np.sqrt(n)))
    return np.array([( (i % cols) * spacing, y0 + (i // cols) * spacing)
                     for i in range(n)])


def plan_bb_extraction(
    H: np.ndarray,
    spacing: float = 6e-6,
    blockade_radius: float = 4e-6,
    move_speed_budget: float = 100e-6,     # duration per unit-cell move [s/50um]
    cz_time: float = 0.3e-6,
    T2: float = 1.0,
    trap_frequency: float = 2 * np.pi * 50e3,
    temperature: float = 10e-6,
) -> ExtractionPlan:
    """Schedule one syndrome-extraction cycle for check matrix H
    ((n_checks, n_data), e.g. Hz of a BB code).

    Every check ancilla tours its support in nearest-neighbour order;
    legs are grouped into waves by greedy conflict colouring (two legs
    conflict when their target data sites are within the blockade radius,
    or the same data qubit is touched twice in a wave).
    """
    H = np.asarray(H) % 2
    n_checks, n_data = H.shape
    data_pos = _grid_positions(n_data, spacing)
    anc_pos = _grid_positions(n_checks, spacing,
                              y0=data_pos[:, 1].max() + 2 * spacing)

    # per-ancilla tours: nearest-neighbour ordering of the support
    tours: List[List[int]] = []
    for c in range(n_checks):
        support = list(np.nonzero(H[c])[0])
        tour, cur = [], anc_pos[c]
        remaining = support[:]
        while remaining:
            dists = [np.linalg.norm(data_pos[q] - cur) for q in remaining]
            q = remaining.pop(int(np.argmin(dists)))
            tour.append(q)
            cur = data_pos[q]
        tours.append(tour)

    max_legs = max(len(t) for t in tours)
    n_legs = sum(len(t) for t in tours)

    # wave scheduling: leg k of every ancilla wants to fire together;
    # colour conflicts (blockade or shared data qubit) greedily
    n_waves = 0
    wave_times: List[float] = []
    total_move = np.zeros(n_checks)
    for k in range(max_legs):
        active = [c for c in range(n_checks) if len(tours[c]) > k]
        groups: List[List[int]] = []
        for c in active:
            placed = False
            for g in groups:
                tq = tours[c][k]
                ok = all(
                    tours[o][k] != tq
                    and np.linalg.norm(data_pos[tours[o][k]]
                                       - data_pos[tq]) > blockade_radius
                    for o in g)
                if ok:
                    g.append(c)
                    placed = True
                    break
            if not placed:
                groups.append([c])
        for g in groups:
            # wave duration = longest move in the group + CZ
            dmax = 0.0
            for c in g:
                src = anc_pos[c] if k == 0 else data_pos[tours[c][k - 1]]
                dist = float(np.linalg.norm(data_pos[tours[c][k]] - src))
                total_move[c] += dist
                dmax = max(dmax, dist)
            wave_times.append(move_speed_budget * (dmax / 50e-6) + cz_time)
        n_waves += len(groups)

    cycle_time = float(sum(wave_times))
    tr = simulate_transport(distance=float(total_move.max()),
                            duration=max(cycle_time, 1e-6),
                            omega=trap_frequency, temperature=temperature)
    idle_error = 1.0 - np.exp(-cycle_time / T2)
    return ExtractionPlan(
        n_data=n_data, n_checks=n_checks, n_legs=n_legs, n_waves=n_waves,
        cycle_time=cycle_time,
        total_move_distance=float(total_move.sum()),
        max_tour_distance=float(total_move.max()),
        mean_parallelism=n_legs / max(n_waves, 1),
        heating_quanta_per_move=tr.energy_gain_quanta,
        idle_error_budget=float(idle_error))


def bb_extraction_study(l: int = 6, m: int = 6) -> Dict:
    """Movement budget for the [[2lm, ...]] BB code (both check types)."""
    from .ldpc import bb_code, css_n_k
    Hx, Hz = bb_code(l, m, (3, 1, 2), (3, 1, 2))
    n, k = css_n_k(Hx, Hz)
    px = plan_bb_extraction(Hx)
    pz = plan_bb_extraction(Hz)
    return {
        "code": f"[[{n},{k}]]",
        "x_plan": px, "z_plan": pz,
        "cycle_time_us": (px.cycle_time + pz.cycle_time) * 1e6,
        "idle_error_per_cycle": px.idle_error_budget + pz.idle_error_budget,
    }


__all__ = ["ExtractionPlan", "plan_bb_extraction", "bb_extraction_study"]
