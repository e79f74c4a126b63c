"""Topology manager: qubit layout and connectivity.

Implements the reference's comment-only topology spec
(reference: architecture/topology.py:5-25 — "2D grid / arbitrary graph /
zone-based / reconfigurable; get_neighbors, get_distance, can_interact,
get_path"). Design change vs the plan: no NetworkX — adjacency lives in
dense numpy arrays (distance matrices precomputed once), so topology
queries are O(1) lookups and can be shipped to device as arrays when the
scheduler needs them.

Host numpy, copied from the reference's `qec/topology.py` unchanged.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclass
class Topology:
    """Base: positions + connectivity via an interaction radius."""
    positions: np.ndarray                 # (n, 2) [m]
    interaction_radius: float             # [m]
    reconfigurable: bool = False
    zones: Optional[np.ndarray] = None    # (n,) zone id per qubit

    def __post_init__(self):
        self.positions = np.asarray(self.positions, dtype=float)
        d = self.positions[:, None, :] - self.positions[None, :, :]
        self._dist = np.sqrt((d ** 2).sum(-1))
        self._adj = (self._dist <= self.interaction_radius) & ~np.eye(
            len(self.positions), dtype=bool)
        # hop distances (BFS via boolean matrix powers)
        n = len(self.positions)
        hops = np.full((n, n), np.inf)
        np.fill_diagonal(hops, 0)
        reach = np.eye(n, dtype=bool)
        frontier = np.eye(n, dtype=bool)
        for k in range(1, n):
            frontier = (frontier @ self._adj) & ~reach
            if not frontier.any():
                break
            hops[frontier] = np.minimum(hops[frontier], k)
            reach |= frontier
        self._hops = hops

    @property
    def n_qubits(self) -> int:
        return len(self.positions)

    def get_neighbors(self, qubit_id: int) -> List[int]:
        return np.nonzero(self._adj[qubit_id])[0].tolist()

    def get_distance(self, q1: int, q2: int) -> float:
        """Physical distance [m]."""
        return float(self._dist[q1, q2])

    def get_hop_distance(self, q1: int, q2: int) -> float:
        return float(self._hops[q1, q2])

    def can_interact(self, q1: int, q2: int) -> bool:
        return bool(self._adj[q1, q2])

    def get_path(self, q1: int, q2: int) -> List[int]:
        """Shortest hop path (BFS)."""
        if q1 == q2:
            return [q1]
        prev = {q1: None}
        frontier = [q1]
        while frontier:
            nxt = []
            for u in frontier:
                for v in self.get_neighbors(u):
                    if v not in prev:
                        prev[v] = u
                        if v == q2:
                            path = [v]
                            while prev[path[-1]] is not None:
                                path.append(prev[path[-1]])
                            return path[::-1]
                        nxt.append(v)
            frontier = nxt
        return []

    def blockade_conflicts(self, pairs: Sequence[Tuple[int, int]],
                           blockade_radius: float) -> List[Tuple[int, int]]:
        """Pairs of *gate pairs* that cannot run simultaneously because some
        qubit of one sits within the blockade radius of the other
        (scheduler constraint, scheduler.py:12)."""
        conflicts = []
        for i in range(len(pairs)):
            for j in range(i + 1, len(pairs)):
                qs_i, qs_j = pairs[i], pairs[j]
                if any(self._dist[a, b] <= blockade_radius
                       for a in qs_i for b in qs_j):
                    conflicts.append((i, j))
        return conflicts


def grid_topology(rows: int, cols: int, spacing: float = 3e-6,
                  diagonal: bool = False) -> Topology:
    """2D grid (surface-code compatible). (topology.py:6)"""
    pos = np.array([(c * spacing, r * spacing)
                    for r in range(rows) for c in range(cols)])
    radius = spacing * (1.5 if diagonal else 1.1)
    return Topology(pos, radius)


def graph_topology(positions: Sequence[Tuple[float, float]],
                   edges: Sequence[Tuple[int, int]]) -> Topology:
    """Arbitrary-graph connectivity: adjacency overrides the radius rule."""
    t = Topology(np.asarray(positions, dtype=float), interaction_radius=0.0)
    n = t.n_qubits
    adj = np.zeros((n, n), dtype=bool)
    for a, b in edges:
        adj[a, b] = adj[b, a] = True
    t._adj = adj
    # recompute hops
    hops = np.full((n, n), np.inf)
    np.fill_diagonal(hops, 0)
    reach = np.eye(n, dtype=bool)
    frontier = np.eye(n, dtype=bool)
    for k in range(1, n):
        frontier = (frontier @ adj) & ~reach
        if not frontier.any():
            break
        hops[frontier] = np.minimum(hops[frontier], k)
        reach |= frontier
    t._hops = hops
    return t


def zoned_topology(zone_sizes: Sequence[int], zone_spacing: float = 20e-6,
                   spacing: float = 3e-6) -> Topology:
    """Zone-based layout (storage / entangling / readout zones — the QCCD
    and neutral-atom zoned architectures). (topology.py:8)"""
    pos, zones = [], []
    x0 = 0.0
    for z, size in enumerate(zone_sizes):
        for i in range(size):
            pos.append((x0 + i * spacing, 0.0))
            zones.append(z)
        x0 += size * spacing + zone_spacing
    t = Topology(np.asarray(pos), interaction_radius=spacing * 1.1,
                 zones=np.asarray(zones))
    return t


def reconfigurable_topology(rows: int, cols: int, spacing: float = 3e-6
                            ) -> Topology:
    """Neutral-atom AOD-reconfigurable array: any pair can interact after a
    Move, so can_interact is distance-based but `reconfigurable` marks that
    the compiler may route with MOVE instead of SWAP. (topology.py:9)"""
    t = grid_topology(rows, cols, spacing)
    t.reconfigurable = True
    return t


__all__ = ["Topology", "grid_topology", "graph_topology", "zoned_topology",
           "reconfigurable_topology"]
