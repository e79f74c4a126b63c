"""Circuit compiler: decompose -> map -> route -> schedule -> optimize.

Implements the reference's comment-only compiler spec
(reference: architecture/compiler/__init__.py:5-26, decomposition.py,
routing.py:5-23): native gate sets {Rz, Raman(R_xy), CZ} for neutral atoms
and {Rz, R_xy, MS} for ions; SWAP vs MOVE vs hybrid routing with cost
models; greedy qubit mapping.

Host Python, copied from the reference's `qec/compiler.py` unchanged.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .scheduler import Op, Scheduler, ScheduleResult
from .topology import Topology

NATIVE_SETS = {
    "neutral_atoms": {"rz", "rxy", "cz"},
    "trapped_ions": {"rz", "rxy", "ms"},
    # the cavity entangler is a photon-exchange (SWAP x CZ-class) gate;
    # CavityBackend derives cz exactly via a free software relabel +
    # virtual ZZ (primitives/cavity_backend.py), so "cz" is compiler-
    # native for this platform
    "cavity_qed": {"rz", "rxy", "cz"},
}


@dataclass
class Gate:
    """Abstract circuit gate (pre-compilation)."""
    name: str                      # h, x, y, z, s, t, rx, ry, rz, cx, cz, ms, swap
    qubits: Tuple[int, ...]
    angle: Optional[float] = None


@dataclass
class CompiledCircuit:
    ops: List[Op]
    mapping: Dict[int, int]        # logical -> physical
    n_swaps: int
    n_moves: int
    native_set: str
    schedule: Optional[ScheduleResult] = None

    def counts(self) -> Dict[str, int]:
        c: Dict[str, int] = {}
        for op in self.ops:
            c[op.name] = c.get(op.name, 0) + 1
        return c


# =============================================================================
# stage 1: decomposition to the native set (compiler/decomposition.py spec)
# =============================================================================

def decompose(gates: Sequence[Gate], platform: str = "neutral_atoms"
              ) -> List[Gate]:
    """Rewrite arbitrary gates into the platform-native set.

    Neutral atoms: single-qubit rotations become Rz/R_xy (Raman); CX becomes
    H-conjugated CZ; H = Rz(pi) R_y(pi/2) etc. Ions: CX/CZ -> MS + locals.
    """
    native = NATIVE_SETS[platform]
    out: List[Gate] = []

    def rxy(q, theta, phi):
        out.append(Gate("rxy", (q,), angle=theta))
        # phi is carried by the schedule of the Raman drive; encode as a
        # preceding virtual Rz for bookkeeping
        if phi:
            out.insert(len(out) - 1, Gate("rz", (q,), angle=phi))

    for g in gates:
        n = g.name.lower()
        if n in native:
            # normalize the stored name to lowercase so downstream duration
            # tables and scheduler op-class checks match ("CZ" == "cz")
            out.append(g if g.name == n else
                       Gate(n, g.qubits, angle=g.angle))
        elif n == "h":
            out.append(Gate("rz", g.qubits, angle=np.pi))
            rxy(g.qubits[0], np.pi / 2, np.pi / 2)
        elif n in ("x", "y"):
            rxy(g.qubits[0], np.pi, 0.0 if n == "x" else np.pi / 2)
        elif n == "z":
            out.append(Gate("rz", g.qubits, angle=np.pi))
        elif n == "s":
            out.append(Gate("rz", g.qubits, angle=np.pi / 2))
        elif n == "t":
            out.append(Gate("rz", g.qubits, angle=np.pi / 4))
        elif n in ("rx", "ry"):
            rxy(g.qubits[0], g.angle, 0.0 if n == "rx" else np.pi / 2)
        elif n in ("cx", "cnot"):
            t = g.qubits[1]
            if "cz" in native:
                out += decompose([Gate("h", (t,))], platform)
                out.append(Gate("cz", g.qubits))
                out += decompose([Gate("h", (t,))], platform)
            else:  # MS-based CX (standard identity up to locals)
                out += decompose([Gate("ry", (g.qubits[0],), angle=np.pi / 2)],
                                 platform)
                out.append(Gate("ms", g.qubits, angle=np.pi / 2))
                out += decompose([Gate("rx", (g.qubits[0],), angle=-np.pi / 2),
                                  Gate("rx", (t,), angle=-np.pi / 2),
                                  Gate("ry", (g.qubits[0],), angle=-np.pi / 2)],
                                 platform)
        elif n == "cz" and "cz" not in native:
            # CZ from MS: H on target, CX, H back
            out += decompose([Gate("cx", g.qubits)], platform)
        elif n == "swap":
            a, b = g.qubits
            out += decompose([Gate("cx", (a, b)), Gate("cx", (b, a)),
                              Gate("cx", (a, b))], platform)
        else:
            raise ValueError(f"Cannot decompose gate: {g.name}")
    return out


# =============================================================================
# stage 2: mapping (greedy locality)
# =============================================================================

def map_qubits(gates: Sequence[Gate], topology: Topology) -> Dict[int, int]:
    """Greedy placement: frequently-interacting logical pairs adjacent."""
    logical = sorted({q for g in gates for q in g.qubits})
    if len(logical) > topology.n_qubits:
        raise ValueError(f"{len(logical)} logical qubits do not fit on a "
                         f"{topology.n_qubits}-site topology")
    if logical and (min(logical) < 0):
        raise ValueError(f"negative qubit index: {min(logical)}")
    weight: Dict[Tuple[int, int], int] = {}
    for g in gates:
        if len(g.qubits) == 2:
            k = tuple(sorted(g.qubits))
            weight[k] = weight.get(k, 0) + 1
    order = sorted(logical, key=lambda q: -sum(
        w for k, w in weight.items() if q in k))
    free = list(range(topology.n_qubits))
    mapping: Dict[int, int] = {}
    for lq in order:
        if not mapping:
            mapping[lq] = free.pop(0)
            continue
        # place next to the already-placed partner with max weight
        best_partner, best_w = None, -1
        for k, w in weight.items():
            if lq in k:
                other = k[0] if k[1] == lq else k[1]
                if other in mapping and w > best_w:
                    best_partner, best_w = other, w
        if best_partner is None:
            mapping[lq] = free.pop(0)
            continue
        anchor = mapping[best_partner]
        free.sort(key=lambda p: topology.get_distance(anchor, p))
        mapping[lq] = free.pop(0)
    return mapping


# =============================================================================
# stage 3: routing (SWAP vs MOVE, routing.py:5-23 cost models)
# =============================================================================

@dataclass
class RoutingCosts:
    swap_time: float = 3 * 0.5e-6 * 2 + 3 * 0.35e-6   # 3 CX from primitives
    swap_error: float = 3 * 0.05
    move_time_per_m: float = 1e6 * 1e-6 / 100e-6       # ~ 10 us per um... see Move
    move_fixed_time: float = 20e-6
    move_error: float = 1e-3


def route(gates: Sequence[Gate], topology: Topology,
          mapping: Dict[int, int],
          costs: Optional[RoutingCosts] = None,
          strategy: str = "auto") -> Tuple[List[Gate], int, int, Dict[int, int]]:
    """Insert SWAPs or MOVEs so every two-qubit gate acts on an
    interactable pair. Emits gates on PHYSICAL qubit indices (the mapping
    evolves as swaps/moves execute). strategy: "swap" | "move" | "auto"
    (hybrid: MOVE on reconfigurable hardware when possible).

    Returns (physical gates, n_swaps, n_moves, final mapping)."""
    costs = costs or RoutingCosts()
    mapping = dict(mapping)
    out: List[Gate] = []
    n_swaps = n_moves = 0

    def phys(q):
        return mapping[q]

    for g in gates:
        if len(g.qubits) != 2:
            out.append(Gate(g.name, tuple(phys(q) for q in g.qubits), g.angle))
            continue
        a, b = g.qubits
        guard = 0
        while not topology.can_interact(phys(a), phys(b)):
            guard += 1
            if guard > topology.n_qubits:
                raise RuntimeError(f"routing failed for {g}")
            use_move = (strategy == "move"
                        or (strategy == "auto" and topology.reconfigurable))
            if use_move:
                target = phys(b)
                occupied = set(mapping.values())
                spot = next((sp for sp in topology.get_neighbors(target)
                             if sp not in occupied), None)
                if spot is not None:
                    out.append(Gate("move", (phys(a),), angle=float(spot)))
                    mapping[a] = spot
                    n_moves += 1
                    continue
            # SWAP one step along the shortest path
            path = topology.get_path(phys(a), phys(b))
            if len(path) < 3:
                break
            nxt = path[1]
            inv = {pq: lq for lq, pq in mapping.items()}
            if nxt in inv:
                out.append(Gate("swap", (phys(a), nxt)))
                mapping[inv[nxt]], mapping[a] = phys(a), nxt
                n_swaps += 1
            else:
                # empty site: relabel (a hidden move on atom hardware)
                out.append(Gate("move", (phys(a),), angle=float(nxt)))
                mapping[a] = nxt
                n_moves += 1
        out.append(Gate(g.name, (phys(a), phys(b)), g.angle))
    return out, n_swaps, n_moves, mapping


# =============================================================================
# stage 4+5: schedule + peephole optimize
# =============================================================================

_DURATIONS = {"rz": 0.0, "rxy": 0.5e-6, "cz": 0.35e-6, "ms": 30e-6,
              "swap": 3 * (0.35e-6 + 2 * 0.5e-6), "move": 30e-6,
              "measure": 10e-3, "cool": 2e-3}


def peephole_optimize(gates: Sequence[Gate]) -> List[Gate]:
    """Merge adjacent Rz on the same qubit; drop zero-angle rotations."""
    out: List[Gate] = []
    for g in gates:
        if (g.name == "rz" and out and out[-1].name == "rz"
                and out[-1].qubits == g.qubits):
            out[-1] = Gate("rz", g.qubits,
                           angle=(out[-1].angle or 0) + (g.angle or 0))
            continue
        out.append(g)
    return [g for g in out
            if not (g.name in ("rz", "rxy")
                    and abs((g.angle or 0.0) % (2 * np.pi)) < 1e-12)]


def compile_circuit(gates: Sequence[Gate], topology: Topology,
                    platform: str = "neutral_atoms",
                    routing_strategy: str = "auto",
                    schedule_strategy: str = "asap",
                    durations: Optional[Dict[str, float]] = None
                    ) -> CompiledCircuit:
    """Full 5-stage pipeline. (compiler/__init__.py:5-10)"""
    durations = {**_DURATIONS, **(durations or {})}
    native = decompose(gates, platform)
    mapping = map_qubits(native, topology)
    routed, n_swaps, n_moves, final_map = route(native, topology, mapping,
                                                strategy=routing_strategy)
    routed = peephole_optimize(routed)
    # SWAPs inserted by routing become native gates too (already physical)
    final: List[Gate] = []
    for g in routed:
        if g.name == "swap":
            final += decompose([g], platform)
        else:
            final.append(g)

    ops = [Op(g.name, g.qubits, durations.get(g.name, 1e-6)) for g in final]

    sched = Scheduler(topology).schedule(ops, strategy=schedule_strategy)
    return CompiledCircuit(ops=ops, mapping=mapping, n_swaps=n_swaps,
                           n_moves=n_moves, native_set=platform,
                           schedule=sched)


__all__ = ["Gate", "CompiledCircuit", "NATIVE_SETS", "decompose",
           "map_qubits", "route", "RoutingCosts", "peephole_optimize",
           "compile_circuit"]
