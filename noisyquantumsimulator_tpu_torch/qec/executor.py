"""Schedule executor: the reference's full simulation loop.

Implements the loop the reference's simulator stub describes
(reference: architecture/simulator.py:22-30 — "load schedule, apply
operations with errors, track syndromes, decode, report metrics"):
consume a CompiledCircuit from the compiler, price every scheduled
operation with the Layer-1 primitive error models (which themselves come
from the Layer-0 Lindblad calibration), inject the resulting Pauli
channels into a Circuit, and run it through the stochastic engine.

The executor performs errors-only frame Monte Carlo: gate unitaries act
as the ideal circuit (the frame tracks deviations), so arbitrary-angle
rz/rxy are supported — their CONTRIBUTION is their error channel, which
is exactly what architecture-level studies need. Full-unitary simulation
of small compiled circuits is available through
solver.circuit_sim.TrajectorySimulator on the same emitted Circuit when
the gate set is Clifford.

Counterpart of the reference's `qec/executor.py`. `compiled_to_error_circuit`
is copied (host Python). `execute` runs the frame Monte Carlo on `device`
with `pauli_frame._apply_channel` and a torch.Generator seeded from `seed`:
one small group of tensor ops per channel instruction, the instruction
targets and PAULI_CHANNEL_2 vectors copied to the device once before the
loop. Gates are ideal; MR clears the frames (and draws nothing).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from .circuits import Circuit


@dataclass
class ExecutionResult:
    """(simulator.py:28-30 'report metrics')"""
    shots: int
    n_ops: int
    total_time: float                    # schedule makespan [s]
    p_any_error: float                   # P(any residual Pauli on any qubit)
    per_qubit_flip_rate: np.ndarray      # (n,) X-or-Y rate at end
    per_qubit_phase_rate: np.ndarray     # (n,) Z-or-Y rate at end
    error_budget: Dict[str, float] = field(default_factory=dict)

    def summary(self) -> str:
        worst = int(np.argmax(self.per_qubit_flip_rate))
        return (f"ExecutionResult: {self.n_ops} ops, "
                f"T={self.total_time*1e6:.1f} us, "
                f"P(any error)={self.p_any_error:.4f}, worst qubit "
                f"{worst} flip={self.per_qubit_flip_rate[worst]:.4f}")


def compiled_to_error_circuit(compiled, backend=None,
                              cz_pauli_probs: Optional[np.ndarray] = None,
                              p1: Optional[float] = None,
                              p_meas: Optional[float] = None,
                              t1: float = 4.0, t2: float = 1.0) -> Circuit:
    """Emit the errors-only Circuit for a CompiledCircuit.

    Error sources per op (all overridable):
      rz     — virtual (frame rotation): error-free
      rxy    — depolarizing from the SingleQubitGate fidelity
      cz     — calibrated 16-entry Pauli channel (Layer-0 -> Layer-1)
      measure— record flip + reset
      idle   — T1/T2 Pauli rates over each qubit's idle windows
    """
    ms_pauli_probs = None
    if backend is not None:
        if cz_pauli_probs is None:
            cz = backend.cz()
            cz_pauli_probs = np.asarray(cz.pauli_error_probs)
        # platform-native MS channel (IonBackend): price "ms" ops with
        # the calibrated MS Pauli probs, not the derived-CZ ones
        if hasattr(backend, "ms"):
            ms_pauli_probs = np.asarray(backend.ms().pauli_error_probs)
        if p1 is None:
            sq = backend.rx(0, np.pi / 2)
            p1 = max(0.0, 1.0 - sq.fidelity)
        if p_meas is None:
            p_meas = max(0.0, 1.0 - backend.measure().fidelity)
        t1, t2 = backend.T1, backend.T2
    cz_pauli_probs = (np.asarray(cz_pauli_probs) if cz_pauli_probs
                      is not None else None)
    p1 = 1e-4 if p1 is None else p1
    p_meas = 2e-3 if p_meas is None else p_meas

    n = 1 + max((max(op.qubits) for op in compiled.ops
                 if op.qubits), default=0)
    c = Circuit(n_qubits=n)
    for op in compiled.ops:
        name = op.name.lower()
        if name == "rz":
            continue                     # virtual
        if name in ("rxy", "rx", "ry", "sq"):
            c.append("DEPOLARIZE1", list(op.qubits), arg=p1)
        elif name in ("cz", "cx", "ms"):
            pair = np.asarray([list(op.qubits)], dtype=np.int32)
            probs2 = (ms_pauli_probs if (name == "ms"
                                         and ms_pauli_probs is not None)
                      else cz_pauli_probs)
            if probs2 is not None:
                c.append("PAULI_CHANNEL_2", pair, probs=probs2)
            else:
                c.append("DEPOLARIZE2", pair, arg=10 * p1)
        elif name in ("m", "measure", "mr", "readout"):
            c.append("MR", list(op.qubits), arg=p_meas)
        elif name in ("move", "cool", "i", "idle"):
            pass                         # captured by idle windows below

    # idle-window dephasing from the schedule
    # (lazy import: channels/__init__ reaches gate.simulate via tomography,
    # which would cycle back through solver -> qec at import time)
    from ..channels.pauli import t1_t2_to_pauli_rates
    if compiled.schedule is not None:
        for q, idle_s in compiled.schedule.idle_time_per_qubit.items():
            if idle_s <= 0 or q >= n:
                continue
            px, py, pz = t1_t2_to_pauli_rates(t1, t2, idle_s)
            c.append("X_ERROR", [q], arg=px + py)
            c.append("Z_ERROR", [q], arg=pz + py)
    return c


_FRAME_CHANNELS = ("X_ERROR", "Z_ERROR", "DEPOLARIZE1", "DEPOLARIZE2",
                   "PAULI_CHANNEL_2", "ERASE")


def _frame_program(circuit: Circuit, dev: torch.device):
    """The channel and MR instructions of `circuit` as (name, targets, p,
    probs) with targets and PAULI_CHANNEL_2 vectors already on `dev`: all
    targets cross in one copy, each distinct probability vector once."""
    kept = [ins for ins in circuit.instructions
            if ins.name in _FRAME_CHANNELS or ins.name == "MR"]
    flat = [np.asarray(ins.targets, np.int64).ravel() for ins in kept]
    every = torch.as_tensor(np.concatenate(flat) if flat
                            else np.zeros(0, np.int64), device=dev)
    vectors: Dict[bytes, torch.Tensor] = {}
    program = []
    start = 0
    for ins, f in zip(kept, flat):
        t = every[start:start + len(f)].view(np.asarray(ins.targets).shape)
        start += len(f)
        probs = None
        if ins.probs is not None:
            key = np.asarray(ins.probs, np.float64).tobytes()
            if key not in vectors:
                vectors[key] = torch.as_tensor(
                    np.asarray(ins.probs, np.float32), device=dev)
            probs = vectors[key]
        program.append((ins.name, t, ins.arg or 0.0, probs))
    return program


def execute(compiled, backend=None, shots: int = 10000, seed: int = 0,
            device: Union[str, torch.device] = "cuda",
            **noise_kw) -> ExecutionResult:
    """Run the full loop: schedule -> error circuit -> frame MC on `device`
    -> metrics."""
    from .pauli_frame import _apply_channel

    circuit = compiled_to_error_circuit(compiled, backend, **noise_kw)
    n = circuit.n_qubits
    dev = torch.device(device)
    program = _frame_program(circuit, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    # errors-only frame Monte Carlo (no records needed): evolve x/z frames
    # through the channel instructions; gates are ideal
    x = torch.zeros((shots, n), dtype=torch.uint8, device=dev)
    z = torch.zeros((shots, n), dtype=torch.uint8, device=dev)
    for name, t, p, probs in program:
        if name == "MR":
            x[:, t] = 0
            z[:, t] = 0
        else:
            x, z = _apply_channel(name, gen, x, z, t, p, probs, shots)

    any_err = int((x | z).any(dim=1).sum())
    flips = x.sum(dim=0, dtype=torch.int64).cpu().numpy()
    phases = z.sum(dim=0, dtype=torch.int64).cpu().numpy()
    total_time = (compiled.schedule.total_time
                  if compiled.schedule is not None else 0.0)
    budget: Dict[str, float] = {}
    for op in compiled.ops:
        budget[op.name] = budget.get(op.name, 0.0) + 1.0
    return ExecutionResult(
        shots=shots, n_ops=len(compiled.ops), total_time=total_time,
        p_any_error=any_err / shots,
        per_qubit_flip_rate=flips / shots,
        per_qubit_phase_rate=phases / shots,
        error_budget=budget)


__all__ = ["ExecutionResult", "compiled_to_error_circuit", "execute"]
