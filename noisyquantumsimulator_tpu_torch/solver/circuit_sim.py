"""Exact circuit-level simulators: density-matrix CPTP and trajectories.

Implements the remaining two of the reference's four planned simulation
modes (reference: architecture/simulator.py:5-30 — "Stim Clifford,
state-vector, density-matrix (CPTP application), Monte-Carlo error
sampling"; the Clifford/Pauli-frame modes live in qec/pauli_frame.py and
qec/fast_sampler.py). Both engines consume the SAME Circuit IR as the
stabilizer samplers, so any small circuit can be cross-validated exactly.

DensityMatrixSimulator — exact CPTP evolution of rho (2^n x 2^n):
    unitaries as contractions on the target-axis reshape of rho, one leg
    at a time; noise channels applied in Pauli-mixture form. n <= 12.

TrajectorySimulator — batched state-vector Monte Carlo:
    every trajectory holds a (2^n,) state; Pauli channels sample a branch
    per trajectory, measurements sample outcomes (Born rule). The whole
    batch of trajectories evolves together. n <= 14.

Counterpart of the reference's `solver/circuit_sim.py`, in torch on
`device` (the card by default), complex64 as the reference. States are
(T, 2^n) complex batches; a gate is a batched product over the target-axis
reshape. Branches and Born outcomes are drawn from a torch.Generator on the
device where the reference splits jax.random keys: the two agree in
distribution, not bit for bit. The instruction loop runs eagerly, one small
op group per instruction.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Union

import numpy as np
import torch

from typing import TYPE_CHECKING

if TYPE_CHECKING:  # Circuit is only an annotation; a runtime import would
    from ..qec.circuits import Circuit  # cycle solver -> qec -> executor

_H = np.array([[1, 1], [1, -1]], dtype=np.complex64) / np.sqrt(2)
_S = np.diag([1, 1j]).astype(np.complex64)
_X = np.array([[0, 1], [1, 0]], dtype=np.complex64)
_Y = np.array([[0, -1j], [1j, 0]], dtype=np.complex64)
_Z = np.diag([1, -1]).astype(np.complex64)
_I = np.eye(2, dtype=np.complex64)
_CX = np.eye(4, dtype=np.complex64)[[0, 1, 3, 2]]
_CZ = np.diag([1, 1, 1, -1]).astype(np.complex64)
_SWAP = np.eye(4, dtype=np.complex64)[[0, 2, 1, 3]]

_GATES1 = {"H": _H, "S": _S, "X": _X, "Y": _Y, "Z": _Z, "I": _I}
_GATES2 = {"CX": _CX, "CZ": _CZ, "SWAP": _SWAP}
_PAULI1 = (_I, _X, _Y, _Z)


def _apply_1q(psi, U, q, n):
    """psi (..., 2^n); apply U on qubit q (qubit 0 = most significant)."""
    shape = psi.shape
    psi = psi.reshape(shape[:-1] + (1 << q, 2, 1 << (n - q - 1)))
    psi = torch.einsum("ab,...bk->...ak", U, psi)
    return psi.reshape(shape)


def _apply_2q(psi, U, qa, qb, n):
    if qa > qb:
        # reorder via U conjugated by SWAP on its own indices
        U = U.reshape(2, 2, 2, 2).permute(1, 0, 3, 2).reshape(4, 4)
        qa, qb = qb, qa
    shape = psi.shape
    psi = psi.reshape(shape[:-1] + (1 << qa, 2, 1 << (qb - qa - 1), 2,
                                    1 << (n - qb - 1)))
    U4 = U.reshape(2, 2, 2, 2)
    psi = torch.einsum("acbd,...bjdk->...ajck", U4, psi)
    return psi.reshape(shape)


def _on(dev):
    """The gate matrices as complex64 tensors on `dev` (numpy makes _H
    complex128: it divides by a float64 square root)."""
    def t(m):
        return torch.as_tensor(m, dtype=torch.complex64, device=dev)
    return ({k: t(v) for k, v in _GATES1.items()},
            {k: t(v) for k, v in _GATES2.items()},
            tuple(t(m) for m in _PAULI1))


class DensityMatrixSimulator:
    """Exact CPTP density-matrix evolution of a Circuit (n <= 12) on
    `device`.

    run() -> {"rho": (2^n, 2^n) complex64, "measurement_probs": (n_meas,)
    float32 per-M marginal p(1)}, tensors on the device. Measurements are
    treated as dephasing + recorded marginals (the exact ensemble view); R
    projects to |0>."""

    def __init__(self, circuit: 'Circuit',
                 device: Union[str, torch.device] = "cuda"):
        self.circuit = circuit
        self.n = circuit.n_qubits
        self.device = torch.device(device)
        if self.n > 12:
            raise ValueError(f"density-matrix sim limited to 12 qubits, "
                             f"got {self.n}")

    def run(self) -> Dict:
        n = self.n
        dim = 1 << n
        dev = self.device
        gates1, gates2, paulis = _on(dev)
        rho = torch.zeros((dim, dim), dtype=torch.complex64, device=dev)
        rho[0, 0] = 1.0

        # U rho U^dag as two leg contractions: U on the ket leg (rho's
        # columns), then U^* on the bra leg (its rows)
        def L1(rho, U, q):
            rho = _apply_1q(rho.mT, U, q, n).mT                 # U rho
            return _apply_1q(rho, U.conj(), q, n)               # ... U^dag

        def L2(rho, U, qa, qb):
            rho = _apply_2q(rho.mT, U, qa, qb, n).mT
            return _apply_2q(rho, U.conj(), qa, qb, n)

        def pauli_mix1(rho, q, probs4):
            out = probs4[0] * rho
            for k in (1, 2, 3):
                out = out + probs4[k] * L1(rho, paulis[k], q)
            return out

        bits = {}

        def bit_of(q):
            if q not in bits:
                bits[q] = ((torch.arange(dim, device=dev) >> (n - q - 1))
                           & 1).to(torch.float32)
            return bits[q]

        def z1_probs(rho, q):
            """p(measure 1) on qubit q from the diagonal."""
            return torch.sum(torch.diagonal(rho).real * bit_of(q))

        P0 = torch.as_tensor(np.diag([1, 0]).astype(np.complex64), device=dev)
        P1 = torch.as_tensor(np.diag([0, 1]).astype(np.complex64), device=dev)

        def project_reset(rho, q):
            """Measure-and-reset to |0> (trace out the outcome)."""
            r0 = L1(rho, P0, q)
            r1 = L1(rho, P1, q)
            return r0 + L1(r1, paulis[1], q)   # outcome-1 branch flipped to |0>

        meas_probs: List = []
        for ins in self.circuit.instructions:
            name, t = ins.name, ins.targets
            p = ins.arg or 0.0
            if name in gates1:
                for q in np.atleast_1d(t):
                    rho = L1(rho, gates1[name], int(q))
            elif name in gates2:
                for qa, qb in t:
                    rho = L2(rho, gates2[name], int(qa), int(qb))
            elif name == "X_ERROR" and p > 0:
                for q in np.atleast_1d(t):
                    rho = pauli_mix1(rho, int(q), [1 - p, p, 0, 0])
            elif name == "Z_ERROR" and p > 0:
                for q in np.atleast_1d(t):
                    rho = pauli_mix1(rho, int(q), [1 - p, 0, 0, p])
            elif name == "DEPOLARIZE1" and p > 0:
                for q in np.atleast_1d(t):
                    rho = pauli_mix1(rho, int(q), [1 - p, p / 3, p / 3,
                                                   p / 3])
            elif name in ("DEPOLARIZE2", "PAULI_CHANNEL_2"):
                if name == "DEPOLARIZE2":
                    probs = np.full(16, p / 15.0)
                    probs[0] = 1 - p
                else:
                    probs = np.asarray(ins.probs, dtype=np.float64)
                if probs[1:].sum() <= 0:
                    continue
                for qa, qb in t:
                    acc = float(probs[0]) * rho
                    for idx in range(1, 16):
                        if probs[idx] <= 0:
                            continue
                        pa, pb = idx // 4, idx % 4
                        r = rho
                        if pa:
                            r = L1(r, paulis[pa], int(qa))
                        if pb:
                            r = L1(r, paulis[pb], int(qb))
                        acc = acc + float(probs[idx]) * r
                    rho = acc
            elif name in ("M", "MR"):
                for q in np.atleast_1d(t):
                    pm = z1_probs(rho, int(q))
                    if p > 0:   # classical flip noise on the record
                        pm = pm * (1 - p) + (1 - pm) * p
                    meas_probs.append(pm)
                    # dephase in Z (measurement backaction on the ensemble)
                    rho = 0.5 * (rho + L1(rho, paulis[3], int(q)))
                if name == "MR":
                    for q in np.atleast_1d(t):
                        rho = project_reset(rho, int(q))
            elif name == "R":
                for q in np.atleast_1d(t):
                    rho = project_reset(rho, int(q))
            elif name == "ERASE" and p > 0:
                for q in np.atleast_1d(t):
                    rho = pauli_mix1(rho, int(q), [1 - 3 * p / 4, p / 4,
                                                   p / 4, p / 4])
        return {"rho": rho,
                "measurement_probs": torch.stack(meas_probs)
                if meas_probs else torch.zeros((0,), device=dev)}


class TrajectorySimulator:
    """Batched state-vector Monte Carlo over a Circuit on `device`.

    sample(generator) -> {"measurements": (T, n_meas) uint8} on the device
    — per-trajectory sampled records, directly comparable with the
    Pauli-frame samplers. `generator` is a torch.Generator on the device
    (default: one seeded with 0)."""

    def __init__(self, circuit: 'Circuit', trajectories: int = 1024,
                 device: Union[str, torch.device] = "cuda"):
        self.circuit = circuit
        self.n = circuit.n_qubits
        self.T = trajectories
        self.device = torch.device(device)
        if self.n > 14:
            raise ValueError("trajectory sim limited to 14 qubits")
        self._fn = self._build()

    def _build(self):
        n, dim, T = self.n, 1 << self.n, self.T
        dev = self.device
        instructions = list(self.circuit.instructions)
        gates1, gates2, paulis = _on(dev)
        X = paulis[1]
        bits = {}

        def bit_of(q):
            if q not in bits:
                bits[q] = (torch.arange(dim, device=dev) >> (n - q - 1)) & 1
            return bits[q]

        def sample(gen):
            def uniform(*shape):
                return torch.rand(shape, generator=gen, device=dev)

            psi = torch.zeros((T, dim), dtype=torch.complex64, device=dev)
            psi[:, 0] = 1.0
            records = []

            def sample_z(psi, q):
                b = bit_of(q)[None, :]
                p1 = torch.sum(psi.abs() ** 2 * b, dim=1)
                m = (uniform(T) < p1).to(torch.uint8)
                psi = psi * (b == m[:, None])
                norm = torch.sqrt(torch.sum(psi.abs() ** 2, dim=1,
                                            keepdim=True))
                return psi / torch.clamp(norm, min=1e-30), m

            def apply_pauli_sampled(psi, q, kinds):
                """kinds: (T,) 0..3 -> apply I/X/Y/Z per trajectory."""
                b = bit_of(q)[None, :]
                flip = (kinds == 1) | (kinds == 2)
                phase = (kinds == 2) | (kinds == 3)
                # X part: swap amplitudes along axis q
                psi_x = _apply_1q(psi, X, q, n)
                psi = torch.where(flip[:, None], psi_x, psi)
                # Z part: phase on |1> component (Y = iXZ up to global phase)
                zsign = torch.where(b == 1, -1.0, 1.0)
                psi = torch.where(phase[:, None], psi * zsign, psi)
                return psi

            for ins in instructions:
                name, t = ins.name, ins.targets
                p = ins.arg or 0.0
                if name in gates1:
                    for q in np.atleast_1d(t):
                        psi = _apply_1q(psi, gates1[name], int(q), n)
                elif name in gates2:
                    for qa, qb in t:
                        psi = _apply_2q(psi, gates2[name], int(qa), int(qb),
                                        n)
                elif name in ("X_ERROR", "Z_ERROR") and p > 0:
                    kind = 1 if name == "X_ERROR" else 3
                    for q in np.atleast_1d(t):
                        hit = uniform(T) < p
                        psi = apply_pauli_sampled(
                            psi, int(q), torch.where(hit, kind, 0))
                elif name == "DEPOLARIZE1" and p > 0:
                    for q in np.atleast_1d(t):
                        u = uniform(T)
                        kinds = torch.clamp(
                            torch.floor(u / (p / 3.0)).to(torch.int32) + 1,
                            0, 3)
                        kinds = torch.where(u < p, kinds, 0)
                        psi = apply_pauli_sampled(psi, int(q), kinds)
                elif name in ("DEPOLARIZE2", "PAULI_CHANNEL_2") and (
                        name == "PAULI_CHANNEL_2" or p > 0):
                    if name == "DEPOLARIZE2":
                        cum = np.cumsum(np.full(15, p / 15.0))
                    else:
                        cum = np.cumsum(np.asarray(ins.probs)[1:])
                        if cum[-1] <= 0:
                            continue
                    cumt = torch.as_tensor(cum, dtype=torch.float32,
                                           device=dev)
                    for qa, qb in t:
                        u = uniform(T, 1)
                        idx = torch.sum((u >= cumt[None, :]).to(torch.int32),
                                        dim=1)
                        idx = torch.where(u[:, 0] < cumt[-1], idx + 1, 0)
                        psi = apply_pauli_sampled(psi, int(qa), idx // 4)
                        psi = apply_pauli_sampled(psi, int(qb), idx % 4)
                elif name in ("M", "MR"):
                    for q in np.atleast_1d(t):
                        psi, m = sample_z(psi, int(q))
                        if p > 0:
                            m = m ^ (uniform(T) < p).to(torch.uint8)
                        records.append(m)
                    if name == "MR":
                        for q in np.atleast_1d(t):
                            # reset: flip |1> outcomes back to |0>
                            b1 = torch.sum(psi.abs() ** 2
                                           * bit_of(int(q))[None, :], dim=1)
                            need = (b1 > 0.5).to(torch.int32)
                            psi = apply_pauli_sampled(psi, int(q), need)
                elif name == "R":
                    for q in np.atleast_1d(t):
                        psi, m = sample_z(psi, int(q))
                        psi = apply_pauli_sampled(psi, int(q),
                                                  m.to(torch.int32))
                elif name == "ERASE" and p > 0:
                    for q in np.atleast_1d(t):
                        u = uniform(T)
                        kinds = torch.clamp(
                            torch.floor(u / (p / 4.0)).to(torch.int32), 0, 3)
                        kinds = torch.where(u < 3 * p / 4, kinds + 1, 0)
                        psi = apply_pauli_sampled(psi, int(q),
                                                  torch.clamp(kinds, max=3))

            meas = (torch.stack(records, dim=1) if records
                    else torch.zeros((T, 0), dtype=torch.uint8, device=dev))
            return {"measurements": meas}

        return sample

    def sample(self, generator: Optional[torch.Generator] = None):
        if generator is None:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(0)
        return self._fn(generator)


__all__ = ["DensityMatrixSimulator", "TrajectorySimulator"]
