# Frozen copy of the port's host code (noisyquantumsimulator_tpu_torch/qec/dem.py), kept so that the
# benchmark's reference rebuilds the BB memory experiment from its configuration
# file without importing the program. Only the imports were changed, and what the
# reference never reaches was left out.
"""Detector error model (DEM): elementary errors -> detector signatures.

Host numpy, copied from the reference's `qec/dem.py` unchanged.

The reference planned "detector error models" as part of its Stim-based
engine (reference: architecture/simulator.py:8, comment-only). Here the DEM
is built by *deterministic frame propagation*: every elementary fault
(each Pauli outcome of every noise channel instance) is injected into one
"shot" of a batched frame propagation, so the whole model is a single
vectorized pass — no per-fault re-simulation.

Output: list of (probability, detector index tuple, observable mask) plus
the decomposed edge list used by matching-style decoders.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

from .circuits import Circuit, detector_matrix, observable_matrix


@dataclass
class ErrorMechanism:
    probability: float
    detectors: Tuple[int, ...]
    observables: int          # bitmask over observables
    location: Tuple[int, int, int]  # (instruction idx, target idx, pauli idx)


@dataclass
class DetectorErrorModel:
    n_detectors: int
    n_observables: int
    mechanisms: List[ErrorMechanism] = field(default_factory=list)

    def merged(self) -> "DetectorErrorModel":
        """Merge mechanisms with identical (detectors, observables):
        p = p1(1-p2) + p2(1-p1)."""
        acc: Dict[Tuple, float] = {}
        for m in self.mechanisms:
            key = (m.detectors, m.observables)
            p0 = acc.get(key, 0.0)
            acc[key] = p0 * (1 - m.probability) + m.probability * (1 - p0)
        out = DetectorErrorModel(self.n_detectors, self.n_observables)
        out.mechanisms = [ErrorMechanism(p, k[0], k[1], (-1, -1, -1))
                          for k, p in acc.items() if p > 0]
        return out


def _propagate_faults(circuit: Circuit, faults) -> Tuple[np.ndarray, np.ndarray]:
    """faults: list of (instr_idx, xflips dict qubit->1, zflips dict).
    Returns (measurement records (n_faults, n_meas), det matrix applied)."""
    n_f = len(faults)
    n = circuit.n_qubits
    x = np.zeros((n_f, n), dtype=np.uint8)
    z = np.zeros((n_f, n), dtype=np.uint8)
    # index faults by instruction position for injection
    by_instr: Dict[int, List[int]] = {}
    for fi, (ii, _, _) in enumerate(faults):
        by_instr.setdefault(ii, []).append(fi)

    records = []
    for ii, ins in enumerate(circuit.instructions):
        name, t = ins.name, ins.targets
        if name in ("H",):
            xt, zt = x[:, t].copy(), z[:, t].copy()
            x[:, t], z[:, t] = zt, xt
        elif name == "S":
            z[:, t] ^= x[:, t]
        elif name in ("X", "Z", "Y", "I"):
            pass
        elif name == "CX":
            c_, t_ = t[:, 0], t[:, 1]
            x[:, t_] ^= x[:, c_]
            z[:, c_] ^= z[:, t_]
        elif name == "CZ":
            c_, t_ = t[:, 0], t[:, 1]
            z[:, t_] ^= x[:, c_]
            z[:, c_] ^= x[:, t_]
        elif name == "SWAP":
            a, b = t[:, 0], t[:, 1]
            x[:, a], x[:, b] = x[:, b].copy(), x[:, a].copy()
            z[:, a], z[:, b] = z[:, b].copy(), z[:, a].copy()
        elif name in ("M", "MR"):
            records.append(x[:, t].copy())
            if name == "MR":
                x[:, t] = 0
                z[:, t] = 0
        elif name == "R":
            x[:, t] = 0
            z[:, t] = 0
        # channels contribute nothing deterministically

        # inject faults attached AFTER this instruction
        for fi in by_instr.get(ii, ()):
            _, xf, zf = faults[fi]
            for q, v in xf.items():
                x[fi, q] ^= v
            for q, v in zf.items():
                z[fi, q] ^= v

    meas = (np.concatenate(records, axis=1) if records
            else np.zeros((n_f, 0), dtype=np.uint8))
    return meas


_P1 = {1: ({0: 1}, {}), 2: ({0: 1}, {0: 1}), 3: ({}, {0: 1})}  # X, Y, Z


def _enumerate_faults(circuit: Circuit):
    """All elementary faults: (probs, locs, record-signature matrix)."""
    faults = []
    probs = []
    locs = []
    for ii, ins in enumerate(circuit.instructions):
        name, t, p = ins.name, ins.targets, (ins.arg or 0.0)
        if name == "X_ERROR" and p > 0:
            for k, q in enumerate(np.atleast_1d(t)):
                faults.append((ii, {int(q): 1}, {}))
                probs.append(p)
                locs.append((ii, k, 1))
        elif name == "Z_ERROR" and p > 0:
            for k, q in enumerate(np.atleast_1d(t)):
                faults.append((ii, {}, {int(q): 1}))
                probs.append(p)
                locs.append((ii, k, 3))
        elif name == "DEPOLARIZE1" and p > 0:
            for k, q in enumerate(np.atleast_1d(t)):
                for pi in (1, 2, 3):
                    xf, zf = _P1[pi]
                    faults.append((ii, {int(q): v for v in xf.values()} if xf else {},
                                   {int(q): v for v in zf.values()} if zf else {}))
                    probs.append(p / 3.0)
                    locs.append((ii, k, pi))
        elif name == "DEPOLARIZE2" and p > 0:
            for k, (qa, qb) in enumerate(t):
                for idx in range(1, 16):
                    pa, pb = idx // 4, idx % 4
                    xf, zf = {}, {}
                    if pa in (1, 2):
                        xf[int(qa)] = 1
                    if pa in (2, 3):
                        zf[int(qa)] = 1
                    if pb in (1, 2):
                        xf[int(qb)] = 1
                    if pb in (2, 3):
                        zf[int(qb)] = 1
                    faults.append((ii, xf, zf))
                    probs.append(p / 15.0)
                    locs.append((ii, k, idx))
        elif name == "PAULI_CHANNEL_2":
            for k, (qa, qb) in enumerate(t):
                for idx in range(1, 16):
                    pp = float(ins.probs[idx])
                    if pp <= 0:
                        continue
                    pa, pb = idx // 4, idx % 4
                    xf, zf = {}, {}
                    if pa in (1, 2):
                        xf[int(qa)] = 1
                    if pa in (2, 3):
                        zf[int(qa)] = 1
                    if pb in (1, 2):
                        xf[int(qb)] = 1
                    if pb in (2, 3):
                        zf[int(qb)] = 1
                    faults.append((ii, xf, zf))
                    probs.append(pp)
                    locs.append((ii, k, idx))
        elif name in ("M", "MR") and p > 0:
            # classical measurement flips: model as a fault flipping only
            # that record — inject an X just before the measurement
            for k, q in enumerate(np.atleast_1d(t)):
                faults.append((ii - 0.5, {int(q): 1}, {}))  # see below
                probs.append(p)
                locs.append((ii, k, 4))
        elif name == "ERASE" and p > 0:
            for k, q in enumerate(np.atleast_1d(t)):
                for pi in (1, 2, 3):
                    faults.append((ii, dict([(int(q), 1)]) if pi in (1, 2) else {},
                                   dict([(int(q), 1)]) if pi in (2, 3) else {}))
                    probs.append(p * (1 / 4 if pi != 2 else 1 / 4))
                    locs.append((ii, k, pi))

    # measurement-flip faults need injection BEFORE their instruction:
    # convert (ii - 0.5) markers by attaching to previous instruction and
    # also flipping back after; simplest exact approach: give them their own
    # propagation with a one-shot record flip.
    clean_faults = []
    meas_flip_records: List[Tuple[int, int]] = []  # (fault row, record idx)
    meas_counter = 0
    rec_index_of_instr: Dict[int, int] = {}
    mc = 0
    for ii, ins in enumerate(circuit.instructions):
        if ins.name in ("M", "MR"):
            rec_index_of_instr[ii] = mc
            mc += len(ins.targets)

    rows_meas = []
    for f, pr, lc in zip(faults, probs, locs):
        if isinstance(f[0], float):  # measurement flip marker
            ii = int(f[0] + 0.5)
            k = lc[1]
            rows_meas.append((len(clean_faults), rec_index_of_instr[ii] + k,
                              pr, lc))
            clean_faults.append((ii, {}, {}))  # no Pauli propagation
        else:
            clean_faults.append(f)

    meas = _propagate_faults(circuit, clean_faults)
    for row, rec, pr, lc in rows_meas:
        meas[row, rec] ^= 1
    return probs, locs, meas


def build_dem(circuit: Circuit) -> DetectorErrorModel:
    """Enumerate every elementary fault of every channel instruction."""
    probs, locs, meas = _enumerate_faults(circuit)

    Dmat = detector_matrix(circuit)
    Omat = observable_matrix(circuit)
    dets = (meas.astype(np.int32) @ Dmat.T.astype(np.int32)) % 2
    obs = (meas.astype(np.int32) @ Omat.T.astype(np.int32)) % 2

    dem = DetectorErrorModel(circuit.n_detectors,
                             max(circuit.observables.keys(), default=-1) + 1)
    for i, (pr, lc) in enumerate(zip(probs, locs)):
        dsig = tuple(np.nonzero(dets[i])[0].tolist())
        omask = int(sum(1 << k for k in np.nonzero(obs[i])[0]))
        if not dsig and not omask:
            continue
        dem.mechanisms.append(ErrorMechanism(pr, dsig, omask, lc))
    return dem
