"""Lattice surgery: fault-tolerant Z (x) Z measurement by rough merge/split.

Counterpart of the reference's `qec/lattice_surgery.py`. The circuit build
(the merged subsystem layout, the merge -> split -> post-split circuit, and
the readout solved over GF(2) from the circuit's exact record-response
matrix, weighted by fault probability) is host numpy, copied: its
instructions, detectors, observables and `zz_records` are bit-identical to
the reference's.

Protocol (rough merge of two distance-d rotated patches):
  1. Patches occupy data columns 0..d-1 and d+1..2d; the seam is column d,
     prepared in |+> (reset + H).
  2. During the merge the code is momentarily a SUBSYSTEM code: the 2-body
     boundary X-checks that straddle the seam at the top/bottom are not
     measured (they anticommute with Z_L1 Z_L2). All other merged
     stabilizers are measured for `rounds_merge` rounds; the bridging
     Z-checks' first-round outcomes are individually random.
  3. Split: the seam data qubits are measured in Z. The surgery outcome
     z1 z2 is the product of the bridging first-round outcomes and the seam
     split reads.
  4. The two patches then run `rounds_after` normal rounds and are read out
     transversally.

`run_zz_surgery` samples with the port's one-matmul fast sampler on the
device (a torch.Generator seeded from `seed`) and decodes with the native
C++ exact matcher (`decoder_for_circuit(kind="native")`). When that library
cannot be built it raises: the port never switches to the greedy matcher
behind the caller's back (the reference does, on RuntimeError or OSError).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Union

import numpy as np

import torch

from .circuits import Circuit
from .dem import _propagate_faults, fault_record_signatures
from .surface_code import SurfaceCodeLayout, build_rect_layout


def _gf2_solve(A: np.ndarray, b: np.ndarray):
    """One solution x of A x = b over GF(2), or None."""
    A = A.copy() % 2
    b = b.copy() % 2
    m, n = A.shape
    piv_col_of_row = []
    r = 0
    for col in range(n):
        rows = np.nonzero(A[r:, col])[0]
        if not len(rows):
            continue
        pr = r + rows[0]
        A[[r, pr]] = A[[pr, r]]
        b[[r, pr]] = b[[pr, r]]
        for i in range(m):
            if i != r and A[i, col]:
                A[i] ^= A[r]
                b[i] ^= b[r]
        piv_col_of_row.append(col)
        r += 1
        if r == m:
            break
    if np.any(b[r:]):
        return None
    x = np.zeros(n, dtype=np.uint8)
    for row, col in enumerate(piv_col_of_row):
        x[col] = b[row]
    return x


def _gf2_nullspace(A: np.ndarray) -> np.ndarray:
    """Basis of {x : A x = 0} over GF(2); rows are basis vectors."""
    A = A.copy() % 2
    m, n = A.shape
    piv = []
    r = 0
    for col in range(n):
        rows = np.nonzero(A[r:, col])[0]
        if not len(rows):
            continue
        pr = r + rows[0]
        A[[r, pr]] = A[[pr, r]]
        for i in range(m):
            if i != r and A[i, col]:
                A[i] ^= A[r]
        piv.append(col)
        r += 1
        if r == m:
            break
    free = [c for c in range(n) if c not in piv]
    basis = np.zeros((len(free), n), dtype=np.uint8)
    for k, fc in enumerate(free):
        basis[k, fc] = 1
        for row, pc in enumerate(piv):
            if A[row, fc]:
                basis[k, pc] = 1
    return basis


def merged_layout(d: int) -> SurfaceCodeLayout:
    """The rough-merge subsystem layout: (2d+1) x d rectangle with the
    seam-straddling 2-body boundary X-checks removed."""
    lay0 = build_rect_layout(2 * d + 1, d)
    drop = {cc for cc in lay0.x_anc
            if cc[0] in (2 * d, 2 * d + 2) and cc[1] in (0, 2 * d)}
    idx = len(lay0.data)
    z_anc, x_anc = {}, {}
    for cc in sorted(lay0.z_anc):
        z_anc[cc] = idx
        idx += 1
    for cc in sorted(lay0.x_anc):
        if cc not in drop:
            x_anc[cc] = idx
            idx += 1
    return SurfaceCodeLayout(d=d, data=lay0.data, x_anc=x_anc, z_anc=z_anc,
                             w=lay0.w, h=lay0.h)


# CX dance orders (same hook-error-avoiding zig-zag as surface_code.py)
_X_ORDER = [(1, 1), (1, -1), (-1, 1), (-1, -1)]
_Z_ORDER = [(1, 1), (-1, 1), (1, -1), (-1, -1)]


@dataclass
class SurgeryCircuit:
    circuit: Circuit
    d: int
    rounds_merge: int
    rounds_after: int
    layout: SurfaceCodeLayout
    zz_records: List[int]          # absolute record indices of the readout
    n_records: int

    def zz_lookbacks(self) -> List[int]:
        return [r - self.n_records for r in self.zz_records]


def _stabilizer_cycle(c: Circuit, lay: SurfaceCodeLayout, zset, xset,
                      p: float, p_meas: float):
    """One round: prep, 4-step CX dance, MR of (Z then X) ancillas."""
    z_ids = [lay.z_anc[a] for a in zset]
    x_ids = [lay.x_anc[a] for a in xset]
    if p > 0:
        c.append("X_ERROR", z_ids + x_ids, arg=p)
    c.append("H", x_ids)
    if p > 0:
        c.append("DEPOLARIZE1", x_ids, arg=p)
    for step in range(4):
        pairs = []
        for a in xset:
            dx, dy = _X_ORDER[step]
            tgt = (a[0] + dx, a[1] + dy)
            if tgt in lay.data:
                pairs.append((lay.x_anc[a], lay.data[tgt]))
        for a in zset:
            dx, dy = _Z_ORDER[step]
            src = (a[0] + dx, a[1] + dy)
            if src in lay.data:
                pairs.append((lay.data[src], lay.z_anc[a]))
        if pairs:
            flat = np.asarray(pairs, dtype=np.int32)
            c.append("CX", flat)
            if p > 0:
                c.append("DEPOLARIZE2", flat, arg=p)
    c.append("H", x_ids)
    if p > 0:
        c.append("DEPOLARIZE1", x_ids, arg=p)
    c.append("MR", z_ids + x_ids, arg=p_meas)


def zz_merge_split_circuit(d: int, rounds_merge: int = 0,
                           rounds_after: int = 0, p: float = 1e-3,
                           p_meas: Optional[float] = None) -> SurgeryCircuit:
    """Full merge -> split -> post-split memory circuit.

    Observables: 0 = Z_L of patch 1, 1 = Z_L of patch 2, 2 = the ZZ
    surgery outcome. With |00> preparation all three read +1 at p = 0.
    """
    if d < 3 or d % 2 == 0:
        raise ValueError(
            f"lattice surgery needs odd patch distance d >= 3, got {d} "
            "(the (2d+1) x d merged rectangle's boundary checkerboard "
            "only aligns with both patches for odd d)")
    rounds_merge = rounds_merge or d
    rounds_after = rounds_after or d
    p_meas = p if p_meas is None else p_meas
    lay = merged_layout(d)
    seam_cols = {d}
    seam_coords = [(2 * d + 1, 2 * j + 1) for j in range(d)]
    seam_ids = [lay.data[cc] for cc in seam_coords]
    zanc = sorted(lay.z_anc)
    xanc = sorted(lay.x_anc)
    bridge = [a for a in zanc if a[0] in (2 * d, 2 * d + 2)]
    # patch-only stabilizers (used after the split): everything whose
    # support avoids the seam column entirely
    def touches_seam(a):
        return any((a[0] + dx, a[1] + dy) in lay.data
                   and (a[0] + dx) == 2 * d + 1
                   for dx in (-1, 1) for dy in (-1, 1))
    z_patch = [a for a in zanc if not touches_seam(a)]
    x_patch = [a for a in xanc if not touches_seam(a)]

    c = Circuit(n_qubits=lay.n_qubits)
    n_anc = len(zanc) + len(xanc)
    n_z = len(zanc)

    # seam |+> preparation
    c.append("R", seam_ids)
    c.append("H", seam_ids)
    if p > 0:
        c.append("DEPOLARIZE1", seam_ids, arg=p)

    # absolute record indexing: `rec` counts records emitted so far;
    # detectors take lookbacks = absolute - records_at_emission_time
    rec = 0
    rec_r1_z = {}                    # zanc coord -> abs record (round 1)
    last_z = {}                      # zanc coord -> abs record (latest)
    skip_r1 = {zanc.index(a) for a in bridge}
    for r in range(rounds_merge):
        _stabilizer_cycle(c, lay, zanc, xanc, p, p_meas)
        prev = dict(last_z)
        for k, a in enumerate(zanc):
            last_z[a] = rec + k
            if r == 0:
                rec_r1_z[a] = rec + k
        rec += n_anc
        for k, a in enumerate(zanc):
            if r == 0:
                if k not in skip_r1:
                    c.detector([last_z[a] - rec])
            else:
                c.detector([last_z[a] - rec, prev[a] - rec])

    # split: measure the seam data qubits in Z
    c.append("M", seam_ids, arg=p_meas)
    seam_rec = {cc: rec + i for i, cc in enumerate(seam_coords)}
    rec += len(seam_ids)

    # post-split rounds on the two patches (patch-only stabilizers)
    n_anc2 = len(z_patch) + len(x_patch)
    for r in range(rounds_after):
        _stabilizer_cycle(c, lay, z_patch, x_patch, p, p_meas)
        prev = dict(last_z)
        for k, a in enumerate(z_patch):
            last_z[a] = rec + k
        rec += n_anc2
        for a in z_patch:
            # r == 0 compares against the same check's last merge round
            c.detector([last_z[a] - rec, prev[a] - rec])

    # final transversal Z measurement of all data
    data_coords = sorted(lay.data)
    data_idx = [lay.data[cc] for cc in data_coords]
    c.append("M", data_idx, arg=p_meas)
    n_data = len(data_idx)
    final_rec = {cc: rec + i for i, cc in enumerate(data_coords)}
    rec += n_data

    # boundary detectors: each patch Z stabilizer vs its data qubits
    for a in z_patch:
        recs = [last_z[a] - rec]
        for dx, dy in ((1, 1), (1, -1), (-1, 1), (-1, -1)):
            cc = (a[0] + dx, a[1] + dy)
            if cc in lay.data:
                recs.append(final_rec[cc] - rec)
        c.detector(recs)

    # ---- solve for all three logical observables and verify ---------------
    # Mid-surgery, the raw patch rows are NOT gauge-invariant (bridging
    # X-plaquette outcomes are teleportation byproducts that must correct
    # the logical frames). Rather than hand-deriving the byproduct rules,
    # solve for record sets with the exact required response:
    #   gauge bits (every R/MR)      -> 0
    #   X_L1 deformation (any col)   -> 1 for obs0/obs2, 0 for obs1
    #   X_L2 deformation (any col)   -> 1 for obs1/obs2, 0 for obs0
    faults = []
    n_gauge = 0
    for ii, ins in enumerate(c.instructions):
        if ins.name in ("R", "MR"):
            for q in np.atleast_1d(ins.targets):
                faults.append((ii, {}, {int(q): 1}))
                n_gauge += 1
    cols1, cols2 = list(range(d)), list(range(d + 1, 2 * d + 1))
    for i in cols1 + cols2:
        col = [lay.data[(2 * i + 1, 2 * j + 1)] for j in range(d)]
        faults.append((0, dict.fromkeys(col, 1), {}))
    M = _propagate_faults(c, faults).astype(np.uint8)
    flip1 = [n_gauge + k for k in range(d)]
    flip2 = [n_gauge + d + k for k in range(d)]

    # candidates: round-1 Z records, X-ancilla byproduct records, seam
    # split reads, final transversal reads. Prefer the sparser candidate
    # set (last merge round's X records only) — fewer records in the
    # readout means a lower raw (undecoded) error rate.
    def x_round(r):
        return [r * n_anc + n_z + k for k in range(len(xanc))]
    base = ([rec_r1_z[a] for a in zanc]
            + [seam_rec[cc] for cc in seam_coords]
            + [final_rec[cc] for cc in data_coords])
    cand_sets = [base + x_round(rounds_merge - 1),
                 base + sum((x_round(r) for r in range(rounds_merge)), [])]

    # fault-probability weighting for representative selection: among all
    # equivalent readouts (differing by nullspace vectors of the constraint
    # system), pick the one flipped by the LEAST total fault probability —
    # that is the raw-error-minimizing AND decoder-friendliest choice.
    # The reference's greedy coordinate descent, with the fault signatures
    # computed once and each candidate's flip parities F (x ^ b) taken as
    # (F x) ^ (F b) from one product of F with the whole basis: the same
    # parity vectors, the same costs, the same choices.
    fp, fsig = fault_record_signatures(c)

    def solve_obs(want1: int, want2: int) -> List[int]:
        rhs = np.asarray([0] * n_gauge + [want1] * d + [want2] * d,
                         np.uint8)
        for cand in cand_sets:
            A = M[:, cand]
            x = _gf2_solve(A, rhs)
            if x is None:
                continue
            if len(fp):
                F = fsig[:, cand].astype(np.uint8)
                basis = _gf2_nullspace(A)
                # uint8 products wrap mod 256, which keeps their parity
                Fb = (basis @ F.T) % 2                 # (n_basis, n_faults)
                Fx = (F @ x) % 2
                best = float(fp @ Fx)
                improved = True
                passes = 0
                while improved and passes < 6:
                    improved = False
                    passes += 1
                    for b, fb in zip(basis, Fb):
                        vec = Fx ^ fb
                        cc = float(fp @ vec)
                        if cc < best - 1e-15:
                            x, Fx, best = x ^ b, vec, cc
                            improved = True
            recs = [cand[i] for i in np.nonzero(x)[0]]
            if not np.array_equal(M[:, recs].sum(axis=1) % 2, rhs):
                raise RuntimeError(f"surgery readout fails its check for d={d}")
            return recs
        raise RuntimeError(f"surgery observable not solvable for d={d}")

    obs_records = [solve_obs(1, 0), solve_obs(0, 1), solve_obs(1, 1)]
    for oi, recs in enumerate(obs_records):
        c.observable_include(oi, [r - rec for r in recs])
    zz_records = obs_records[2]
    return SurgeryCircuit(circuit=c, d=d, rounds_merge=rounds_merge,
                          rounds_after=rounds_after, layout=lay,
                          zz_records=zz_records, n_records=rec)


def run_zz_surgery(d: int = 3, rounds_merge: int = 0, rounds_after: int = 0,
                   p: float = 1e-3, shots: int = 20000, seed: int = 0,
                   decode: bool = True,
                   device: Union[str, torch.device] = "cuda") -> Dict:
    """Sample the full merge/split protocol with the one-matmul sampler on
    `device`.

    Returns raw (undecoded) flip rates for the ZZ outcome and both patch
    logicals, plus - when decode=True and p > 0 - the DECODED error rates:
    the native exact matcher predicts each observable's flip from the
    detector data (a parity bitmask per shot), as for memory experiments.
    Raises when the native library cannot be built."""
    from .decoders import decoder_for_circuit
    from .fast_sampler import build_fast_sampler

    sc = zz_merge_split_circuit(d, rounds_merge, rounds_after, p)
    sampler = build_fast_sampler(sc.circuit, shots, device)
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(seed)
    out = sampler(gen)
    obs = out["observables"].cpu().numpy()
    dets = out["detectors"].cpu().numpy()
    res = {
        "d": d, "rounds_merge": sc.rounds_merge,
        "rounds_after": sc.rounds_after, "p": p, "shots": shots,
        "zz_error_rate_raw": float(obs[:, 2].mean()),
        "patch1_logical_error_raw": float(obs[:, 0].mean()),
        "patch2_logical_error_raw": float(obs[:, 1].mean()),
        "n_detectors": sc.circuit.n_detectors,
        "detector_fraction": float(dets.mean()),
        "n_zz_records": len(sc.zz_records),
    }
    if decode and p > 0:
        dec = decoder_for_circuit(sc.circuit, kind="native")
        pred = dec.decode_batch(dets)          # observable bitmask per shot
        for oi, name in ((0, "patch1_logical_error"),
                         (1, "patch2_logical_error"), (2, "zz_error_rate")):
            corrected = obs[:, oi] ^ ((pred >> oi) & 1)
            res[name + "_decoded"] = float(corrected.mean())
        res["decode_seconds"] = dec.last_decode_seconds
    return res


__all__ = ["SurgeryCircuit", "merged_layout", "zz_merge_split_circuit",
           "run_zz_surgery"]
