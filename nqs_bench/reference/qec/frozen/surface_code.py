# Frozen copy of the port's host code (noisyquantumsimulator_tpu_torch/qec/surface_code.py), kept so that the
# benchmark's reference rebuilds the surface-code memory experiment from its configuration
# file without importing the program. Only the imports were changed, and what the
# reference never reaches was left out.
"""Rotated surface code: layout, memory circuits, metrics.

Implements the reference's comment-only surface-code spec
(reference: architecture/qec/surface_code.py:5-25 — "rotated layout,
syndrome circuits, logical operators, error rate / round, threshold").

Layout (distance d, rotated):
  data qubits on the d x d grid at odd coordinates (2i+1, 2j+1)
  ancillas at even-coordinate plaquette centers, alternating X/Z type in
  the checkerboard pattern with 2-body checks on the boundary.

Memory-Z experiment: initialize |0..0>, run `rounds` cycles of stabilizer
extraction (standard 4-step CX dance with the zig-zag order that avoids
hook errors), then measure all data qubits in Z. Detectors compare
consecutive Z-syndrome rounds; the observable is a logical-Z data column.

Noise models:
  * "circuit": uniform circuit-level depolarizing noise (probability p on
    every gate, measurement flip p, reset error p) — the standard Stim
    benchmark model, for cross-tool comparison.
  * "calibrated": two-qubit gates carry the 16-entry Pauli channel from
    Layer-0 calibration; idle/measure/reset errors from Layer-1 primitives.

Host numpy, copied from the reference's `qec/surface_code.py` unchanged, so
the port builds the same layouts and circuits without importing the JAX
package.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from .circuits import Circuit


@dataclass(frozen=True)
class SurfaceCodeLayout:
    d: int                                    # min(w, h) for rectangles
    data: Dict[Tuple[int, int], int]          # coord -> qubit index
    x_anc: Dict[Tuple[int, int], int]
    z_anc: Dict[Tuple[int, int], int]
    w: int = 0                                # data columns (0 = square d)
    h: int = 0                                # data rows

    @property
    def n_qubits(self) -> int:
        return len(self.data) + len(self.x_anc) + len(self.z_anc)

    @property
    def data_indices(self) -> List[int]:
        return [self.data[c] for c in sorted(self.data)]

    @property
    def z_anc_indices(self) -> List[int]:
        return [self.z_anc[c] for c in sorted(self.z_anc)]

    @property
    def x_anc_indices(self) -> List[int]:
        return [self.x_anc[c] for c in sorted(self.x_anc)]


def build_rect_layout(w: int, h: int) -> SurfaceCodeLayout:
    """Rectangular rotated surface code: w data columns x h data rows.

    Distance against X errors is w (logical Z = a data row), against Z
    errors is h (logical X = a data column); k = 1. Rectangles are the
    building block for lattice surgery (a rough ZZ merge of two d-patches
    is the (2d+1) x d rectangle — see lattice_surgery.py)."""
    data = {}
    idx = 0
    for i in range(w):
        for j in range(h):
            data[(2 * i + 1, 2 * j + 1)] = idx
            idx += 1
    x_anc, z_anc = {}, {}
    for x in range(0, 2 * w + 1, 2):
        for y in range(0, 2 * h + 1, 2):
            # plaquette center (x, y); type by checkerboard
            neighbors = [(x - 1, y - 1), (x - 1, y + 1),
                         (x + 1, y - 1), (x + 1, y + 1)]
            n_data = sum(1 for c in neighbors if c in data)
            if n_data < 2:  # corners touch only one data qubit: no check
                continue
            is_x_type = ((x + y) // 2) % 2 == 1
            # boundary rules of the rotated code: 2-body X checks live on
            # top/bottom rows, 2-body Z checks on left/right columns
            if n_data == 2:
                if is_x_type and not (y == 0 or y == 2 * h):
                    continue
                if not is_x_type and not (x == 0 or x == 2 * w):
                    continue
            if is_x_type:
                x_anc[(x, y)] = idx
            else:
                z_anc[(x, y)] = idx
            idx += 1
    lay = SurfaceCodeLayout(d=min(w, h), data=data, x_anc=x_anc,
                            z_anc=z_anc, w=w, h=h)
    _validate_layout(lay)
    return lay


def build_layout(d: int) -> SurfaceCodeLayout:
    """Rotated surface code coordinates (the standard square construction)."""
    return build_rect_layout(d, d)


def _validate_layout(lay: SurfaceCodeLayout) -> None:
    """Stabilizer-group sanity: counts, mutual commutation, logical ops."""
    w = lay.w or lay.d
    h = lay.h or lay.d

    def support(center):
        x, y = center
        return {c for c in ((x - 1, y - 1), (x - 1, y + 1),
                            (x + 1, y - 1), (x + 1, y + 1)) if c in lay.data}

    assert len(lay.x_anc) + len(lay.z_anc) == w * h - 1, "stabilizer count"
    if w == h:
        assert len(lay.x_anc) == (w * h - 1) // 2, "X stabilizer count"
    logical_z = {(2 * i + 1, 1) for i in range(w)}       # bottom row
    logical_x = {(1, 2 * j + 1) for j in range(h)}       # left column
    for cx in lay.x_anc:
        for cz in lay.z_anc:
            assert len(support(cx) & support(cz)) % 2 == 0, "commutation"
        assert len(support(cx) & logical_z) % 2 == 0, "logical Z commutes"
    for cz in lay.z_anc:
        assert len(support(cz) & logical_x) % 2 == 0, "logical X commutes"


# CX dance order: the zig-zag (N-shape for X, Z-shape for Z ancillas)
# that avoids hook errors propagating onto logical operators.
_X_ORDER = [(1, 1), (1, -1), (-1, 1), (-1, -1)]
_Z_ORDER = [(1, 1), (-1, 1), (1, -1), (-1, -1)]


def memory_z_circuit(
    d: int,
    rounds: int,
    noise: str = "circuit",
    p: float = 1e-3,
    cz_pauli_probs: Optional[np.ndarray] = None,
    p_meas: Optional[float] = None,
    p_reset: Optional[float] = None,
    p_idle: Optional[float] = None,
    layout: Optional[SurfaceCodeLayout] = None,
    extra_observables: Optional[List[List[int]]] = None,
    plus_init_data: Optional[List[Tuple[int, int]]] = None,
    indeterminate_z_round1: Optional[List[Tuple[int, int]]] = None,
    logical_z_columns: Optional[List[int]] = None,
    p_erase: float = 0.0,
) -> Circuit:
    """Memory-Z experiment circuit for the rotated surface code.

    layout: pass a rectangular layout (build_rect_layout) to override the
    square d x d default — used by lattice_surgery.py.
    extra_observables: additional observables as lists of measurement-
    record lookbacks *counted within the first round's ancilla block*
    (0 = first Z ancilla of round 1); used for surgery logical products.
    plus_init_data: data coordinates prepared in |+> instead of |0>
    (lattice-surgery seam); their round-1 Z checks become indeterminate.
    indeterminate_z_round1: Z-ancilla coordinates whose round-1 detector
    must be dropped (outcomes random by design, e.g. seam-bridging checks).
    logical_z_columns: restrict observable 0 to these data columns of the
    bottom row (default: all columns).
    """
    lay = layout if layout is not None else build_layout(d)
    c = Circuit(n_qubits=lay.n_qubits)
    data_idx = lay.data_indices
    zanc = sorted(lay.z_anc)
    xanc = sorted(lay.x_anc)
    z_ids = [lay.z_anc[a] for a in zanc]
    x_ids = [lay.x_anc[a] for a in xanc]
    p_meas = p if p_meas is None else p_meas
    p_reset = p if p_reset is None else p_reset
    p_idle = (p / 10 if p_idle is None else p_idle)

    use_calibrated = noise == "calibrated" and cz_pauli_probs is not None

    def noisy_cx(pairs):
        if not pairs:
            return
        flat = np.asarray(pairs, dtype=np.int32)
        c.append("CX", flat)
        if use_calibrated:
            c.append("PAULI_CHANNEL_2", flat, probs=cz_pauli_probs)
        elif p > 0:
            c.append("DEPOLARIZE2", flat, arg=p)

    def cycle(first: bool):
        # ancilla prep
        if p_reset > 0:
            c.append("X_ERROR", z_ids + x_ids, arg=p_reset)
        c.append("H", x_ids)
        if p > 0 and not use_calibrated:
            c.append("DEPOLARIZE1", x_ids, arg=p)
        # 4-step dance
        for step in range(4):
            pairs = []
            for a in xanc:  # X ancilla is CONTROL
                dx, dy = _X_ORDER[step]
                tgt = (a[0] + dx, a[1] + dy)
                if tgt in lay.data:
                    pairs.append((lay.x_anc[a], lay.data[tgt]))
            for a in zanc:  # data is control, Z ancilla is TARGET
                dx, dy = _Z_ORDER[step]
                src = (a[0] + dx, a[1] + dy)
                if src in lay.data:
                    pairs.append((lay.data[src], lay.z_anc[a]))
            noisy_cx(pairs)
        c.append("H", x_ids)
        if p > 0 and not use_calibrated:
            c.append("DEPOLARIZE1", x_ids, arg=p)
        if p_idle > 0:
            c.append("DEPOLARIZE1", data_idx, arg=p_idle)
        if p_erase > 0:   # heralded atom loss/erasure per round (loss.py)
            c.append("ERASE", data_idx, arg=p_erase)
        # measure + reset ancillas
        c.append("MR", z_ids + x_ids, arg=p_meas)

    n_anc = len(z_ids) + len(x_ids)
    n_z = len(z_ids)

    # |+> seam preparation (lattice surgery): R then H before the first
    # cycle — the reset's z-gauge randomization becomes the x-gauge of
    # |+> under H, which is exactly the measurement randomness of Z reads
    # on |+> (the frame sampler needs the gauge injected explicitly)
    if plus_init_data:
        seam_ids = [lay.data[cc] for cc in plus_init_data]
        c.append("R", seam_ids)
        c.append("H", seam_ids)
    skip_r1 = {zanc.index(a) for a in (indeterminate_z_round1 or ())}

    for r in range(rounds):
        cycle(first=(r == 0))
        if r == 0:
            # Z ancillas start deterministic for |0..0> memory, except
            # those declared indeterminate (seam-bridging checks)
            for k in range(n_z):
                if k not in skip_r1:
                    c.detector([-n_anc + k])
        else:
            for k in range(n_z):
                c.detector([-n_anc + k, -2 * n_anc + k])

    # final data measurement
    c.append("M", data_idx, arg=p_meas)
    n_data = len(data_idx)
    data_coords = sorted(lay.data)

    # boundary detectors: each Z stabilizer vs its data qubits
    for k, a in enumerate(zanc):
        recs = [-n_data - n_anc + k]
        for dx, dy in ((1, 1), (1, -1), (-1, 1), (-1, -1)):
            cc = (a[0] + dx, a[1] + dy)
            if cc in lay.data:
                pos = data_coords.index(cc)
                recs.append(-n_data + pos)
        c.detector(recs)

    # logical Z: bottom row of data qubits (y = 1); commutes with every X
    # stabilizer (checked in _validate_layout). logical_z_columns restricts
    # to a sub-patch row (surgery: read Z_L of one patch only).
    cols = (set(logical_z_columns) if logical_z_columns is not None
            else None)
    row = [i for i, cc in enumerate(data_coords)
           if cc[1] == 1 and (cols is None or (cc[0] - 1) // 2 in cols)]
    c.observable_include(0, [-n_data + i for i in row])

    # extra observables (lattice surgery): indices into the round-1
    # ancilla measurement block, converted to lookbacks from the end
    if extra_observables:
        total = rounds * n_anc + n_data
        for oi, idxs in enumerate(extra_observables, start=1):
            c.observable_include(oi, [-total + k for k in idxs])
    return c
