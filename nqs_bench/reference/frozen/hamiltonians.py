# Frozen copy of the port's host plan code (noisyquantumsimulator_tpu_torch/ops/hamiltonians.py), kept so that the
# benchmark's reference rebuilds the gate from its configuration file without
# importing the program. Only the imports were changed, and what the reference
# never reaches was left out.
"""Two-atom Hamiltonian builders (dense complex arrays).

Rebuild of the reference Hamiltonian layer
(reference: rydberg_gates/hamiltonians.py:584-1343). Rotating frame, RWA:

  H = sum_atoms [(Omega/2)(e^{i phi}|r><1| + h.c.) - Delta |r><r|
                 + (omega_q + delta_z + delta_s)|1><1|] + V |rr><rr|

Builders return numpy complex128 arrays (host-side). The solver never
calls these per time step: the drive enters through the (L0, C+, C-)
decomposition in ops/lindblad.py, so only scalar (amp, phase) schedules
reach the device.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from .hilbert import HS3, HS4, HilbertSpace, op_two_atom, sym_two_atom


def _hs(hs: Optional[HilbertSpace], dim: int) -> HilbertSpace:
    if hs is not None:
        return hs
    return HS3 if dim == 3 else HS4


def drive_operator(hs: HilbertSpace, polarization: str = "sigma+",
                   Omega_minus_frac: Optional[float] = None) -> np.ndarray:
    """Two-atom raising operator S such that
    H_laser = (Omega/2) e^{i phi} S + h.c.   (hamiltonians.py:584-681)

    dim=3: S = |r><1| on each atom. dim=4: polarization selects the
    coupling weights to |r+> and |r->.
    """
    if hs.dim == 3:
        return sym_two_atom(hs.transitions["1->r"])
    sp = hs.transitions["1->r+"]
    sm = hs.transitions["1->r-"]
    if polarization == "sigma+":
        w_p, w_m = 1.0, 0.0
    elif polarization == "sigma-":
        w_p, w_m = 0.0, 1.0
    elif polarization == "pi":
        w_p = w_m = 1.0 / np.sqrt(2.0)
    else:  # "mixed"
        w_m = Omega_minus_frac if Omega_minus_frac is not None else 0.02
        w_p = 1.0
    return sym_two_atom(w_p * sp + w_m * sm)


def build_detuning_hamiltonian(Delta: float, hs: HilbertSpace = None,
                               zeeman_splitting: float = 0.0,
                               Delta_minus: Optional[float] = None) -> np.ndarray:
    """H_det = -Delta sum_atoms |r><r|. (hamiltonians.py:684-755)"""
    hs = _hs(hs, 3)
    if hs.dim == 3:
        return -Delta * sym_two_atom(hs.projectors["r"])
    Dm = Delta_minus if Delta_minus is not None else Delta + zeeman_splitting
    return (-Delta * sym_two_atom(hs.projectors["r+"])
            - Dm * sym_two_atom(hs.projectors["r-"]))


def build_interaction_hamiltonian(V: float, hs: HilbertSpace = None,
                                  V_pm: Optional[float] = None,
                                  V_mm: Optional[float] = None) -> np.ndarray:
    """H_int = V |rr><rr| (+ cross-mJ terms for dim=4).
    (hamiltonians.py:758-855)"""
    hs = _hs(hs, 3)
    if hs.dim == 3:
        Pr = hs.projectors["r"]
        return V * op_two_atom(Pr, Pr)
    Pp, Pm = hs.projectors["r+"], hs.projectors["r-"]
    Vc = V_pm if V_pm is not None else V
    Vm = V_mm if V_mm is not None else V
    return (V * op_two_atom(Pp, Pp)
            + Vc * (op_two_atom(Pp, Pm) + op_two_atom(Pm, Pp))
            + Vm * op_two_atom(Pm, Pm))


def build_zeeman_hamiltonian(delta_zeeman: float, hs: HilbertSpace = None) -> np.ndarray:
    """delta_B sum |1><1|. (hamiltonians.py:893)"""
    hs = _hs(hs, 3)
    return delta_zeeman * sym_two_atom(hs.projectors["1"])


def build_stark_hamiltonian(delta_stark: float, hs: HilbertSpace = None,
                            trap_laser_on: bool = True) -> np.ndarray:
    """delta_AC sum |1><1| (zero when the trap is blanked).
    (hamiltonians.py:936)"""
    hs = _hs(hs, 3)
    if not trap_laser_on:
        return np.zeros((hs.dim ** 2, hs.dim ** 2), dtype=np.complex128)
    return delta_stark * sym_two_atom(hs.projectors["1"])
