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

from ..core.constants import HBAR, MU_B, TWO_PI
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


def build_laser_hamiltonian(Omega: complex, hs: HilbertSpace = None,
                            polarization: str = "sigma+",
                            Omega_minus: Optional[float] = None) -> np.ndarray:
    """H_laser = (Omega/2) S + (Omega*/2) S^dag. (hamiltonians.py:584)"""
    hs = _hs(hs, 3)
    if hs.dim == 3 or polarization != "mixed" or Omega_minus is None:
        frac = None if Omega_minus is None else abs(Omega_minus) / max(abs(Omega), 1e-300)
        S = drive_operator(hs, polarization, frac)
        return 0.5 * (Omega * S + np.conj(Omega) * S.conj().T)
    S = drive_operator(hs, polarization, abs(Omega_minus) / max(abs(Omega), 1e-300))
    return 0.5 * (Omega * S + np.conj(Omega) * S.conj().T)


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


def build_qubit_hamiltonian(omega_qubit: float, hs: HilbertSpace = None) -> np.ndarray:
    """omega_q sum |1><1|. (hamiltonians.py:858)"""
    hs = _hs(hs, 3)
    return omega_qubit * sym_two_atom(hs.projectors["1"])


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


def build_full_hamiltonian(Omega: complex, Delta: float, V: float,
                           hs: HilbertSpace = None, dim: int = 3,
                           polarization: str = "sigma+",
                           zeeman_splitting: float = 0.0,
                           omega_qubit: float = 0.0,
                           delta_zeeman: float = 0.0,
                           delta_stark: float = 0.0,
                           trap_laser_on: bool = True,
                           **kwargs) -> np.ndarray:
    """H = H_laser + H_det + H_int + optional terms.
    (hamiltonians.py:1057-1172)"""
    hs = _hs(hs, dim)
    H = (build_laser_hamiltonian(Omega, hs, polarization,
                                 kwargs.get("Omega_minus"))
         + build_detuning_hamiltonian(Delta, hs, zeeman_splitting,
                                      kwargs.get("Delta_minus"))
         + build_interaction_hamiltonian(V, hs, kwargs.get("V_pm"),
                                         kwargs.get("V_mm")))
    if omega_qubit != 0:
        H = H + build_qubit_hamiltonian(omega_qubit, hs)
    if delta_zeeman != 0:
        H = H + build_zeeman_hamiltonian(delta_zeeman, hs)
    if delta_stark != 0:
        H = H + build_stark_hamiltonian(delta_stark, hs, trap_laser_on)
    return H


def build_phase_modulated_hamiltonian(Omega: float, phase: float, V: float,
                                      hs: HilbertSpace = None,
                                      Delta: float = 0.0,
                                      delta_zeeman: float = 0.0,
                                      delta_stark: float = 0.0,
                                      trap_laser_on: bool = True) -> np.ndarray:
    """H with Omega e^{i phase} drive; used by JP protocols.
    (hamiltonians.py:1179-1273)"""
    return build_full_hamiltonian(Omega * np.exp(1j * phase), Delta, V,
                                  hs=hs, delta_zeeman=delta_zeeman,
                                  delta_stark=delta_stark,
                                  trap_laser_on=trap_laser_on)


def check_rwa_validity(Omega: float, omega_optical: float = TWO_PI * 384e12,
                       threshold: float = 0.01, verbose: bool = True) -> bool:
    """RWA validity Omega/omega_opt < threshold. (hamiltonians.py:996-1053)"""
    ratio = abs(Omega) / omega_optical
    ok = ratio < threshold
    if verbose and not ok:
        bs = Omega ** 2 / (4.0 * omega_optical)
        print(f"RWA WARNING: Omega/omega_opt = {ratio:.2e} > {threshold}; "
              f"Bloch-Siegert shift ~ {bs / TWO_PI / 1e3:.3f} kHz")
    return ok


def compute_mJ_zeeman_splitting(B_field: float, g_J: float = 2.002) -> float:
    """g_J mu_B B / hbar [rad/s]. (hamiltonians.py:1281)"""
    return g_J * MU_B * B_field / HBAR


def compute_mJ_coupling_ratio(polarization: str):
    """(w+, w-) with w+^2 + w-^2 = 1. (hamiltonians.py:1309-1343)"""
    if polarization == "sigma+":
        return (1.0, 0.0)
    if polarization == "sigma-":
        return (0.0, 1.0)
    if polarization == "pi":
        return (1.0 / np.sqrt(2.0), 1.0 / np.sqrt(2.0))
    impurity = 0.02
    return (np.sqrt(1.0 - impurity), np.sqrt(impurity))


__all__ = [
    "drive_operator", "build_laser_hamiltonian", "build_detuning_hamiltonian",
    "build_interaction_hamiltonian", "build_qubit_hamiltonian",
    "build_zeeman_hamiltonian", "build_stark_hamiltonian",
    "build_full_hamiltonian", "build_phase_modulated_hamiltonian",
    "check_rwa_validity", "compute_mJ_zeeman_splitting",
    "compute_mJ_coupling_ratio",
]
