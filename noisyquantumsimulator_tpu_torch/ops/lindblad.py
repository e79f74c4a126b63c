"""Lindblad collapse operators and superoperator (Liouvillian) construction.

Rebuild of Part 2 of the reference noise module
(reference: rydberg_gates/noise_models.py:1176-1620) plus the superoperator
machinery that replaces QuTiP's mesolve internals.

Vectorization convention (row-major / C-order flatten):
  vec(A X B) = (A kron B^T) vec(X)
so
  -i[H, rho]        -> -i (H kron I - I kron H^T)
  L rho L^dag       ->  L kron conj(L)
  -1/2 {L^dag L, .} -> -1/2 (L^dag L kron I + I kron (L^dag L)^T)

The full Liouvillian for the CZ engine splits as

  Lmat(a, phi) = L0 + a e^{i phi} C_plus + a e^{-i phi} C_minus

where L0 holds every drive-independent term (detuning, blockade, shifts,
dissipator) and C_+- come from the (Omega/2) S drive operator. This is the
key trick: a full pulse schedule is a *linear combination* of three
constant matrices — no per-step Hamiltonian rebuilds on the device.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from .hilbert import HilbertSpace, HS3, HS4, op_two_atom, sym_two_atom
from .hamiltonians import (build_detuning_hamiltonian,
                           build_interaction_hamiltonian,
                           build_zeeman_hamiltonian, build_stark_hamiltonian,
                           drive_operator)


# =============================================================================
# collapse operators (two-atom, dense arrays)
# =============================================================================

def _both_atoms(op: np.ndarray, I: np.ndarray) -> List[np.ndarray]:
    return [np.kron(op, I), np.kron(I, op)]


def build_decay_operators(gamma_optical: float, hs: HilbertSpace,
                          gamma_bbr: float = 0.0, branching_1: float = 0.5,
                          leakage_rate: float = 0.0) -> List[np.ndarray]:
    """|r> -> |1>/|0> spontaneous decay, BBR, and mJ leakage collapse
    operators. (noise_models.py:1199-1297)"""
    c_ops: List[np.ndarray] = []
    I = hs.identity
    if hs.dim == 3:
        if gamma_optical > 0:
            s_r1, s_r0 = hs.transitions["r->1"], hs.transitions["r->0"]
            c_ops += _both_atoms(np.sqrt(gamma_optical * branching_1) * s_r1, I)
            c_ops += _both_atoms(np.sqrt(gamma_optical * (1 - branching_1)) * s_r0, I)
        if gamma_bbr > 0:
            s_r0 = hs.transitions["r->0"]
            c_ops += _both_atoms(np.sqrt(gamma_bbr) * s_r0, I)
    else:
        if gamma_optical > 0:
            for r in ("r+", "r-"):
                s1 = hs.transitions[f"{r}->1"]
                s0 = hs.transitions[f"{r}->0"]
                c_ops += _both_atoms(np.sqrt(gamma_optical * branching_1) * s1, I)
                c_ops += _both_atoms(np.sqrt(gamma_optical * (1 - branching_1)) * s0, I)
        if gamma_bbr > 0:
            for r in ("r+", "r-"):
                s0 = hs.transitions[f"{r}->0"]
                c_ops += _both_atoms(np.sqrt(gamma_bbr) * s0, I)
        if leakage_rate > 0:
            c_ops += _both_atoms(np.sqrt(leakage_rate) * hs.transitions["r+->r-"], I)
            c_ops += _both_atoms(np.sqrt(leakage_rate) * hs.transitions["r-->r+"], I)
    return c_ops


def build_dephasing_operators(gamma_phi: float, hs: HilbertSpace,
                              gamma_phi_minus: Optional[float] = None
                              ) -> List[np.ndarray]:
    """sqrt(gamma) |r><r| pure dephasing. (noise_models.py:1300-1356)"""
    if gamma_phi <= 0:
        return []
    if gamma_phi_minus is None:
        gamma_phi_minus = gamma_phi
    I = hs.identity
    c_ops: List[np.ndarray] = []
    if hs.dim == 3:
        c_ops += _both_atoms(np.sqrt(gamma_phi) * hs.projectors["r"], I)
    else:
        c_ops += _both_atoms(np.sqrt(gamma_phi) * hs.projectors["r+"], I)
        c_ops += _both_atoms(np.sqrt(gamma_phi_minus) * hs.projectors["r-"], I)
    return c_ops


def build_loss_operators(gamma_loss: float, hs: HilbertSpace,
                         loss_source: str = "rydberg") -> List[np.ndarray]:
    """Loss modeled as |r> -> |0| (or |1> -> |0>).
    (noise_models.py:1359-1412)"""
    if gamma_loss <= 0:
        return []
    I = hs.identity
    c_ops: List[np.ndarray] = []
    if loss_source == "rydberg":
        keys = ["r->0"] if hs.dim == 3 else ["r+->0", "r-->0"]
        for k in keys:
            c_ops += _both_atoms(np.sqrt(gamma_loss) * hs.transitions[k], I)
    elif loss_source == "qubit":
        c_ops += _both_atoms(np.sqrt(gamma_loss) * hs.transitions["1->0"], I)
    return c_ops


def build_scatter_operators(gamma_scatter: float, hs: HilbertSpace
                            ) -> List[np.ndarray]:
    """Intermediate-state scattering as dephasing on |1>.
    (noise_models.py:1415-1446)"""
    if gamma_scatter <= 0:
        return []
    I = hs.identity
    return _both_atoms(np.sqrt(gamma_scatter) * hs.projectors["1"], I)


def build_all_noise_operators(
    params: Optional[dict] = None,
    hs: Optional[HilbertSpace] = None,
    dim: int = 3,
    gamma_r: Optional[float] = None,
    gamma_bbr: Optional[float] = None,
    gamma_phi_laser: Optional[float] = None,
    gamma_phi_thermal: Optional[float] = None,
    gamma_phi_zeeman: Optional[float] = None,
    gamma_loss_antitrap: Optional[float] = None,
    gamma_loss_background: Optional[float] = None,
    gamma_scatter_intermediate: Optional[float] = None,
    gamma_leakage: Optional[float] = None,
    branching_1: float = 0.5,
    mJ_leakage_rate: float = 0.0,
) -> Tuple[List[np.ndarray], Dict]:
    """Unified collapse-operator factory. (noise_models.py:1449-1620)

    Returns (c_ops, noise_breakdown) keyed identically to the reference.
    """
    if hs is None:
        hs = HS3 if dim == 3 else HS4
    if params is not None:
        gamma_r = params.get("gamma_r", params.get("gamma_optical", 0)) or 0
        if gamma_r == 0 and params.get("T1", 0) > 0:
            gamma_r = 1.0 / params["T1"]
        gamma_bbr = params.get("gamma_bbr", 0)
        gamma_phi_laser = params.get("gamma_phi_laser", 0)
        gamma_phi_thermal = params.get("gamma_phi_thermal", 0)
        gamma_phi_zeeman = params.get("gamma_phi_zeeman", 0)
        if not (gamma_phi_laser or gamma_phi_thermal or gamma_phi_zeeman):
            g = params.get("gamma_dephasing", 0)
            if g == 0 and params.get("T2_star", 0) > 0:
                g = 1.0 / params["T2_star"]
            gamma_phi_laser = g
        gamma_loss_antitrap = params.get("gamma_loss_antitrap", 0)
        gamma_loss_background = params.get("gamma_loss_background", 0)
        gamma_scatter_intermediate = params.get("gamma_scatter_intermediate", 0)
        gamma_leakage = params.get("gamma_leakage", 0)
        branching_1 = params.get("branching_1", 0.5)
        mJ_leakage_rate = params.get("mJ_leakage_rate", 0)

    gamma_r = float(gamma_r or 0)
    gamma_bbr = float(gamma_bbr or 0)
    gamma_phi_laser = float(gamma_phi_laser or 0)
    gamma_phi_thermal = float(gamma_phi_thermal or 0)
    gamma_phi_zeeman = float(gamma_phi_zeeman or 0)
    gamma_loss_antitrap = float(gamma_loss_antitrap or 0)
    gamma_loss_background = float(gamma_loss_background or 0)
    gamma_scatter_intermediate = float(gamma_scatter_intermediate or 0)
    gamma_leakage = float(gamma_leakage or 0)

    c_ops: List[np.ndarray] = []
    c_ops += build_decay_operators(gamma_r, hs, gamma_bbr, branching_1, mJ_leakage_rate)
    gamma_phi_total = gamma_phi_laser + gamma_phi_thermal + gamma_phi_zeeman
    c_ops += build_dephasing_operators(gamma_phi_total, hs)
    c_ops += build_loss_operators(gamma_loss_antitrap, hs, "rydberg")
    c_ops += build_loss_operators(gamma_loss_background, hs, "rydberg")
    c_ops += build_scatter_operators(gamma_scatter_intermediate, hs)
    c_ops += build_loss_operators(gamma_leakage, hs, "rydberg")

    noise_breakdown = {
        "gamma_r": gamma_r, "gamma_bbr": gamma_bbr,
        "gamma_phi_laser": gamma_phi_laser,
        "gamma_phi_thermal": gamma_phi_thermal,
        "gamma_phi_zeeman": gamma_phi_zeeman,
        "gamma_loss_antitrap": gamma_loss_antitrap,
        "gamma_loss_background": gamma_loss_background,
        "gamma_scatter_intermediate": gamma_scatter_intermediate,
        "gamma_leakage": gamma_leakage,
        "mJ_leakage_rate": mJ_leakage_rate,
        "branching_1": branching_1,
        "gamma_phi_total": gamma_phi_total,
        "total_decay_rate": gamma_r + gamma_bbr,
        "total_dephasing_rate": gamma_phi_total,
        "total_loss_rate": gamma_loss_antitrap + gamma_loss_background + gamma_leakage,
        "dim": hs.dim,
        "n_collapse_ops": len(c_ops),
    }
    return c_ops, noise_breakdown


# =============================================================================
# superoperators
# =============================================================================

def hamiltonian_superop(H: np.ndarray) -> np.ndarray:
    """-i (H kron I - I kron H^T) for row-major vec."""
    D = H.shape[0]
    I = np.eye(D, dtype=H.dtype)
    return -1j * (np.kron(H, I) - np.kron(I, H.T))


def dissipator_superop(c_ops: List[np.ndarray], D: int) -> np.ndarray:
    """sum_k [ L kron conj(L) - 1/2 (L^dag L kron I + I kron (L^dag L)^T) ]."""
    I = np.eye(D, dtype=np.complex128)
    out = np.zeros((D * D, D * D), dtype=np.complex128)
    for L in c_ops:
        LdL = L.conj().T @ L
        out += np.kron(L, L.conj())
        out -= 0.5 * (np.kron(LdL, I) + np.kron(I, LdL.T))
    return out


def liouvillian(H: np.ndarray, c_ops: List[np.ndarray]) -> np.ndarray:
    """Full constant Liouvillian matrix (D^2 x D^2)."""
    return hamiltonian_superop(H) + dissipator_superop(c_ops, H.shape[0])


def drive_decomposition(hs: HilbertSpace, Omega: float,
                        H0: np.ndarray, c_ops: List[np.ndarray],
                        polarization: str = "sigma+",
                        Omega_minus_frac: Optional[float] = None
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Decompose the Liouvillian into (L0, C_plus, C_minus).

    Lmat(a, phi) = L0 + a e^{i phi} C_plus + a e^{-i phi} C_minus, with
    `a` a dimensionless amplitude scale (1 for square pulses) applied to
    the |Omega|/2 drive.

    H0 must contain every drive-independent Hamiltonian term.
    """
    S = drive_operator(hs, polarization, Omega_minus_frac)
    Hp = 0.5 * Omega * S          # coefficient of e^{+i phi}
    Hm = 0.5 * Omega * S.conj().T  # coefficient of e^{-i phi}
    L0 = hamiltonian_superop(H0) + dissipator_superop(c_ops, H0.shape[0])
    Cp = hamiltonian_superop_linear(Hp)
    Cm = hamiltonian_superop_linear(Hm)
    return L0, Cp, Cm


def hamiltonian_superop_linear(A: np.ndarray) -> np.ndarray:
    """-i (A kron I - I kron A^T): the superoperator of a (possibly
    non-Hermitian) Hamiltonian *term*. Summing the e^{+-i phi} pair restores
    Hermiticity of the total H."""
    D = A.shape[0]
    I = np.eye(D, dtype=complex)
    return -1j * (np.kron(A, I) - np.kron(I, A.T))


def static_hamiltonian(hs: HilbertSpace, Delta: float, V: float,
                       delta_zeeman: float = 0.0, delta_stark: float = 0.0,
                       trap_laser_on: bool = True,
                       zeeman_splitting: float = 0.0,
                       Delta_minus: Optional[float] = None,
                       V_pm: Optional[float] = None,
                       V_mm: Optional[float] = None) -> np.ndarray:
    """All drive-independent Hamiltonian terms."""
    H = (build_detuning_hamiltonian(Delta, hs, zeeman_splitting, Delta_minus)
         + build_interaction_hamiltonian(V, hs, V_pm, V_mm))
    if delta_zeeman != 0:
        H = H + build_zeeman_hamiltonian(delta_zeeman, hs)
    if delta_stark != 0:
        H = H + build_stark_hamiltonian(delta_stark, hs, trap_laser_on)
    return H


def superop_basis(hs: HilbertSpace) -> Dict[str, np.ndarray]:
    """Fixed superoperator basis for the linear Liouvillian assembly.

    Any 3-level two-atom CZ Liouvillian in this framework is a *linear
    combination* of these constant matrices:

        Lmat = Delta * Cd + shift1 * C1 + V * Cv
             + Omega [a e^{i phi} Sp + a e^{-i phi} Sm]
             + g_r1 D_r1 + g_r0 D_r0 + g_deph_r D_deph_r + g_deph_1 D_deph_1

    so hardware/protocol parameters stay plain scalar coefficients (the
    reference has no analog — its optimizers re-run the full Python
    pipeline per point).

    Keys:
      Cd      coefficient: -Delta on |r><r| both atoms (detuning; note the
              minus sign of H_det is baked in, multiply by +Delta)
      C1      coefficient: qubit-|1> shift (Zeeman + Stark) [rad/s]
      Cv      coefficient: blockade V on |rr><rr| [rad/s]
      Sp, Sm  coefficient: Omega * a * e^{+-i phi} (drive halves)
      D_r1    unit-rate decay |r> -> |1> on both atoms
      D_r0    unit-rate decay/loss |r> -> |0> on both atoms
      D_deph_r  unit-rate dephasing sqrt(g)|r><r|
      D_deph_1  unit-rate dephasing sqrt(g)|1><1| (intermediate scattering)
    """
    if hs.dim != 3:
        raise ValueError("superop_basis currently supports the 3-level model")
    D = hs.dim ** 2
    Pr, P1 = hs.projectors["r"], hs.projectors["1"]
    S = drive_operator(hs)
    basis = {
        "Cd": hamiltonian_superop_linear(-sym_two_atom(Pr)),
        "C1": hamiltonian_superop_linear(sym_two_atom(P1)),
        "Cv": hamiltonian_superop_linear(op_two_atom(Pr, Pr)),
        "Sp": hamiltonian_superop_linear(0.5 * S),
        "Sm": hamiltonian_superop_linear(0.5 * S.conj().T),
        "D_r1": dissipator_superop(_both_atoms(hs.transitions["r->1"], hs.identity), D),
        "D_r0": dissipator_superop(_both_atoms(hs.transitions["r->0"], hs.identity), D),
        "D_deph_r": dissipator_superop(_both_atoms(Pr, hs.identity), D),
        "D_deph_1": dissipator_superop(_both_atoms(P1, hs.identity), D),
    }
    return basis


__all__ = [
    "build_decay_operators", "build_dephasing_operators",
    "build_loss_operators", "build_scatter_operators",
    "build_all_noise_operators", "hamiltonian_superop",
    "hamiltonian_superop_linear", "dissipator_superop", "liouvillian",
    "drive_decomposition", "static_hamiltonian", "superop_basis",
]
