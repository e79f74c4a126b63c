"""Engine-driven sideband cooling: the motional-ladder master equation.

Implements the reference's neutral-atom cooling spec for real
(reference: src/qpu_simulator/micro_physics/neutral_atoms/
cooling.py:1-27 — "sideband cooling (resolved sideband), cooling time
vs final temperature tradeoff" -> duration, final motional state /
temperature, success probability, atom loss). The repo's Cool primitive
(primitives/motion.py) previously returned METHOD-TABLE constants; this
module derives the time-resolved Fock-state distribution from dynamics,
the same L0 standard as gate/{ms_gate,cavity_gate,raman_gate,readout}.

Model — the resolved-sideband rate ladder, solved exactly
---------------------------------------------------------
Adiabatic elimination of the excited state in the resolved-sideband
regime (Gamma_eff << omega) reduces the cooling cycle to a classical
birth-death process on the Fock ladder {0..n_max}:

  cooling   n -> n-1   rate A_minus * n
  heating   n -> n+1   rate A_plus * (n + 1) + R_trap

with the standard sideband-cooling coefficients (eta = Lamb-Dicke):
  A_minus = eta^2 W [ Gamma_eff^2 / (Gamma_eff^2)            ]  (red res.)
  A_plus  = eta^2 W [ (Gamma_eff / (4 omega))^2 (on-res. carrier recoil
            + blue-sideband off-resonant terms, alpha factor) ]
i.e. A_plus/A_minus = (Gamma_eff / (4 omega))^2 * zeta with the recoil
geometry factor zeta ~ (1 + alpha_dipole); R_trap is the apparatus
anomalous-heating floor in quanta/s. The steady state is thermal with
  nbar_ss = A_plus_tot / (A_minus - A_plus_tot).

One expm of the tridiagonal generator — through the same expm as the
gate engine (ops/expm via gate/readout._expm_engine) — gives the EXACT
P_n(t) from any initial thermal state: the cooling-time-vs-final-nbar
tradeoff, the ground-state fraction ("success probability"), and the
non-thermal transient distribution a single-rate exponential misses.
Atom loss during cooling rides as a uniform rate (photon recoil out of
a shallow trap), reported separately.

Counterpart of the reference's `gate/cooling.py`; the expm runs on `device`
at float64 (see gate/readout.py). The default generator is 81 x 81 with a
1-norm of 1.414e4: 12 squarings under Pade-13, which `_expm_engine` passes as
`max_squarings` (K2's resident route on the card).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

from ..core.constants import HBAR, KB, TWO_PI
from .open_system import thermal_state
from .readout import _expm_engine


@dataclass
class CoolingSimResult:
    """Spec contract (cooling.py:19-27 outputs) + extras."""
    duration: float
    final_nbar: float
    final_temperature: float
    ground_state_fraction: float         # "success probability"
    loss_probability: float
    nbar_ss: float                       # steady-state floor
    cooling_rate: float                  # A_minus - A_plus [1/s]
    populations: np.ndarray              # final P_n
    error_budget: Dict[str, float] = field(default_factory=dict)
    parameters: Dict = field(default_factory=dict)

    def print_summary(self) -> None:
        print(f"sideband cooling: t = {self.duration*1e3:.2f} ms, "
              f"nbar {self.parameters.get('nbar0', 0):.2f} -> "
              f"{self.final_nbar:.4f} (floor {self.nbar_ss:.4f}), "
              f"P(n=0) = {self.ground_state_fraction:.4f}")


def _ladder_generator(n_max: int, a_minus: float, a_plus: float,
                      r_trap: float) -> np.ndarray:
    """Birth-death generator on {0..n_max} (column-stochastic)."""
    m = n_max + 1
    G = np.zeros((m, m))
    for n in range(m):
        if n > 0:
            G[n - 1, n] += a_minus * n
            G[n, n] -= a_minus * n
        if n < n_max:
            up = a_plus * (n + 1) + r_trap
            G[n + 1, n] += up
            G[n, n] -= up
    return G


def simulate_sideband_cooling(
        duration: float = 5e-3,
        omega_trap: float = TWO_PI * 100e3,
        gamma_eff: float = TWO_PI * 20e3,   # quenched effective linewidth
        eta_ld: float = 0.15,               # Lamb-Dicke parameter
        omega_sideband: float = TWO_PI * 50e3,  # red-sideband Rabi freq
        alpha_dipole: float = 0.4,          # recoil geometry factor
        r_trap_heating: float = 0.5,        # anomalous heating [quanta/s]
        nbar0: float = 10.0,
        loss_rate: float = 0.05,            # [1/s] during cooling light
        n_max: Optional[int] = None,
        device="cuda") -> CoolingSimResult:
    """Exact Fock-ladder cooling dynamics (see module doc).

    Defaults model Raman sideband cooling of a tweezer atom at 100 kHz
    trap frequency from nbar ~ 10 (post-loading) toward the ground
    state. Sideband-resolution requires gamma_eff < omega_trap; the
    floor degrades as (gamma_eff / 4 omega)^2 as resolution is lost.
    The expm runs on `device`.
    """
    if n_max is None:
        n_max = int(max(32, 8 * nbar0))
    if n_max > 4096:
        raise ValueError(f"Fock ladder n_max={n_max} too large; "
                         "lower nbar0 or pass n_max")
    # cycle rate: excitation on the red sideband (saturated two-level
    # estimate), times the branching of decays that remove a quantum
    W = (omega_sideband ** 2) / gamma_eff
    a_minus = W * (eta_ld ** 2)
    # off-resonant carrier + blue-sideband excitation with recoil:
    # the standard resolved-sideband limit coefficient
    zeta = (gamma_eff / (4.0 * omega_trap)) ** 2 * (1.0 + alpha_dipole)
    a_plus = a_minus * zeta
    # exact mean ODE for the linear ladder:
    # d<n>/dt = -(A- - A+) <n> + (A+ + R)
    rate = a_minus - a_plus
    nbar_ss = (a_plus + r_trap_heating) / max(rate, 1e-30) \
        if rate > 0 else float("inf")

    G = _ladder_generator(n_max, a_minus, a_plus, r_trap_heating)
    p0 = np.diag(thermal_state(n_max + 1, nbar0)).real
    p0 = p0 / p0.sum()
    E = _expm_engine(G * duration, device)
    p = E @ p0
    p = np.clip(p, 0.0, None)
    p = p / p.sum()
    ns = np.arange(n_max + 1)
    nbar_f = float(np.dot(ns, p))
    T_f = HBAR * omega_trap / KB / np.log(1.0 + 1.0 / max(nbar_f, 1e-12))
    loss = 1.0 - float(np.exp(-loss_rate * duration))
    budget = {
        "offres_heating_floor": a_plus / max(a_minus, 1e-30),
        "trap_heating_floor": r_trap_heating / max(a_minus, 1e-30),
        "transient_excess": max(0.0, nbar_f - nbar_ss),
        "truncation_tail": float(p[-1]),
        "loss": loss,
    }
    return CoolingSimResult(
        duration=duration, final_nbar=nbar_f, final_temperature=float(T_f),
        ground_state_fraction=float(p[0]), loss_probability=loss,
        nbar_ss=float(nbar_ss), cooling_rate=float(rate),
        populations=p, error_budget=budget,
        parameters={"omega_trap": omega_trap, "gamma_eff": gamma_eff,
                    "eta_ld": eta_ld, "omega_sideband": omega_sideband,
                    "a_minus": float(a_minus), "a_plus": float(a_plus),
                    "r_trap_heating": r_trap_heating, "nbar0": nbar0,
                    "n_max": n_max,
                    "engine": "Fock-ladder master equation, exact expm"})


def cooling_calibration_record(result: CoolingSimResult, regime: str):
    """CalibrationRecord (platform neutral_atoms / operation cooling)."""
    from ..channels.calibration import CalibrationRecord
    return CalibrationRecord(
        platform="neutral_atoms", operation="cooling", regime=regime,
        parameters={k: float(v) for k, v in result.parameters.items()
                    if isinstance(v, (int, float))},
        error_rates={
            "avg_gate_infidelity": 1.0 - result.ground_state_fraction,
            "final_nbar": result.final_nbar,
            "loss": result.loss_probability,
        },
        duration=result.duration,
        pauli_error_probs=None, pauli_labels=None, superop=None,
        metadata={
            "generator": "noisyquantumsimulator_tpu_torch.gate.cooling",
            "final_temperature_K": result.final_temperature,
            "nbar_steady_state": result.nbar_ss,
            "cooling_rate_per_s": result.cooling_rate,
            "error_budget": {k: float(v)
                             for k, v in result.error_budget.items()},
        })


__all__ = ["CoolingSimResult", "simulate_sideband_cooling",
           "cooling_calibration_record"]
