"""CZ-gate protocol parameter registry: Levine-Pichler, smooth JP, bang-bang JP.

Rebuild of the reference protocol registry
(reference: rydberg_gates/protocols.py:127-858). Numbers here are protocol
constants from the literature / numerical optimization:
  - LP asymptotic optimum (Levine et al. PRL 123 170503): Delta/Omega=0.377371,
    Omega*tau=4.29268 per pulse, xi=3.90242 rad
  - Smooth JP (Evered et al. Nature 622 268; Bluvstein thesis):
    phi(t)=A cos(w t - phi0)+delta0 t with A=0.311pi, w/Omega=1.242,
    phi0=4.696, delta0/Omega=0.0205, Omega*tau=10.09
  - Validated 5-segment bang-bang at V/Omega=200 (~95.6% fidelity).
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np


# =============================================================================
# constants
# =============================================================================

LP_OMEGA_TAU_DEFAULT: float = 4.29268
LP_DELTA_OVER_OMEGA_DEFAULT: float = 0.377371
LP_XI_DEFAULT: float = 3.90242

# (protocols.py:369-379) V/Omega -> (delta_over_omega, omega_tau_single)
LP_PARAMS_BY_V_OMEGA: Dict = {
    10: (0.340, 4.45),
    25: (0.360, 4.35),
    50: (0.370, 4.32),
    100: (0.375, 4.30),
    200: (0.377, 4.293),
    500: (0.3773, 4.2927),
    1000: (0.37737, 4.29268),
    "inf": (0.377371, 4.29268),
}

# validated 5-segment bang-bang (protocols.py:296-301)
JP_SWITCHING_TIMES_VALIDATED: List[float] = [2.214, 8.823, 13.258, 19.867]
JP_PHASES_VALIDATED: List[float] = [np.pi / 2, 0.0, -np.pi / 2, 0.0, np.pi / 2]
JP_OMEGA_TAU_VALIDATED: float = 22.08

# original 7-segment (protocols.py:305-306)
JP_SWITCHING_TIMES_DEFAULT: List[float] = [0.3328, 0.5859, 3.4340, 3.5530, 4.1204, 6.7431]
JP_PHASES_DEFAULT: List[float] = [np.pi / 2, 0.0, -np.pi / 2, -np.pi / 2, 0.0, np.pi / 2, 0.0]

SMOOTH_JP_PARAMS: Dict = {
    "name": "smooth_jp",
    "A": 0.311 * np.pi,
    "omega_mod_ratio": 1.242,
    "phi_offset": 4.696,
    "delta_over_omega": 0.0205,
    "omega_tau": 10.09,
    "n_pulses": 1,
    "validated": True,
    "reference": "Evered et al., Nature 622, 268 (2023); Bluvstein thesis (2024)",
}

LEVINE_PICHLER_PARAMS: Dict = {
    "name": "levine_pichler",
    "delta_over_omega": LP_DELTA_OVER_OMEGA_DEFAULT,
    "omega_tau": LP_OMEGA_TAU_DEFAULT,
    "xi": LP_XI_DEFAULT,
    "n_pulses": 2,
    "total_omega_tau": 2 * LP_OMEGA_TAU_DEFAULT,
    "reference": "Levine et al., PRL 123, 170503 (2019)",
}

JP_BANGBANG_PARAMS: Dict = {
    "name": "jandura_pupillo",
    "omega_tau": JP_OMEGA_TAU_VALIDATED,
    "delta_over_omega": 0.0,
    "switching_times": list(JP_SWITCHING_TIMES_VALIDATED),
    "phases": list(JP_PHASES_VALIDATED),
    "n_pulses": 1,
    "reference": "Jandura & Pupillo, PRX Quantum 3, 010353 (2022)",
    "adapted_for_V_over_Omega": 200.0,
}

CZ_OPTIMAL_PARAMS = LEVINE_PICHLER_PARAMS  # alias, parity with reference exports


# =============================================================================
# dataclasses
# =============================================================================

@dataclass
class LPProtocolParameters:
    """(protocols.py:157-209)"""
    omega_tau: float = LP_OMEGA_TAU_DEFAULT
    delta_over_omega: float = LP_DELTA_OVER_OMEGA_DEFAULT
    xi: float = LP_XI_DEFAULT
    pulse_shape: str = "square"
    name: str = "levine_pichler"
    reference: str = "Levine et al., PRL 123, 170503 (2019)"
    adapted_for_V_over_Omega: Optional[float] = None
    n_pulses: int = 2

    @property
    def total_omega_tau(self) -> float:
        return 2.0 * self.omega_tau

    def get_gate_time(self, Omega: float) -> float:
        return self.total_omega_tau / Omega

    def to_dict(self) -> dict:
        return {
            "name": self.name, "delta_over_omega": self.delta_over_omega,
            "omega_tau": self.omega_tau, "xi": self.xi,
            "n_pulses": self.n_pulses, "total_omega_tau": self.total_omega_tau,
            "pulse_shape": self.pulse_shape, "reference": self.reference,
            "adapted_for_V_over_Omega": self.adapted_for_V_over_Omega,
        }


@dataclass
class JPProtocolParameters:
    """(protocols.py:212-287)"""
    omega_tau: float = JP_OMEGA_TAU_VALIDATED
    switching_times: List[float] = field(default_factory=lambda: list(JP_SWITCHING_TIMES_VALIDATED))
    phases: List[float] = field(default_factory=lambda: list(JP_PHASES_VALIDATED))
    name: str = "jandura_pupillo"
    reference: str = "Jandura & Pupillo, PRX Quantum 3, 010353 (2022)"
    adapted_for_V_over_Omega: Optional[float] = None
    n_pulses: int = 1

    @property
    def delta_over_omega(self) -> float:
        return 0.0

    @property
    def n_segments(self) -> int:
        return len(self.phases)

    def get_gate_time(self, Omega: float) -> float:
        return self.omega_tau / Omega

    def get_phase_at_time(self, omega_t: float) -> float:
        for i, ts in enumerate(self.switching_times):
            if omega_t < ts:
                return self.phases[i]
        return self.phases[-1]

    def to_dict(self) -> dict:
        return {
            "name": self.name, "omega_tau": self.omega_tau,
            "delta_over_omega": self.delta_over_omega,
            "switching_times": list(self.switching_times),
            "phases": list(self.phases), "n_pulses": self.n_pulses,
            "reference": self.reference,
            "adapted_for_V_over_Omega": self.adapted_for_V_over_Omega,
        }


LP_DEFAULT = LPProtocolParameters()
JP_DEFAULT = JPProtocolParameters(adapted_for_V_over_Omega=200.0)
JP_7SEG = JPProtocolParameters(
    name="jandura_pupillo_7seg", omega_tau=7.0,
    switching_times=list(JP_SWITCHING_TIMES_DEFAULT),
    phases=list(JP_PHASES_DEFAULT))


# =============================================================================
# retrieval
# =============================================================================

_LP_ALIASES = ("levine_pichler", "lp", "two_pulse")
_JP_BB_ALIASES = ("jandura_pupillo", "jp", "single_pulse", "time_optimal")
_SMOOTH_ALIASES = ("smooth_jp", "dark_state", "sinusoidal_jp")


def _normalize(protocol: str) -> str:
    return protocol.lower().replace("-", "_").replace(" ", "_")


def get_adaptive_protocol_params(protocol: str, V_over_Omega: float) -> dict:
    """Log-space interpolation over the LP lookup table.
    (protocols.py:562-651)"""
    p = _normalize(protocol)
    if p not in _LP_ALIASES:
        raise ValueError(
            f"V/Omega-adaptive lookup only supported for LP, got: {protocol}")
    if V_over_Omega < 10:
        warnings.warn(
            f"V/Omega = {V_over_Omega:.1f} < 10: blockade too weak for a "
            f"reliable CZ gate", UserWarning)
        V_over_Omega = 10.0
    elif V_over_Omega > 1000:
        V_over_Omega = 1000.0

    keys = sorted(k for k in LP_PARAMS_BY_V_OMEGA if k != "inf")
    lower = max((k for k in keys if k <= V_over_Omega), default=keys[0])
    upper = min((k for k in keys if k >= V_over_Omega), default=keys[-1])
    if lower == upper:
        d, ot = LP_PARAMS_BY_V_OMEGA[lower]
    else:
        t = (np.log(V_over_Omega) - np.log(lower)) / (np.log(upper) - np.log(lower))
        lo, hi = LP_PARAMS_BY_V_OMEGA[lower], LP_PARAMS_BY_V_OMEGA[upper]
        d = lo[0] + t * (hi[0] - lo[0])
        ot = lo[1] + t * (hi[1] - lo[1])
    return {"delta_over_omega": d, "omega_tau": ot,
            "adapted_for_V_over_Omega": V_over_Omega, "source": "adaptive_lookup"}


def get_protocol_params(protocol: str = "levine_pichler",
                        V_over_Omega: Optional[float] = None) -> dict:
    """Main protocol-parameter dispatch. (protocols.py:484-559)"""
    p = _normalize(protocol)
    if p in _LP_ALIASES:
        params = dict(LEVINE_PICHLER_PARAMS)
        if V_over_Omega is not None:
            params.update(get_adaptive_protocol_params(p, V_over_Omega))
        return params
    if p in _SMOOTH_ALIASES:
        return dict(SMOOTH_JP_PARAMS)
    if p in _JP_BB_ALIASES:
        return dict(JP_BANGBANG_PARAMS)
    raise ValueError(
        f"Unknown protocol: {protocol}. Use 'levine_pichler', "
        f"'jandura_pupillo', or 'smooth_jp'.")


def get_lp_protocol(V_over_Omega: Optional[float] = None,
                    pulse_shape: str = "square") -> LPProtocolParameters:
    """(protocols.py:658-711)"""
    if V_over_Omega is None:
        return LPProtocolParameters(pulse_shape=pulse_shape)
    a = get_adaptive_protocol_params("lp", V_over_Omega)
    return LPProtocolParameters(
        omega_tau=a["omega_tau"], delta_over_omega=a["delta_over_omega"],
        pulse_shape=pulse_shape,
        adapted_for_V_over_Omega=a["adapted_for_V_over_Omega"])


def get_jp_protocol(V_over_Omega: Optional[float] = None) -> dict:
    """Deprecated: returns smooth JP parameters. (protocols.py:714-740)"""
    warnings.warn("get_jp_protocol() is deprecated; use "
                  "get_protocol_params('smooth_jp').", DeprecationWarning,
                  stacklevel=2)
    return dict(SMOOTH_JP_PARAMS)


def compute_phase_shift_xi(Delta, Omega, tau):
    """Optimal LP second-pulse phase factor e^{i xi} (host/numpy).
    (protocols.py:747-819; Levine et al. PRL 123 170503 supplement)

    With y = Delta/|Omega|, s = |Omega| tau, a = sqrt(y^2+1), b = s a / 2:
        e^{i xi} = (a cos b + i y sin b) / (-a cos b + i y sin b)
    """
    absO = np.abs(Omega)
    if absO < 1e-10:
        return 1.0 + 0j
    y = Delta / absO
    s = absO * tau
    a = np.sqrt(y ** 2 + 1.0)
    b = s * a / 2.0
    num = a * np.cos(b) + 1j * y * np.sin(b)
    den = -a * np.cos(b) + 1j * y * np.sin(b)
    if np.abs(den) < 1e-12:
        return 1.0 + 0j
    return num / den


__all__ = [
    "LP_OMEGA_TAU_DEFAULT", "LP_DELTA_OVER_OMEGA_DEFAULT", "LP_XI_DEFAULT",
    "LP_PARAMS_BY_V_OMEGA", "JP_SWITCHING_TIMES_VALIDATED",
    "JP_PHASES_VALIDATED", "JP_OMEGA_TAU_VALIDATED",
    "JP_SWITCHING_TIMES_DEFAULT", "JP_PHASES_DEFAULT", "SMOOTH_JP_PARAMS",
    "LEVINE_PICHLER_PARAMS", "JP_BANGBANG_PARAMS", "CZ_OPTIMAL_PARAMS",
    "LPProtocolParameters", "JPProtocolParameters",
    "LP_DEFAULT", "JP_DEFAULT", "JP_7SEG",
    "get_protocol_params", "get_adaptive_protocol_params",
    "get_lp_protocol", "get_jp_protocol", "compute_phase_shift_xi",
]
