"""Move / Cool / Idle / Measure primitives for the neutral-atom platform.

Implements the reference's comment-only specs:
  Move    (primitives/move.py:1-29 + micro_physics/neutral_atoms/
           aod_slm_motion.py:13-18: Langevin transport
           m x'' = -m w^2 (x - x0(t)) - gamma x' + xi(t))
  Cool    (primitives/cooling.py:1-27: doppler/sideband/molasses methods)
  Idle    (primitives/idle.py:1-28: T1/T2/T2* error map, loss, heating)
  Measure (primitives/measurement.py:1-25 + micro_physics measurement spec:
           fluorescence confusion matrices)

Counterpart of the reference's `primitives/motion.py`, copied; host numpy.
With a calibration record attached, `Cool(method="sideband")` returns the
record's numbers and ignores `target_temperature`, as the reference does.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from ..core.constants import HBAR, KB, TWO_PI
from ..core.atom_data import get_species
from ..channels.pauli import (pauli_channel_superop, t1_t2_to_pauli_rates)
from .base import (CoolPrimitive, CoolResult, IdlePrimitive, IdleResult,
                   MeasurePrimitive, MeasureResult, MovePrimitive, MoveResult)


# =============================================================================
# Move: AOD tweezer transport
# =============================================================================

def minimum_jerk_trajectory(distance: float, duration: float, n: int = 64
                            ) -> np.ndarray:
    """Minimum-jerk profile x(t) = d (10 s^3 - 15 s^4 + 6 s^5), the standard
    low-heating AOD waveform. Returns (n, 2) [t, x]."""
    t = np.linspace(0.0, duration, n)
    s = t / max(duration, 1e-30)
    x = distance * (10 * s ** 3 - 15 * s ** 4 + 6 * s ** 5)
    return np.stack([t, x], axis=1)


class Move(MovePrimitive):
    """Tweezer transport with heating from trap-frame acceleration.

    Physics: for a harmonic trap of frequency w moved along x0(t), the
    coherent displacement excited is |alpha| = |F(x0'')(w)| / sqrt(2 hbar w / m)
    evaluated at the trap frequency; for a minimum-jerk ramp the spectral
    content at w falls steeply once duration >> 2pi/w. We use the standard
    adiabatic estimate  n_added ~ (a_max / (w^2 x_zpf w))^2 * S(w T)
    with S the min-jerk suppression factor, plus a loss probability from the
    trap-depth criterion a_max < U0' bound.
    """
    name = "move"

    def __init__(self, species: str = "Rb87",
                 trap_frequency: float = TWO_PI * 100e3,
                 trap_depth_K: float = 1e-3,
                 max_velocity: float = 0.5,       # [m/s], AOD scan limit
                 max_acceleration: Optional[float] = None):
        self.sp = get_species(species)
        self.omega = trap_frequency
        self.trap_depth_K = trap_depth_K
        self.max_velocity = max_velocity
        # default a_max: fraction of the trap's max restoring acceleration
        U0 = KB * trap_depth_K
        # harmonic estimate: a_trap_max ~ w * sqrt(2 U0 / m)
        self.max_acceleration = (max_acceleration if max_acceleration is not None
                                 else 0.1 * self.omega * np.sqrt(2 * U0 / self.sp.mass))

    def __call__(self, qubit_id: int = 0, start=0.0, end=1e-6,
                 duration: Optional[float] = None,
                 constraints: Optional[Dict] = None) -> MoveResult:
        d = float(abs(np.asarray(end) - np.asarray(start)))
        # min-jerk peak accel = 5.77 d / T^2 ; peak velocity = 1.875 d / T
        if duration is None:
            T_acc = np.sqrt(5.7735 * d / self.max_acceleration) if d > 0 else 0.0
            T_vel = 1.875 * d / self.max_velocity if d > 0 else 0.0
            duration = max(T_acc, T_vel, 2 * TWO_PI / self.omega if d > 0 else 0.0)
        traj = minimum_jerk_trajectory(d, max(duration, 1e-12))

        if d > 0 and duration > 0:
            a_pk = 5.7735 * d / duration ** 2
            x_zpf = np.sqrt(HBAR / (2 * self.sp.mass * self.omega))
            # spectral suppression of a min-jerk ramp at the trap frequency
            wT = self.omega * duration
            S = 1.0 / (1.0 + (wT / TWO_PI) ** 6)
            n_added = (a_pk / (self.omega ** 2 * x_zpf)) ** 2 * S
            heat_T = n_added * HBAR * self.omega / KB
            # loss: exponentially suppressed unless heating approaches depth
            depth_quanta = KB * self.trap_depth_K / (HBAR * self.omega)
            p_loss = float(np.clip(np.exp(-(depth_quanta * 0.1)
                                          / max(n_added, 1e-12)), 0.0, 1.0)) \
                if n_added > 1e-9 else 0.0
        else:
            n_added, heat_T, p_loss = 0.0, 0.0, 0.0

        return MoveResult(duration=float(duration), loss_probability=p_loss,
                          heating_quanta=float(n_added),
                          heating_temperature=float(heat_T),
                          trajectory=traj,
                          metadata={"distance_m": d, "qubit": qubit_id})


# =============================================================================
# Cool
# =============================================================================

class Cool(CoolPrimitive):
    """Cooling to a method-dependent temperature floor.
    (cooling.py:10-27 spec)"""
    name = "cool"

    METHODS = {
        # (floor_K_expr, duration_s, success, loss)
        "doppler": ("doppler", 2e-3, 0.999, 1e-3),
        "molasses": ("sub_doppler", 5e-3, 0.995, 2e-3),
        "sideband": ("ground", 20e-3, 0.99, 5e-3),
        "sympathetic": ("ground", 50e-3, 0.98, 1e-3),
    }

    def __init__(self, species: str = "Rb87",
                 trap_frequency: float = TWO_PI * 100e3,
                 linewidth: Optional[float] = None,
                 calibration=None):
        """calibration: an engine-driven sideband-cooling record
        (gate/cooling.py — exact Fock-ladder master equation). When
        present, method="sideband" returns the record's dynamics-derived
        duration / final nbar / ground-state fraction / loss instead of
        the METHODS table constants."""
        self.sp = get_species(species)
        self.omega = trap_frequency
        self.Gamma = linewidth or self.sp.intermediate_states[
            self.sp.default_intermediate].linewidth
        self.calibration = calibration

    def _floor(self, kind: str) -> float:
        if kind == "doppler":
            return HBAR * self.Gamma / (2 * KB)         # T_D = hbar Gamma / 2 kB
        if kind == "sub_doppler":
            return 10.0 * HBAR * self.Gamma / (2 * KB) / 100.0  # ~T_D/10
        # ground-state: nbar ~ 0.02
        return 0.02 * HBAR * self.omega / KB

    def __call__(self, qubit_id: int = 0,
                 target_temperature: Optional[float] = None,
                 method: str = "doppler") -> CoolResult:
        if method not in self.METHODS:
            raise ValueError(f"Unknown cooling method: {method}. "
                             f"Available: {list(self.METHODS)}")
        if method == "sideband" and self.calibration is not None:
            rec = self.calibration
            return CoolResult(
                duration=rec.duration,
                loss_probability=rec.error_rates["loss"],
                final_temperature=rec.metadata["final_temperature_K"],
                final_nbar=rec.error_rates["final_nbar"],
                success_probability=1.0
                - rec.error_rates["avg_gate_infidelity"],
                metadata={"method": "sideband",
                          "engine": rec.metadata.get("generator"),
                          "regime": rec.regime, "qubit": qubit_id})
        kind, dur, succ, loss = self.METHODS[method]
        floor = self._floor(kind)
        T_final = max(floor, target_temperature or 0.0)
        nbar = 1.0 / max(np.expm1(HBAR * self.omega / (KB * T_final)), 1e-12)
        return CoolResult(duration=dur, loss_probability=loss,
                          final_temperature=float(T_final),
                          final_nbar=float(nbar), success_probability=succ,
                          metadata={"method": method, "qubit": qubit_id})


# =============================================================================
# Idle
# =============================================================================

class Idle(IdlePrimitive):
    """Wait/decoherence: T1/T2 Pauli-twirled error map + background loss +
    heating. (idle.py:10-28 spec)"""
    name = "idle"

    def __init__(self, T1: float = 4.0, T2: float = 1.0,
                 background_loss_rate: float = 0.02,   # 1/s (trap lifetime 50s)
                 heating_rate_quanta_per_s: float = 10.0):
        self.T1, self.T2 = T1, T2
        self.background_loss_rate = background_loss_rate
        self.heating_rate = heating_rate_quanta_per_s

    def __call__(self, qubit_id: int = 0, duration: float = 1e-6) -> IdleResult:
        px, py, pz = t1_t2_to_pauli_rates(self.T1, self.T2, duration)
        probs = np.array([1.0 - px - py - pz, px, py, pz])
        error_map = pauli_channel_superop(probs, 1)
        p_loss = 1.0 - np.exp(-self.background_loss_rate * duration)
        return IdleResult(duration=duration, loss_probability=float(p_loss),
                          error_map=error_map, pauli_error_probs=probs,
                          T1=self.T1, T2=self.T2,
                          heating_quanta=self.heating_rate * duration,
                          metadata={"qubit": qubit_id})


# =============================================================================
# Measure
# =============================================================================

class Measure(MeasurePrimitive):
    """Fluorescence readout with confusion matrix.
    (measurement.py:11-25 spec)

    Bright/dark discrimination errors: eps_0 = P(read 1 | 0) from background
    counts / off-resonant pumping; eps_1 = P(read 0 | 1) from depumping and
    finite photon collection; loss during imaging for destructive readout.
    """
    name = "measure"

    def __init__(self, fidelity_0: float = 0.998, fidelity_1: float = 0.995,
                 duration: float = 10e-3, loss_probability: float = 5e-3,
                 destructive: bool = True):
        self.f0, self.f1 = fidelity_0, fidelity_1
        self._duration = duration
        self._loss = loss_probability
        self.destructive = destructive

    @property
    def confusion_matrix(self) -> np.ndarray:
        return np.array([[self.f0, 1 - self.f0],
                         [1 - self.f1, self.f1]])

    def __call__(self, qubit_id: int = 0, basis: str = "Z",
                 destructive: Optional[bool] = None,
                 state_probabilities: Optional[np.ndarray] = None,
                 rng: Optional[np.random.Generator] = None) -> MeasureResult:
        destructive = self.destructive if destructive is None else destructive
        outcome = None
        post = None
        if state_probabilities is not None:
            rng = rng or np.random.default_rng()
            true = int(rng.random() < state_probabilities[1])
            row = self.confusion_matrix[true]
            outcome = int(rng.random() < row[1])
            if not destructive:
                post = np.zeros(2)
                post[true] = 1.0
        return MeasureResult(duration=self._duration,
                             loss_probability=self._loss if destructive else self._loss / 10,
                             outcome=outcome,
                             fidelity=(self.f0 + self.f1) / 2,
                             confusion_matrix=self.confusion_matrix,
                             post_state=post,
                             metadata={"basis": basis, "qubit": qubit_id,
                                       "destructive": destructive})


__all__ = ["minimum_jerk_trajectory", "Move", "Cool", "Idle", "Measure"]
