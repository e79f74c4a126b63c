"""Engine-driven fluorescence readout: the counting master equation.

Implements the reference's neutral-atom measurement spec for real
(reference: src/qpu_simulator/micro_physics/neutral_atoms/
measurement.py:11-25 — "bright/dark state discrimination via photon
scattering, Poisson photon statistics, detection efficiency and
threshold, atom loss during measurement" -> confusion matrix, readout
fidelity, false positive/negative rates, loss, duration). The repo's
Measure primitive (primitives/motion.py) previously took the two
fidelities as ANALYTIC inputs; this module derives them from dynamics,
the same L0 standard as gate/ms_gate.py / cavity_gate.py / raman_gate.py.

Model — a jump process solved EXACTLY, not sampled
--------------------------------------------------
The joint distribution over (internal state, detected-photon count) is
evolved under the counting master equation on the truncated ladder
{bright, dark, lost} x {0..N_max}:

  detection   (b, n) -> (b, n+1)   rate eta * R_sc + R_bg
              (d, n) -> (d, n+1)   rate eta * R_dark + R_bg
  depump      (b, n) -> (d, n)     rate R_depump   (F=2 -> F'=2 -> F=1)
  repump      (d, n) -> (b, n)     rate R_repump   (off-resonant F=1 exc.)
  loss        (b, n) -> (X, n)     rate R_loss_b   (recoil heating /
              (d, n) -> (X, n)     rate R_loss_d    light-assisted)
  background  (X, n) -> (X, n+1)   rate R_bg       (counts keep arriving)

One matrix exponential of the (3(N+1))^2 generator — through the SAME
expm the gate engine uses (ops/expm.expm, its squaring chain kernel K2 on
the card) — gives the EXACT count distributions P(n | initial state),
including the
state-flip-during-integration distortions (a depumped bright atom's
truncated-Poisson tail) that closed-form Poisson models miss entirely.
The discrimination threshold is then chosen optimally from the exact
distributions, and the confusion matrix, SPAM-style error rates, loss,
and duration tradeoff all follow with no Monte-Carlo noise.

Rates from hardware parameters (spec's "detection laser power,
duration; scattering rate; collection efficiency; camera parameters"):
  R_sc     = (Gamma/2) s0/(1+s0+(2 delta/Gamma)^2)   saturation formula
  R_depump = R_sc * (Gamma / (2 delta_hf_excited))^2 * branching
  R_repump = R_sc * (Gamma / (2 delta_hf_ground))^2
  R_loss_b = R_sc * 2 E_recoil / U_trap  (recoil heat-out of the trap)

Counterpart of the reference's `gate/readout.py`. `_expm_engine` runs the
port's expm at float64 on `device` (the card by default: Pade-13, the
squaring count from the host 1-norm, K2 on its tiled route at the default
540 x 540 generator) and makes one copy back. The reference meant to do the
same on its device, but its float64 switch fails in the JAX it runs on and a
broad `except` sends every readout and cooling expm to scipy; the port is
held to scipy's numbers.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

import torch

from ..core.constants import TWO_PI
from ..ops.expm import expm, squarings_for


def _expm_engine(A: np.ndarray, device="cuda") -> np.ndarray:
    """exp(A) for a real generator: the port's expm at float64 on `device`
    (Pade-13 with the squaring count the host 1-norm needs), one copy of
    A to the device and one of exp(A) back."""
    A = np.asarray(A, np.float64)
    ms = squarings_for(np.abs(A).sum(axis=0).max(), "pade13")
    E = expm(torch.as_tensor(A, device=torch.device(device)),
             max_squarings=ms, method="pade13")
    E = E.cpu().numpy()
    return E


@dataclass
class ReadoutSimResult:
    """Spec contract (measurement.py:20-25 outputs) + extras."""
    duration: float
    confusion_matrix: np.ndarray        # (2,2): [true 0, true 1] rows
    fidelity: float                     # (F_00 + F_11)/2
    false_positive: float               # P(read 1 | true 0)
    false_negative: float               # P(read 0 | true 1)
    loss_probability_bright: float
    loss_probability_dark: float
    threshold: int                      # counts >= threshold -> "1"
    mean_counts_bright: float
    mean_counts_dark: float
    count_distributions: Dict[str, np.ndarray] = field(default_factory=dict)
    error_budget: Dict[str, float] = field(default_factory=dict)
    parameters: Dict = field(default_factory=dict)

    def print_summary(self) -> None:
        print(f"fluorescence readout: t = {self.duration*1e3:.2f} ms, "
              f"F = {self.fidelity:.6f} (eps01 {self.false_positive:.2e} "
              f"eps10 {self.false_negative:.2e}), thresh "
              f"{self.threshold} counts "
              f"({self.mean_counts_dark:.1f} dark / "
              f"{self.mean_counts_bright:.1f} bright)")


def _count_generator(n_max: int, lam_b: float, lam_d: float, lam_x: float,
                     r_bd: float, r_db: float, r_xb: float, r_xd: float
                     ) -> np.ndarray:
    """Generator of the counting master equation, states ordered
    (s, n) -> s * (n_max+1) + n with s in {0:bright, 1:dark, 2:lost}."""
    m = n_max + 1
    dim = 3 * m
    G = np.zeros((dim, dim))

    def idx(s, n):
        return s * m + n

    for n in range(m):
        # photon detections (top count bin absorbs: no exit)
        for s, lam in ((0, lam_b), (1, lam_d), (2, lam_x)):
            if n < n_max:
                G[idx(s, n + 1), idx(s, n)] += lam
                G[idx(s, n), idx(s, n)] -= lam
        # internal-state jumps (count preserved)
        G[idx(1, n), idx(0, n)] += r_bd
        G[idx(0, n), idx(0, n)] -= r_bd
        G[idx(0, n), idx(1, n)] += r_db
        G[idx(1, n), idx(1, n)] -= r_db
        G[idx(2, n), idx(0, n)] += r_xb
        G[idx(0, n), idx(0, n)] -= r_xb
        G[idx(2, n), idx(1, n)] += r_xd
        G[idx(1, n), idx(1, n)] -= r_xd
    return G


def simulate_fluorescence_readout(
        duration: float = 2e-3,
        gamma: float = TWO_PI * 6.07e6,      # D2 linewidth (Rb87)
        s0: float = 0.05,                    # probe saturation parameter
        delta: float = -TWO_PI * 3e6,        # probe detuning [rad/s]
        eta: float = 0.1,                    # photon collection*QE (high NA)
        delta_hf_excited: float = TWO_PI * 267e6,   # F'=3 - F'=2 (Rb87)
        delta_hf_ground: float = TWO_PI * 6.835e9,  # ground hyperfine
        branching_to_dark: float = 0.5,      # F'=2 decay branch to F=1
        background_rate: float = 50.0,       # detected cts/s (camera+stray)
        recoil_energy_over_trap: float = 2.4e-6,  # 2 E_rec / U_0
        dark_scatter_fraction: float = 0.0,  # extra dark-state signal
        n_max: Optional[int] = None,
        threshold: Optional[int] = None,
        device="cuda") -> ReadoutSimResult:
    """Exact confusion matrix for fluorescence readout (see module doc).

    Defaults model a tweezer-array Rb87 readout: 10% collection (eta = 0.1,
    high NA), a 2 ms window, F=2 bright / F=1 dark imaging on the D2
    cycling transition; the count ladder then has n_max = 179 (a 540 x 540
    generator). The expm runs on `device`.
    """
    R_sc = 0.5 * gamma * s0 / (1.0 + s0 + (2.0 * delta / gamma) ** 2)
    R_depump = R_sc * (gamma / (2.0 * delta_hf_excited)) ** 2 \
        * branching_to_dark
    R_repump = R_sc * (gamma / (2.0 * delta_hf_ground)) ** 2
    R_loss_b = R_sc * recoil_energy_over_trap
    R_loss_d = R_repump * recoil_energy_over_trap
    lam_b = eta * R_sc + background_rate
    lam_d = eta * (dark_scatter_fraction * R_sc + R_repump) \
        + background_rate
    lam_x = background_rate

    if n_max is None:
        mean = lam_b * duration
        n_max = int(max(32, mean + 8.0 * np.sqrt(mean) + 8))
    if n_max > 1024:
        raise ValueError(
            f"count ladder n_max={n_max} (mean ~{lam_b * duration:.0f} "
            "detected photons) exceeds the exact-expm budget; lower "
            "s0/eta/duration or pass an explicit binned n_max")

    G = _count_generator(n_max, lam_b, lam_d, lam_x,
                         R_depump, R_repump, R_loss_b, R_loss_d)
    E = _expm_engine(G * duration, device)
    m = n_max + 1
    # initial states: pure bright (s=0, n=0) and pure dark (s=1, n=0)
    p_b = E[:, 0]
    p_d = E[:, m]
    # marginal count distributions (sum over internal state)
    pn_bright = p_b[:m] + p_b[m:2 * m] + p_b[2 * m:]
    pn_dark = p_d[:m] + p_d[m:2 * m] + p_d[2 * m:]
    loss_b = float(p_b[2 * m:].sum())
    loss_d = float(p_d[2 * m:].sum())

    cdf_b = np.cumsum(pn_bright)          # P(n <= k | bright)
    cdf_d = np.cumsum(pn_dark)
    if threshold is None:
        # optimal threshold: maximize (P(n>=t|b) + P(n<t|d))/2 over t
        # P(n >= t) = 1 - cdf[t-1]; t=0 reads everything as bright
        score = np.empty(m + 1)
        score[0] = 0.5 * (1.0 + 0.0)
        score[1:] = 0.5 * ((1.0 - cdf_b[:m]) + cdf_d[:m])
        threshold = int(np.argmax(score))
    t = threshold
    p_read1_given_1 = float(1.0 - (cdf_b[t - 1] if t > 0 else 0.0))
    p_read1_given_0 = float(1.0 - (cdf_d[t - 1] if t > 0 else 0.0))
    f11 = p_read1_given_1
    f00 = 1.0 - p_read1_given_0
    cm = np.array([[f00, 1.0 - f00], [1.0 - f11, f11]])

    # error budget: exact single-mechanism ablations would need 4 more
    # expms; first-order analytic shares are enough to rank sources
    mean_b = float(np.dot(np.arange(m), pn_bright))
    mean_d = float(np.dot(np.arange(m), pn_dark))
    budget = {
        "depump_bright_to_dark": R_depump * duration,
        "repump_dark_to_bright": R_repump * duration,
        "background_counts_dark": background_rate * duration,
        "shot_noise_overlap": float(np.minimum(pn_bright, pn_dark).sum()),
        "loss_bright": loss_b,
        "truncation_tail": float(pn_bright[-1]),
    }
    return ReadoutSimResult(
        duration=duration, confusion_matrix=cm,
        fidelity=0.5 * (f00 + f11),
        false_positive=1.0 - f00, false_negative=1.0 - f11,
        loss_probability_bright=loss_b, loss_probability_dark=loss_d,
        threshold=t, mean_counts_bright=mean_b, mean_counts_dark=mean_d,
        count_distributions={"bright": pn_bright, "dark": pn_dark},
        error_budget=budget,
        parameters={"gamma": gamma, "s0": s0, "delta": delta, "eta": eta,
                    "R_sc": R_sc, "R_depump": R_depump,
                    "R_repump": R_repump, "background_rate":
                    background_rate, "n_max": n_max,
                    "engine": "counting master equation, exact expm"})


def readout_calibration_record(result: ReadoutSimResult, regime: str):
    """CalibrationRecord for the store (platform neutral_atoms /
    operation readout) — consumed by primitives.motion.Measure via
    NeutralAtomBackend."""
    from ..channels.calibration import CalibrationRecord
    cm = result.confusion_matrix
    return CalibrationRecord(
        platform="neutral_atoms", operation="readout", regime=regime,
        parameters={k: float(v) for k, v in result.parameters.items()
                    if isinstance(v, (int, float))},
        error_rates={
            "avg_gate_infidelity": 1.0 - result.fidelity,
            "false_positive": result.false_positive,
            "false_negative": result.false_negative,
            "loss_bright": result.loss_probability_bright,
            "loss_dark": result.loss_probability_dark,
        },
        duration=result.duration,
        pauli_error_probs=None, pauli_labels=None, superop=None,
        metadata={
            "generator": "noisyquantumsimulator_tpu_torch.gate.readout",
            "confusion_matrix": cm.tolist(),
            "threshold_counts": int(result.threshold),
            "mean_counts_bright": result.mean_counts_bright,
            "mean_counts_dark": result.mean_counts_dark,
            "error_budget": {k: float(v)
                             for k, v in result.error_budget.items()},
        })


__all__ = ["ReadoutSimResult", "simulate_fluorescence_readout",
           "readout_calibration_record"]
