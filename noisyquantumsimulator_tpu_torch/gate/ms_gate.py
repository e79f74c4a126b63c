"""Engine-driven Moelmer-Soerensen gate: a real Lindblad simulation on the
spin (x) spin (x) motional Hilbert space.

Implements the reference's trapped-ion micro-physics contract
(reference: src/qpu_simulator/micro_physics/trapped_ions/qccd/gates.py:1-28
"MS gate -> CPTP map, duration, crosstalk") as a SIMULATION through the
shared Lindblad machinery, not a formula sheet: the analytic error budget
in physics/trapped_ions.ms_gate is a cross-check of this engine.

Physics. Two ions (qubits) share one motional mode (Fock-truncated,
n_fock levels; total dim D = 4 n_fock). A bichromatic field detuned
+-delta from the red/blue sidebands gives, in the Lamb-Dicke interaction
picture,

    H(t) = (Omega0/2) S_x (B e^{-i delta t} + B^dag e^{+i delta t}),
    S_x  = sigma_x^(1) + sigma_x^(2),

where B is the sideband lowering operator. Moving to the frame rotating
with the mode at delta makes H exactly TIME-INDEPENDENT,

    H_rot = -delta a^dag a + (Omega0/2) S_x (B + B^dag),

and because every collapse operator here is either number-conserving or a
pure ladder (heating a/a^dag, dephasing a^dag a, qubit Paulis), the
dissipators are invariant under the number-frame rotation — the rotating
frame Lindbladian is constant EXACTLY. At the closure time
tau = 2 pi K / delta the frame transform exp(-i delta tau a^dag a) is the
identity on the integer Fock spectrum, so

    E_gate = exp(L_rot tau)      (one batched expm, zero discretization)

computed through the port's expm (gate/open_system.qubit_channel_device:
Pade-13 at complex128, its squaring chain kernel K2 on the card). The
maximally-entangling condition is
eta Omega0 = delta / (2 sqrt(K)), giving U_ideal = exp(+i pi/4 X X) up to
a global phase (sign verified numerically against the engine).

Beyond-Lamb-Dicke thermal error. With exact_lamb_dicke=False (default)
the sideband operator carries the exact Fock matrix elements

    <n+1| B^dag |n> = eta e^{-eta^2/2} L_n^1(eta^2) / sqrt(n+1)

(L generalized Laguerre), i.e. the Debye-Waller factor and its
n-dependence. The amplitude is calibrated on the n=0 element (standard
sideband calibration), so the residual is the thermal SPREAD of the
coupling — the eta^4 nbar "thermal" error the analytic model estimates
with (pi^2/2) nbar eta^4; here it emerges from the dynamics.

Motional dephasing. Two models: "markovian" (collapse a^dag a at rate
1/tau_coh — exponential coherence decay) and the default "quasistatic"
(slow mode-frequency drift: Gauss-Hermite average of the channel over a
static detuning offset ~ N(0, sigma^2), sigma = sqrt(2)/tau_coh so free
coherence decays as exp(-(t/tau_coh)^2) — the regime behind the analytic
~ (tau/tau_coh)^2 / 2 budget entry). The GH average is a BATCHED expm:
the nodes of a noise case are one call.

Counterpart of the reference's `gate/ms_gate.py`. engine="device" (the
default; the reference's "jax") runs each noise case's stack through
`qubit_channel_device` on `device`; engine="host" stays the scipy oracle.
At the defaults (n_fock = 10, gh_nodes = 7) a call is 7 device calls and 19
expms of (1600, 1600) complex128 Liouvillians. The record's parameters are
the "full" case's: the reference takes them from the last case of its loop
("scattering", nbar 0.0) and so stores nbar 0.0 whatever the run's nbar.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from ..core.constants import TWO_PI
from ..physics.trapped_ions import ION_MASSES, lamb_dicke_parameter

__all__ = ["MSGateSimResult", "build_ms_system", "simulate_ms_gate",
           "ms_calibration_record"]


# --------------------------------------------------------------------------
# operators (host numpy, complex128 — offline calibration-scale work)
# --------------------------------------------------------------------------

# shared through gate/open_system.py under the reference's private names
from .open_system import I2 as _I2
from .open_system import SX as _SX
from .open_system import SY as _SY
from .open_system import SZ as _SZ
from .open_system import gh_nodes as _gh_nodes
from .open_system import kron3 as _two_ion_mode
from .open_system import propagators_host as _propagators_host
from .open_system import qubit_channel_device as _qubit_channel_device
from .open_system import qubit_channel_host as _qubit_channel_from_props
from .open_system import thermal_state as _thermal_state


def _sideband_lowering(n_fock: int, eta: float,
                       exact_lamb_dicke: bool) -> np.ndarray:
    """B with <n|B|n+1> = the exact red-sideband matrix element of
    e^{i eta (a + a^dag)} (magnitude), reducing to eta a at eta -> 0."""
    n = np.arange(n_fock - 1, dtype=float)
    if exact_lamb_dicke:
        from scipy.special import eval_genlaguerre
        amp = (eta * np.exp(-eta * eta / 2.0)
               * eval_genlaguerre(n, 1, eta * eta) / np.sqrt(n + 1.0))
    else:
        amp = eta * np.sqrt(n + 1.0)
    B = np.zeros((n_fock, n_fock), dtype=complex)
    B[np.arange(n_fock - 1), np.arange(1, n_fock)] = amp
    return B


def build_ms_system(
    n_fock: int = 10,
    eta: float = 0.1,
    detuning_from_mode: float = TWO_PI * 20e3,
    n_loops: int = 1,
    nbar: float = 0.05,
    heating_rate_quanta_per_s: float = 0.0,
    motional_dephasing_rate: float = 0.0,
    laser_dephasing_rate: float = 0.0,
    scattering_rate: float = 0.0,
    exact_lamb_dicke: bool = True,
    amplitude_error: float = 0.0,
):
    """Assemble (H_rot, c_ops, tau, meta) for the rotating-frame MS gate.

    The drive amplitude is set by the closure condition
    eta Omega0 = delta / (2 sqrt(K)) and calibrated on the n=0 sideband
    element (so the Debye-Waller factor is absorbed, its thermal SPREAD
    is not). amplitude_error is a fractional miscalibration.
    """
    delta = detuning_from_mode
    K = n_loops
    tau = TWO_PI * K / delta

    B = _sideband_lowering(n_fock, eta, exact_lamb_dicke)
    # calibrate Omega0 so the n=0 coupling equals the ideal eta*Omega/2
    # with eta Omega = delta / (2 sqrt(K)): <1|B^dag|0> replaces eta.
    b0 = float(np.abs(B[0, 1]))
    Omega0 = delta / (2.0 * np.sqrt(K)) / b0
    Omega0 *= (1.0 + amplitude_error)

    Im = np.eye(n_fock, dtype=complex)
    a = np.zeros((n_fock, n_fock), dtype=complex)
    a[np.arange(n_fock - 1), np.arange(1, n_fock)] = \
        np.sqrt(np.arange(1, n_fock, dtype=float))
    num = a.conj().T @ a

    Sx = (_two_ion_mode(_SX, _I2, Im) + _two_ion_mode(_I2, _SX, Im))
    Bfull = _two_ion_mode(_I2, _I2, B)
    Nfull = _two_ion_mode(_I2, _I2, num)

    H_rot = (-delta * Nfull
             + 0.5 * Omega0 * (Sx @ (Bfull + Bfull.conj().T)))

    c_ops: List[np.ndarray] = []
    if heating_rate_quanta_per_s > 0:
        # infinite-temperature bath limit (electric-field noise): equal
        # up/down rates ndot
        g = np.sqrt(heating_rate_quanta_per_s)
        afull = _two_ion_mode(_I2, _I2, a)
        c_ops.append(g * afull.conj().T)
        c_ops.append(g * afull)
    if motional_dephasing_rate > 0:
        # markovian model: coherence <n|rho|m> decays at
        # rate/2 * (n - m)^2 — c = sqrt(rate/2) a^dag a gives exactly
        # exp(-rate t / 2 (n-m)^2); for |0>-|1> that is exp(-rate t / 2)
        c_ops.append(np.sqrt(motional_dephasing_rate / 2.0) * Nfull)
    if laser_dephasing_rate > 0:
        # per-ion qubit dephasing: c = sqrt(rate/2) sigma_z gives qubit
        # coherence decay exp(-rate t) (T2_laser = 1/rate)
        g = np.sqrt(laser_dephasing_rate / 2.0)
        c_ops.append(g * _two_ion_mode(_SZ, _I2, Im))
        c_ops.append(g * _two_ion_mode(_I2, _SZ, Im))
    if scattering_rate > 0:
        # per-ion depolarizing proxy for Raman scattering; the TOTAL
        # (two-ion) event rate is scattering_rate, split rate/2 per ion,
        # rate/6 per Pauli
        g = np.sqrt(scattering_rate / 6.0)
        for P in (_SX, _SY, _SZ):
            c_ops.append(g * _two_ion_mode(P, _I2, Im))
            c_ops.append(g * _two_ion_mode(_I2, P, Im))

    meta = dict(n_fock=n_fock, eta=eta, delta=delta, n_loops=K, tau=tau,
                Omega0=Omega0, nbar=nbar,
                exact_lamb_dicke=exact_lamb_dicke,
                amplitude_error=amplitude_error)
    return H_rot, c_ops, tau, meta


# --------------------------------------------------------------------------
# channel extraction
# --------------------------------------------------------------------------

# U_ideal = exp(-i pi/4 XX): sign fixed by the engine's own noiseless run
# (blue-detuned drive accumulates geometric phase exp(-i Phi S_x^2),
# Phi = pi/8 at closure; verified numerically — the +i target scores
# F = 0.2, the -i target 0.999998 at n_fock = 8, nbar = 0).
def _ideal_ms_unitary() -> np.ndarray:
    XX = np.kron(_SX, _SX)
    return (np.cos(np.pi / 4) * np.eye(4) - 1j * np.sin(np.pi / 4) * XX)


@dataclass
class MSGateSimResult:
    """Spec contract (qccd/gates.py:20-28) + the engine-level extras."""
    duration: float
    fidelity: float                  # avg gate fidelity vs exp(i pi/4 XX)
    error_map_pauli: np.ndarray      # (16,) twirled 2-qubit error probs
    crosstalk: float
    error_budget: Dict[str, float] = field(default_factory=dict)
    superop: Optional[np.ndarray] = None     # (16,16) qubit channel
    process_fidelity: float = 0.0
    completely_positive: bool = True
    trace_preserving: bool = True
    leakage: float = 0.0             # population left outside the qubit
    parameters: Dict = field(default_factory=dict)

    def print_summary(self) -> None:
        print(f"MS gate: tau = {self.duration * 1e6:.1f} us, "
              f"F_avg = {self.fidelity:.6f}")
        for k, v in sorted(self.error_budget.items(),
                           key=lambda kv: -kv[1]):
            print(f"  {k:>22s}: {v:.2e}")


def simulate_ms_gate(
    species: str = "Yb171",
    omega_mode: float = TWO_PI * 3e6,
    nbar: float = 0.05,
    heating_rate_quanta_per_s: float = 100.0,
    motional_coherence_time: float = 10e-3,
    laser_coherence_time: float = 1.0,
    scattering_rate: float = 1.0,
    detuning_from_mode: float = TWO_PI * 20e3,
    k_eff: float = 2.0 * TWO_PI / 355e-9,
    n_loops: int = 1,
    neighbor_mode_splitting: float = TWO_PI * 1e6,
    n_fock: int = 10,
    exact_lamb_dicke: bool = True,
    amplitude_error: float = 0.0,
    motional_dephasing_model: str = "quasistatic",
    gh_nodes: int = 7,
    engine: str = "device",
    include_budget: bool = True,
    device="cuda",
) -> MSGateSimResult:
    """Simulate the MS gate through the Lindblad engine and extract the
    CPTP qubit channel (the analytic physics/trapped_ions.ms_gate keeps the
    same signature prefix and is the cross-check, not the product).

    engine="device" exponentiates on `device` (complex128), engine="host"
    with scipy."""
    from ..channels.conversions import (average_gate_fidelity, is_cptp,
                                        process_fidelity, unitary_superop)
    from ..channels.pauli import twirled_error_probs
    from ..ops.lindblad import dissipator_superop, hamiltonian_superop

    mass = ION_MASSES[species]
    eta = lamb_dicke_parameter(mass, omega_mode, k_eff)
    if motional_dephasing_model not in ("quasistatic", "markovian"):
        raise ValueError("motional_dephasing_model must be 'quasistatic' "
                         "or 'markovian'")
    quasistatic = motional_dephasing_model == "quasistatic"
    gamma_mot = (0.0 if (quasistatic or motional_coherence_time <= 0)
                 else 1.0 / motional_coherence_time)

    def liouvillian_stack(heating, mot_rate, las_rate, sc_rate, nb,
                          quasi_sigma):
        H, c_ops, tau, meta = build_ms_system(
            n_fock=n_fock, eta=eta,
            detuning_from_mode=detuning_from_mode, n_loops=n_loops,
            nbar=nb, heating_rate_quanta_per_s=heating,
            motional_dephasing_rate=mot_rate,
            laser_dephasing_rate=las_rate, scattering_rate=sc_rate,
            exact_lamb_dicke=exact_lamb_dicke,
            amplitude_error=amplitude_error)
        D = H.shape[0]
        L = hamiltonian_superop(H) + dissipator_superop(c_ops, D)
        if quasi_sigma > 0:
            # static mode-frequency offsets: L + eps * superop(-[N, .])
            num = np.zeros((n_fock, n_fock), dtype=complex)
            np.fill_diagonal(num, np.arange(n_fock, dtype=float))
            Nfull = _two_ion_mode(_I2, _I2, num)
            LN = hamiltonian_superop(Nfull)
            eps, w = _gh_nodes(gh_nodes, quasi_sigma)
            return np.stack([L + e * LN for e in eps]), w, tau, meta
        return L[None], np.ones(1), tau, meta

    las_rate = (1.0 / laser_coherence_time
                if laser_coherence_time > 0 else 0.0)
    sigma_q = (np.sqrt(2.0) / motional_coherence_time
               if (quasistatic and motional_coherence_time > 0) else 0.0)

    cases = {"full": (heating_rate_quanta_per_s, gamma_mot, las_rate,
                      scattering_rate, nbar, sigma_q)}
    if include_budget:
        cases.update({
            "floor": (0.0, 0.0, 0.0, 0.0, 0.0, 0.0),
            "thermal": (0.0, 0.0, 0.0, 0.0, nbar, 0.0),
            "heating": (heating_rate_quanta_per_s, 0.0, 0.0, 0.0, 0.0, 0.0),
            "motional_dephasing": (0.0, gamma_mot, 0.0, 0.0, 0.0, sigma_q),
            "laser_dephasing": (0.0, 0.0, las_rate, 0.0, 0.0, 0.0),
            "scattering": (0.0, 0.0, 0.0, scattering_rate, 0.0, 0.0),
        })

    U_target = _ideal_ms_unitary()
    S_target = unitary_superop(U_target)
    fids: Dict[str, float] = {}
    chan_full = meta = None
    if engine not in ("device", "host"):
        raise ValueError("engine must be 'device' or 'host'")
    for name, (h, m, la, sc, nb, sq) in cases.items():
        Ls, w, tau, meta_case = liouvillian_stack(h, m, la, sc, nb, sq)
        rho_th = _thermal_state(n_fock, nb)
        if engine == "device":
            S16 = _qubit_channel_device(Ls, np.asarray(w), tau, rho_th,
                                        n_fock, device=device)
        else:
            props = _propagators_host(Ls, tau)
            S16 = _qubit_channel_from_props(props, w, rho_th, n_fock)
        del Ls
        fids[name] = average_gate_fidelity(S16, U_target)
        if name == "full":
            chan_full, meta = S16, meta_case

    F = fids["full"]
    floor = 1.0 - fids.get("floor", 1.0)
    budget = {}
    if include_budget:
        budget = {k: max(0.0, (1.0 - fids[k]) - floor)
                  for k in ("thermal", "heating", "motional_dephasing",
                            "laser_dephasing", "scattering")}
        budget["model_floor"] = floor
    # spectator-mode crosstalk stays analytic: the neighbouring mode is
    # outside this Hilbert space (documented limitation; the formula is
    # the same leading-order estimate the analytic module used)
    eps_spect = (detuning_from_mode / neighbor_mode_splitting) ** 2 / 2.0
    budget["spectator_mode(analytic)"] = eps_spect

    cp, tp = is_cptp(chan_full)
    # trace deficit on the maximally-mixed input = population pushed past
    # the Fock truncation (the only way trace can leave this model)
    out_mm = (chan_full @ (np.eye(4).reshape(16) / 4.0)).reshape(4, 4)
    leakage = float(max(0.0, 1.0 - np.real(np.trace(out_mm))))
    probs = twirled_error_probs(chan_full, U_target)

    params = dict(meta, species=species, omega_mode=omega_mode,
                  heating_rate_quanta_per_s=heating_rate_quanta_per_s,
                  motional_coherence_time=motional_coherence_time,
                  laser_coherence_time=laser_coherence_time,
                  scattering_rate=scattering_rate,
                  motional_dephasing_model=motional_dephasing_model,
                  engine=engine)
    return MSGateSimResult(
        duration=float(tau), fidelity=float(F),
        error_map_pauli=np.asarray(probs, dtype=float),
        crosstalk=float(eps_spect + 0.1 * budget.get("thermal", 0.0)),
        error_budget=budget, superop=chan_full,
        process_fidelity=float(process_fidelity(chan_full, U_target)),
        completely_positive=bool(cp), trace_preserving=bool(tp),
        leakage=leakage, parameters=params)


def ms_calibration_record(result: MSGateSimResult, regime: str):
    """CalibrationRecord for the trapped-ion backend (same store/schema as
    the Rydberg CZ path, calibration_data/README.md)."""
    from ..channels.calibration import (CalibrationRecord,
                                        _complex_matrix_to_json)
    from ..channels.conversions import pauli_basis
    labels, _ = pauli_basis(2)
    return CalibrationRecord(
        platform="trapped_ions",
        operation="ms_gate",
        regime=regime,
        parameters={k: v for k, v in result.parameters.items()
                    if isinstance(v, (int, float, str, bool))},
        error_rates={
            "avg_gate_infidelity": 1.0 - result.fidelity,
            "process_infidelity": 1.0 - result.process_fidelity,
            "leakage_mean": result.leakage,
            "crosstalk": result.crosstalk,
        },
        duration=result.duration,
        pauli_error_probs=[float(p) for p in result.error_map_pauli],
        pauli_labels=list(labels),
        superop=_complex_matrix_to_json(result.superop),
        metadata={"generator": "noisyquantumsimulator_tpu_torch.gate.ms_gate",
                  "error_budget": {k: float(v) for k, v in
                                   result.error_budget.items()}},
    )
