"""simulate_cz_gate — the Layer-0 CZ gate engine (PyTorch / CUDA).

Counterpart of the reference's `gate/simulate.py`
(reference: rydberg_gates/simulation.py:2534-3676 `simulate_CZ_gate`).
The pipeline is split into two stages:

  plan_cz_gate(...)   host-side config resolution (steps 0-9): species
                      lookups, protocol tables, noise rates, warnings —
                      produces a GatePlan of host arrays + metadata.
  run_plan(plan)      the device compute (steps 10-11) on the plan's
                      device and dtype: one expm for the base propagator
                      (CUDA kernel K2 squares it), the phase-frame scan of
                      the five initial states in the real Hermitian basis
                      (CUDA kernel K1), then fidelity + controlled-phase
                      extraction. Schedules that are not phase-frame
                      eligible take the per-segment expm + ordered product.

`plan_from_numpy` builds a plan from bare arrays (e.g. the reference
package's GatePlan fields), so both packages can run one plan.
"""
from __future__ import annotations

import dataclasses
import warnings
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..core.constants import KB, TWO_PI
from ..core.configs import (AtomicConfiguration, JPSimulationInputs,
                            LPSimulationInputs, SmoothJPSimulationInputs)
from ..core.atom_data import get_C6, get_species
from ..physics import protocols as proto
from ..physics.laser import (laser_E0, rydberg_blockade, single_photon_rabi,
                             two_photon_rabi)
from ..physics.noise_rates import (leakage_rate_to_adjacent_states,
                                   mJ_mixing_rate, rydberg_zeeman_splitting,
                                   zeeman_dephasing_rate)
from ..physics.pulses import area_correction_factor, get_pulse_envelope
from ..physics.trap import (calculate_qubit_stark_shift, calculate_zeeman_shift,
                            compute_trap_dependent_noise, tweezer_spacing)
from ..ops.hilbert import HS3, HS4, kets_to_density, two_atom_kets
from ..ops.lindblad import (build_all_noise_operators, drive_decomposition,
                            static_hamiltonian)
from ..ops.phase_frame import phase_frame_generator
from ..solver.propagator import (Schedule, evolve_rhos, real_dtype,
                                 uniform_base_propagator)
from ..solver.real_rep import (build_real_rep, evolve_real_phased,
                               from_real_coords, real_propagator_device,
                               to_real_coords)
from .fidelity import compute_cz_fidelity

SimInputs = Union[LPSimulationInputs, JPSimulationInputs, SmoothJPSimulationInputs]

OMEGA_MAX_PHYSICAL = TWO_PI * 100e6   # (simulation.py:2924)
OMEGA_MIN_PRACTICAL = TWO_PI * 0.1e6  # (simulation.py:2926)


@dataclass
class GatePlan:
    """Resolved, array-valued description of one CZ gate simulation.

    The arrays are host numpy (complex128), as the planner builds them;
    `device` and `dtype` say where and in what precision run_plan computes.
    Metadata fields have defaults so plan_from_numpy can build a plan from
    bare arrays."""
    # device inputs
    L0: np.ndarray
    Cp: np.ndarray
    Cm: np.ndarray
    schedule: Schedule
    rho0s: np.ndarray            # (5, D, D)
    kets: Dict[str, np.ndarray]
    # where run_plan computes
    device: Union[str, torch.device] = "cpu"
    dtype: torch.dtype = torch.complex128
    # metadata (host-side diagnostics)
    protocol: str = ""
    n_pulses: int = 1
    hilbert_space_dim: int = 3
    Omega: float = 0.0
    Omega1: float = 0.0
    Omega2: float = 0.0
    V: float = 0.0
    Delta: float = 0.0
    V_over_Omega: float = 0.0
    delta_over_omega: float = 0.0
    xi: complex = 1.0
    tau_single: float = 0.0
    tau_total: float = 0.0
    R: float = 0.0
    spacing_factor: float = 2.8
    U0_mK: float = 0.0
    omega_r_kHz: float = 0.0
    sigma_r_nm: float = 0.0
    trap_wavelength_nm: float = 1064.0
    magic_wavelength_analysis: Dict = field(default_factory=dict)
    noise_breakdown: Dict = field(default_factory=dict)
    include_noise: bool = True
    pulse_info: Dict = field(default_factory=dict)
    config: Optional[AtomicConfiguration] = None
    temperature_K: float = 2e-6
    B_field_T: float = 1e-4
    delta_zeeman: float = 0.0
    delta_stark: float = 0.0
    trap_laser_on: bool = True


@dataclass
class GateResult:
    """Simulation output — mirrors the reference SimulationResult
    (simulation.py:2238-2531)."""
    avg_fidelity: float
    fidelities: Dict[str, float]
    phase_info: Dict
    protocol: str
    n_pulses: int
    hilbert_space_dim: int
    Omega: float
    V: float
    Delta: float
    V_over_Omega: float
    tau_single: float
    tau_total: float
    R: float
    Delta_over_Omega: float = 0.0
    xi: complex = 1.0
    spacing_factor: float = 2.8
    U0_mK: float = 0.0
    omega_r_kHz: float = 0.0
    sigma_r_nm: float = 0.0
    trap_wavelength_nm: float = 1064.0
    magic_wavelength_analysis: Dict = field(default_factory=dict)
    noise_breakdown: Dict = field(default_factory=dict)
    include_noise: bool = True
    include_motional_dephasing: bool = True
    pulse_info: Dict = field(default_factory=dict)
    config: Optional[AtomicConfiguration] = None
    species: str = "Rb87"
    n_rydberg: int = 70
    qubit_0: Tuple[int, int] = (1, 0)
    qubit_1: Tuple[int, int] = (2, 0)
    temperature_K: float = 2e-6
    B_field_T: float = 1e-4
    delta_zeeman: float = 0.0
    delta_stark: float = 0.0
    trap_laser_on: bool = True
    results: Dict = field(default_factory=dict)

    @property
    def Omega_MHz(self):
        return self.Omega / (TWO_PI * 1e6)

    @property
    def V_MHz(self):
        return self.V / (TWO_PI * 1e6)

    @property
    def Delta_MHz(self):
        return self.Delta / (TWO_PI * 1e6)

    @property
    def gate_time_us(self):
        return self.tau_total * 1e6

    @property
    def R_um(self):
        return self.R * 1e6

    @property
    def xi_rad(self):
        return float(np.angle(self.xi))

    @property
    def xi_deg(self):
        return float(np.degrees(np.angle(self.xi)))

    @property
    def temperature_uK(self):
        return self.temperature_K * 1e6

    @property
    def B_field_Gauss(self):
        return self.B_field_T * 1e4

    def print_summary(self):
        print("=" * 70)
        print("CZ GATE SIMULATION RESULTS (noisyquantumsimulator_tpu_torch)")
        print("=" * 70)
        print(f"Average fidelity: {self.avg_fidelity:.6f} "
              f"({(1 - self.avg_fidelity) * 100:.4f}% error)")
        for state, fid in self.fidelities.items():
            print(f"  |{state}> -> {fid:.6f}")
        print(f"Protocol: {self.protocol} ({self.n_pulses} pulse(s), "
              f"{self.hilbert_space_dim}-level)")
        print(f"Omega/2pi = {self.Omega_MHz:.3f} MHz  V/2pi = {self.V_MHz:.2f} MHz  "
              f"V/Omega = {self.V_over_Omega:.1f}")
        print(f"Gate time: {self.gate_time_us:.3f} us   R = {self.R_um:.2f} um")
        if self.noise_breakdown:
            nb = self.noise_breakdown
            print(f"Noise: decay {nb.get('total_decay_rate', 0) / 1e3:.2f} kHz, "
                  f"dephasing {nb.get('total_dephasing_rate', 0) / 1e3:.2f} kHz, "
                  f"loss {nb.get('total_loss_rate', 0) / 1e3:.2f} kHz, "
                  f"{nb.get('n_collapse_ops', 0)} collapse ops")
        print("=" * 70)


# =============================================================================
# planning (host-side; steps 0-9 of the reference pipeline)
# =============================================================================

def plan_cz_gate(
    simulation_inputs: SimInputs,
    config: Optional[AtomicConfiguration] = None,
    species: str = "Rb87",
    n_rydberg: int = 70,
    qubit_0: Tuple[int, int] = (1, 0),
    qubit_1: Tuple[int, int] = (2, 0),
    hilbert_space_dim: int = 3,
    tweezer_power: float = 30e-3,
    tweezer_waist: float = 1.0e-6,
    tweezer_wavelength_nm: Optional[float] = None,
    temperature: float = 2e-6,
    B_field: float = 1e-4,
    NA: float = 0.5,
    spacing_factor: float = 2.8,
    include_noise: bool = True,
    background_loss_rate_hz: Optional[float] = None,
    trap_laser_on: bool = True,
    n_steps_smooth: int = 300,
    n_steps_shaped: int = 500,
    verbose: bool = False,
    device: Union[str, torch.device] = "cpu",
    dtype: torch.dtype = torch.complex128,
) -> GatePlan:
    """Steps 0-9: resolve every physical parameter into a GatePlan that
    run_plan computes on `device` in complex `dtype`."""
    # ---- step 0: protocol dispatch (simulation.py:2769-2793) ----
    if isinstance(simulation_inputs, LPSimulationInputs):
        protocol = "levine_pichler"
        pulse_shape = simulation_inputs.pulse_shape
        delta_over_omega = simulation_inputs.delta_over_omega
        omega_tau = simulation_inputs.omega_tau
    elif isinstance(simulation_inputs, SmoothJPSimulationInputs):
        protocol = "smooth_jp"
        pulse_shape = "smooth_sinusoidal"
        delta_over_omega = simulation_inputs.delta_over_omega
        omega_tau = simulation_inputs.omega_tau
    elif isinstance(simulation_inputs, JPSimulationInputs):
        protocol = "jandura_pupillo"
        pulse_shape = "bangbang"
        delta_over_omega = 0.0
        omega_tau = simulation_inputs.omega_tau
    else:
        raise TypeError(
            "simulation_inputs must be LPSimulationInputs, JPSimulationInputs "
            f"or SmoothJPSimulationInputs, got {type(simulation_inputs).__name__}")

    exc = simulation_inputs.excitation
    noise_cfg = simulation_inputs.noise
    Delta_e = exc.Delta_e

    # ---- step 1: Hilbert space + atomic configuration ----
    hs = HS3 if hilbert_space_dim == 3 else HS4
    if config is None:
        config = AtomicConfiguration(species=species, qubit_0=qubit_0,
                                     qubit_1=qubit_1, n_rydberg=n_rydberg,
                                     L_rydberg="S")
    sp = get_species(config.species)

    laser_linewidth_hz = float(np.sqrt(exc.laser_1.linewidth_hz ** 2
                                       + exc.laser_2.linewidth_hz ** 2))

    # ---- trap wavelength (simulation.py:2863-2878) ----
    if tweezer_wavelength_nm is not None:
        trap_wavelength = tweezer_wavelength_nm * 1e-9
    else:
        trap_wavelength = sp.trap_wavelength
    wavelength_nm = trap_wavelength * 1e9

    # ---- step 2: spacing (simulation.py:2887) ----
    R = float(tweezer_spacing(trap_wavelength, NA, spacing_factor))

    # ---- step 3: Rabi frequencies (simulation.py:2896-2912) ----
    E0_1 = float(laser_E0(exc.laser_1.power, exc.laser_1.waist))
    E0_2 = float(laser_E0(exc.laser_2.power, exc.laser_2.waist))
    dipole_1e = sp.intermediate_states[config.intermediate_state].dipole_from_ground
    dipole_er = (sp.dipole_intermediate_to_rydberg_ref
                 * (config.n_rydberg / sp.n_ref) ** (-1.5))
    Omega1 = float(single_photon_rabi(dipole_1e, E0_1))
    Omega2 = float(single_photon_rabi(dipole_er, E0_2))
    Omega = float(two_photon_rabi(Omega1, Omega2, Delta_e))

    if Omega <= 0:
        raise ValueError(
            "Effective two-photon Rabi frequency is zero — check laser "
            f"powers (P1={exc.laser_1.power} W, P2={exc.laser_2.power} W).")
    if Omega > OMEGA_MAX_PHYSICAL:
        warnings.warn(f"Omega/2pi = {Omega / TWO_PI / 1e6:.1f} MHz exceeds the "
                      f"~100 MHz physical limit; check laser powers.",
                      UserWarning)
    if Omega < OMEGA_MIN_PRACTICAL:
        warnings.warn(f"Omega/2pi = {Omega / TWO_PI / 1e3:.1f} kHz is very low; "
                      f"the gate will be slow and decoherence-dominated.",
                      UserWarning)

    # ---- step 4: blockade (simulation.py:2958-2959) ----
    C6 = get_C6(config.n_rydberg, config.species)
    V = float(rydberg_blockade(C6, R))
    V_over_Omega = V / Omega if Omega > 0 else float("inf")

    # ---- step 5: protocol parameters + timing (simulation.py:2989-3056) ----
    pp = proto.get_protocol_params(protocol, V_over_Omega=V_over_Omega
                                   if protocol == "levine_pichler" else None)
    smooth_params: Dict = {}
    bb_switching = bb_phases = None
    if protocol == "levine_pichler":
        _dow = delta_over_omega if delta_over_omega is not None else pp["delta_over_omega"]
        _ot = omega_tau if omega_tau is not None else pp["omega_tau"]
        tau_single = _ot / Omega
        tau_total = 2.0 * tau_single
        Delta_gate = _dow * Omega
        n_pulses = 2
    elif protocol == "jandura_pupillo":
        _ot = omega_tau if omega_tau is not None else pp.get("omega_tau", 22.08)
        tau_single = _ot / Omega
        tau_total = tau_single
        Delta_gate = 0.0
        _dow = 0.0
        n_pulses = 1
        bb_switching = (simulation_inputs.switching_times
                        or pp.get("switching_times",
                                  proto.JP_SWITCHING_TIMES_VALIDATED))
        bb_phases = (simulation_inputs.phases
                     or pp.get("phases", proto.JP_PHASES_VALIDATED))
    else:  # smooth_jp
        _ot = omega_tau if omega_tau is not None else pp.get("omega_tau", 10.09)
        tau_single = _ot / Omega
        tau_total = tau_single
        n_pulses = 1
        si = simulation_inputs
        A = si.A if getattr(si, "A", None) is not None else pp.get("A", 0.311 * np.pi)
        omr = (si.omega_mod_ratio if getattr(si, "omega_mod_ratio", None) is not None
               else pp.get("omega_mod_ratio", 1.242))
        phi_off = (si.phi_offset if getattr(si, "phi_offset", None) is not None
                   else pp.get("phi_offset", 4.696))
        raw_d = getattr(si, "delta_over_omega", None)
        mag = abs(raw_d if raw_d is not None else pp.get("delta_over_omega", 0.0205))
        # dark-state sign rule: delta opposite sign to Delta_e
        # (simulation.py:3473-3483)
        _dow = -mag if Delta_e > 0 else +mag
        Delta_gate = _dow * Omega
        smooth_params = {"A": A, "omega_mod_ratio": omr, "phi_offset": phi_off,
                         "delta_over_omega": _dow}
        if V_over_Omega < 5:
            warnings.warn(f"V/Omega = {V_over_Omega:.1f} may be too weak for a "
                          f"reliable CZ gate; recommend V/Omega > 10.",
                          UserWarning)

    # ---- step 6: trap-dependent noise (simulation.py:3076-3097) ----
    trap_noise = compute_trap_dependent_noise(
        species=config.species,
        tweezer_power=tweezer_power,
        tweezer_waist=tweezer_waist,
        temperature=temperature,
        spacing=R,
        gate_time=tau_total,
        n_rydberg=config.n_rydberg,
        gamma_phi_laser=np.pi * laser_linewidth_hz,
        Omega_1=Omega1,
        Delta_e=Delta_e,
        intermediate_state=config.intermediate_state,
        Omega_eff=Omega,
        tweezer_wavelength_nm=wavelength_nm,
        include_doppler=noise_cfg.include_doppler_dephasing,
        include_intensity_noise=noise_cfg.include_intensity_noise,
        intensity_noise_frac=noise_cfg.intensity_noise_frac,
        rydberg_wavelength_1_nm=config.excitation_wavelength_1_nm,
        rydberg_wavelength_2_nm=config.excitation_wavelength_2_nm,
        counter_propagating=exc.counter_propagating,
    )
    trap_noise = {k: (float(v) if not isinstance(v, str) else v)
                  for k, v in trap_noise.items()}
    U0 = trap_noise["trap_depth_uK"] * KB / 1e6

    magic_analysis = {
        "alpha_ratio": trap_noise["alpha_ratio"],
        "alpha_ground_au": trap_noise["alpha_ground_au"],
        "alpha_rydberg_au": trap_noise["alpha_rydberg_au"],
        "gamma_antitrap_Hz": trap_noise["gamma_loss_antitrap"],
        "differential_shift_Hz": trap_noise["differential_shift_Hz"],
        "magic_enhancement": trap_noise["magic_enhancement"],
        "wavelength_nm": trap_noise["wavelength_nm"],
    }

    # ---- step 6b: coherent shifts (simulation.py:3129-3159) ----
    delta_zeeman = float(calculate_zeeman_shift(B_field, config.qubit_0,
                                                config.qubit_1, config.species))
    if trap_laser_on:
        trap_depth_mK = trap_noise["trap_depth_uK"] / 1000.0
        delta_stark = float(calculate_qubit_stark_shift(
            tweezer_power, tweezer_waist, config.species,
            trap_depth_mK=trap_depth_mK if trap_depth_mK > 0 else None))
    else:
        delta_stark = 0.0

    # ---- step 8: collapse operators (simulation.py:3219-3355) ----
    c_ops = []
    noise_breakdown: Dict = {
        "total_decay_rate": 0.0, "total_dephasing_rate": 0.0,
        "total_loss_rate": 0.0, "n_collapse_ops": 0,
        "motional_dephasing_included": noise_cfg.include_motional_dephasing,
        "gamma_scatter_intermediate": trap_noise["gamma_scatter_intermediate"],
        "Omega1_MHz": Omega1 / (TWO_PI * 1e6),
    }
    if include_noise:
        gamma_phi = (np.pi * laser_linewidth_hz
                     if noise_cfg.include_laser_dephasing else 0.0)
        gamma_loss_background = (background_loss_rate_hz
                                 if background_loss_rate_hz is not None
                                 else trap_noise["gamma_loss_background"])
        gamma_motional = (trap_noise["gamma_phi_thermal"]
                          if noise_cfg.include_motional_dephasing else 0.0)
        gamma_doppler = trap_noise.get("gamma_phi_doppler", 0.0)
        gamma_intensity = trap_noise.get("gamma_phi_intensity", 0.0)

        if noise_cfg.include_magnetic_dephasing:
            B_rms_gauss = max(0.01 * B_field * 1e4, 1e-3)
            qtype = "clock" if config.is_clock_transition else "stretched"
            K_quad = sp.K_quad_clock
            gamma_zeeman = float(zeeman_dephasing_rate(B_rms_gauss, qtype, K_quad))
        else:
            gamma_zeeman = 0.0

        rydberg_fraction = 0.3
        time_factor = min(1.0, (tau_total / 1e-6) ** 2)
        gamma_antitrap_eff = (trap_noise["gamma_loss_antitrap"]
                              * rydberg_fraction * time_factor)

        Delta_leak = TWO_PI * 50e6  # fine structure (pulse_shaping.py:637)
        gamma_leakage = leakage_rate_to_adjacent_states(
            Omega=Omega, Delta_leak=Delta_leak, pulse_shape=pulse_shape,
            tau=tau_single, gamma_rydberg=trap_noise["gamma_r"])

        gamma_thermal_total = gamma_motional + gamma_doppler + gamma_intensity

        gamma_scatter = (trap_noise["gamma_scatter_intermediate"]
                         if noise_cfg.include_intermediate_scattering else 0.0)
        gamma_r = (trap_noise["gamma_r"]
                   if noise_cfg.include_spontaneous_emission else 0.0)

        if hilbert_space_dim == 4:
            Delta_zeeman_ryd = float(rydberg_zeeman_splitting(B_field, L=0, J=0.5))
            purity = min(exc.laser_1.polarization_purity,
                         exc.laser_2.polarization_purity)
            gamma_mJ = float(mJ_mixing_rate(Omega, purity, Delta_zeeman_ryd))
        else:
            Delta_zeeman_ryd, purity, gamma_mJ = 0.0, 1.0, 0.0

        c_ops, noise_dict = build_all_noise_operators(
            hs=hs,
            gamma_r=gamma_r,
            gamma_bbr=trap_noise.get("gamma_bbr", 0.0),
            gamma_phi_laser=gamma_phi,
            gamma_phi_thermal=gamma_thermal_total,
            gamma_phi_zeeman=gamma_zeeman,
            gamma_loss_antitrap=gamma_antitrap_eff,
            gamma_loss_background=gamma_loss_background,
            gamma_scatter_intermediate=gamma_scatter,
            gamma_leakage=gamma_leakage,
            mJ_leakage_rate=gamma_mJ,
        )
        noise_breakdown.update(noise_dict)
        noise_breakdown.update({
            "gamma_blockade_fluct": gamma_motional,
            "gamma_doppler": gamma_doppler,
            "gamma_intensity_noise": gamma_intensity,
            "gamma_thermal_total": gamma_thermal_total,
            "delta_V_over_V_percent": trap_noise["blockade_fluctuation_percent"],
            "anti_trap_time_factor": time_factor,
            "magic_enhancement": trap_noise["magic_enhancement"],
            "alpha_ratio": trap_noise["alpha_ratio"],
            "k_eff_rad_per_m": trap_noise.get("k_eff_rad_per_m", 0.0),
            "v_thermal_m_per_s": trap_noise.get("v_thermal_m_per_s", 0.0),
            "gamma_mJ_leakage": gamma_mJ,
            "combined_polarization_purity": purity,
            "Delta_zeeman_rydberg_Hz": Delta_zeeman_ryd / TWO_PI,
        })

    # ---- step 7 + schedule: Liouvillian decomposition + pulse program ----
    zeeman_splitting_r = (float(rydberg_zeeman_splitting(B_field))
                          if hilbert_space_dim == 4 else 0.0)
    H0 = static_hamiltonian(hs, Delta_gate, V, delta_zeeman, delta_stark,
                            trap_laser_on, zeeman_splitting=zeeman_splitting_r)
    pol = exc.laser_2.polarization if hilbert_space_dim == 4 else "sigma+"
    L0, Cp, Cm = drive_decomposition(hs, Omega, H0, c_ops, polarization=pol)

    xi = complex(1.0)
    pulse_info: Dict = {"shape": pulse_shape, "delta_zeeman": delta_zeeman,
                        "delta_stark": delta_stark,
                        "trap_laser_on": trap_laser_on,
                        # oracle-reconstruction metadata: lets independent
                        # verifiers (bench.py run_baseline_zvode) rebuild
                        # H + c_ops without touching the plan's L0/Cp/Cm
                        "polarization": pol,
                        "zeeman_splitting_r": zeeman_splitting_r}

    if protocol == "levine_pichler":
        xi = complex(proto.compute_phase_shift_xi(Delta_gate, Omega,
                                                   tau_single))
        xi_phase = float(np.angle(xi))
        if pulse_shape == "square":
            schedule = Schedule(np.ones(2), np.array([0.0, xi_phase]),
                                np.full(2, tau_single))
            pulse_info["implementation"] = "constant_hamiltonian"
        else:
            corr = area_correction_factor(pulse_shape, tau_single)
            n = n_steps_shaped
            dt = tau_single / n
            t_mid = (np.arange(n) + 0.5) * dt
            kwargs = ({"Delta_leak": TWO_PI * 50e6,
                       "lambda_drag": simulation_inputs.drag_lambda}
                      if pulse_shape == "drag" else {})
            env = np.real(np.asarray(get_pulse_envelope(pulse_shape, t_mid,
                                                        tau_single, **kwargs)))
            amps = np.concatenate([env, env]) * corr
            phases = np.concatenate([np.zeros(n), np.full(n, xi_phase)])
            dts = np.full(2 * n, dt)
            schedule = Schedule(amps, phases, dts)
            pulse_info.update({"implementation": "piecewise_constant_envelope",
                               "area_correction": corr,
                               "n_steps_per_pulse": n})
    elif protocol == "jandura_pupillo":
        sw = np.asarray(bb_switching, dtype=float)
        ph = np.asarray(bb_phases, dtype=float)
        bounds_bb = np.concatenate([[0.0], sw, [_ot]])
        dts_bb = np.clip(np.diff(bounds_bb), 0.0, None) / Omega
        schedule = Schedule(np.ones(len(ph)), ph, dts_bb)
        pulse_info.update({"implementation": "piecewise_constant_hamiltonian",
                           "protocol_variant": "jandura_pupillo_bangbang",
                           "switching_times": list(map(float, bb_switching)),
                           "phases": list(map(float, bb_phases)),
                           "n_segments": len(bb_phases), "omega_tau": _ot})
    else:  # smooth_jp
        n = n_steps_smooth
        dt = tau_total / n
        t_mid = (np.arange(n) + 0.5) * dt
        phases_np = smooth_params["A"] * np.cos(
            smooth_params["omega_mod_ratio"] * Omega * t_mid
            - smooth_params["phi_offset"])
        schedule = Schedule(np.ones(n), phases_np, np.full(n, dt))
        pulse_info.update({"implementation": "time_dependent_hamiltonian",
                           "protocol_variant": "bluvstein_evered_dark_state",
                           **smooth_params,
                           "dark_state_valid": (_dow < 0) == (Delta_e > 0),
                           "n_steps": n_steps_smooth})

    # ---- step 9: initial states (simulation.py:3364-3377) ----
    # Four computational basis states plus the |++> superposition used for
    # coherence-based controlled-phase extraction (see gate/fidelity.py).
    kets = two_atom_kets(hs)
    rho0s = np.stack([kets_to_density(kets[k])
                      for k in ("00", "01", "10", "11", "++")])

    if verbose:
        print(f"[plan] {protocol}: Omega/2pi={Omega / TWO_PI / 1e6:.3f} MHz, "
              f"V/Omega={V_over_Omega:.1f}, tau={tau_total * 1e6:.3f} us, "
              f"{schedule.dts.shape[0]} segments, "
              f"{noise_breakdown.get('n_collapse_ops', 0)} c_ops")

    return GatePlan(
        L0=L0, Cp=Cp, Cm=Cm, schedule=schedule, rho0s=rho0s, kets=kets,
        device=device, dtype=dtype, protocol=pp["name"], n_pulses=n_pulses,
        hilbert_space_dim=hilbert_space_dim, Omega=Omega, Omega1=Omega1,
        Omega2=Omega2, V=V, Delta=Delta_gate, V_over_Omega=V_over_Omega,
        delta_over_omega=_dow, xi=xi, tau_single=tau_single,
        tau_total=tau_total, R=R, spacing_factor=spacing_factor,
        U0_mK=U0 / KB * 1e3, omega_r_kHz=trap_noise["trap_freq_radial_kHz"],
        sigma_r_nm=trap_noise["position_uncertainty_nm"],
        trap_wavelength_nm=wavelength_nm,
        magic_wavelength_analysis=magic_analysis,
        noise_breakdown=noise_breakdown, include_noise=include_noise,
        pulse_info=pulse_info, config=config, temperature_K=temperature,
        B_field_T=B_field, delta_zeeman=delta_zeeman, delta_stark=delta_stark,
        trap_laser_on=trap_laser_on,
    )



# =============================================================================
# execution (steps 10-11, on the plan's device)
# =============================================================================

def plan_phase_frame(plan: GatePlan):
    """The phase-frame generator g (ops/phase_frame.py) when the plan's
    schedule is eligible for the one-expm fast path: uniform amplitudes
    and durations, no per-segment detunings, and exactly phase-covariant
    (L0, C+, C-) — verified numerically, host-side. None otherwise."""
    sched = plan.schedule
    if sched.dets is not None:
        return None
    amps = np.asarray(sched.amps)
    dts = np.asarray(sched.dts)
    if not (np.allclose(amps, amps[0]) and np.allclose(dts, dts[0])):
        return None
    hs = HS3 if plan.hilbert_space_dim == 3 else HS4
    return phase_frame_generator(plan.L0, plan.Cp, plan.Cm, hs)


def plan_squaring_bound(plan: GatePlan) -> int:
    """Tight static bound on the expm squaring count, computed on the host
    (plan matrices and schedule are numpy). Every masked squaring-loop trip
    costs a full batched product on the device."""
    def n1(M):
        return float(np.abs(M).sum(axis=0).max())
    sched = plan.schedule
    amax = float(np.max(np.abs(np.asarray(sched.amps))))
    dtmax = float(np.max(np.asarray(sched.dts)))
    norm = n1(plan.L0) + amax * (n1(plan.Cp) + n1(plan.Cm))
    if sched.dets is not None and getattr(plan, "Cd", None) is not None:
        norm += float(np.max(np.abs(np.asarray(sched.dets)))) * n1(plan.Cd)
    norm *= dtmax
    # theta = 1.8 is the tighter (taylor16) threshold; +1 slack segment
    return max(1, int(np.ceil(np.log2(max(norm, 1.8) / 1.8))) + 1)


def plan_from_numpy(fields: Dict, device: Union[str, torch.device] = "cpu",
                    dtype: torch.dtype = torch.complex128) -> GatePlan:
    """A GatePlan computed on `device` in `dtype` from bare arrays.

    fields: a mapping with at least L0, Cp, Cm (D^2 x D^2), rho0s (5, D, D),
    kets (dict of (D,) kets) and schedule (any object or tuple with amps,
    phases, dts[, dets]); any other GatePlan field is taken as metadata
    (e.g. ``vars(plan)`` of the reference package's GatePlan). The
    Hilbert-space dim defaults to the one rho0s implies."""
    names = {f.name for f in dataclasses.fields(GatePlan)}
    kw = {k: v for k, v in fields.items() if k in names}
    sched = fields["schedule"]
    amps, phases, dts, *rest = (sched if isinstance(sched, tuple)
                                else (sched.amps, sched.phases, sched.dts,
                                      getattr(sched, "dets", None)))
    dets = rest[0] if rest else None
    kw["schedule"] = Schedule(
        np.asarray(amps, np.float64), np.asarray(phases, np.float64),
        np.asarray(dts, np.float64),
        None if dets is None else np.asarray(dets, np.float64))
    for k in ("L0", "Cp", "Cm", "rho0s"):
        kw[k] = np.asarray(fields[k], np.complex128)
    kw["kets"] = {k: np.asarray(v) for k, v in fields["kets"].items()}
    D = kw["rho0s"].shape[-1]
    kw.setdefault("hilbert_space_dim", int(round(np.sqrt(D))))
    kw["device"], kw["dtype"] = device, dtype
    return GatePlan(**kw)


def run_plan(plan: GatePlan):
    """Evolve the five initial states and analyze, on plan.device in
    plan.dtype. Returns (fidelities, avg_fidelity, phase_info, rhos), all
    tensors on that device."""
    dev, cdt = torch.device(plan.device), plan.dtype
    rdt = real_dtype(cdt)

    def put(a):
        return torch.as_tensor(np.asarray(a, np.complex128), device=dev).to(cdt)

    L0, Cp, Cm, rho0s = put(plan.L0), put(plan.Cp), put(plan.Cm), put(plan.rho0s)
    ms = plan_squaring_bound(plan)
    g = plan_phase_frame(plan)
    sched = plan.schedule
    if g is not None:
        # one expm + the phase-frame scan in the real Hermitian basis
        # (exact; see ops/phase_frame.py and solver/real_rep.py)
        Ub = uniform_base_propagator(
            L0, Cp, Cm, float(np.asarray(sched.amps)[0]),
            float(np.asarray(sched.dts)[0]), max_squarings=ms)
        D = rho0s.shape[-1]
        rep = build_real_rep(g, D)
        Wr, Wi, cq = (torch.as_tensor(a, dtype=rdt, device=dev)
                      for a in (rep.Wr, rep.Wi, rep.cq))
        phases = torch.as_tensor(np.asarray(sched.phases, np.float64),
                                 dtype=rdt, device=dev)
        xf = evolve_real_phased(real_propagator_device(Ub, Wr, Wi), cq,
                                phases, to_real_coords(rho0s, Wr, Wi),
                                D, rep.P)
        rhos = from_real_coords(xf, Wr, Wi)
    else:
        rhos = evolve_rhos(L0, Cp, Cm, sched, rho0s, max_squarings=ms)
    fids, avg, phase_info = compute_cz_fidelity(rhos, plan.kets)
    return fids, avg, phase_info, rhos


def simulate_cz_gate(simulation_inputs: SimInputs,
                     device: Union[str, torch.device] = "cpu",
                     dtype: torch.dtype = torch.complex128,
                     **kwargs) -> GateResult:
    """Full pipeline: plan + run + package, computed on `device` in complex
    `dtype`. Mirrors simulate_CZ_gate (simulation.py:2534)."""
    plan = plan_cz_gate(simulation_inputs, device=device, dtype=dtype,
                        **kwargs)
    fids, avg, phase_info, rhos = run_plan(plan)

    fids = {k: float(v) for k, v in fids.items()}
    phase_info = {k: (bool(v) if v.dtype == torch.bool else float(v))
                  for k, v in phase_info.items()}
    order = ("00", "01", "10", "11", "++")
    rhos_np = rhos.cpu().numpy()
    results = {k: rhos_np[i] for i, k in enumerate(order)}

    return GateResult(
        avg_fidelity=float(avg), fidelities=fids, phase_info=phase_info,
        protocol=plan.protocol, n_pulses=plan.n_pulses,
        hilbert_space_dim=plan.hilbert_space_dim, Omega=plan.Omega, V=plan.V,
        Delta=plan.Delta, V_over_Omega=plan.V_over_Omega,
        Delta_over_Omega=plan.delta_over_omega, xi=plan.xi,
        tau_single=plan.tau_single, tau_total=plan.tau_total, R=plan.R,
        spacing_factor=plan.spacing_factor, U0_mK=plan.U0_mK,
        omega_r_kHz=plan.omega_r_kHz, sigma_r_nm=plan.sigma_r_nm,
        trap_wavelength_nm=plan.trap_wavelength_nm,
        magic_wavelength_analysis=plan.magic_wavelength_analysis,
        noise_breakdown=plan.noise_breakdown, include_noise=plan.include_noise,
        pulse_info=plan.pulse_info, config=plan.config,
        species=plan.config.species, n_rydberg=plan.config.n_rydberg,
        qubit_0=plan.config.qubit_0, qubit_1=plan.config.qubit_1,
        temperature_K=plan.temperature_K, B_field_T=plan.B_field_T,
        delta_zeeman=plan.delta_zeeman, delta_stark=plan.delta_stark,
        trap_laser_on=plan.trap_laser_on, results=results,
    )


# aliases matching the reference public names
simulate_CZ_gate = simulate_cz_gate
SimulationResult = GateResult

__all__ = ["GatePlan", "GateResult", "plan_cz_gate", "plan_phase_frame",
           "plan_squaring_bound", "plan_from_numpy", "run_plan",
           "simulate_cz_gate", "simulate_CZ_gate", "SimulationResult"]
