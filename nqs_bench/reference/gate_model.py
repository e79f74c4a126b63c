"""The smooth-JP CZ gate of a configuration file, as plain numpy arrays.

This is the smooth-JP branch of the host plan (species data, lasers, trap,
noise rates, collapse operators, the Liouvillian) run on the frozen copy of
that code under `frozen/`, from the settings that the configuration file
states. Nothing here reads the program or its defaults: every number comes
from the file.

The Liouvillian of a segment with drive phase phi and detuning Delta is

    L(phi, Delta) = L_static + Delta * L_det + e^{i phi} L_plus + e^{-i phi} L_minus

with L_static the Liouvillian of every drive-free term at Delta = 0
(blockade, Zeeman and Stark shifts, the dissipator), L_det its change per
unit of detuning, and L_plus / L_minus the two halves of the (Omega / 2)
drive. Row-major vectorisation: vec(A X B) = (A kron B^T) vec(X).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np

from .frozen.atom_data import get_C6, get_species
from .frozen.configs import AtomicConfiguration
from .frozen.constants import TWO_PI
from .frozen.hamiltonians import drive_operator
from .frozen.hilbert import HS3, HS4, kets_to_density, two_atom_kets
from .frozen.laser import (laser_E0, rydberg_blockade, single_photon_rabi,
                           two_photon_rabi)
from .frozen.lindblad import (build_all_noise_operators,
                              hamiltonian_superop_linear, liouvillian,
                              static_hamiltonian)
from .frozen.noise_rates import (leakage_rate_to_adjacent_states,
                                 mJ_mixing_rate, rydberg_zeeman_splitting,
                                 zeeman_dephasing_rate)
from .frozen.trap import (calculate_qubit_stark_shift, calculate_zeeman_shift,
                          compute_trap_dependent_noise, tweezer_spacing)

STATE_ORDER = ("00", "01", "10", "11", "++")


@dataclass
class GateModel:
    """One configuration's gate: Liouvillian pieces (D^2 x D^2 complex128),
    initial states, target kets and the pulse constants."""
    dim: int
    L_static: np.ndarray
    L_det: np.ndarray
    L_plus: np.ndarray
    L_minus: np.ndarray
    rho0s: np.ndarray              # (5, D, D) in STATE_ORDER
    kets: Dict[str, np.ndarray]    # (D,) each
    Omega: float
    Delta_e: float
    Delta_gate: float              # the configuration's detuning (sign rule applied)
    smooth: Dict[str, float]
    n_steps: int

    def base_schedule(self):
        """(phases (n_steps,), dt) of the configuration's own pulse."""
        return smooth_jp_schedule(self.smooth["omega_tau"], self.smooth["A"],
                                  self.smooth["omega_mod_ratio"],
                                  self.smooth["phi_offset"], self.Omega,
                                  self.n_steps)

    def detuning(self, delta_over_omega):
        """Detuning of |delta/Omega| under the dark-state sign rule: the
        sign opposite to the intermediate detuning's."""
        sign = -1.0 if self.Delta_e > 0 else 1.0
        return sign * np.abs(delta_over_omega) * self.Omega


def smooth_jp_schedule(omega_tau, A, omega_mod_ratio, phi_offset, Omega,
                       n_steps):
    """phi_k = A cos(omega_mod_ratio Omega t_k - phi_offset) at the segment
    midpoints t_k, and dt = omega_tau / Omega / n_steps. Arguments may be
    arrays of one shape (one schedule each): phases get a last axis."""
    dt = np.asarray(omega_tau, np.float64) / Omega / n_steps
    t_mid = (np.arange(n_steps) + 0.5) * dt[..., None]
    phases = np.asarray(A)[..., None] * np.cos(
        np.asarray(omega_mod_ratio)[..., None] * Omega * t_mid
        - np.asarray(phi_offset)[..., None])
    return phases, dt


def build(config: dict, entry: str) -> GateModel:
    """The gate of `config` (a configuration file's JSON) under the settings
    of `entry` (its key in the file: "sweep" or "population")."""
    st = config[entry]
    dim = int(config["hilbert_space_dim"])
    smooth = dict(config["smooth_jp"])
    hs = HS3 if dim == 3 else HS4
    l1, l2 = st["laser_1"], st["laser_2"]
    nz = st["noise"]
    Delta_e = float(st["Delta_e"])
    atom = AtomicConfiguration(species=st["species"], n_rydberg=st["n_rydberg"],
                               qubit_0=tuple(st["qubit_0"]),
                               qubit_1=tuple(st["qubit_1"]), L_rydberg="S")
    sp = get_species(atom.species)
    linewidth = float(np.sqrt(l1["linewidth_hz"] ** 2 + l2["linewidth_hz"] ** 2))
    wavelength = (sp.trap_wavelength if st["tweezer_wavelength_nm"] is None
                  else st["tweezer_wavelength_nm"] * 1e-9)
    R = float(tweezer_spacing(wavelength, st["NA"], st["spacing_factor"]))

    dipole_1e = sp.intermediate_states[atom.intermediate_state].dipole_from_ground
    dipole_er = (sp.dipole_intermediate_to_rydberg_ref
                 * (atom.n_rydberg / sp.n_ref) ** (-1.5))
    Omega1 = float(single_photon_rabi(dipole_1e, float(laser_E0(l1["power"], l1["waist"]))))
    Omega2 = float(single_photon_rabi(dipole_er, float(laser_E0(l2["power"], l2["waist"]))))
    Omega = float(two_photon_rabi(Omega1, Omega2, Delta_e))
    V = float(rydberg_blockade(get_C6(atom.n_rydberg, atom.species), R))

    tau = smooth["omega_tau"] / Omega
    Delta_gate = (-1.0 if Delta_e > 0 else 1.0) * abs(smooth["delta_over_omega"]) * Omega

    tn = compute_trap_dependent_noise(
        species=atom.species, tweezer_power=st["tweezer_power"],
        tweezer_waist=st["tweezer_waist"], temperature=st["temperature"],
        spacing=R, gate_time=tau, n_rydberg=atom.n_rydberg,
        gamma_phi_laser=np.pi * linewidth, Omega_1=Omega1, Delta_e=Delta_e,
        intermediate_state=atom.intermediate_state, Omega_eff=Omega,
        tweezer_wavelength_nm=wavelength * 1e9,
        include_doppler=nz["include_doppler_dephasing"],
        include_intensity_noise=nz["include_intensity_noise"],
        intensity_noise_frac=nz["intensity_noise_frac"],
        rydberg_wavelength_1_nm=atom.excitation_wavelength_1_nm,
        rydberg_wavelength_2_nm=atom.excitation_wavelength_2_nm,
        counter_propagating=st["counter_propagating"])
    tn = {k: (float(v) if not isinstance(v, str) else v) for k, v in tn.items()}

    B = st["B_field"]
    delta_zeeman = float(calculate_zeeman_shift(B, atom.qubit_0, atom.qubit_1,
                                                atom.species))
    if st["trap_laser_on"]:
        depth_mK = tn["trap_depth_uK"] / 1000.0
        delta_stark = float(calculate_qubit_stark_shift(
            st["tweezer_power"], st["tweezer_waist"], atom.species,
            trap_depth_mK=depth_mK if depth_mK > 0 else None))
    else:
        delta_stark = 0.0

    c_ops = []
    if st["include_noise"]:
        if nz["include_magnetic_dephasing"]:
            qtype = "clock" if atom.is_clock_transition else "stretched"
            gamma_zeeman = float(zeeman_dephasing_rate(
                max(0.01 * B * 1e4, 1e-3), qtype, sp.K_quad_clock))
        else:
            gamma_zeeman = 0.0
        gamma_leak = leakage_rate_to_adjacent_states(
            Omega=Omega, Delta_leak=TWO_PI * 50e6, pulse_shape="smooth_sinusoidal",
            tau=tau, gamma_rydberg=tn["gamma_r"])
        if dim == 4:
            purity = min(l1["polarization_purity"], l2["polarization_purity"])
            gamma_mJ = float(mJ_mixing_rate(
                Omega, purity, float(rydberg_zeeman_splitting(B, L=0, J=0.5))))
        else:
            gamma_mJ = 0.0
        background = st["background_loss_rate_hz"]
        c_ops, _ = build_all_noise_operators(
            hs=hs,
            gamma_r=tn["gamma_r"] if nz["include_spontaneous_emission"] else 0.0,
            gamma_bbr=tn.get("gamma_bbr", 0.0),
            gamma_phi_laser=np.pi * linewidth if nz["include_laser_dephasing"] else 0.0,
            gamma_phi_thermal=((tn["gamma_phi_thermal"]
                                if nz["include_motional_dephasing"] else 0.0)
                               + tn.get("gamma_phi_doppler", 0.0)
                               + tn.get("gamma_phi_intensity", 0.0)),
            gamma_phi_zeeman=gamma_zeeman,
            gamma_loss_antitrap=(tn["gamma_loss_antitrap"] * 0.3
                                 * min(1.0, (tau / 1e-6) ** 2)),
            gamma_loss_background=(tn["gamma_loss_background"]
                                   if background is None else background),
            gamma_scatter_intermediate=(tn["gamma_scatter_intermediate"]
                                        if nz["include_intermediate_scattering"]
                                        else 0.0),
            gamma_leakage=gamma_leak,
            mJ_leakage_rate=gamma_mJ)

    split = float(rydberg_zeeman_splitting(B)) if dim == 4 else 0.0

    def static(Delta):
        return liouvillian(static_hamiltonian(
            hs, Delta, V, delta_zeeman, delta_stark, st["trap_laser_on"],
            zeeman_splitting=split), c_ops)

    L_static = static(0.0)
    S = drive_operator(hs, l2["polarization"] if dim == 4 else "sigma+")
    kets = two_atom_kets(hs)
    return GateModel(
        dim=dim, L_static=L_static, L_det=static(1.0) - L_static,
        L_plus=hamiltonian_superop_linear(0.5 * Omega * S),
        L_minus=hamiltonian_superop_linear(0.5 * Omega * S.conj().T),
        rho0s=np.stack([kets_to_density(kets[k]) for k in STATE_ORDER]),
        kets=kets, Omega=Omega, Delta_e=Delta_e, Delta_gate=Delta_gate,
        smooth=smooth, n_steps=int(config["n_steps"]))
