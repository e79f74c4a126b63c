"""Named experiment parameter sets ("hardware configs").

Implements the reference's comment-only hardware-config layer
(reference: src/qpu_simulator/hardware_configs/{__init__,neutral_atoms,
trapped_ions,cavity_qed}.py — `NeutralAtomConfig.from_experiment(...)`
style factories for published experimental platforms).

Values are representative published parameters (order-of-magnitude
faithful; see each entry's citation) intended as realistic starting points,
exactly as the reference planned.

Counterpart of the reference's `models/hardware_configs.py`, copied; the
neutral-atom apparatus comes from the port's `optimize/apparatus.py`.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, Optional, Tuple

from ..core.constants import TWO_PI
from ..optimize.apparatus import ApparatusConstraints


@dataclass
class NeutralAtomConfig:
    """Apparatus-level description of a neutral-atom experiment."""
    name: str
    species: str = "Rb87"
    n_rydberg: int = 70
    qubit_0: Tuple[int, int] = (1, 0)
    qubit_1: Tuple[int, int] = (2, 0)
    temperature: float = 10e-6
    B_field: float = 1e-4
    NA: float = 0.5
    spacing_factor: float = 2.8
    tweezer_power: float = 20e-3
    tweezer_waist: float = 0.9e-6
    tweezer_wavelength_nm: float = 1064.0
    laser_1_power: float = 50e-6
    laser_2_power: float = 0.3
    laser_waist: float = 50e-6
    Delta_e: float = TWO_PI * 1e9
    laser_linewidth_hz: float = 100.0
    counter_propagating: bool = True
    reference: str = ""

    def apparatus(self) -> ApparatusConstraints:
        return ApparatusConstraints(
            laser_1_power=self.laser_1_power, laser_1_waist=self.laser_waist,
            laser_2_power=self.laser_2_power, laser_2_waist=self.laser_waist,
            Delta_e=self.Delta_e,
            laser_1_linewidth_hz=self.laser_linewidth_hz,
            laser_2_linewidth_hz=self.laser_linewidth_hz,
            temperature=self.temperature,
            spacing_factor=self.spacing_factor, n_rydberg=self.n_rydberg,
            species=self.species, tweezer_power=self.tweezer_power,
            tweezer_waist=self.tweezer_waist, B_field=self.B_field,
            NA=self.NA, counter_propagating=self.counter_propagating)

    @staticmethod
    def from_experiment(name: str) -> "NeutralAtomConfig":
        key = name.lower()
        if key not in NEUTRAL_ATOM_EXPERIMENTS:
            raise ValueError(f"Unknown experiment '{name}'. Available: "
                             f"{list(NEUTRAL_ATOM_EXPERIMENTS)}")
        return replace(NEUTRAL_ATOM_EXPERIMENTS[key])


NEUTRAL_ATOM_EXPERIMENTS: Dict[str, NeutralAtomConfig] = {
    # Harvard/Lukin logical-processor era apparatus (Bluvstein/Evered):
    # n=53, Omega/2pi=4.6 MHz regime, 99.5% CZ.
    "lukin_2022": NeutralAtomConfig(
        name="lukin_2022", species="Rb87", n_rydberg=53,
        temperature=10e-6, spacing_factor=2.0, NA=0.55,
        Delta_e=TWO_PI * 7.8e9, laser_2_power=1.0,
        laser_linewidth_hz=100.0,
        reference="Evered et al., Nature 622, 268 (2023); Bluvstein thesis"),
    # QuEra Aquila-style analog machine parameters
    "quera_aquila": NeutralAtomConfig(
        name="quera_aquila", species="Rb87", n_rydberg=70,
        temperature=15e-6, spacing_factor=3.2, NA=0.4,
        Delta_e=TWO_PI * 1e9, laser_2_power=0.5,
        laser_linewidth_hz=500.0,
        reference="Wurtz et al., arXiv:2306.11727 (Aquila whitepaper)"),
    # Pasqal Fresnel-style device
    "pasqal_fresnel": NeutralAtomConfig(
        name="pasqal_fresnel", species="Rb87", n_rydberg=60,
        temperature=20e-6, spacing_factor=2.5, NA=0.5,
        Delta_e=TWO_PI * 0.7e9, laser_2_power=0.3,
        laser_linewidth_hz=1e3,
        reference="Henriet et al., Quantum 4, 327 (2020)"),
    # Cs tweezer platform (Wisconsin/Saffman lineage)
    "saffman_cs": NeutralAtomConfig(
        name="saffman_cs", species="Cs133", n_rydberg=66,
        qubit_0=(3, 0), qubit_1=(4, 0),
        temperature=15e-6, spacing_factor=2.6, NA=0.45,
        Delta_e=TWO_PI * 1.1e9, laser_2_power=0.4,
        laser_linewidth_hz=300.0,
        reference="Graham et al., Nature 604, 457 (2022)"),
}


@dataclass
class TrappedIonConfig:
    """QCCD / chain trapped-ion platform parameters.
    (hardware_configs/trapped_ions.py spec)"""
    name: str
    species: str = "Yb171"
    n_qubits: int = 32
    ms_gate_time: float = 200e-6
    ms_gate_fidelity: float = 0.998
    sq_gate_time: float = 10e-6
    sq_gate_fidelity: float = 0.9999
    shuttle_time: float = 300e-6
    shuttle_heating_quanta: float = 0.1
    readout_time: float = 200e-6
    readout_fidelity: float = 0.998
    T1: float = 1e4
    T2: float = 1.0
    trap_frequency: float = TWO_PI * 3e6
    reference: str = ""

    @staticmethod
    def from_experiment(name: str) -> "TrappedIonConfig":
        key = name.lower()
        if key not in TRAPPED_ION_EXPERIMENTS:
            raise ValueError(f"Unknown experiment '{name}'. Available: "
                             f"{list(TRAPPED_ION_EXPERIMENTS)}")
        return replace(TRAPPED_ION_EXPERIMENTS[key])


TRAPPED_ION_EXPERIMENTS: Dict[str, TrappedIonConfig] = {
    "quantinuum_h2": TrappedIonConfig(
        name="quantinuum_h2", species="Yb171", n_qubits=32,
        ms_gate_time=100e-6, ms_gate_fidelity=0.9988,
        readout_fidelity=0.9985, T2=2.0,
        reference="Moses et al., PRX 13, 041052 (2023)"),
    "ionq_forte": TrappedIonConfig(
        name="ionq_forte", species="Yb171", n_qubits=36,
        ms_gate_time=200e-6, ms_gate_fidelity=0.995,
        readout_fidelity=0.995, T2=1.0,
        reference="IonQ Forte system datasheet (2023)"),
}


@dataclass
class CavityQEDConfig:
    """Cavity-QED platform parameters. (hardware_configs/cavity_qed.py spec)"""
    name: str
    g: float = TWO_PI * 10e6          # atom-cavity coupling
    kappa: float = TWO_PI * 1e6       # cavity decay
    gamma: float = TWO_PI * 3e6       # atomic decay
    reference: str = ""

    @property
    def cooperativity(self) -> float:
        return self.g ** 2 / (self.kappa * self.gamma)

    @staticmethod
    def from_experiment(name: str) -> "CavityQEDConfig":
        key = name.lower()
        if key not in CAVITY_QED_EXPERIMENTS:
            raise ValueError(f"Unknown experiment '{name}'. Available: "
                             f"{list(CAVITY_QED_EXPERIMENTS)}")
        return replace(CAVITY_QED_EXPERIMENTS[key])


CAVITY_QED_EXPERIMENTS: Dict[str, CavityQEDConfig] = {
    "rempe_fiber": CavityQEDConfig(
        name="rempe_fiber", g=TWO_PI * 20e6, kappa=TWO_PI * 2.5e6,
        gamma=TWO_PI * 3e6, reference="Reiserer & Rempe, RMP 87, 1379 (2015)"),
    "lukin_nanophotonic": CavityQEDConfig(
        name="lukin_nanophotonic", g=TWO_PI * 40e6, kappa=TWO_PI * 10e6,
        gamma=TWO_PI * 3e6,
        reference="Samutpraphoot et al., PRL 124, 063602 (2020)"),
}


def list_experiments() -> Dict[str, list]:
    return {
        "neutral_atoms": list(NEUTRAL_ATOM_EXPERIMENTS),
        "trapped_ions": list(TRAPPED_ION_EXPERIMENTS),
        "cavity_qed": list(CAVITY_QED_EXPERIMENTS),
    }


__all__ = ["NeutralAtomConfig", "NEUTRAL_ATOM_EXPERIMENTS",
           "TrappedIonConfig", "TRAPPED_ION_EXPERIMENTS",
           "CavityQEDConfig", "CAVITY_QED_EXPERIMENTS", "list_experiments"]
