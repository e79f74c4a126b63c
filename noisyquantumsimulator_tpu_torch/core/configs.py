"""Configuration dataclasses (host-side, resolved before any device work).

Rebuild of the reference configuration layer
(reference: rydberg_gates/configurations.py:76-1042). These are frozen-ish
plain dataclasses used only during *config resolution*; the device compute
path consumes pure-array schedules (see gate/simulate.py), never these objects.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from .constants import C, EPS0, HBAR, KB, TWO_PI
from . import atom_data
from .atom_data import SpeciesData, get_species


# =============================================================================
# lasers
# =============================================================================

@dataclass
class LaserParameters:
    """One Rydberg-excitation laser. (configurations.py:76-171)"""
    power: float = 1e-3           # [W]
    waist: float = 50e-6          # [m], 1/e^2 intensity radius
    polarization: str = "sigma+"
    polarization_purity: float = 0.99
    linewidth_hz: float = 100.0

    def peak_intensity(self) -> float:
        """I0 = 2P/(pi w^2). (configurations.py:145)"""
        return 2.0 * self.power / (np.pi * self.waist ** 2)

    def peak_electric_field(self) -> float:
        """E0 = sqrt(2 I0 / (eps0 c)). (configurations.py:158)"""
        return float(np.sqrt(2.0 * self.peak_intensity() / (EPS0 * C)))


@dataclass
class TwoPhotonExcitationConfig:
    """Two-photon ladder: ground --laser1--> P --laser2--> nS.
    (configurations.py:177-215)"""
    laser_1: LaserParameters = field(default_factory=lambda: LaserParameters(
        power=50e-6, waist=50e-6, polarization="pi", linewidth_hz=1000))
    laser_2: LaserParameters = field(default_factory=lambda: LaserParameters(
        power=500e-3, waist=50e-6, polarization="sigma+", linewidth_hz=1000))
    Delta_e: float = TWO_PI * 1e9         # intermediate detuning [rad/s]
    counter_propagating: bool = True


@dataclass
class NoiseSourceConfig:
    """Per-channel noise toggles. (configurations.py:218-259)"""
    include_spontaneous_emission: bool = True
    include_intermediate_scattering: bool = True
    include_motional_dephasing: bool = True
    include_doppler_dephasing: bool = True
    include_intensity_noise: bool = True
    intensity_noise_frac: float = 0.01
    include_laser_dephasing: bool = True
    include_magnetic_dephasing: bool = True

    @classmethod
    def noiseless(cls) -> "NoiseSourceConfig":
        return cls(include_spontaneous_emission=False,
                   include_intermediate_scattering=False,
                   include_motional_dephasing=False,
                   include_doppler_dephasing=False,
                   include_intensity_noise=False,
                   intensity_noise_frac=0.0,
                   include_laser_dephasing=False,
                   include_magnetic_dephasing=False)

    @classmethod
    def full(cls) -> "NoiseSourceConfig":
        return cls()


# =============================================================================
# protocol-specific simulation inputs
# =============================================================================

@dataclass
class LPSimulationInputs:
    """Levine-Pichler two-pulse protocol inputs. (configurations.py:262-313)"""
    excitation: TwoPhotonExcitationConfig = field(default_factory=TwoPhotonExcitationConfig)
    noise: NoiseSourceConfig = field(default_factory=NoiseSourceConfig)
    delta_over_omega: Optional[float] = None   # None -> V/Omega lookup
    omega_tau: Optional[float] = None          # None -> V/Omega lookup
    pulse_shape: str = "square"
    drag_lambda: float = 1.0

    @property
    def protocol_name(self) -> str:
        return "levine_pichler"

    @property
    def n_pulses(self) -> int:
        return 2


@dataclass
class JPSimulationInputs:
    """Jandura-Pupillo bang-bang protocol inputs. (configurations.py:316-375)"""
    excitation: TwoPhotonExcitationConfig = field(default_factory=TwoPhotonExcitationConfig)
    noise: NoiseSourceConfig = field(default_factory=NoiseSourceConfig)
    omega_tau: Optional[float] = None
    switching_times: Optional[List[float]] = None   # dimensionless Omega*t
    phases: Optional[List[float]] = None            # [rad] per segment

    @property
    def protocol_name(self) -> str:
        return "jandura_pupillo"

    @property
    def pulse_shape(self) -> str:
        return "bangbang"

    @property
    def n_pulses(self) -> int:
        return 1


@dataclass
class SmoothJPSimulationInputs:
    """Smooth sinusoidal JP (Bluvstein-form) inputs. (configurations.py:378-454)

    phi(t) = A cos(omega_mod t - phi_offset) + delta0 t
    """
    excitation: TwoPhotonExcitationConfig = field(default_factory=TwoPhotonExcitationConfig)
    noise: NoiseSourceConfig = field(default_factory=NoiseSourceConfig)
    omega_tau: Optional[float] = None
    A: Optional[float] = None
    omega_mod_ratio: Optional[float] = None
    phi_offset: Optional[float] = None
    delta_over_omega: Optional[float] = None

    @property
    def protocol_name(self) -> str:
        return "smooth_jp"

    @property
    def pulse_shape(self) -> str:
        return "smooth_sinusoidal"

    @property
    def n_pulses(self) -> int:
        return 1


SimulationInputs = (LPSimulationInputs, JPSimulationInputs, SmoothJPSimulationInputs)


# =============================================================================
# tweezer / environment
# =============================================================================

@dataclass
class TweezerParameters:
    """Optical tweezer trap. (configurations.py:457-548)"""
    power: float = 10e-3            # [W]
    waist: float = 0.9e-6           # [m]
    wavelength_nm: float = 820.0
    NA: float = 0.5

    def diffraction_limited_waist(self) -> float:
        return 0.64 * self.wavelength_nm * 1e-9 / self.NA

    def rayleigh_range(self) -> float:
        return float(np.pi * self.waist ** 2 / (self.wavelength_nm * 1e-9))

    def peak_intensity(self) -> float:
        return 2.0 * self.power / (np.pi * self.waist ** 2)


@dataclass
class EnvironmentParameters:
    """Temperature / B-field / spacing. (configurations.py:551-632)"""
    temperature: float = 20e-6      # [K]
    B_field: float = 0.5e-4         # [T]
    B_field_angle: float = 0.0
    spacing_factor: float = 2.8

    def thermal_velocity(self, mass: float) -> float:
        return float(np.sqrt(KB * self.temperature / mass))

    def B_field_gauss(self) -> float:
        return self.B_field / 1e-4


# =============================================================================
# atomic configuration
# =============================================================================

@dataclass
class AtomicConfiguration:
    """Species + Rydberg state + qubit encoding. (configurations.py:639-948)"""
    species: str = "Rb87"
    n_rydberg: int = 70
    L_rydberg: str = "S"
    qubit_0: Tuple[int, int] = (1, 0)
    qubit_1: Tuple[int, int] = (2, 0)
    intermediate_state: Optional[str] = None

    def __post_init__(self):
        sp = get_species(self.species)
        if self.intermediate_state is None:
            self.intermediate_state = sp.default_intermediate

    @property
    def data(self) -> SpeciesData:
        return get_species(self.species)

    @property
    def n_star(self) -> float:
        return atom_data.effective_n(self.n_rydberg, self.species, self.L_rydberg)

    @property
    def quantum_defect(self) -> float:
        return atom_data.get_quantum_defect(self.species, self.L_rydberg)

    @property
    def rydberg_energy(self) -> float:
        return atom_data.get_rydberg_energy(self.n_rydberg, self.species, self.L_rydberg)

    @property
    def C6(self) -> float:
        return atom_data.get_C6(self.n_rydberg, self.species)

    @property
    def rydberg_lifetime_300K(self) -> float:
        return atom_data.get_rydberg_lifetime(self.n_rydberg, self.species, 300.0)

    @property
    def rydberg_lifetime_0K(self) -> float:
        return atom_data.get_rydberg_lifetime(self.n_rydberg, self.species, 0.0)

    @property
    def rydberg_polarizability(self) -> float:
        return atom_data.get_rydberg_polarizability(self.n_rydberg, self.species)

    @property
    def mass(self) -> float:
        return self.data.mass

    @property
    def hyperfine_splitting(self) -> float:
        return self.data.hyperfine_splitting_hz

    @property
    def ground_polarizability(self) -> float:
        return self.data.alpha_ground

    @property
    def is_clock_transition(self) -> bool:
        return self.qubit_0[1] == 0 and self.qubit_1[1] == 0

    @property
    def delta_mF(self) -> int:
        return abs(self.qubit_1[1] - self.qubit_0[1])

    @property
    def delta_F(self) -> int:
        return abs(self.qubit_1[0] - self.qubit_0[0])

    @property
    def intermediate_linewidth(self) -> float:
        return atom_data.get_intermediate_state_linewidth(self.species, self.intermediate_state)

    def _leg1_frequency(self) -> float:
        sp = self.data
        key = f"ground_to_{self.intermediate_state}"
        if key in sp.transitions:
            return sp.transitions[key]
        return list(sp.transitions.values())[0]

    @property
    def excitation_wavelength_1_nm(self) -> float:
        """Ground -> intermediate wavelength. (configurations.py:812)"""
        return C / self._leg1_frequency() * 1e9

    @property
    def excitation_wavelength_2_nm(self) -> float:
        """Intermediate -> Rydberg wavelength via energy conservation.
        (configurations.py:841)"""
        E_total = self.data.E_ionization + self.rydberg_energy
        E_photon1 = HBAR * TWO_PI * self._leg1_frequency()
        freq2 = (E_total - E_photon1) / (HBAR * TWO_PI)
        return C / freq2 * 1e9

    def get_g_F(self, state: Tuple[int, int]) -> float:
        return self.data.g_F[state[0]]

    def blockade_radius(self, Omega: float) -> float:
        """R_b = (C6/Omega)^(1/6); C6 in (rad/s) m^6. (configurations.py:893)"""
        return float((self.C6 / Omega) ** (1.0 / 6.0))

    def blockade_shift(self, R: float) -> float:
        return self.C6 / R ** 6

    def summary(self) -> str:
        return (f"AtomicConfiguration({self.species}, {self.n_rydberg}{self.L_rydberg}, "
                f"n*={self.n_star:.3f}, C6/2pi={self.C6 / TWO_PI:.3e} Hz m^6, "
                f"qubit=({self.qubit_0},{self.qubit_1}), clock={self.is_clock_transition})")


def get_standard_rb87_config(n_rydberg: int = 70) -> AtomicConfiguration:
    return AtomicConfiguration(species="Rb87", n_rydberg=n_rydberg,
                               qubit_0=(1, 0), qubit_1=(2, 0),
                               intermediate_state="5P3/2")


def get_standard_cs133_config(n_rydberg: int = 70) -> AtomicConfiguration:
    return AtomicConfiguration(species="Cs133", n_rydberg=n_rydberg,
                               qubit_0=(3, 0), qubit_1=(4, 0),
                               intermediate_state="6P3/2")


__all__ = [
    "LaserParameters", "TwoPhotonExcitationConfig", "NoiseSourceConfig",
    "LPSimulationInputs", "JPSimulationInputs", "SmoothJPSimulationInputs",
    "SimulationInputs", "TweezerParameters", "EnvironmentParameters",
    "AtomicConfiguration", "get_standard_rb87_config", "get_standard_cs133_config",
]
