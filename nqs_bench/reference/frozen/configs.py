# Frozen copy of the port's host plan code (noisyquantumsimulator_tpu_torch/core/configs.py), kept so that the
# benchmark's reference rebuilds the gate from its configuration file without
# importing the program. Only the imports were changed, and what the reference
# never reaches was left out.
"""Configuration dataclasses (host-side, resolved before any device work).

Rebuild of the reference configuration layer
(reference: rydberg_gates/configurations.py:76-1042). These are frozen-ish
plain dataclasses used only during *config resolution*; the device compute
path consumes pure-array schedules (see gate/simulate.py), never these objects.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

from .constants import C, HBAR, TWO_PI
from . import atom_data
from .atom_data import SpeciesData, get_species


# =============================================================================
# lasers
# =============================================================================

# =============================================================================
# protocol-specific simulation inputs
# =============================================================================

# =============================================================================
# tweezer / environment
# =============================================================================

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
    def rydberg_energy(self) -> float:
        return atom_data.get_rydberg_energy(self.n_rydberg, self.species, self.L_rydberg)

    @property
    def is_clock_transition(self) -> bool:
        return self.qubit_0[1] == 0 and self.qubit_1[1] == 0

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
