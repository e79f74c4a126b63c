"""Apparatus constraints and result containers for CZ optimization (host).

Counterpart of the reference's `optimize/apparatus.py`: the apparatus and
bookkeeping half of the forward optimizer (optimize_cz_gate.py:152-360,
711-785). Host code only; no tensors.
"""
from __future__ import annotations

import hashlib
import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..core.constants import TWO_PI
from ..core.configs import (LaserParameters, NoiseSourceConfig,
                            TwoPhotonExcitationConfig)


@dataclass
class ApparatusConstraints:
    """Fixed experimental parameters the optimizer cannot change.
    (optimize_cz_gate.py:152-283)"""
    laser_1_power: float = 50e-6
    laser_1_waist: float = 50e-6
    laser_2_power: float = 0.3
    laser_2_waist: float = 50e-6
    Delta_e: float = TWO_PI * 1e9
    laser_1_linewidth_hz: float = 100.0
    laser_2_linewidth_hz: float = 100.0
    temperature: float = 2e-6
    spacing_factor: float = 2.8
    n_rydberg: int = 70
    species: str = "Rb87"
    tweezer_power: float = 0.020
    tweezer_waist: float = 0.8e-6
    B_field: float = 1e-4
    NA: float = 0.5
    counter_propagating: bool = True

    def fingerprint(self) -> str:
        key_vals = (
            round(self.laser_1_power, 8), round(self.laser_1_waist, 8),
            round(self.laser_2_power, 8), round(self.laser_2_waist, 8),
            round(self.Delta_e, 2), self.n_rydberg,
            round(self.spacing_factor, 4), round(self.temperature, 10),
            self.species, round(self.tweezer_power, 6),
            round(self.tweezer_waist, 8), round(self.NA, 3),
        )
        return hashlib.md5(str(key_vals).encode()).hexdigest()[:12]

    def make_excitation_config(self, pol_purity: float = 1.0
                               ) -> TwoPhotonExcitationConfig:
        return TwoPhotonExcitationConfig(
            laser_1=LaserParameters(power=self.laser_1_power,
                                    waist=self.laser_1_waist,
                                    polarization="pi",
                                    polarization_purity=pol_purity,
                                    linewidth_hz=self.laser_1_linewidth_hz),
            laser_2=LaserParameters(power=self.laser_2_power,
                                    waist=self.laser_2_waist,
                                    polarization="sigma+",
                                    polarization_purity=pol_purity,
                                    linewidth_hz=self.laser_2_linewidth_hz),
            Delta_e=self.Delta_e,
            counter_propagating=self.counter_propagating,
        )

    @staticmethod
    def make_noiseless() -> NoiseSourceConfig:
        return NoiseSourceConfig.noiseless()

    @staticmethod
    def make_full_noise() -> NoiseSourceConfig:
        return NoiseSourceConfig.full()

    def sim_kwargs(self) -> Dict[str, Any]:
        """Keyword arguments for plan_cz_gate/simulate_cz_gate."""
        return dict(species=self.species, n_rydberg=self.n_rydberg,
                    tweezer_power=self.tweezer_power,
                    tweezer_waist=self.tweezer_waist,
                    temperature=self.temperature, B_field=self.B_field,
                    NA=self.NA, spacing_factor=self.spacing_factor)


class SimulationCache:
    """Memoization keyed by rounded parameter tuples, JSON-persistable.
    (optimize_cz_gate.py:284-360)

    Mostly unnecessary here (a generation is one batched device call) but
    kept for API parity and for host-loop optimizers.
    """

    def __init__(self, precision: int = 4):
        self._store: Dict[str, Tuple[float, Dict]] = {}
        self.precision = precision
        self.hits = 0
        self.misses = 0

    def make_key(self, protocol: str, params, apparatus_hash: str = "") -> str:
        rounded = tuple(round(float(p), self.precision) for p in params)
        return f"{apparatus_hash}|{protocol}|{rounded}"

    def __contains__(self, key):
        return key in self._store

    def __getitem__(self, key):
        self.hits += 1
        return self._store[key]

    def __setitem__(self, key, value):
        self._store[key] = value

    def __len__(self):
        return len(self._store)

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def save(self, path: str):
        data = {"precision": self.precision,
                "entries": {k: {"cost": v[0], "metrics": v[1]}
                            for k, v in self._store.items()}}
        with open(path, "w") as f:
            json.dump(data, f, indent=2, default=str)

    def load(self, path: str):
        if not os.path.exists(path):
            return
        with open(path) as f:
            data = json.load(f)
        self.precision = data.get("precision", self.precision)
        for k, v in data.get("entries", {}).items():
            self._store[k] = (v["cost"], v["metrics"])


_global_cache = SimulationCache(precision=4)


@dataclass
class OptimizationResult:
    """(optimize_cz_gate.py:711-785)"""
    success: bool
    protocol: str
    best_params: np.ndarray
    param_names: List[str]
    best_cost: float
    best_metrics: Dict[str, float]
    n_evaluations: int
    runtime_s: float
    discrete_variant: str = ""
    all_variants: Dict[str, Any] = field(default_factory=dict)
    cache_hits: int = 0
    history: List[float] = field(default_factory=list)

    def __repr__(self):
        m = self.best_metrics
        return (f"OptimizationResult({self.protocol}, success={self.success}, "
                f"F={m.get('avg_fidelity', float('nan')):.6f}, "
                f"cost={self.best_cost:.4f}, evals={self.n_evaluations}, "
                f"t={self.runtime_s:.1f}s)")


__all__ = ["ApparatusConstraints", "SimulationCache", "_global_cache",
           "OptimizationResult"]
