"""Lindblad propagators, the real Hermitian-basis phase-frame scan, the
exact circuit simulators and the zvode oracle."""
from .propagator import *  # noqa: F401,F403
from . import circuit_sim, reference  # noqa: F401
from .circuit_sim import DensityMatrixSimulator, TrajectorySimulator  # noqa: F401
