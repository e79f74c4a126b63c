"""Layer-1 primitives: the neutral-atom and trapped-ion backends and their
operations (counterpart of the reference's `primitives/` package)."""
from .base import *  # noqa: F401,F403
from .gates import SingleQubitGate, TwoQubitGate  # noqa: F401
from .motion import Cool, Idle, Measure, Move  # noqa: F401
from .backend import NeutralAtomBackend  # noqa: F401
from .ion_backend import IonBackend  # noqa: F401
