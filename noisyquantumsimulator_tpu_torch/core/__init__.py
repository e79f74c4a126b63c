"""Host data: constants, species tables and configuration dataclasses."""
from .constants import *  # noqa: F401,F403
from .atom_data import *  # noqa: F401,F403
from .configs import *  # noqa: F401,F403
