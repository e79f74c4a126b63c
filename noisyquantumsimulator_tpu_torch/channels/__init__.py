from . import calibration, conversions, pauli, tomography  # noqa: F401
from .tomography import extract_cz_channel, ExtractedChannel  # noqa: F401
from .calibration import CalibrationStore, calibrate_cz  # noqa: F401
