"""Exception types (the port's own copy of `utils/exceptions.py`).

The reference's SLAMException analogue. The numerical core raises nothing
(it returns masked validity instead); these are raised by the host-side
layers: I/O, config, orchestration and checkpoints.
"""


class SlamError(Exception):
    """Base error for stereovision_slam_torch (the SLAMException analogue)."""


class DatasetError(SlamError):
    """Missing calibration or images."""


class ConfigError(SlamError):
    """Malformed or missing configuration."""


class CheckpointError(SlamError):
    """Incompatible or corrupt checkpoint."""
