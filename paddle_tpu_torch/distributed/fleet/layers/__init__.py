"""fleet.layers (paddle_tpu/distributed/fleet/layers/)."""
from . import mpu

__all__ = ["mpu"]
