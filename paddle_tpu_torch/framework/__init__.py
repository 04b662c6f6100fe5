"""Framework state (paddle_tpu/framework): the RNG."""
from . import random

__all__ = ["random"]
