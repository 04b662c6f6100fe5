from . import functional
from .layer import FusedEcMoe

__all__ = ["functional", "FusedEcMoe"]
