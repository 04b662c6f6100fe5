from . import moe

__all__ = ["moe"]
