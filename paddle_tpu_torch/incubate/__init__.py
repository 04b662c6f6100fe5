from . import distributed, nn

__all__ = ["distributed", "nn"]
