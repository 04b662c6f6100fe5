from . import kernels

__all__ = ["kernels"]
