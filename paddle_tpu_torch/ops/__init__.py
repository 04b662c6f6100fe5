"""The eager op surface of the ported slices (paddle_tpu/ops) and the CUDA
kernels (``ops.kernels``).

The ops are patched onto Tensor as methods and operators
(``patch_tensor_methods``, ops/__init__.py:34), at import time. Importing
``yaml_extra`` registers the attention ops of the op registry.
"""
import operator as _operator

from . import kernels, registry, yaml_extra
from .creation import *  # noqa: F401,F403
from .linalg import *  # noqa: F401,F403
from .manipulation import *  # noqa: F401,F403
from .math import *  # noqa: F401,F403
from .search import *  # noqa: F401,F403
from . import creation, linalg, manipulation, math, search
from ..core.tensor import Tensor

__all__ = (["kernels", "registry", "yaml_extra", "patch_tensor_methods"]
           + creation.__all__ + linalg.__all__ + manipulation.__all__
           + math.__all__ + search.__all__)

_METHOD_SOURCES = [creation, linalg, manipulation, math, search]
# names that are not methods of a Tensor
_SKIP_METHODS = {"to_tensor", "zeros", "ones", "full", "arange", "promote",
                 "zeros_like"}


def patch_tensor_methods():
    for mod in _METHOD_SOURCES:
        for name in mod.__all__:
            if name in _SKIP_METHODS or hasattr(Tensor, name):
                continue
            setattr(Tensor, name, getattr(mod, name))
    Tensor.__add__ = Tensor.__radd__ = math.add
    Tensor.__sub__ = math.subtract
    Tensor.__rsub__ = math.reflected("subtract", _operator.sub)
    Tensor.__mul__ = Tensor.__rmul__ = math.multiply
    Tensor.__truediv__ = math.divide
    Tensor.__rtruediv__ = math.reflected("divide", _operator.truediv)
    Tensor.__pow__ = math.pow
    Tensor.__rpow__ = math.reflected("pow", _operator.pow)
    Tensor.__neg__ = math.neg
    Tensor.__abs__ = math.abs
    Tensor.__matmul__ = linalg.matmul
    Tensor.__eq__ = math.equal
    Tensor.__ne__ = math.not_equal
    Tensor.__lt__ = math.less_than
    Tensor.__le__ = math.less_equal
    Tensor.__gt__ = math.greater_than
    Tensor.__ge__ = math.greater_equal
    Tensor.__hash__ = object.__hash__


patch_tensor_methods()
