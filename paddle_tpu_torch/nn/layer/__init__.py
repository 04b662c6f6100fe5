from .common import Embedding, Linear
from .layers import Layer, LayerDict, LayerList, ParameterList, Sequential
from .norm import RMSNorm

__all__ = ["Layer", "Sequential", "LayerList", "ParameterList", "LayerDict",
           "Linear", "Embedding", "RMSNorm"]
