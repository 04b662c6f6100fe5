from .activation import GELU, ReLU, Tanh
from .common import Dropout, Embedding, Linear
from .layers import Layer, LayerDict, LayerList, ParameterList, Sequential
from .loss import CrossEntropyLoss, MSELoss
from .norm import LayerNorm, RMSNorm
from .transformer import (MultiHeadAttention, TransformerEncoder,
                          TransformerEncoderLayer)

__all__ = ["Layer", "Sequential", "LayerList", "ParameterList", "LayerDict",
           "Linear", "Embedding", "Dropout", "LayerNorm", "RMSNorm", "ReLU",
           "GELU", "Tanh", "CrossEntropyLoss", "MSELoss", "MultiHeadAttention",
           "TransformerEncoderLayer", "TransformerEncoder"]
