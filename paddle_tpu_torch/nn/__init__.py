"""Layers and functional ops (paddle_tpu/nn): the eager Layers, and the
torch.nn.Module layers the serving model is built of (``nn.modules``)."""
from . import functional, initializer, modules
from .layer import (GELU, CrossEntropyLoss, Dropout, Embedding, Layer,
                    LayerDict, LayerList, LayerNorm, Linear, MSELoss,
                    MultiHeadAttention, ParameterList, ReLU, RMSNorm,
                    Sequential, Tanh, TransformerEncoder,
                    TransformerEncoderLayer)

__all__ = ["functional", "initializer", "modules", "Layer", "Sequential",
           "LayerList", "ParameterList", "LayerDict", "Linear", "Embedding",
           "Dropout", "LayerNorm", "RMSNorm", "ReLU", "GELU", "Tanh",
           "CrossEntropyLoss", "MSELoss", "MultiHeadAttention",
           "TransformerEncoderLayer", "TransformerEncoder"]
