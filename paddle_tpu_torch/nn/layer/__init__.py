from . import conv, pooling
from .activation import GELU, ReLU, Tanh
from .common import Dropout, Embedding, Linear
from .conv import (Conv1D, Conv1DTranspose, Conv2D, Conv2DTranspose, Conv3D,
                   Conv3DTranspose)
from .layers import Layer, LayerDict, LayerList, ParameterList, Sequential
from .loss import CrossEntropyLoss, MSELoss
from .norm import (BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D,
                   LayerNorm, RMSNorm, SyncBatchNorm)
from .pooling import (AdaptiveAvgPool1D, AdaptiveAvgPool2D, AdaptiveAvgPool3D,
                      AdaptiveMaxPool1D, AdaptiveMaxPool2D, AdaptiveMaxPool3D,
                      AvgPool1D, AvgPool2D, AvgPool3D, MaxPool1D, MaxPool2D,
                      MaxPool3D)
from .transformer import (MultiHeadAttention, TransformerEncoder,
                          TransformerEncoderLayer)

__all__ = ["Layer", "Sequential", "LayerList", "ParameterList", "LayerDict",
           "Linear", "Embedding", "Dropout", "LayerNorm", "RMSNorm", "ReLU",
           "GELU", "Tanh", "CrossEntropyLoss", "MSELoss", "MultiHeadAttention",
           "TransformerEncoderLayer", "TransformerEncoder"] \
    + conv.__all__ + pooling.__all__ + ["BatchNorm", "BatchNorm1D",
                                        "BatchNorm2D", "BatchNorm3D",
                                        "SyncBatchNorm"]
