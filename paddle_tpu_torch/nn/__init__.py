"""Layers and functional ops (paddle_tpu/nn): the eager Layers, and the
torch.nn.Module layers the serving model is built of (``nn.modules``)."""
from . import functional, initializer, modules
from .layer import (Embedding, Layer, LayerDict, LayerList, Linear,
                    ParameterList, RMSNorm, Sequential)

__all__ = ["functional", "initializer", "modules", "Layer", "Sequential",
           "LayerList", "ParameterList", "LayerDict", "Linear", "Embedding",
           "RMSNorm"]
