"""Layers and functional ops (paddle_tpu/nn): the eager Layers, and the
torch.nn.Module layers the serving model is built of (``nn.modules``)."""
from . import functional, initializer, layer, modules
from .layer import *  # noqa: F401,F403

__all__ = ["functional", "initializer", "modules"] + layer.__all__
