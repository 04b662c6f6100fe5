"""Layers and functional ops of the ported slice (paddle_tpu/nn)."""
from . import functional
from .layer import Embedding, Linear, RMSNorm

__all__ = ["functional", "Embedding", "Linear", "RMSNorm"]
