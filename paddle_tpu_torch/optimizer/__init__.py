"""Optimizers of the eager surface (paddle_tpu/optimizer) and their LR
schedulers (``optimizer.lr``)."""
from . import lr
from .optimizer import (SGD, Adam, AdamW, ClipGradByGlobalNorm, Momentum,
                        Optimizer)

__all__ = ["lr", "Optimizer", "SGD", "Momentum", "Adam", "AdamW",
           "ClipGradByGlobalNorm"]
