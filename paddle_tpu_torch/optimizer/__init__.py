"""Optimizers of the eager surface (paddle_tpu/optimizer)."""
from .optimizer import SGD, Adam, AdamW, ClipGradByGlobalNorm, Optimizer

__all__ = ["Optimizer", "SGD", "Adam", "AdamW", "ClipGradByGlobalNorm"]
