"""The high-level API (paddle_tpu/hapi): Model, its callbacks and
summary."""
from . import callbacks
from .model import Model
from .summary import summary

__all__ = ["callbacks", "Model", "summary"]
