"""Framework state (paddle_tpu/framework): the RNG, and save / load."""
from . import io, random
from .io import async_save, clear_async_save_task_queue, load, save

__all__ = ["random", "io", "save", "load", "async_save",
           "clear_async_save_task_queue"]
