"""incubate.distributed (paddle_tpu/incubate/distributed): the MoE model
with expert parallelism."""
from . import models

__all__ = ["models"]
