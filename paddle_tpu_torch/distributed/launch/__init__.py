"""The launch CLI (paddle_tpu/distributed/launch): ``python -m
paddle_tpu_torch.distributed.launch``."""
from . import main
