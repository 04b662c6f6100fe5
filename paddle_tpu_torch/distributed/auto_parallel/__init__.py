"""Auto-parallel over DTensor (paddle_tpu/distributed/auto_parallel):
ProcessMesh, the placements, shard_tensor / reshard / to_static, and the
Engine."""
from . import api
from .api import (DistModel, dtensor_from_fn, reshard, shard_layer,
                  shard_optimizer, shard_tensor, to_static, unshard_dtensor)
from .placement import Partial, Placement, Replicate, Shard
from .process_mesh import ProcessMesh
from .static_engine import Engine, Strategy
