"""fleet.layers.mpu: the model-parallel layers
(paddle_tpu/distributed/fleet/layers/mpu/__init__.py). The layers live in
distributed/meta_parallel/mp_layers.py, as in the reference, and are read
from there on first use (mp_layers imports mp_ops from here)."""
from . import mp_ops  # noqa: F401

__all__ = ["VocabParallelEmbedding", "ColumnParallelLinear",
           "RowParallelLinear", "ParallelCrossEntropy", "mp_ops"]


def __getattr__(name):
    if name in __all__:
        from ....meta_parallel import mp_layers

        return getattr(mp_layers, name)
    raise AttributeError(name)
