from .recompute import recompute
from .trainer import HybridTrainer

__all__ = ["HybridTrainer", "recompute"]
