from .trainer import HybridTrainer

__all__ = ["HybridTrainer"]
