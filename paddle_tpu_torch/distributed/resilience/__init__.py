"""Fault-tolerance errors of the ported slices
(paddle_tpu/distributed/resilience)."""
from .errors import PublishRejectedError, WeightTransferError

__all__ = ["PublishRejectedError", "WeightTransferError"]
