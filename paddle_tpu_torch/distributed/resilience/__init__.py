"""Fault tolerance of the ported slices (paddle_tpu/distributed/
resilience): its errors and the backoff of every retry loop."""
from . import backoff
from .errors import (PublishRejectedError, StaleGenerationError,
                     StoreTimeoutError, TransportError, WeightTransferError)

__all__ = ["backoff", "PublishRejectedError", "WeightTransferError",
           "TransportError", "StoreTimeoutError", "StaleGenerationError"]
