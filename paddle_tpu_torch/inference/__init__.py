from .prefix_cache import PrefixCache
from .serving import (EngineOverloadedError, PagedCausalLM,
                      PagedServingConfig, SamplingParams, ServingEngine,
                      sample_logits, sampling_salt)
from .speculative import DraftModelDrafter, Drafter, NGramDrafter

__all__ = ["EngineOverloadedError", "PagedCausalLM", "PagedServingConfig",
           "SamplingParams", "ServingEngine", "sample_logits",
           "sampling_salt", "PrefixCache", "Drafter", "NGramDrafter",
           "DraftModelDrafter"]
