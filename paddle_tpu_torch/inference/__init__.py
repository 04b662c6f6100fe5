from .prefix_cache import PrefixCache
from .serving import (EngineOverloadedError, PagedCausalLM,
                      PagedServingConfig, SamplingParams, ServingEngine,
                      sample_logits, sampling_salt)
from .speculative import DraftModelDrafter, Drafter, NGramDrafter
from .weight_publish import build_weight_set
from .weight_stream import WeightStreamer, measure_stream_win

__all__ = ["EngineOverloadedError", "PagedCausalLM", "PagedServingConfig",
           "SamplingParams", "ServingEngine", "sample_logits",
           "sampling_salt", "PrefixCache", "Drafter", "NGramDrafter",
           "DraftModelDrafter", "WeightStreamer", "measure_stream_win",
           "build_weight_set"]
