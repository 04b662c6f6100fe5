from .serving import (EngineOverloadedError, PagedCausalLM,
                      PagedServingConfig, SamplingParams, ServingEngine,
                      sample_logits, sampling_salt)

__all__ = ["EngineOverloadedError", "PagedCausalLM", "PagedServingConfig",
           "SamplingParams", "ServingEngine", "sample_logits",
           "sampling_salt"]
