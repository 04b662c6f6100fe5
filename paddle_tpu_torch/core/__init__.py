"""The eager core: dtypes, places, Tensor, grad mode, the op funnel and the
AMP state (paddle_tpu/core)."""
