from .convert import params_from_paddle_tpu, stacked_params_from_paddle_tpu

__all__ = ["params_from_paddle_tpu", "stacked_params_from_paddle_tpu"]
