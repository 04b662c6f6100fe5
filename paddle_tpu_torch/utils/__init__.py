from .convert import (load_params_from_paddle_tpu, params_from_paddle_tpu,
                      stacked_params_from_paddle_tpu,
                      stage_state_dict_from_paddle_tpu,
                      state_dict_from_paddle_tpu)

__all__ = ["params_from_paddle_tpu", "stacked_params_from_paddle_tpu",
           "load_params_from_paddle_tpu", "state_dict_from_paddle_tpu",
           "stage_state_dict_from_paddle_tpu"]
