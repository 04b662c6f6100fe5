"""Fused layers of the ported slices (paddle_tpu/incubate/nn/layer.py)."""
from __future__ import annotations

from ... import nn

__all__ = ["FusedEcMoe"]


class FusedEcMoe(nn.Layer):
    """The expert-computation MoE block (reference
    incubate/nn/layer/fused_ec_moe.py) over ``functional.fused_ec_moe``."""

    def __init__(self, hidden_size, inter_size, num_experts,
                 act_type="gelu", weight_attr=None, bias_attr=None):
        super().__init__()
        if act_type not in ("gelu", "relu"):
            raise ValueError("act_type must be gelu or relu")
        self.act_type = act_type
        self.bmm0_weight = self.create_parameter(
            [num_experts, hidden_size, inter_size])
        self.bmm0_bias = self.create_parameter(
            [num_experts, 1, inter_size], is_bias=True)
        self.bmm1_weight = self.create_parameter(
            [num_experts, inter_size, hidden_size])
        self.bmm1_bias = self.create_parameter(
            [num_experts, 1, hidden_size], is_bias=True)

    def forward(self, x, gate):
        from . import functional as IF

        return IF.fused_ec_moe(x, gate, self.bmm0_weight, self.bmm0_bias,
                               self.bmm1_weight, self.bmm1_bias,
                               self.act_type)
