"""The AMP cast policy the op funnel consults (paddle_tpu/core/amp_state.py).

Under ``amp.auto_cast`` the float inputs of a white-listed op are cast to
the AMP dtype, those of a black-listed op to float32; at O2 every op not
black-listed runs in the AMP dtype. The lists are the TPU package's.
"""
from __future__ import annotations

import threading

import torch

__all__ = ["WHITE_LIST", "BLACK_LIST", "amp_enabled", "amp_dtype",
           "amp_level", "set_amp", "restore_amp", "snapshot", "cast_policy"]

# ops that gain from low precision (matmul class: the tensor cores)
WHITE_LIST = {
    "matmul", "bmm", "mm", "mv", "linear", "conv1d", "conv2d", "conv3d",
    "conv1d_transpose", "conv2d_transpose", "conv3d_transpose", "einsum",
    "addmm", "scaled_dot_product_attention", "flash_attention",
}

# ops that must stay float32 for numerics
BLACK_LIST = {
    "exp", "log", "log2", "log10", "log1p", "expm1", "pow", "square",
    "reciprocal", "rsqrt", "softmax", "log_softmax", "cross_entropy",
    "softmax_with_cross_entropy", "layer_norm", "batch_norm", "group_norm",
    "instance_norm", "rms_norm", "mse_loss", "l1_loss", "nll_loss",
    "binary_cross_entropy", "bce_with_logits", "kl_div", "sum", "mean",
    "logsumexp", "norm", "cumsum", "erf", "erfinv",
}

# the float dtypes an op's inputs are cast from
CASTABLE = (torch.float32, torch.bfloat16, torch.float16)


class _AmpState(threading.local):
    def __init__(self):
        self.enabled = False
        self.dtype = None
        self.level = "O1"
        self.custom_white = frozenset()
        self.custom_black = frozenset()


_state = _AmpState()


def amp_enabled():
    return _state.enabled


def amp_dtype():
    return _state.dtype


def amp_level():
    return _state.level


def snapshot():
    """The whole state, for ``restore_amp`` (recompute replays a forward
    under the state it first ran in)."""
    return (_state.enabled, _state.dtype, _state.level, _state.custom_white,
            _state.custom_black)


def set_amp(enabled, dtype=None, level="O1", custom_white=None,
            custom_black=None):
    prev = snapshot()
    _state.enabled = enabled
    _state.dtype = dtype
    _state.level = level
    _state.custom_white = frozenset(custom_white or ())
    _state.custom_black = frozenset(custom_black or ())
    return prev


def restore_amp(prev):
    (_state.enabled, _state.dtype, _state.level, _state.custom_white,
     _state.custom_black) = prev


def cast_policy(op_name):
    """The dtype an op's float inputs are cast to, or None."""
    if not _state.enabled:
        return None
    name = op_name or ""
    if name in _state.custom_black or name in BLACK_LIST:
        return torch.float32
    if _state.level == "O2":
        return _state.dtype
    if name in _state.custom_white or name in WHITE_LIST:
        return _state.dtype
    return None
