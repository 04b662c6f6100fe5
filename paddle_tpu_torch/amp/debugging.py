"""AMP debugging: the numeric checks the training loop's guard shares
(paddle_tpu/amp/debugging.py, reference python/paddle/amp/debugging.py).

``nonfinite_counts`` is the finiteness probe of
``distributed.resilience.guards.StepGuard``; ``enable_tensor_checker`` in
``CHECK_NAN_INF_AND_ABORT`` mode hangs an observer on the op funnel
(``core/dispatch.py``'s ``op_observers``) that raises
``FloatingPointError`` at the first eager op whose float output is not
finite (each check synchronises with the device: a debugging tool). The
rest of the reference's module (operator statistics, accuracy compare)
is not ported yet.
"""
from __future__ import annotations

import json
import os
from enum import Enum
from typing import Optional

import numpy as np

__all__ = ["DebugMode", "TensorCheckerConfig", "nonfinite_counts",
           "enable_tensor_checker", "disable_tensor_checker"]


class DebugMode(Enum):
    """reference debugging.py DebugMode."""

    CHECK_NAN_INF_AND_ABORT = 0
    CHECK_NAN_INF = 1
    CHECK_ALL_FOR_OVERFLOW = 2
    CHECK_ALL = 3


def _leaf_stats(a):
    """dtype, shape and NaN / Inf counts of a float array-like (a torch
    tensor, an eager Tensor, a numpy array, a Python number), or None for
    other data."""
    import torch

    from ..core.tensor import Tensor

    if isinstance(a, Tensor):
        a = a._value
    if isinstance(a, torch.Tensor):
        if not (a.is_floating_point() or a.is_complex()):
            return None
        return {"dtype": str(a.dtype).rsplit(".", 1)[-1],
                "shape": list(a.shape),
                "num_nan": int(torch.isnan(a).sum()),
                "num_inf": int(torch.isinf(a).sum())}
    try:
        arr = np.asarray(a)
    except Exception:
        return None
    if arr.dtype.kind not in "fc":
        return None
    return {"dtype": str(arr.dtype), "shape": list(arr.shape),
            "num_nan": int(np.isnan(arr).sum()),
            "num_inf": int(np.isinf(arr).sum())}


def nonfinite_counts(value) -> tuple:
    """(num_nan, num_inf) for any array-like (0, 0 for non-float data).

    The shared finiteness probe: ``resilience.guards.StepGuard`` calls
    this on losses/grad-norms so the training-loop numerical guard and
    the per-op tensor checker agree on what "non-finite" means."""
    st = _leaf_stats(value)
    if st is None:
        return (0, 0)
    return (st["num_nan"], st["num_inf"])


class TensorCheckerConfig:
    def __init__(self, enable=True,
                 debug_mode=DebugMode.CHECK_NAN_INF_AND_ABORT,
                 output_dir=None, checked_op_list=None,
                 skipped_op_list=None, debug_step=None,
                 stack_height_limit=1):
        self.enable = enable
        self.debug_mode = debug_mode
        self.output_dir = output_dir
        self.checked_op_list = set(checked_op_list or ())
        self.skipped_op_list = set(skipped_op_list or ())
        self.debug_step = debug_step
        self._log = None

    def _want(self, op_name):
        if self.checked_op_list and op_name not in self.checked_op_list:
            return False
        return op_name not in self.skipped_op_list


_checker: Optional[TensorCheckerConfig] = None


def _checker_observer(name, leaves):
    cfg = _checker
    if cfg is None or not cfg._want(name):
        return
    for i, a in enumerate(leaves):
        st = _leaf_stats(a)
        if st is None:
            continue
        if cfg._log is not None:
            cfg._log.write(json.dumps(dict(st, op=name, output_index=i))
                           + "\n")
            cfg._log.flush()
        if st["num_nan"] or st["num_inf"]:
            msg = (f"[tensor_checker] op [{name}] output {i} has "
                   f"{st['num_nan']} NaN / {st['num_inf']} Inf "
                   f"(shape {st['shape']}, dtype {st['dtype']})")
            if cfg.debug_mode == DebugMode.CHECK_NAN_INF_AND_ABORT:
                raise FloatingPointError(msg)
            print("WARNING:", msg)


def enable_tensor_checker(checker_config: TensorCheckerConfig):
    """Install the per-op output checker (reference
    enable_tensor_checker). With output_dir set, every float output's
    NaN / Inf counts stream to <output_dir>/tensor_stats.jsonl."""
    global _checker
    from ..core import dispatch

    if not checker_config.enable:
        return
    _checker = checker_config
    if checker_config.output_dir:
        os.makedirs(checker_config.output_dir, exist_ok=True)
        checker_config._log = open(
            os.path.join(checker_config.output_dir,
                         "tensor_stats.jsonl"), "w")
    dispatch.add_op_observer(_checker_observer)


def disable_tensor_checker():
    global _checker
    from ..core import dispatch

    dispatch.remove_op_observer(_checker_observer)
    if _checker is not None and _checker._log is not None:
        _checker._log.close()
        _checker._log = None
    _checker = None
