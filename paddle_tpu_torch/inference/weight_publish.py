"""Building a live weight set for the serving engine.

Port of ``build_weight_set`` of paddle_tpu/inference/weight_publish.py
(:114-151), and the host-side helpers the engine's ``stage_weight_set``
shares with it. A set is the engine's flat weight list: the floating
parameters cast to the serving dtype, in sorted name order (the order
``jax.tree_util.tree_flatten`` gives a dict in the reference), each
streamed decoder Linear a 0-d placeholder under ``weight_stream``, then
its codes and scales, (kind, layer) in STREAM_KINDS order. The reference's
host arrays and CRC-32s slot in position for position.

The transport (``send_weight_set`` / ``receive_weight_set``), the canary
and the rollout controller (``WeightPublisher``) wait for the fleet tier
(ROADMAP.md, queue 1).
"""
from __future__ import annotations

import zlib
from typing import List, Tuple

import numpy as np
import torch

from .weight_stream import WeightStreamer

__all__ = ["build_weight_set", "host_tensor", "crc32"]


def host_tensor(a) -> torch.Tensor:
    """A weight-set entry as a contiguous CPU tensor of its own dtype: a
    tensor (any device), or a numpy array; bfloat16 arrives as ml_dtypes'
    type from the reference and keeps its bits."""
    if isinstance(a, torch.Tensor):
        return a.detach().contiguous().cpu()
    a = np.asarray(a)
    if not (a.flags.c_contiguous and a.flags.writeable):
        a = a.copy(order="C")          # ascontiguousarray makes 0-d 1-d
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def crc32(t: torch.Tensor) -> int:
    """CRC-32 of a CPU tensor's bytes in C order: the reference's
    ``zlib.crc32(array.tobytes())``."""
    raw = t.contiguous().reshape(-1).view(torch.uint8).numpy()
    return zlib.crc32(raw) & 0xFFFFFFFF


def build_weight_set(model, params, cfg, weight_stream=None
                     ) -> Tuple[List[torch.Tensor], List[int]]:
    """Run new parameters through ``ServingEngine.from_model``'s serving
    pipeline: floating entries cast to ``cfg.dtype``, the decoder Linear
    stacks quantized out under ``weight_stream`` (int8 per channel or int4
    grouped, each replaced by the 0-d placeholder), the entries in sorted
    name order with the streamed codes and scales after them. ``params``
    maps ``model``'s parameter names to tensors or numpy arrays (None: the
    model's own). Returns ``(host tensors, crcs)`` in exactly the flat order
    of an engine built with the same ``(cfg.dtype, weight_stream)``, which
    ``stage_weight_set`` accepts position for position."""
    if params is None:
        params = dict(model.named_parameters())
    tgt = cfg.torch_dtype
    cast = {}
    for name, a in params.items():
        t = a.detach() if isinstance(a, torch.Tensor) else host_tensor(a)
        if t.is_floating_point():
            t = t.to(tgt)               # on its own device: the same bits
        cast[name] = t.cpu()
    flat = []
    if weight_stream is not None:
        streamer = WeightStreamer.build(
            model, cast, tgt, prefetch=weight_stream != "int8-noprefetch",
            mode="int4" if weight_stream == "int4" else "int8",
            device="cpu")
        flat = streamer.flat()
    host = [cast[n].contiguous() for n in sorted(cast)] + flat
    return host, [crc32(t) for t in host]
