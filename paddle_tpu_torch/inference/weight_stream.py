"""int8 / int4 weight streaming for the paged serving decoder.

Port of paddle_tpu/inference/weight_stream.py. Each decoder Linear stack
weight (qkv / proj / gate_up / down) is kept on the device quantized, int8
with one f32 scale an output channel or int4 with one a (32-row input
group, output channel), and dequantized a layer group at a time into a
workspace slot just before use (``dequant_layer``, through the
hand-written kernel of ops/kernels/weight_dequant.py on a CUDA tensor).
``prefetch=True`` issues layer i+1's group before layer i's compute; on
the card ``PagedCausalLM.forward`` runs it on a side stream into the other
of two slots, so it overlaps the GEMMs it does not feed.

What streaming buys on an H100 differs from the TPU: a decode step there
is not bound by reading its weights (PERF.md §5), and dequantizing into a
bf16 workspace before cuBLAS adds bytes to the step. It buys device
memory: the streamed weights' codes take half (int8) or about a quarter
(int4) of their bf16 bytes.

Numerics: a streaming engine's generations equal, bit for bit, those of a
plain engine over the DEQUANTIZED weights. The quantizers take the weights
after the cast to the serving dtype (the reference quantizes the cast
tree) and run in numpy on the host, with the reference's arithmetic.
"""
from __future__ import annotations

import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..ops.kernels.weight_dequant import (INT4_GROUP, dequantize,
                                          dequantize_int4, weight_dequant)
from ..profiler import metrics as _metrics

__all__ = ["STREAM_KINDS", "quantize_per_channel", "dequantize",
           "INT4_GROUP", "quantize_int4_grouped", "dequantize_int4",
           "WeightStreamer", "measure_stream_win"]

# the decoder Linear stacks streamed a layer (PagedCausalLM attribute names;
# the architecture has no biases)
STREAM_KINDS = ("qkv", "proj", "gate_up", "down")

_m_prefetch = _metrics.histogram("weights/stream_prefetch_ms")

# a segment's offset in a workspace slot is a multiple of this many bytes,
# the caching allocator's alignment: cuBLAS picks its kernel by the
# operands' alignment too, so a streamed weight must sit as a freshly
# allocated one would for the product to give a plain engine's bits
_SEGMENT_ALIGN = 512


def _host_f32(w) -> np.ndarray:
    """A weight (tensor on any device, or numpy array, bf16 included) as a
    float32 numpy array on the host; exact for bf16 and f32."""
    if isinstance(w, torch.Tensor):
        return w.detach().float().cpu().numpy()
    return np.asarray(w).astype(np.float32)


def quantize_per_channel(w) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric per-output-channel int8: ``w`` [in, out] float ->
    (int8 [in, out], f32 scale [out]) with w ~= q * scale
    (weight_stream.py:51-58)."""
    a = _host_f32(w)
    amax = np.max(np.abs(a), axis=0)
    scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.round(a / scale), -127, 127).astype(np.int8)
    return q, scale


def quantize_int4_grouped(w, group: int = INT4_GROUP
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric int4 with per-(input-group, out-channel) scales
    (weight_stream.py:76-96): ``w`` [in, out] float -> (packed uint8
    [in_pad // 2, out], f32 scales [n_groups, out]) with w ~= q * scale, q
    in [-7, 7]. Input rows pad to a multiple of ``group`` (zeros quantize to
    0); two 4-bit codes (stored biased, q + 8) pack a byte along the input
    axis, the even row in the high nibble."""
    a = _host_f32(w)
    d_in, d_out = a.shape
    n_g = -(-d_in // group)
    pad = n_g * group - d_in
    if pad:
        a = np.concatenate([a, np.zeros((pad, d_out), np.float32)])
    g = a.reshape(n_g, group, d_out)
    amax = np.max(np.abs(g), axis=1)                     # [n_g, out]
    scale = np.where(amax > 0, amax / 7.0, 1.0).astype(np.float32)
    q = np.clip(np.round(g / scale[:, None, :]), -7, 7)
    nib = (q.reshape(n_g * group, d_out) + 8).astype(np.uint8)
    packed = (nib[0::2] << 4) | nib[1::2]
    return packed, scale


class WeightStreamer:
    """A layer's quantized Linear group and its dequant.

    Built once at engine construction (``ServingEngine.from_model(...,
    weight_stream="int8")``): ``build`` takes the streamed weights out of
    the cast parameters (0-d placeholders keep their names, so the
    full-precision copies never stay on the device) and quantizes them on
    the host. ``flat`` gives the codes and scales in the engine's weight-set
    order; ``over`` gives the same streamer over another weight set's codes
    (a staged or committed version). The reference's ``bind`` rebinds the
    streamer to a jit's traced arrays; PyTorch runs eagerly, so it has no
    counterpart. ``dequant_layer`` writes a layer's group into a workspace
    slot (``workspace``)."""

    def __init__(self, num_layers: int, dtype, prefetch: bool = True,
                 mode: str = "int8"):
        if mode not in ("int8", "int4"):
            raise ValueError("weight stream mode must be 'int8' or "
                             "'int4'")
        self.num_layers = int(num_layers)
        self.dtype = dtype
        self.prefetch = bool(prefetch)
        self.mode = mode
        self._q: Dict[Tuple[str, int], torch.Tensor] = {}
        self._s: Dict[Tuple[str, int], torch.Tensor] = {}
        # each weight's [in, out]: the int4 codes lose `in` to the padding
        self._shape: Dict[Tuple[str, int], Tuple[int, int]] = {}

    @classmethod
    def build(cls, model, params: Dict[str, torch.Tensor], dtype,
              prefetch: bool = True, mode: str = "int8",
              device=None) -> "WeightStreamer":
        """Quantize the decoder Linear stacks out of ``params`` (name ->
        tensor of the cast parameters), replacing each streamed entry with a
        0-d placeholder of ``dtype``; codes and scales go to ``device``
        (default: the weight's)."""
        ws = cls(model.cfg.num_layers, dtype, prefetch, mode)
        for kind in STREAM_KINDS:
            for li in range(ws.num_layers):
                name = f"{kind}.{li}.weight"
                if name not in params:
                    raise KeyError(
                        f"weight streaming expects '{name}' in the "
                        f"parameters (PagedCausalLM layout); have e.g. "
                        f"{sorted(params)[:4]}")
                w = params[name]
                dev = w.device if device is None else device
                ws._shape[(kind, li)] = tuple(int(n) for n in w.shape)
                q, s = (quantize_int4_grouped(w) if mode == "int4"
                        else quantize_per_channel(w))
                ws._q[(kind, li)] = torch.from_numpy(q).to(dev)
                ws._s[(kind, li)] = torch.from_numpy(s).to(dev)
                params[name] = torch.zeros((), dtype=dtype, device=dev)
        return ws

    def _ordered_keys(self) -> List[Tuple[str, int]]:
        return [(kind, li) for kind in STREAM_KINDS
                for li in range(self.num_layers)]

    def flat(self) -> List[torch.Tensor]:
        """Codes and scales in a stable order, (kind, layer) in
        STREAM_KINDS order: the tail of the engine's flat weight set."""
        out = []
        for key in self._ordered_keys():
            out.append(self._q[key])
            out.append(self._s[key])
        return out

    def over(self, flat) -> "WeightStreamer":
        """This streamer's layout over ``flat`` (codes and scales in
        ``flat()``'s order: another weight set's tail)."""
        ws = WeightStreamer(self.num_layers, self.dtype, self.prefetch,
                            self.mode)
        ws._shape = self._shape
        it = iter(flat)
        for key in self._ordered_keys():
            ws._q[key] = next(it)
            ws._s[key] = next(it)
        return ws

    def _offsets(self):
        """{kind: element offset in a slot} and the slot's elements."""
        align = _SEGMENT_ALIGN // torch.empty((), dtype=self.dtype) \
            .element_size()
        offs, o = {}, 0
        for kind in STREAM_KINDS:
            n_in, n_out = self._shape[(kind, 0)]
            offs[kind] = o
            o += -(-n_in * n_out // align) * align
        return offs, o

    def workspace(self, device, slots: int = 2) -> List[torch.Tensor]:
        """``slots`` flat buffers of self.dtype on ``device``, each holding
        one layer's group (``slot_views``)."""
        _, n = self._offsets()
        return [torch.empty(n, dtype=self.dtype, device=device)
                for _ in range(slots)]

    def slot_views(self, slot) -> Dict[str, torch.Tensor]:
        """{kind: [in, out] view of ``slot``} (every layer's group has the
        same shapes)."""
        offs, _ = self._offsets()
        views = {}
        for kind in STREAM_KINDS:
            n_in, n_out = self._shape[(kind, 0)]
            views[kind] = slot[offs[kind]:offs[kind] + n_in * n_out] \
                .view(n_in, n_out)
        return views

    def dequant_layer(self, li: int, out=None) -> Dict[str, torch.Tensor]:
        """Dequantize layer ``li``'s whole Linear group into ``out`` (a
        workspace slot, or its ``slot_views``; None: new tensors) and return
        it as {kind: [in, out]}. One kernel launch on a CUDA tensor, the
        plain versions on a CPU one. Where the call sits in the step is the
        prefetch: issued one layer early under ``prefetch=True``."""
        if out is None:
            out = {kind: torch.empty(self._shape[(kind, li)],
                                     dtype=self.dtype,
                                     device=self._q[(kind, li)].device)
                   for kind in STREAM_KINDS}
        elif isinstance(out, torch.Tensor):
            out = self.slot_views(out)
        weight_dequant([(self._q[(kind, li)], self._s[(kind, li)],
                         self._shape[(kind, li)][0])
                        for kind in STREAM_KINDS],
                       [out[kind] for kind in STREAM_KINDS])
        return out

    def quantized_bytes(self) -> int:
        return sum(int(a.numel()) * a.element_size() for a in self.flat())


def _device_sync(_):
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def measure_stream_win(stream_step, base_step, repeats: int = 3,
                       sync=None):
    """Price the double buffer (weight_stream.py:209-232): best-of wall
    times of two warmed decode-step thunks (prefetched stream against the
    baseline), each call followed by ``sync(result)`` (default: a device
    synchronise). Returns ``(win_ms, t_stream_s, t_base_s)``; the win is
    the signed delta, negative when prefetch lost; the win (floored at
    0) goes into ``weights/stream_prefetch_ms``."""
    sync = sync or _device_sync

    def best(fn):
        dt = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            sync(fn())
            dt = min(dt, time.perf_counter() - t0)
        return dt

    sync(stream_step())                      # warm both
    sync(base_step())
    t_stream = best(stream_step)
    t_base = best(base_step)
    win_ms = (t_base - t_stream) * 1e3
    _m_prefetch.observe(max(win_ms, 0.0))
    return win_ms, t_stream, t_base
