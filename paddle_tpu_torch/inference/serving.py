"""Continuous-batching serving engine over the paged-KV cache, in PyTorch.

Port of paddle_tpu/inference/serving.py (the core of its engine): N
concurrent requests share one decoder; each engine step packs a mixed
batch of prefill chunks and decode tokens, attends against paged KV blocks
addressed by per-request block tables, and requests join and leave the
batch at any step. The host side (``ServingEngine``) is a scheduler: page
allocator, request queue, chunked prefill and preemption. Sampling runs on
the device under schedule-independent salts, so paged generations equal
the dense reference path token for token. Padding tokens go to a reserved
trash page, so a step's fixed token budget never touches live pages.

On a CUDA device the step runs through the port's hand-written kernels:
RMSNorm 2L + 1 times a step, the varlen flash-attention forward once per
layer on fresh-prefill steps, and the paged-attention kernel once per layer
on decode and chunked-prefill steps. ``decode_run`` replays one CUDA graph
a (row bucket, sampling mode) once a step, the counterpart of the
reference's fused decode window (``_decode_window_fn``): one host sync a
window and no per-op dispatch.

``cache_quant="int8"`` keeps int8 pages with per-slot f32 scales: every
layer writes them through the quantize-on-append kernel and reads them
through the paged kernel's int8 instantiations. ``prefix_cache=True``
shares full prompt blocks between requests (inference/prefix_cache.py):
a hit moves ``cached`` past the shared tokens, and the suffix runs as a
chunked step. ``set_drafter`` turns on speculative decoding
(inference/speculative.py): a pure decode-tip step drafts up to k tokens a
row and verifies them in one eager paged step with logits at every
position.

``from_model(..., weight_stream="int8" | "int8-noprefetch" | "int4")``
streams the decoder Linears (inference/weight_stream.py): int8 or int4
codes on the device, a layer's group dequantized into a workspace slot by
the hand-written dequant kernel (16 launches a step), on a side stream one
layer ahead under prefetch. Live weight versions: ``stage_weight_set``,
``commit_weight_set``, ``rollback_weight_set``, ``probe_logits``; each
request is pinned to the version serving at its admission and a step binds
one version. A window's graph holds the addresses of the weights it read,
so windows are kept a version and captured at a version's first use.

``ServingEngine(path_prefix, cfg)`` serves a deploy artifact written by
``save_paged_model`` (inference/__init__.py): the ``torch.export`` program
of the paged step over flat weights, the kernels reached through their
registered ops. Every step of such an engine, decode windows included, runs
at the fixed token length ``cfg.token_budget`` on the paged route (the
artifact has no fresh-prefill or verify entry), and its windows capture the
program's call. ``add_request(deadline_s=)`` bounds a request's latency:
past it the request is evicted before the next step or window, its pages
freed, and ``requeue_hook`` told. ``PagedServingConfig(backend=)`` is the
engine's placement handle.

The engine writes the reference's ``serving/*`` series into the metrics
registry (``profiler.metrics``: TTFT, TPOT, steps, tokens, requests,
preemptions, shed load, deadline evictions, the prefix cache's reuse, the
speculative counters, batch occupancy, KV utilization and the live weight
version), into a replica's child registry after ``set_metrics_namespace``.

The fleet tier's hooks (inference/router.py, disagg.py,
fleet_supervisor.py, gateway.py): each request records its lifecycle spans
(``serving::admit``, ``serving::queue``, ``serving::prefill``,
``serving::decode``) under one trace that travels with it; a request keeps
its origin sampling identity (``salt_rid``, ``salt_seed``) across a
migration or requeue, so its stream is the one its first engine would have
sampled; a step consults the ``prefill`` and ``decode`` chaos sites before
it takes a page (``kill`` fells the engine: ``dead`` set, EngineDeadError
from then on), and ``stage_weight_set`` the ``publish`` site.

Not ported (ROADMAP.md): the StableHLO artifact of the decode step
(``lower_fused_decode``).
"""
from __future__ import annotations

import copy
import math
import os
import time

import numpy as np
import torch
from torch import nn

from ..incubate.nn import functional as IF
from ..nn import modules as F
from ..nn.modules import TorchEmbedding, TorchLinear, TorchRMSNorm
from ..ops.kernels import (add_launch_counts, launch_counts,
                           resolve_device)
from ..ops.kernels.rope_append import _rope
from ..profiler import metrics as _metrics
from ..profiler import tracing as _tracing
from .prefix_cache import PrefixCache, restore_snapshot, save_snapshot
from .weight_stream import STREAM_KINDS, WeightStreamer

__all__ = ["PagedServingConfig", "PagedCausalLM", "ServingEngine",
           "SamplingParams", "sampling_salt", "sample_logits",
           "EngineOverloadedError", "save_paged_model",
           "resolve_backend_device"]


class EngineOverloadedError(RuntimeError):
    """Admission rejected: the engine already holds cfg.max_queue live
    requests; the front-end should shed or retry elsewhere."""


def resolve_backend_device(backend):
    """``PagedServingConfig.backend`` as a device (serving.py:106-123):
    None stays None (the engine then takes ``resolve_device(None)``,
    "cuda"); a device string or a ``torch.device`` resolves through
    ``resolve_device``. A CUDA handle naming no card raises ValueError."""
    if backend is None:
        return None
    dev = torch.device(backend)
    if dev.type == "cuda" and (
            not torch.cuda.is_available()
            or (dev.index or 0) >= torch.cuda.device_count()):
        raise ValueError(f"backend {backend!r} has no devices")
    return resolve_device(dev)


class PagedServingConfig:
    """Engine and model dims for the paged-KV serving path
    (serving.py:126-204).

    ``cache_quant="int8"`` stores KV pages as int8 with a dynamic f32 scale
    a (token, head). ``prefix_cache=True`` shares full prompt blocks
    between requests; ``prefix_snapshot_root`` is a directory of
    ``cache_<seq>`` snapshots, the newest of which an engine restores at
    start and ``save_prefix_cache()`` writes to; ``prefix_page_quota``
    caps the cache pages one tenant namespace owns (None: no cap). Weight
    streaming and versions are the engine's (``ServingEngine.from_model``'s
    ``weight_stream``, ``stage_weight_set``). ``backend`` is the engine's
    placement handle, a device string or ``torch.device`` (None: the
    engine's ``device`` argument, else "cuda"; ``resolve_backend_device``).
    """

    def __init__(self, vocab_size=256, hidden_size=64, num_layers=2,
                 num_heads=4, ffn_size=128, block_size=16, num_blocks=64,
                 max_batch=4, max_blocks_per_seq=8, token_budget=64,
                 num_kv_heads=None, dtype="float32", cache_quant=None,
                 max_queue=None, prefix_cache=False,
                 prefix_snapshot_root=None, prefix_page_quota=None,
                 backend=None):
        if dtype not in ("float32", "bfloat16"):
            raise ValueError("dtype must be 'float32' or 'bfloat16'")
        if cache_quant not in (None, "int8"):
            raise ValueError("cache_quant must be None or 'int8'")
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.num_kv_heads = num_kv_heads or num_heads
        self.head_dim = hidden_size // num_heads
        self.ffn_size = ffn_size
        self.block_size = block_size
        self.num_blocks = num_blocks          # page pool (page 0 = trash)
        self.max_batch = max_batch
        self.max_blocks_per_seq = max_blocks_per_seq
        self.token_budget = token_budget
        self.dtype = dtype
        self.cache_quant = cache_quant
        # load shedding: admission raises EngineOverloadedError once this
        # many requests are live; None admits everything
        self.max_queue = max_queue
        self.prefix_cache = bool(prefix_cache)
        self.prefix_snapshot_root = prefix_snapshot_root
        self.prefix_page_quota = prefix_page_quota
        self.backend = backend
        self.max_seq = max_blocks_per_seq * block_size

    @property
    def torch_dtype(self):
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    @classmethod
    def llama_1b(cls, **over):
        """Flagship serving dims: the ~0.9B llama (hidden 2048, 16 layers),
        GQA 16q/8kv, bf16 cache."""
        base = dict(vocab_size=32000, hidden_size=2048, num_layers=16,
                    num_heads=16, num_kv_heads=8, ffn_size=5632,
                    block_size=32, num_blocks=64, max_batch=8,
                    max_blocks_per_seq=6, token_budget=256,
                    dtype="bfloat16")
        base.update(over)
        return cls(**base)


class SamplingParams:
    """Per-request decode sampling. temperature<=0 means greedy (argmax);
    top_k<=0 and top_p>=1 disable those filters."""

    def __init__(self, temperature=0.0, top_k=0, top_p=1.0):
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)


GREEDY = SamplingParams()


def sampling_salt(seed, rid, n_generated):
    """Schedule-independent salt for one sampled token: depends only on
    (engine seed, request id, index of the token being sampled), so
    chunked prefill, preemption, batch order and the dense reference path
    all draw the same noise."""
    return (seed * 1000003 + rid * 65537 + n_generated) & 0x7FFFFFFF


_M32 = 0xFFFFFFFF


def _mul32(x, c):
    """(x * c) mod 2**32 for int64 x in [0, 2**32) without int64 overflow."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _gumbel(salts, tokens):
    """Gumbel noise as a pure function of (salt, token id): the lowbias32
    mixer of ops/pallas/flash_attention.py:80-92 in int64 masked to 32
    bits, turned into a uniform in (0, 1) from 23 of them (exact in f32),
    then -log(-log(u)). The same bits on the CPU and the card. ``salts`` and
    ``tokens`` broadcast against each other."""
    h = (_mul32(tokens.long() & _M32, 0x9E3779B1)
         + _mul32(salts.long() & _M32, 0x85EBCA77)) & _M32
    h = h ^ (h >> 16)
    h = _mul32(h, 0x7FEB352D)
    h = h ^ (h >> 15)
    h = _mul32(h, 0x846CA68B)
    h = h ^ (h >> 16)
    u = ((h >> 9).float() + 0.5) * (2.0 ** -23)
    return -torch.log(-torch.log(u))


def _sample_core(logits, temps, topks, topps, salts):
    """Batched sampling: greedy where temp<=0, else gumbel-argmax over the
    temperature-scaled logits restricted to the top-k/top-p support. The
    noise is indexed by TOKEN ID (not sorted rank), so near-tie order
    differences between two close logit sources cannot change the draw."""
    logits = logits.float()
    V = logits.shape[-1]
    dev = logits.device
    greedy = logits.argmax(dim=-1)
    lt = logits / temps.float().clamp_min(1e-6)[:, None]
    sl, order = torch.sort(lt, dim=-1, descending=True, stable=True)
    ranks = torch.arange(V, device=dev)[None, :]
    k = topks.long()[:, None]
    keep = torch.where(k > 0, ranks < k, torch.ones_like(ranks, dtype=bool))
    pr = torch.softmax(sl.masked_fill(~keep, float("-inf")), dim=-1)
    keep = keep & ((pr.cumsum(dim=-1) - pr) < topps.float()[:, None])
    keep_tok = torch.zeros_like(keep).scatter(1, order, keep)
    g = _gumbel(salts[:, None], torch.arange(V, device=dev)[None, :])
    sampled = (lt.masked_fill(~keep_tok, float("-inf")) + g).argmax(dim=-1)
    return torch.where(temps <= 0, greedy, sampled).to(torch.int32)


_TOPK_FAST_C = 128


def _sample_topk_core(logits, temps, topks, topps, salts):
    """Sampler for rows with 0 < top_k <= _TOPK_FAST_C: top-C candidates
    replace the full-vocab sort. Exact against ``_sample_core``: top-p
    applies inside the top-k support and the noise is keyed by token id,
    so the winner is the same token."""
    logits = logits.float()
    V = logits.shape[-1]
    C = min(_TOPK_FAST_C, V)
    greedy = logits.argmax(dim=-1)
    lt = logits / temps.float().clamp_min(1e-6)[:, None]
    vals, idx = torch.topk(lt, C, dim=-1)
    keep = torch.arange(C, device=logits.device)[None, :] \
        < topks.long()[:, None]
    pr = torch.softmax(vals.masked_fill(~keep, float("-inf")), dim=-1)
    keep = keep & ((pr.cumsum(dim=-1) - pr) < topps.float()[:, None])
    g = _gumbel(salts[:, None], idx)
    win = (vals.masked_fill(~keep, float("-inf")) + g).argmax(dim=-1)
    sampled = idx.gather(1, win[:, None])[:, 0]
    return torch.where(temps <= 0, greedy, sampled).to(torch.int32)


def _topk_fast_ok(temps, topks):
    """True when every sampling row is within the exact top-k fast path."""
    sampling = temps > 0
    return bool(np.all(~sampling | ((topks > 0)
                                    & (topks <= _TOPK_FAST_C))))


def _next_pow2(n):
    """Smallest power of two >= n (n >= 1)."""
    return 1 << (int(n) - 1).bit_length()


def sample_logits(logits, sampling: SamplingParams, salt: int) -> int:
    """Sample one token from a single logits vector with the engine's
    sampler — the reference-path helper for parity checks."""
    lg = torch.as_tensor(logits)
    dev = lg.device
    out = _sample_core(
        lg.reshape(1, -1),
        torch.tensor([sampling.temperature], device=dev),
        torch.tensor([sampling.top_k], device=dev),
        torch.tensor([sampling.top_p], device=dev),
        torch.tensor([salt], device=dev))
    return int(out[0])


def _sample(logits, mode, temps, topks, topps, salts):
    if mode == "greedy":
        return logits.argmax(dim=-1).to(torch.int32)
    core = _sample_topk_core if mode == "topk" else _sample_core
    return core(logits, temps, topks, topps, salts)


def _sample_mode(temps, topks):
    if not np.any(temps > 0):
        return "greedy"
    return "topk" if _topk_fast_ok(temps, topks) else "full"


class _WeightView:
    """What ``PagedCausalLM.forward`` reads of one weight set
    (``PagedCausalLM.weight_view``): the embedding, final norm and head,
    each layer's two norm weights and its Linears ({kind: [in, out]}; empty
    when they are streamed), and the streamer over the set's codes."""

    __slots__ = ("embed", "ln_f", "head", "ln1", "ln2", "layers", "stream")

    def __init__(self, embed, ln_f, head, ln1, ln2, layers, stream):
        self.embed, self.ln_f, self.head = embed, ln_f, head
        self.ln1, self.ln2, self.layers = ln1, ln2, layers
        self.stream = stream


class StreamWorkspace:
    """A streaming engine's dequant workspace: two slots, each holding one
    layer's group in the serving dtype ([in, out] views a kind), allocated
    once with the engine and never inside a CUDA graph's capture; and on a
    CUDA device the side stream the prefetched dequants run on, with an
    event a layer for "group ready" and one for "group read"."""

    def __init__(self, streamer: WeightStreamer, device):
        self.slots = streamer.workspace(device, 2)
        self.views = [streamer.slot_views(t) for t in self.slots]
        self.cuda = torch.device(device).type == "cuda"
        L = streamer.num_layers
        if self.cuda:
            self.side = torch.cuda.Stream(device)
            self.ready = [torch.cuda.Event() for _ in range(L)]
            self.read = [torch.cuda.Event() for _ in range(L)]


class _StreamFeed:
    """One forward's schedule of streamed groups (the reference's double
    buffer, serving.py:451-468). Layer i's group goes to slot i % 2.
    Without prefetch, ``group(i)`` dequantizes layer i at its use. With
    prefetch, layer i+1's group is dequantized before layer i's compute:
    on the CPU in program order; on the card on the workspace's side
    stream, forked from the current stream at the start, which waits for
    layer i-1's last product (the slot's last reader) before overwriting
    its slot, while layer i+1's first product waits for the dequant; the
    side stream joins the current stream in ``close``, so a CUDA graph
    captures the fork and the join."""

    def __init__(self, streamer, workspace):
        self.ws, self.wk = streamer, workspace
        self.L = streamer.num_layers
        self.side = workspace.cuda and streamer.prefetch
        if self.side:
            self.main = torch.cuda.current_stream(workspace.slots[0].device)
            workspace.side.wait_stream(self.main)
        if streamer.prefetch:
            self._dequant(0)

    def _dequant(self, li):
        views = self.wk.views[li % 2]
        if not self.side:
            self.ws.dequant_layer(li, out=views)
            return
        side = self.wk.side
        with torch.cuda.stream(side):
            if li >= 2:
                side.wait_event(self.wk.read[li - 2])
            self.ws.dequant_layer(li, out=views)
            self.wk.ready[li].record(side)

    def group(self, li):
        """Layer li's group, {kind: [in, out]}, ready for its products."""
        if not self.ws.prefetch:
            self._dequant(li)
            return self.wk.views[li % 2]
        if self.side and li >= 1:
            self.wk.read[li - 1].record(self.main)
        if li + 1 < self.L:
            self._dequant(li + 1)
        if self.side:
            self.main.wait_event(self.wk.ready[li])
        return self.wk.views[li % 2]

    def close(self):
        if self.side:
            self.main.wait_stream(self.wk.side)


class PagedCausalLM(nn.Module):
    """A llama-architecture causal LM (RMSNorm -> GQA attention -> swiglu
    MLP, untied LM head, no biases) whose serving forward runs on paged KV
    caches through ``block_multihead_attention``. ``forward`` is the
    engine's step; ``forward_dense`` the stateless reference path over the
    same weights. Weights are random from ``seed`` on ``device`` (None
    means "cuda"), in f32; ``load_paddle_tpu_params`` carries the TPU
    package's weights in."""

    def __init__(self, cfg: PagedServingConfig, device=None, seed=0):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        self.cfg = cfg
        h, f, D = cfg.hidden_size, cfg.ffn_size, cfg.head_dim
        kvw = cfg.num_kv_heads * D
        L = cfg.num_layers

        def lin(i, o):
            return TorchLinear(i, o, device=dev, generator=gen)

        self.embed = TorchEmbedding(cfg.vocab_size, h, device=dev,
                                    generator=gen)
        self.ln1 = nn.ModuleList([TorchRMSNorm(h, device=dev)
                                  for _ in range(L)])
        self.qkv = nn.ModuleList([lin(h, h + 2 * kvw) for _ in range(L)])
        self.proj = nn.ModuleList([lin(h, h) for _ in range(L)])
        self.ln2 = nn.ModuleList([TorchRMSNorm(h, device=dev)
                                  for _ in range(L)])
        self.gate_up = nn.ModuleList([lin(h, 2 * f) for _ in range(L)])
        self.down = nn.ModuleList([lin(f, h) for _ in range(L)])
        self.ln_f = TorchRMSNorm(h, device=dev)
        self.head = lin(h, cfg.vocab_size)

    def rope_cos_sin(self, device):
        """(cos, sin) [2, max_seq, D/2] at positions 0..max_seq-1, in f32
        on ``device``: made once a device, not a step. It is not state, so
        a cast of the model (serving copies are cast to cfg.dtype) leaves
        it f32. A traced step (the deploy artifact) computes it in the
        program, from the same ops on the serving device, and caches
        nothing."""
        tracing = torch.compiler.is_compiling()
        table = None if tracing else self.__dict__.get("_rope_cos_sin")
        if table is None or table.device != device:
            cos, sin = self._rope_table(
                torch.arange(self.cfg.max_seq, device=device))
            table = torch.stack([cos, sin])
            if not tracing:
                self.__dict__["_rope_cos_sin"] = table
        return table

    def load_paddle_tpu_params(self, named):
        """Load the TPU package's parameters: ``named`` maps its parameter
        names (``current_params``) to numpy arrays; see
        utils.convert.params_from_paddle_tpu."""
        from ..utils.convert import (load_params_from_paddle_tpu,
                                     params_from_paddle_tpu)

        params_from_paddle_tpu(named)        # refuses a foreign name
        return load_params_from_paddle_tpu(self, named)

    def _lin(self, kind, li, h, w=None):
        """One decoder Linear (bias-free): the layer's own module, or, when
        ``w`` holds the layer's weights ({kind: [in, out]}: a weight set's
        tensors, or a streamed group dequantized into a workspace slot), a
        plain product with them, the op the module computes
        (serving.py:356-368)."""
        if w is None:
            return getattr(self, kind)[li](h)
        return F.linear(h, w[kind])

    def _mlp(self, li, h, w=None):
        gu = self._lin("gate_up", li, h, w)
        half = self.cfg.ffn_size
        return self._lin("down", li, F.swiglu(gu[..., :half],
                                               gu[..., half:]), w)

    def weight_view(self, named, stream=None):
        """What ``forward`` reads of a weight set: ``named`` maps this
        model's parameter names to tensors (a version's set, or the model's
        own parameters); ``stream`` is a WeightStreamer over the set's codes
        when the decoder Linears are streamed (their entries in ``named``
        are then placeholders)."""
        L = self.cfg.num_layers
        kinds = () if stream is not None else STREAM_KINDS
        return _WeightView(
            named["embed.weight"], named["ln_f.weight"], named["head.weight"],
            [named[f"ln1.{li}.weight"] for li in range(L)],
            [named[f"ln2.{li}.weight"] for li in range(L)],
            [{k: named[f"{k}.{li}.weight"] for k in kinds}
             for li in range(L)], stream)

    def _rope_table(self, positions):
        """(cos, sin) [..., head_dim//2] at absolute positions, in f32."""
        half = self.cfg.head_dim // 2
        inv = 1.0 / (10000.0 ** (
            torch.arange(half, dtype=torch.float32,
                         device=positions.device) * 2.0
            / self.cfg.head_dim))
        ang = positions[..., None].float() * inv
        return torch.cos(ang), torch.sin(ang)

    def forward(self, tokens, seq_lens_encoder, seq_lens_decoder,
                seq_lens_this_time, cu_seqlens_q, block_tables,
                key_caches, value_caches, k_scales=None, v_scales=None,
                fresh_prefill=False, all_logits=False, weights=None,
                workspace=None):
        """One engine step (serving.py:392-491).

        tokens [T] packed (row b contributes seq_lens_this_time[b] tokens
        starting at cache position seq_lens_decoder[b]; padding goes to
        the trash row); seq_lens_* [B+1] (the last row is the padding
        row); cu_seqlens_q [B+2]; block_tables [B+1, max_blocks];
        key/value_caches [L, num_blocks, HKV, bs, D], updated in place;
        k_scales / v_scales [L, num_blocks, HKV, bs] the f32 scale pools
        of int8 caches (None otherwise), updated in place too.
        fresh_prefill=True when every scheduled row starts at position 0.
        all_logits=True returns the logits of every packed position [T, V]
        (the speculative verify step, the reference's ``_step_mode ==
        "spec_verify"``) instead of each row's last token's [B+1, V].
        Returns (logits, key_caches, value_caches), and the scale pools
        after them for int8 caches.

        ``weights`` (``weight_view``) is the weight set to read, None for
        the model's own parameters. When it streams the decoder Linears,
        each layer's group is dequantized into a slot of ``workspace`` (a
        StreamWorkspace; None makes one for this call), in the reference's
        order (serving.py:427-478): with prefetch, layer i+1's group is
        dequantized before layer i's compute, on the card on the
        workspace's side stream (``_StreamFeed``); without, at its use.
        """
        cfg = self.cfg
        w = weights if weights is not None \
            else self.weight_view(dict(self.named_parameters()))
        eps = self.ln_f._epsilon
        x = F.embedding(tokens, w.embed)
        B1 = int(seq_lens_encoder.shape[0])
        if block_tables.shape[1] > cfg.max_blocks_per_seq:
            raise ValueError(f"block_tables [{B1}, {block_tables.shape[1]}]"
                             f" wider than max_blocks_per_seq "
                             f"{cfg.max_blocks_per_seq}")
        max_seq = int(block_tables.shape[1]) * cfg.block_size
        table = self.rope_cos_sin(x.device)                  # [2, S, D/2]
        rope = table[:, None, None, :max_seq].expand(
            2, B1, 1, max_seq, cfg.head_dim // 2)
        # what every layer shares, once a step
        md = IF.paged_metadata(tokens.shape[0], seq_lens_encoder,
                               seq_lens_decoder, cu_seqlens_q, block_tables,
                               cfg.block_size, rope)
        quant = k_scales is not None
        feed = None
        if w.stream is not None:
            feed = _StreamFeed(w.stream, workspace
                               or StreamWorkspace(w.stream, x.device))
        for li in range(cfg.num_layers):
            lw = w.layers[li] if feed is None else feed.group(li)
            h = F.rms_norm(x, w.ln1[li], eps)
            qkv = self._lin("qkv", li, h, lw)
            out = IF.block_multihead_attention(
                qkv, key_caches, value_caches, seq_lens_encoder,
                seq_lens_decoder, seq_lens_this_time, cu_seqlens_q,
                block_tables, rope, layer_idx=li,
                fresh_prefill=fresh_prefill, cache_k_quant_scales=k_scales,
                cache_v_quant_scales=v_scales,
                use_dynamic_cachekv_quant=quant, metadata=md)[0]
            x = x + self._lin("proj", li, out, lw)
            h = F.rms_norm(x, w.ln2[li], eps)
            x = x + self._mlp(li, h, lw)
        if feed is not None:
            feed.close()
        x = F.rms_norm(x, w.ln_f, eps)
        if all_logits:
            logits = F.linear(x, w.head)                     # [T, V]
        else:
            # last token of each row: cu_q[i+1]-1 (rows with 0 tokens this
            # step read their previous row's last token — masked host-side)
            idx = (cu_seqlens_q[1:].long() - 1).clamp(min=0)
            logits = F.linear(x[idx], w.head)                # [B+1, V]
        if quant:
            return logits, key_caches, value_caches, k_scales, v_scales
        return logits, key_caches, value_caches

    def _attn_dense(self, qkv):
        cfg = self.cfg
        T = qkv.shape[0]
        HQ, HKV, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        q = qkv[:, :HQ * D].reshape(T, HQ, D)
        k = qkv[:, HQ * D:(HQ + HKV) * D].reshape(T, HKV, D)
        v = qkv[:, (HQ + HKV) * D:].reshape(T, HKV, D)
        cos, sin = self._rope_table(torch.arange(T, device=qkv.device))
        cos_h, sin_h = cos[:, None, :], sin[:, None, :]
        q = _rope(q, cos_h, sin_h).to(q.dtype)
        k = _rope(k, cos_h, sin_h).to(k.dtype)
        if HQ != HKV:
            k = k.repeat_interleave(HQ // HKV, dim=1)
            v = v.repeat_interleave(HQ // HKV, dim=1)
        logits = torch.einsum("thd,shd->ths", q.float(), k.float()) \
            / math.sqrt(D)
        causal = torch.arange(T, device=qkv.device)[:, None] \
            >= torch.arange(T, device=qkv.device)[None, :]
        logits = logits.masked_fill(~causal[:, None, :], float("-inf"))
        probs = torch.softmax(logits, dim=-1)
        out = torch.einsum("ths,shd->thd", probs, v.float()).to(qkv.dtype)
        return out.reshape(T, HQ * D)

    def forward_dense(self, input_ids):
        """input_ids [1, S] -> logits [1, S, V] with standard causal GQA
        attention; the numerical reference for the paged path."""
        cfg = self.cfg
        ids = input_ids.reshape(-1)
        S = ids.shape[0]
        x = self.embed(ids)
        for li in range(cfg.num_layers):
            h = self.ln1[li](x)
            out = self._attn_dense(self.qkv[li](h))
            x = x + self.proj[li](out)
            h = self.ln2[li](x)
            x = x + self._mlp(li, h)
        x = self.ln_f(x)
        return self.head(x).reshape(1, S, cfg.vocab_size)


def _serving_copy(model, cfg, device, weight_stream=None):
    """The model with floating params cast to cfg.dtype on ``device`` and,
    under ``weight_stream``, its decoder Linears quantized out (0-d
    placeholders stand for them, so their full-precision copies do not
    stay on the device), with the names of its parameters in sorted order
    and version 0's flat weight set (``ServingEngine._params``): made once
    and shared by every engine over the same model, dtype, cache
    quantization, quantization and device, as the reference keys its
    executables and staged weights (serving.py:771; weights are snapshotted
    at the first call). "int8" and "int8-noprefetch" share one
    quantization: prefetch is a property of each engine's schedule."""
    quant = None if weight_stream is None \
        else ("int4" if weight_stream == "int4" else "int8")
    key = (cfg.dtype, cfg.cache_quant, quant, str(device), str(cfg.backend))
    cached = getattr(model, "_serving_shared", None)
    if cached is not None and cached[0] == key:
        return cached[1:]
    model.__dict__.pop("_serving_shared", None)
    served = copy.deepcopy(model).to(device=device, dtype=cfg.torch_dtype)
    served.eval()
    streamer = None
    if quant is not None:
        params = dict(served.named_parameters())
        streamer = WeightStreamer.build(served, params, cfg.torch_dtype,
                                        mode=quant)
        for kind in STREAM_KINDS:
            for li, lin in enumerate(getattr(served, kind)):
                lin.weight = nn.Parameter(params[f"{kind}.{li}.weight"],
                                          requires_grad=False)
    named = dict(served.named_parameters())
    names = sorted(named)
    flat = [named[n] for n in names]
    if streamer is not None:
        flat += streamer.flat()
    shared = (key, served, streamer, names, flat)
    model.__dict__["_serving_shared"] = shared
    return shared[1:]


class _EngineMetrics:
    """Handle bundle for the serving/* series one engine writes
    (reference serving.py:48-92): TTFT from request submit to its first
    sampled token, TPOT from decode_run windows (window wall / steps),
    plus the scheduler gauges the capacity story needs."""

    __slots__ = ("ttft", "tpot", "steps", "tokens", "requests",
                 "preempt", "occupancy", "kv_util", "deadline", "shed",
                 "prefix_rate", "prefix_pages", "spec_steps",
                 "spec_drafted", "spec_accepted", "spec_accept_rate",
                 "spec_tokens_per_step", "weight_version", "weight_swaps",
                 "weight_rollbacks")

    def __init__(self, reg):
        self.ttft = reg.histogram("serving/ttft_ms")
        self.tpot = reg.histogram("serving/tpot_ms")
        self.steps = reg.counter("serving/steps")
        self.tokens = reg.counter("serving/tokens_generated")
        self.requests = reg.counter("serving/requests")
        self.preempt = reg.counter("serving/preemptions")
        self.occupancy = reg.gauge("serving/batch_occupancy")
        self.kv_util = reg.gauge("serving/kv_cache_utilization")
        self.deadline = reg.counter("serving/deadline_evictions")
        self.shed = reg.counter("serving/load_shed")
        self.prefix_rate = reg.gauge("serving/prefix_hit_rate")
        self.prefix_pages = reg.counter("serving/prefix_pages_reused")
        self.spec_steps = reg.counter("serving/spec_steps")
        self.spec_drafted = reg.counter("serving/spec_drafted_tokens")
        self.spec_accepted = reg.counter("serving/spec_accepted_tokens")
        self.spec_accept_rate = reg.gauge("serving/spec_accept_rate")
        self.spec_tokens_per_step = reg.gauge(
            "serving/spec_tokens_per_step")
        # live weight publishing: the version this engine currently
        # serves, atomic swaps taken, and rollbacks to the retained
        # previous buffer
        self.weight_version = reg.gauge("serving/weight_version")
        self.weight_swaps = reg.counter("serving/weight_swaps")
        self.weight_rollbacks = reg.counter("serving/weight_rollbacks")


class _Request:
    __slots__ = ("rid", "prompt", "generated", "max_new", "pages",
                 "cached", "done", "sampling", "eos_token_id", "submit_t",
                 "deadline_t", "timed_out", "requeues", "shared_keys",
                 "prefix_registered", "tenant", "spec_observed",
                 "weight_version", "first_tok_t", "salt_rid", "salt_seed",
                 "trace", "sched_t0")

    def __init__(self, rid, prompt, max_new, sampling, eos_token_id,
                 tenant=None, deadline_s=None):
        self.rid = rid
        self.prompt = list(int(t) for t in prompt)
        self.generated = []
        self.max_new = max_new
        self.pages = []
        self.cached = 0        # tokens whose KV currently lives in pages
        self.done = False
        self.sampling = sampling or GREEDY
        self.eos_token_id = eos_token_id
        self.submit_t = time.perf_counter()
        self.first_tok_t = None
        self.deadline_t = None if deadline_s is None \
            else self.submit_t + float(deadline_s)
        self.timed_out = False
        # sampling identity (reference serving.py:575-579): a request
        # moved between engines (migrated, requeued, drained) keeps its
        # ORIGIN (seed, rid), so its stream is the single-engine one
        self.salt_rid = rid
        self.salt_seed = None      # None: the engine's own seed
        # the admission span's context: every later lifecycle span parents
        # to it, and it travels in hand-offs, so a moved request's spans
        # share one trace id
        self.trace = None
        self.sched_t0 = None       # when a step first scheduled this row
        # how many times a router already retried this request elsewhere
        # (its cap is the router's)
        self.requeues = 0
        # prefix cache: the trie keys this request holds a ref on, and
        # whether its full prompt blocks were registered after prefill
        self.shared_keys = []
        self.prefix_registered = False
        # the prefix cache's namespace (None: the shared default)
        self.tenant = tenant
        # how much of prompt + generated the drafter has observed
        self.spec_observed = 0
        # the weight version the whole stream runs under, pinned at
        # admission (KV depends on the weights); a step only batches rows
        # of one version
        self.weight_version = 0

    @property
    def length(self):
        return len(self.prompt) + len(self.generated)


# the side stream every decode window's pre-capture warm-up runs on, one a
# device: PyTorch keeps a cuBLAS workspace for each stream a GEMM has run on
# (for the process), so a new stream a capture left one more behind each
# time, and clearing them (torch._C._cuda_clearCublasWorkspaces) frees the
# workspace that graphs captured earlier still point at
_WARMUP_STREAMS = {}


def _warmup_stream(dev) -> "torch.cuda.Stream":
    stream = _WARMUP_STREAMS.get(dev)
    if stream is None:
        stream = _WARMUP_STREAMS[dev] = torch.cuda.Stream(dev)
    return stream


class _DecodeWindow:
    """One decode window's static buffers and its step body: the
    counterpart of the reference's ``_decode_window_fn`` (serving.py:
    1746-1801), one per (weight version, row bucket ``Bb``, sampling mode):
    a captured graph holds the addresses of the weights it read, so each
    version has its own windows.

    Every input of a window lives in one int64 device buffer ``buf``
    (tokens [tok_len]: Bb on a from_model engine, the artifact's fixed
    token length on an artifact engine, whose padding goes to the trash
    row; enc, dec, this, cu, the block table, top-k, the per-row
    salts, temperatures and top-p as float32 views, the step counter), so
    one copy from a pinned host buffer stages a window. The body runs the
    model on those buffers, samples in the window's mode, feeds the Bb
    bucket rows' samples back as the next tokens, advances ``dec`` and the
    live rows' salts by one ((s + 1) & 0x7FFFFFFF is the salt of the next
    token, ``sampling_salt``), and writes the step's samples into row
    ``step`` of ``samples`` [n_max, B+1]. No host sync: on a CUDA device
    the body is captured once into a CUDA graph and replayed n times a
    window; on the CPU it runs eagerly n times."""

    def __init__(self, engine, Bb, mode, version=0):
        cfg = engine.cfg
        dev = engine.device
        self.engine, self.Bb, self.mode = engine, Bb, mode
        self.version = version
        B1 = cfg.max_batch + 1
        self.n_max = cfg.max_seq     # no request decodes more tokens
        tok_len = engine._fixed_token_len or Bb
        fields = (("tokens", tok_len), ("enc", B1), ("dec", B1), ("this", B1),
                  ("cu", B1 + 1), ("bt", B1 * cfg.max_blocks_per_seq),
                  ("topks", B1), ("salts", B1), ("step", 1),
                  ("temps", (B1 + 1) // 2), ("topps", (B1 + 1) // 2))
        self._slices, o = {}, 0
        for name, n in fields:
            self._slices[name] = (o, o + n)
            o += n
        self.buf = torch.zeros(o, dtype=torch.int64, device=dev)
        # the pinned staging buffer (on the CPU the buffer itself)
        self._host = (torch.zeros(o, dtype=torch.int64, pin_memory=True)
                      if dev.type == "cuda" else self.buf)
        self._host_np = self._host.numpy()
        for name, _ in fields[:-2]:
            setattr(self, name, self.buf[slice(*self._slices[name])])
        self.bt = self.bt.view(B1, cfg.max_blocks_per_seq)
        self.temps = self._float_view("temps", B1)
        self.topps = self._float_view("topps", B1)
        self.live = (torch.arange(B1, device=dev) < Bb).long()
        self.samples = torch.zeros((self.n_max, B1), dtype=torch.int32,
                                   device=dev)
        self.graph = None
        self.capture_ms = None
        self.graph_launches = {}     # launch counts one replay makes

    def _float_view(self, name, n):
        return self.buf[slice(*self._slices[name])].view(torch.float32)[:n]

    def stage(self, tokens, enc, dec, this, cu, bt, temps, topks, topps,
              salts):
        """Write one window's host inputs (numpy) into the buffers, step
        counter at 0: one copy from the pinned staging buffer."""
        h = self._host_np
        for name, a in (("tokens", tokens), ("enc", enc), ("dec", dec),
                        ("this", this), ("cu", cu), ("bt", bt.reshape(-1)),
                        ("topks", topks), ("salts", salts)):
            lo, hi = self._slices[name]
            h[lo:hi] = a
        lo, hi = self._slices["step"]
        h[lo:hi] = 0
        for name, a in (("temps", temps), ("topps", topps)):
            lo, hi = self._slices[name]
            h[lo:hi].view(np.float32)[:len(a)] = a
        if self._host is not self.buf:
            self.buf.copy_(self._host, non_blocking=True)

    def body(self):
        logits = self.engine._forward(self.version, self.tokens, self.enc,
                                      self.dec, self.this, self.cu, self.bt)
        sampled = _sample(logits, self.mode, self.temps, self.topks,
                          self.topps, self.salts)
        self.tokens[:self.Bb].copy_(sampled[:self.Bb])
        self.dec.add_(self.live)
        self.salts.add_(self.live).bitwise_and_(0x7FFFFFFF)
        self.samples.index_copy_(0, self.step, sampled[None])
        self.step.add_(1)

    def capture(self, pool):
        """Capture the body into a CUDA graph in ``pool``. The warm-up run
        PyTorch wants before a capture executes for real, so it runs with
        every row's block table on the trash page 0, and the buffers are
        put back as they were afterwards: no live page, scale, token or
        position changes. The launch counts the capture's Python made are
        taken back and kept in ``graph_launches``, added on each replay. A
        failed capture raises."""
        dev = self.engine.device
        t0 = time.perf_counter()
        saved = self.buf.clone()
        self.bt.zero_()
        self.step.zero_()
        side = _warmup_stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self.body()
        torch.cuda.current_stream(dev).wait_stream(side)
        self.step.zero_()
        before = launch_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=pool):
            self.body()
        made = {k: v - before[k] for k, v in launch_counts().items()}
        add_launch_counts(made, -1)
        self.buf.copy_(saved)
        torch.cuda.synchronize(dev)
        self.graph, self.graph_launches = graph, made
        self.capture_ms = (time.perf_counter() - t0) * 1e3

    def run(self, n, graph):
        """n steps of the staged window (graph replays, or the body run
        eagerly); returns the samples [n, B+1] (one host sync)."""
        if graph:
            for _ in range(n):
                self.graph.replay()
            add_launch_counts(self.graph_launches, n)
        else:
            for _ in range(n):
                self.body()
        return self.samples[:n].cpu().numpy()


class ServingEngine:
    """Continuous-batching scheduler over a PagedCausalLM step.

    engine = ServingEngine(path_prefix, cfg)       # serves the artifact
    engine = ServingEngine.from_model(model, cfg)  # or a live model
    rid = engine.add_request([tokens...], max_new_tokens=8,
                             sampling=SamplingParams(temperature=0.8,
                                                     top_k=50, top_p=0.9))
    engine.step()                # one mixed prefill/decode batch step
    engine.decode_run(16)        # 16 decode steps, ONE host sync
    engine.run_to_completion() -> {rid: [generated tokens]}

    Live weight versions (serving.py:1056-1301): ``stage_weight_set``
    checks and copies a new flat weight set (``weight_publish.
    build_weight_set``) to the device beside the serving one;
    ``commit_weight_set`` swaps it in at a step boundary (new admissions pin
    to it; streams admitted before finish under theirs);
    ``rollback_weight_set`` swaps back. Every step binds one version.

    The device: ``device`` when given, else ``cfg.backend``
    (``resolve_backend_device``), else "cuda".
    """

    def __init__(self, path_prefix: str = None,
                 cfg: PagedServingConfig = None, device=None, seed=0):
        if cfg is None:
            raise ValueError("ServingEngine needs cfg, the engine's "
                             "PagedServingConfig")
        self.cfg = cfg
        self.seed = seed
        self.name = f"engine{seed}"
        backend = resolve_backend_device(cfg.backend) if device is None \
            else None
        self.device = resolve_device(device if device is not None
                                     else backend)
        self._model = None          # set by from_model
        # the loaded artifact's program (path_prefix): every step runs at
        # its fixed token length; None on a from_model engine, whose steps
        # and windows run at their own
        self._program = None
        self._buffers = []
        self._fixed_token_len = None
        shape = (cfg.num_layers, cfg.num_blocks, cfg.num_kv_heads,
                 cfg.block_size, cfg.head_dim)
        if cfg.cache_quant == "int8":
            # int8 pages and an f32 scale a (page, head, slot)
            self._cache_dt = torch.int8
            self._ks = torch.zeros(shape[:-1], dtype=torch.float32,
                                   device=self.device)
            self._vs = torch.zeros(shape[:-1], dtype=torch.float32,
                                   device=self.device)
        else:
            self._cache_dt = cfg.torch_dtype
            self._ks = self._vs = None
        self._kc = torch.zeros(shape, dtype=self._cache_dt,
                               device=self.device)
        self._vc = torch.zeros(shape, dtype=self._cache_dt,
                               device=self.device)
        # page 0 is the trash page for padding tokens
        self._free_pages = list(range(1, cfg.num_blocks))
        self._requests = {}
        self._next_rid = 0
        # decode windows, {weight version: {(row bucket, sampling mode):
        # window}}; on a CUDA device each holds its CUDA graph, a version's
        # graphs in one memory pool of their own (``_graph_pools``), so a
        # freed version's graphs and memory go with it
        self._windows = {}
        self._graph_pools = {}
        # live weight versions (serving.py:1056-1301): _params is the flat
        # weight set new admissions pin to (version _active_wv); sets still
        # referenced (the active one, the previous one for rollback, any
        # an in-flight stream is pinned to) are kept in _weight_sets;
        # staged, not yet committed sets in _staged_weights. _views caches
        # what the model reads of each version (PagedCausalLM.weight_view)
        self._params = None
        self._names = None
        self._streamer = None
        self._stream_ws = None
        self._weight_stream_mode = None
        self._active_wv = 0
        self._prev_wv = None
        self._weight_sets = {}
        self._staged_weights = {}
        self._views = {}
        # logits of the last step() or verify step (for parity checks)
        self.last_logits = None
        # speculative decoding (inference/speculative.py), set by
        # set_drafter: while a drafter is set, _step runs pure decode-tip
        # batches through _spec_step
        self._drafter = None
        # serving/* handles; set_metrics_namespace rebinds them to a
        # replica's child registry
        self.metrics_namespace = None
        self._m = _EngineMetrics(_metrics.registry())
        # liveness: a kill at a serving chaos site fells this engine; every
        # call into a dead engine raises EngineDeadError until a
        # supervisor replaces it
        self.dead = False
        # the rank the chaos injector sees for this engine's fault sites
        self.fault_rank = 0
        self._spec_k = 0
        self._spec_steps = 0
        self._spec_drafted_total = 0
        self._spec_accepted_total = 0
        self._spec_emitted_total = 0
        self._spec_rows_total = 0
        # shared-prefix KV reuse: a refcounted trie over the page pool,
        # consulted at admission
        self._prefix_cache = PrefixCache(
            cfg.block_size, page_quota=cfg.prefix_page_quota) \
            if cfg.prefix_cache else None
        # deadline-evicted requests are handed to this hook when it is set
        # (a router retries them elsewhere): it gets _requeue_info's dict
        # and must not raise, or the step sweeping it fails
        self.requeue_hook = None
        from ..distributed.resilience import faults as _faults

        _faults.maybe_arm_from_env()
        if self._prefix_cache is not None and cfg.prefix_snapshot_root:
            restore_snapshot(self, cfg.prefix_snapshot_root)
        if path_prefix is not None:
            self._load_artifact(path_prefix)

    def _load_artifact(self, path_prefix):
        """Load ``save_paged_model``'s artifact (serving.py:628-639): the
        program moved to this engine's device, its flat weights placed
        there once (version 0's set)."""
        from . import load_inference_model

        cfg = self.cfg
        if cfg.cache_quant is not None:
            raise ValueError("an artifact engine serves float pages: the "
                             "artifact's inputs carry no scale pools")
        program, params, buffers, sig = load_inference_model(path_prefix,
                                                             self.device)
        want = [{"name": spec.name, "shape": list(spec.shape),
                 "dtype": spec.dtype} for spec in _paged_specs(cfg)]
        if sig["inputs"] != want:
            raise ValueError(f"the artifact at {path_prefix!r} was saved for "
                             f"other step shapes than cfg's: {sig['inputs']}"
                             f" != {want}")
        self._program = program
        self._params = params
        self._buffers = buffers
        self._fixed_token_len = cfg.token_budget

    @classmethod
    def from_model(cls, model: PagedCausalLM, cfg: PagedServingConfig,
                   seed=0, device=None, weight_stream=None):
        """An engine over a live model, with floating params cast to
        cfg.dtype on ``device`` (None means "cuda"); engines over one
        model share the cast copy. Fresh-prefill steps take the varlen
        flash-attention route. ``device``: as the constructor's.

        ``weight_stream`` streams the decoder Linear stacks
        (inference/weight_stream.py; serving.py:739-843): ``"int8"``
        per-channel int8, its group for layer i+1 dequantized while layer
        i computes; ``"int8-noprefetch"`` the same codes dequantized at use;
        ``"int4"`` two 4-bit codes a byte with a scale a (32-row group,
        output channel), prefetched. Generations equal, bit for bit, those
        of a plain engine over the dequantized weights."""
        if weight_stream not in (None, "int8", "int8-noprefetch", "int4"):
            raise ValueError(
                f"weight_stream={weight_stream!r}: expected None, "
                f"'int8', 'int8-noprefetch' or 'int4'")
        eng = cls(None, cfg, device=device, seed=seed)
        eng._weight_stream_mode = weight_stream
        served, streamer, names, flat = _serving_copy(model, cfg, eng.device,
                                                      weight_stream)
        eng._model, eng._names, eng._params = served, names, flat
        if streamer is not None:
            eng._streamer = streamer.over(flat[len(names):])
            eng._streamer.prefetch = weight_stream != "int8-noprefetch"
            eng._stream_ws = StreamWorkspace(streamer, eng.device)
        return eng

    @property
    def _window_fns(self):
        """The active version's decode windows, {(row bucket, sampling
        mode): window}."""
        return self._windows.get(self._active_wv, {})

    # -- live weight versions (double-buffered versioned hot swap) -------
    @property
    def active_weight_version(self):
        """The version NEW admissions pin to (0 = the build-time set)."""
        return self._active_wv

    def has_weight_version(self, version):
        """True when ``version`` can serve here: active, or kept (an
        in-flight pinned stream can run under it). A staged, uncommitted
        set does not count."""
        return version == self._active_wv or version in self._weight_sets

    def _params_for(self, version):
        """The flat weight set of a pinned version. Every dispatch binds
        through this (by ``_view``), so a step runs exactly the version its
        rows are pinned to."""
        if version == self._active_wv:
            return self._params
        try:
            return self._weight_sets[version]
        except KeyError:
            raise KeyError(
                f"weight version {version} is not resident on this engine "
                f"(active={self._active_wv}, retained="
                f"{sorted(self._weight_sets)})") from None

    def _make_view(self, flat):
        n = len(self._names)
        return self._model.weight_view(
            dict(zip(self._names, flat[:n])),
            None if self._streamer is None else self._streamer.over(flat[n:]))

    def _view(self, version):
        """What the model reads of ``version``'s set, made once a
        version."""
        view = self._views.get(version)
        if view is None:
            view = self._views[version] = self._make_view(
                self._params_for(version))
        return view

    def _drop_version(self, version):
        """Forget a freed version's view, decode windows and their graphs'
        memory pool."""
        self._views.pop(version, None)
        self._windows.pop(version, None)
        self._graph_pools.pop(version, None)

    def pin_weight_version(self, rid, version):
        """Re-pin a just-admitted request to the version its stream started
        under (a hand-off between engines): any prefix match taken under
        the admission version is released and taken again under the pin.
        Raises KeyError when ``version`` cannot serve here."""
        r = self._requests[rid]
        if version == r.weight_version:
            return r
        if not self.has_weight_version(version):
            raise KeyError(f"this engine cannot serve weight version "
                           f"{version} (active={self._active_wv})")
        self._release(r)
        r.cached = 0
        r.prefix_registered = False
        r.weight_version = version
        self._try_prefix_match(r)
        return r

    def stage_weight_set(self, version, arrays, crcs=None):
        """Stage version ``version`` WITHOUT serving it (serving.py:
        1104-1169): check the tensor count, shapes and dtypes against the
        serving flat set, the per-tensor CRC-32s when given (of each
        tensor's bytes), then copy the set to the device. ``arrays`` are
        host numpy arrays (bfloat16 as ml_dtypes' type, as the reference's
        ``build_weight_set`` gives them) or tensors. Raises
        WeightTransferError on any mismatch; nothing is staged then and the
        engine serves as before."""
        from ..distributed.resilience.errors import WeightTransferError
        from .weight_publish import crc32, host_tensor

        self._check_alive()
        cur = self._params
        host = [host_tensor(a) for a in arrays]
        if len(host) != len(cur):
            raise WeightTransferError(
                version, self.name,
                f"tensor count {len(host)} != expected {len(cur)}")
        for i, (a, ref) in enumerate(zip(host, cur)):
            if tuple(a.shape) != tuple(ref.shape) or a.dtype != ref.dtype:
                raise WeightTransferError(
                    version, self.name,
                    f"tensor {i}: got {a.dtype}{tuple(a.shape)}, "
                    f"expected {ref.dtype}{tuple(ref.shape)}")
        # chaos site "publish" (reference serving.py:1134-1152): kill
        # fells this engine mid-stage (the active version keeps serving),
        # drop makes the transfer vanish, corrupt flips a staged byte the
        # CRC check below must catch, delay stalls the rollout
        from ..distributed.resilience import faults as _faults
        from ..distributed.resilience.errors import (EngineDeadError,
                                                     PeerUnreachableError)

        _faults.maybe_arm_from_env()
        act = _faults.injector.on_event("publish", self.fault_rank)
        if act is not None:
            if act.kind == "kill":
                self.dead = True
                raise EngineDeadError(self.name, "publish")
            if act.kind == "delay":
                time.sleep(act.delay_ms / 1e3)
            elif act.kind == "drop":
                raise PeerUnreachableError(self.fault_rank, self.name, 1)
            elif act.kind == "corrupt":
                big = max(range(len(host)), key=lambda i: host[i].numel())
                flat = host[big].contiguous().view(-1).view(torch.uint8)
                flat = flat.clone()
                flat[flat.numel() // 2] ^= 0xFF
                host[big] = flat.view(host[big].dtype).view(
                    host[big].shape)
        if crcs is not None:
            if len(crcs) != len(host):
                raise WeightTransferError(
                    version, self.name,
                    f"crc count {len(crcs)} != tensor count {len(host)}")
            for i, a in enumerate(host):
                got = crc32(a)
                if got != (crcs[i] & 0xFFFFFFFF):
                    raise WeightTransferError(
                        version, self.name,
                        f"tensor {i} CRC mismatch (got {got:#010x}, "
                        f"manifest {crcs[i] & 0xFFFFFFFF:#010x})")
        self._staged_weights[version] = [a.to(self.device, copy=True)
                                         for a in host]
        return version

    def commit_weight_set(self, version):
        """Swap a STAGED version in at a step boundary: a swap of
        references, no copy of weights. The serving set is kept (rollback
        buffer, and the set in-flight pinned streams finish under) and
        ``version`` becomes what new admissions pin to; its decode windows
        are captured at first use. Raises PublishRejectedError
        ('stale_version') when ``version`` does not advance the active one,
        ('not_staged') when it was never staged. Returns the previous
        version."""
        from ..distributed.resilience.errors import PublishRejectedError

        self._check_alive()
        if version <= self._active_wv:
            raise PublishRejectedError(
                "stale_version", version, fence_version=self._active_wv)
        staged = self._staged_weights.pop(version, None)
        if staged is None:
            raise PublishRejectedError(
                "not_staged", version,
                detail=f"stage_weight_set({version}, ...) never completed "
                       f"on engine {self.name}")
        old = self._active_wv
        self._weight_sets[old] = self._params
        self._weight_sets[version] = staged
        self._params = staged
        self._prev_wv = old
        self._active_wv = version
        self._gc_weight_sets()
        self._m.weight_swaps.inc()
        self._m.weight_version.set(version)
        return old

    def discard_staged(self, version=None):
        """Drop staged, uncommitted sets (all, or one version): a refused
        candidate must not stay in device memory."""
        if version is None:
            self._staged_weights.clear()
        else:
            self._staged_weights.pop(version, None)

    def rollback_weight_set(self):
        """Roll back to the kept previous version, bit for bit as if it had
        never been promoted: its set becomes active again, and every
        in-flight stream pinned to the dropped version is RESET (pages
        released, tokens discarded) and pinned to the previous one, so its
        regeneration under the schedule-independent salts gives the stream
        a never-promoted engine gives. The dropped version's set, windows
        and their graphs go. Returns the version rolled back to."""
        from ..distributed.resilience.errors import PublishRejectedError

        self._check_alive()
        if self._prev_wv is None or self._prev_wv not in self._weight_sets:
            raise PublishRejectedError(
                "no_previous", self._active_wv,
                detail="nothing retained to roll back to")
        bad, prev = self._active_wv, self._prev_wv
        self._params = self._weight_sets[prev]
        self._active_wv = prev
        self._prev_wv = None          # a rollback cannot be rolled back
        for r in self.pending():
            if r.weight_version == bad:
                self._release(r)
                r.generated = []
                r.cached = 0
                r.prefix_registered = False
                r.spec_observed = 0
                r.weight_version = prev
                self._try_prefix_match(r)
        self._weight_sets.pop(bad, None)
        self._staged_weights.pop(bad, None)
        self._drop_version(bad)
        self._m.weight_rollbacks.inc()
        self._m.weight_version.set(prev)
        return prev

    def _gc_weight_sets(self):
        """Free kept sets no stream can reach, with their decode windows
        and graphs: keep the active version, the rollback buffer and every
        version an in-flight stream is pinned to."""
        keep = {self._active_wv}
        if self._prev_wv is not None:
            keep.add(self._prev_wv)
        keep.update(r.weight_version for r in self.pending())
        for v in [v for v in self._weight_sets if v not in keep]:
            del self._weight_sets[v]
        for v in [v for v in self._views.keys() | self._windows.keys()
                  if v not in keep]:
            self._drop_version(v)

    def probe_logits(self, prompt, version=None):
        """Stateless canary probe (serving.py:1258-1301): next-token logits
        of ``prompt``'s last position under ``version`` (default: active;
        a staged set can be scored before it is committed), without
        touching a live page, the scheduler or any request: one packed row
        through the fresh-prefill route, its KV written to the trash page
        0. Returns a float32 numpy vector of vocabulary logits."""
        self._check_alive()
        if self._model is None:
            raise ValueError("probe_logits needs a from_model engine: the "
                             "exported serving artifact has no "
                             "fresh-prefill entry")
        cfg = self.cfg
        n = len(prompt)
        if not 0 < n <= cfg.token_budget:
            raise ValueError(
                f"probe prompt length {n} must be in [1, "
                f"{cfg.token_budget}] (one fresh-prefill shot)")
        wv = self._active_wv if version is None else version
        if wv != self._active_wv and wv in self._staged_weights:
            view = self._make_view(self._staged_weights[wv])
        else:
            view = self._view(wv)
        B1 = cfg.max_batch + 1
        enc = np.zeros(B1, np.int64)
        dec = np.zeros(B1, np.int64)
        this = np.zeros(B1, np.int64)
        this[0] = n
        n_pad = cfg.token_budget - n
        this[B1 - 1] = n_pad
        enc[B1 - 1] = n_pad
        tokens = np.asarray(list(prompt) + [0] * n_pad, np.int64)
        cu = np.zeros(B1 + 1, np.int64)
        cu[1:] = np.cumsum(this)
        bt = np.zeros((B1, cfg.max_blocks_per_seq), np.int64)
        ins = self._tensors(tokens, enc, dec, this, cu, bt)
        with torch.inference_mode():
            logits = self._model(*ins, self._kc, self._vc, self._ks,
                                 self._vs, fresh_prefill=True, weights=view,
                                 workspace=self._stream_ws)[0]
            return logits[0].float().cpu().numpy()

    # -- scheduling ------------------------------------------------------
    def add_request(self, prompt_tokens, max_new_tokens=8, sampling=None,
                    eos_token_id=None, deadline_s=None, tenant=None):
        """Admit one request. ``deadline_s`` (seconds from submit) bounds
        its total latency: a request unfinished past it is evicted before
        the next step or decode window (``_evict_expired``: pages freed,
        ``timed_out`` set, ``requeue_hook`` told). ``tenant`` scopes its
        prefix-cache reads and writes to that tenant's namespace. Raises
        EngineOverloadedError when cfg.max_queue live requests already
        exist, EngineDeadError when the engine is dead."""
        self._check_alive()
        if len(prompt_tokens) == 0:
            raise ValueError("prompt must contain at least one token "
                             "(an empty row would read another request's "
                             "logits)")
        if len(prompt_tokens) + max_new_tokens > self.cfg.max_seq:
            raise ValueError("prompt + max_new_tokens exceeds max_seq")
        if self.cfg.max_queue is not None \
                and len(self.pending()) >= self.cfg.max_queue:
            self._m.shed.inc()
            raise EngineOverloadedError(
                f"engine saturated: {len(self.pending())} live requests "
                f">= max_queue={self.cfg.max_queue}; shed this request "
                f"(retry later or on another replica)")
        rid = self._next_rid
        self._next_rid += 1
        req = _Request(rid, prompt_tokens, max_new_tokens, sampling,
                       eos_token_id, tenant=tenant, deadline_s=deadline_s)
        # the whole stream runs under the version serving at admission
        req.weight_version = self._active_wv
        self._requests[rid] = req
        self._try_prefix_match(req)
        # the root (or ambient-parented) span of the request's trace; the
        # request keeps its context for every later lifecycle span
        req.trace = _tracing.record_span(
            "serving::admit", req.submit_t, time.perf_counter(),
            args={"rid": rid, "engine": self.name})
        self._m.requests.inc()
        return rid

    def set_metrics_namespace(self, namespace):
        """Bind this engine's serving/* writes to the named child registry
        of the global one (a replica's own series, rolled up into the
        global ones), or back to the global registry for None."""
        self.metrics_namespace = namespace
        reg = _metrics.registry() if namespace is None \
            else _metrics.child(namespace)
        self._m = _EngineMetrics(reg)
        return self._m

    def set_drafter(self, drafter, k=None):
        """Attach a speculative drafter (inference/speculative.py;
        serving.py:900-926). While one is set, a step whose scheduled rows
        are all at their decode tip runs as one verify step: the drafter
        proposes up to ``k`` tokens a row, the model scores them in one
        paged step, and each position is sampled under the salt the plain
        path would use there, so the stream is the non-speculative one
        token for token; pages holding only rejected tokens go back to the
        pool. ``k`` defaults to ``PT_SPEC_K`` (environment) or 4;
        ``set_drafter(None)`` turns speculation off."""
        if drafter is not None and self._model is None:
            raise ValueError(
                "speculative decoding needs a from_model engine: the "
                "exported serving artifact has no all-positions verify "
                "entry")
        self._drafter = drafter
        if k is not None:
            self._spec_k = int(k)
        elif self._spec_k <= 0:
            self._spec_k = int(os.environ.get("PT_SPEC_K", "4"))
        if self._spec_k < 1:
            raise ValueError("speculative draft length k must be >= 1")
        return drafter

    def spec_stats(self):
        """The speculative counters: verify steps, rows verified, tokens
        emitted, drafted and accepted, the acceptance rate and tokens
        emitted a row a verify step (the reference's serving/spec_*
        series)."""
        return {"steps": self._spec_steps,
                "rows": self._spec_rows_total,
                "emitted": self._spec_emitted_total,
                "drafted": self._spec_drafted_total,
                "accepted": self._spec_accepted_total,
                "accept_rate": (self._spec_accepted_total
                                / self._spec_drafted_total
                                if self._spec_drafted_total else 0.0),
                "tokens_per_row_step": (self._spec_emitted_total
                                        / self._spec_rows_total
                                        if self._spec_rows_total else 0.0)}

    def _spec_observe(self, r):
        """Feed the drafter what it has not seen of this request (the
        prompt on first contact, then each newly emitted suffix)."""
        seq = r.prompt + r.generated
        if r.spec_observed < len(seq):
            self._drafter.observe(seq, start=r.spec_observed)
            r.spec_observed = len(seq)

    def _try_prefix_match(self, req):
        """Map the request's leading full prompt blocks onto cached pages:
        a hit moves ``cached`` past the shared tokens, so scheduling skips
        their prefill."""
        cache = self._prefix_cache
        if cache is None or req.pages:
            return
        pages, keys, n_tok = cache.match(req.prompt, namespace=req.tenant,
                                         version=req.weight_version)
        if n_tok:
            req.pages = list(pages)
            req.shared_keys = keys
            req.cached = n_tok
            self._m.prefix_pages.inc(len(pages))
        self._m.prefix_rate.set(cache.hit_rate())

    def _maybe_register_prefix(self, req):
        """Once a request's prompt is fully prefilled, publish its full
        prompt blocks into the prefix cache (the pages pass to the cache;
        the request keeps a ref)."""
        cache = self._prefix_cache
        if cache is None or req.prefix_registered \
                or req.cached < len(req.prompt):
            return
        req.prefix_registered = True
        req.shared_keys.extend(cache.insert(req.prompt, req.pages,
                                            namespace=req.tenant,
                                            version=req.weight_version))

    def _snapshot_root(self, root):
        root = root or self.cfg.prefix_snapshot_root
        if root is None:
            raise ValueError("no snapshot root: pass root= or set "
                             "cfg.prefix_snapshot_root")
        return root

    def save_prefix_cache(self, root=None, keep=None):
        """Snapshot the prefix cache (trie + its KV pages, and their
        scales for int8 pools) under ``root`` (default
        cfg.prefix_snapshot_root); returns the snapshot path, or None when
        the cache is empty."""
        return save_snapshot(self, self._snapshot_root(root), keep=keep)

    def restore_prefix_cache(self, root=None):
        """Restore the newest complete snapshot under ``root`` (default
        cfg.prefix_snapshot_root) into this engine's cache, after sweeping
        torn snapshot dirs. Returns the blocks restored."""
        return restore_snapshot(self, self._snapshot_root(root))

    def pending(self):
        return [r for r in self._requests.values() if not r.done]

    def _evict_expired(self):
        """The deadline sweep before scheduling (serving.py:966-983):
        requests past their deadline finish now as timed out, their pages
        back in the pool, each handed to ``requeue_hook`` when one is
        set."""
        now = time.perf_counter()
        for r in self.pending():
            if r.deadline_t is not None and now > r.deadline_t:
                r.timed_out = True
                r.done = True
                self._release(r)
                self._m.deadline.inc()
                if self.requeue_hook is not None:
                    self.requeue_hook(self._requeue_info(r))

    @staticmethod
    def _requeue_info(r):
        """What a router needs to retry an evicted request elsewhere
        (serving.py:985-1001): the prompt, the progress, the budget and
        sampling, the stream's sampling identity (``salt_rid``,
        ``salt_seed``; a seed of None means the evicting engine's own),
        its pinned weight version and its trace context."""
        return {"rid": r.rid, "prompt": list(r.prompt),
                "generated": list(r.generated), "max_new": r.max_new,
                "sampling": r.sampling, "eos_token_id": r.eos_token_id,
                "timed_out": True, "requeues": r.requeues,
                "tenant": r.tenant, "salt_rid": r.salt_rid,
                "salt_seed": r.salt_seed,
                "weight_version": r.weight_version,
                "trace": r.trace.to_dict() if r.trace is not None
                else None}

    def timed_out_requests(self):
        """rids evicted by the deadline sweep (a front-end's 504)."""
        return [r.rid for r in self._requests.values() if r.timed_out]

    # -- liveness and chaos sites -----------------------------------------
    def _check_alive(self):
        # getattr: argument checks stay usable on an engine built without
        # __init__
        if getattr(self, "dead", False):
            from ..distributed.resilience.errors import EngineDeadError

            raise EngineDeadError(self.name)

    def _fault_event(self, site):
        """Consult the chaos injector at a serving site (serving.py:
        1012-1028): ``kill`` fells THIS engine (``dead`` and
        EngineDeadError: a replica's death, in-process), ``delay``
        sleeps; the frame kinds mean nothing here."""
        from ..distributed.resilience import faults as _faults

        act = _faults.injector.on_event(site, self.fault_rank)
        if act is None:
            return
        if act.kind == "kill":
            self.dead = True
            from ..distributed.resilience.errors import EngineDeadError

            raise EngineDeadError(self.name, site)
        if act.kind == "delay":
            time.sleep(act.delay_ms / 1e3)

    def _salt(self, r, n_generated):
        """The salt of a request's token ``n_generated`` under its ORIGIN
        identity: a request moved here from another engine keeps that
        engine's (seed, rid), so it samples the stream it would have
        sampled there. The decode windows advance these salts on the
        device from the first step's."""
        seed = self.seed if r.salt_seed is None else r.salt_seed
        return sampling_salt(seed, r.salt_rid, n_generated)

    def _take_free_page(self):
        """Pop one free page, reclaiming a zero-ref prefix-cache page when
        the pool is dry (cache residency never blocks live traffic)."""
        if not self._free_pages and self._prefix_cache is not None:
            self._free_pages.extend(self._prefix_cache.evict(1))
        if not self._free_pages:
            raise RuntimeError("KV page pool exhausted")
        return self._free_pages.pop()

    def _available_pages(self):
        """Free pages, and the zero-ref cache pages eviction can take."""
        n = len(self._free_pages)
        if self._prefix_cache is not None:
            n += self._prefix_cache.evictable_count()
        return n

    def _ensure_pages(self, req, upto_len):
        need = math.ceil(upto_len / self.cfg.block_size)
        while len(req.pages) < need:
            req.pages.append(self._take_free_page())

    def _release(self, req):
        cache = self._prefix_cache
        if req.shared_keys:
            cache.release(req.shared_keys)
            req.shared_keys = []
        if cache is not None:
            owned = cache.owned_pages()
            self._free_pages.extend(p for p in req.pages if p not in owned)
        else:
            self._free_pages.extend(req.pages)
        req.pages = []

    def _schedule(self):
        """Pick <= max_batch rows and a chunk size for each within the
        token budget (chunked prefill: a request needing more tokens than
        fit this step takes the next chunk of prompt+generated)."""
        cfg = self.cfg
        rows = []
        budget = cfg.token_budget
        avail = self._available_pages()
        # one weight version a step: after a swap the step serves the
        # OLDEST pending stream's version first (serving.py:1390-1411)
        step_wv = None
        for r in self.pending():
            if len(rows) == cfg.max_batch or budget == 0:
                break
            if step_wv is not None and r.weight_version != step_wv:
                continue
            chunk = min(r.length - r.cached, budget)
            cap = (len(r.pages) + avail) * cfg.block_size  # page-limited
            chunk = min(chunk, cap - r.cached)
            if chunk <= 0:
                continue  # defer: rerun once budget/pages free up
            pages_needed = max(
                math.ceil((r.cached + chunk) / cfg.block_size)
                - len(r.pages), 0)
            budget -= chunk
            avail -= pages_needed
            rows.append((r, chunk))
            step_wv = r.weight_version
        return rows

    def _tensors(self, *arrays):
        return [torch.from_numpy(np.ascontiguousarray(a)).to(
            self.device, torch.int64) for a in arrays]

    def _forward(self, version, tokens, enc, dec, this, cu, bt, fresh=False,
                 all_logits=False):
        """The logits of one step over the engine's caches (updated in
        place) under weight ``version``, from the live model, or from the
        artifact's program fed that version's flat weights (its logits f32,
        its route always the paged one)."""
        if self._program is not None:
            return self._program(self._params_for(version), self._buffers,
                                 tokens, enc, dec, this, cu, bt, self._kc,
                                 self._vc)[0]
        return self._model(tokens, enc, dec, this, cu, bt, self._kc,
                           self._vc, self._ks, self._vs, fresh_prefill=fresh,
                           all_logits=all_logits, weights=self._view(version),
                           workspace=self._stream_ws)[0]

    def _run(self, version, tokens, enc, dec, this, cu, bt, fresh=False,
             all_logits=False):
        """One forward step from host arrays (``_forward``)."""
        ins = self._tensors(tokens, enc, dec, this, cu, bt)
        with torch.inference_mode():
            return self._forward(version, *ins, fresh=fresh,
                                 all_logits=all_logits)

    def step(self):
        """One engine iteration: schedule <= max_batch live requests
        (prefill chunks and decode mixed) within the token budget, run the
        step once, sample one token for each request at its sequence tip.
        Returns the produced (rid, token) pairs."""
        cfg = self.cfg
        self._check_alive()
        self._evict_expired()
        rows = self._schedule()
        preempted = set()
        while not rows and self.pending():
            # pool deadlock: in-flight requests hold pages but none can
            # grow — preempt the NEWEST holder (the oldest always makes
            # progress); the victim re-prefills prompt+generated later
            holders = [r for r in self.pending() if r.pages]
            if not holders:
                raise RuntimeError(
                    "KV page pool exhausted: no pending request fits in "
                    f"{len(self._free_pages)} free pages — raise "
                    "num_blocks or lower concurrency")
            victim = max(holders, key=lambda r: r.rid)
            self._release(victim)
            victim.cached = 0
            victim.prefix_registered = False
            if victim.rid not in preempted:
                # its shared prefix may still be cached: match again, once
                # a sweep (a matched prefix makes it a holder again)
                self._try_prefix_match(victim)
            preempted.add(victim.rid)
            self._m.preempt.inc()
            rows = self._schedule()
        if not rows:
            return []
        # chaos sites, consulted before any page allocation or cache write
        # (serving.py:1456-1463): a kill here leaves every scheduled request
        # as it was before the step (a decode row still at its tip), so a
        # supervisor can migrate it whole
        if any(r.cached < len(r.prompt) for r, _ in rows):
            self._fault_event("prefill")
        if any(r.cached >= len(r.prompt) for r, _ in rows):
            self._fault_event("decode")
        self._m.steps.inc()
        self._update_pool_gauges(len(rows))
        # a request's first scheduling ends its queue span
        now_sched = time.perf_counter()
        for r, _chunk in rows:
            if r.sched_t0 is None:
                r.sched_t0 = now_sched
                if r.trace is not None:
                    _tracing.record_span(
                        "serving::queue", r.submit_t, now_sched,
                        parent=r.trace,
                        args={"rid": r.rid, "engine": self.name})
        # a pure decode-tip batch runs as one draft + verify step
        if self._drafter is not None and all(
                chunk == 1 and r.cached == r.length - 1
                for r, chunk in rows):
            return self._spec_step(rows)

        B1 = cfg.max_batch + 1
        enc = np.zeros(B1, np.int64)
        dec = np.zeros(B1, np.int64)
        this = np.zeros(B1, np.int64)
        bt = np.zeros((B1, cfg.max_blocks_per_seq), np.int64)  # 0 = trash
        packed = []
        for i, (r, chunk) in enumerate(rows):
            seq = r.prompt + r.generated
            dec[i] = r.cached                # chunk starts at this pos
            this[i] = chunk
            self._ensure_pages(r, r.cached + chunk)
            bt[i, :len(r.pages)] = r.pages
            packed.extend(seq[r.cached:r.cached + chunk])
        # padding tokens -> trash row (index B1-1, block table all page 0)
        n_pad = cfg.token_budget - len(packed)
        this[B1 - 1] = n_pad
        enc[B1 - 1] = n_pad
        tokens = np.asarray(packed + [0] * n_pad, np.int64)
        cu = np.zeros(B1 + 1, np.int64)
        cu[1:] = np.cumsum(this)
        # fresh-prefill steps (every scheduled row starts at position 0)
        # run block-diagonal varlen flash over the packed tokens; an
        # artifact has only the paged route
        fresh = self._program is None \
            and all(r.cached == 0 for r, _ in rows)
        logits = self._run(rows[0][0].weight_version, tokens, enc, dec, this,
                           cu, bt, fresh)
        self.last_logits = logits

        temps = np.zeros(B1, np.float32)
        topks = np.zeros(B1, np.int64)
        topps = np.ones(B1, np.float32)
        salts = np.zeros(B1, np.int64)
        tip = [False] * len(rows)
        for i, (r, chunk) in enumerate(rows):
            if r.cached + chunk == r.length:
                tip[i] = True
                sp = r.sampling
                temps[i] = sp.temperature
                topks[i] = sp.top_k
                topps[i] = sp.top_p
                salts[i] = self._salt(r, len(r.generated))
        if not any(tip):
            # pure prefill-chunk step: nothing to sample, no host sync
            for r, chunk in rows:
                r.cached += chunk
                self._maybe_register_prefix(r)
            return []
        with torch.inference_mode():
            sampled = _sample(logits, _sample_mode(temps, topks),
                              *self._sampling_tensors(temps, topks, topps),
                              *self._tensors(salts))
        sampled = sampled.cpu().numpy()                       # host sync

        produced = []
        now = time.perf_counter()
        for i, (r, chunk) in enumerate(rows):
            r.cached += chunk
            self._maybe_register_prefix(r)
            if not tip[i]:
                continue
            nxt = int(sampled[i])
            r.generated.append(nxt)
            produced.append((r.rid, nxt))
            self._note_first_token(r, now)
            if len(r.generated) >= r.max_new \
                    or (r.eos_token_id is not None
                        and nxt == r.eos_token_id):
                r.done = True
                self._release(r)
                self._trace_done(r, now)
        self._m.tokens.inc(len(produced))
        return produced

    def _note_first_token(self, req, now):
        if req.first_tok_t is None:
            req.first_tok_t = now
            self._m.ttft.observe((now - req.submit_t) * 1e3)
            if req.trace is not None:
                begin = req.sched_t0 if req.sched_t0 is not None \
                    else req.submit_t
                _tracing.record_span(
                    "serving::prefill", begin, now, parent=req.trace,
                    args={"rid": req.rid, "engine": self.name})

    def _trace_done(self, req, now):
        """Close the request's decode span (first token to completion)."""
        if req.trace is None:
            return
        begin = req.first_tok_t if req.first_tok_t is not None \
            else req.submit_t
        _tracing.record_span(
            "serving::decode", begin, now, parent=req.trace,
            args={"rid": req.rid, "engine": self.name,
                  "tokens": len(req.generated)})

    def _update_pool_gauges(self, n_rows):
        cfg = self.cfg
        self._m.occupancy.set(n_rows / max(cfg.max_batch, 1))
        live = cfg.num_blocks - 1 - len(self._free_pages)  # page 0 = trash
        self._m.kv_util.set(live / max(cfg.num_blocks - 1, 1))

    def _sampling_tensors(self, temps, topks, topps):
        return [torch.from_numpy(a).to(self.device)
                for a in (temps, topks, topps)]

    # -- multi-step decode (one host sync per window) --------------------
    def decode_run(self, n_steps):
        """Run up to ``n_steps`` decode iterations over the current decode
        batch with ONE host sync: each step's sampled tokens feed the next
        step's inputs on the device. Requests must be at their decode tip;
        pages for the whole window are reserved up front so block tables
        stay fixed. Returns the produced (rid, token) list in step order.

        The counterpart of the reference's ``_decode_run`` over
        ``_decode_window_fn``: on a CUDA device one CUDA graph a (row
        bucket, sampling mode), kept in ``self._window_fns``, is replayed
        once a step; on the CPU the same body runs eagerly. The reference
        keys its executables by the window length too; replays make the
        length free, so the key drops it."""
        return self._decode_window_run(n_steps,
                                       graph=self.device.type == "cuda")

    def _decode_run_eager(self, n_steps):
        """``decode_run`` with the window's body run eagerly on the device
        instead of replaying its graph: the yardstick that chip_smoke.py
        and the GPU tests compare the graphs with. ``decode_run`` never
        takes it."""
        return self._decode_window_run(n_steps, graph=False)

    def _window(self, Bb, mode, graph, version):
        wins = self._windows.setdefault(version, {})
        win = wins.get((Bb, mode))
        if win is None:
            win = _DecodeWindow(self, Bb, mode, version)
        if graph and win.graph is None:
            pool = self._graph_pools.get(version)
            if pool is None:
                pool = self._graph_pools[version] = \
                    torch.cuda.graph_pool_handle()
            with torch.inference_mode():
                win.capture(pool)
        wins[(Bb, mode)] = win
        return win

    def _decode_window_run(self, n_steps, graph):
        cfg = self.cfg
        self._check_alive()
        self._evict_expired()
        rows = [r for r in self.pending() if r.length - r.cached == 1]
        if rows:
            # one weight version a window, the oldest tip row's first
            # (serving.py:1841-1847)
            wv = rows[0].weight_version
            rows = [r for r in rows
                    if r.weight_version == wv][:cfg.max_batch]
        if not rows:
            return []
        # the step's pre-write contract: every selected row is at its
        # decode tip when a kill fires here, so it can migrate
        self._fault_event("decode")
        n = min([n_steps] + [r.max_new - len(r.generated) for r in rows])
        # clamp the window to what the page pool can hold (free pages and
        # the zero-ref cache pages _take_free_page may evict); callers fall
        # back to step() (which can preempt) when not one step fits
        free = self._available_pages()
        while n > 0 and sum(
                max(math.ceil((r.cached + n) / cfg.block_size)
                    - len(r.pages), 0) for r in rows) > free:
            n -= 1
        if n <= 0:
            return []
        if n < n_steps:
            # tail windows round down to a power of two, as the reference
            # bounds its compiled window shapes
            n = 1 << (n.bit_length() - 1)
        B = len(rows)
        B1 = cfg.max_batch + 1
        for r in rows:
            self._ensure_pages(r, r.cached + n)
            self._maybe_register_prefix(r)
        self._update_pool_gauges(B)
        self._m.steps.inc(n)
        t_start = time.perf_counter()
        # the row count is bucketed to a power of two (the reference's
        # executable-reuse rule); the bucket's spare slots are padding
        # routed to the trash row like any other, and so is an artifact's
        # padding up to its fixed token length (serving.py:1888-1893)
        Bb = min(_next_pow2(B), cfg.max_batch)
        enc = np.zeros(B1, np.int64)
        this = np.zeros(B1, np.int64)
        this[:B] = 1
        n_pad = (self._fixed_token_len or Bb) - B
        this[B1 - 1] = n_pad
        enc[B1 - 1] = n_pad
        cu = np.zeros(B1 + 1, np.int64)
        cu[1:] = np.cumsum(this)
        bt = np.zeros((B1, cfg.max_blocks_per_seq), np.int64)
        for i, r in enumerate(rows):
            bt[i, :len(r.pages)] = r.pages
        dec = np.zeros(B1, np.int64)
        dec[:B] = [r.cached for r in rows]
        tokens = np.asarray([(r.prompt + r.generated)[-1] for r in rows]
                            + [0] * n_pad, np.int64)
        temps = np.zeros(B1, np.float32)
        topks = np.zeros(B1, np.int64)
        topps = np.ones(B1, np.float32)
        salts = np.zeros(B1, np.int64)
        for i, r in enumerate(rows):
            temps[i] = r.sampling.temperature
            topks[i] = r.sampling.top_k
            topps[i] = r.sampling.top_p
            # the first step's salts; the body advances them on the device
            salts[i] = self._salt(r, len(r.generated))
        win = self._window(Bb, _sample_mode(temps, topks), graph,
                           rows[0].weight_version)
        with torch.inference_mode():
            win.stage(tokens, enc, dec, this, cu, bt, temps, topks, topps,
                      salts)
            fetched = win.run(n, graph)                       # host sync
        now = time.perf_counter()
        self._m.tpot.observe((now - t_start) / n * 1e3)
        produced = []
        for j in range(n):
            for i, r in enumerate(rows):
                if r.done:
                    continue
                nxt = int(fetched[j, i])
                r.generated.append(nxt)
                r.cached += 1
                produced.append((r.rid, nxt))
                self._note_first_token(r, now)
                if len(r.generated) >= r.max_new \
                        or (r.eos_token_id is not None
                            and nxt == r.eos_token_id):
                    r.done = True
                    self._release(r)
                    self._trace_done(r, now)
        self._m.tokens.inc(len(produced))
        return produced

    # -- speculative decode (draft k, verify in one paged step) ----------
    def _spec_step(self, rows):
        """One speculative iteration over decode-tip rows (serving.py:
        1579-1743): the drafter proposes up to ``_spec_k`` tokens a row
        (clamped to the remaining max_new, the token budget and the page
        pool), the model scores tip + drafts in one paged step shaped as a
        chunked-prefill continuation with logits at every position, and
        position j of a row is sampled under the salt of its generated
        index g0 + j. A draft is accepted only when it equals the token
        sampled at the position before it; the first mismatch still emits
        its own (correct) sample. Each row is left at its decode tip:
        pages that hold only rejected positions go back to the pool. Runs
        eagerly (no CUDA graph)."""
        cfg = self.cfg
        B1 = cfg.max_batch + 1
        drafter = self._drafter
        budget = cfg.token_budget
        avail = self._available_pages()
        plans = []
        for idx, (r, _chunk) in enumerate(rows):
            self._spec_observe(r)
            rows_after = len(rows) - idx - 1
            cap = min(self._spec_k, r.max_new - len(r.generated) - 1,
                      budget - 1 - rows_after)
            drafts = []
            if cap > 0:
                for t in list(drafter.propose(r.prompt + r.generated,
                                              cap))[:cap]:
                    t = int(t)
                    if not 0 <= t < cfg.vocab_size:
                        break      # a draft outside the vocabulary
                    drafts.append(t)

            def pages_needed(n_drafts):
                return max(math.ceil((r.cached + 1 + n_drafts)
                                     / cfg.block_size) - len(r.pages), 0)

            while drafts and pages_needed(len(drafts)) > avail:
                drafts.pop()       # page-limited: shorten the proposal
            avail -= pages_needed(len(drafts))
            budget -= 1 + len(drafts)
            plans.append((r, drafts))

        enc = np.zeros(B1, np.int64)
        dec = np.zeros(B1, np.int64)
        this = np.zeros(B1, np.int64)
        bt = np.zeros((B1, cfg.max_blocks_per_seq), np.int64)
        packed = []
        spans = []
        for i, (r, drafts) in enumerate(plans):
            n_feed = 1 + len(drafts)
            dec[i] = r.cached
            this[i] = n_feed
            self._ensure_pages(r, r.cached + n_feed)
            bt[i, :len(r.pages)] = r.pages
            spans.append((len(packed), n_feed))
            packed.append((r.prompt + r.generated)[-1])
            packed.extend(drafts)
        # padding to a power of two (the trash row takes it), as the
        # reference bounds its verify shapes
        tok_len = min(_next_pow2(len(packed)), cfg.token_budget)
        n_pad = tok_len - len(packed)
        this[B1 - 1] = n_pad
        enc[B1 - 1] = n_pad
        tokens = np.asarray(packed + [0] * n_pad, np.int64)
        cu = np.zeros(B1 + 1, np.int64)
        cu[1:] = np.cumsum(this)
        logits = self._run(plans[0][0].weight_version, tokens, enc, dec,
                           this, cu, bt, all_logits=True)     # [tok_len, V]
        self.last_logits = logits

        P = len(packed)
        temps = np.zeros(P, np.float32)
        topks = np.zeros(P, np.int64)
        topps = np.ones(P, np.float32)
        salts = np.zeros(P, np.int64)
        for i, (r, _drafts) in enumerate(plans):
            p0, n_feed = spans[i]
            sp = r.sampling
            g0 = len(r.generated)
            for j in range(n_feed):
                temps[p0 + j] = sp.temperature
                topks[p0 + j] = sp.top_k
                topps[p0 + j] = sp.top_p
                salts[p0 + j] = self._salt(r, g0 + j)
        with torch.inference_mode():
            sampled = _sample(logits[:P], _sample_mode(temps, topks),
                              *self._sampling_tensors(temps, topks, topps),
                              *self._tensors(salts))
        sampled = sampled.cpu().numpy()                       # host sync

        produced = []
        for i, (r, drafts) in enumerate(plans):
            p0, n_feed = spans[i]
            emitted = [int(sampled[p0])]
            for j in range(1, n_feed):
                if drafts[j - 1] != emitted[-1]:
                    break
                emitted.append(int(sampled[p0 + j]))
            self._spec_drafted_total += len(drafts)
            self._spec_accepted_total += len(emitted) - 1
            self._m.spec_drafted.inc(len(drafts))
            self._m.spec_accepted.inc(len(emitted) - 1)
            for t in emitted:
                r.generated.append(t)
                produced.append((r.rid, t))
                if len(r.generated) >= r.max_new \
                        or (r.eos_token_id is not None
                            and t == r.eos_token_id):
                    r.done = True
                    break
            # back to the decode tip: the accepted run's KV is in place;
            # pages holding only rejected positions return to the pool
            r.cached = r.length - 1
            self._maybe_register_prefix(r)
            if r.done:
                self._release(r)
                self._trace_done(r, time.perf_counter())
            else:
                keep = math.ceil(r.cached / cfg.block_size)
                if len(r.pages) > keep:
                    self._free_pages.extend(r.pages[keep:])
                    del r.pages[keep:]
        self._spec_steps += 1
        self._spec_emitted_total += len(produced)
        self._spec_rows_total += len(plans)
        self._m.spec_steps.inc()
        self._m.tokens.inc(len(produced))
        if self._spec_drafted_total:
            self._m.spec_accept_rate.set(
                self._spec_accepted_total / self._spec_drafted_total)
        if plans:
            self._m.spec_tokens_per_step.set(len(produced) / len(plans))
        return produced

    def run_to_completion(self, max_steps=1000):
        for _ in range(max_steps):
            if not self.pending():
                break
            self.step()
        return {rid: list(r.generated)
                for rid, r in self._requests.items()}


def _paged_specs(cfg):
    """The artifact's eight inputs at the engine's static shapes
    (serving.py:1973-1986). The index inputs are int64, the dtype the
    port's engine stages them in (the reference's int32 is JAX's 32-bit
    default); the pools are cfg.dtype."""
    from ..jit.api import InputSpec

    B1 = cfg.max_batch + 1
    pools = (cfg.num_layers, cfg.num_blocks, cfg.num_kv_heads,
             cfg.block_size, cfg.head_dim)
    return [
        InputSpec((cfg.token_budget,), "int64", "tokens"),
        InputSpec((B1,), "int64", "seq_lens_encoder"),
        InputSpec((B1,), "int64", "seq_lens_decoder"),
        InputSpec((B1,), "int64", "seq_lens_this_time"),
        InputSpec((B1 + 1,), "int64", "cu_seqlens_q"),
        InputSpec((B1, cfg.max_blocks_per_seq), "int64", "block_tables"),
        InputSpec(pools, cfg.dtype, "key_caches"),
        InputSpec(pools, cfg.dtype, "value_caches"),
    ]


def save_paged_model(path_prefix: str, model: PagedCausalLM):
    """Export the paged step as a serving artifact at the engine's static
    shapes (serving.py:1966-1992), through ``save_inference_model``: bf16
    weights and compute for a bfloat16 config, f32 logits, the pools
    updated in place. The program takes the paged route (the reference's
    artifact has no fresh-prefill entry). An int8 ``cache_quant`` config
    raises ValueError: the artifact's inputs carry no scale pools. Weight
    streaming is ``from_model``'s: an artifact carries full weights."""
    from . import PrecisionType, save_inference_model

    cfg = model.cfg
    if cfg.cache_quant is not None:
        raise ValueError("save_paged_model: the artifact's inputs carry no "
                         "scale pools, so an int8 cache_quant engine serves "
                         "through ServingEngine.from_model")
    precision = PrecisionType.Bfloat16 if cfg.dtype == "bfloat16" \
        else PrecisionType.Float32
    return save_inference_model(path_prefix, model, _paged_specs(cfg),
                                precision=precision,
                                output_names=["logits", "key_caches",
                                              "value_caches"])
