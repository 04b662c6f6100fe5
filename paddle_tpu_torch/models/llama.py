"""The functional stacked Llama core (paddle_tpu/models/llama.py:48-91,
392-576): the training path's model.

Parameters are a dict of tensors with the TPU package's pytree keys and
shapes: block weights stacked on a leading layer axis, Linear weights in
the [in, out] layout of ``x @ w``, the norm weights in f32. The trunk is a
Python loop over the layers (the TPU package's ``lax.scan``); with
``remat=True`` each layer runs under ``torch.utils.checkpoint`` (the
TPU package's ``jax.checkpoint``), so its forward, attention kernel
included, runs again in the backward. Attention goes through
ops/kernels/flash_attention.py (the CUDA kernels on a card), RMSNorm
through ops/kernels/rms_norm.py.

Beside it, the eager model (llama.py:129-385): ``LlamaAttention``,
``LlamaMLP``, ``LlamaDecoderLayer``, ``LlamaModel`` and
``LlamaForCausalLM`` as nn.Layers over the eager surface (Tensor, the op
funnel, nn.Linear / nn.Embedding / nn.RMSNorm, F.scaled_dot_product_attention,
recompute), with ``generate``'s greedy KV-cached decode. Its parameters
are f32, the reference's default; ``dtype="bfloat16"`` casts the
embedding's output only, so without AMP the trunk computes in f32 from the
first projection on (bf16 times f32 promotes), and under
``amp.auto_cast("O1", "bfloat16")`` the projections and attention run in
bf16 and RMSNorm and the loss in f32.

Over a mesh (``loss_fn_stacked(..., hcg=)``, HybridTrainer's path) each
rank holds the shards ``param_specs`` gives it (llama.py:426-449) and the
trunk runs Megatron's tensor parallelism over 'mp' and FSDP over
'sharding' (``_Par``): the vocab-parallel lookup, each layer's leaves
all-gathered over 'sharding' inside the remat'd block (so recomputation
gathers again, and the gradients come back reduce-scattered), attention at
H/mp heads through the same flash kernels, ``wo`` and ``w_down`` summed
over 'mp', and a vocab-parallel LSE loss with the reference's stop-gradient
max. Under fleet.init with mp > 1 the eager model builds the
tensor-parallel layers, as the reference's does (llama.py:118-122).

Over a mesh with a 'pp' axis (``loss_fn_pipelined``, HybridTrainer's
pipelined path) each rank holds num_hidden_layers / pp layers, and the
micro-batches go through them as a ring of sends and receives
(distributed/meta_parallel/pipeline_parallel.py::spmd_pipeline).

Over a mesh with a 'sep' axis each rank holds 1/sep of every sequence (sep
rank r the positions r·S/sep onwards): RoPE rotates at those global
positions, and attention runs as a ring over the sep group
(ops/kernels/ring_attention.py: the K/V shards passed round, each hop
through the flash kernels), as the reference's ``shard_map`` over 'sep'
(llama.py:486-509) does.

Not ported here: ``generate_static`` (the compile tier).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from .. import nn
from ..core.tensor import Tensor
from ..incubate.nn import functional as IF
from ..nn import functional as F
from ..ops import manipulation, search
from ..ops.kernels import flash_attention as fa
from ..ops.kernels import resolve_device
from ..ops.kernels import ring_attention as ra
from ..ops.kernels import rms_norm as rn

__all__ = ["LlamaConfig", "LLAMA_PRESETS", "init_stacked_params",
           "forward_stacked", "loss_fn_stacked", "microbatch_spec",
           "loss_fn_pipelined", "num_params",
           "param_specs", "shard_leaf",
           "LlamaAttention", "LlamaMLP", "LlamaDecoderLayer", "LlamaModel",
           "LlamaForCausalLM"]


@dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: Optional[int] = None
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False
    dtype: str = "bfloat16"
    use_flash_attention: bool = True
    recompute: bool = True
    # "full" recomputes the whole block in the backward; "save_attn" keeps
    # each block's attention output (the attention forward is not run again)
    remat_policy: str = "full"

    def __post_init__(self):
        if self.num_key_value_heads is None:
            self.num_key_value_heads = self.num_attention_heads

    @property
    def head_dim(self):
        return self.hidden_size // self.num_attention_heads


LLAMA_PRESETS = {
    "llama2-7b": LlamaConfig(),
    "llama2-13b": LlamaConfig(hidden_size=5120, intermediate_size=13824,
                              num_hidden_layers=40, num_attention_heads=40),
    "llama2-70b": LlamaConfig(hidden_size=8192, intermediate_size=28672,
                              num_hidden_layers=80, num_attention_heads=64,
                              num_key_value_heads=8),
    "tiny": LlamaConfig(vocab_size=512, hidden_size=256,
                        intermediate_size=512, num_hidden_layers=2,
                        num_attention_heads=4, max_position_embeddings=512),
    "debug": LlamaConfig(vocab_size=256, hidden_size=128,
                         intermediate_size=256, num_hidden_layers=2,
                         num_attention_heads=2, num_key_value_heads=2,
                         max_position_embeddings=256, dtype="float32"),
}

_BLOCK_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
               "ln_attn", "ln_mlp")


def _torch_dtype(name):
    return torch.bfloat16 if name == "bfloat16" else torch.float32


def init_stacked_params(config: LlamaConfig, seed: int = 0,
                        device=None, hcg=None) -> Dict[str, Any]:
    """The stacked-parameter dict (llama.py:392-423): normal weights scaled
    by 1/sqrt(fan_in) (embeddings 0.02) in the model dtype, norm weights
    ones in f32. Drawn on ``device`` from a generator seeded with ``seed``
    (the numbers differ from the TPU package's jax.random ones). With a
    hybrid group ``hcg`` each leaf is drawn whole, in the same order, and
    only this rank's shard (``param_specs``) is kept before the next is
    drawn: every mesh starts from the parameters of one process."""
    dev = resolve_device(device)
    specs = layout = None
    if hcg is not None:
        from ..distributed.topology import rank_layout

        specs, layout = leaves(param_specs(config)), rank_layout(hcg)
    d = _torch_dtype(config.dtype)
    h, i, v = config.hidden_size, config.intermediate_size, config.vocab_size
    kvh = config.num_key_value_heads * config.head_dim
    L = config.num_hidden_layers
    gen = torch.Generator(device=dev).manual_seed(seed)

    def norm_init(shape, scale=None):
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        s = scale if scale is not None else fan_in ** -0.5
        w = torch.randn(shape, generator=gen, device=dev,
                        dtype=torch.float32)
        return (w.mul_(s)).to(d)

    def ones(*shape):
        return torch.ones(shape, dtype=torch.float32, device=dev)

    def keep(name, t):
        """``t`` whole, or its shard on this rank (before the next draw)."""
        return t if specs is None else shard_leaf(t, specs[name], layout)

    def block(key, t):
        return keep(f"['blocks']['{key}']", t)

    # drawn in this order from one generator, whatever the mesh
    return {
        "embed": keep("['embed']", norm_init((v, h), scale=0.02)),
        "blocks": {
            "wq": block("wq", norm_init((L, h, h))),
            "wk": block("wk", norm_init((L, h, kvh))),
            "wv": block("wv", norm_init((L, h, kvh))),
            "wo": block("wo", norm_init((L, h, h))),
            "w_gate": block("w_gate", norm_init((L, h, i))),
            "w_up": block("w_up", norm_init((L, h, i))),
            "w_down": block("w_down", norm_init((L, i, h))),
            "ln_attn": block("ln_attn", ones(L, h)),
            "ln_mlp": block("ln_mlp", ones(L, h)),
        },
        "final_norm": keep("['final_norm']", ones(h)),
        "lm_head": keep("['lm_head']", norm_init((h, v))),
    }


def leaves(params) -> Dict[str, torch.Tensor]:
    """{"['blocks']['wq']": tensor, ...}: the leaves under the TPU
    package's jax.tree_util.keystr names, in its (sorted-key) order."""
    out = {}

    def walk(tree, prefix):
        for key in sorted(tree):
            sub = tree[key]
            name = f"{prefix}['{key}']"
            if isinstance(sub, dict):
                walk(sub, name)
            else:
                out[name] = sub
    walk(params, "")
    return out


def num_params(params) -> int:
    return sum(t.numel() for t in leaves(params).values())


def param_specs(config: LlamaConfig) -> Dict[str, Any]:
    """Each leaf's split over the mesh axes (llama.py:426-449), a tuple of
    one axis name or None a dimension: the stack axis on 'pp', the head and
    FFN dimension on 'mp', the other large one on 'sharding' (FSDP), the
    embedding's vocabulary on 'mp'; the norm weights replicated."""
    fsdp = "sharding"
    col, row = ("pp", fsdp, "mp"), ("pp", "mp", fsdp)
    return {
        "embed": ("mp", None),
        "blocks": {"wq": col, "wk": col, "wv": col, "wo": row,
                   "w_gate": col, "w_up": col, "w_down": row,
                   "ln_attn": ("pp", None), "ln_mlp": ("pp", None)},
        "final_norm": (None,),
        "lm_head": (fsdp, "mp"),
    }


def shard_leaf(t: torch.Tensor, spec, layout) -> torch.Tensor:
    """This rank's piece of the full leaf ``t`` under ``spec`` (a tuple of
    axis names or None, one a dimension); ``layout`` (a
    distributed.topology.RankLayout, as ``rank_layout`` gives it) holds
    each axis's degree and this rank's coordinate on it."""
    for dim, axis in enumerate(spec):
        n = layout.degrees[axis] if axis else 1
        if n > 1:
            if t.shape[dim] % n:
                raise ValueError(f"dimension {dim} of a {tuple(t.shape)} "
                                 f"leaf does not split over {axis}={n}")
            t = t.chunk(n, dim=dim)[layout.coords[axis]]
    return t.contiguous()


class _Par:
    """The stacked core's collectives over one rank's shards: Megatron's
    tensor parallelism over 'mp', FSDP gathers over 'sharding'
    (distributed/fleet/layers/mpu/mp_ops.py,
    distributed/meta_parallel/sharding_optimizer.py) and ring attention
    over 'sep'. With a hybrid group of one rank each collective runs over
    its one-rank group."""

    def __init__(self, hcg, config: LlamaConfig):
        from ..distributed.fleet.layers.mpu import mp_ops

        self.ops, self.gather_leaf = mp_ops, mp_ops.gather_leaf
        self.mp = hcg.get_model_parallel_group()
        self.sharding = hcg.get_sharding_parallel_group()
        self.mp_size = hcg.get_model_parallel_world_size()
        self.mp_rank = hcg.get_model_parallel_rank()
        self.sep = hcg.get_sep_parallel_group()
        self.sep_size = hcg.get_sep_parallel_world_size()
        self.sep_rank = hcg.get_sep_parallel_rank()
        specs = param_specs(config)["blocks"]
        # the dimension of a layer's leaf that 'sharding' splits
        self.block_dims = {k: v.index("sharding") - 1
                           for k, v in specs.items() if "sharding" in v}

    def gather_block(self, p):
        """A layer's leaves whole over 'sharding' (still split on 'mp')."""
        return {k: (self.gather_leaf(v, self.sharding, self.block_dims[k])
                    if k in self.block_dims else v) for k, v in p.items()}

    def enter(self, x):
        """Identity forward; the gradient summed over 'mp'."""
        return self.ops._CIdentity.apply(x, self.mp)

    def reduce(self, x):
        """The partial products summed over 'mp'."""
        return self.ops._MpAllreduce.apply(x, self.mp)

    def embed(self, table, ids):
        """The vocab-parallel lookup: this rank's rows, zeros elsewhere,
        summed over 'mp' (indexed as ``_trunk`` indexes the whole table,
        so that its gradient sums in the same order)."""
        per = table.shape[0]
        local = ids - self.mp_rank * per
        outside = (local < 0) | (local >= per)
        x = table[local.masked_fill(outside, 0)]
        return self.reduce(x.masked_fill(outside[..., None], 0))

    def head_loss(self, params, h, labels, config: LlamaConfig):
        """_head_loss over vocab-sharded logits (the stop-gradient max, the
        sum of exponentials and the picked logit reduced over 'mp')."""
        h = self.enter(rn.rms_norm(h, params["final_norm"],
                                   config.rms_norm_eps))
        w = self.gather_leaf(params["lm_head"], self.sharding, 0)
        return self.ops.vocab_parallel_nll(h.float() @ w.float(), labels,
                                           self.mp, self.mp_rank).mean()


def _rope(q, k, theta, offset: int = 0):
    """Rotary embedding on rotating halves (llama.py:452-468), at positions
    ``offset`` to ``offset`` + S - 1 (a sep rank's shard of the sequence
    starts at its global position)."""
    _, s, _, hd = q.shape
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                        device=q.device) / hd))
    pos = torch.arange(offset, offset + s, dtype=torch.float32,
                       device=q.device)
    freqs = torch.outer(pos, inv)
    emb = torch.cat([freqs, freqs], dim=-1)
    cos = emb.cos()[None, :, None, :]
    sin = emb.sin()[None, :, None, :]

    def rot(t):
        d2 = t.shape[-1] // 2
        rotated = torch.cat([-t[..., d2:], t[..., :d2]], dim=-1)
        return (t.float() * cos + rotated.float() * sin).to(t.dtype)

    return rot(q), rot(k)


def _qkv(p, x, config: LlamaConfig, par: Optional[_Par] = None):
    """RMSNorm -> q, k, v projections -> RoPE -> GQA repeat, [B, S, H, D]
    (H/mp heads a rank over a mesh; over 'sep', S is the rank's shard and
    RoPE rotates it at its global positions)."""
    tp = par.mp_size if par is not None else 1
    nh, kvh, hd = (config.num_attention_heads // tp,
                   config.num_key_value_heads // tp, config.head_dim)
    b, s, _ = x.shape
    hx = rn.rms_norm(x, p["ln_attn"], config.rms_norm_eps)
    if par is not None:
        hx = par.enter(hx)
    q = (hx @ p["wq"]).reshape(b, s, nh, hd)
    k = (hx @ p["wk"]).reshape(b, s, kvh, hd)
    v = (hx @ p["wv"]).reshape(b, s, kvh, hd)
    q, k = _rope(q, k, config.rope_theta,
                 par.sep_rank * s if par is not None else 0)
    if nh != kvh:
        rep = nh // kvh
        k = k.repeat_interleave(rep, dim=2)       # jnp.repeat(k, rep, 2)
        v = v.repeat_interleave(rep, dim=2)
    return q, k, v


def _after_attn(p, x, attn, config: LlamaConfig,
                par: Optional[_Par] = None):
    """Output projection + residual, then the swiglu MLP + residual (the
    row-parallel products summed over 'mp' over a mesh)."""
    b, s, _ = x.shape
    out = attn.reshape(b, s, -1) @ p["wo"]
    x = x + (out if par is None else par.reduce(out))
    hx = rn.rms_norm(x, p["ln_mlp"], config.rms_norm_eps)
    if par is not None:
        hx = par.enter(hx)
    gated = torch.nn.functional.silu(hx @ p["w_gate"]) * (hx @ p["w_up"])
    out = gated @ p["w_down"]
    return x + (out if par is None else par.reduce(out))


def _block(p, x, config: LlamaConfig, par: Optional[_Par] = None):
    """One decoder block (llama.py:471-518); over a mesh its leaves are
    gathered over 'sharding' first (inside the remat'd region, so the
    recomputation gathers them again), and over 'sep' attention is the
    ring over the sep group."""
    if par is not None:
        p = par.gather_block(p)
    q, k, v = _qkv(p, x, config, par)
    if par is not None and par.sep_size > 1:
        attn = ra.ring_attention_bshd(q, k, v, par.sep, is_causal=True)
    else:
        attn = fa.flash_attention_bshd(q, k, v, is_causal=True)
    return _after_attn(p, x, attn, config, par)


class _SavedAttention(torch.autograd.Function):
    """The attention half of a block under remat_policy="save_attn": RMSNorm,
    the q, k, v projections, RoPE and causal flash attention (over 'sep'
    the ring). It keeps what the reference's
    ``save_only_these_names("flash_attn_out")`` (llama.py:534-540) keeps,
    the attention output O (and its LSE, which the flash backward needs
    beside it), and its inputs, which the block keeps anyway: over a mesh
    the weights' shards, not their FSDP-gathered whole, which the backward
    gathers again (as the reference frees the gathered weights between the
    forward and the backward). q, k and v are recomputed in the backward
    and fed to the flash backward (the ring's backward over 'sep') with the
    saved O and LSE; the gathered weights' gradients are reduce-scattered
    back to the shards. The numbers are those of ``_block``'s attention."""

    @staticmethod
    def forward(ctx, x, ln_attn, wq, wk, wv, config, par):
        p = {"ln_attn": ln_attn, **_gather_qkv(par, wq, wk, wv)}
        q, k, v = _qkv_bhsd(p, x, config, par)
        if _ring(par):
            o, lse = ra.ring_forward(q, k, v, par.sep, True)
        else:
            o, lse = fa.forward_with_lse(q, k, v, None, 0, True, 0.0)
        ctx.save_for_backward(x, ln_attn, wq, wk, wv, o, lse)
        ctx.config, ctx.par = config, par
        return o.transpose(1, 2)

    @staticmethod
    def backward(ctx, do):
        x, ln_attn, wq, wk, wv, o, lse = ctx.saved_tensors
        par = ctx.par
        full = _gather_qkv(par, wq, wk, wv)
        inputs = [t.detach().requires_grad_(need) for t, need in
                  zip((x, ln_attn, full["wq"], full["wk"], full["wv"]),
                      ctx.needs_input_grad)]
        with torch.enable_grad():
            p = dict(zip(("ln_attn", "wq", "wk", "wv"), inputs[1:]))
            q, k, v = _qkv_bhsd(p, inputs[0], ctx.config, par)
        do = do.transpose(1, 2)
        qkv = (q.detach(), k.detach(), v.detach())
        if _ring(par):
            dq, dk, dv = ra.ring_backward(*qkv, o, lse, do, par.sep, True)
        else:
            dq, dk, dv = fa.backward(*qkv, None, 0, o, lse, do, True, 0.0)
        wanted = [t for t in inputs if t.requires_grad]
        grads = iter(torch.autograd.grad((q, k, v), wanted, (dq, dk, dv)))
        out = [next(grads) if t.requires_grad else None for t in inputs]
        if par is not None:
            from ..distributed.fleet.layers.mpu.mp_ops import \
                reduce_scatter_along

            for i, key in enumerate(("wq", "wk", "wv"), start=2):
                if out[i] is not None:
                    out[i] = reduce_scatter_along(out[i], par.sharding,
                                                  par.block_dims[key])
        return tuple(out) + (None, None)


def _ring(par):
    """Whether attention runs as the ring over a sep group of processes."""
    return par is not None and par.sep_size > 1 and \
        par.sep.process_group is not None


def _gather_qkv(par, wq, wk, wv):
    """The q, k, v weights whole over 'sharding' (no autograd record: the
    saved-attention Function reduce-scatters their gradients itself)."""
    w = {"wq": wq, "wk": wk, "wv": wv}
    if par is None:
        return w
    from ..distributed.fleet.layers.mpu.mp_ops import gather_along

    return {k: gather_along(t.detach(), par.sharding, par.block_dims[k])
            for k, t in w.items()}


def _qkv_bhsd(p, x, config: LlamaConfig, par: Optional[_Par] = None):
    """``_qkv`` in the flash kernels' layout: [B, H, S, D] views, as
    ``flash_attention_bshd`` makes them."""
    return tuple(t.transpose(1, 2) for t in _qkv(p, x, config, par))


_MLP_KEYS = ("wo", "ln_mlp", "w_gate", "w_up", "w_down")


def _after_attn_gathered(p, x, attn, config: LlamaConfig,
                         par: Optional[_Par] = None):
    """``_after_attn`` with the rest of the block's leaves gathered over
    'sharding' first (inside the checkpointed region)."""
    if par is not None:
        p = par.gather_block(p)
    return _after_attn(p, x, attn, config, par)


def _block_save_attn(p, x, config: LlamaConfig, par: Optional[_Par] = None):
    """remat_policy="save_attn": the attention half keeps only its output
    O and LSE (``_SavedAttention``), and the rest of the block is
    checkpointed, so the attention forward is not run again."""
    attn = _SavedAttention.apply(x, p["ln_attn"], p["wq"], p["wk"], p["wv"],
                                 config, par)
    rest = {k: p[k] for k in _MLP_KEYS}
    return checkpoint(_after_attn_gathered, rest, x, attn, config, par,
                      use_reentrant=False)


def _check_mesh(mesh, hcg=None):
    """A mesh whose 'sep' axis splits the sequence runs over a hybrid group
    of that sep degree, whose sep group carries the ring: without one
    (``hcg`` None, or another degree) it raises ValueError."""
    if mesh is None:
        return
    sep = dict(getattr(mesh, "shape", mesh)).get("sep", 1)
    have = None if hcg is None else hcg.get_sep_parallel_world_size()
    if sep > 1 and have != sep:
        raise ValueError(
            f"a mesh with sep={sep} splits each sequence over {sep} ranks: "
            f"pass the hybrid group of that mesh (hcg=), which runs the "
            f"ring attention; got "
            + ("no hybrid group" if hcg is None else f"one of sep={have}"))


def _trunk(params, input_ids, config: LlamaConfig, remat: bool = True,
           par: Optional[_Par] = None):
    """Embedding -> the blocks in order (llama.py:521-544); with ``par``
    (a hybrid group's collectives), on this rank's shards."""
    x = params["embed"][input_ids] if par is None else \
        par.embed(params["embed"], input_ids)
    if config.dtype == "bfloat16":
        x = x.to(torch.bfloat16)
    return _blocks(params["blocks"], x, config, remat, par)


def _blocks(blocks, x, config: LlamaConfig, remat: bool = True,
            par: Optional[_Par] = None, policy: Optional[str] = None):
    """The stacked layers of ``blocks`` in order over ``x``, remat'd under
    ``policy`` (the config's remat_policy when None)."""
    # unbind once: its backward stacks the layers' gradients in one op
    per_layer = zip(*(blocks[key].unbind(0) for key in _BLOCK_KEYS))
    remat = remat and torch.is_grad_enabled()
    policy = policy or config.remat_policy
    for vals in per_layer:
        p = dict(zip(_BLOCK_KEYS, vals))
        if not remat:
            x = _block(p, x, config, par)
        elif policy == "save_attn":
            x = _block_save_attn(p, x, config, par)
        else:
            x = checkpoint(_block, p, x, config, par, use_reentrant=False)
    return x


def forward_stacked(params, input_ids, config: LlamaConfig,
                    remat: bool = True):
    """Whole-model forward: trunk -> final norm -> f32 logits
    (llama.py:547-553)."""
    x = _trunk(params, input_ids, config, remat)
    x = rn.rms_norm(x, params["final_norm"], config.rms_norm_eps)
    return x.float() @ params["lm_head"].float()


def _head_loss(params, h, labels, config: LlamaConfig):
    """Final norm -> LM head -> mean next-token NLL as lse - picked, the
    max under a stop-gradient (llama.py:556-567)."""
    h = rn.rms_norm(h, params["final_norm"], config.rms_norm_eps)
    logits = h.float() @ params["lm_head"].float()
    m = logits.amax(dim=-1, keepdim=True).detach()
    lse = m[..., 0] + torch.log(torch.exp(logits - m).sum(dim=-1))
    picked = logits.gather(-1, labels[..., None].long())[..., 0]
    return (lse - picked).mean()


def loss_fn_stacked(params, batch, config: LlamaConfig, remat: bool = True,
                    mesh=None, hcg=None):
    """Next-token LM loss; batch = (input_ids [B, S], labels [B, S])
    (llama.py:570-576). With a hybrid group ``hcg``, ``params`` are this
    rank's shards, ``batch`` its rows (over 'sep', its shard of each
    sequence, labels beside their tokens), and the loss the mean over its
    tokens. A ``mesh`` with a 'sep' axis > 1 needs the ``hcg`` of that
    mesh (ValueError otherwise)."""
    input_ids, labels = batch
    _check_mesh(mesh, hcg)
    par = None if hcg is None else _Par(hcg, config)
    x = _trunk(params, input_ids, config, remat, par=par)
    if par is not None:
        return par.head_loss(params, x, labels, config)
    return _head_loss(params, x, labels, config)


def microbatch_spec():
    """The split of a micro-batched tensor [n_micro, mb, S] over the mesh
    (llama.py:579-583): the micro-batch axis whole (the pipeline's time
    axis), the batch over the data axes, the sequence over 'sep'."""
    return (None, ("dp", "sharding"), "sep")


class _LastStageLoss(torch.autograd.Function):
    """The last pp stage's loss on every rank of the pp group (a broadcast
    forward); the backward gives each rank's own loss the gradient, so
    that every stage's hops run (spmd_pipeline)."""

    @staticmethod
    def forward(ctx, local, group):
        from ..distributed import collective

        out = local.detach().float().contiguous().clone()
        if group is not None and group.process_group is not None:
            collective.broadcast(out, src=group.ranks[-1], group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def loss_fn_pipelined(params, batch, config: LlamaConfig, mesh=None,
                      remat: bool = True, overlap_sends: bool = False,
                      hcg=None):
    """The pipelined next-token loss over the 'pp' axis (llama.py:586-640);
    every rank of the mesh calls it with its shards and its rows.

    batch = (input_ids [n_micro, mb, S], labels [n_micro, mb, S]). The
    embedding runs on the first stage; the blocks of this rank's
    num_hidden_layers / pp layers run through ``spmd_pipeline`` (a GPipe
    ring of n_micro + pp - 1 ticks, each hop a send to the next stage and a
    receive from the previous one; ``overlap_sends`` half-splits each
    tick's micro-batch so that the first half's send runs behind the
    second half's compute); the final norm, the LM head and the loss
    (``_Par.head_loss``) run on the last stage, whose loss every rank
    returns. The embedding's and the head's gradients therefore exist on
    one stage only: HybridTrainer sums them over the pp group, with zeros
    elsewhere, so that the replicas stay equal (the TPU package runs the
    head on every pp device after a psum of the last stage's outputs,
    which costs an all-reduce of the activations and the head on every
    stage)."""
    from ..distributed.meta_parallel.pipeline_parallel import spmd_pipeline

    if hcg is None:
        raise ValueError("loss_fn_pipelined runs over a hybrid group (hcg)")
    _check_mesh(mesh, hcg)
    input_ids, labels = batch
    n_micro, mb, s = input_ids.shape
    par = _Par(hcg, config)
    group = hcg.get_pipe_parallel_group()
    p, stage = hcg.get_pipe_parallel_world_size(), hcg.get_stage_id()
    dtype = _torch_dtype(config.dtype)
    if stage == 0:
        x = par.embed(params["embed"], input_ids).to(dtype)
    else:
        x = torch.empty((n_micro, mb, s, config.hidden_size), dtype=dtype,
                        device="meta")

    def stage_fn(blocks, h):
        # the reference's stage function recomputes whole blocks whatever
        # the remat_policy (llama.py:612-620)
        return _blocks(blocks, h, config, remat, par, policy="full")

    ys = spmd_pipeline(stage_fn, params["blocks"], x, n_micro,
                       overlap_sends=overlap_sends, group=hcg)
    if stage == p - 1:
        local = par.head_loss(params, ys, labels, config)
    else:
        local = ys.sum().float()      # zero: ties in this stage's hops
    return _LastStageLoss.apply(local, group if p > 1 else None)


# ---------------------------------------------------------------------------
# the eager nn.Layer model (llama.py:129-385)
# ---------------------------------------------------------------------------

def _mp_degree():
    """The hybrid group's (fleet.init) model-parallel degree, 1 without
    one (llama.py:118-122): above 1 the eager model builds the
    tensor-parallel layers, each rank holding its shard."""
    from ..distributed.topology import get_hybrid_communicate_group

    hcg = get_hybrid_communicate_group()
    return 1 if hcg is None else hcg.get_model_parallel_world_size()


class LlamaAttention(nn.Layer):
    def __init__(self, config: LlamaConfig):
        super().__init__()
        self.config = config
        h = config.hidden_size
        kvh = config.num_key_value_heads * config.head_dim
        # under mp, each rank holds the columns of its H/mp heads
        self.mp = _mp_degree()
        if self.mp > 1:
            from ..distributed.meta_parallel import (ColumnParallelLinear,
                                                     RowParallelLinear)

            self.q_proj = ColumnParallelLinear(h, h, has_bias=False,
                                               gather_output=False)
            self.k_proj = ColumnParallelLinear(h, kvh, has_bias=False,
                                               gather_output=False)
            self.v_proj = ColumnParallelLinear(h, kvh, has_bias=False,
                                               gather_output=False)
            self.o_proj = RowParallelLinear(h, h, has_bias=False,
                                            input_is_parallel=True)
        else:
            self.q_proj = nn.Linear(h, h, bias_attr=False)
            self.k_proj = nn.Linear(h, kvh, bias_attr=False)
            self.v_proj = nn.Linear(h, kvh, bias_attr=False)
            self.o_proj = nn.Linear(h, h, bias_attr=False)

    def forward(self, x, kv_cache=None, position_offset=0):
        cfg = self.config
        b, s = x.shape[0], x.shape[1]
        nh, kvh = (cfg.num_attention_heads // self.mp,
                   cfg.num_key_value_heads // self.mp)
        q = self.q_proj(x).reshape([b, s, nh, cfg.head_dim])
        k = self.k_proj(x).reshape([b, s, kvh, cfg.head_dim])
        v = self.v_proj(x).reshape([b, s, kvh, cfg.head_dim])
        prev_len = int(kv_cache[0].shape[1]) if kv_cache is not None \
            else 0
        # RoPE at absolute positions: a decode chunk after prev_len
        # cached tokens rotates at prev_len .. prev_len + s - 1
        pos_ids = None
        if prev_len or position_offset:
            pos_ids = Tensor._wrap(torch.arange(
                prev_len + position_offset,
                prev_len + position_offset + s,
                device=x._value.device).reshape(1, s))
        q, k, _ = IF.fused_rotary_position_embedding(
            q, k, None, position_ids=pos_ids,
            rotary_emb_base=cfg.rope_theta)
        new_cache = None
        if kv_cache is not None:
            k = manipulation.concat([kv_cache[0], k], axis=1)
            v = manipulation.concat([kv_cache[1], v], axis=1)
            new_cache = (k, v)
        rep = cfg.num_attention_heads // cfg.num_key_value_heads
        if rep > 1:
            k = manipulation.repeat_interleave(k, rep, axis=2)
            v = manipulation.repeat_interleave(v, rep, axis=2)
        # causal whenever the query chunk spans more than one position;
        # a one-token decode step attends the whole prefix
        out = F.scaled_dot_product_attention(q, k, v, is_causal=s > 1)
        out = self.o_proj(out.reshape([b, s, nh * cfg.head_dim]))
        return (out, new_cache) if new_cache is not None else out


class LlamaMLP(nn.Layer):
    def __init__(self, config: LlamaConfig):
        super().__init__()
        h, i = config.hidden_size, config.intermediate_size
        if _mp_degree() > 1:
            from ..distributed.meta_parallel import (ColumnParallelLinear,
                                                     RowParallelLinear)

            self.gate_proj = ColumnParallelLinear(h, i, has_bias=False,
                                                  gather_output=False)
            self.up_proj = ColumnParallelLinear(h, i, has_bias=False,
                                                gather_output=False)
            self.down_proj = RowParallelLinear(i, h, has_bias=False,
                                               input_is_parallel=True)
        else:
            self.gate_proj = nn.Linear(h, i, bias_attr=False)
            self.up_proj = nn.Linear(h, i, bias_attr=False)
            self.down_proj = nn.Linear(i, h, bias_attr=False)

    def forward(self, x):
        return self.down_proj(IF.swiglu(self.gate_proj(x),
                                        self.up_proj(x)))


class LlamaDecoderLayer(nn.Layer):
    def __init__(self, config: LlamaConfig):
        super().__init__()
        self.self_attn = LlamaAttention(config)
        self.mlp = LlamaMLP(config)
        self.input_layernorm = nn.RMSNorm(config.hidden_size,
                                          epsilon=config.rms_norm_eps)
        self.post_attention_layernorm = nn.RMSNorm(
            config.hidden_size, epsilon=config.rms_norm_eps)
        self._recompute = config.recompute

    def _block(self, h):
        h = h + self.self_attn(self.input_layernorm(h))
        return h + self.mlp(self.post_attention_layernorm(h))

    def forward(self, x, kv_cache=None):
        if kv_cache is not None:
            a, new_cache = self.self_attn(self.input_layernorm(x),
                                          kv_cache)
            x = x + a
            x = x + self.mlp(self.post_attention_layernorm(x))
            return x, new_cache
        if self._recompute and self.training:
            from ..distributed.fleet.recompute import recompute

            return recompute(self._block, x)
        return self._block(x)


class LlamaModel(nn.Layer):
    def __init__(self, config: LlamaConfig):
        super().__init__()
        self.config = config
        if _mp_degree() > 1:
            from ..distributed.meta_parallel import VocabParallelEmbedding

            self.embed_tokens = VocabParallelEmbedding(config.vocab_size,
                                                       config.hidden_size)
        else:
            self.embed_tokens = nn.Embedding(config.vocab_size,
                                             config.hidden_size)
        self.layers = nn.LayerList(
            [LlamaDecoderLayer(config)
             for _ in range(config.num_hidden_layers)])
        self.norm = nn.RMSNorm(config.hidden_size,
                               epsilon=config.rms_norm_eps)

    def forward(self, input_ids, kv_caches=None):
        x = self.embed_tokens(input_ids)
        if self.config.dtype == "bfloat16":
            x = x.astype("bfloat16")
        new_caches = [] if kv_caches is not None else None
        for i, layer in enumerate(self.layers):
            if kv_caches is not None:
                x, c = layer(x, kv_caches[i])
                new_caches.append(c)
            else:
                x = layer(x)
        x = self.norm(x)
        return (x, new_caches) if kv_caches is not None else x


class LlamaForCausalLM(nn.Layer):
    def __init__(self, config: LlamaConfig):
        super().__init__()
        self.config = config
        self.model = LlamaModel(config)
        # the LM head stays a replicated Linear under mp (llama.py:291-293)
        self.lm_head = None if config.tie_word_embeddings else \
            nn.Linear(config.hidden_size, config.vocab_size,
                      bias_attr=False)

    def forward(self, input_ids, labels=None, kv_caches=None):
        """Logits [B, S, vocab] in f32 (bf16 under AMP O1: the head is
        a white-listed linear), or with ``labels`` the mean next-token
        cross entropy, or with ``kv_caches`` (logits, new caches)."""
        new_caches = None
        if kv_caches is not None:
            h, new_caches = self.model(input_ids, kv_caches)
        else:
            h = self.model(input_ids)
        if self.lm_head is not None:
            logits = self.lm_head(h.astype("float32"))
        elif getattr(self.model.embed_tokens, "world_size", 1) > 1:
            return self._tied_vocab_parallel(h, labels, kv_caches,
                                             new_caches)
        else:
            from ..ops.linalg import matmul

            logits = matmul(
                h.astype("float32"),
                self.model.embed_tokens.weight.astype("float32"),
                transpose_y=True)
        if labels is not None:
            return F.cross_entropy(
                logits.reshape([-1, self.config.vocab_size]),
                labels.reshape([-1]))
        if kv_caches is not None:
            return logits, new_caches
        return logits

    def _tied_vocab_parallel(self, h, labels, kv_caches, new_caches):
        """The head over the vocab-sharded table (tied embeddings under
        mp): each rank's logits against its rows of the table, in f32 as
        the reference's (llama.py:307), the hidden state's gradient summed
        over mp (``_c_identity``); with labels the mean of the port's
        vocab-parallel cross entropy, else the logits gathered. The
        table's gradient is the lookup's plus the head's (one Parameter)."""
        from ..core.dispatch import apply
        from ..distributed.fleet.layers.mpu import mp_ops

        emb = self.model.embed_tokens
        group, rank = emb.mp_group, emb.rank
        x = mp_ops._c_identity(h.astype("float32"), group)

        def head(a, w):
            return torch.matmul(a, w.float().t())

        logits = apply(head, x, emb.weight, op_name="matmul")
        if labels is None:
            logits = mp_ops._c_concat(logits, group)
            return (logits, new_caches) if kv_caches is not None \
                else logits

        def loss(lg, lab):
            per = mp_ops.vocab_parallel_nll(
                lg.reshape(-1, lg.shape[-1]), lab.reshape(-1), group, rank)
            valid = lab.reshape(-1) != -100
            per = torch.where(valid, per, torch.zeros_like(per))
            return per.sum() / torch.clamp(valid.float().sum(), min=1.0)
        return apply(loss, logits, labels, op_name="cross_entropy")

    @classmethod
    def from_preset(cls, name: str):
        import copy

        return cls(copy.deepcopy(LLAMA_PRESETS[name]))

    def generate(self, input_ids, max_new_tokens=32, eos_token_id=None):
        """Greedy decode with a KV cache: the prompt in one causal
        forward (the flash kernels at a kernel shape), then one token
        a step (Sq = 1: the dense fallback). Returns the prompt and the
        new tokens, [B, S + n]; stops early when every row emitted
        ``eos_token_id``."""
        with torch.no_grad():
            self.eval()
            cfg = self.config
            b = input_ids.shape[0]
            dev = self.model.embed_tokens.weight._value.device
            shape = (b, 0, cfg.num_key_value_heads, cfg.head_dim)
            empty = [(Tensor._wrap(torch.zeros(shape, device=dev)),
                      Tensor._wrap(torch.zeros(shape, device=dev)))
                     for _ in range(cfg.num_hidden_layers)]
            logits, caches = self.forward(input_ids, kv_caches=empty)
            out = input_ids
            cur = search.argmax(logits[:, -1], axis=-1).reshape([b, 1])
            for _ in range(max_new_tokens):
                out = manipulation.concat([out, cur], axis=1)
                if eos_token_id is not None and bool(
                        (cur == eos_token_id).all()):
                    break
                logits, caches = self.forward(cur, kv_caches=caches)
                cur = search.argmax(logits[:, -1],
                                    axis=-1).reshape([b, 1])
            return out

    def generate_static(self, *args, **kwargs):
        raise NotImplementedError(
            "paddle_tpu_torch: generate_static belongs to the compile "
            "tier (to_static), not ported yet; use generate")
