"""Mixture-of-Experts with expert parallelism
(paddle_tpu/incubate/distributed/models/moe/__init__.py).

The routing is the TPU package's: capacity-based top-k gating
(``top2_gating``'s dense one-hot masks, or ``topk_sort_dispatch``'s stable
sort of the (round, token) pairs by expert), a scatter of the kept pairs
into an [E, C, D] expert buffer, the experts as batched products, and a
gather back weighted by the gates. Its arithmetic follows the reference:
softmax in f32, capacity ``max(int(cf * S * k / E), 1)`` as Python
computes it, ties going to the lower expert index (a stable descending
sort, and ``argmax``'s first maximum), and ``moe_block_stacked``'s GELU in
``jax.nn.gelu``'s default, the tanh form (``MoELayer``'s default experts
use ``nn.GELU()``, the exact erf form, as the reference's do).

The reference is single-controller: ``moe_block_stacked`` routes the whole
global batch and GSPMD inserts the token <-> expert ``all_to_all`` when
w1 / w2 are sharded over an 'ep' axis. Here each rank is a process, so the
exchange is explicit (``moe_block_stacked(..., group=)``): every rank
all-gathers the router logits and runs the same routing over the global
batch (capacity over the global S, so drops do not depend on how the
tokens are split), sends each kept (token, k) pair of its rows to the rank
that owns its slot with one ``all_to_all_single`` in slot order, runs its
own experts, and gets the outputs back with the reverse exchange. The
split sizes come from the n x n count matrix, which every rank computes
from the routing it holds: one host sync a call.

``MoELayer`` follows the reference: its ``experts`` are the full list and
``group`` is accepted and unused (the expert-parallel path is
``moe_block_stacked``).
"""
from __future__ import annotations

import torch

from ..... import nn
from .....core.dispatch import apply

__all__ = ["MoELayer", "TopKGate", "top2_gating", "topk_sort_dispatch",
           "dispatch_to_experts", "combine_from_experts",
           "moe_block_stacked", "moe_params_from_paddle_tpu"]


def _capacity(capacity_factor, s, top_k, e):
    """The reference's expert capacity, computed as Python computes it."""
    return max(int(capacity_factor * s * top_k / e), 1)


def _aux_loss(probs):
    """The Switch-style load-balancing loss: E * sum(mean probability x
    share of tokens whose first choice is the expert)."""
    e = probs.shape[-1]
    me = probs.mean(dim=0)
    first = torch.nn.functional.one_hot(probs.argmax(dim=-1), e)
    ce = first.to(torch.float32).mean(dim=0)
    return (me * ce).sum() * e


def top2_gating(logits, capacity_factor=1.5, top_k=2):
    """(dispatch [S, E, C], combine [S, E, C], aux_loss): the dense
    one-hot routing, round by round (moe/__init__.py:32-67)."""
    s, e = logits.shape
    capacity = _capacity(capacity_factor, s, top_k, e)
    probs = torch.softmax(logits.float(), dim=-1)
    dev = probs.device
    dispatch = torch.zeros((s, e, capacity), dtype=torch.float32, device=dev)
    combine = torch.zeros_like(dispatch)
    remaining = probs
    fill = torch.zeros(e, dtype=torch.int64, device=dev)
    for _ in range(top_k):
        idx = remaining.argmax(dim=-1)            # the first maximum
        gate = remaining.gather(1, idx[:, None])[:, 0]
        onehot = torch.nn.functional.one_hot(idx, e).float()
        pos_in_e = (onehot.cumsum(dim=0) - 1.0) * onehot
        pos = pos_in_e.sum(dim=-1).long() + fill[idx]
        keep = pos < capacity
        gate = gate * keep
        pos_oh = torch.nn.functional.one_hot(
            pos.clamp(0, capacity - 1), capacity).float()
        contrib = onehot[:, :, None] * pos_oh[:, None, :] \
            * keep[:, None, None]
        dispatch = dispatch + contrib
        combine = combine + contrib * gate[:, None, None]
        fill = fill + (onehot * keep[:, None]).sum(dim=0).long()
        remaining = remaining * (1.0 - onehot)
    return dispatch, combine, _aux_loss(probs)


def topk_sort_dispatch(logits, capacity_factor=1.5, top_k=2):
    """Count-based routing (moe/__init__.py:70-104): the (round, token)
    pairs sorted stably by expert, each pair's rank in its expert from the
    counts' prefix, pairs beyond capacity dropped.

    Returns (slot [S, K] int32 into the [E*C] expert buffer, -1 for a
    dropped pair; gate [S, K] f32, 0 where dropped; capacity; aux_loss)."""
    s, e = logits.shape
    k = top_k
    capacity = _capacity(capacity_factor, s, k, e)
    probs = torch.softmax(logits.float(), dim=-1)
    # lax.top_k: the k largest, a tie to the lower index
    vals, order_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, exp_idx = vals[:, :k], order_e[:, :k]
    # priority order = (round, token): round-major flatten + stable sort
    flat_e = exp_idx.t().reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    counts = torch.zeros(e, dtype=torch.int64, device=logits.device) \
        .scatter_add_(0, flat_e, torch.ones_like(flat_e))
    starts = counts.cumsum(dim=0) - counts
    sorted_rank = torch.arange(s * k, device=logits.device) \
        - starts[flat_e[order]]
    rank = torch.empty_like(sorted_rank).scatter_(0, order, sorted_rank)
    keep = rank < capacity
    slot = torch.where(keep, flat_e * capacity + rank,
                       torch.full_like(rank, -1))
    slot = slot.reshape(k, s).t().to(torch.int32)
    gate = gate * (slot >= 0)
    return slot, gate, capacity, _aux_loss(probs)


def dispatch_to_experts(x, slot, num_experts, capacity):
    """x [S, D], slot [S, K] -> the expert buffer [E, C, D]; a dropped pair
    lands on an overflow row that is discarded."""
    s, d = x.shape
    k = slot.shape[1]
    xk = x[:, None].expand(s, k, d).reshape(s * k, d)
    flat = slot.reshape(-1).long()
    safe = torch.where(flat >= 0, flat,
                       torch.full_like(flat, num_experts * capacity))
    buf = x.new_zeros((num_experts * capacity + 1, d)).index_put(
        (safe,), xk)
    return buf[:-1].reshape(num_experts, capacity, d)


def _weighted_pairs(vals, w):
    """sum_k vals[s, k, :] * w[s, k] (the reference's einsum
    "skd,sk->sd")."""
    return torch.einsum("skd,sk->sd", vals, w)


def combine_from_experts(expert_out, slot, gate):
    """expert_out [E, C, D], slot [S, K], gate [S, K] -> [S, D]."""
    e, c, d = expert_out.shape
    s, k = slot.shape
    flat = slot.reshape(-1).long()
    safe = torch.where(flat >= 0, flat, torch.zeros_like(flat))
    vals = expert_out.reshape(e * c, d)[safe].reshape(s, k, d)
    w = (gate * (slot >= 0)).to(vals.dtype)
    return _weighted_pairs(vals, w)


def _experts(buf, w1, w2):
    """The reference's expert, GELU (tanh form) between w1 and w2, on each
    expert's [C, D] rows: [E, C, D] -> [E, C, D]."""
    h = torch.nn.functional.gelu(torch.bmm(buf, w1.to(buf.dtype)),
                                 approximate="tanh")
    return torch.bmm(h, w2.to(buf.dtype))


def _route(slot, rank, n, rows_a_rank, slots_a_rank):
    """The exchange's plan, the same on every rank: the n x n counts of
    kept pairs from each rank to each expert owner (read to the host: the
    call's one sync); this rank's kept pairs in slot order (indices into
    its rows x K), and the local buffer rows of the pairs it receives, by
    source rank then slot (the order they arrive in)."""
    s, k = slot.shape
    flat = slot.reshape(-1).long()
    kept = flat >= 0
    dev = flat.device
    big = n * slots_a_rank
    src = torch.arange(s * k, device=dev) // (rows_a_rank * k)
    dst = torch.where(kept, flat // slots_a_rank, torch.zeros_like(flat))
    counts = torch.zeros(n * n, dtype=torch.int64, device=dev).scatter_add_(
        0, src * n + dst, kept.long()).reshape(n, n).tolist()
    send = counts[rank]
    recv = [counts[p][rank] for p in range(n)]
    mine = flat[rank * rows_a_rank * k:(rank + 1) * rows_a_rank * k]
    sent = torch.argsort(torch.where(mine >= 0, mine,
                                     torch.full_like(mine, big)),
                         stable=True)[:sum(send)]
    lo = rank * slots_a_rank
    here = (flat >= lo) & (flat < lo + slots_a_rank)
    key = torch.where(here, src * big + flat, torch.full_like(flat, n * big))
    arrive = torch.argsort(key, stable=True)[:sum(recv)]
    return send, recv, sent, flat[arrive] - lo


def moe_block_stacked(params, x, top_k=2, capacity_factor=1.5, group=None):
    """The functional MoE block (moe/__init__.py:202-221): params = {wg
    [D, E], w1 [E, D, F], w2 [E, F, D]}, x [S, D]; returns (out [S, D] in
    x's dtype, aux_loss). The router, the experts and the combine run in
    f32, as the reference computes them.

    With ``group`` (n ranks; None, or a group of one, is the local block)
    rank r holds rows r·S/n:(r+1)·S/n of the global x, the whole ``wg``,
    and experts r·E/n:(r+1)·E/n of w1 and w2 (``moe_params_from_paddle_tpu``
    slices them); E that n does not divide raises ValueError. The result
    is the reference's function of the global batch: this rank's rows of
    its output, and its aux loss (the same on every rank). The logits are
    all-gathered in f32 (their gradient summed back to their rank), the
    routing runs on the global logits on every rank, each kept pair goes
    to its expert's owner and its output comes back, each exchange one
    ``all_to_all_single`` over the group whose backward is the reverse one.

    The loss contract: with each rank's loss written so that the losses
    summed over the group are the reference's loss on the global batch
    (its rows' share of a mean over the global tokens, and the aux term
    divided by n, since every rank returns the global aux), each rank's
    gradients of its own experts are the reference's slices, and the
    ``wg`` gradients summed over the group are the reference's."""
    wg = params["wg"]
    e = wg.shape[1]
    n = 1 if group is None or group.process_group is None else group.nranks
    if n == 1:
        logits = x.float() @ wg.float()
        slot, gate, capacity, aux = topk_sort_dispatch(
            logits, capacity_factor, top_k)
        expert_in = dispatch_to_experts(x.float(), slot, e, capacity)
        out = combine_from_experts(
            _experts(expert_in, params["w1"], params["w2"]), slot, gate)
        return out.to(x.dtype), aux
    from .....distributed.fleet.layers.mpu.mp_ops import gather_leaf
    from .....distributed.utils import exchange

    if e % n:
        raise ValueError(f"moe_block_stacked: {e} experts do not split "
                         f"over the group's {n} ranks")
    e_local = e // n
    if params["w1"].shape[0] != e_local:
        raise ValueError(f"moe_block_stacked: w1 holds "
                         f"{params['w1'].shape[0]} experts; a rank of {n} "
                         f"holds {e_local} of {e}")
    rows, d = x.shape
    r = group.rank
    logits = gather_leaf(x.float() @ wg.float(), group, 0)
    slot, gate, capacity, aux = topk_sort_dispatch(logits, capacity_factor,
                                                   top_k)
    send, recv, sent, local = _route(slot, r, n, rows, e_local * capacity)
    arrived = exchange(x.float()[sent // top_k], send, recv, group)
    buf = x.new_zeros((e_local * capacity, d), dtype=torch.float32) \
        .index_put((local,), arrived).reshape(e_local, capacity, d)
    out_e = _experts(buf, params["w1"], params["w2"]).reshape(-1, d)
    back = exchange(out_e[local], recv, send, group)
    vals = back.new_zeros((rows * top_k, d)).index_put((sent,), back) \
        .reshape(rows, top_k, d)
    mine = slice(r * rows, (r + 1) * rows)
    w = (gate[mine] * (slot[mine] >= 0)).to(vals.dtype)
    return _weighted_pairs(vals, w).to(x.dtype), aux


def moe_params_from_paddle_tpu(params_np, rank=0, world=1):
    """The reference's ``moe_block_stacked`` params (a dict of numpy
    arrays: wg [D, E], w1 [E, D, F], w2 [E, F, D]) -> the port's dict of
    tensors for rank ``rank`` of an expert group of ``world`` ranks: the
    whole wg and this rank's E / world experts of w1 and w2."""
    from .....utils.convert import tensor_from_numpy

    e = params_np["wg"].shape[1]
    if e % world:
        raise ValueError(f"{e} experts do not split over {world} ranks")
    per = e // world
    out = {"wg": tensor_from_numpy(params_np["wg"])}
    for key in ("w1", "w2"):
        out[key] = tensor_from_numpy(
            params_np[key][rank * per:(rank + 1) * per])
    return out


class TopKGate(nn.Layer):
    def __init__(self, d_model, num_experts, top_k=2, capacity_factor=1.5):
        super().__init__()
        self.wg = nn.Linear(d_model, num_experts, bias_attr=False)
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        self.num_experts = num_experts

    def forward(self, x):
        return self.wg(x)


class MoELayer(nn.Layer):
    """The eager MoE layer (reference moe_layer.py:263): ``experts`` a
    LayerList of shape-alike per-expert FFNs (by default Linear(d, 4d),
    exact GELU, Linear(4d, d)); sort-based routing over the layer's
    tokens; ``aux_loss`` set by each forward. ``group`` is accepted and
    unused, as in the reference; ``moe_block_stacked(..., group=)`` is the
    expert-parallel path."""

    def __init__(self, d_model, experts=None, gate=None, num_experts=None,
                 top_k=2, capacity_factor=1.5, group=None,
                 recompute_interval=0):
        super().__init__()
        if experts is not None:
            self.experts = experts if isinstance(experts, nn.LayerList) \
                else nn.LayerList(list(experts))
            num_experts = len(self.experts)
        else:
            if not num_experts:
                raise ValueError("MoELayer: num_experts or experts required")
            self.experts = nn.LayerList([
                nn.Sequential(nn.Linear(d_model, 4 * d_model), nn.GELU(),
                              nn.Linear(4 * d_model, d_model))
                for _ in range(num_experts)])
        self.gate = gate or TopKGate(d_model, num_experts, top_k,
                                     capacity_factor)
        self.num_experts = num_experts
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        self.aux_loss = None

    def forward(self, x):
        from .....ops.manipulation import stack

        b, s, d = x.shape[0], x.shape[1], x.shape[2]
        flat = x.reshape([b * s, d])
        logits = self.gate(flat)
        e, k = self.num_experts, self.top_k
        capacity = _capacity(self.capacity_factor, b * s, k, e)

        def gating(lg):
            slot, gate, _, aux = topk_sort_dispatch(
                lg, self.capacity_factor, k)
            return slot, gate, aux

        slot, gate, aux = apply(gating, logits, op_name="moe_gate_sort")
        self.aux_loss = aux
        expert_in = apply(
            lambda xa, sl: dispatch_to_experts(xa, sl, e, capacity),
            flat, slot, op_name="moe_dispatch")
        outs = [expert(expert_in[i]) for i, expert in enumerate(self.experts)]
        out = apply(combine_from_experts, stack(outs, axis=0), slot, gate,
                    op_name="moe_combine")
        return out.astype(x.dtype).reshape([b, s, d])
