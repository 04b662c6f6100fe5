"""Ring attention: attention over a sequence split across the ranks of a
'sep' (context-parallel) group.

Replaces paddle_tpu/ops/pallas/ring_attention.py. That module reaches no
``pallas_call``: it computes each hop in f32 jnp inside a ``shard_map``
over 'sep' and rotates the K/V shards with ``ppermute``. Here each rank is
a process that holds its [B, H, S/n, D] shard of q, k and v, the K/V
shards go round the ring through NCCL (gloo for CPU tensors), and each
hop's attention runs through the hand-written flash kernels
(ops/kernels/flash_attention.py: ``forward_with_lse`` and ``backward``),
the plain versions on the CPU.

Hop h of rank ``idx`` attends its q to the K/V shard of rank
``src = (idx - h) mod n``. Under a causal mask the hop is

- the causal diagonal when ``src == idx`` (hop 0; the kernels' causal
  needs Sq == Sk, which equal shards give);
- a non-causal block when ``src < idx``;
- skipped when ``src > idx``: in the reference's merge a hop whose LSE is
  -inf has weight 0, so O and LSE stay as they were.

The hops' outputs merge in log-sum-exp space in f32 (``merge``, the
reference's ``_merge``), and O is cast to q's dtype at the end. The
backward (``_RingAttention.backward``) runs the flash backward kernels
each hop with the final O and LSE: they form P = exp(S - LSE) and
delta = rowsum(dO * O), which is the reference's ring VJP
(ring_attention.py:118-155). dQ accumulates in f32 on the rank; the f32
dK/dV accumulators ride the ring with their K/V shard and arrive home
after n hops.

Each hop posts one ``batch_isend_irecv`` over the sep group: the send to
the next rank and the receive from the previous one together, so that a
cyclic ring cannot deadlock on NCCL's per-communicator order. Every rank
posts every hop's exchange, skipped hops included. The forward posts hop
h+1's K/V before it launches hop h's kernels, so that the transfer can
run behind them; the backward sends on the K/V it holds before its
kernels, and with it the dK/dV accumulator the previous hop finished, so
that accumulators travel one hop behind their shard (one more exchange
after the last hop takes each home).

``compose_forward`` / ``compose_backward`` run the same hops for n
virtual ranks whose shards all lie on one device (no exchange).
"""
from __future__ import annotations

import torch

from . import flash_attention as fa

__all__ = ["ring_attention_bhsd", "ring_attention_bshd", "ring_forward",
           "ring_backward", "hop_causal", "hop_forward", "hop_backward",
           "merge", "compose_forward", "compose_backward"]


# ---------------------------------------------------------------------------
# one hop, and the merge
# ---------------------------------------------------------------------------

def hop_causal(idx: int, src: int, causal: bool):
    """The flash call's ``causal`` flag for rank ``idx`` attending the K/V
    shard of rank ``src``, or None where the hop is skipped (every key
    lies after every query)."""
    if causal and src > idx:
        return None
    return bool(causal and src == idx)


def hop_forward(q, k, v, idx: int, src: int, causal: bool):
    """(O in q's dtype, LSE [B, H, Sq] f32) of q against one K/V shard, or
    None for a skipped hop: the flash forward kernel on a card, its plain
    version on the CPU (the flash module's routing)."""
    c = hop_causal(idx, src, causal)
    if c is None:
        return None
    return fa.forward_with_lse(q, k, v, None, 0, c, 0.0)


def hop_backward(q, k, v, o, lse, do, idx: int, src: int, causal: bool):
    """(dQ, dK, dV) of one hop from the final O and LSE, or None for a
    skipped hop: the flash backward kernels on a card."""
    c = hop_causal(idx, src, causal)
    if c is None:
        return None
    return fa.backward(q, k, v, None, 0, o, lse, do, c, 0.0)


def merge(o, lse, o_new, lse_new):
    """Two normalized partial attentions merged in log-sum-exp space, in
    f32 (ring_attention.py:57-70): ``o`` f32, ``o_new`` any float dtype,
    the LSEs f32 [B, H, Sq]."""
    m = torch.maximum(lse, lse_new)
    finite = torch.isfinite(m)
    m_safe = torch.where(finite, m, torch.zeros_like(m))
    zero = torch.zeros_like(lse)
    w_old = torch.where(torch.isfinite(lse), torch.exp(lse - m_safe), zero)
    w_new = torch.where(torch.isfinite(lse_new), torch.exp(lse_new - m_safe),
                        zero)
    denom = torch.clamp(w_old + w_new, min=1e-37)
    o = (o * w_old[..., None] + o_new.float() * w_new[..., None]) \
        / denom[..., None]
    lse = torch.where(finite, m_safe + torch.log(denom),
                      torch.full_like(m, float("-inf")))
    return o, lse


def _forward_hops(q, idx, n, causal, shards):
    """O (q's dtype) and LSE of rank ``idx`` over the K/V pairs that
    ``shards`` yields, hop by hop (hop h's pair is rank (idx - h) mod n's).
    Hop 0 is the diagonal, which every row sees, so the first merge starts
    from it."""
    o = lse = None
    for hop, (k, v) in enumerate(shards):
        part = hop_forward(q, k, v, idx, (idx - hop) % n, causal)
        if part is None:
            continue
        if o is None:
            o, lse = part[0].float(), part[1]
        else:
            o, lse = merge(o, lse, *part)
    return o.to(q.dtype), lse


# ---------------------------------------------------------------------------
# the exchange over the sep group
# ---------------------------------------------------------------------------

class _Ring:
    """A rank's place on the sep group's ring: its index, the ring's size
    and the global ranks of its neighbours."""

    def __init__(self, group):
        self.group = group
        self.n = group.nranks
        self.idx = group.rank
        if self.idx < 0:
            raise ValueError(f"this rank is not in the sep group {group}")
        self.next = group.ranks[(self.idx + 1) % self.n]
        self.prev = group.ranks[(self.idx - 1) % self.n]

    def post(self, sends):
        """Each tensor of ``sends`` to the next rank, and a buffer like it
        from the previous one, in one batch_isend_irecv over the group.
        Returns (the buffers, the tasks to wait for before reading them or
        writing the sent tensors)."""
        from ...distributed import collective

        if not sends:
            return [], []
        bufs = [torch.empty_like(t) for t in sends]
        ops = [collective.P2POp(collective.isend, t, self.next, self.group)
               for t in sends]
        ops += [collective.P2POp(collective.irecv, b, self.prev, self.group)
                for b in bufs]
        return bufs, collective.batch_isend_irecv(ops)


def _wait(tasks):
    for task in tasks:
        task.wait()


def _kv_ring(kv, ring):
    """The stacked [2, ...] K/V pair of each hop, in order: hop h+1's is
    posted before hop h's is yielded, so that the transfer runs behind the
    caller's kernels for hop h."""
    for hop in range(ring.n):
        last = hop == ring.n - 1
        nxt, tasks = ring.post([] if last else [kv])
        yield kv[0], kv[1]
        _wait(tasks)
        if not last:
            kv = nxt[0]


def ring_forward(q, k, v, group, causal: bool = True):
    """(O in q's dtype, LSE [B, H, S/n] f32) of this rank's [B, H, S/n, D]
    shards over the ring of ``group``: the forward of
    ``ring_attention_bhsd`` without its autograd record (a caller that
    keeps O and LSE, as remat_policy="save_attn" does, feeds them to
    ``ring_backward``)."""
    ring = _Ring(group)
    return _forward_hops(q.contiguous(), ring.idx, ring.n, causal,
                         _kv_ring(torch.stack([k, v]), ring))


def _ring_backward(q, kv, o, lse, do, ring, causal):
    n, idx = ring.n, ring.idx
    do = do.contiguous()
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    acc = None      # f32 [2, ...] dK/dV of the shard held this hop
    for hop in range(n):
        src = (idx - hop) % n
        # one batch: the K/V held now on to the next rank (it needs them
        # at hop + 1) with the accumulator finished last hop, and from the
        # previous rank the next K/V and this hop's accumulator
        sends = ([kv] if hop < n - 1 else []) + ([acc] if hop > 0 else [])
        bufs, tasks = ring.post(sends)
        part = hop_backward(q, kv[0], kv[1], o, lse, do, idx, src, causal)
        if part is not None:
            dq += part[0].float()
        _wait(tasks)
        if hop < n - 1:
            kv = bufs[0]
        acc = bufs[-1] if hop > 0 else torch.zeros(
            kv.shape, dtype=torch.float32, device=kv.device)
        if part is not None:
            acc[0] += part[1].float()
            acc[1] += part[2].float()
    if n > 1:
        # the last accumulator goes home: rank idx + 1's shard
        bufs, tasks = ring.post([acc])
        _wait(tasks)
        acc = bufs[0]
    return dq.to(q.dtype), acc[0].to(kv.dtype), acc[1].to(kv.dtype)


def ring_backward(q, k, v, o, lse, do, group, causal: bool = True):
    """(dQ, dK, dV) of this rank's shards from the final O and LSE that
    ``ring_forward`` gave: the ring's backward hops over ``group``."""
    return _ring_backward(q.contiguous(), torch.stack([k, v]), o, lse, do,
                          _Ring(group), causal)


class _RingAttention(torch.autograd.Function):
    """The reference's ``_ring_core`` custom VJP over the sep group: the
    forward keeps q, k, v (this rank's shards), O and LSE."""

    @staticmethod
    def forward(ctx, q, k, v, group, causal):
        ring = _Ring(group)
        q = q.contiguous()
        kv = torch.stack([k, v])
        o, lse = _forward_hops(q, ring.idx, ring.n, causal,
                               _kv_ring(kv, ring))
        ctx.save_for_backward(q, kv, o, lse)
        ctx.ring, ctx.causal = ring, causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, kv, o, lse = ctx.saved_tensors
        return _ring_backward(q, kv, o, lse, do, ctx.ring, ctx.causal) \
            + (None, None)


def ring_attention_bhsd(q, k, v, group, is_causal: bool = True):
    """Attention of this rank's [B, H, S/n, D] shards of q, k and v over
    the whole sequence, split in order over the ranks of ``group`` (the
    sep group; rank r holds positions r·S/n to (r+1)·S/n - 1). Returns
    this rank's [B, H, S/n, D] output, in q's dtype. A group without a
    process group (one process) is a ring of one: flash attention."""
    if group is None or group.process_group is None or group.nranks == 1:
        return fa.flash_attention_bhsd(q, k, v, is_causal=is_causal)
    return _RingAttention.apply(q, k, v, group, bool(is_causal))


def ring_attention_bshd(q, k, v, group, is_causal: bool = True):
    """The reference's layout, [B, S/n, H, D]."""
    out = ring_attention_bhsd(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), group, is_causal)
    return out.transpose(1, 2)


# ---------------------------------------------------------------------------
# the same hops for n virtual ranks on one device
# ---------------------------------------------------------------------------

def compose_forward(qs, ks, vs, causal: bool = True):
    """The ring's forward for n virtual ranks whose shards (lists of
    [B, H, S/n, D], in sequence order) all lie on one device: each rank's
    hops through ``hop_forward`` and ``merge``, as the sep group runs them,
    without the exchange. Returns (the ranks' O, their LSE)."""
    n = len(qs)
    outs = [_forward_hops(qs[i], i, n, causal,
                          ((ks[(i - h) % n], vs[(i - h) % n])
                           for h in range(n)))
            for i in range(n)]
    return [o for o, _ in outs], [lse for _, lse in outs]


def compose_backward(qs, ks, vs, os, lses, dos, causal: bool = True):
    """The ring's backward for the n virtual ranks of ``compose_forward``:
    each rank's hops through ``hop_backward`` with its final O and LSE,
    dQ summed on the rank and dK/dV on the shard's owner, in f32. Returns
    (dQs, dKs, dVs) in the inputs' dtypes."""
    n = len(qs)
    f32 = dict(dtype=torch.float32, device=qs[0].device)
    dqs = [torch.zeros(q.shape, **f32) for q in qs]
    dks = [torch.zeros(k.shape, **f32) for k in ks]
    dvs = [torch.zeros(v.shape, **f32) for v in vs]
    for i in range(n):
        for hop in range(n):
            src = (i - hop) % n
            part = hop_backward(qs[i], ks[src], vs[src], os[i], lses[i],
                                dos[i], i, src, causal)
            if part is None:
                continue
            dqs[i] += part[0].float()
            dks[src] += part[1].float()
            dvs[src] += part[2].float()
    return ([d.to(q.dtype) for d, q in zip(dqs, qs)],
            [d.to(k.dtype) for d, k in zip(dks, ks)],
            [d.to(v.dtype) for d, v in zip(dvs, vs)])
