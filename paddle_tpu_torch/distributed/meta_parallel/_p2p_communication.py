"""Point-to-point hand-offs between pipeline stages (after Paddle's
fleet/meta_parallel/pp_utils/p2p_communication.py; the TPU package has no
counterpart: its single controller moves the arrays itself).

Each pp rank talks to its two ring neighbours over the groups topology.py
makes, one a ring edge (``HybridCommunicateGroup.get_p2p_groups``): the
next edge carries this rank's activations forward and the gradients that
come back for them, the previous edge the activations this rank receives
and the gradients it returns. NCCL carries CUDA tensors and gloo CPU ones
(collective.py refuses the other pairing).

NCCL runs the operations of one communicator in the order they were
issued. Were stage s to issue ``isend(act -> s+1)`` and then
``irecv(grad <- s+1)`` while stage s+1 issues ``isend(grad -> s)`` and then
``irecv(act <- s)``, each send would wait for a receive queued behind the
other send, and the ring would hang (gloo buffers sends, so CPU runs cannot
show it). So ``exchange`` issues a step's sends and receives on one edge
together in one ``batch_isend_irecv`` (one NCCL group), as Megatron's and
Paddle's schedules do.

A forward boundary's shape and dtype go once per batch of micro-batches
(``begin_batch``), before its first tensor, as Paddle's SendRecvMeta; a
gradient has the shape and dtype of the activation it belongs to, which
both sides know.
"""
from __future__ import annotations

import torch

from .. import collective, env

__all__ = ["P2P", "p2p_of"]

_META_LEN = 10          # dtype code, ndim, up to 8 dimensions
_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.float64,
           torch.int64, torch.int32, torch.int16, torch.int8, torch.uint8,
           torch.bool)


def _encode(t: torch.Tensor, device) -> torch.Tensor:
    if t.dim() > _META_LEN - 2:
        raise ValueError(f"a pipeline activation of {t.dim()} dimensions "
                         f"(at most {_META_LEN - 2})")
    meta = [_DTYPES.index(t.dtype), t.dim()] + list(t.shape)
    meta += [0] * (_META_LEN - len(meta))
    return torch.tensor(meta, dtype=torch.int64, device=device)


def _decode(values):
    dtype, ndim = _DTYPES[values[0]], values[1]
    return tuple(values[2:2 + ndim]), dtype


class P2P:
    """One pp rank's sends and receives with its previous and next stage.

    ``exchange(sends, recvs)`` runs one step: ``sends`` a list of
    (edge, tensor, key) and ``recvs`` a list of (edge, key, like) with edge
    "next" or "prev". A forward activation has a key (its boundary: the
    shape and dtype go before its first tensor of the batch) and ``like``
    None; a gradient has key None and ``like`` the (shape, dtype) it takes.
    Returns the received tensors in the order of ``recvs``."""

    def __init__(self, hcg):
        groups = hcg.get_p2p_groups()
        if groups is None:
            raise ValueError("P2P needs a pp degree of 2 or more")
        self._edges = {"next": groups[0], "prev": groups[1]}
        prev_rank, next_rank = hcg.get_p2p_neighbours()
        self._peers = {"next": next_rank, "prev": prev_rank}
        self._nccl = env.backend() == "nccl"
        self.device = torch.device("cuda", torch.cuda.current_device()) \
            if self._nccl else torch.device("cpu")
        self._unfinished = []
        # the first use of a group is a collective of all its ranks: take
        # the edges in ring order (this rank's two edges are s - 1 and s),
        # so that no rank waits on an edge its neighbour comes to later
        p, s = hcg.get_pipe_parallel_world_size(), hcg.get_stage_id()
        order = sorted([(s, "next"), ((s - 1) % p, "prev")])
        for _, edge in order:
            collective.all_reduce(torch.zeros(1, device=self.device),
                                  group=self._edges[edge])
        self.begin_batch()

    def begin_batch(self):
        """Forget the boundaries' shapes: each is sent again before its
        first tensor of the next batch of micro-batches."""
        self._sent_meta = set()
        self._meta = {}

    def _post(self, ops, wait=True):
        """Issue ``ops`` ((edge, "send" or "recv", tensor)) as one batch an
        edge; wait for what was received (on the card: the current stream
        waits), or with ``wait`` False return the tasks to wait for. Sends
        are kept until ``finish``."""
        waits = []
        for edge in ("next", "prev"):
            mine = [(kind, t) for e, kind, t in ops if e == edge]
            if not mine:
                continue
            group, peer = self._edges[edge], self._peers[edge]
            tasks = collective.batch_isend_irecv([
                collective.P2POp(collective.isend if kind == "send"
                                 else collective.irecv, t, peer, group)
                for kind, t in mine])
            if self._nccl:
                # one coalesced work for the group: waited for where it
                # holds a receive, else kept with the sends
                if any(kind == "recv" for kind, _ in mine):
                    waits += tasks
                else:
                    self._unfinished += [(task, None) for task in tasks]
            else:
                for (kind, t), task in zip(mine, tasks):
                    if kind == "recv":
                        waits.append(task)
                    else:
                        self._unfinished.append((task, t))
        if not wait:
            return waits
        for task in waits:
            task.wait()
        return []

    def exchange(self, sends=(), recvs=(), wait=True):
        """One step (see the class); with ``wait`` False, returns the
        received buffers and the tasks to wait for before reading them."""
        sends, recvs = list(sends), list(recvs)
        new_meta = [(e, _encode(t, self.device), key) for e, t, key in sends
                    if key is not None and key not in self._sent_meta]
        want_meta = [(e, key) for e, key, like in recvs
                     if like is None and key not in self._meta]
        if new_meta or want_meta:
            bufs = [torch.empty(_META_LEN, dtype=torch.int64,
                                device=self.device) for _ in want_meta]
            self._post([(e, "send", m) for e, m, _ in new_meta]
                       + [(e, "recv", b) for (e, _), b in
                          zip(want_meta, bufs)])
            self._sent_meta.update(key for _, _, key in new_meta)
            for (_, key), b in zip(want_meta, bufs):
                self._meta[key] = _decode(b.tolist())
        out = []
        for _, key, like in recvs:
            shape, dtype = like if like is not None else self._meta[key]
            out.append(torch.empty(shape, dtype=dtype, device=self.device))
        pending = self._post(
            [(e, "send", t.contiguous()) for e, t, _ in sends]
            + [(e, "recv", b) for (e, _, _), b in zip(recvs, out)], wait)
        return out if wait else (out, pending)

    def finish(self):
        """Wait for every send still in flight (the end of a batch)."""
        for task, _ in self._unfinished:
            task.wait()
        self._unfinished = []

    # -- Paddle's names (p2p_communication.py) ------------------------------
    def recv_forward(self, key):
        return self.exchange(recvs=[("prev", key, None)])[0]

    def send_forward(self, t, key):
        self.exchange(sends=[("next", t, key)])

    def recv_backward(self, like):
        return self.exchange(recvs=[("next", None, like)])[0]

    def send_backward(self, t):
        self.exchange(sends=[("prev", t, None)])

    def send_forward_recv_backward(self, t, key, like):
        """The activation to the next stage and, in the same batch on the
        same edge, the gradient of an earlier one back from it."""
        return self.exchange(sends=[("next", t, key)],
                             recvs=[("next", None, like)])[0]

    def send_backward_recv_forward(self, t, key):
        """The gradient to the previous stage and, in the same batch on
        the same edge, the next activation from it."""
        return self.exchange(sends=[("prev", t, None)],
                             recvs=[("prev", key, None)])[0]


def p2p_of(hcg) -> P2P:
    """The hybrid group's P2P, made at its first use (by every rank of the
    pp group, as the groups' first collective) and kept for the engines and
    the functional ring alike."""
    p2p = getattr(hcg, "_p2p_helper", None)
    if p2p is None:
        p2p = hcg._p2p_helper = P2P(hcg)
    return p2p
