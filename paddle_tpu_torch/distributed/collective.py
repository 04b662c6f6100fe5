"""Process groups and collectives (paddle_tpu/distributed/collective.py).

The TPU package's Group names a mesh axis and its collectives lower to XLA
ops inside shard_map, or run eagerly over its TCP transport. Here a Group
wraps a ``torch.distributed`` process group, and every collective is the
torch one on this rank's own tensor: NCCL for CUDA tensors, gloo for CPU
tensors. The pairing is checked, not repaired: a CUDA tensor on a gloo
group, or a CPU tensor on an NCCL group, raises (no collective goes
quietly over the host).

Tensors are the eager surface's Tensors or torch tensors; results come
back in the caller's kind. Ranks (``src``, ``dst``, ``peer``) are global
ranks, as in Paddle. ``new_group`` is collective: every rank of the world
calls it, in the same order, and a rank outside ``ranks`` gets a Group it
is not a member of.
"""
from __future__ import annotations

import time
from typing import List, Optional

import torch
import torch.distributed as tdist

from ..profiler import RecordEvent, host_tracing_active
from ..profiler import metrics as _metrics
from . import env as _env
from .watchdog import comm_task_manager

__all__ = ["ReduceOp", "Group", "Task", "new_group", "get_group",
           "destroy_process_group", "is_initialized", "all_reduce",
           "all_gather", "all_gather_object", "reduce_scatter", "all_to_all",
           "all_to_all_single", "broadcast", "broadcast_object_list",
           "reduce", "scatter", "scatter_object_list", "gather", "send",
           "recv", "isend", "irecv", "P2POp", "batch_isend_irecv", "barrier",
           "wait", "get_world_size", "get_rank", "get_backend", "stream",
           "record_collective", "group_of"]

_m_coll_count = _metrics.counter("comm/collective_count")
_m_coll_bytes = _metrics.counter("comm/collective_bytes")
_m_coll_latency = _metrics.histogram("comm/latency_ms")

_all_gather_single = getattr(tdist, "all_gather_single", None) or \
    getattr(tdist, "all_gather_into_tensor")
_reduce_scatter_single = getattr(tdist, "reduce_scatter_single", None) or \
    getattr(tdist, "reduce_scatter_tensor")


class ReduceOp:
    SUM = "sum"
    MAX = "max"
    MIN = "min"
    PROD = "prod"
    AVG = "avg"


def _torch_op(op):
    table = {ReduceOp.SUM: tdist.ReduceOp.SUM,
             ReduceOp.MAX: tdist.ReduceOp.MAX,
             ReduceOp.MIN: tdist.ReduceOp.MIN,
             ReduceOp.PROD: tdist.ReduceOp.PRODUCT,
             ReduceOp.AVG: tdist.ReduceOp.AVG}
    if op not in table:
        raise ValueError(f"unknown reduce op {op!r}")
    return table[op]


class Task:
    """A collective's handle (reference ProcessGroup::Task): ``wait()``
    blocks on torch's Work (on the card: orders the caller's stream after
    the collective) and then runs what the call left to do (filling an
    output list)."""

    def __init__(self, work=None, finish=None):
        self._work = work
        self._finish = finish
        self._done = work is None and finish is None

    def wait(self):
        if not self._done:
            if self._work is not None:
                self._work.wait()
            if self._finish is not None:
                self._finish()
            self._done = True
        return True

    def is_completed(self):
        return self._done or (self._work is not None
                              and self._work.is_completed()
                              and self._finish is None)

    def synchronize(self):
        self.wait()


def _run(work, finish, sync_op, rec=None, tensor=None):
    task = Task(work, finish)
    if sync_op:
        task.wait()
    if rec is not None:
        rec.issued(tensor, None if sync_op else work)
    return task


# ---------------------------------------------------------------------------
# the comm records (reference collective.py:246-341)
# ---------------------------------------------------------------------------

def _tensor_nbytes(tensor) -> int:
    if tensor is None:
        return 0
    local = getattr(tensor, "to_local", None)
    t = local() if callable(local) else tensor
    return t.numel() * t.element_size()


class _CommRecord:
    """Per-collective instrumentation handle, created for EVERY issued
    collective: folds (count, bytes, host latency) into the always-on
    metrics registry and the CommTaskManager's cumulative per-group
    stats, opens a host RecordEvent span when a Profiler is collecting,
    and wraps the watchdog CommTask when the watchdog is enabled.
    Latency is issue -> return of the call: the host-side span of the op
    (a gloo op blocks, so it IS the op; an NCCL op measures the issue,
    the part Python can stall on). Nothing here synchronises the host:
    the watchdog watches an NCCL collective through a CUDA event recorded
    after it, polled by its own thread."""

    __slots__ = ("task", "op", "gid", "nbytes", "t0", "_finished", "_span")

    def __init__(self, task, op, gid, nbytes):
        self.task = task
        self.op = op
        self.gid = gid
        self.nbytes = nbytes
        self.t0 = time.monotonic()
        self._finished = False
        if host_tracing_active():
            self._span = RecordEvent("comm::" + op)
            self._span.__enter__()
        else:
            self._span = None

    def _finish(self):
        if self._finished:
            return
        self._finished = True
        dt_ms = (time.monotonic() - self.t0) * 1e3
        _m_coll_count.inc()
        _m_coll_bytes.inc(self.nbytes)
        _metrics.inc(f"comm/{self.op}_count")
        if self.nbytes:
            _metrics.inc(f"comm/{self.op}_bytes", self.nbytes)
        _m_coll_latency.observe(dt_ms)
        comm_task_manager.record_stats(self.op, self.gid, self.nbytes,
                                       dt_ms)
        if self._span is not None:
            self._span.end()
            self._span = None

    def mark_done(self):
        self._finish()
        if self.task is not None:
            self.task.mark_done()

    def attach(self, value):
        self._finish()
        if self.task is not None:
            self.task.attach(value)

    def issued(self, tensor=None, work=None):
        """The collective was issued: an async one is watched through its
        Work; a CUDA one through an event recorded on the current stream
        (which the sync call's wait ordered after the collective); a gloo
        one has completed."""
        if self.task is None:
            self._finish()
        elif work is not None:
            self.attach(work)
        elif tensor is not None and tensor.is_cuda:
            ev = torch.cuda.Event()
            ev.record()
            self.attach(ev)
        else:
            self.mark_done()


def record_collective(op_name: str, gid: int, ranks, tensor=None) \
        -> _CommRecord:
    """Instrument one collective issued on group ``gid`` over global
    ``ranks`` (always), and register it with the desync watchdog when
    enabled (reference: CommTaskManager::CommTaskEnqueue,
    comm_task_manager.h). Call ``issued()`` on the result after the
    collective."""
    task = None
    if comm_task_manager.enabled:
        shape = dtype = None
        if tensor is not None:
            shape, dtype = tuple(tensor.shape), tensor.dtype
        task = comm_task_manager.start_task(
            op_name, gid, list(ranks), _env.global_rank(),
            shape=shape, dtype=dtype)
    return _CommRecord(task, op_name, gid, _tensor_nbytes(tensor))


def _track(op_name, group, tensor=None) -> _CommRecord:
    g = group or _get_default_group()
    return record_collective(op_name, g.id, g.ranks, tensor)


class Group:
    """A communicator: global ranks and the torch process group over them
    (None before init_parallel_env, for the world of one process)."""

    def __init__(self, ranks: List[int], gid: int = 0,
                 axis_name: Optional[str] = None, pg=None, name=None):
        self.ranks = list(ranks)
        self.nranks = len(self.ranks)
        self.id = gid
        self.axis_name = axis_name or f"group_{gid}"
        self.name = name or self.axis_name
        self.process_group = pg
        # the comm watchdog's CommTimeoutError once it aborted the group:
        # every later collective on it raises that
        self.aborted: Optional[BaseException] = None

    @property
    def rank(self):
        return self.get_group_rank(_env.global_rank())

    @property
    def world_size(self):
        return self.nranks

    def get_group_rank(self, global_rank):
        return self.ranks.index(global_rank) \
            if global_rank in self.ranks else -1

    def is_member(self):
        return _env.global_rank() in self.ranks

    @property
    def backend(self):
        if self.process_group is None:
            return None
        return tdist.get_backend(self.process_group)

    def __repr__(self):
        return (f"Group(id={self.id}, axis={self.axis_name}, "
                f"ranks={self.ranks})")


_groups = {}
_group_counter = [0]


def _get_default_group() -> Group:
    g = _groups.get(0)
    if g is None or (g.process_group is None and _env.is_initialized()):
        pg = tdist.group.WORLD if _env.is_initialized() else None
        g = Group(list(range(_env.get_world_size())), 0, axis_name="world",
                  pg=pg)
        _groups[0] = g
    return g


def new_group(ranks=None, backend=None, timeout=None, axis_name=None):
    """A group over ``ranks`` (all of the world when None), reference
    collective.py:142. Collective: every rank calls it with the same
    ranks, in the same order. ``backend`` None takes the world's."""
    _group_counter[0] += 1
    gid = _group_counter[0]
    world = _env.get_world_size()
    ranks = sorted(range(world) if ranks is None else ranks)
    if any(not 0 <= r < world for r in ranks):
        raise ValueError(f"ranks {ranks} outside the world of {world}")
    pg = None
    if _env.is_initialized():
        kw = {} if timeout is None else {"timeout": timeout}
        pg = tdist.new_group(ranks, backend=backend, **kw)
    g = Group(ranks, gid, axis_name=axis_name, pg=pg)
    _groups[gid] = g
    return g


def get_group(gid=0):
    return _get_default_group() if gid == 0 else _groups.get(gid)


def group_of(pg) -> Group:
    """The Group over an existing torch process group (a DeviceMesh
    dimension's, say), registered under a group id of its own at the first
    call, so that its collectives go through this module and are recorded
    under that id. Every member calls it for its groups in the same order,
    as new_group is called."""
    if pg is tdist.group.WORLD:
        return _get_default_group()
    for g in _groups.values():
        if g.process_group is pg:
            return g
    _group_counter[0] += 1
    gid = _group_counter[0]
    g = Group(tdist.get_process_group_ranks(pg), gid, pg=pg)
    _groups[gid] = g
    return g


def destroy_process_group(group=None):
    """Destroy ``group``, or with None every group and the world (the
    process may init_parallel_env again after)."""
    if group is None:
        _groups.clear()
        from .auto_parallel.process_mesh import clear_device_meshes

        clear_device_meshes()
        if _env.is_initialized():
            # every rank reaches the teardown before any rank goes: a gloo
            # rank that destroys the world while a peer is still inside its
            # last collective or its own teardown aborts the peer
            # ("terminate called without an active exception", a joinable
            # thread destroyed; 3 of 30 fresh 4-rank runs with one rank's
            # teardown delayed)
            tdist.barrier()
            tdist.destroy_process_group()
        return
    _groups.pop(group.id, None)
    if group.process_group is not None and group.is_member():
        tdist.destroy_process_group(group.process_group)


def is_initialized():
    return _env.is_initialized()


def get_world_size(group=None):
    return (group or _get_default_group()).nranks


def get_rank(group=None):
    if group is None:
        return _env.global_rank()
    return group.rank


def get_backend(group=None):
    """"NCCL" or "GLOO" (Paddle's spelling), None before
    init_parallel_env."""
    b = (group or _get_default_group()).backend
    return None if b is None else str(b).upper()


# ---------------------------------------------------------------------------
# tensors in, tensors out
# ---------------------------------------------------------------------------

def _raw(x) -> torch.Tensor:
    from ..core.tensor import Tensor

    return x._value if isinstance(x, Tensor) else x


def _like(proto, t: torch.Tensor):
    """``t`` as the caller's kind (an eager Tensor when ``proto`` is)."""
    from ..core.tensor import Tensor

    return Tensor._wrap(t) if isinstance(proto, Tensor) else t


def _pg(group, tensors=()):
    """The torch process group of ``group``, after checking that every
    tensor lies where the backend carries it."""
    g = group or _get_default_group()
    if g.process_group is None:
        raise RuntimeError("paddle_tpu_torch.distributed: call "
                           "init_parallel_env() before a collective")
    if g.aborted is not None:
        raise g.aborted
    if not g.is_member():
        raise RuntimeError(f"rank {_env.global_rank()} is not in {g}")
    backend = str(g.backend)
    for t in tensors:
        if t is None:
            continue
        cuda = t.is_cuda
        if cuda and backend != "nccl":
            raise RuntimeError(
                f"a CUDA tensor on a {backend} group: CUDA tensors go over "
                f"NCCL (init_parallel_env(backend='nccl'))")
        if not cuda and backend == "nccl":
            raise RuntimeError(
                "a CPU tensor on an NCCL group: CPU tensors go over gloo "
                "(init_parallel_env(backend='gloo'))")
    return g.process_group


def _set(dst: torch.Tensor, src: torch.Tensor):
    with torch.no_grad():
        dst.copy_(src)


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def all_reduce(tensor, op=ReduceOp.SUM, group=None, sync_op=True):
    t = _raw(tensor)
    pg = _pg(group, [t])
    rec = _track("all_reduce", group, t)
    work = tdist.all_reduce(t, op=_torch_op(op), group=pg,
                            async_op=not sync_op)
    return _run(work, None, sync_op, rec, t)


def all_gather(tensor_list, tensor, group=None, sync_op=True, axis=0):
    """Every rank's ``tensor``: into ``tensor_list`` (cleared, then one
    entry a rank, in rank order), or with ``tensor_list=None`` returned
    concatenated along ``axis``."""
    t = _raw(tensor)
    g = group or _get_default_group()
    pg = _pg(g, [t])
    n = g.nranks
    flat = torch.empty((n * t.shape[0],) + tuple(t.shape[1:]) if t.dim()
                       else (n,), dtype=t.dtype, device=t.device)
    rec = _track("all_gather", g, t)
    work = _all_gather_single(flat, t.contiguous(), group=pg,
                              async_op=not sync_op)
    parts = list(flat.chunk(n, dim=0)) if t.dim() else list(flat.unbind(0))

    if isinstance(tensor_list, list):
        def finish():
            tensor_list.clear()
            tensor_list.extend(_like(tensor, p) for p in parts)
        return _run(work, finish, sync_op, rec, t)
    if not sync_op:
        raise ValueError("all_gather(None, ...) returns its result: "
                         "sync_op=False needs a tensor_list")
    _run(work, None, True, rec, t)
    out = flat if axis == 0 else torch.cat(parts, dim=axis)
    return _like(tensor, out)


def all_gather_object(object_list, obj, group=None):
    g = group or _get_default_group()
    out = [None] * g.nranks
    tdist.all_gather_object(out, obj, group=_pg(g))
    object_list.clear()
    object_list.extend(out)


def reduce_scatter(tensor, tensor_or_tensor_list, op=ReduceOp.SUM,
                   group=None, sync_op=True):
    """Reduce the inputs over the group and keep this rank's piece: the
    list's entry of this rank's index, or the rank's slice of dim 0."""
    out = _raw(tensor)
    src = tensor_or_tensor_list
    full = torch.cat([_raw(x) for x in src], dim=0) \
        if isinstance(src, (list, tuple)) else _raw(src)
    pg = _pg(group, [out, full])
    rec = _track("reduce_scatter", group, full)
    work = _reduce_scatter_single(out, full.contiguous(), op=_torch_op(op),
                                  group=pg, async_op=not sync_op)
    return _run(work, None, sync_op, rec, out)


def all_to_all(out_tensor_list, in_tensor_list, group=None, sync_op=True):
    """Entry i of this rank's ``in_tensor_list`` goes to rank i of the
    group; ``out_tensor_list`` gets entry j from rank j (shapes as the
    inputs')."""
    ins = [_raw(x).contiguous() for x in in_tensor_list]
    pg = _pg(group, ins)
    outs = [torch.empty_like(x) for x in ins]
    rec = _track("all_to_all", group, ins[0] if ins else None)
    rec.nbytes = sum(_tensor_nbytes(x) for x in ins)
    work = tdist.all_to_all(outs, ins, group=pg, async_op=not sync_op)

    def finish():
        out_tensor_list.clear()
        out_tensor_list.extend(_like(in_tensor_list[0], o) for o in outs)
    return _run(work, finish, sync_op, rec, outs[0] if outs else None)


def all_to_all_single(out_tensor, in_tensor, out_split_sizes=None,
                      in_split_sizes=None, group=None, sync_op=True):
    out, inp = _raw(out_tensor), _raw(in_tensor)
    pg = _pg(group, [out, inp])
    rec = _track("all_to_all_single", group, inp)
    work = tdist.all_to_all_single(
        out, inp.contiguous(),
        output_split_sizes=list(out_split_sizes) if out_split_sizes
        else None,
        input_split_sizes=list(in_split_sizes) if in_split_sizes else None,
        group=pg, async_op=not sync_op)
    return _run(work, None, sync_op, rec, out)


def broadcast(tensor, src=0, group=None, sync_op=True):
    t = _raw(tensor)
    pg = _pg(group, [t])
    rec = _track("broadcast", group, t)
    work = tdist.broadcast(t, src=src, group=pg, async_op=not sync_op)
    return _run(work, None, sync_op, rec, t)


def broadcast_object_list(object_list, src=0, group=None):
    tdist.broadcast_object_list(object_list, src=src, group=_pg(group))


def reduce(tensor, dst=0, op=ReduceOp.SUM, group=None, sync_op=True):
    t = _raw(tensor)
    pg = _pg(group, [t])
    rec = _track("reduce", group, t)
    work = tdist.reduce(t, dst=dst, op=_torch_op(op), group=pg,
                        async_op=not sync_op)
    return _run(work, None, sync_op, rec, t)


def scatter(tensor, tensor_list=None, src=0, group=None, sync_op=True):
    """``tensor`` gets entry (its group rank) of ``src``'s list."""
    t = _raw(tensor)
    me = _env.global_rank()
    ins = [_raw(x).contiguous() for x in tensor_list] \
        if me == src and tensor_list else None
    pg = _pg(group, [t] + (ins or []))
    rec = _track("scatter", group, t)
    work = tdist.scatter(t, ins, src=src, group=pg, async_op=not sync_op)
    return _run(work, None, sync_op, rec, t)


def scatter_object_list(out_object_list, in_object_list=None, src=0,
                        group=None):
    out = [None]
    tdist.scatter_object_list(out, in_object_list if _env.global_rank()
                              == src else None, src=src, group=_pg(group))
    out_object_list.clear()
    out_object_list.append(out[0])


def gather(tensor, gather_list=None, dst=0, group=None, sync_op=True):
    """Every rank's ``tensor`` into ``gather_list`` on ``dst`` (cleared,
    one entry a rank)."""
    t = _raw(tensor).contiguous()
    g = group or _get_default_group()
    pg = _pg(g, [t])
    me = _env.global_rank()
    outs = [torch.empty_like(t) for _ in range(g.nranks)] if me == dst \
        else None
    rec = _track("gather", g, t)
    work = tdist.gather(t, outs, dst=dst, group=pg, async_op=not sync_op)

    def finish():
        if outs is not None and gather_list is not None:
            gather_list.clear()
            gather_list.extend(_like(tensor, o) for o in outs)
    return _run(work, finish, sync_op, rec, t)


def send(tensor, dst=0, group=None, sync_op=True):
    t = _raw(tensor).contiguous()
    pg = _pg(group, [t])
    rec = _track("send", group, t)
    if sync_op:
        tdist.send(t, dst, group=pg)
        rec.issued(t)
        return Task()
    work = tdist.isend(t, dst, group=pg)
    rec.issued(t, work)
    return Task(work)


def recv(tensor, src=0, group=None, sync_op=True):
    t = _raw(tensor)
    pg = _pg(group, [t])
    rec = _track("recv", group, t)
    if sync_op:
        tdist.recv(t, src, group=pg)
        rec.issued(t)
        return Task()
    work = tdist.irecv(t, src, group=pg)
    rec.issued(t, work)
    return Task(work)


def isend(tensor, dst=0, group=None):
    return send(tensor, dst, group, sync_op=False)


def irecv(tensor, src=0, group=None):
    return recv(tensor, src, group, sync_op=False)


class P2POp:
    def __init__(self, op, tensor, peer, group=None):
        if op not in (isend, irecv, send, recv):
            raise ValueError("P2POp takes isend or irecv")
        self.op = op
        self.tensor = tensor
        self.peer = peer
        self.group = group


def batch_isend_irecv(p2p_op_list):
    """Post every send and receive of the list together (torch's
    batch_isend_irecv: one NCCL group call, no order to deadlock on);
    returns a Task each."""
    ops, recs = [], []
    for op in p2p_op_list:
        t = _raw(op.tensor)
        fn = tdist.isend if op.op in (isend, send) else tdist.irecv
        ops.append(tdist.P2POp(fn, t, op.peer, group=_pg(op.group, [t])))
        recs.append((_track("isend" if fn is tdist.isend else "irecv",
                            op.group, t), t))
    works = tdist.batch_isend_irecv(ops)
    for (rec, t), w in zip(recs, works):
        rec.issued(t, w)
    return [Task(w) for w in works]


def barrier(group=None):
    g = group or _get_default_group()
    pg = _pg(g)
    rec = _track("barrier", g)
    if _env.backend() == "nccl":
        tdist.barrier(group=pg, device_ids=[torch.cuda.current_device()])
    else:
        tdist.barrier(group=pg)
    rec.mark_done()
    return Task()


def wait(tensor, group=None, use_calc_stream=True):
    """Wait for ``tensor``'s pending work: on the card, the device."""
    if _raw(tensor).is_cuda:
        torch.cuda.current_stream().synchronize()


class stream:
    """paddle.distributed.stream: the stream-addressed variants; torch
    orders a collective after the caller's stream itself, so these are the
    collectives above."""

    all_reduce = staticmethod(all_reduce)
    all_gather = staticmethod(all_gather)
    reduce_scatter = staticmethod(reduce_scatter)
    all_to_all = staticmethod(all_to_all)
    alltoall = staticmethod(all_to_all)
    broadcast = staticmethod(broadcast)
    reduce = staticmethod(reduce)
    scatter = staticmethod(scatter)
    send = staticmethod(send)
    recv = staticmethod(recv)
