"""Pipeline-parallel engines (paddle_tpu/distributed/meta_parallel/
pipeline_parallel.py; reference PipelineParallel.train_batch /
forward_backward_pipeline, fleet/meta_parallel/pipeline_parallel.py:149,
459, 697; interleaved VPP :1010; zero bubble, passes/
pipeline_scheduler_pass/pipeline_zero_bubble.py).

The TPU package is single-controller. Its eager PipelineParallel runs every
micro-batch through the whole model in one process, and no stage ever sends
anything (:70-91); its _ChunkExecutor runs every stage's instruction stream
in one loop (:132-282); its compiled pipeline is a ``ppermute`` ring inside
``shard_map`` (:341-408). The port follows PaddlePaddle's multi-process
Fleet, as the rest of distributed/ does:

- a pp rank builds and holds only its stage's layers (its virtual chunks,
  under VPP: pp_layers.py);
- activations go forward, and their gradients backward, as real sends and
  receives over the pp ring (_p2p_communication.py: NCCL for CUDA tensors,
  gloo for CPU ones; a step's sends and receives with one neighbour go in
  one batch);
- the loss exists on the last stage, and the engines broadcast it over the
  pp group, as Paddle's ``train_batch`` does.

The engines (``PipelineParallel``: 1F1B; ``PipelineParallelWithInterleave``:
interleaved 1F1B over v chunks a stage, ``num_micro % pp == 0``;
``PipelineParallelZeroBubble``: ZB-H1) each run this rank's stream of
pipeline_schedules.py through ``_ChunkExecutor``. Each micro-batch's loss is
divided by the micro-batch count, as the TPU package accumulates it, and
scaled by a GradScaler after (1F1B, :83-87) or before (the other two, as
its chunk executor, :231-233). Under ZB-H1, B is the input-gradient
pullback with the graph kept and W the weight-gradient pullback: two
``autograd.grad`` calls, as :243-267. A shared layer's weights count in the
chunks that use them here; the TPU package's chunk executor leaves them out
of its chunks' parameters (their run functions are lambdas), so its
interleaved and zero-bubble engines give them no gradient, where its 1F1B
engine gives them theirs.

``spmd_pipeline`` and ``spmd_pipeline_interleaved`` are functions that every
rank of the pp group calls with its stage's parameters: each tick's hop is
an autograd function whose forward sends to the next stage and receives
from the previous one, and whose backward does the reverse. A stage skips
its compute on ticks where it holds no micro-batch, and the P-1 -> 0 hop of
the plain ring is dropped (the TPU package computes on zeros there and
sends a value nobody records).
"""
from __future__ import annotations

import time as _time
from typing import Callable

import torch

from ...core import autograd
from ...core.tensor import Tensor
from ...nn.layer.layers import Layer
from ...profiler import metrics as _metrics
from .. import collective
from ..fleet.layers.mpu.mp_ops import _live
from . import pipeline_schedules as psched
from ._p2p_communication import p2p_of
from .pp_layers import PipelineLayer

__all__ = ["PipelineParallel", "PipelineParallelWithInterleave",
           "PipelineParallelZeroBubble", "spmd_pipeline",
           "spmd_pipeline_interleaved"]


def _raw(x):
    return x._value if isinstance(x, Tensor) else x


def _tensor(x):
    if isinstance(x, Tensor):
        return x
    return Tensor._wrap(x) if torch.is_tensor(x) else Tensor(x)


def _floating(t):
    return t.is_floating_point() or t.is_complex()


class PipelineParallel(Layer):
    """1F1B (reference :459): this rank runs ``gen_1f1b``'s stream of its
    stage, sending and receiving the activations and their gradients."""

    _split_bw = False
    # the loss of a micro-batch divided by their count before the scaler
    # scales it, as the TPU package's 1F1B engine; its chunk executor
    # (the interleaved and zero-bubble engines) scales first
    _mean_first = True

    def __init__(self, layers, hcg, strategy=None):
        super().__init__()
        self._layers = layers
        self._hcg = hcg
        self._strategy = strategy
        pp_cfg = {}
        if strategy is not None:
            pp_cfg = strategy.hybrid_configs.get("pp_configs", {}) or {}
            if hasattr(pp_cfg, "keys"):
                pp_cfg = dict(pp_cfg)
        self.micro_batch_size = pp_cfg.get("micro_batch_size", 1)
        self.accumulate_steps = pp_cfg.get("accumulate_steps", 1)
        self.num_stages = hcg.get_pipe_parallel_world_size()
        self.stage_id = hcg.get_stage_id()
        self.num_virtual = 1
        self.total_loss = None
        self._executor = None

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def _stream(self, n_micro):
        return psched.gen_1f1b(self.stage_id, self.num_stages, n_micro)

    def _split_micro(self, data):
        if isinstance(data, (tuple, list)):
            xs, ys = data[0], data[1]
        else:
            xs, ys = data, None
        n = self.accumulate_steps

        def split(t):
            t = _raw(_tensor(t))
            if t.shape[0] % n:
                raise ValueError(f"a batch of {t.shape[0]} does not split "
                                 f"into {n} micro-batches")
            return [Tensor._wrap(c) for c in t.split(t.shape[0] // n)]

        x_chunks = split(xs)
        y_chunks = split(ys) if ys is not None else [None] * n
        return list(zip(x_chunks, y_chunks))

    def _get_executor(self):
        if self._executor is None:
            self._executor = _ChunkExecutor(self._layers, self._hcg,
                                            self.num_virtual)
        return self._executor

    def forward_backward_pipeline(self, data, scaler=None):
        """This rank's stream over the micro-batches of ``data``; returns
        the mean of the micro-batches' losses (on every rank of the pp
        group: the last stage's, broadcast)."""
        micros = self._split_micro(data)
        ex = self._get_executor()
        self.total_loss = ex.run(ex.stream_of(self, len(micros)), micros,
                                 self._split_bw, scaler,
                                 mean_first=self._mean_first)
        return self.total_loss

    def train_batch(self, data, optimizer, lr_scheduler=None, scaler=None):
        """reference :697, with Paddle's allreduce of the shared weights'
        gradients before the step; under a GradScaler, a non-finite
        gradient on any stage skips the step on every stage."""
        self._layers.train()
        loss = self.forward_backward_pipeline(data, scaler)
        if isinstance(self._layers, PipelineLayer):
            self._layers.allreduce_shared_weight_gradients()
        if scaler is not None:
            scaler.unscale_(optimizer)
            group = self._hcg.get_pipe_parallel_group()
            if scaler.is_enable() and group.nranks > 1 and _live(group):
                found = torch.tensor(float(scaler._found_inf),
                                     device=self._get_executor().device)
                collective.all_reduce(found, op=collective.ReduceOp.MAX,
                                      group=group)
                scaler._found_inf = bool(found.item())
            scaler.step(optimizer)
        else:
            optimizer.step()
        optimizer.clear_grad()
        if lr_scheduler is not None:
            lr_scheduler.step()
        return loss

    def eval_batch(self, data, compute_loss=False):
        """The forwards of this rank's stream, without gradients: the mean
        over the micro-batches of the loss (``compute_loss``) or of the
        model's output, on every rank of the pp group."""
        self._layers.eval()
        micros = self._split_micro(data)
        ex = self._get_executor()
        stream = [i for i in ex.stream_of(self, len(micros)) if i[0] == "F"]
        with autograd.no_grad():
            return ex.run(stream, micros, False, None,
                          forward_only=True, compute_loss=compute_loss)

    def state_dict(self, *a, **k):
        return self._layers.state_dict(*a, **k)

    def set_state_dict(self, s, *a, **k):
        return self._layers.set_state_dict(s, *a, **k)

    def parameters(self, *a, **k):
        return self._layers.parameters(*a, **k)

    def named_parameters(self, *a, **k):
        return self._layers.named_parameters(*a, **k)


class _ChunkExecutor:
    """One rank's executor of its own instruction stream
    ((kind, micro, chunk), kind F/B/W) over its chunks: F takes the
    micro-batch (virtual stage gv = 0) or receives its input from gv - 1;
    B receives the gradient of its output from gv + 1 (the last stage
    starts from its loss) and sends its input's gradient to gv - 1; W
    (``split_bw``) runs the weight-gradient pullback that B left. Each step
    sends what the previous instruction produced together with what this
    one receives (_p2p_communication.py). At pp 1 the one rank runs every
    chunk as one, without sends."""

    def __init__(self, layers, hcg, num_chunks):
        self.p = hcg.get_pipe_parallel_world_size()
        self.s = hcg.get_stage_id() if self.p > 1 else 0
        self.v = num_chunks if self.p > 1 else 1
        self.q = self.p * self.v
        self._loss_fn = getattr(layers, "_loss_fn", None)
        if isinstance(layers, PipelineLayer):
            if self.p > 1 and (layers.num_stages != self.p
                               or layers.get_num_virtual_stages() != self.v):
                raise ValueError(
                    f"a PipelineLayer of {layers.num_stages} stages x "
                    f"{layers.get_num_virtual_stages()} chunks under an "
                    f"engine of {self.p} stages x {self.v} chunks: build "
                    f"it with num_virtual_pipeline_stages={self.v}")
            held = layers.held_chunks()
            if self.p > 1:
                self._fns = {gv: layers.chunk_fns(gv) for gv in held}
                self._params = {gv: layers.chunk_parameters(gv)
                                for gv in held}
            else:
                self._fns = {0: [f for gv in held
                                 for f in layers.chunk_fns(gv)]}
                params, seen = [], set()
                for gv in held:
                    for prm in layers.chunk_parameters(gv):
                        if id(prm) not in seen:
                            seen.add(id(prm))
                            params.append(prm)
                self._params = {0: params}
        elif self.p == 1:
            self._fns = {0: [layers]}
            self._params = {0: [prm for prm in layers.parameters()
                                if not prm.stop_gradient]}
        else:
            raise TypeError("a pipeline of 2 or more stages needs a "
                            "PipelineLayer")
        self._p2p = p2p_of(hcg) if self.p > 1 else None
        self._group = hcg.get_pipe_parallel_group() if self.p > 1 else None
        self.device = self._p2p.device if self._p2p is not None else None

    def stream_of(self, engine, n_micro):
        """The engine's stream of this rank (one chunk at pp 1)."""
        if self.p == 1:
            return (psched._zb_h1_all_stages(1, n_micro)[0]
                    if engine._split_bw else psched.gen_1f1b(0, 1, n_micro))
        return engine._stream(n_micro)

    def _run_chunk(self, gv, x):
        for f in self._fns[gv]:
            x = f(x)
        return x

    def run(self, stream, micros, split_bw, scaler=None, forward_only=False,
            compute_loss=True, mean_first=False):
        """Run ``stream``; returns the mean of the micro-batches' losses
        (or, ``forward_only`` without ``compute_loss``, of the outputs) as
        a Tensor on every rank of the pp group."""
        n_micro = len(micros)
        p2p = self._p2p
        if p2p is not None:
            p2p.begin_batch()
        acts, dws = {}, {}
        total = None
        pending = []      # the previous instruction's sends
        for kind, mi, c in stream:
            gv = c * self.p + self.s
            recvs = []
            if kind == "F" and gv > 0:
                recvs.append(("prev", gv, None))
            elif kind == "B" and gv < self.q - 1:
                out = _raw(acts[(mi, gv)][1])
                if _floating(out):
                    recvs.append(("next", None, (tuple(out.shape),
                                                 out.dtype)))
            t_posted = _time.perf_counter()
            got = p2p.exchange(pending, recvs) if pending or recvs else []
            pending = []
            if kind == "F":
                if gv == 0:
                    x_in = micros[mi][0]
                else:
                    # comm/overlap_ms of each forward hand-off (reference
                    # pipeline_parallel.py:214-218): from posting the
                    # exchange to holding the activation, the part of the
                    # hand-off this stage waits for
                    _metrics.observe("comm/overlap_ms",
                                     (_time.perf_counter() - t_posted) * 1e3)
                    x_in = Tensor._wrap(got[0])
                    if _floating(got[0]) and not forward_only:
                        x_in.stop_gradient = False
                out = self._run_chunk(gv, x_in)
                if gv == self.q - 1:
                    y = micros[mi][1]
                    if (self._loss_fn is not None and y is not None
                            and compute_loss):
                        out = self._loss_fn(out, y)
                    det = out.detach()
                    total = det if total is None else total + det
                    if not forward_only:
                        # 1F1B scales loss / n (:83-87), the chunk
                        # executor the loss before the division (:231-233)
                        if scaler is not None and not mean_first:
                            out = scaler.scale(out)
                        out = out / n_micro
                        if scaler is not None and mean_first:
                            out = scaler.scale(out)
                else:
                    pending.append(("next", _raw(out).detach(), gv + 1))
                if not forward_only:
                    acts[(mi, gv)] = (x_in, out)
            elif kind == "B":
                x_in, out = acts.pop((mi, gv))
                dy = Tensor._wrap(got[0]) if got else None
                gx = self._backward(gv, mi, x_in, out, dy, split_bw, dws)
                if gv > 0 and _floating(_raw(x_in)):
                    gx = torch.zeros_like(_raw(x_in)) if gx is None \
                        else _raw(gx)
                    pending.append(("prev", gx, None))
            else:  # W
                out, dy = dws.pop((mi, gv))
                params = self._params[gv]
                if params and not out.stop_gradient:
                    self._accum(params, autograd.grad(
                        out, params, grad_outputs=dy, retain_graph=False,
                        allow_unused=True))
        if p2p is not None:
            if pending:
                p2p.exchange(pending, [])
            p2p.finish()
        return self._broadcast_mean(total, n_micro)

    def _backward(self, gv, mi, x_in, out, dy, split_bw, dws):
        """B of (mi, gv): the input's gradient (None where it has none);
        the parameters' gradients accumulated, or (``split_bw``) left to
        W with the graph kept."""
        params = self._params[gv]
        wrt_x = [x_in] if gv > 0 and not x_in.stop_gradient else []
        if split_bw:
            dws[(mi, gv)] = (out, dy)
        if out.stop_gradient:
            return None
        if split_bw:
            if not wrt_x:
                return None
            return autograd.grad(out, wrt_x, grad_outputs=dy,
                                 retain_graph=True, allow_unused=True)[0]
        grads = autograd.grad(out, wrt_x + params, grad_outputs=dy,
                              retain_graph=False, allow_unused=True)
        self._accum(params, grads[len(wrt_x):])
        return grads[0] if wrt_x else None

    @staticmethod
    def _accum(params, grads):
        for prm, g in zip(params, grads):
            if g is None:
                continue
            t = prm._value
            t.grad = _raw(g) if t.grad is None else t.grad + _raw(g)

    def _broadcast_mean(self, total, n_micro):
        """The last stage's mean, on every rank of the pp group (a shape
        and dtype first, then the values)."""
        mean = None if total is None else _raw(total) / n_micro
        if self._group is None:
            return None if mean is None else Tensor._wrap(mean)
        last = self._group.ranks[-1]
        meta = [None if mean is None else (tuple(mean.shape), mean.dtype)]
        collective.broadcast_object_list(meta, src=last, group=self._group)
        shape, dtype = meta[0]
        buf = mean.contiguous() if mean is not None else \
            torch.empty(shape, dtype=dtype, device=self.device)
        collective.broadcast(buf, src=last, group=self._group)
        return Tensor._wrap(buf)


class PipelineParallelWithInterleave(PipelineParallel):
    """Interleaved/VPP 1F1B (reference :1010): each stage holds
    ``num_virtual_pipeline_stages`` chunks of the PipelineLayer (which must
    be built with that many), run in Megatron's interleaved order
    (``num_micro % pp == 0``)."""

    _mean_first = False

    def __init__(self, layers, hcg, strategy=None,
                 num_virtual_pipeline_stages=None):
        super().__init__(layers, hcg, strategy)
        v = num_virtual_pipeline_stages or getattr(
            layers, "_num_virtual_pipeline_stages", None) or 2
        self.num_virtual = max(int(v), 1)

    def _stream(self, n_micro):
        return psched.gen_interleave_1f1b(self.stage_id, self.num_stages,
                                          n_micro, self.num_virtual)


class PipelineParallelZeroBubble(PipelineParallelWithInterleave):
    """ZB-H1 (reference passes/pipeline_scheduler_pass/
    pipeline_zero_bubble.py): B computes the input gradients only (the
    critical path), W the weight gradients, scheduled into the bubbles."""

    _split_bw = True

    def __init__(self, layers, hcg, strategy=None):
        super().__init__(layers, hcg, strategy,
                         num_virtual_pipeline_stages=1)

    def _stream(self, n_micro):
        return psched._zb_h1_all_stages(self.num_stages,
                                        n_micro)[self.stage_id]


# ---------------------------------------------------------------------------
# the functional ring (every rank of the pp group calls it)
# ---------------------------------------------------------------------------

def _ring(group):
    """(pp degree, stage, P2P or None) of ``group``: a hybrid group, its
    pp group, or None (the current hybrid group's)."""
    from ..topology import (HybridCommunicateGroup,
                            get_hybrid_communicate_group)

    hcg = group if isinstance(group, HybridCommunicateGroup) else \
        get_hybrid_communicate_group()
    if hcg is None:
        if group is None or group.nranks == 1:
            return 1, 0, None
        raise ValueError("spmd_pipeline runs over the pp group of a hybrid "
                         "communicate group (fleet.init, or HybridTrainer's "
                         "mesh)")
    pp = hcg.get_pipe_parallel_group()
    if group is not None and group is not hcg and group is not pp:
        raise ValueError(f"{group} is not the pp group of the hybrid "
                         f"communicate group")
    p = hcg.get_pipe_parallel_world_size()
    return p, hcg.get_stage_id(), p2p_of(hcg) if p > 1 else None


class _Hop(torch.autograd.Function):
    """One tick's hand-off: forward sends ``ys`` to the next stage and
    receives ``likes`` ((shape, dtype) each) from the previous one, without
    waiting for them (``hop.wait()`` before they are read); backward sends
    the received tensors' gradients back and receives those of ``ys``. The
    token chains the hops of one rank, so that its backward runs them in
    the reverse order of the forward, as every other rank does."""

    @staticmethod
    def forward(ctx, token, hop, likes, *ys):
        ctx.hop, ctx.likes = hop, [(tuple(y.shape), y.dtype) for y in ys]
        sends = [("next", y.detach(), None) for y in ys]
        recvs = [("prev", None, like) for like in likes]
        got, pending = hop.p2p.exchange(sends, recvs, wait=False)
        hop.pending += pending
        return (token.detach().clone(),) + tuple(got)

    @staticmethod
    def backward(ctx, g_token, *g_got):
        sends = [("prev", g.contiguous(), None) for g in g_got]
        recvs = [("next", None, like) for like in ctx.likes]
        grads = ctx.hop.p2p.exchange(sends, recvs)
        return (torch.zeros_like(g_token), None, None) + tuple(grads)


class _HopState:
    """A ring's receives in flight (waited for before they are read) over
    its P2P; the sends of its previous call, backward included, are
    finished when it starts, and its forward's when the forward ends."""

    def __init__(self, p2p):
        self.p2p = p2p
        self.pending = []
        p2p.finish()

    def wait(self):
        for task in self.pending:
            task.wait()
        self.pending = []

    def close(self):
        self.wait()
        self.p2p.finish()


def _hop(state, token, ys, likes):
    """``_Hop`` of ``ys`` (sent) and ``likes`` (received); returns the new
    token and the received tensors."""
    out = _Hop.apply(token, state, likes, *ys)
    return out[0], list(out[1:])


class _Tie(torch.autograd.Function):
    """``x`` as it is, with the token's hops behind it in the backward."""

    @staticmethod
    def forward(ctx, x, token):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g, torch.zeros((), dtype=torch.float32, device=g.device)


def _start_token(params, device):
    """The first token of a rank's hop chain: zero, taken from one element
    of its smallest parameter that takes a gradient, so that a backward
    that asks for the parameters' gradients (``torch.autograd.grad``)
    runs every hop, a receive-only one too (a leaf of its own would be
    pruned from such a backward)."""
    live = [t for t in _leaves(params) if t.requires_grad]
    if not live:
        return torch.zeros((), dtype=torch.float32, device=device,
                           requires_grad=True)
    t = min(live, key=lambda t: t.numel())
    return t[(0,) * t.dim()].float() * 0.0


def _device_of(stacked_params, x):
    if x.device.type != "meta":
        return x.device
    for t in _leaves(stacked_params):
        return t.device
    raise ValueError("spmd_pipeline: x is a meta tensor and the parameters "
                     "hold no tensor to take the device from")


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif torch.is_tensor(tree):
        yield tree


def _finish(outputs, token, shape, dtype, device, last):
    """The last stage's outputs, or elsewhere zeros of their shape (an
    expanded scalar: no memory), each with the rank's hops tied behind."""
    if last:
        out = torch.stack(outputs)
    else:
        out = torch.zeros((), dtype=dtype, device=device).expand(shape)
    return _Tie.apply(out, token)


def spmd_pipeline(stage_fn: Callable, stacked_params, x, n_micro: int,
                  axis_name: str = "pp", overlap_sends: bool = False,
                  group=None):
    """GPipe ring over the pp group; every rank of it calls this with its
    stage's parameters (reference :341-408).

    stage_fn(params, x) -> y   : one stage's computation (y as x's shape)
    stacked_params             : this stage's parameters
    x                          : [n_micro, mb, ...] micro-batched input;
                                 only stage 0's values are read (the other
                                 stages may pass a "meta" tensor of its
                                 shape and dtype)

    Returns [n_micro, mb, ...]: the outputs on the last stage, zeros (an
    expanded scalar) elsewhere; a loss of either carries the backward
    through every stage. There are n_micro + P - 1 ticks: at tick t stage s
    computes micro-batch t - s, then sends it to stage s + 1 and receives
    the next from s - 1. ``overlap_sends=True`` splits each tick's
    micro-batch into halves along the batch dimension and issues the first
    half's send before the second half's compute (needs a per-sample
    stage_fn; with mb odd or below 2 the call uses the unsplit schedule,
    as :370-371). ``axis_name`` is the TPU package's; ``group`` (a hybrid
    communicate group or its pp group; None: the current hybrid group's)
    names the ranks.
    """
    p, stage, p2p = _ring(group)
    device = _device_of(stacked_params, x)
    mb_shape = tuple(x.shape[1:])
    split = overlap_sends and len(mb_shape) >= 1 \
        and mb_shape[0] % 2 == 0 and mb_shape[0] >= 2
    parts = 2 if split else 1
    part_shape = ((mb_shape[0] // parts,) + mb_shape[1:]) if mb_shape \
        else mb_shape
    hop = _HopState(p2p) if p2p is not None else None
    token = _start_token(stacked_params, device)
    state, outputs = [], []
    for t in range(n_micro + p - 1):
        m = t - stage
        valid = 0 <= m < n_micro
        send = valid and stage < p - 1
        recv = stage > 0 and 0 <= t - (stage - 1) < n_micro
        if hop is not None:
            hop.wait()            # the previous tick's receives
        if valid:
            cur = x[m] if stage == 0 else torch.cat(state, 0)
        ys, got = [], []
        for k in range(parts):
            if valid:
                n = part_shape[0] if split else None
                ys.append(stage_fn(stacked_params,
                                   cur[k * n:(k + 1) * n] if split else cur))
            if send or recv:
                # a half's send goes before the next half's compute
                token, r = _hop(hop, token, ys[k:k + 1] if send else [],
                                [(part_shape, x.dtype)] if recv else [])
                got += r
        if valid and stage == p - 1:
            outputs.append(torch.cat(ys, 0) if split else ys[0])
        state = got
    if hop is not None:
        hop.close()
    return _finish(outputs, token, (n_micro,) + mb_shape, x.dtype, device,
                   stage == p - 1)


def spmd_pipeline_interleaved(stage_fn: Callable, chunked_params, x,
                              n_micro: int, n_chunks: int,
                              axis_name: str = "pp", group=None):
    """Interleaved (virtual-stage) ring over the pp group (reference
    :411-469); every rank calls it with its ``n_chunks`` chunks.

    Virtual stage gv = c * P + stage computes micro-batch t - gv at tick t
    (n_micro + P * n_chunks - 1 ticks); chunk c's output goes to stage + 1,
    or on stage P - 1 to chunk c + 1 of stage 0.

    chunked_params : a pytree with a leading [n_chunks] axis on every leaf
    x              : [n_micro, mb, ...] (read on stage 0; see
                     ``spmd_pipeline``)
    Returns [n_micro, mb, ...]: the outputs on the last stage, zeros
    elsewhere.
    """
    p, stage, p2p = _ring(group)
    v, q = n_chunks, p * n_chunks
    device = _device_of(chunked_params, x)
    mb_shape = tuple(x.shape[1:])
    like = (mb_shape, x.dtype)

    def chunk_params(c):
        return _index_tree(chunked_params, c)

    def live(gv, t):
        return 0 <= gv and 0 <= t - gv < n_micro

    hop = _HopState(p2p) if p2p is not None else None
    token = _start_token(chunked_params, device)
    held = {}               # chunk -> its input at this tick
    outputs = []
    for t in range(n_micro + q - 1):
        if hop is not None:
            hop.wait()
        ys = {}
        for c in range(v):
            gv = c * p + stage
            if not live(gv, t):
                continue
            xin = x[t - gv] if gv == 0 else held[c]
            ys[c] = stage_fn(chunk_params(c), xin)
        if stage == p - 1 and v - 1 in ys:
            outputs.append(ys[v - 1])
        # chunk c goes to chunk c (stage + 1) or c + 1 (stage 0, from P-1)
        to = [c for c in sorted(ys) if c * p + stage < q - 1]
        frm = [c for c in range(v) if live(c * p + stage - 1, t)]
        if p == 1:
            held = {c + 1: ys[c] for c in to}
            continue
        if to or frm:
            token, got = _hop(hop, token, [ys[c] for c in to],
                              [like] * len(frm))
            held = dict(zip(frm, got))
        else:
            held = {}
    if hop is not None:
        hop.close()
    return _finish(outputs, token, (n_micro,) + mb_shape, x.dtype, device,
                   stage == p - 1)


def _index_tree(tree, i):
    if isinstance(tree, dict):
        return {k: _index_tree(v, i) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_index_tree(v, i) for v in tree)
    return tree[i]
