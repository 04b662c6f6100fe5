"""AdamW trainer over the stacked Llama core
(paddle_tpu/distributed/fleet/trainer.py:34-220), on one card or over a
dp x pp x sharding x sep x mp mesh of ranks.

The TPU package compiles the whole step into one XLA program over a hybrid
mesh; its parameters are full arrays with NamedShardings. Here the step
runs eagerly, and over a mesh each rank is a process (spawn, or a launcher
and init_parallel_env) holding only its shards (models/llama.py::
param_specs): the loss and its gradient through models/llama.py (the
flash-attention and RMSNorm kernels on a card, at H/mp heads), then the
global-norm clip and AdamW exactly as the TPU package writes them: f32
moments, bias correction by the step count t, weight decay on every leaf,
the update computed in f32 and cast back to the parameter's dtype.
Parameters and moments are updated in place (the TPU package donates its
buffers to the same end).

Over a mesh:

- ``place_batch``: each data rank (over dp x sharding, dp outer) takes its
  rows of the global batch, and each sep rank its shard of every sequence
  (sep rank r the positions r·S/sep onwards; the model runs attention as a
  ring over the sep group). The loss is the global batch's mean: the
  gradients are summed over the data and sep ranks (reduce-scattered over
  'sharding' by the FSDP gathers, all-reduced over dp x sep, or over dp x
  sharding x sep for a leaf replicated on them) and divided by their
  count, and the loss is averaged over the same ranks, so that every sep
  replica takes the same step, bit for bit;
- the clip's norm counts each logical element once: a leaf's sum of
  squares is summed over the axes it is split on, and the sums are added
  in the leaves' order, as the one-card step adds them;
- every mesh starts from the parameters ``HybridTrainer(mesh=None,
  seed=s)`` draws (each leaf drawn whole on the card, only this rank's
  shard kept), so any mesh reproduces the one-card run;
- ``elastic_state`` returns full numpy arrays (gathered; every rank calls
  it) and ``load_elastic_state`` re-slices them for the current mesh
  (reshard on load).

Over 'pp' (trainer.py:58-70, 104-111, 143-158) each rank holds
num_hidden_layers / pp layers and the loss is models/llama.py::
loss_fn_pipelined: ``place_batch`` splits the batch into
[pipeline_micro_batches, mb, S] (one micro-batch by default: the TPU
package's plain stack placement, one micro-batch through the ring), the
micro-batches go through the stages as a GPipe ring of sends and receives
(with ``overlap_sends``, each tick's micro-batch in halves, the first
half's send behind the second half's compute), the embedding runs on the
first stage and the head on the last. Their gradients, and the final
norm's, exist on one stage only and are summed over the pp group (zeros
elsewhere) after the data ranks' reduction, so that every pp replica takes
the same step; the clip counts them once and sums the blocks' squares over
pp.

Over 'pp' x 'sep' each stage's blocks run the ring inside the pipeline,
whose hops carry [mb, S/sep, hidden] (the reference's GSPMD computes the
same attention over its sequence-sharded activations).

A mesh larger than the initialized world raises, and so do:
``pipeline_micro_batches`` > 1 without a 'pp' axis, num_hidden_layers
that pp does not divide (ValueError, as in the TPU package), and a
sequence that sep does not divide (ValueError at ``place_batch``);
``lower_text`` (there is no HLO) raises naming ROADMAP.md.
``overlap_sends`` without a 'pp' axis does nothing, as in the TPU package.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ...models import llama as llama_mod
from ...ops.kernels import resolve_device
from ...utils.convert import tensor_from_numpy
from ..fleet.layers.mpu.mp_ops import all_reduce_live, gather_along
from ..topology import hcg_for_mesh, mesh_degrees

__all__ = ["HybridTrainer"]

def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A CPU numpy copy; bf16 (which numpy lacks) goes out as f32, which
    the TPU package's load_elastic_state casts back."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy().copy()


class HybridTrainer:
    """AdamW trainer over the stacked Llama core. Usage:

        trainer = HybridTrainer(config)              # one card
        trainer = HybridTrainer(config, mesh)        # each rank of a mesh
        loss = trainer.step(input_ids, labels)       # global batch, in place
    """

    def __init__(self, config, mesh=None, learning_rate=3e-4,
                 weight_decay=0.1, beta1=0.9, beta2=0.95, eps=1e-8,
                 grad_clip_norm: Optional[float] = 1.0, seed: int = 0,
                 remat: bool = True,
                 pipeline_micro_batches: Optional[int] = None,
                 overlap_sends: bool = False, device=None):
        self.config = config
        self.mesh = mesh
        self.hcg = None
        degrees = mesh_degrees(mesh) if mesh is not None else {"pp": 1}
        pp = degrees["pp"]
        self.n_micro = int(pipeline_micro_batches or 1)
        if self.n_micro > 1 and pp <= 1:
            raise ValueError(
                f"pipeline_micro_batches={self.n_micro} requires a mesh "
                f"with a 'pp' axis of size > 1 (got pp={pp})")
        if pp > 1 and config.num_hidden_layers % pp != 0:
            raise ValueError(
                f"num_hidden_layers={config.num_hidden_layers} must divide "
                f"evenly over pp={pp} for the pipeline")
        self.pipelined = pp > 1
        self.overlap_sends = overlap_sends
        if mesh is not None:
            self._check_divides(config, degrees)
            self.hcg = hcg_for_mesh(degrees)
        self.device = resolve_device(device)
        self.lr = learning_rate
        self.wd = weight_decay
        self.betas = (beta1, beta2)
        self.eps = eps
        self.clip = grad_clip_norm
        self.remat = remat
        self.params = llama_mod.init_stacked_params(
            config, seed=seed, device=self.device, hcg=self.hcg)
        for t in llama_mod.leaves(self.params).values():
            t.requires_grad_(True)
        self.opt_state = {
            "m": self._zeros_like_params(), "v": self._zeros_like_params()}
        self.step_count = 0
        self.last_grad_norm = None
        if self.hcg is not None:
            self._specs = llama_mod.leaves(llama_mod.param_specs(config))
            self._data_ranks = (self.hcg.get_data_parallel_world_size()
                                * self.hcg.get_sharding_parallel_world_size())
            self._sep = self.hcg.get_sep_parallel_world_size()
            # the ranks whose losses and gradients make the global mean
            self._mean_ranks = self._data_ranks * self._sep

    @staticmethod
    def _check_divides(config, degrees):
        mp, sh = degrees["mp"], degrees["sharding"]
        need = {"num_attention_heads": mp, "num_key_value_heads": mp,
                "intermediate_size": mp, "vocab_size": mp,
                "hidden_size": sh}
        for name, n in need.items():
            if getattr(config, name) % n:
                raise ValueError(f"{name}={getattr(config, name)} does not "
                                 f"split over {n} ranks of the mesh "
                                 f"{degrees}")

    def _zeros_like_params(self):
        def walk(tree):
            return {k: walk(v) if isinstance(v, dict)
                    else torch.zeros(v.shape, dtype=torch.float32,
                                     device=v.device)
                    for k, v in tree.items()}
        return walk(self.params)

    def _batch(self, x):
        return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x)
                               else x, device=self.device).long()

    def place_batch(self, input_ids, labels):
        """This rank's rows of the global batch (all of it on one card):
        data rank dp_rank * sharding + sharding_rank of dp x sharding, and
        over 'sep' its shard of each row's sequence (sep rank r the
        positions r·S/sep to (r+1)·S/sep - 1). Over 'pp', [n_micro, mb,
        S]: the global batch split into ``pipeline_micro_batches``
        micro-batches, of each this data rank's rows
        (llama.py::microbatch_spec)."""
        ids, labs = self._batch(input_ids), self._batch(labels)
        if self.pipelined:
            b = ids.shape[0]
            if b % self.n_micro:
                raise ValueError(
                    f"batch {b} not divisible by "
                    f"pipeline_micro_batches={self.n_micro}")
            ids = ids.reshape((self.n_micro, b // self.n_micro)
                              + tuple(ids.shape[1:]))
            labs = labs.reshape(ids.shape)
        if self.hcg is None:
            return ids, labs
        n = self._data_ranks
        dim = 1 if self.pipelined else 0
        if ids.shape[dim] % n:
            raise ValueError(f"batch {ids.shape[dim]} does not split over "
                             f"{n} data ranks (dp x sharding)")
        r = (self.hcg.get_data_parallel_rank()
             * self.hcg.get_sharding_parallel_world_size()
             + self.hcg.get_sharding_parallel_rank())
        rows = ids.shape[dim] // n
        ids, labs = (ids.narrow(dim, r * rows, rows),
                     labs.narrow(dim, r * rows, rows))
        if self._sep > 1:
            seq, sep = ids.shape[dim + 1], self._sep
            if seq % sep:
                raise ValueError(f"sequence length {seq} does not split "
                                 f"over sep={sep} ranks")
            part = seq // sep
            start = self.hcg.get_sep_parallel_rank() * part
            ids, labs = (ids.narrow(dim + 1, start, part),
                         labs.narrow(dim + 1, start, part))
        return ids, labs

    def _groups_of(self, name):
        """The groups a leaf's gradient and sum of squares are split over,
        and those its gradient is summed over beyond the FSDP gathers (the
        data ranks and the sep ranks)."""
        spec, hcg = self._specs[name], self.hcg
        split = [hcg.get_group(a) for a in ("pp", "sharding", "mp")
                 if a in spec]
        data = hcg.get_group("dp", "sep") if "sharding" in spec else \
            hcg.get_group("dp", "sharding", "sep")
        return split, data

    def step(self, input_ids, labels):
        """One AdamW step on the global batch; returns its loss (a 0-d f32
        tensor on the device, computed before the update)."""
        ids, labs = self.place_batch(input_ids, labels)
        self.step_count += 1
        names = list(llama_mod.leaves(self.params))
        params = llama_mod.leaves(self.params)
        if self.pipelined:
            loss = llama_mod.loss_fn_pipelined(
                self.params, (ids, labs), self.config, self.mesh,
                remat=self.remat, overlap_sends=self.overlap_sends,
                hcg=self.hcg)
        else:
            loss = llama_mod.loss_fn_stacked(self.params, (ids, labs),
                                             self.config, remat=self.remat,
                                             mesh=self.mesh, hcg=self.hcg)
        # over 'pp' a stage's gradient of the embedding or the head is
        # zero where that stage does not run it
        grads = torch.autograd.grad(loss, [params[n] for n in names],
                                    allow_unused=self.pipelined)
        grads = [torch.zeros(params[n].shape, dtype=torch.float32,
                             device=params[n].device) if g is None
                 else g.float() for n, g in zip(names, grads)]
        loss = loss.detach()
        b1, b2 = self.betas
        with torch.no_grad():
            if self.hcg is not None:
                self._reduce_over_data(names, grads)
                all_reduce_live(loss, self.hcg.get_group("dp", "sharding",
                                                         "sep"))
                if self._mean_ranks > 1:
                    loss /= self._mean_ranks
            if self.clip is not None:
                gnorm = torch.sqrt(sum(self._squares(names, grads)))
                # the global gradient norm before the clip, for callers
                self.last_grad_norm = gnorm
                scale = torch.clamp(
                    self.clip / torch.clamp(gnorm, min=1e-12), max=1.0)
                for g in grads:
                    g.mul_(scale)
            f32 = dict(dtype=torch.float32, device=self.device)
            t = torch.tensor(float(self.step_count), **f32)
            lr = torch.tensor(self.lr, **f32)
            bc1 = 1 - torch.tensor(b1, **f32) ** t
            bc2 = 1 - torch.tensor(b2, **f32) ** t
            m_all = llama_mod.leaves(self.opt_state["m"])
            v_all = llama_mod.leaves(self.opt_state["v"])
            for name, g in zip(names, grads):
                p, m, v = params[name], m_all[name], v_all[name]
                m.mul_(b1).add_((1 - b1) * g)
                v.mul_(b2).add_((1 - b2) * g * g)
                pf = p.float()
                upd = (m / bc1) / (torch.sqrt(v / bc2) + self.eps) \
                    + self.wd * pf
                p.copy_((pf - lr * upd).to(p.dtype))
        return loss

    def _reduce_over_data(self, names, grads):
        """Each gradient summed over the data and sep ranks, then divided
        by their count: the gradient of the global batch's mean loss (each
        sep rank's loss is the mean over its shard of the tokens). Over
        'pp', a leaf that every stage holds whole (the embedding, the final
        norm, the head) is then summed over the pp group: one stage
        computed it, the others add zeros, and every replica gets the same
        bits."""
        pp = self.hcg.get_group("pp") if self.pipelined else None
        for name, g in zip(names, grads):
            all_reduce_live(g, self._groups_of(name)[1])
            if self._mean_ranks > 1:
                g.div_(self._mean_ranks)
            if pp is not None and "pp" not in self._specs[name]:
                all_reduce_live(g, pp)

    def _squares(self, names, grads):
        """Each leaf's sum of squares, summed over the axes it is split
        on: one entry a logical leaf, in the leaves' order."""
        out = []
        for name, g in zip(names, grads):
            sq = g.square().sum()
            if self.hcg is not None:
                for group in self._groups_of(name)[0]:
                    all_reduce_live(sq, group)
            out.append(sq)
        return out

    # -- elastic supervisor wiring ----------------------------------------
    def _full(self, name, t):
        """The whole leaf from every rank's shard (collective)."""
        if self.hcg is None:
            return t
        spec = self._specs[name]
        for axis in ("pp", "sharding", "mp"):
            if axis in spec:
                t = gather_along(t.detach(), self.hcg.get_group(axis),
                                 spec.index(axis))
        return t

    def elastic_state(self) -> Dict[str, np.ndarray]:
        """Flat host-side state (params + Adam moments + step) under the
        TPU package's keys ("p:['blocks']['wq']", ...), full arrays on
        every rank (over a mesh every rank must call it), so either
        package's trainer, on any mesh, loads it."""
        d = {}
        for prefix, tree in (("p:", self.params),
                             ("m:", self.opt_state["m"]),
                             ("v:", self.opt_state["v"])):
            for name, t in llama_mod.leaves(tree).items():
                d[prefix + name] = _to_numpy(self._full(name, t))
        d["step"] = np.asarray(self.step_count, np.int64)
        return d

    def load_elastic_state(self, state: Dict[str, np.ndarray]):
        """Restore from ``elastic_state()`` output of either package, taken
        on any mesh: each full leaf re-sliced for this rank and cast to
        its current dtype on this trainer's device."""
        layout = None if self.hcg is None else self.hcg.layout()
        with torch.no_grad():
            for prefix, tree in (("p:", self.params),
                                 ("m:", self.opt_state["m"]),
                                 ("v:", self.opt_state["v"])):
                for name, t in llama_mod.leaves(tree).items():
                    full = tensor_from_numpy(state[prefix + name])
                    if layout is not None:
                        full = llama_mod.shard_leaf(full, self._specs[name],
                                                    layout)
                    t.copy_(full)
        self.step_count = int(np.asarray(state["step"]))

    def run_elastic(self, batch_fn, num_steps: int, config=None,
                    **overrides):
        """Drive this trainer under the self-healing supervisor:
        `batch_fn(step) -> (input_ids, labels)` must be deterministic in
        `step` so replay after a rollback/recovery converges. Each step
        hands the supervisor ``elastic_state()`` (a full host copy: the
        state a SKIP's ``on_restore`` puts back). Returns the
        supervisor's (final_state, report)."""
        from ..resilience.supervisor import SupervisorConfig, run_elastic

        cfg = config or SupervisorConfig.from_env(**overrides)

        def step_fn(state, step, ctx):
            ids, labels = batch_fn(step)
            loss = self.step(ids, labels)
            return self.elastic_state(), float(loss.detach())

        return run_elastic(step_fn, self.elastic_state(), cfg,
                           num_steps=num_steps,
                           on_restore=self.load_elastic_state,
                           start_step=self.step_count)

    def lower_text(self, batch_shape):
        raise NotImplementedError(
            "paddle_tpu_torch: lower_text belongs to the compile tier; the "
            "eager step has no HLO (ROADMAP.md, queue 1, item 9)")
