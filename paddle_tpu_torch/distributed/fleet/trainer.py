"""AdamW trainer over the stacked Llama core, on one device
(paddle_tpu/distributed/fleet/trainer.py:34-220).

The TPU package compiles the whole step into one XLA program over a hybrid
mesh. Here the step runs eagerly on one card: the loss and its gradient
through models/llama.py (the flash-attention and RMSNorm kernels on a
card), then the global-norm clip and AdamW exactly as the TPU package
writes them: f32 moments, bias correction by the step count t, weight
decay on every leaf, the update computed in f32 and cast back to the
parameter's dtype. Parameters and moments are updated in place (the TPU
package donates its buffers to the same end). A mesh of more than one
device raises: the hybrid-parallel layouts are not ported yet.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

from ...models import llama as llama_mod
from ...ops.kernels import resolve_device
from ...utils.convert import tensor_from_numpy

__all__ = ["HybridTrainer"]


def _mesh_size(mesh) -> int:
    shape = getattr(mesh, "shape", mesh)
    return math.prod(int(n) for n in dict(shape).values())


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A CPU numpy copy; bf16 (which numpy lacks) goes out as f32, which
    the TPU package's load_elastic_state casts back."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy().copy()


class HybridTrainer:
    """AdamW trainer over the stacked Llama core. Usage:

        trainer = HybridTrainer(config)              # device "cuda"
        loss = trainer.step(input_ids, labels)       # one step, in place
    """

    def __init__(self, config, mesh=None, learning_rate=3e-4,
                 weight_decay=0.1, beta1=0.9, beta2=0.95, eps=1e-8,
                 grad_clip_norm: Optional[float] = 1.0, seed: int = 0,
                 remat: bool = True, device=None):
        if mesh is not None and _mesh_size(mesh) > 1:
            raise NotImplementedError(
                "paddle_tpu_torch: HybridTrainer runs on one device; a mesh "
                "of more than one device is not ported yet")
        self.config = config
        self.mesh = mesh
        self.device = resolve_device(device)
        self.lr = learning_rate
        self.wd = weight_decay
        self.betas = (beta1, beta2)
        self.eps = eps
        self.clip = grad_clip_norm
        self.remat = remat
        self.params = llama_mod.init_stacked_params(config, seed=seed,
                                                    device=self.device)
        for t in llama_mod.leaves(self.params).values():
            t.requires_grad_(True)
        self.opt_state = {
            "m": self._zeros_like_params(), "v": self._zeros_like_params()}
        self.step_count = 0

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

    def step(self, input_ids, labels):
        """One AdamW step; returns the loss (a 0-d f32 tensor on the
        device, computed before the update)."""
        ids, labs = self._batch(input_ids), self._batch(labels)
        self.step_count += 1
        names = list(llama_mod.leaves(self.params))
        params = llama_mod.leaves(self.params)
        loss = llama_mod.loss_fn_stacked(self.params, (ids, labs),
                                         self.config, remat=self.remat,
                                         mesh=self.mesh)
        grads = torch.autograd.grad(loss, [params[n] for n in names])
        grads = [g.float() for g in grads]
        b1, b2 = self.betas
        with torch.no_grad():
            if self.clip is not None:
                gnorm = torch.sqrt(sum(g.square().sum() for g in grads))
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
        return loss.detach()

    # -- elastic supervisor wiring ----------------------------------------
    def elastic_state(self) -> Dict[str, np.ndarray]:
        """Flat host-side state (params + Adam moments + step) under the
        TPU package's keys ("p:['blocks']['wq']", ...), so either trainer
        loads the other's."""
        d = {}
        for prefix, tree in (("p:", self.params),
                             ("m:", self.opt_state["m"]),
                             ("v:", self.opt_state["v"])):
            for name, t in llama_mod.leaves(tree).items():
                d[prefix + name] = _to_numpy(t)
        d["step"] = np.asarray(self.step_count, np.int64)
        return d

    def load_elastic_state(self, state: Dict[str, np.ndarray]):
        """Restore from ``elastic_state()`` output of either package, each
        leaf cast to its current dtype on this trainer's device."""
        with torch.no_grad():
            for prefix, tree in (("p:", self.params),
                                 ("m:", self.opt_state["m"]),
                                 ("v:", self.opt_state["v"])):
                for name, t in llama_mod.leaves(tree).items():
                    t.copy_(tensor_from_numpy(state[prefix + name]))
        self.step_count = int(np.asarray(state["step"]))
