"""Carry the TPU package's weights into the port.

The TPU package names parameters by ``jit/functional.py:84-85``
(``current_params``: ``named_parameters`` of the layer). The serving model
has the same module tree in both packages, so the names carry over as
they are, and Linear weights keep the [in, out] layout of ``x @ w``: no
transpose.
"""
from __future__ import annotations

import re

import numpy as np
import torch

__all__ = ["params_from_paddle_tpu", "stacked_params_from_paddle_tpu",
           "load_params_from_paddle_tpu", "state_dict_from_paddle_tpu",
           "stage_state_dict_from_paddle_tpu"]

# parameter names of PagedCausalLM in both packages
_SERVING_NAMES = re.compile(
    r"(embed|ln_f|head)\.weight"
    r"|(ln1|qkv|proj|ln2|gate_up|down)\.\d+\.weight")


def tensor_from_numpy(arr) -> torch.Tensor:
    """numpy (or array-like) -> a CPU tensor of the same dtype; bf16,
    which numpy lacks, goes through f32 (exact)."""
    a = np.asarray(arr)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def _layout(mesh):
    from ..distributed.topology import rank_layout

    return rank_layout(mesh)


def stacked_params_from_paddle_tpu(tree, mesh=None) -> dict:
    """The TPU package's stacked Llama pytree (models/llama.py::
    init_stacked_params; nested dicts of arrays, e.g. after
    ``jax.tree.map(np.asarray, params)``) -> the same nesting of CPU
    tensors, dtype kept, for paddle_tpu_torch.models.llama. With ``mesh``
    (a HybridCommunicateGroup, or a mesh: a Mesh or a dict of axis sizes,
    read at this process's rank) each leaf is this rank's shard
    (models/llama.py::param_specs): over 'pp' the blocks' stack axis holds
    this stage's num_hidden_layers / pp layers."""
    from ..models import llama

    if mesh is None:
        return {k: stacked_params_from_paddle_tpu(v) if isinstance(v, dict)
                else tensor_from_numpy(v) for k, v in tree.items()}
    layout, specs = _layout(mesh), llama.param_specs(llama.LlamaConfig())

    def walk(sub, spec):
        return {k: walk(v, spec[k]) if isinstance(v, dict) else
                llama.shard_leaf(tensor_from_numpy(v), spec[k], layout)
                for k, v in sub.items()}
    return walk(tree, specs)


def load_params_from_paddle_tpu(module, named):
    """Copy the TPU package's parameters (``{name: numpy array}``, names as
    ``current_params`` or ``named_parameters`` give them) into ``module``'s
    parameters of the same names, in place; the names and shapes must
    match. ``module`` is a torch module or an eager Layer (the GPT and BERT
    models carry over so: both packages name their parameters alike and
    keep Linear weights [in, out]). An eager parameter placed by
    ``distributed.shard_tensor`` (a DTensor value) takes this rank's shard
    of the full array, every rank passing the same state (auto-parallel:
    the CPU tests load the reference's weights so). Returns ``module``."""
    own = dict(module.named_parameters())
    if set(named) != set(own):
        raise KeyError(f"parameter names differ: missing "
                       f"{sorted(set(own) - set(named))}, unexpected "
                       f"{sorted(set(named) - set(own))}")
    with torch.no_grad():
        for name, p in own.items():
            src = tensor_from_numpy(named[name])
            if tuple(src.shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {tuple(src.shape)} != "
                                 f"{tuple(p.shape)}")
            p.copy_(src)
    return module


def params_from_paddle_tpu(named, mesh=None) -> dict:
    """{name: numpy array} from the TPU package (e.g.
    ``{k: np.asarray(v) for k, v in current_params(model).items()}``) ->
    {name: torch.Tensor} on the CPU, dtype kept (bf16 goes through f32).
    With ``mesh`` (a HybridCommunicateGroup or a mesh), this rank's
    arrays: the serving model has no model-parallel layers, so each rank
    of a data-parallel mesh holds them all, and an mp degree above 1
    raises."""
    if mesh is not None and _layout(mesh).degrees["mp"] > 1:
        raise NotImplementedError(
            "paddle_tpu_torch: the serving model under mp is not ported "
            "(ROADMAP.md, queue 1, item 5)")
    out = {}
    for name, arr in named.items():
        if not _SERVING_NAMES.fullmatch(name):
            raise KeyError(f"{name!r} is not a parameter name of the "
                           f"serving model")
        out[name] = tensor_from_numpy(arr)
    return out


# the eager Llama's tensor-parallel weights: the axis of the full array
# that 'mp' splits (mp_layers.py: column layers split the outputs, row
# layers the inputs, the embedding the vocabulary)
_EAGER_MP_AXIS = (
    (re.compile(r".*\.(q_proj|k_proj|v_proj|gate_proj|up_proj)\.weight"), 1),
    (re.compile(r".*\.(o_proj|down_proj)\.weight"), 0),
    (re.compile(r"(.*\.)?embed_tokens\.weight"), 0))


def state_dict_from_paddle_tpu(state, mesh=None) -> dict:
    """An eager Layer's ``state_dict()`` from the TPU package, as numpy
    arrays under Paddle's structured names (e.g.
    ``{k: np.asarray(v) for k, v in layer.state_dict().items()}``: names
    such as ``model.layers.0.self_attn.q_proj.weight``) -> {name: CPU
    tensor}, which the port's ``Layer.set_state_dict`` takes. Dtypes are
    kept (bf16 goes through f32, exactly); Linear weights keep the [in,
    out] layout. With ``mesh`` (a HybridCommunicateGroup or a mesh) and an
    mp degree above 1, the eager Llama's tensor-parallel weights are this
    rank's slices, as its mp layers hold them."""
    out = {name: tensor_from_numpy(arr) for name, arr in state.items()}
    if mesh is None:
        return out
    layout = _layout(mesh)
    n, r = layout.degrees["mp"], layout.coords["mp"]
    if n == 1:
        return out
    for name, t in out.items():
        for pattern, axis in _EAGER_MP_AXIS:
            if pattern.fullmatch(name):
                out[name] = t.chunk(n, dim=axis)[r].contiguous()
                break
    return out


def stage_state_dict_from_paddle_tpu(state, layer, mesh=None) -> dict:
    """The TPU package's whole-model ``state_dict()`` of a PipelineLayer
    (numpy arrays, names ``layers_list.<i>.<...>``) -> the entries of the
    stage that the port's PipelineLayer ``layer`` holds on this rank, under
    the same global names, as ``state_dict_from_paddle_tpu`` converts them
    (with ``mesh``, the eager Llama's tensor-parallel weights as this
    rank's slices). ``layer.set_state_dict`` takes the result with nothing
    missing or unexpected."""
    own = set(layer.state_dict())
    return state_dict_from_paddle_tpu(
        {k: v for k, v in state.items() if k in own}, mesh)
