"""Inference: the deploy artifact and its predictor, and the serving engine.

Port of paddle_tpu/inference/__init__.py (:36-347; reference: Paddle
Inference's ``Config`` / ``create_predictor`` and
``paddle.static.save_inference_model``). The artifact keeps the
reference's three files and their keys:

- ``<prefix>.pdmodel``: a ``torch.export`` program over FLAT parameter and
  buffer lists, then the inputs (``torch.func.functional_call``, as the
  reference's ``pure`` exports over flat lists), so the weights stay outside
  the program and a weight version can feed it. The port's kernels appear
  in it as the registered ops ``paddle_tpu_torch::rms_norm``,
  ``::rope_append`` and ``::paged_attention``;
- ``<prefix>.pdiparams.npz``: the flat arrays (bfloat16, which numpy
  lacks, as uint8 bytes with its dtype and shape in the signature);
- ``<prefix>.pdconfig``: the JSON signature (input names, shapes, dtypes,
  output names, precision, counts).

A process that never imports the model's class loads the artifact and
serves from it. ``load_inference_model`` moves the program to the serving
device (``move_to_device_pass``), so an artifact saved on the CPU serves on
the card, as the reference's exports for ("cpu", "tpu") do. Entry points
run on "cuda" unless the caller asks for the CPU (``Config.disable_gpu``).
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..ops.kernels import resolve_device

__all__ = ["Config", "Predictor", "PrecisionType", "create_predictor",
           "save_inference_model", "load_inference_model", "Tensor"]


class PrecisionType:
    Float32 = "float32"
    Half = "float16"
    Bfloat16 = "bfloat16"
    Int8 = "int8"      # accepted; weights and inputs stay as they are


class Config:
    """reference: paddle.inference.Config (AnalysisConfig). Selects the
    card (``"cuda"``, device 0) unless ``disable_gpu()`` is called."""

    def __init__(self, model_path: Optional[str] = None,
                 params_path: Optional[str] = None):
        self._model_path = model_path
        self._params_path = params_path
        self._device = "cuda"
        self._device_id = 0
        self._precision = PrecisionType.Float32
        self._ir_optim = True
        self._memory_optim = True
        self._profile = False
        self._threads = 1

    def set_model(self, model_path: str, params_path: Optional[str] = None):
        self._model_path = model_path
        self._params_path = params_path

    def model_path(self):
        return self._model_path

    # -- device selection (reference enable_use_gpu/disable_gpu) ----------
    def enable_use_gpu(self, memory_pool_init_size_mb: int = 0,
                       device_id: int = 0, precision=None):
        self._device = "cuda"
        self._device_id = device_id
        if precision is not None:
            self._precision = precision

    def enable_use_tpu(self, device_id: int = 0):
        """The TPU package's name for selecting the accelerator: the card
        here."""
        self.enable_use_gpu(device_id=device_id)

    def disable_gpu(self):
        self._device = "cpu"

    def use_gpu(self):
        return self._device != "cpu"

    def _torch_device(self) -> torch.device:
        """The device a predictor of this config runs on (raises where
        CUDA is selected and there is none); a device id past the last
        card selects the last, as the reference clamps it."""
        if self._device == "cpu":
            return resolve_device("cpu")
        resolve_device("cuda")
        return torch.device(
            "cuda", min(self._device_id, torch.cuda.device_count() - 1))

    def set_cpu_math_library_num_threads(self, n: int):
        self._threads = n

    # -- optimization switches: recorded, as the reference's are on a TPU
    def switch_ir_optim(self, on: bool = True):
        self._ir_optim = on

    def enable_memory_optim(self, on: bool = True):
        self._memory_optim = on

    def enable_profile(self):
        self._profile = True

    def set_precision(self, precision: str):
        self._precision = precision

    def enable_tensorrt_engine(self, workspace_size=1 << 30,
                               max_batch_size=1, min_subgraph_size=3,
                               precision_mode=None, use_static=False,
                               use_calib_mode=False):
        """Accepted for scripts written against Paddle Inference; only the
        precision request is recorded."""
        if precision_mode is not None:
            self._precision = precision_mode

    def summary(self):
        return json.dumps({
            "model": self._model_path, "device": self._device,
            "precision": self._precision, "ir_optim": self._ir_optim,
            "memory_optim": self._memory_optim}, indent=2)


class Tensor:
    """Named zero-copy handle (reference: ZeroCopyTensor, paddle_api.h):
    ``copy_from_cpu`` stages an input on the predictor's device,
    ``copy_to_cpu`` fetches."""

    def __init__(self, name: str, predictor: "Predictor", is_input: bool):
        self.name = name
        self._pred = predictor
        self._is_input = is_input

    def copy_from_cpu(self, arr: np.ndarray):
        if not self._is_input:
            raise RuntimeError(f"{self.name} is an output handle")
        self._pred._inputs[self.name] = self._pred._stage(arr)

    def reshape(self, shape):      # reference API; shapes come from data
        pass

    def copy_to_cpu(self) -> np.ndarray:
        store = self._pred._inputs if self._is_input \
            else self._pred._outputs
        return store[self.name].cpu().numpy()

    def shape(self):
        store = self._pred._inputs if self._is_input \
            else self._pred._outputs
        return list(store[self.name].shape)


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _torch_dtype(name: str) -> torch.dtype:
    dt = getattr(torch, _dtype_name(name), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


class _Program(nn.Module):
    """What is exported: ``layer``'s forward as a function of its flat
    parameters, its flat buffers and the inputs (the reference's ``pure``,
    inference/__init__.py:181-192). ``layer`` is held outside the module
    tree, so its weights are inputs of the program and not its state."""

    def __init__(self, layer, p_names, b_names, cast):
        super().__init__()
        self.__dict__["_layer"] = layer
        self._names = (list(p_names), list(b_names))
        self._cast = cast

    def forward(self, flat_p, flat_b, *ins):
        if self._cast is not None:
            ins = tuple(x.to(self._cast) if x.is_floating_point() else x
                        for x in ins)
        state = dict(zip(self._names[0], flat_p))
        state.update(zip(self._names[1], flat_b))
        out = torch.func.functional_call(self._layer, state, ins)
        outs = out if isinstance(out, (list, tuple)) else (out,)
        # float outputs come back as f32 (the deploy contract), except an
        # input the layer updated in place and returned (the serving
        # step's KV pools): the reference casts those to f32 and back, a
        # lossless round trip XLA elides; here it would copy both pools
        # every step, so they are returned as they are
        return tuple(o if not o.is_floating_point()
                     or any(o is x for x in ins) else o.float()
                     for o in outs)


def save_inference_model(path_prefix: str, layer, input_spec,
                         precision: str = PrecisionType.Float32,
                         input_names: Optional[Sequence[str]] = None,
                         output_names: Optional[Sequence[str]] = None):
    """Serialize ``layer`` for serving (reference:
    paddle.static.save_inference_model / the jit.save deploy path).

    ``input_spec`` is a list of ``jit.InputSpec``; a ``None`` dim exports
    as a ``torch.export.Dim``, one Dim shared by every input at the same
    axis position (the reference's dynamic batch), traced at an example
    size of 2 (``torch.export`` specializes sizes 0 and 1).
    ``PrecisionType.Bfloat16`` / ``Half`` cast the floating parameters and
    inputs; float outputs come back as f32. The program is traced on the
    device ``layer``'s parameters live on, in eval mode. Writes the three
    files of the module docstring; returns ``path_prefix``."""
    lowp = precision in (PrecisionType.Bfloat16, PrecisionType.Half)
    cast = (torch.bfloat16 if precision == PrecisionType.Bfloat16
            else torch.float16) if lowp else None
    named_p = dict(layer.named_parameters())
    named_b = dict(layer.named_buffers())
    p_names, b_names = sorted(named_p), sorted(named_b)
    flat_p = [named_p[n].detach() for n in p_names]
    if lowp:
        flat_p = [t.to(cast) if t.is_floating_point() else t
                  for t in flat_p]
    flat_b = [named_b[n].detach() for n in b_names]
    dev = next((t.device for t in flat_p + flat_b), torch.device("cpu"))
    examples, dims, dyn = [], {}, []
    for s in input_spec:
        shape = tuple(s.shape)
        examples.append(torch.zeros(tuple(2 if d is None else d
                                          for d in shape),
                                    dtype=_torch_dtype(s.dtype), device=dev))
        dyn.append({j: dims.setdefault(j, torch.export.Dim(f"d{j}"))
                    for j, d in enumerate(shape) if d is None})
    dynamic = None
    if dims:
        dynamic = ([None] * len(flat_p), [None] * len(flat_b),
                   tuple(d or None for d in dyn))
    was_training = layer.training
    layer.eval()
    try:
        program = torch.export.export(
            _Program(layer, p_names, b_names, cast),
            (flat_p, flat_b, *examples), dynamic_shapes=dynamic,
            strict=False)
    finally:
        layer.train(was_training)
    # the traced example inputs would be saved with the program: the
    # weights a second time, and zeroed buffers as large as the KV pools
    program.example_inputs = None
    with open(path_prefix + ".pdmodel", "wb") as f:
        torch.export.save(program, f)

    arrays, meta = {}, {}
    for key, t in [(f"p{i}", t) for i, t in enumerate(flat_p)] + \
                  [(f"b{i}", t) for i, t in enumerate(flat_b)]:
        t = t.contiguous().cpu()
        if t.dtype is torch.bfloat16:
            arrays[key] = t.reshape(-1).view(torch.uint8).numpy()
            meta[key] = {"dtype": "bfloat16", "shape": list(t.shape)}
        else:
            arrays[key] = t.numpy()
    np.savez(path_prefix + ".pdiparams", **arrays)

    in_names = list(input_names or
                    [getattr(s, "name", None) or f"x{i}"
                     for i, s in enumerate(input_spec)])
    sig = {
        "inputs": [{"name": n, "shape": list(s.shape),
                    "dtype": _dtype_name(s.dtype)}
                   for n, s in zip(in_names, input_spec)],
        "output_names": list(output_names or []),
        "precision": precision,
        "n_params": len(flat_p), "n_buffers": len(flat_b),
        "array_meta": meta,
    }
    with open(path_prefix + ".pdconfig", "w") as f:
        json.dump(sig, f)
    return path_prefix


def load_inference_model(path_prefix: str, device=None):
    """Load the serving artifact on ``device`` (None means "cuda"): returns
    (program, params, buffers, sig). ``program(params, buffers, *inputs)``
    runs the exported step, moved to ``device``; params and buffers are
    the flat tensors on ``device``; sig is the JSON signature."""
    from torch.export.passes import move_to_device_pass

    # the ops an exported serving step calls are registered when their
    # modules are imported
    from ..ops.kernels import (paged_attention, rms_norm,  # noqa: F401
                               rope_append)

    dev = resolve_device(device)
    with open(path_prefix + ".pdmodel", "rb") as f:
        program = move_to_device_pass(torch.export.load(f), dev)
    with open(path_prefix + ".pdconfig") as f:
        sig = json.load(f)
    meta = sig.get("array_meta", {})
    with np.load(path_prefix + ".pdiparams.npz") as data:
        def unpack(key):
            a = data[key]
            m = meta.get(key)
            t = torch.from_numpy(np.ascontiguousarray(a))
            if m is not None:
                t = t.view(_torch_dtype(m["dtype"])).reshape(m["shape"])
            return t.to(dev)

        params = [unpack(f"p{i}") for i in range(sig["n_params"])]
        buffers = [unpack(f"b{i}") for i in range(sig["n_buffers"])]
    return program.module(), params, buffers, sig


class Predictor:
    """reference: paddle.inference.Predictor (AnalysisPredictor). Runs the
    exported program on the configured device; the weights are placed there
    once."""

    def __init__(self, config: Config):
        self.config = config
        self._device = config._torch_device()
        program, params, buffers, sig = load_inference_model(
            config._model_path, self._device)
        self._program = program
        self._params = params
        self._buffers = buffers
        self._sig = sig
        self._in_names = [i["name"] for i in sig["inputs"]]
        self._out_names: List[str] = list(sig["output_names"])
        self._inputs: Dict[str, torch.Tensor] = {}
        self._outputs: Dict[str, torch.Tensor] = {}

    # -- handle API (reference get_input_handle / zero-copy) -------------
    def get_input_names(self):
        return list(self._in_names)

    def get_output_names(self):
        if not self._out_names:
            return [f"out{i}" for i in range(len(self._outputs))] \
                if self._outputs else ["out0"]
        return list(self._out_names)

    def get_input_handle(self, name: str) -> Tensor:
        return Tensor(name, self, is_input=True)

    def get_output_handle(self, name: str) -> Tensor:
        return Tensor(name, self, is_input=False)

    def _stage(self, arr):
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self._device)

    # -- execution ---------------------------------------------------------
    def run(self, inputs: Optional[Sequence[np.ndarray]] = None):
        """Modern API: run(list_of_arrays) -> list of numpy arrays.
        Handle API: stage via copy_from_cpu, then run() -> True."""
        if inputs is not None:
            arrays = [self._stage(a) for a in inputs]
        else:
            arrays = [self._inputs[n] for n in self._in_names]
        with torch.inference_mode():
            outs = self._program(self._params, self._buffers, *arrays)
        outs = outs if isinstance(outs, (list, tuple)) else (outs,)
        names = self._out_names or [f"out{i}" for i in range(len(outs))]
        self._out_names = names
        self._outputs = dict(zip(names, outs))
        if inputs is not None:
            return [o.cpu().numpy() for o in outs]
        return True


def create_predictor(config: Config) -> Predictor:
    """reference: paddle.inference.create_predictor."""
    return Predictor(config)


# the serving engine (after the deploy surface: save_paged_model and the
# artifact engine use it)
from .prefix_cache import PrefixCache  # noqa: E402
from .serving import (EngineOverloadedError, PagedCausalLM,  # noqa: E402
                      PagedServingConfig, SamplingParams, ServingEngine,
                      resolve_backend_device, sample_logits, sampling_salt,
                      save_paged_model)
from .speculative import DraftModelDrafter, Drafter, NGramDrafter  # noqa
from .weight_publish import build_weight_set  # noqa: E402
from .weight_stream import WeightStreamer, measure_stream_win  # noqa: E402

__all__ += ["EngineOverloadedError", "PagedCausalLM", "PagedServingConfig",
            "SamplingParams", "ServingEngine", "sample_logits",
            "sampling_salt", "save_paged_model", "resolve_backend_device",
            "PrefixCache", "Drafter", "NGramDrafter", "DraftModelDrafter",
            "WeightStreamer", "measure_stream_win", "build_weight_set"]

# the fleet serving tier, loaded at first use (inference/__init__.py:
# 350-390 of the reference): disaggregation, the router, the supervisor,
# the publisher, the gateway, the autoscaler and process-isolated replicas
_FLEET_EXPORTS = {
    "PrefillWorker": "disagg", "DecodeWorker": "disagg",
    "migrate_request": "disagg", "receive_request": "disagg",
    "Replica": "router", "ReplicaRouter": "router",
    "FleetSupervisor": "fleet_supervisor",
    "FleetSupervisorConfig": "fleet_supervisor",
    "LoopbackTransport": "fleet_supervisor",
    "AutoScaler": "autoscaler", "AutoScalerConfig": "autoscaler",
    "ReplicaFactory": "autoscaler",
    "InProcessReplicaFactory": "autoscaler",
    "WeightPublisher": "weight_publish",
    "PublishPolicy": "weight_publish",
    "PublishReport": "weight_publish",
    "send_weight_set": "weight_publish",
    "receive_weight_set": "weight_publish",
    "FleetGateway": "gateway", "GatewayConfig": "gateway",
    "SLOClassConfig": "gateway", "TenantConfig": "gateway",
    "BrownoutConfig": "gateway", "BrownoutController": "gateway",
    "TokenBucket": "gateway", "RetryBudget": "gateway",
    "RemoteEngine": "remote_replica", "RemoteReplica": "remote_replica",
    "SubprocessReplicaFactory": "remote_replica",
}


def __getattr__(name):
    mod = _FLEET_EXPORTS.get(name)
    if mod is None:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module("." + mod, __name__), name)


__all__ += sorted(_FLEET_EXPORTS)
