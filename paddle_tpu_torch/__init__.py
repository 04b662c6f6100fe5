"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu for NVIDIA Hopper.

A second package beside paddle_tpu (the JAX reference, which it never
imports). Plain tensor code is PyTorch; every Pallas kernel on a ported
path is a CUDA C++ kernel written for sm_90a (ops/kernels/csrc), built at
first use. Entry points run on "cuda" unless the caller passes a device;
device="cpu" runs the kernels' plain PyTorch versions.

Ported so far: the paged-KV serving path (inference.serving, its decode
windows replayed as CUDA graphs), the deploy artifact (inference:
save_inference_model / create_predictor, save_paged_model and
ServingEngine(path_prefix), a torch.export program that reaches the
kernels through registered ops), one Llama training step
(distributed.fleet.HybridTrainer over models.llama), packed-sequence
attention training (incubate.nn.functional.flash_attn_unpadded), and the
eager (dygraph) surface: Tensor over a torch tensor, the op funnel
(core.dispatch.apply) with AMP, nn.Layer, the optimizers, recompute, and
the eager models.llama.LlamaForCausalLM with its training loop and
generate, and hybrid parallelism over torch.distributed (distributed:
collectives, Fleet, the tensor-parallel layers, ZeRO stage 1, and
HybridTrainer over a dp x sharding x mp mesh, one process a card), and
the vision slice: conv, pooling and batch norm (nn.functional and their
Layers; cuDNN's and PyTorch's own ops, none of them a Pallas kernel in the
reference), Momentum with the LR schedulers (optimizer.lr) and the
regularizers, io (datasets, samplers, DataLoader), save / load, metric,
hapi.Model, and vision (the datasets, LeNet, the ResNet family). The
eager surface creates tensors on the default place,
"gpu:0"; ``set_device("cpu")`` selects the CPU.
"""
from .core.autograd import (enable_grad, grad, is_grad_enabled, no_grad,
                            set_grad_enabled)
from .core.dtype import (bfloat16, bool_, complex64, complex128, float16,
                         float32, float64, int8, int16, int32, int64, uint8)
from .core.dispatch import set_flags
from .core.place import CPUPlace, CUDAPlace, Place, get_device, set_device
from .core.tensor import Parameter, Tensor
from .ops import *  # noqa: F401,F403
from . import (amp, distributed, framework, hapi, incubate, inference, io,
               jit, metric, models, nn, ops, optimizer, profiler,
               regularizer, utils, vision)
from .framework.io import async_save, clear_async_save_task_queue, load, save
from .framework.random import get_rng_state, seed, set_rng_state
from .hapi import callbacks
from .hapi.model import Model
from .ops.kernels import launch_counts, reset_launch_counts, resolve_device

bool = bool_  # paddle.bool

__version__ = "0.1.0"
