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
(distributed.fleet.HybridTrainer over models.llama) and packed-sequence
attention training (incubate.nn.functional.flash_attn_unpadded).
"""
from . import distributed, incubate, inference, jit, models, nn, ops, utils
from .ops.kernels import launch_counts, reset_launch_counts, resolve_device

__version__ = "0.1.0"

__all__ = ["distributed", "incubate", "inference", "jit", "models", "nn",
           "ops", "utils", "launch_counts",
           "reset_launch_counts", "resolve_device"]
