"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain versions.

Counterpart of paddle_tpu/ops/pallas/: every Pallas kernel on a ported path
becomes a CUDA C++ kernel under ``csrc/``, built by ``_build.py`` into one
shared library at first use and bound with ctypes. Each kernel module keeps
a plain PyTorch version of the same function beside the wrapper. The
wrapper takes the plain version only for a tensor that lies on the CPU; for
a CUDA tensor it launches the kernel or raises.

Each kernel module counts the launches of each of its kernels in a
module-level integer (``launches``, or one ``launches_*`` a kernel where a
module holds several); ``launch_counts()`` reads them all and
``reset_launch_counts()`` sets them to 0. Beside them,
``aligned16_copies`` counts the inputs the wrappers copied to a 16-byte
boundary (``_build.aligned16``). The wrappers count in Python, which a
CUDA graph's replay does not run: the serving decode window records what
its graph's capture counted and adds it back on every replay
(``add_launch_counts``).
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device", "launch_counts", "reset_launch_counts",
           "add_launch_counts"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on. ``None`` means ``"cuda"``; a
    CUDA device with no CUDA runtime raises instead of dropping to the
    CPU. Pass ``device="cpu"`` to run the plain PyTorch versions."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "paddle_tpu_torch: device=%r needs CUDA, but "
                "torch.cuda.is_available() is False (device=None means "
                "'cuda'); pass device='cpu' to run the plain PyTorch path"
                % (device,))
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"paddle_tpu_torch runs on 'cuda' or 'cpu', "
                         f"not {dev.type!r}")
    return dev


def _counters():
    """{kernel name: (module, name of its launch counter)}."""
    from . import (_build, flash_attention, kv_quant, paged_attention,
                   rms_norm, rope_append, varlen_attention, weight_dequant)

    return {"rms_norm": (rms_norm, "launches"),
            "rms_norm_bwd": (rms_norm, "launches_bwd"),
            "varlen_attention_fwd": (varlen_attention, "launches"),
            "varlen_attention_bwd_dkv": (varlen_attention,
                                         "launches_bwd_dkv"),
            "varlen_attention_bwd_dq": (varlen_attention, "launches_bwd_dq"),
            "flash_attention_fwd": (flash_attention, "launches_fwd"),
            "flash_attention_bwd_dkv": (flash_attention, "launches_bwd_dkv"),
            "flash_attention_bwd_dq": (flash_attention, "launches_bwd_dq"),
            "paged_attention": (paged_attention, "launches"),
            "paged_attention_int8": (paged_attention, "launches_int8"),
            "kv_quant": (kv_quant, "launches"),
            "rope_append": (rope_append, "launches"),
            "weight_dequant": (weight_dequant, "launches"),
            "aligned16_copies": (_build, "copies")}


def launch_counts() -> dict:
    """{kernel name: kernel launches since the last reset}, and
    ``aligned16_copies``."""
    return {name: getattr(mod, attr)
            for name, (mod, attr) in _counters().items()}


def reset_launch_counts():
    """Set every count to 0, and forget the paged-attention and RoPE-append
    wrappers' last validated steps (the next calls are checked in full)."""
    from . import paged_attention, rope_append

    for mod, attr in _counters().values():
        setattr(mod, attr, 0)
    paged_attention._step = None
    rope_append._step = None


def add_launch_counts(counts: dict, times: int = 1):
    """Add ``times`` x ``counts`` ({kernel name: launches}, as
    ``launch_counts`` gives them) to the counters."""
    table = _counters()
    for name, n in counts.items():
        mod, attr = table[name]
        setattr(mod, attr, getattr(mod, attr) + times * n)
