"""Where an RMSNorm call of the port spends its time on one card.

    python3 tools/torch_rms_norm_probe.py        (needs one CUDA card)

Prints JSON lines, each with the card's name:
- "bwd": at the training shape (x and g [16384, 2048] bf16, weight [2048]
  f32), the ms a call (CUDA events, chip_smoke.time_ms) and, under
  torch.profiler, the device kernels a call launches and their device ms,
  of: the plain gradient `_rms_norm_bwd`; the gradient kernel (where the
  module has one), also with its grid at 132, 264, 528 and 1056 blocks
  beside the wrapper's BWD_BLOCKS, timed in turns; `torch.autograd.grad` through
  `F.rms_norm` (the backward alone, the graph kept); beside them
  `F.rms_norm`'s forward at that shape.
- "host": the host's nanoseconds a call (time.perf_counter_ns over 10,000
  calls, synchronised before and after) of each piece of the wrapper's
  forward at x [256, 2048] bf16 with a bf16 weight, of the whole call
  through each layer above it (ops.kernels.rms_norm.rms_norm,
  nn.functional.rms_norm, nn.RMSNorm under inference_mode, as serving
  calls it), and of `F.rms_norm` beside them; "after-kernel-phase" runs
  chip_smoke.py's first two phases in the process first.
- "fwd": the forward kernel's device time (torch.profiler) at x [8, 2048],
  [256, 2048] and [16384, 2048] bf16 with a bf16 weight, and at
  [16384, 2048] with an f32 weight.
- "train-profile": chip_smoke.py's flagship training step (batch 4, seq
  4096, random weights): one warm-up, the median of 3 timed steps, peak
  memory, then one step under torch.profiler with its kernels summed by
  kind (elementwise, copy, reduce, RMSNorm, other): launches and device ms.

With PROBE_ROOT=DIR in the environment, paddle_tpu_torch (and chip_smoke)
are imported from DIR, another commit's tree unpacked by `git archive`:
"fwd" and "train-profile" then measure that commit in the same call.
"""
import ctypes
import json
import os
import sys
import time

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.abspath(os.environ.get("PROBE_ROOT", HERE))
sys.path.insert(0, ROOT)

from chip_smoke import time_ms  # noqa: E402
from paddle_tpu_torch.ops.kernels import _build  # noqa: E402
from paddle_tpu_torch.ops.kernels import rms_norm as RN  # noqa: E402

N_HOST = 10_000


def device_kernels(fn, calls=10):
    """(kernel launches a call, device ms a call, {kernel: [launches a
    call, device ms a call]}) under torch.profiler."""
    from chip_smoke import profile_kernels

    fn()
    torch.cuda.synchronize()
    prof = profile_kernels(fn, calls)
    return (sum(n for n, _ in prof.values()) / calls,
            sum(us for _, us in prof.values()) / calls / 1e3,
            {k[:70]: [n / calls, us / calls / 1e3]
             for k, (n, us) in prof.items()})


def probe_bwd(dev, card):
    gen = torch.Generator(device=dev).manual_seed(0)
    rows, h, eps = 16384, 2048, 1e-5
    x = (torch.randn(rows, h, device=dev, generator=gen) * 3) \
        .to(torch.bfloat16)
    g = torch.randn(rows, h, device=dev, generator=gen).to(torch.bfloat16)
    w = torch.randn(h, device=dev, generator=gen)
    out = {"device": card, "shape": f"x, g [{rows}, {h}] bf16, w [{h}] f32"}
    port_bwd = getattr(RN, "_launch_bwd", None)
    runs = {"plain _rms_norm_bwd": lambda: RN._rms_norm_bwd(x, w, eps, g)}
    if port_bwd is not None:
        runs["kernel"] = lambda: port_bwd(x, w, eps, g)

        def with_blocks(n):
            def run():
                keep, RN.BWD_BLOCKS = RN.BWD_BLOCKS, n
                try:
                    return port_bwd(x, w, eps, g)
                finally:
                    RN.BWD_BLOCKS = keep
            return run

        grids = tuple(dict.fromkeys((RN.BWD_BLOCKS, 132, 264, 528, 1056)))
        ref = port_bwd(x, w, eps, g)
        for n in grids:
            got = with_blocks(n)()
            torch.cuda.synchronize()
            out[f"kernel, {n} blocks: gx equal, gw max abs diff"] = (
                bool(torch.equal(got[0], ref[0])),
                float((got[1] - ref[1]).abs().max()))
        turns = {n: [] for n in grids}
        for n in grids + grids[::-1]:
            turns[n].append(time_ms(with_blocks(n), calls=20, windows=5))
        out["kernel ms by grid, in turns"] = turns
    xl = x.detach().requires_grad_(True)
    wl = w.detach().requires_grad_(True)
    y = torch.nn.functional.rms_norm(xl, (h,), wl, eps)
    runs["torch.autograd.grad(F.rms_norm)"] = lambda: torch.autograd.grad(
        y, (xl, wl), g, retain_graph=True)
    runs["F.rms_norm forward"] = lambda: torch.nn.functional.rms_norm(
        x, (h,), w, eps)
    # all timings first: a profiler run slows later host work
    for name, fn in runs.items():
        out[name] = {"ms": time_ms(fn, calls=20, windows=5)}
    for name, fn in runs.items():
        launches, dev_ms, names = device_kernels(fn)
        out[name].update(device_launches=launches, device_ms=dev_ms,
                         kernels=names)
    print(json.dumps({"bwd": out}), flush=True)


def per_call_ns(fn, n=N_HOST):
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter_ns()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter_ns() - t) / n


def probe_host(dev, card):
    from paddle_tpu_torch.nn import modules as TF
    from paddle_tpu_torch.nn.modules import TorchRMSNorm as RMSNorm

    gen = torch.Generator(device=dev).manual_seed(1)
    h = 2048
    x = (torch.randn(256, h, device=dev, generator=gen) * 3) \
        .to(torch.bfloat16)
    w = torch.randn(h, device=dev, generator=gen).to(torch.bfloat16)
    y = torch.empty_like(x)
    c = ctypes
    entry = _build.entry("pt_rms_norm", [c.c_void_p] * 3 + [
        c.c_int64, c.c_int, c.c_float, c.c_int, c.c_void_p])
    py = _build.py_module().rms_norm
    mode = RN._mode(h, x.dtype, w.dtype, False)
    stream = torch.cuda.current_stream(dev).cuda_stream
    codes = {torch.float32: 0, torch.bfloat16: 1}
    layer = RMSNorm(h, device=dev).to(torch.bfloat16)
    # the pieces of the parent's _launch, one at a time, and the
    # alternatives measured for them
    pieces = {
        "x dtype check": lambda: x.dtype not in codes,
        "weight dtype, device and shape checks": lambda: (
            w.dtype not in codes or w.device != x.device
            or tuple(w.shape) != (x.shape[-1],)),
        "weight dtype against x's": lambda: w.dtype not in (
            x.dtype, torch.float32),
        "h and its width check": lambda: (x.shape[-1] % (
            16 // x.element_size())),
        "x.contiguous().reshape(-1, h)": lambda: x.contiguous().reshape(
            -1, h),
        "_build.aligned16(x)": lambda: _build.aligned16(x),
        "_build.aligned16(w.contiguous())": lambda: _build.aligned16(
            w.contiguous()),
        "torch.empty_like(x)": lambda: torch.empty_like(x),
        "torch.cuda.current_stream(dev).cuda_stream":
            lambda: torch.cuda.current_stream(x.device).cuda_stream,
        "torch._C._cuda_getCurrentRawStream(index)":
            lambda: torch._C._cuda_getCurrentRawStream(x.device.index),
        "three data_ptr() and shape reads": lambda: (
            x.data_ptr(), w.data_ptr(), y.data_ptr(), x.shape[0]),
        "the ctypes call (launches the kernel)": lambda: entry(
            x.data_ptr(), w.data_ptr(), y.data_ptr(), 256, h, 1e-6, mode,
            stream),
        "the ctypes call, refused before a launch (0 rows)": lambda: entry(
            x.data_ptr(), w.data_ptr(), y.data_ptr(), 0, h, 1e-6, mode,
            stream),
        "the extension-module call (launches the kernel)": lambda: py(
            x.data_ptr(), w.data_ptr(), y.data_ptr(), 256, h, 1e-6, mode,
            stream),
        "the extension-module call, refused before a launch (0 rows)":
            lambda: py(x.data_ptr(), w.data_ptr(), y.data_ptr(), 0, h, 1e-6,
                       mode, stream),
        "the mode word (cached)": lambda: RN._mode(h, x.dtype, w.dtype,
                                                   False),
        "_kernel_weight(x, w)": lambda: RN._kernel_weight(x, w),
        "x.is_contiguous()": lambda: x.is_contiguous(),
        "x.get_device()": lambda: x.get_device(),
        "torch.empty(x.shape, dtype=, device=)": lambda: torch.empty(
            x.shape, dtype=x.dtype, device=x.device),
        "x.new_empty(x.shape)": lambda: x.new_empty(x.shape),
        "_build.check(0)": lambda: _build.check(0, "rms_norm"),
        "y.reshape(x.shape)": lambda: y.reshape(x.shape),
        "rms_norm's grad test": lambda: torch.is_grad_enabled() and (
            x.requires_grad or w.requires_grad),
        "_forward's device test": lambda: x.device.type == "cpu",
        "whole: ops.kernels.rms_norm.rms_norm": lambda: RN.rms_norm(x, w),
        "whole: nn.functional.rms_norm": lambda: TF.rms_norm(x, w),
        "F.rms_norm (library)": lambda: torch.nn.functional.rms_norm(
            x, (h,), w, 1e-6),
    }
    out = {"device": card, "shape": f"x [256, {h}] bf16, w [{h}] bf16",
           "calls": N_HOST}
    for name, fn in pieces.items():
        out[name] = per_call_ns(fn)
    with torch.inference_mode():
        out["whole: nn.RMSNorm under inference_mode"] = per_call_ns(
            lambda: layer(x))
        out["whole: ops.kernels.rms_norm.rms_norm under inference_mode"] = \
            per_call_ns(lambda: RN.rms_norm(x, w))
    out["a call, CUDA events (chip_smoke.time_ms)"] = {
        "rms_norm": time_ms(lambda: RN.rms_norm(x, w)) * 1e6,
        "F.rms_norm": time_ms(lambda: torch.nn.functional.rms_norm(
            x, (h,), w, 1e-6)) * 1e6}
    print(json.dumps({"host": out}), flush=True)


def probe_fwd(dev, card):
    from chip_smoke import kernel_device_ms

    gen = torch.Generator(device=dev).manual_seed(2)
    h, out = 2048, {"device": card, "root": ROOT}
    for rows, wdtype in ((8, torch.bfloat16), (256, torch.bfloat16),
                         (16384, torch.bfloat16), (16384, torch.float32)):
        x = (torch.randn(rows, h, device=dev, generator=gen) * 3) \
            .to(torch.bfloat16)
        w = torch.randn(h, device=dev, generator=gen).to(wdtype)
        out[f"[{rows}, {h}] bf16, {str(wdtype)[6:]} weight"] = \
            kernel_device_ms(lambda: RN.rms_norm(x, w), "rms_norm_kernel",
                             50 if rows < 16384 else 20)
    print(json.dumps({"fwd_device_ms": out}), flush=True)


def probe_train(dev, card):
    import statistics

    import numpy as np

    from chip_smoke import (TRAIN_BATCH, TRAIN_SEQ, _flagship_config,
                            profile_kernels)
    from paddle_tpu_torch.distributed.fleet import HybridTrainer

    cfg = _flagship_config()
    trainer = HybridTrainer(cfg, learning_rate=3e-4, seed=1234, device=dev)
    rng = np.random.RandomState(0)
    ids = rng.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ))
    ids_t = torch.tensor(ids, device=dev)
    labels_t = torch.tensor(np.roll(ids, -1, axis=1), device=dev)
    trainer.step(ids_t, labels_t)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    step_ms, losses = [], []
    for _ in range(3):
        t = time.perf_counter()
        losses.append(float(trainer.step(ids_t, labels_t)))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
    peak = torch.cuda.max_memory_allocated(dev)
    kinds = {}
    for key, (n, us) in profile_kernels(
            lambda: trainer.step(ids_t, labels_t)).items():
        kind = ("copy" if "direct_copy" in key or "Memcpy" in key
                else "rms_norm" if "rms_norm" in key
                else "elementwise" if "elementwise_kernel" in key
                else "reduce" if "reduce_kernel" in key else "other")
        k = kinds.setdefault(kind, [0, 0.0])
        k[0] += n
        k[1] += us / 1e3
    print(json.dumps({"train_profile": {
        "device": card, "root": ROOT, "step_ms": step_ms,
        "step_ms_median": statistics.median(step_ms), "losses": losses,
        "peak_memory_gb": peak / 1e9,
        "device_ms": sum(ms for _, ms in kinds.values()),
        "by_kind_launches_ms": kinds}}), flush=True)


def main():
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    import subprocess

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    dev = torch.device("cuda", 0)
    _build.library()
    what = sys.argv[1:] or ["host", "bwd"]
    if "after-kernel-phase" in what:
        # the host probe again after chip_smoke's first two phases have run
        # in this process
        import chip_smoke

        chip_smoke.phase_device_and_build()
        chip_smoke.phase_kernels(dev)
        probe_host(dev, card)
    if "host" in what:
        probe_host(dev, card)
    if "bwd" in what:
        probe_bwd(dev, card)
    if "fwd" in what:
        probe_fwd(dev, card)
    if "train-profile" in what:
        probe_train(dev, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
