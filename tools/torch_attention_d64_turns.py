"""The flash kernels at head dim 64 with dropout 0.1 against SDPA with
dropout_p=0.1, in turns, on one card.

    python3 tools/torch_attention_d64_turns.py [--windows 7]

At chip_smoke.py's D64_SHAPES (BERT-base [32, 12, 512, 64], GPT-2
[8, 12, 1024, 64] causal, bf16) times, with CUDA events around 5
back-to-back calls a window, windows taken in turns (ours, SDPA, SDPA,
ours, ...): the port's forward (flash_attention.forward_with_lse) and its
backward pair (dK/dV then dQ), and SDPA's forward and its backward
(torch.autograd.grad of one SDPA output) under each SDPA backend that
takes the inputs (flash, memory-efficient, math) and under PyTorch's own
choice. Prints one JSON line a shape: each variant's median ms a call and
its windows' spread. Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as C  # noqa: E402


def _window_ms(fn, calls=5):
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(calls):
        fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / calls


def shape_turns(model, shape, windows):
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from paddle_tpu_torch.ops.kernels import flash_attention as FA

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(64)
    b, s, causal = shape["batch"], shape["seq"], shape["causal"]
    q, k, v, do, _ = C._d64_inputs(dev, gen, b, s, False)
    p, seed = C.ATTN_DROPOUT, 12345
    o, lse = FA.forward_with_lse(q, k, v, None, seed, causal, p)
    _, _, _, _, _, _, delta = FA._bwd_inputs(q, k, v, None, o, lse, do,
                                             causal)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    fns = {
        "ours_fwd": lambda: FA.forward_with_lse(q, k, v, None, seed, causal,
                                                p),
        "ours_bwd": lambda: (
            FA._launch_bwd_dkv(q, k, v, None, seed, do, lse, delta, causal,
                               p),
            FA._launch_bwd_dq(q, k, v, None, seed, do, lse, delta, causal,
                              p)),
    }
    backends = {"default": None, "flash": SDPBackend.FLASH_ATTENTION,
                "efficient": SDPBackend.EFFICIENT_ATTENTION,
                "math": SDPBackend.MATH}
    for name, backend in backends.items():
        def run(fn, backend=backend):
            if backend is None:
                return fn()
            with sdpa_kernel(backend):
                return fn()
        qg, kg, vg = (t.detach().clone().requires_grad_(True)
                      for t in (q, k, v))
        try:
            out = run(lambda: sdpa(qg, kg, vg, dropout_p=p,
                                   is_causal=causal))
            run(lambda: torch.autograd.grad(out, (qg, kg, vg), do,
                                            retain_graph=True))
        except RuntimeError as e:
            print(f"{model}: SDPA backend {name} refused: "
                  f"{str(e).splitlines()[0][:120]}", file=sys.stderr)
            continue
        fns[f"sdpa_{name}_fwd"] = lambda run=run: run(
            lambda: sdpa(q, k, v, dropout_p=p, is_causal=causal))
        fns[f"sdpa_{name}_bwd"] = lambda run=run, out=out, leaves=(
            qg, kg, vg): run(lambda: torch.autograd.grad(
                out, leaves, do, retain_graph=True))
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    ms = {n: [] for n in fns}
    names = list(fns)
    for w in range(windows):
        order = names if w % 2 == 0 else names[::-1]
        for n in order:
            ms[n].append(_window_ms(fns[n]))
    return {"model": model, "card": C.card(),
            "shape": f"[{b}, 12, {s}, 64] bf16{' causal' if causal else ''}"
                     f", dropout {p}",
            "ms": {n: {"median": statistics.median(v), "min": min(v),
                       "max": max(v)} for n, v in ms.items()}}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--windows", type=int, default=7)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_attention_d64_turns: needs a CUDA card", file=sys.stderr)
        return 1
    for model, shape in C.D64_SHAPES.items():
        print(json.dumps(shape_turns(model, shape, args.windows)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
