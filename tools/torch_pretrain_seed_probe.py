"""Where the host stalls a GPT-2 or BERT-base pretraining step on one card.

    python3 tools/torch_pretrain_seed_probe.py [--steps 8] [--turns 2]

Builds chip_smoke.py's pretraining rows (``phase_pretrain``: O2 bf16,
AdamW at lr 1e-4, jit.TrainStep; GPT-2 small at batch 8 x 1024, BERT-base
at 32 x 512) and, for each:

1. counts the host synchronisations of one step, by the warnings of
   ``torch.cuda.set_sync_debug_mode("warn")``, grouped by message;
2. times the step in turns (seed as the port draws it, host seed, host
   seed, seed as the port draws it, ``--turns`` times) with the flash
   kernels' dropout seed drawn as the port draws it
   (``flash_attention.seed_from_generator`` on the card's generator: a
   randint on the card read back on the host) and drawn from a host
   generator instead (no read-back), printing each variant's median step
   ms and its spread.

Prints one JSON line a model. Needs one CUDA card; imports torch, numpy,
the port and chip_smoke.py.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
import warnings
from collections import Counter

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as C  # noqa: E402


def _step_ms(step, ids, labels, n):
    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        step(ids, labels)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t) * 1e3)
    return out


def _syncs(step, ids, labels):
    """{warning message's first line: count} of one step under the sync
    debug mode."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            step(ids, labels)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return dict(Counter(str(w.message).splitlines()[0][:120]
                        for w in caught))


def probe(kind, steps, turns):
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.ops.kernels import flash_attention as FA

    sizes = C.PRETRAIN[kind]
    paddle.set_device("gpu:0")
    paddle.seed(0)
    cfg, model = C._pretrain_model(kind)
    model = paddle.amp.decorate(model, level="O2", dtype="bfloat16")
    opt = paddle.optimizer.AdamW(learning_rate=1e-4,
                                 parameters=model.parameters())
    step = C._pretrain_step(kind, cfg, model, opt)
    ids, labels = C._pretrain_batch(kind, cfg, sizes["batch"], sizes["seq"],
                                    seed=0)
    _step_ms(step, ids, labels, 2)                       # warm-up
    real = FA.seed_from_generator
    host = torch.Generator().manual_seed(0)
    variants = {"card_seed": real,
                "host_seed": lambda generator=None: real(host)}
    syncs, times = {}, {v: [] for v in variants}
    try:
        for name, fn in variants.items():
            FA.seed_from_generator = fn
            syncs[name] = _syncs(step, ids, labels)
        for _ in range(turns):
            for name in ("card_seed", "host_seed", "host_seed",
                         "card_seed"):
                FA.seed_from_generator = variants[name]
                times[name] += _step_ms(step, ids, labels, steps)
    finally:
        FA.seed_from_generator = real
    out = {"model": kind, "card": C.card(), "steps_a_turn": steps,
           "syncs_a_step": syncs}
    for name, ms in times.items():
        out[name] = {"median_ms": statistics.median(ms), "min_ms": min(ms),
                     "max_ms": max(ms), "steps": len(ms)}
    del model, opt, step
    torch.cuda.empty_cache()
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--turns", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_pretrain_seed_probe: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    for kind in C.PRETRAIN:
        print(json.dumps(probe(kind, args.steps, args.turns)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
