"""Does the eager phase of chip_smoke.py slow the packed-training step that
runs after it in the same process?

The eager phase leaves its 0.95B f32 model, its gradients, AdamW's moments
and tens of thousands of Python objects allocated for the profile phase.
This script runs, in one process on one card, chip_smoke's training phase
(held, as chip_smoke holds it) and its packed-training phase, then times
the packed step (host clock around the step and a sync, as chip_smoke
times it) in turns under four states of the process:

- "before": no eager state yet;
- "eager alive": after chip_smoke's eager phase, its result held;
- "eager alive, gc off": the same with Python's garbage collector off
  while the steps run (tells a collector's pause apart from the card);
- "eager freed": the result deleted, gc.collect(), empty_cache().

Each round builds the eager state anew (``--rounds``, default 2), so every
state but "before" is read in each round. Also printed: the live Python
objects and the time of one full gc.collect() in each state.

    python3 tools/torch_packed_after_eager.py [--steps 30] [--rounds 2]

Needs one CUDA card (about 3 minutes with the kernels' build). The last
line of standard output is a JSON object with every step's ms by state.
"""
import argparse
import gc
import json
import os
import statistics
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def timed(step, n):
    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        step()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t) * 1e3)
    return out


def gc_probe():
    """(live objects tracked by the collector, ms of one full collect)."""
    t = time.perf_counter()
    gc.collect()
    return len(gc.get_objects()), (time.perf_counter() - t) * 1e3


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as S
    from paddle_tpu_torch import resolve_device

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = resolve_device("cuda")
    S.log(S.card())
    training = S.phase_training(dev)
    packed = S.phase_packed_training(dev)
    step = packed["step"]
    steps, probes = {}, {}

    def measure(state):
        steps.setdefault(state, []).extend(timed(step, args.steps))

    def probe(state):
        probes.setdefault(state, []).append(gc_probe())

    probe("before")
    measure("before")
    for _ in range(args.rounds):
        eager = S.phase_eager(dev)
        probe("eager alive")
        for _ in range(2):
            measure("eager alive")
            gc.disable()
            try:
                measure("eager alive, gc off")
            finally:
                gc.enable()
        del eager
        probe("eager freed")
        torch.cuda.empty_cache()
        measure("eager freed")
        measure("eager freed")
    summary = {}
    for state, ms in steps.items():
        summary[state] = {
            "steps": len(ms), "median_ms": statistics.median(ms),
            "p10_ms": float(np.percentile(ms, 10)),
            "p90_ms": float(np.percentile(ms, 90)), "max_ms": max(ms),
            "gc_objects_and_collect_ms": probes.get(state)}
        S.log(f"{state}: packed step median {summary[state]['median_ms']:.3f}"
              f" ms (p10 {summary[state]['p10_ms']:.3f}, p90 "
              f"{summary[state]['p90_ms']:.3f}, max "
              f"{summary[state]['max_ms']:.3f}) over {len(ms)} steps; gc "
              f"{probes.get(state)}")
    del training
    print(json.dumps({"card": S.card(), "summary": summary,
                      "step_ms": steps}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
