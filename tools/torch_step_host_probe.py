"""Time the serving engine's eager ``step()`` on the card, for comparing two
trees of the port in turns.

    python tools/torch_step_host_probe.py [ROOT] [--steps N]

Imports paddle_tpu_torch from ROOT (default: this checkout), builds
``PagedServingConfig.llama_1b()`` (bf16, random weights from seed 1234),
and times, each step synchronised on the device: fresh-prefill steps (two
128-token prompts, the whole 256-token budget) and decode steps through
``step()`` (8 rows at their decode tips, eager, no graph). Prints one JSON
line: the medians and every step's ms, with the card's name and the tree.
Run two trees as separate processes in turns (A, B, B, A): a step's host
time moves with the host from call to call.
"""
import argparse
import json
import os
import statistics
import sys
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("root", nargs="?",
                    default=os.path.dirname(os.path.dirname(
                        os.path.abspath(__file__))))
    ap.add_argument("--steps", type=int, default=20)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import numpy as np
    import torch

    from paddle_tpu_torch.inference import (PagedCausalLM,
                                            PagedServingConfig,
                                            ServingEngine)

    dev = torch.device("cuda")
    cfg = PagedServingConfig.llama_1b()
    model = PagedCausalLM(cfg, device=dev, seed=1234)
    rng = np.random.RandomState(0)

    def prompts(lens):
        return [list(rng.randint(1, cfg.vocab_size, n)) for n in lens]

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3

    fresh, decode = [], []
    eng = ServingEngine.from_model(model, cfg, seed=7, device=dev)
    for i in range(args.steps + 2):
        for p in prompts((128, 128)):
            eng.add_request(p, max_new_tokens=1)
        ms = timed(eng.step)
        if i >= 2:                      # the first calls warm up
            fresh.append(ms)
    for p in prompts([24] * 8):
        eng.add_request(p, max_new_tokens=args.steps + 3)
    while any(r.length - r.cached > 1 for r in eng.pending()):
        eng.step()
    for i in range(args.steps + 2):
        ms = timed(eng.step)
        if i >= 2:
            decode.append(ms)
    print(json.dumps({
        "root": os.path.abspath(args.root),
        "device": torch.cuda.get_device_name(0),
        "fresh_prefill_step_ms_median": statistics.median(fresh),
        "eager_decode_step_ms_median": statistics.median(decode),
        "fresh_prefill_step_ms": fresh, "eager_decode_step_ms": decode}))


if __name__ == "__main__":
    main()
