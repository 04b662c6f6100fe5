"""Time the serving engine's steps on the card, for comparing two trees of
the port in turns.

    python tools/torch_step_host_probe.py [ROOT] [--steps N]
        [--engine bf16|int8|int8-stream ...] [--window]

Imports paddle_tpu_torch from ROOT (default: this checkout), builds
``PagedServingConfig.llama_1b()`` (bf16, random weights from seed 1234),
and for each ``--engine`` (default bf16: bf16 pages; int8: int8 cache-KV
pages; int8-stream: bf16 pages with the decoder's weights streamed as
int8) times, each step synchronised on the device: fresh-prefill steps
(two 128-token prompts, the whole 256-token budget) and decode steps
through ``step()`` (8 rows at their decode tips, eager, no graph). With
``--window``, also decode through ``decode_run`` windows of 16 steps at
batch 8 whose CUDA graph exists (ms a step over 6 windows), and, last (a
profiler session slows later host work), one such window under
torch.profiler: its device kernels (and copies) a step, in all, and its
device ms a step, after 1024 one-cycle spin kernels (the profiler may lose
the first records of a session). Prints one JSON line: every engine's
medians and every step's ms, with the card's name and the tree. Run two
trees as separate processes in turns (A, B, B, A): a step's host time moves
with the host from call to call.
"""
import argparse
import json
import os
import statistics
import sys
import time

# (PagedServingConfig.llama_1b's overrides, from_model's weight_stream)
ENGINES = {"bf16": ({}, None), "int8": ({"cache_quant": "int8"}, None),
           "int8-stream": ({}, "int8")}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("root", nargs="?",
                    default=os.path.dirname(os.path.dirname(
                        os.path.abspath(__file__))))
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--engine", action="append", choices=sorted(ENGINES))
    ap.add_argument("--window", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import numpy as np
    import torch

    from paddle_tpu_torch.inference import (PagedCausalLM,
                                            PagedServingConfig,
                                            ServingEngine)

    dev = torch.device("cuda")
    model = PagedCausalLM(PagedServingConfig.llama_1b(), device=dev,
                          seed=1234)
    rng = np.random.RandomState(0)

    def prompts(cfg, lens):
        return [list(rng.randint(1, cfg.vocab_size, n)) for n in lens]

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3

    def to_tips(eng, cfg, new_tokens):
        for p in prompts(cfg, [24] * 8):
            eng.add_request(p, max_new_tokens=new_tokens)
        while any(r.length - r.cached > 1 for r in eng.pending()):
            eng.step()

    out, engines = {}, {}
    for kind in args.engine or ["bf16"]:
        over, stream = ENGINES[kind]
        cfg = PagedServingConfig.llama_1b(**over)
        eng = ServingEngine.from_model(model, cfg, seed=7, device=dev,
                                       weight_stream=stream)
        fresh, decode = [], []
        for i in range(args.steps + 2):
            for p in prompts(cfg, (128, 128)):
                eng.add_request(p, max_new_tokens=1)
            ms = timed(eng.step)
            if i >= 2:                      # the first calls warm up
                fresh.append(ms)
        to_tips(eng, cfg, args.steps + 3)
        for i in range(args.steps + 2):
            ms = timed(eng.step)
            if i >= 2:
                decode.append(ms)
        eng.run_to_completion()
        res = {"fresh_prefill_step_ms_median": statistics.median(fresh),
               "eager_decode_step_ms_median": statistics.median(decode),
               "fresh_prefill_step_ms": fresh, "eager_decode_step_ms": decode}
        if args.window:
            to_tips(eng, cfg, 16 * 8 + 2)
            eng.decode_run(16)              # captures the window's graph
            windows = []
            for _ in range(6):
                windows.append(timed(lambda: eng.decode_run(16)) / 16)
            eng.run_to_completion()
            res.update(window_ms_per_step_median=statistics.median(windows),
                       window_ms_per_step=windows)
        out[kind] = res
        engines[kind] = (eng, cfg)
    if args.window:
        from torch.profiler import ProfilerActivity, profile

        for kind, (eng, cfg) in engines.items():
            to_tips(eng, cfg, 40)
            eng.decode_run(16)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(1024):
                    torch.cuda._sleep(1)
                eng.decode_run(16)
                torch.cuda.synchronize()
            n = us = 0
            for evt in prof.key_averages():
                if not str(getattr(evt, "device_type", "")).endswith("CUDA") \
                        or evt.self_device_time_total <= 0 \
                        or "spin_kernel" in evt.key:
                    continue
                n += evt.count
                us += evt.self_device_time_total
            out[kind].update(window_device_kernels_a_step=n / 16,
                             window_device_ms_a_step=us / 1e3 / 16)
            eng.run_to_completion()
    print(json.dumps({
        "root": os.path.abspath(args.root),
        "device": torch.cuda.get_device_name(0), **out}))


if __name__ == "__main__":
    main()
