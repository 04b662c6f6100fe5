"""Does one use of torch.profiler slow the port's host-bound decode after it?

    python tools/torch_profiler_effect.py        (needs one CUDA card)

Builds the llama_1b serving model once (random weights), then in one
process times decode_run(32) at batch 8 three times, opens and closes one
torch.profiler context, and times it three times more. Prints one JSON
line with the decode ms/step before and after. chip_smoke.py profiles in
its last phase because of this effect.
"""
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from paddle_tpu_torch.inference import (PagedCausalLM,  # noqa: E402
                                        PagedServingConfig, ServingEngine)


def decode_ms_per_step(model, cfg, rng, steps=32):
    eng = ServingEngine.from_model(model, cfg, device="cuda")
    for _ in range(8):
        eng.add_request(list(rng.randint(1, cfg.vocab_size, 64)),
                        max_new_tokens=steps + 8)
    eng.step()
    torch.cuda.synchronize()
    t = time.perf_counter()
    eng.decode_run(steps)
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / steps * 1e3


def main():
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    cfg = PagedServingConfig.llama_1b()
    model = PagedCausalLM(cfg, device="cuda", seed=1)
    rng = np.random.RandomState(0)
    decode_ms_per_step(model, cfg, rng)                  # warm-up
    before = [decode_ms_per_step(model, cfg, rng) for _ in range(3)]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.ones(16, device="cuda").sum()
        torch.cuda.synchronize()
    after = [decode_ms_per_step(model, cfg, rng) for _ in range(3)]
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "decode_ms_per_step_before_profiler": before,
                      "decode_ms_per_step_after_profiler": after}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
