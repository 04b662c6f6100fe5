"""Which kernels does torch.profiler lose, and does padding keep them?

    python tools/torch_profiler_window.py [SECONDS]   (needs one CUDA card)

Captures one CUDA graph of 256 bf16 GEMMs ([8, 2048] x [2048, 5632], a
decode step's shape) and, for SECONDS (default 150) of process life,
profiles replays of it every few seconds in four ways:

- "plain": one replay;
- "marked": one replay between two spin kernels (torch.cuda._sleep), one
  before and one after, to see at which end records go missing;
- "padded": PAD_LAUNCHES one-cycle spin kernels first, then one replay (as
  chip_smoke.py's profile_kernels does);
- "padded_x16": the same with 16 replays (a decode window's shape).

For each round it prints one JSON line: the graph's kernels that Kineto's
raw results and torch.profiler's events hold, and the spin kernels kept.
A last line counts the rounds that came up short in each way.
"""
import json
import sys
import time

import torch

N_KERNELS = 256
PAD_LAUNCHES = 1024
MARK_CYCLES = 200_000          # ~0.1 ms


def profile_round(graph, pad, marks, replays):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(pad):
            torch.cuda._sleep(1)
        if marks:
            torch.cuda._sleep(MARK_CYCLES)
        for _ in range(replays):
            graph.replay()
        if marks:
            torch.cuda._sleep(MARK_CYCLES)
        torch.cuda.synchronize()
    events = sum(1 for e in prof.events()
                 if str(e.device_type).endswith("CUDA")
                 and "spin_kernel" not in e.name)
    raw = spins = 0
    for e in prof.profiler.kineto_results.events():
        if str(e.device_type()).endswith("CUDA"):
            if "spin_kernel" in e.name():
                spins += 1
            else:
                raw += 1
    return {"raw": raw, "events": events, "spins": spins,
            "spins_launched": pad + 2 * marks}


def main():
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    seconds = float(sys.argv[1]) if len(sys.argv) > 1 else 150.0
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(8, 2048, device="cuda", generator=gen,
                    dtype=torch.bfloat16)
    ws = [torch.randn(2048, 5632, device="cuda", generator=gen,
                      dtype=torch.bfloat16) for _ in range(4)]
    out = torch.empty(8, 5632, device="cuda", dtype=torch.bfloat16)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            torch.matmul(x, ws[0], out=out)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(N_KERNELS):
            torch.matmul(x, ws[i % 4], out=out)
    graph.replay()
    torch.cuda.synchronize()
    # the kernels of one replay (cuBLAS may split a product in two), seen
    # while the process is young
    want = profile_round(graph, PAD_LAUNCHES, False, 1)["raw"]
    variants = (("plain", 0, False, 1), ("marked", 0, True, 1),
                ("padded", PAD_LAUNCHES, False, 1),
                ("padded_x16", PAD_LAUNCHES, False, 16))
    totals = {name: [0, 0] for name, *_ in variants}
    while time.perf_counter() - t0 < seconds:
        row = {"process_s": round(time.perf_counter() - t0, 1)}
        for name, pad, marks, replays in variants:
            r = profile_round(graph, pad, marks, replays)
            row[name] = r
            totals[name][0] += 1
            totals[name][1] += r["raw"] != want * replays
        print(json.dumps(row), flush=True)
        time.sleep(4.0)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "gemms_a_replay": N_KERNELS,
                      "kernels_a_replay": want,
                      "rounds_short": {k: f"{short} of {n}" for k, (n, short)
                                       in totals.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
