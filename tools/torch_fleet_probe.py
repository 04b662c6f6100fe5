"""chip_smoke.py's fleet phase (6j) alone, after the kernels' build.

    python tools/torch_fleet_probe.py        (needs one CUDA card)

Prints the card's name and power limit, builds the port's kernels, draws
llama_1b (seed 1234, as chip_smoke.py's serving phase does), then runs
chip_smoke.phase_fleet: the gateway over a router of 2 replicas, the
disaggregated pair, kill@decode under the supervisor, a weight rollout,
the autoscaler and 2 replica children on the card. Its "fleet (N)" lines
are chip_smoke's own; the last line holds the fleet path's launches and
launches a step. Exits non-zero when a check fails or there is no card.
"""
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def main():
    if not torch.cuda.is_available():
        print("torch_fleet_probe: no CUDA card", file=sys.stderr)
        return 1
    from paddle_tpu_torch.inference import PagedCausalLM, PagedServingConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    chip_smoke.phase_device_and_build()
    dev = torch.device("cuda", 0)
    model = PagedCausalLM(PagedServingConfig.llama_1b(), device=dev,
                          seed=1234)
    out = chip_smoke.phase_fleet(dev, {"model": model})
    print(json.dumps({"fleet_per_step": out["per_step"],
                      "fleet_counts": dict(out["counts"])}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
