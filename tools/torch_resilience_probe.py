"""chip_smoke.py's resilience phase alone, after the kernels' build.

    python tools/torch_resilience_probe.py        (needs one CUDA card)

Prints the card's name and power limit, builds the port's kernels, then
runs chip_smoke.phase_resilience: the flagship Llama row (16 layers,
hidden 2048, 4 x 4096) through HybridTrainer.run_elastic under the
supervisor and a Profiler, with its SKIP, rollback and disk-tier checks,
and the supervised step against the plain step in turns. Its JSON lines
are chip_smoke's own. Exits non-zero when a check fails or there is no
card.
"""
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def main():
    if not torch.cuda.is_available():
        print("torch_resilience_probe: no CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    chip_smoke.phase_device_and_build()
    chip_smoke.phase_resilience(torch.device("cuda", 0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
