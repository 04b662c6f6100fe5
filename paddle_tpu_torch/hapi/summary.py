"""Model summary (paddle_tpu/hapi/summary.py; reference
python/paddle/hapi/model_summary.py): each parameter's name, shape and
count, and the totals."""
from __future__ import annotations

import numpy as np


def summary(net, input_size=None, dtypes=None, input=None):
    total = 0
    trainable = 0
    rows = []
    for name, p in net.named_parameters():
        n = int(np.prod(p.shape)) if p.shape else 1
        total += n
        if p.trainable:
            trainable += n
        rows.append((name, tuple(p.shape), n))
    width = max((len(r[0]) for r in rows), default=20) + 2
    lines = [f"{'Param':<{width}} {'Shape':<24} {'Count':>12}"]
    for name, shape, n in rows:
        lines.append(f"{name:<{width}} {str(shape):<24} {n:>12,}")
    lines.append("-" * (width + 38))
    lines.append(f"Total params: {total:,}")
    lines.append(f"Trainable params: {trainable:,}")
    print("\n".join(lines))
    return {"total_params": total, "trainable_params": trainable}
