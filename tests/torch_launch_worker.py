"""A training script for tests/test_torch_launch.py, started by
``python -m paddle_tpu_torch.distributed.launch`` (one process a worker,
gloo on the CPU). Imports only torch, numpy and the port.

It writes the launcher's environment contract to ``$OUT_DIR/env<rank>.json``,
then trains ``nn.Linear(4, 2)`` (the weights of ``$OUT_DIR/init.npz``)
under DataParallel with SGD for 5 steps on its half of an 8-row batch
(tests/test_models_launch.py's numbers) and saves the weight to
``$OUT_DIR/w<rank>.npy``.
"""
import json
import os
import sys

import numpy as np
import torch


def main():
    torch.set_num_threads(1)
    out = os.environ["OUT_DIR"]
    keys = ("PADDLE_TRAINER_ID", "PADDLE_TRAINERS_NUM",
            "PADDLE_TRAINER_ENDPOINTS", "PADDLE_CURRENT_ENDPOINT",
            "PADDLE_LOCAL_RANK", "PADDLE_MASTER", "PADDLE_JOB_ID")
    import paddle_tpu_torch as paddle
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch import nn

    env = dist.init_parallel_env()
    rank = dist.get_rank()
    with open(os.path.join(out, f"env{rank}.json"), "w") as f:
        json.dump({"env": {k: os.environ.get(k) for k in keys},
                   "rank": env.rank, "world": env.world_size,
                   "local": env.local_rank, "argv": sys.argv[1:]}, f)
    init = np.load(os.path.join(out, "init.npz"))
    layer = nn.Linear(4, 2)
    layer.weight.set_value(init["weight"])
    layer.bias.set_value(init["bias"])
    model = dist.DataParallel(layer)
    opt = paddle.optimizer.SGD(parameters=model.parameters(),
                               learning_rate=0.1)
    loss_fn = nn.MSELoss()
    rng = np.random.RandomState(42)
    x_full = rng.randn(8, 4).astype("float32")
    y_full = rng.randn(8, 2).astype("float32")
    x, y = x_full[rank * 4:(rank + 1) * 4], y_full[rank * 4:(rank + 1) * 4]
    for _ in range(5):
        loss = loss_fn(model(paddle.to_tensor(x)), paddle.to_tensor(y))
        loss.backward()
        opt.step()
        opt.clear_grad()
    np.save(os.path.join(out, f"w{rank}.npy"), layer.weight.numpy())
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
