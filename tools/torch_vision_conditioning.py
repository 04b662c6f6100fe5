"""How far the port's f32 ResNet training lands from float64, on the CPU.

    python tools/torch_vision_conditioning.py [DEPTH,BATCH,SIZE,MODE,STEPS ...]

For each case (default: the sizes the CPU tests and chip_smoke.py's
vision parity use), builds ``resnet{DEPTH}(num_classes=10)`` from
``paddle_tpu_torch.seed(0)``, copies it to float64 (the batch norms'
statistics and backward stay in float64 for a float64 input), and runs
STEPS TrainStep steps of Momentum(0.1, 0.9) on one batch of BATCH x 3 x
SIZE x SIZE from ``numpy.random.RandomState(0)``, with the batch norms on
batch statistics (MODE "train") or on their running statistics ("eval").
Prints one JSON line a case: the f32 loss's relative distance from the
float64 one, and the f32 state's distance from the float64 state after
the steps, as a share of each leaf's largest magnitude (worst leaf and
median leaf); after one step the velocities are the gradients, so STEPS
1 reads the gradients' distance. No card: torch on the CPU, 4 threads.
"""
import json
import os
import statistics
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import paddle_tpu_torch as paddle  # noqa: E402
from paddle_tpu_torch.jit import TrainStep  # noqa: E402
from paddle_tpu_torch.vision import models  # noqa: E402

CASES = ["50,2,32,train,1", "50,4,32,train,1", "50,4,64,train,1",
         "50,8,64,train,1", "50,4,32,eval,2", "18,4,64,train,1",
         "18,4,64,train,2"]


def run(state, depth, x, y, mode, steps, dtype):
    model = getattr(models, f"resnet{depth}")(num_classes=10)
    model.set_state_dict(state)
    if dtype == "float64":
        model.to(dtype=dtype)
    opt = paddle.optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                                    parameters=model.parameters())
    step = TrainStep(model, paddle.nn.CrossEntropyLoss(), opt,
                     train=mode == "train")
    losses = [float(step(paddle.to_tensor(x.astype(dtype)),
                         paddle.to_tensor(y))) for _ in range(steps)]
    names = {id(p): n for n, p in model.named_parameters()}
    vel = {names[id(p)]: opt._accumulators[id(p)]["velocity"].double()
           .numpy() for p in opt._parameter_list}
    state = {k: v._value.detach().double().numpy()
             for k, v in model.state_dict().items()}
    return losses, state, vel


def share(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def main(cases):
    paddle.set_device("cpu")
    torch.set_num_threads(4)
    for case in cases:
        depth, batch, size, mode, steps = case.split(",")
        depth, batch, size, steps = int(depth), int(batch), int(size), \
            int(steps)
        rng = np.random.RandomState(0)
        x = rng.randn(batch, 3, size, size).astype(np.float32)
        y = rng.randint(0, 10, (batch,)).astype(np.int64)
        paddle.seed(0)
        model = getattr(models, f"resnet{depth}")(num_classes=10)
        state = {k: v._value.detach().clone()
                 for k, v in model.state_dict().items()}
        l32, s32, v32 = run(state, depth, x, y, mode, steps, "float32")
        l64, s64, v64 = run(state, depth, x, y, mode, steps, "float64")
        leaves = [share(s32[k], v) for k, v in s64.items()] + \
            [share(v32[k], v) for k, v in v64.items()]
        print(json.dumps({
            "case": case, "loss_rel": abs(l32[-1] - l64[-1]) / abs(l64[-1]),
            "worst_leaf_share": max(leaves),
            "median_leaf_share": statistics.median(leaves)}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:] or CASES)
