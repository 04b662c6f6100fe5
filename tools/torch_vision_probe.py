"""The ResNet-50 training step of the port's vision slice on one card.

    python tools/torch_vision_probe.py phase    (needs one CUDA card)
    python tools/torch_vision_probe.py turns
    python tools/torch_vision_probe.py steps

``phase`` runs chip_smoke.py's vision phase alone (ResNet-50 at batch 256
x 224 under the bench recipe, the MNIST LeNet fit and evaluate through
Model; not its card-against-CPU checks), then profiles one ResNet-50 step and
prints its device ms by kernel class (chip_smoke.py's _vision_profile)
with every kernel of more than 0.5 ms, and its device busy share.

``turns`` times the same step in turns under three settings of one
process, a window of 4 steps each in turn, 3 rounds: as the package runs
it; with ``torch.backends.cudnn.benchmark = True``; and with the input
and every conv weight in channels_last memory format (PyTorch's NHWC
layout under NCHW shapes). Prints one JSON line of the median step ms of
each. Neither setting is the package's: this measures what they would
buy.

``steps`` repeats the card-against-CPU check of chip_smoke.py's vision
parity that is most sensitive to the card's conv algorithms: ResNet-50
(num_classes=10, batch 4 x 32 x 32) through 2 Momentum TrainStep steps
of lr 0.1 on its running statistics, against one CPU run. 4 repeats on
the card each as PyTorch chooses (cuDNN), with
``cudnn.deterministic = True``, with ``cudnn.enabled = False``, and as
PyTorch chooses beside a 40 GB allocation (the memory the earlier phases
of chip_smoke.py hold); one JSON line of the worst parameter's share of
its largest magnitude in each repeat.
"""
import json
import os
import statistics
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as C  # noqa: E402


def phase():
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    C.log(C.card())
    C._vision_parity = lambda dev: None
    vision = C.phase_vision(dev)
    prof = C.profile_kernels(vision["step"])
    classes, claimed, _ = C._vision_profile(vision["step"], vision["model"],
                                            vision["opt"])
    ms = sum(us for _, us in prof.values()) / 1e3
    top = sorted(((k[:120], n, us / 1e3) for k, (n, us) in prof.items()
                  if us > 500), key=lambda r: -r[2])
    print(json.dumps({"resnet50_profile": {
        "step_device_ms": ms,
        "device_busy": ms / vision["metrics"]["step_ms_median"],
        "device_ms_by_class": classes, "attributed_ms": claimed,
        "kernels_over_half_ms": top}}), flush=True)


def _resnet_step(paddle, channels_last):
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.vision.models import resnet50

    b, size = C.VISION_ROW["batch"], C.VISION_ROW["size"]
    paddle.seed(0)
    model = paddle.amp.decorate(resnet50(num_classes=1000), level="O2",
                                dtype="bfloat16")
    opt = paddle.optimizer.Momentum(parameters=model.parameters(),
                                    learning_rate=0.1, momentum=0.9)
    step = TrainStep(model, paddle.nn.CrossEntropyLoss(), opt)
    rng = np.random.RandomState(0)
    x = paddle.to_tensor(rng.randn(b, 3, size, size).astype(np.float32))
    y = paddle.to_tensor(rng.randint(0, 1000, (b,)).astype(np.int64))
    if channels_last:
        x._value = x._value.to(memory_format=torch.channels_last)
        for p in model.parameters():
            if p.ndim == 4:
                p._replace(p._value.to(memory_format=torch.channels_last))

    def call():
        with paddle.amp.auto_cast(True, level="O1", dtype="bfloat16"):
            return step(x, y)
    return call


def turns(rounds=3, window=4):
    import paddle_tpu_torch as paddle

    C.log(C.card())
    settings = {}
    for name in ("default", "cudnn_benchmark", "channels_last"):
        settings[name] = _resnet_step(paddle, name == "channels_last")
    per = {name: [] for name in settings}
    for _ in range(rounds + 1):
        for name, call in settings.items():
            torch.backends.cudnn.benchmark = name == "cudnn_benchmark"
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(window):
                loss = call()
            torch.cuda.synchronize()
            per[name].append((time.perf_counter() - t) / window * 1e3)
            if not np.isfinite(float(loss)):
                raise AssertionError(f"{name}: loss {float(loss)}")
    torch.backends.cudnn.benchmark = False
    # the first round warms each setting up (cuDNN's search included)
    print(json.dumps({"resnet50_step_ms_turns": {
        name: {"median": statistics.median(v[1:]), "rounds": v[1:],
               "first": v[0]} for name, v in per.items()}}), flush=True)


def steps(repeats=4):
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.vision.models import resnet50

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    C.log(C.card())
    rng = np.random.RandomState(1)
    x = rng.randn(4, 3, 32, 32).astype(np.float32)
    y = rng.randint(0, 10, (4,)).astype(np.int64)
    paddle.set_device("cpu")
    paddle.seed(3)
    state = C._vision_state(resnet50(num_classes=10))
    with C.one_cpu_thread():
        _, cpu, _ = C._vision_steps(paddle, C._resnet_on(
            paddle, "cpu", state), x, y, False, 2)

    def worst():
        _, card, _ = C._vision_steps(paddle, C._resnet_on(
            paddle, "gpu:0", state), x, y, False, 2)
        paddle.set_device("gpu:0")
        return max((C._vision_share(card[k], v), k) for k, v in cpu.items()
                   if not k.endswith(("_mean", "_variance")))

    out = {}
    for name in ("default", "deterministic", "no_cudnn", "beside_40gb"):
        torch.backends.cudnn.deterministic = name == "deterministic"
        torch.backends.cudnn.enabled = name != "no_cudnn"
        held = torch.empty(40 << 30, dtype=torch.uint8, device="cuda") \
            if name == "beside_40gb" else None
        out[name] = [worst() for _ in range(repeats)]
        del held
        torch.cuda.empty_cache()
    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.enabled = True
    print(json.dumps({"eval_steps_worst_parameter": out}), flush=True)


if __name__ == "__main__":
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        sys.exit(1)
    {"phase": phase, "turns": turns, "steps": steps}[sys.argv[1]]()
