"""Readings behind the AMP O1 bf16 tolerances of
tests/test_torch_eager_llama.py: the port's eager Llama against the JAX
package's under ``amp.auto_cast(level="O1", dtype="bfloat16")`` on the
CPU, over several seeds, beside controls in which the port runs part or
all of the same step at another precision than the reference's policy.

For each seed (the "debug" preset's weights from the seed, B = 1,
S = 128 tokens from the seed) it prints, for the port's run and for each
control, against the JAX run under AMP O1 bf16:

- the loss's relative gap;
- the worst leaf's gradient gap: max |port - jax| over max |jax| of the
  leaf, the worst over the 21 leaves;
- the worst leaf's relative L2 gap: ||port - jax|| / ||jax||.

Controls: "f32" (no AMP), "attention f32" (scaled_dot_product_attention
black-listed) and "lm_head f32" (the LM head outside auto_cast). A
tolerance between the port's largest gap and a control's smallest tells
the two precisions apart; where the ranges overlap (one op moved, at this
size) the test needs another check: the ops' output dtypes.

Run from the repository root: ``python tests/torch_eager_amp_gaps.py
[--seeds 6]`` (about a minute on one CPU core; JAX on the CPU with the
Pallas kernels in interpret mode).
"""
import argparse
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ["PT_PALLAS_INTERPRET"] = "1"
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import paddle_tpu as jpaddle  # noqa: E402
import paddle_tpu_torch as tpaddle  # noqa: E402
from paddle_tpu.models import llama as JL  # noqa: E402
from paddle_tpu_torch.models import llama as TL  # noqa: E402
from paddle_tpu_torch.utils import state_dict_from_paddle_tpu  # noqa: E402


def pair(seed):
    """The JAX "debug" model from ``seed`` and the port's over its
    weights."""
    jpaddle.seed(seed)
    base = vars(JL.LLAMA_PRESETS["debug"])
    jm = JL.LlamaForCausalLM(JL.LlamaConfig(**base))
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = TL.LlamaForCausalLM(TL.LlamaConfig(**base))
    tm.set_state_dict(state_dict_from_paddle_tpu(state))
    return jm, tm


def loss_and_grads(model, lib, ids, labels, amp, black=None):
    i, l = lib.to_tensor(ids), lib.to_tensor(labels)
    with lib.amp.auto_cast(enable=amp, level="O1", dtype="bfloat16",
                           custom_black_list=black):
        loss = model(i, labels=l)
    loss.backward()
    grads = {n: np.asarray(p.grad.numpy(), np.float32)
             for n, p in model.named_parameters()}
    model.clear_gradients()
    return float(loss.numpy()), grads


def gaps(ref, got):
    (lr, gr), (lg, gg) = ref, got
    worst = max(float(np.abs(gg[n] - g).max()) / float(np.abs(g).max())
                for n, g in gr.items())
    l2 = max(float(np.linalg.norm(gg[n] - g)) / float(np.linalg.norm(g))
             for n, g in gr.items())
    return abs(lg - lr) / abs(lr), worst, l2


def port_runs(tm, ids, labels):
    """name -> (loss, grads) of the port's run and of each control."""
    out = {"port": loss_and_grads(tm, tpaddle, ids, labels, True),
           "f32": loss_and_grads(tm, tpaddle, ids, labels, False),
           "attention f32": loss_and_grads(
               tm, tpaddle, ids, labels, True,
               black={"scaled_dot_product_attention"})}
    head = tm.lm_head.forward

    def head_f32(x):
        with tpaddle.amp.auto_cast(enable=False):
            return head(x)
    tm.lm_head.forward = head_f32
    try:
        out["lm_head f32"] = loss_and_grads(tm, tpaddle, ids, labels, True)
    finally:
        del tm.lm_head.forward
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=6)
    args = ap.parse_args()
    torch.set_num_threads(1)
    tpaddle.set_device("cpu")
    worst = {}
    for seed in range(args.seeds):
        jm, tm = pair(seed)
        ids = np.random.RandomState(11 + seed).randint(0, 256, (1, 128))
        labels = np.roll(ids, -1, axis=1)
        ref = loss_and_grads(jm, jpaddle, ids, labels, True)
        for name, got in port_runs(tm, ids, labels).items():
            g = gaps(ref, got)
            print(f"seed {seed} {name:14s} loss {g[0]:.3e}  grad max/leaf "
                  f"max {g[1]:.3e}  grad rel L2 {g[2]:.3e}", flush=True)
            w = worst.setdefault(name, [[], [], []])
            for k in range(3):
                w[k].append(g[k])
    print("over the seeds: smallest .. largest")
    for name, w in worst.items():
        print(f"{name:14s} loss {min(w[0]):.3e} .. {max(w[0]):.3e}  grad "
              f"max/leaf max {min(w[1]):.3e} .. {max(w[1]):.3e}  grad rel "
              f"L2 {min(w[2]):.3e} .. {max(w[2]):.3e}")


if __name__ == "__main__":
    main()
