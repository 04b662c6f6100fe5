"""Does the CPU side of chip_smoke.py's training-parity check move from one
fresh process to the next?

    python tools/cpu_reference_spread.py [--runs 8]   (needs one CUDA card)

The check (chip_smoke.py::phase_training_parity) holds the loss and every
gradient of a 2-layer full-width f32 Llama at B=1, S=512 on the card
against the same weights on the CPU, each gradient element within
1e-3 * (|ref| + its row's RMS) + 1e-12. This script computes the card's
side twice in this process (no atomics in the kernels: the same bits
expected), then the CPU's side in fresh processes, one at a time: first
on one PyTorch thread, then ``--runs`` times on PyTorch's default thread
count, as the check ran before it pinned one thread. Each CPU run is held
to the card with the check's tolerance and compared with the one-thread
run. Prints one JSON line a run, then a summary line. Weights and
gradients pass between the processes through files under build/
(gitignored), removed at the end.
"""
import argparse
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke as CS  # noqa: E402
from paddle_tpu_torch.models import llama as TL  # noqa: E402


def parity_config():
    """chip_smoke.py's training-parity model: the flagship at 2 layers, f32."""
    return TL.LlamaConfig(**{**vars(CS._flagship_config()),
                             "num_hidden_layers": 2, "dtype": "float32"})


def loss_and_grads(params, cfg, where):
    """The loss and every gradient leaf (on the CPU) of one batch, as
    phase_training_parity computes them."""
    p = {k: ({kk: vv.detach().to(where).requires_grad_(True)
              for kk, vv in v.items()} if isinstance(v, dict)
             else v.detach().to(where).requires_grad_(True))
         for k, v in params.items()}
    rng = np.random.RandomState(3)
    ids = torch.tensor(rng.randint(0, cfg.vocab_size,
                                   (1, min(512, cfg.max_position_embeddings))))
    labels = torch.roll(ids, -1, dims=1)
    loss = TL.loss_fn_stacked(p, (ids.to(where), labels.to(where)), cfg)
    loss.backward()
    return float(loss.detach()), {k: t.grad.detach().cpu()
                                  for k, t in TL.leaves(p).items()}


def compare(got, ref):
    """got, ref = (loss, grads): the loss's relative difference, the worst
    gradient element over the check's tolerance and its leaf, and whether
    every gradient is the same bits."""
    (loss, grads), (ref_loss, ref_grads) = got, ref
    ratios = {k: CS._worst_of_tol(grads[k], ref_grads[k], 1e-3, 1e-12)
              for k in ref_grads}
    worst = max(ratios, key=ratios.get)
    return {"loss_rel": abs(loss - ref_loss) / abs(ref_loss),
            "worst_ratio": ratios[worst], "worst_leaf": worst,
            "same_bits": all(torch.equal(grads[k], ref_grads[k])
                             for k in ref_grads)}


def child(work, threads, name):
    if threads:
        torch.set_num_threads(threads)
    saved = torch.load(os.path.join(work, "params.pt"))
    cfg = TL.LlamaConfig(**saved["cfg"])
    got = loss_and_grads(saved["params"], cfg, torch.device("cpu"))
    out = {"run": name, "threads": torch.get_num_threads(), "loss": got[0],
           "vs_card": compare(got, torch.load(os.path.join(work,
                                                           "card.pt")))}
    one = os.path.join(work, "cpu_one_thread.pt")
    if os.path.exists(one):
        out["vs_one_thread"] = compare(got, torch.load(one))
    else:
        torch.save(got, one)
    print(json.dumps(out), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--runs", type=int, default=8,
                    help="CPU runs on the default thread count")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--threads", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--name", default="", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        child(args.child, args.threads, args.name)
        return 0
    dev = torch.device("cuda")
    if not torch.cuda.is_available():
        print("cpu_reference_spread: no CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    work = os.path.join(HERE, "build", "cpu_reference_spread")
    os.makedirs(work, exist_ok=True)
    try:
        cfg = parity_config()
        params = TL.init_stacked_params(cfg, seed=7, device=dev)
        card = loss_and_grads(params, cfg, dev)
        again = loss_and_grads(params, cfg, dev)
        print(json.dumps({"run": "card twice", "loss": card[0],
                          "repeat": compare(again, card)}), flush=True)
        torch.save(card, os.path.join(work, "card.pt"))
        torch.save({"cfg": vars(cfg),
                    "params": {k: ({kk: vv.cpu() for kk, vv in v.items()}
                                   if isinstance(v, dict) else v.cpu())
                               for k, v in params.items()}},
                   os.path.join(work, "params.pt"))
        del params, card, again
        rows = []
        for name, threads in [("one thread", 1)] + [
                (f"default threads {i}", 0) for i in range(args.runs)]:
            res = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--child", work,
                 "--threads", str(threads), "--name", name],
                check=True, capture_output=True, text=True)
            rows.append(json.loads(res.stdout.strip().splitlines()[-1]))
            print(json.dumps(rows[-1]), flush=True)
        multi = [r for r in rows if "vs_one_thread" in r]
        print(json.dumps({"summary": {
            "runs_on_default_threads": len(multi),
            "threads": sorted({r["threads"] for r in multi}),
            "worst_ratio_vs_card": [r["vs_card"]["worst_ratio"]
                                    for r in rows],
            "failing_the_check": sum(r["vs_card"]["worst_ratio"] > 1
                                     for r in rows),
            "differing_from_one_thread": sum(
                not r["vs_one_thread"]["same_bits"] for r in multi),
            "distinct_losses": len({r["loss"] for r in multi}),
        }}), flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
