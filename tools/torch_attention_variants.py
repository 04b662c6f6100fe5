"""Development tool: build variants of the attention kernels' CUDA sources,
check each against the plain versions, and time them in turns on one card.
Nothing on the port's path or in its tests uses it.

    python3 tools/torch_attention_variants.py TARGET VARIANTS ORDER

TARGET is `fwd` (the flash and varlen forwards, csrc/flash_attention_fwd.cu
and csrc/varlen_attention.cu), `bwd` (the flash backward,
csrc/flash_attention_bwd.cu), `vbwd` (the varlen backward,
csrc/varlen_attention_bwd.cu) or `step` (the forwards' checks, then the
flagship training step). VARIANTS is a JSON object {name: [[old, new],
...]}: each variant is the whole csrc directory with every `old` text
replaced by `new` in whichever files hold it (each must occur in one); a
first pair ["DIR", path] takes the directory `path` instead (another
commit's csrc from an unpacked `git archive`). ORDER names the variants to
time, in turns, e.g. "a,b,b,a", so that versions are compared inside one
call on one card. Each variant is built into its own library under
paddle_tpu_torch/build/variants/ and loaded in turn as the wrappers'
library (`_build`), so the wrappers' own entry signatures apply.

For each variant the script prints what `ptxas -v` says of TARGET's bf16
kernels (registers, spills, wgmma serialization warnings), whether its
outputs equal the first variant's bit for bit, and the worst error over the
tolerance against the plain versions (chip_smoke._worst_of_tol, 2**-6,
1e-5; a fully padded sequence apart; LSE by its largest absolute error).
- fwd: O and LSE of the flash forward at B=1 H=16 S=4096 D=128 causal and
  at B=2 H=4 S=1024 D=128 and 64 with key padding and dropout 0.1, and of
  the varlen forward at 4096 tokens with a padding tail and a query segment
  with no valid key (causal and not, GQA 16/8) and at 16,384 tokens in the
  packed-training phase's 12 documents. Timed: the flash forward at the
  training shape [4, 16, 4096, 128] bf16 causal, the varlen forward at
  [1, 16, 16384, 128] for the 12 documents and for 4 x 4096.
- bwd: dQ, dK and dV of the flash backward at the same flash shapes.
  Timed: dK/dV and dQ at the training shape.
- vbwd: dQ, dK and dV of the varlen backward (H = 16, bf16) at 4096 tokens
  with a padding tail and a query segment with no valid key, causal and
  not, D = 128 and 64, and at 16,384 tokens in the 12 documents, causal;
  the forward is the first library's. Timed: dK/dV and dQ at
  [1, 16, 16384, 128] causal for the 12 documents and for 4 x 4096.
- step: timed, chip_smoke's flagship training step (HybridTrainer.step,
  batch 4, seq 4096, random weights and tokens), one trainer for all
  variants.
Times are chip_smoke.time_ms: CUDA events around 10 back-to-back calls
(1 a step), median of 5 windows.
"""
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

from chip_smoke import (PACKED_SEED, TRAIN_BATCH, TRAIN_SEQ,  # noqa: E402
                        _flagship_config, _packed_lens, _packed_segments,
                        _varlen_ref_by_head, _worst_of_tol, time_ms)
from paddle_tpu_torch.ops.kernels import _build  # noqa: E402
from paddle_tpu_torch.ops.kernels import flash_attention as FA  # noqa: E402
from paddle_tpu_torch.ops.kernels import varlen_attention as VA  # noqa: E402

CSRC = os.path.join(HERE, "paddle_tpu_torch", "ops", "kernels", "csrc")
OUT = os.path.join(_build.BUILD_DIR, "variants")
TARGETS = {"fwd": ("flash_attention_fwd.cu", "varlen_attention.cu"),
           "bwd": ("flash_attention_bwd.cu",),
           "vbwd": ("varlen_attention_bwd.cu",)}
TARGETS["step"] = TARGETS["fwd"]


def build(variants, target_files):
    """{name: ctypes library} of the variants that compiled and linked.
    Every .cu of a variant's directory is compiled by its own nvcc, all
    variants' at once; prints what ptxas says of the bf16 kernels of
    ``target_files``."""
    nvcc = _build._nvcc()
    procs = {}
    for name, subs in variants.items():
        d = os.path.join(OUT, name)
        shutil.rmtree(d, ignore_errors=True)
        os.makedirs(d)
        src = CSRC
        if subs and subs[0][0] == "DIR":
            src, subs = os.path.join(HERE, subs[0][1]), subs[1:]
        files = sorted(f for f in os.listdir(src)
                       if f.endswith((".cu", ".cuh")))
        texts = {f: open(os.path.join(src, f)).read() for f in files}
        for old, new in subs:
            hits = [f for f in files if old in texts[f]]
            if not hits:
                raise ValueError(f"variant {name}: {old!r} not in the source")
            for f in hits:
                texts[f] = texts[f].replace(old, new)
        for f, text in texts.items():
            with open(os.path.join(d, f), "w") as fh:
                fh.write(text)
        procs[name] = {f: subprocess.Popen(
            [nvcc] + _build.NVCC_FLAGS + ["-Xptxas", "-v", "-c",
                                          os.path.join(d, f), "-o",
                                          os.path.join(d, f + ".o")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for f in files if f.endswith(".cu")}
    libs = {}
    for name, ps in procs.items():
        outs = {f: p.communicate()[0] for f, p in ps.items()}
        if any(p.returncode for p in ps.values()):
            print(f"{name}: build failed\n"
                  + "\n".join(o[-3000:] for f, o in outs.items()
                              if ps[f].returncode))
            continue
        fn = None
        for line in "\n".join(outs[f] for f in target_files).splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                fn = m.group(1)
            elif "wgmma" in line or "Performance" in line:
                print(f"  {name}: {line.strip()}")
            elif fn and "__nv_bfloat16" in fn and ("spill" in line
                                                   or "Used" in line):
                # <D>, or an older commit's <bf16, D> or <D, PLAIN>
                k = re.search(r"((?:flash|varlen)_(?:fwd|bwd_dkv|bwd_dq))"
                              r"_kernelI(?:13__nv_bfloat16)?Li(\d+)E"
                              r"(?:Lb([01]))?", fn)
                print(f"  {name} {k.group(1)} D={k.group(2)}"
                      f"{' plain' if k.group(3) == '1' else ''}: "
                      f"{line.strip()}")
        d = os.path.join(OUT, name)
        so = os.path.join(d, "lib.so")
        r = subprocess.run([nvcc] + _build.ARCH_FLAGS + ["-shared", "-o", so]
                           + [os.path.join(d, f + ".o") for f in ps],
                           capture_output=True, text=True)
        if r.returncode:
            print(f"{name}: link failed\n{r.stdout}{r.stderr}")
            continue
        libs[name] = ctypes.CDLL(so)
    return libs


def use(lib):
    """Make ``lib`` the wrappers' kernel library: their entries are looked
    up in it anew, with their own argument types."""
    _build._lib = lib
    FA._entries.clear()
    VA._entries.clear()


def worst(got, ref):
    """chip_smoke's element-wise bf16 check (2**-6, 1e-5), rounded, of an
    output [B, H, S, D]; the largest absolute error of an LSE [B, H, S]."""
    if got.dim() == 3:
        return f"LSE {float((got - ref).abs().max()):.2e}"
    return round(_worst_of_tol(got, ref, 2 ** -6, 1e-5), 3)


def _flash_cases(rnd, dev):
    """(label, q, k, v, key bias, causal, dropout) of the flash checks."""
    cases = [("S=4096 causal", *(rnd(1, 16, 4096, 128) for _ in range(3)),
              None, True, 0.0)]
    for d in (128, 64):
        km = torch.zeros(2, 1024, device=dev)
        km[0, 341:] = -1e30
        km[1] = -1e30
        cases.append((f"S=1024 D={d} padding + dropout",
                      *(rnd(2, 4, 1024, d) for _ in range(3)), km, False,
                      0.1))
    return cases


def fwd_checks(rnd, dev):
    """(label, call, (O, LSE) of the plain version, padded last batch)."""
    cases = []
    for label, q, k, v, km, causal, p in _flash_cases(rnd, dev):
        args = (q, k, v, km, -7, causal, p)
        cases.append((f"flash {label}",
                      lambda a=args: FA.forward_with_lse(*a),
                      FA._forward_ref(*args), km is not None))
    seg = _packed_segments(_packed_lens(4000, PACKED_SEED + 1), 4096, dev)
    segk = seg.clone()
    segk[segk == 1] = 10 ** 6
    q, k, v = rnd(1, 16, 4096, 128), rnd(1, 8, 4096, 128), \
        rnd(1, 8, 4096, 128)
    for causal in (True, False):
        cases.append((f"varlen T=4096 padding + dead segment causal={causal}",
                      lambda q=q, k=k, v=v, c=causal: VA._launch(
                          q, k, v, seg, segk, c),
                      VA._varlen_ref(q, k, v, seg, segk, causal), False))
    seg12 = _packed_segments(_packed_lens(16384, PACKED_SEED), 16384, dev)
    q, k, v = (rnd(1, 16, 16384, 128) for _ in range(3))
    cases.append(("varlen T=16384 12 documents",
                  lambda: VA._launch(q, k, v, seg12, seg12, True),
                  _varlen_ref_by_head(q, k, v, seg12, True), False))
    return cases


def bwd_checks(rnd, dev):
    """The same, for dQ, dK and dV; the forward is the library's own."""
    cases = []
    for label, q, k, v, km, causal, p in _flash_cases(rnd, dev):
        do = rnd(*q.shape)
        o, lse = FA.forward_with_lse(q, k, v, km, -7, causal, p)
        args = (q, k, v, km, -7, o, lse, do, causal, p)
        cases.append((f"flash {label}", lambda a=args: FA.backward(*a),
                      FA._backward_ref(*args), km is not None))
    return cases


def vbwd_checks(rnd, dev):
    """The same, for the varlen backward's dQ, dK and dV."""
    cases = []
    seg = _packed_segments(_packed_lens(4000, PACKED_SEED + 1), 4096, dev)
    segk = seg.clone()
    segk[segk == 1] = 10 ** 6
    seg12 = _packed_segments(_packed_lens(16384, PACKED_SEED), 16384, dev)
    for label, n, d, sq, sk, causal in (
            ("T=4096 padding + dead segment causal", 4096, 128, seg, segk,
             True),
            ("T=4096 padding + dead segment", 4096, 128, seg, segk, False),
            ("T=4096 D=64 padding + dead segment causal", 4096, 64, seg,
             segk, True),
            ("T=16384 12 documents causal", 16384, 128, seg12, seg12,
             True)):
        q, k, v, do = (rnd(1, 16, n, d) for _ in range(4))
        o, lse = VA._launch(q, k, v, sq, sk, causal)
        args = (q, k, v, sq, sk, o, lse, do, causal)
        cases.append((f"varlen {label}",
                      lambda a=args: VA._launch_bwd(*a),
                      VA._varlen_bwd_ref(*args), False))
    return cases


def fwd_timers(rnd, dev):
    """{label: (call, operations, calls a window)} of the timed
    forwards."""
    q, k, v = (rnd(4, 16, 4096, 128) for _ in range(3))
    timers = {"flash": (lambda: FA.forward_with_lse(q, k, v, None, 0, True,
                                                    0.0),
                        4 * 128 * 4 * 16 * 4096 * 4097 // 2, 10)}
    qv, kv, vv = (rnd(1, 16, 16384, 128) for _ in range(3))
    for mix, lens in (("12 docs", _packed_lens(16384, PACKED_SEED)),
                      ("4x4096", [4096] * 4)):
        s = _packed_segments(lens, 16384, dev)
        n = torch.tensor(lens, dtype=torch.float64)
        timers[f"varlen {mix}"] = (
            lambda s=s: VA._launch(qv, kv, vv, s, s, True),
            int(4 * 128 * 16 * (n * (n + 1) / 2).sum()), 10)
    return timers


def bwd_timers(rnd, dev):
    q, k, v, do = (rnd(4, 16, 4096, 128) for _ in range(4))
    o, lse = FA.forward_with_lse(q, k, v, None, 0, True, 0.0)
    delta = FA._bwd_inputs(q, k, v, None, o, lse, do, True)[-1]
    pairs = 4 * 16 * 4096 * 4097 // 2
    return {"dkv": (lambda: FA._launch_bwd_dkv(q, k, v, None, 0, do, lse,
                                               delta, True, 0.0),
                    8 * 128 * pairs, 10),
            "dq": (lambda: FA._launch_bwd_dq(q, k, v, None, 0, do, lse,
                                             delta, True, 0.0),
                   6 * 128 * pairs, 10)}


def vbwd_timers(rnd, dev):
    q, k, v, do = (rnd(1, 16, 16384, 128) for _ in range(4))
    timers = {}
    for mix, lens in (("12 docs", _packed_lens(16384, PACKED_SEED)),
                      ("4x4096", [4096] * 4)):
        s = _packed_segments(lens, 16384, dev)
        o, lse = VA._launch(q, k, v, s, s, True)
        delta = (do.float() * o.float()).sum(-1)
        n = torch.tensor(lens, dtype=torch.float64)
        pairs = 16 * (n * (n + 1) / 2).sum()
        args = (q, k, v, s, s, do, lse, delta, True)
        timers[f"dkv {mix}"] = (lambda a=args: VA._launch_bwd_dkv(*a),
                                int(8 * 128 * pairs), 10)
        timers[f"dq {mix}"] = (lambda a=args: VA._launch_bwd_dq(*a),
                               int(6 * 128 * pairs), 10)
    return timers


def step_timers(rnd, dev):
    from paddle_tpu_torch.distributed.fleet import HybridTrainer

    cfg = _flagship_config()
    trainer = HybridTrainer(cfg, learning_rate=3e-4, seed=1234, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    ids = torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ),
                        device=dev, generator=gen)
    labels = torch.roll(ids, -1, 1)
    return {"training step": (lambda: trainer.step(ids, labels), None, 1)}


def main():
    target = sys.argv[1]
    variants = json.loads(sys.argv[2])
    order = sys.argv[3].split(",")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip())
    main_lib = _build.library()
    libs = build(variants, TARGETS[target])
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)

    def rnd(*shape):
        return torch.randn(*shape, device=dev, generator=gen) \
            .to(torch.bfloat16)

    checks, timers = {"fwd": (fwd_checks, fwd_timers),
                      "bwd": (bwd_checks, bwd_timers),
                      "vbwd": (vbwd_checks, vbwd_timers),
                      "step": (fwd_checks, step_timers)}[target]
    use(main_lib)
    cases = checks(rnd, dev)
    first = {}
    for name, lib in libs.items():
        use(lib)
        for label, call, ref, padded in cases:
            got = call()
            torch.cuda.synchronize()
            live = slice(0, -1) if padded else slice(None)
            msg = [f"{worst(a[live], b[live])}" for a, b in zip(got, ref)]
            if padded:
                msg += ["padded:"] + [f"{worst(a[-1:], b[-1:])}"
                                      for a, b in zip(got, ref)]
            if label not in first:
                first[label] = (name, got)
            else:
                same = all(torch.equal(a, b)
                           for a, b in zip(got, first[label][1]))
                msg.append(f"equal {first[label][0]}'s bits: {same}")
            print(f"  {name} {label}: worst/tol " + " ".join(msg))
    del cases, first
    use(main_lib)
    timed = timers(rnd, dev)
    for name in order:
        use(libs[name])
        msg, total = [], 0.0
        for label, (call, ops, calls) in timed.items():
            t = time_ms(call, calls=calls, windows=5, warmup=3)
            total += t
            msg.append(f"{label} {t:.3f} ms"
                       + (f" ({ops / t / 1e9:.1f} TFLOP/s)" if ops else ""))
        print(f"{name}: " + ", ".join(msg) + f"; sum {total:.3f} ms")


if __name__ == "__main__":
    main()
