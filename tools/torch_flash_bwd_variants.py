"""Development tool: build variants of the flash-attention backward source,
check each against the plain version, and time them in turns on one card.
Nothing on the port's path or in its tests uses it.

    python3 tools/torch_flash_bwd_variants.py VARIANTS ORDER

VARIANTS is a JSON object {name: [[old, new], ...]}: each variant is
csrc/flash_attention_bwd.cu (and csrc/common.cuh) with every `old` text
replaced by `new` (each must occur); a first pair ["DIR", path] takes both
files from `path` instead. ORDER names the variants to time, in turns,
e.g. "a,b,b,a", so that two versions are compared inside one call on one
card. For each variant the script prints what `ptxas -v` says of the bf16
kernels (registers, spills, wgmma serialization warnings), the worst
error over the tolerance of dQ, dK and dV against the plain version
(B=1 H=16 S=4096 D=128 causal, and B=2 H=4 S=1024 D=128 and 64 with key
padding and dropout 0.1, the fully padded sequence apart), then each
timed turn: dK/dV and dQ at the training shape [4, 16, 4096, 128] bf16
causal, chip_smoke.time_ms (CUDA events around 10 back-to-back calls,
median of 5 windows); errors by chip_smoke._worst_of_tol.
Variants are built under paddle_tpu_torch/build/variants/; the rest of
the library (the forward) is the repository's.
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

from chip_smoke import _worst_of_tol, time_ms  # noqa: E402
from paddle_tpu_torch.ops.kernels import _build  # noqa: E402
from paddle_tpu_torch.ops.kernels import flash_attention as FA  # noqa: E402

CSRC = os.path.join(HERE, "paddle_tpu_torch", "ops", "kernels", "csrc")
OUT = os.path.join(_build.BUILD_DIR, "variants")
ENTRIES = ("pt_flash_attention_bwd_dkv", "pt_flash_attention_bwd_dq")
TIMING = dict(calls=10, windows=5, warmup=3)


def build(variants):
    """{name: ctypes library} of the variants that compiled; prints ptxas's
    report of the bf16 kernels."""
    nvcc = _build._nvcc()
    procs = {}
    for name, subs in variants.items():
        d = os.path.join(OUT, name)
        os.makedirs(d, exist_ok=True)
        src = CSRC
        if subs and subs[0][0] == "DIR":
            src, subs = os.path.join(HERE, subs[0][1]), subs[1:]
        s = open(os.path.join(src, "flash_attention_bwd.cu")).read()
        for old, new in subs:
            if old not in s:
                raise ValueError(f"variant {name}: {old!r} not in the source")
            s = s.replace(old, new)
        with open(os.path.join(d, "flash_attention_bwd.cu"), "w") as f:
            f.write(s)
        shutil.copy(os.path.join(src, "common.cuh"), d)
        shutil.copy(os.path.join(CSRC, "rms_norm.cu"), d)  # pt_error_string
        procs[name] = [subprocess.Popen(
            [nvcc] + _build.NVCC_FLAGS + ["-Xptxas", "-v", "-c",
                                          os.path.join(d, f), "-o",
                                          os.path.join(d, f + ".o")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for f in ("flash_attention_bwd.cu", "rms_norm.cu")]
    libs = {}
    for name, ps in procs.items():
        out = ps[0].communicate()[0]
        ps[1].communicate()
        if ps[0].returncode or ps[1].returncode:
            print(f"{name}: build failed\n{out[-3000:]}")
            continue
        fn = None
        for line in out.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                fn = m.group(1)
            elif "wgmma" in line or "Performance" in line:
                print(f"  {name}: {line.strip()}")
            elif fn and "__nv_bfloat16" in fn and ("spill" in line
                                                   or "Used" in line):
                k = re.search(r"(dkv|dq)_kernelILi(\d+)", fn)
                print(f"  {name} {k.group(1)} D={k.group(2)}: "
                      f"{line.strip()}")
        d = os.path.join(OUT, name)
        so = os.path.join(d, "lib.so")
        r = subprocess.run([nvcc] + _build.ARCH_FLAGS + [
            "-shared", "-o", so, os.path.join(d, "flash_attention_bwd.cu.o"),
            os.path.join(d, "rms_norm.cu.o")], capture_output=True, text=True)
        if r.returncode:
            print(f"{name}: link failed\n{r.stdout}{r.stderr}")
            continue
        libs[name] = ctypes.CDLL(so)
    return libs


def use(lib):
    """Point the wrapper's two backward entries at ``lib``."""
    for n in ENTRIES:
        fn = getattr(lib, n)
        fn.argtypes, fn.restype = FA._entry(n).argtypes, ctypes.c_int
        FA._entries[n] = fn


def worst(got, ref):
    """chip_smoke's element-wise bf16 check (2**-6, 1e-5), rounded."""
    return round(_worst_of_tol(got, ref, 2 ** -6, 1e-5), 3)


def main():
    variants = json.loads(sys.argv[1])
    order = sys.argv[2].split(",")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip())
    _build.library()
    libs = build(variants)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)

    def inputs(b, h, s, d):
        return [torch.randn(b, h, s, d, device=dev, generator=gen)
                .to(torch.bfloat16) for _ in range(4)]

    cases = []
    q, k, v, do = inputs(1, 16, 4096, 128)
    o, lse = FA.forward_with_lse(q, k, v, None, 0, True, 0.0)
    args = (q, k, v, None, 0, o, lse, do, True, 0.0)
    cases.append(("S=4096 causal", args, FA._backward_ref(*args)))
    for d in (128, 64):
        q, k, v, do = inputs(2, 4, 1024, d)
        km = torch.zeros(2, 1024, device=dev)
        km[0, 341:] = -1e30
        km[1] = -1e30
        o, lse = FA.forward_with_lse(q, k, v, km, -7, False, 0.1)
        args = (q, k, v, km, -7, o, lse, do, False, 0.1)
        cases.append((f"S=1024 D={d} padding + dropout", args,
                      FA._backward_ref(*args)))
    for name, lib in libs.items():
        use(lib)
        for label, args, ref in cases:
            g = FA.backward(*args)
            torch.cuda.synchronize()
            live = slice(0, -1) if args[3] is not None else slice(None)
            msg = [worst(a[live], b[live]) for a, b in zip(g, ref)]
            if args[3] is not None:
                msg += ["padded:"] + [worst(a[-1:], b[-1:])
                                      for a, b in zip(g, ref)]
            print(f"  {name} {label}: dq dk dv worst/tol {msg}")
    del cases
    B = 4
    q, k, v, do = inputs(B, 16, 4096, 128)
    o, lse = FA.forward_with_lse(q, k, v, None, 0, True, 0.0)
    _, _, _, _, _, _, delta = FA._bwd_inputs(q, k, v, None, o, lse, do,
                                             True)
    pairs = B * 16 * 4096 * 4097 // 2
    for name in order:
        use(libs[name])
        a = time_ms(lambda: FA._launch_bwd_dkv(q, k, v, None, 0, do, lse,
                                               delta, True, 0.0), **TIMING)
        b = time_ms(lambda: FA._launch_bwd_dq(q, k, v, None, 0, do, lse,
                                              delta, True, 0.0), **TIMING)
        print(f"{name}: dkv {a:.3f} ms ({8 * 128 * pairs / a / 1e9:.1f} "
              f"TFLOP/s), dq {b:.3f} ms ({6 * 128 * pairs / b / 1e9:.1f} "
              f"TFLOP/s), sum {a + b:.3f}")


if __name__ == "__main__":
    main()
