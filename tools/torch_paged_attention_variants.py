"""Development tool: build versions of the paged-attention kernel's source,
check each against the plain version, and time them in turns on one card.
Nothing on the port's path or in its tests uses it.

    python3 tools/torch_paged_attention_variants.py NAME=FILE[@OLD@NEW]... ORDER

Each NAME=FILE is a version of csrc/paged_attention.cu (FILE "csrc" means
the one in the tree; another version is kept anywhere in the checkout,
e.g. under build/, which .gitignore lists: `git show
<commit>:paddle_tpu_torch/ops/kernels/csrc/paged_attention.cu >
build/old_paged.cu`), with the text OLD replaced by NEW where given (e.g.
"slots4=csrc@constexpr int kSlots = 6;@constexpr int kSlots = 4;"),
compiled on its own with nvcc (-I csrc for common.cuh)
into paddle_tpu_torch/build/paged_variants/ and called through
its C entries pt_paged_attention and pt_paged_attention_int8 with ctypes
(a version whose entries take no B, the batch rows, before the dtype is
called without it). ORDER names the versions to time, in turns, e.g.
"new,old,old,new", so that they are compared inside one call on one card.

For each version it prints what `ptxas -v` says (registers, spills and
stack of each instantiation) and, at chip_smoke's three shapes
(PagedServingConfig.llama_1b()'s widths: 8 decode rows at positions
18-177, a 256-token chunked step, and chip_smoke.PAGED_SHAPES' speculative
verify step, 8 rows of 5 tokens padded to 64), the worst error over the
tolerance against the plain version (chip_smoke._worst_of_tol, bf16 2**-6
and 1e-5, f32 1e-4 and 1e-6) over bf16, f32 and int8 pages (int8 with bf16
q), whether its output equals the first version's bit for bit, and whether
its int8 output equals its own bf16 output over pages holding the
dequantized values. Timed, for bf16 and int8 pages: chip_smoke.time_ms
(CUDA events around back-to-back calls, each call on the next of the 16
layers' pools so it finds its pages cold; median of 7 windows of 48 calls)
in turns, and the same on one layer's pools (whose pages then stay in L2);
then each version's device time a launch under torch.profiler
(chip_smoke.kernel_device_ms).
"""
import ctypes
import math
import os
import re
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

from chip_smoke import (PAGED_SHAPES, _paged_inputs,  # noqa: E402
                        _worst_of_tol, kernel_device_ms, time_ms)
from paddle_tpu_torch.inference import PagedServingConfig  # noqa: E402
from paddle_tpu_torch.ops.kernels import _build  # noqa: E402
from paddle_tpu_torch.ops.kernels import paged_attention as PA  # noqa: E402

CSRC = os.path.join(HERE, "paddle_tpu_torch", "ops", "kernels", "csrc")
OUT = os.path.join(_build.BUILD_DIR, "paged_variants")
SHAPES = {"decode": ([(1, p) for p in (18, 33, 50, 65, 80, 97, 130, 177)],
                     0), **PAGED_SHAPES}
TOLS = {torch.bfloat16: (2.0 ** -6, 1e-5), torch.float32: (1e-4, 1e-6)}


def build(name, src):
    """(bf16/f32 entry, int8 entry, takes B) of one version of the
    source."""
    os.makedirs(OUT, exist_ok=True)
    so = os.path.join(OUT, f"{name}.so")
    cmd = [_build._nvcc()] + _build.ARCH_FLAGS + [
        "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-shared", "-I", CSRC,
        "-Xptxas", "-v", src, "-o", so]
    p = subprocess.run(cmd, capture_output=True, text=True)
    if p.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{p.stderr}")
    for part in p.stderr.split("Compiling entry function '")[1:]:
        found = [re.search(pat, part) for pat in (
            r"Used (\d+) registers", r"(\d+) bytes stack frame",
            r"(\d+) bytes spill stores")]
        regs, stack, spill = [m.group(1) if m else "?" for m in found]
        print(f"{name}: {part.split(chr(39))[0][:100]}: {regs} registers, "
              f"stack {stack}, spill stores {spill}", flush=True)
    dump = subprocess.run(
        [os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump"), "-sass",
         so], capture_output=True, text=True).stdout
    for part in dump.split("Function : ")[1:]:
        fn = part.split("\n")[0]
        if "paged_attention" in fn:
            count = len(re.findall(r"/\*[0-9a-f]{4,}\*/", part))
            print(f"{name}: SASS {fn[:100]}: {count} instructions",
                  flush=True)
    text = open(src).read()
    takes_b = re.search(r"pt_paged_attention\([^)]*int max_blocks,\s*int B,",
                        text) is not None
    lib = ctypes.CDLL(so)
    P, I = ctypes.c_void_p, ctypes.c_int
    nb = 8 if takes_b else 7
    fns = []
    for entry, ptrs in (("pt_paged_attention", 7),
                        ("pt_paged_attention_int8", 9)):
        fn = getattr(lib, entry)
        fn.argtypes = [P] * ptrs + [I] * nb + [ctypes.c_float, P]
        fn.restype = I
        fns.append(fn)
    return fns[0], fns[1], takes_b


def caller(version, q, kc, vc, t2b, pos, bt, ks=None, vs=None):
    """call(layer) of one version over layer `layer` of the pools."""
    fn, fn8, takes_b = version
    T, HQ, D = q.shape
    _, _, HKV, bs, _ = kc.shape
    sizes = [T, HQ, HKV, D, bs, bt.shape[1]] + (
        [bt.shape[0]] if takes_b else []) + [PA._DTYPES[q.dtype]]
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream().cuda_stream

    def call(layer):
        if ks is None:
            err = fn(q.data_ptr(), kc[layer].data_ptr(),
                     vc[layer].data_ptr(), out.data_ptr(), t2b.data_ptr(),
                     pos.data_ptr(), bt.data_ptr(), *sizes, math.sqrt(D),
                     stream)
        else:
            err = fn8(q.data_ptr(), kc[layer].data_ptr(),
                      vc[layer].data_ptr(), ks[layer].data_ptr(),
                      vs[layer].data_ptr(), out.data_ptr(), t2b.data_ptr(),
                      pos.data_ptr(), bt.data_ptr(), *sizes, math.sqrt(D),
                      stream)
        if err:
            raise RuntimeError(f"launch failed: cudaError_t {err}")
        return out
    return call


def int8_pools(kc, gen):
    """int8 pools and f32 scale pools beside the float pools kc's shape,
    and the bf16 pools holding their dequantized values."""
    k8, v8 = [torch.randint(-127, 128, kc.shape, device=kc.device,
                            generator=gen, dtype=torch.int8)
              for _ in range(2)]
    ks, vs = [torch.rand(kc.shape[:-1], device=kc.device, generator=gen)
              * 0.03 + 1e-3 for _ in range(2)]
    kd = (k8.float() * ks[..., None]).to(torch.bfloat16)
    vd = (v8.float() * vs[..., None]).to(torch.bfloat16)
    return k8, v8, ks, vs, kd, vd


def main():
    *specs, order = sys.argv[1:]
    os.makedirs(OUT, exist_ok=True)
    srcs = {}
    for spec in specs:
        name, rest = spec.split("=", 1)
        path, *sub = rest.split("@")
        src = (os.path.join(CSRC, "paged_attention.cu") if path == "csrc"
               else os.path.join(HERE, path))
        if sub:
            text = open(src).read()
            if sub[0] not in text:
                raise SystemExit(f"{name}: {sub[0]!r} not in {src}")
            src = os.path.join(OUT, f"{name}.cu")
            with open(src, "w") as f:
                f.write(text.replace(sub[0], sub[1]))
        srcs[name] = src
    versions = {name: build(name, src) for name, src in srcs.items()}
    print("card:", subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)
    cfg = PagedServingConfig.llama_1b()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(17)
    L = cfg.num_layers
    inputs = {}
    for label, (rows, n_pad) in SHAPES.items():
        for dtype in (torch.bfloat16, torch.float32):
            q, kc, vc, t2b, pos, bt = _paged_inputs(dev, cfg, rows, dtype,
                                                    gen, n_pad)
            ref = PA._paged_attention_ref(q, kc[3], vc[3], t2b, pos, bt)
            first = None
            for name, ver in versions.items():
                got = caller(ver, q, kc, vc, t2b, pos, bt)(3).clone()
                torch.cuda.synchronize()
                same = first is None or torch.equal(got, first)
                first = got if first is None else first
                print(f"{label} T={q.shape[0]} {dtype} {name}: worst error "
                      f"/ tol {_worst_of_tol(got, ref, *TOLS[dtype]):.3f}, "
                      f"equal to the first version's bits: {same}",
                      flush=True)
            if dtype == torch.bfloat16:
                k8, v8, ks, vs, kd, vd = int8_pools(kc, gen)
                ref8 = PA._paged_attention_ref(q, k8[3], v8[3], t2b, pos, bt,
                                               ks[3], vs[3])
                first = None
                for name, ver in versions.items():
                    got = caller(ver, q, k8, v8, t2b, pos, bt, ks, vs)(3) \
                        .clone()
                    deq = caller(ver, q, kd, vd, t2b, pos, bt)(3).clone()
                    torch.cuda.synchronize()
                    same = first is None or torch.equal(got, first)
                    first = got if first is None else first
                    print(f"{label} int8 {name}: worst error / tol "
                          f"{_worst_of_tol(got, ref8, *TOLS[dtype]):.3f}, "
                          f"equal to the first version's bits: {same}, to "
                          f"its bf16 kernel over the dequantized pages: "
                          f"{torch.equal(got, deq)}", flush=True)
                inputs[label] = {
                    "bf16": (q, kc, vc, t2b, pos, bt),
                    "int8": (q, k8, v8, t2b, pos, bt, ks, vs)}
    names = order.split(",")
    for label, kinds in inputs.items():
        for kind, ins in kinds.items():
            calls = {name: caller(versions[name], *ins)
                     for name in set(names)}
            times = {name: [] for name in calls}
            warm = {name: [] for name in calls}
            for name in names:
                turn = [0]

                def step(call=calls[name]):
                    turn[0] = (turn[0] + 1) % L
                    return call(turn[0])
                times[name].append(time_ms(step, calls=48))
                warm[name].append(time_ms(lambda call=calls[name]: call(3),
                                          calls=48))
            print(f"{label} {kind}: ms a call in turns {order}: {times}; on "
                  f"one layer's pools (L2-warm): {warm}", flush=True)
    for label, kinds in inputs.items():
        for kind, ins in kinds.items():
            for name in versions:
                call = caller(versions[name], *ins)
                turn = [0]

                def step(call=call):
                    turn[0] = (turn[0] + 1) % L
                    return call(turn[0])
                print(f"{label} {kind} {name}: device ms a launch "
                      f"{kernel_device_ms(step, 'paged_attention', 48)}",
                      flush=True)


if __name__ == "__main__":
    main()
