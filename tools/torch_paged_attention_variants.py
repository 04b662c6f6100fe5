"""Development tool: build versions of the paged-attention kernel's source,
check each against the plain version, and time them in turns on one card.
Nothing on the port's path or in its tests uses it.

    python3 tools/torch_paged_attention_variants.py NAME=FILE... ORDER

Each NAME=FILE is a version of csrc/paged_attention.cu (FILE "csrc" means
the one in the tree; another version is kept anywhere in the checkout,
e.g. under build/, which .gitignore lists), compiled on its own with nvcc
(-I csrc for common.cuh) into paddle_tpu_torch/build/paged_variants/ and
called through its C entry pt_paged_attention with ctypes. ORDER names the
versions to time, in turns, e.g. "new,old,old,new", so that they are
compared inside one call on one card.

For each version it prints what `ptxas -v` says (registers and spills of
each instantiation), the worst error over the tolerance against the plain
version (chip_smoke._worst_of_tol, bf16 2**-6 and 1e-5, f32 1e-4 and 1e-6)
at chip_smoke's two shapes (PagedServingConfig.llama_1b()'s widths: 8 decode
rows at positions 18-177, and a 256-token chunked step), in bf16 and f32,
and whether its bf16 output equals the first version's bit for bit. Timed:
chip_smoke.time_ms (CUDA events around back-to-back calls, each call on the
next of the 16 layers' pools so it finds its pages cold; median of 7
windows of 48 calls) in turns, and the same on one layer's pools (whose
pages then stay in L2); then each version's device time a launch under
torch.profiler (chip_smoke.kernel_device_ms).
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

from chip_smoke import (_paged_inputs, _worst_of_tol,  # noqa: E402
                        kernel_device_ms, time_ms)
from paddle_tpu_torch.inference import PagedServingConfig  # noqa: E402
from paddle_tpu_torch.ops.kernels import _build  # noqa: E402
from paddle_tpu_torch.ops.kernels import paged_attention as PA  # noqa: E402

CSRC = os.path.join(HERE, "paddle_tpu_torch", "ops", "kernels", "csrc")
OUT = os.path.join(_build.BUILD_DIR, "paged_variants")
SHAPES = {"decode": [(1, p) for p in (18, 33, 50, 65, 80, 97, 130, 177)],
          "chunked": [(120, 64), (100, 90), (1, 170), (35, 0)]}


def build(name, src):
    os.makedirs(OUT, exist_ok=True)
    so = os.path.join(OUT, f"{name}.so")
    cmd = [_build._nvcc()] + _build.ARCH_FLAGS + [
        "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-shared", "-I", CSRC,
        "-Xptxas", "-v", src, "-o", so]
    p = subprocess.run(cmd, capture_output=True, text=True)
    if p.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{p.stderr}")
    regs = re.findall(r"Used (\d+) registers", p.stderr)
    spills = re.findall(r"(\d+) bytes spill stores", p.stderr)
    print(f"{name}: {len(regs)} kernels, registers {sorted(set(regs))}, "
          f"spill stores (bytes) {sorted(set(spills))}", flush=True)
    lib = ctypes.CDLL(so)
    fn = lib.pt_paged_attention
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P] * 7 + [I] * 7 + [ctypes.c_float, P]
    fn.restype = I
    return fn


def caller(fn, q, kc, vc, t2b, pos, bt):
    T, HQ, D = q.shape
    _, _, HKV, bs, _ = kc.shape
    dtype = PA._DTYPES[q.dtype]
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream().cuda_stream

    def call(layer):
        err = fn(q.data_ptr(), kc[layer].data_ptr(), vc[layer].data_ptr(),
                 out.data_ptr(), t2b.data_ptr(), pos.data_ptr(),
                 bt.data_ptr(), T, HQ, HKV, D, bs, bt.shape[1], dtype,
                 math.sqrt(D), stream)
        if err:
            raise RuntimeError(f"launch failed: cudaError_t {err}")
        return out
    return call


def main():
    *specs, order = sys.argv[1:]
    srcs = {}
    for spec in specs:
        name, path = spec.split("=", 1)
        srcs[name] = (os.path.join(CSRC, "paged_attention.cu")
                      if path == "csrc" else os.path.join(HERE, path))
    fns = {name: build(name, src) for name, src in srcs.items()}
    cfg = PagedServingConfig.llama_1b()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(17)
    L = cfg.num_layers
    inputs = {}
    for label, rows in SHAPES.items():
        for dtype, tol in ((torch.bfloat16, (2.0 ** -6, 1e-5)),
                           (torch.float32, (1e-4, 1e-6))):
            q, kc, vc, t2b, pos, bt = _paged_inputs(dev, cfg, rows, dtype,
                                                    gen)
            ref = PA._paged_attention_ref(q, kc[3], vc[3], t2b, pos, bt)
            first = None
            for name, fn in fns.items():
                got = caller(fn, q, kc, vc, t2b, pos, bt)(3).clone()
                torch.cuda.synchronize()
                same = first is None or torch.equal(got, first)
                first = got if first is None else first
                print(f"{label} {dtype} {name}: worst error / tol "
                      f"{_worst_of_tol(got, ref, *tol):.3f}, equal to the "
                      f"first version's bits: {same}", flush=True)
            if dtype == torch.bfloat16:
                inputs[label] = (q, kc, vc, t2b, pos, bt)
    names = order.split(",")
    for label, ins in inputs.items():
        calls = {name: caller(fns[name], *ins) for name in set(names)}
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
        print(f"{label}: ms a call in turns {order}: {times}; on one "
              f"layer's pools (L2-warm): {warm}", flush=True)
    for label, ins in inputs.items():
        for name in calls:
            call = caller(fns[name], *ins)
            turn = [0]

            def step(call=call):
                turn[0] = (turn[0] + 1) % L
                return call(turn[0])
            print(f"{label} {name}: device ms a launch "
                  f"{kernel_device_ms(step, 'paged_attention_kernel', 48)}",
                  flush=True)


if __name__ == "__main__":
    main()
