"""Development tool: where a launch of the bf16 paged-attention kernel
spends its time, phase by phase, on one card. Nothing on the port's path or
in its tests uses it.

    python3 tools/torch_paged_attention_timeline.py

It copies csrc/paged_attention.cu with clock64() stamps inserted at the
kernel's phase boundaries (thread 0 of each block writes them to a
__device__ array, read back through an extra C entry), builds it with nvcc
on its own, runs 20 launches at each of chip_smoke's three shapes
(PagedServingConfig.llama_1b()'s widths: 8 decode rows at positions
18-177, PAGED_SHAPES' 256-token chunked step and speculative verify step),
each launch on the next layer's pools, and prints for the last launch the
SM cycles from each block's start to each stamp, median and maximum over
the blocks with a tile. The stamps sit on the kept-row route (rows of up to
three chunks of keys, all three shapes here). Environment:

    PROBE_INT8=1        int8 pages (and f32 scales) instead of bf16 pages
    PROBE_SUB=OLD@NEW   the kernel's text OLD replaced by NEW first (an
                        ablation; OLD must not touch the stamped lines)

A stamp is a volatile clock read: the compiler keeps it in order with the
kernel's other inline assembly (cp.async, ldmatrix, mma), not with plain
loads and stores, so a phase's boundary is good to some tens of cycles.
"""
import ctypes
import math
import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

from chip_smoke import PAGED_SHAPES, _paged_inputs  # noqa: E402
from paddle_tpu_torch.inference import PagedServingConfig  # noqa: E402
from paddle_tpu_torch.ops.kernels import _build  # noqa: E402

CSRC = os.path.join(HERE, "paddle_tpu_torch", "ops", "kernels", "csrc")
OUT = os.path.join(_build.BUILD_DIR, "paged_timeline")
SLOTS = 40                                  # stamps a block
# (text in the kernel, stamp index, stamp after the text (else before),
# phase name): the stamp marks the end of the phase
POINTS = [
    ("    auto slot_of = [&](int j) -> size_t {", 2, False, "slots table"),
    ("        refill(-1);\n", 3, True, "copies issued"),
    ("        land(0, nch);\n", 4, True, "K landed"),
    ("        logits(std::integral_constant<int, Lay::kKeep>{}, 0, 0);\n", 5,
     True, "logits"),
    ("        softmax(nch * KC, 0, true, true);\n", 6, True, "softmax"),
    ("        land(nch, 2 * nch);\n", 7, True, "V landed"),
    ("        pv(nch, (n + 15) / 16, 0);\n", 8, True, "P V"),
    ("    __syncthreads();          // before the next tile's scan and "
     "copies", 9, False, "stored"),
]


def stamp(k):
    return ("if (threadIdx.x == 0) g_stamps[(blockIdx.y * gridDim.x + "
            f"blockIdx.x) * {SLOTS} + {k}] = clock64();")


def instrumented_source():
    src = open(os.path.join(CSRC, "paged_attention.cu")).read()
    sub = os.environ.get("PROBE_SUB")
    if sub:
        old, new = sub.split("@", 1)
        if old not in src:
            raise SystemExit(f"PROBE_SUB: {old!r} not in the kernel")
        src = src.replace(old, new)
    for text, k, after, _ in POINTS:
        if text not in src:
            raise SystemExit(f"stamp point {text!r} not in the kernel")
        src = src.replace(text, text + "        " + stamp(k) + "\n"
                          if after else stamp(k) + "\n" + text, 1)
    head = "  const int warp = tid >> 5;\n  const int G = HQ / HKV;"
    if head not in src:
        raise SystemExit("kernel start not found")
    src = src.replace(head, head.replace(
        "const int G", stamp(0) + "\n  const int G"), 1)
    src = src.replace("namespace tc {\n", "namespace tc {\n__device__ long "
                      f"long g_stamps[65536 * {SLOTS}];\n", 1)
    src = src.replace("}  // namespace tc\n", "cudaError_t read_stamps(void* "
                      "dst, int n) {\n  return cudaMemcpyFromSymbol(dst, "
                      "g_stamps, n);\n}\n}  // namespace tc\n", 1)
    return src + ('\nextern "C" int pt_paged_timeline_read(void* dst, int n) '
                  '{ return tc::read_stamps(dst, n); }\n')


def build():
    os.makedirs(OUT, exist_ok=True)
    cu, so = os.path.join(OUT, "timeline.cu"), os.path.join(OUT,
                                                             "timeline.so")
    with open(cu, "w") as f:
        f.write(instrumented_source())
    p = subprocess.run([_build._nvcc()] + _build.ARCH_FLAGS + [
        "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-shared", "-I", CSRC,
        cu, "-o", so], capture_output=True, text=True)
    if p.returncode:
        raise RuntimeError(f"nvcc failed\n{p.stderr[-3000:]}")
    lib = ctypes.CDLL(so)
    P, I = ctypes.c_void_p, ctypes.c_int
    fn = lib.pt_paged_attention
    fn.argtypes = [P] * 7 + [I] * 8 + [ctypes.c_float, P]
    fn8 = lib.pt_paged_attention_int8
    fn8.argtypes = [P] * 9 + [I] * 8 + [ctypes.c_float, P]
    read = lib.pt_paged_timeline_read
    read.argtypes = [P, I]
    for f in (fn, fn8, read):
        f.restype = I
    return fn, fn8, read


def main():
    fn, fn8, read = build()
    int8 = os.environ.get("PROBE_INT8") == "1"
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(),
          "int8 pages" if int8 else "bf16 pages", flush=True)
    cfg = PagedServingConfig.llama_1b()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(17)
    shapes = {"decode": ([(1, p) for p in (18, 33, 50, 65, 80, 97, 130,
                                            177)], 0), **PAGED_SHAPES}
    stream = torch.cuda.current_stream().cuda_stream
    for label, (rows, n_pad) in shapes.items():
        q, kc, vc, t2b, pos, bt = _paged_inputs(dev, cfg, rows,
                                                torch.bfloat16, gen, n_pad)
        T, HQ, D = q.shape
        HKV, bs = kc.shape[2], kc.shape[3]
        sizes = (T, HQ, HKV, D, bs, bt.shape[1], bt.shape[0], 1)
        out = torch.empty_like(q)
        k8, v8 = [torch.randint(-127, 128, kc.shape, device=dev,
                                generator=gen, dtype=torch.int8)
                  for _ in range(2)]
        ks, vs = [torch.rand(kc.shape[:-1], device=dev, generator=gen)
                  * 0.03 + 1e-3 for _ in range(2)]
        for rep in range(20):
            layer = rep % kc.shape[0]
            if int8:
                err = fn8(q.data_ptr(), k8[layer].data_ptr(),
                          v8[layer].data_ptr(), ks[layer].data_ptr(),
                          vs[layer].data_ptr(), out.data_ptr(),
                          t2b.data_ptr(), pos.data_ptr(), bt.data_ptr(),
                          *sizes, math.sqrt(D), stream)
            else:
                err = fn(q.data_ptr(), kc[layer].data_ptr(),
                         vc[layer].data_ptr(), out.data_ptr(),
                         t2b.data_ptr(), pos.data_ptr(), bt.data_ptr(),
                         *sizes, math.sqrt(D), stream)
            if err:
                raise RuntimeError(f"launch failed: cudaError_t {err}")
        torch.cuda.synchronize()
        blocks = min((T + 31) // 32 + bt.shape[0], T) * HKV * ((
            HQ // HKV + 1) // 2)
        buf = torch.zeros(blocks * SLOTS, dtype=torch.int64)
        if read(buf.data_ptr(), buf.numel() * 8):
            raise RuntimeError("reading the stamps failed")
        st = buf.reshape(blocks, SLOTS)
        st = st[st[:, 9] > st[:, 0]]        # blocks that stored a tile
        print(f"{label}: {st.shape[0]} blocks with a tile; SM cycles from a "
              f"block's start to the end of each phase (median / max):")
        for _, k, _, name in POINTS:
            rel = (st[:, k] - st[:, 0]).float()
            print(f"  {name:14s} {float(rel.median()):8.0f} "
                  f"{float(rel.max()):8.0f}", flush=True)


if __name__ == "__main__":
    main()
