"""Drive the PyTorch/CUDA port (paddle_tpu_torch) once on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which fails the run with a non-zero exit:
  1. device and build: the card's name and power limit, then the CUDA
     kernels built from paddle_tpu_torch/ops/kernels/csrc with nvcc;
  2. kernels: each kernel against its plain PyTorch version at the serving
     path's shapes, then timed (CUDA events around 50 back-to-back
     calls, median of 7 such runs, after warm-up) beside its plain version
     and one PyTorch library call;
  3. serving: PagedServingConfig.llama_1b() at full width (16 layers,
     bf16, random weights from a seed) serves 8 requests through
     ServingEngine.from_model / add_request / step / decode_run; the
     kernels' launch counters must rise during that run;
  4. parity: a 2-layer full-width f32 engine's greedy streams equal its
     forward_dense greedy decode, and the bf16 16-layer engine's first-step
     logits are close to forward_dense;
  5. profile, last: each kernel's device time and the device time of a
     fresh-prefill step and of a decode window, by torch.profiler.
The last line is {"ok": true, "device": {...}}; the line before it holds
the kernels' numbers. Imports only torch, numpy and paddle_tpu_torch.
"""
import json
import os
import statistics
import subprocess
import sys
import time
from collections import Counter

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, dense bf16 tensor-core
# and f32 CUDA-core operations/s
HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12
F32_OPS_PER_S = 67e12


def log(*a):
    print(*a, flush=True)


def time_ms(fn, calls=50, windows=7, warmup=10):
    """Milliseconds per call: CUDA events around ``calls`` back-to-back
    calls, divided by ``calls``; the median over ``windows`` such runs.
    A call's host-side launch cost is inside the window, as the caller
    pays it."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(windows):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(calls):
            fn()
        e.record()
        e.synchronize()
        per_call.append(s.elapsed_time(e) / calls)
    return statistics.median(per_call)


def profile_kernels(fn, calls=1):
    """{kernel name: (launches, total device us)} of ``calls`` calls of
    ``fn`` under torch.profiler (CUPTI), device-side kernel rows only."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        if not str(getattr(evt, "device_type", "")).endswith("CUDA"):
            continue
        us = evt.self_device_time_total
        if us > 0:
            n, tot = out.get(evt.key, (0, 0.0))
            out[evt.key] = (n + evt.count, tot + us)
    return out


def kernel_device_ms(fn, kernel_symbol, calls=50):
    """Mean device time of one launch of the kernel whose name contains
    ``kernel_symbol`` (None when the profiler records no device time)."""
    fn()
    torch.cuda.synchronize()
    for key, (n, us) in profile_kernels(fn, calls).items():
        if kernel_symbol in key and n:
            return us / n / 1e3
    return None


def bound(nbytes, ops, ops_per_s):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def phase_device_and_build():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr}")
    log(smi.stdout.strip().splitlines()[0])
    from paddle_tpu_torch.ops.kernels import _build

    t0 = time.perf_counter()
    so = _build.build()
    _build.library()
    log(f"build: {time.perf_counter() - t0:.1f} s -> "
        f"{os.path.relpath(so, HERE)} (nvcc "
        f"{' '.join(_build.ARCH_FLAGS)})")


def _max_err(a, b):
    return float((a.float() - b.float()).abs().max())


def phase_kernels(dev):
    """Each kernel against its plain version, then its times."""
    from paddle_tpu_torch.ops.kernels import rms_norm as RN
    from paddle_tpu_torch.ops.kernels import varlen_attention as VA

    gen = torch.Generator(device=dev).manual_seed(0)
    results = {}

    # -- RMSNorm: bf16, one bf16 ulp (2**-7 relative): both round the same
    # f32 value, whose last bits differ (rsqrtf, sum order)
    h = 2048
    rms_err = 0.0
    for rows in (256, 8):
        x = (torch.randn(rows, h, device=dev, generator=gen) * 3) \
            .to(torch.bfloat16)
        w = torch.randn(h, device=dev, generator=gen).to(torch.bfloat16)
        for weight in (w, None):
            got = RN.rms_norm(x, weight)
            ref = RN._rms_norm_ref(x, weight, 1e-6)
            torch.cuda.synchronize()
            d = (got.float() - ref.float()).abs()
            ok = bool((d <= 2.0 ** -7 * ref.float().abs()).all())
            log(f"rms_norm [{rows}, {h}] bf16 weight={weight is not None}:"
                f" max_abs_err {float(d.max()):.3e} (tol 2**-7 * |ref|) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError("rms_norm kernel disagrees with its "
                                     "plain version")
            rms_err = max(rms_err, float(d.max()))
    x = (torch.randn(256, h, device=dev, generator=gen) * 3) \
        .to(torch.bfloat16)
    w = torch.randn(h, device=dev, generator=gen).to(torch.bfloat16)
    lib = getattr(torch.nn.functional, "rms_norm", None)
    b, by = bound(2 * x.numel() * 2 + h * 2, 4 * x.numel(), F32_OPS_PER_S)
    results["rms_norm"] = dict(
        name="rms_norm", route="cuda",
        source="paddle_tpu_torch/ops/kernels/csrc/rms_norm.cu",
        replaces="paddle_tpu/ops/pallas/rms_norm.py:31",
        max_abs_err=rms_err,
        ms=time_ms(lambda: RN.rms_norm(x, w)),
        plain_ms=time_ms(lambda: RN._rms_norm_ref(x, w, 1e-6)),
        bound_ms=b, bound_by=by,
        library_ms=(time_ms(lambda: lib(x, (h,), w, 1e-6))
                    if lib is not None else None),
        shape="x [256, 2048] bf16, weight [2048]")

    # -- varlen attention: the fresh-prefill shape, GQA 16q/8kv, D=128;
    # bf16 O within 2e-2 (P is rounded to bf16 before PV in the kernel, as
    # in the TPU kernel, not in the dense plain version; |O| <~ 3), LSE
    # within 1e-3 (f32 online vs dense logsumexp of bf16-valued logits)
    HQ, HKV, D = 16, 8, 128

    def varlen_case(lens, total):
        cu = np.concatenate([[0], np.cumsum(lens)])
        seg = torch.tensor(VA.segment_ids_from_cu_seqlens(cu, total),
                           device=dev)[None]
        q = torch.randn(1, HQ, total, D, device=dev, generator=gen) \
            .to(torch.bfloat16)
        k = torch.randn(1, HKV, total, D, device=dev, generator=gen) \
            .to(torch.bfloat16)
        v = torch.randn(1, HKV, total, D, device=dev, generator=gen) \
            .to(torch.bfloat16)
        return q, k, v, seg

    va_err = 0.0
    cases = {"T=256 three segments + padding tail":
             varlen_case([90, 60, 70], 256),
             "T=200 unaligned": varlen_case([120, 50, 30], 200)}
    for label, (q, k, v, seg) in cases.items():
        o, lse = VA.varlen_flash_attention_packed(q, k, v, seg, seg, True)
        o2, lse2 = VA._varlen_ref(q, k, v, seg, seg, True)
        torch.cuda.synchronize()
        eo, el = _max_err(o, o2), _max_err(lse, lse2)
        ok = eo <= 2e-2 and el <= 1e-3 \
            and bool(torch.isfinite(o.float()).all())
        log(f"varlen_attention {label} causal bf16: O max_abs_err "
            f"{eo:.3e} (tol 2e-2), LSE max_abs_err {el:.3e} (tol 1e-3) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("varlen attention kernel disagrees with "
                                 "its plain version")
        va_err = max(va_err, eo)
    q, k, v, seg = cases["T=256 three segments + padding tail"]
    T = q.shape[2]
    s = seg[0]
    pos = torch.arange(T, device=dev)
    pairs = int((((s[:, None] == s[None, :]) & (s[:, None] >= 0))
                 & (pos[:, None] >= pos[None, :])).sum())
    nbytes = (q.numel() + k.numel() + v.numel() + q.numel()) * 2 \
        + 2 * seg.numel() * 4 + HQ * T * 4
    b, by = bound(nbytes, 4 * D * HQ * pairs, BF16_OPS_PER_S)
    kr = k.repeat_interleave(HQ // HKV, dim=1)
    vr = v.repeat_interleave(HQ // HKV, dim=1)
    mask = ((s[:, None] == s[None, :]) & (pos[:, None] >= pos[None, :]))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    results["varlen_attention_fwd"] = dict(
        name="varlen_attention_fwd", route="cuda",
        source="paddle_tpu_torch/ops/kernels/csrc/varlen_attention.cu",
        replaces="paddle_tpu/ops/pallas/varlen_attention.py:52",
        max_abs_err=va_err,
        ms=time_ms(lambda: VA.varlen_flash_attention_packed(
            q, k, v, seg, seg, True)),
        plain_ms=time_ms(lambda: VA._varlen_ref(q, k, v, seg, seg, True)),
        bound_ms=b, bound_by=by,
        library_ms=time_ms(lambda: sdpa(q, kr, vr, attn_mask=mask)),
        shape=f"q [1, {HQ}, {T}, {D}], k/v [1, {HKV}, {T}, {D}] bf16, "
              f"{pairs} causal pairs")
    for r in results.values():
        log(f"{r['name']}: {r['ms']:.4f} ms a call, {r['plain_ms']:.4f} ms "
            f"plain, library {r['library_ms']} ms, bound "
            f"{r['bound_ms']:.5f} ms ({r['bound_by']})")
    # device-time probes, run under the profiler after the serving phase
    probes = {
        "rms_norm": (lambda: RN.rms_norm(x, w), "rms_norm_kernel"),
        "varlen_attention_fwd": (lambda: VA.varlen_flash_attention_packed(
            q, k, v, seg, seg, True), "varlen_fwd_kernel"),
    }
    return results, probes


def _prompts(rng, lens, vocab):
    return [list(rng.randint(1, vocab, n)) for n in lens]


def phase_serving(dev):
    """llama_1b at full width serves 8 requests; returns metrics, the
    kernels' launch counts of the measured run, the engine and prompts."""
    from paddle_tpu_torch import launch_counts, reset_launch_counts
    from paddle_tpu_torch.inference import (PagedCausalLM,
                                            PagedServingConfig,
                                            SamplingParams, ServingEngine)

    cfg = PagedServingConfig.llama_1b()
    t0 = time.perf_counter()
    model = PagedCausalLM(cfg, device=dev, seed=1234)
    torch.cuda.synchronize()
    log(f"llama_1b: {sum(p.numel() for p in model.parameters()) / 1e9:.3f}"
        f"B params, init {time.perf_counter() - t0:.1f} s")
    rng = np.random.RandomState(0)
    first = _prompts(rng, (128, 128), cfg.vocab_size)
    later = _prompts(rng, (32, 64, 96, 17, 50, 80), cfg.vocab_size)
    sampling = [None, SamplingParams(0.8, 50, 0.9), None,
                SamplingParams(1.0, 0, 0.95), SamplingParams(0.7, 20, 1.0),
                None, SamplingParams(0.9, 40, 0.8), None]
    max_new = 48

    def drive():
        eng = ServingEngine.from_model(model, cfg, seed=7, device=dev)
        rids = [eng.add_request(p, max_new_tokens=max_new,
                                sampling=sampling[i])
                for i, p in enumerate(first)]
        before = launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        eng.step()                       # fresh prefill: exactly 256 tokens
        torch.cuda.synchronize()
        t_fresh = time.perf_counter() - t
        per_step = {k: v - before[k] for k, v in launch_counts().items()}
        first_logits = eng.last_logits[:2].float().clone()
        rids += [eng.add_request(p, max_new_tokens=max_new,
                                 sampling=sampling[2 + i])
                 for i, p in enumerate(later)]
        t = time.perf_counter()
        n_steps = 0
        while any(r.length - r.cached > 1 for r in eng.pending()):
            eng.step()
            n_steps += 1
        torch.cuda.synchronize()
        t_fill = time.perf_counter() - t
        t = time.perf_counter()
        dec_steps = dec_tokens = 0
        while eng.pending():
            got = eng.decode_run(32)
            if not got:
                raise AssertionError("decode_run made no progress")
            dec_tokens += len(got)
            dec_steps += max(Counter(rid for rid, _ in got).values())
        t_dec = time.perf_counter() - t
        outs = {rid: list(r.generated) for rid, r in eng._requests.items()}
        return dict(eng=eng, rids=rids, outs=outs, t_fresh=t_fresh,
                    t_fill=t_fill, fill_steps=n_steps, t_dec=t_dec,
                    dec_steps=dec_steps, dec_tokens=dec_tokens,
                    per_step=per_step, first_logits=first_logits)

    drive()                              # warm-up: allocator, cuBLAS, lib
    reset_launch_counts()
    run = drive()
    counts = launch_counts()
    log(f"serving launch counts: {counts}; first (fresh-prefill) step: "
        f"{run['per_step']}")
    for name, n in counts.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"serving path")
    V = cfg.vocab_size
    for rid in run["rids"]:
        toks = run["outs"][rid]
        if len(toks) != max_new or not all(0 <= t < V for t in toks):
            raise AssertionError(f"request {rid}: bad output {toks[:8]}")
    prompt_tokens = sum(map(len, first + later))
    metrics = {
        "requests": len(run["rids"]),
        "fresh_prefill_tokens_per_s": 256 / run["t_fresh"],
        "fresh_prefill_step_ms": run["t_fresh"] * 1e3,
        "prefill_tokens_per_s": prompt_tokens
        / (run["t_fresh"] + run["t_fill"]),
        "mixed_steps_to_decode_tip": run["fill_steps"],
        "decode_steps": run["dec_steps"],
        "decode_ms_per_step": run["t_dec"] / run["dec_steps"] * 1e3,
        "decode_tokens_per_s": run["dec_tokens"] / run["t_dec"],
        "decode_mean_batch": run["dec_tokens"] / run["dec_steps"],
        "peak_memory_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
    }
    log(json.dumps({"serving": metrics}))
    return dict(metrics=metrics, counts=counts, run=run, model=model,
                cfg=cfg, first=first, prompts=first + later,
                sampling=sampling)


def phase_profile(dev, serving, kernels, probes):
    """Under torch.profiler, last (the profiler stays attached to the
    process once started, and would slow what follows): each kernel's
    device time, and the device time of one fresh-prefill step and of one
    16-step decode window at batch 8, beside the wall times of the
    unprofiled run — the device's busy share and its top kernels."""
    from paddle_tpu_torch.inference import ServingEngine

    for name, (fn, symbol) in probes.items():
        kernels[name]["device_ms"] = kernel_device_ms(fn, symbol)
        log(f"{name}: {kernels[name]['device_ms']} ms on the device")
    model, cfg = serving["model"], serving["cfg"]
    prompts, sampling = serving["prompts"], serving["sampling"]
    metrics = serving["metrics"]

    def summary(kernels, per):
        total = sum(us for _, us in kernels.values()) / 1e3 / per
        top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:6]
        return total, [{"kernel": k[:70], "launches": n // per,
                        "ms": us / 1e3 / per} for k, (n, us) in top]

    eng = ServingEngine.from_model(model, cfg, seed=7, device=dev)
    for i, p in enumerate(prompts[:2]):
        eng.add_request(p, max_new_tokens=40, sampling=sampling[i])
    fresh_ms, fresh_top = summary(profile_kernels(eng.step), 1)
    for i, p in enumerate(prompts[2:]):
        eng.add_request(p, max_new_tokens=40, sampling=sampling[2 + i])
    while any(r.length - r.cached > 1 for r in eng.pending()):
        eng.step()
    if len(eng.pending()) != 8:
        raise AssertionError("profile: the decode batch is not 8 rows")
    dec_ms, dec_top = summary(profile_kernels(lambda: eng.decode_run(16)),
                              16)
    prof = {
        "fresh_prefill_step_device_ms": fresh_ms,
        "fresh_prefill_device_busy": fresh_ms
        / metrics["fresh_prefill_step_ms"],
        "fresh_prefill_top": fresh_top,
        "decode_step_device_ms": dec_ms,
        "decode_device_busy": dec_ms / metrics["decode_ms_per_step"],
        "decode_top": dec_top,
    }
    log(json.dumps({"profile": prof}))
    return prof


def phase_parity(dev, serving):
    """(a) 2-layer f32 engine greedy == forward_dense greedy, token for
    token; (b) bf16 16-layer first-step logits near forward_dense."""
    run, model, first = serving["run"], serving["model"], serving["first"]
    from paddle_tpu_torch.inference import (PagedCausalLM,
                                            PagedServingConfig,
                                            ServingEngine)

    cfg = PagedServingConfig.llama_1b(num_layers=2, dtype="float32")
    m = PagedCausalLM(cfg, device=dev, seed=99)
    eng = ServingEngine.from_model(m, cfg, seed=0, device=dev)
    rng = np.random.RandomState(5)
    prompts = _prompts(rng, (128, 128, 40), cfg.vocab_size)
    n_new = 8
    rids = [eng.add_request(p, max_new_tokens=n_new) for p in prompts[:2]]
    eng.step()                                  # fresh prefill (kernels)
    rids.append(eng.add_request(prompts[2], max_new_tokens=n_new))
    outs = eng.run_to_completion()
    for rid, p in zip(rids, prompts):
        ids = list(p)
        with torch.inference_mode():
            for _ in range(n_new):
                lg = m.forward_dense(torch.tensor([ids], device=dev))
                ids.append(int(lg[0, -1].argmax()))
        if outs[rid] != ids[len(p):]:
            raise AssertionError(f"f32 greedy parity: request {rid} "
                                 f"{outs[rid]} != dense {ids[len(p):]}")
    log(f"parity (a) f32 2-layer full width: {len(rids)} greedy streams "
        f"equal forward_dense token for token")

    served = model._serving_shared[1]           # the bf16 serving copy
    worst = 0.0
    with torch.inference_mode():
        for i, p in enumerate(first):
            ref = served.forward_dense(torch.tensor([p], device=dev))[0, -1]
            got = run["first_logits"][i]
            rel = float((got - ref.float()).norm() / ref.float().norm())
            worst = max(worst, rel)
    # bf16 over 16 layers: the paged step (varlen kernel, P rounded to
    # bf16) and the dense path (f32 softmax) round at other places
    ok = worst <= 5e-2
    log(f"parity (b) bf16 16-layer first-step logits vs forward_dense: "
        f"relative L2 error {worst:.3e} (tol 5e-2) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("bf16 paged logits too far from dense")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs one CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import paddle_tpu_torch

    if not os.path.abspath(paddle_tpu_torch.__file__).startswith(
            HERE + os.sep):
        print(f"chip_smoke: paddle_tpu_torch is not beside this script "
              f"({paddle_tpu_torch.__file__})", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = paddle_tpu_torch.resolve_device("cuda")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    phase_device_and_build()
    kernels, probes = phase_kernels(dev)
    serving = phase_serving(dev)
    phase_parity(dev, serving)
    phase_profile(dev, serving, kernels, probes)
    counts, run = serving["counts"], serving["run"]
    line = []
    for name, r in kernels.items():
        r = dict(r)
        r["launches"] = counts[name]
        r["launches_per_step"] = run["per_step"][name]
        line.append(r)
    log(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
