"""Drive the PyTorch/CUDA port (paddle_tpu_torch) once on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which fails the run with a non-zero exit:
  1. device and build: the card's name and power limit, then the CUDA
     kernels built from paddle_tpu_torch/ops/kernels/csrc with nvcc, and
     the count of tensor-core instructions (HGMMA, HMMA) in the bf16
     attention kernels' SASS (flash and varlen, forward and backward) where
     cuobjdump is found (printed, and in the kernels line); beside the
     build, nvcc -Xptxas -v of the flash sources: each bf16
     instantiation's registers and spill (printed, and in the kernels
     line);
  2. kernels: each kernel against its plain PyTorch version at its path's
     shapes (the varlen backward kernels with exact zeros on padding rows
     and keys; the RMSNorm gradient at the serving and training shapes;
     RMSNorm forward and gradient with f32 x at the eager path's shape,
     [16384, 2048]; and at h = 100 and 40,000), then timed (CUDA
     events around back-to-back calls, median of several such runs, after
     warm-up; RMSNorm's host-bound serving-shape call in turns with its
     plain version and F.rms_norm) beside its plain version and one
     PyTorch library call; the flash kernels also run twice at the training
     shape, the varlen forward at the packed shape and the RMSNorm
     gradient at the training and eager shapes, and must give the same
     bits; the varlen forward and backward kernels are timed at both
     document mixes, with the share of the causal tiles the skip's rule
     keeps and the backward's tiles a block (both computed from the
     segment ids, in the log only), and the TFLOP/s over the
     within-segment pairs;
  2b. the flash kernels at head dim 64 with dropout 0.1 (seeds from the
     port's generator), their general instantiations at the pretraining
     shapes: BERT-base [32, 12, 512, 64], with and without a key-padding
     bias, and GPT-2 [8, 12, 1024, 64] causal; O, LSE, dQ, dK and dV held
     to the plain versions as in phase 2, then each kernel timed beside its
     bound, its plain version and SDPA with dropout_p=0.1 (new *_d64_* rows
     of the kernels line); and the BERT shape's second half of the batch
     with the dropout hash's bh offset (a data-parallel rank's rows): O
     held to the whole batch's plain version, the gradients to the
     shard's at that offset;
  2c. sep: the ring attention's hops at the training shape (q/k/v [4, 16,
     4096, 128] bf16 causal) for 2 and 4 virtual sep ranks on this card,
     composed from ops/kernels/ring_attention.py's own hop functions (every
     shard already on the card; the --hybrid jobs run the exchange): O,
     LSE, dQ, dK and dV held to the whole sequence's flash call, the
     launches held exactly (n(n+1)/2 forward, dK/dV and dQ), the
     composition's forward + backward timed beside the whole call's (the
     "sep" path of the kernels line);
  3. serving: PagedServingConfig.llama_1b() at full width (16 layers,
     bf16, random weights from a seed) serves 8 requests through
     ServingEngine.from_model / add_request / step / decode_run, twice on
     one engine: the first drive captures the decode windows' CUDA graphs
     (their count and capture ms are printed; its decode is the all-in
     figure), the second is measured over windows whose graphs exist; the
     serving kernels' launch counters (RMSNorm, the varlen forward, paged
     attention, RoPE-and-append) must rise during that run, the RMSNorm
     gradient must not launch, and no input be copied to a 16-byte
     boundary; then 8 more requests decode through the graphs and, in
     turns, through the eager runner of the same window body on a second
     engine: each window's tokens must be equal bit for bit, and a replayed
     window must count RMSNorm 33, paged attention 16 and rope_append 16
     launches a step;
  3b. paged attention: the kernel against its plain version in bf16 and
     f32 at the flagship decode shape (8 rows at the positions the serving
     phase's decode started from) and at a 256-token chunked step, then
     timed (over the 16 layers' pools in turn, so each call finds its
     pages cold) beside its plain version and SDPA on the gathered view;
  3c. the int8 cache-KV kernels: kv_quant against its plain version, codes
     and scales bit for bit, at the decode shape (8 tokens) and the
     256-token step, bf16 and f32, with a tie head and an all-zero head;
     the int8 paged-attention kernel against its plain version at 3b's two
     shapes (bf16 and f32 q), and bit for bit against the float kernel over
     pages holding the same dequantized values; both timed (the int8 paged
     kernel in turns with the bf16 kernel on the same rows and SDPA on the
     dequantized gathered view); then rope_append (RoPE of q and k, k and
     v cast or quantized into their pages, one launch a layer) against its
     plain version bit for bit (q, k and v, and every pool byte outside the
     trash page 0, whose slots the padding tokens share) at the decode
     shape, the verify step and the 256-token chunked and fresh-prefill
     steps, in both output layouts, bf16 and f32 q, float and int8 pages
     (a tie head and an all-zero head), then timed in turns with its plain
     version and with the composition it replaced (the plain version's
     tensor ops with the page scatter, or with the old kv_quant kernel);
  3a. the deploy artifact: save_paged_model of the serving phase's model
     and ServingEngine(path, cfg) (timed; bytes on disk); one fixed
     256-token step through the loaded program against the live model's
     forward (relative L2 within 5e-2); the serving phase's 8 requests
     through the artifact engine, twice: its first (eager) step and a
     replayed window must count RMSNorm 33, rope_append 16, paged attention
     16 and varlen 0 a step (the kernels reached through their registered
     ops); decode ms/step in turns with the from_model engine's windows; a
     2-layer f32 artifact engine's greedy streams equal the from_model
     engine's; deadlines (a zero deadline evicted at the next step, a
     passed one after a step, pages back, requeue_hook told); and a small
     MLP artifact saved on the CPU served on the card by create_predictor
     against the CPU's eager output;
  4. parity: a 2-layer full-width f32 engine's greedy streams through
     decode_run's replayed graphs equal its forward_dense greedy decode;
     through speculative verify steps, prefix-cache hits and int8 pools
     (the last held to the plain versions run on the card's tensors) they
     equal the plain engine's; the bf16 16-layer engine's first-step
     logits are close to forward_dense; and its greedy streams over the
     serving phase's 8 prompts through rope_append equal, token for token,
     the same engine's with only rope_append patched to its plain version;
  4b. int8 serving: llama_1b(cache_quant="int8") drives the serving phase's
     requests twice (captures, then measured): a replayed decode step must
     count RMSNorm 33, int8 paged attention 16, rope_append 16, kv_quant 0
     and bf16 paged attention 0; its tokens against the bf16 engine's (equal count and
     first divergence, printed), its pools' bytes and peak memory, and its
     windows' graphs against the eager runner, token for token;
  4c. prefix cache: 8 requests sharing a 96-token prefix, with and without
     the cache: prefill tokens computed, time to first token of requests
     2-8, every page back in the pool or the cache with refcounts 0;
  4d. speculative decoding: NGramDrafter, k = 4, prompts of a repeated
     random segment: acceptance, tokens a row a verify step and ms an
     emitted token, in turns with plain eager step() and the graph
     windows of the same engine;
  4e. weight streaming and versions: the weight-dequant kernel bit for bit
     against its plain version (the llama_1b layer group and an odd group,
     int8 and int4, bf16 and f32 out), timed beside its plain version and
     its bound; engines with weight_stream "int4", "int8" and
     "int8-noprefetch" drive the serving phase's requests twice (a replayed
     decode step must count RMSNorm 33, paged attention 16, weight_dequant
     16 and rope_append 16), their tokens equal to a plain bf16 engine's over
     the dequantized weights, their weights' bytes and peak memory;
     measure_stream_win (prefetch against no prefetch, three turns); live
     weight versions on the int8 engine (build, stage, probe, commit under
     rows in flight, rollback, gc; every stream against a single-version
     engine, memory back); and a dropped engine's memory returned;
  5. training: the flagship Llama row (vocab 32000, hidden 2048, ffn 5632,
     16 layers, 16 heads, bf16, recompute; batch 4, seq 4096) takes one
     warm-up and 3 timed HybridTrainer steps; every step must launch the
     flash-attention forward 32 times, its dK/dV and dQ kernels 16 times
     each, RMSNorm 65 times and its gradient 33 times, and copy no input to
     a 16-byte boundary;
     the step time and peak memory under each remat policy (the timed
     steps are "full"; then "save_attn", which must launch the forward 16
     times a step, and whose forward must leave held the layers' attention
     outputs and LSEs beside what "full" holds, no more); then a 2-layer
     full-width f32 model's loss and every
     gradient on the card are held against the same weights on the CPU
     (plain versions);
  6. packed training: flash_attn_unpadded at the flagship's attention
     width (16 heads of 128, bf16) over 16,384 packed tokens (the
     training row's 4 x 4096) in ~14 documents, q/k/v projected from a
     hidden state, causal, 1 warm-up and 3 timed forward + backward steps;
     every step must launch the varlen forward, dK/dV and dQ kernels once
     each, no other kernel, and copy no input to a 16-byte boundary; a total of 16,300 tokens (padded to 16,384) must give the
     padding rows exactly zero gradient; one step through
     flash_attn_varlen_qkvpacked; then the same path in f32 at a small
     size on the card against the CPU;
  6b. eager, after the packed phases (which then run before its state
     exists): the PaddlePaddle user's own loop at the flagship row's
     widths: an eager LlamaForCausalLM (f32 parameters, recompute; batch
     4, seq 4096) trained by AdamW under amp.auto_cast("O1", "bfloat16")
     through loss.backward(), opt.step(), opt.clear_grad(), one warm-up
     and 3 timed steps, each held to RMSNorm 65 and its gradient 33, flash
     forward 32, dK/dV 16 and dQ 16 launches, no 16-byte copy, the losses
     finite and falling; greedy generate of 16 tokens after a 128-token
     prompt (the prefill launches the flash forward 16 times); then a
     2-layer f32 eager model at the same widths on the card against the
     CPU (loss, every gradient, one AdamW step, greedy tokens);
  6c. pretraining, after the eager phase: BERT-base (bench.py::bench_bert's
     row: BertForPretraining(BertConfig()), batch 32, seq 512) and GPT-2
     small (GPT_PRESETS["gpt2"], batch 8, seq 1024) under amp.decorate O2
     bf16, AdamW at lr 1e-4, through jit.TrainStep: one warm-up and 8 timed
     steps, each held to 12 flash forward, 12 dK/dV and 12 dQ launches,
     every forward at D = 64 in bf16 with dropout 0.1, no dense attention,
     no 16-byte copy, the losses finite; BERT's BertModel with a [B, 1, 1,
     S] key-padding mask (the forward with the bias, 12 launches); then
     each model with 2 layers at full width, f32, dropout 0, one TrainStep
     on the card against the CPU (loss, every gradient, the update from
     the card's gradients; BERT's masked BertModel);
  6d. the registry's attention ops: flash_attn_unpadded and
     flash_attn_varlen_qkvpacked over a packed mix (12 heads of 64, bf16,
     causal), forward and backward, bit for bit the incubate function and
     launching each varlen kernel once; flash_attn through the flash
     kernels, bit for bit F.scaled_dot_product_attention;
  6f. MoE, after the registry ops: moe_block_stacked at Mixtral-8x7B's
     sparse-layer widths (hidden 4096, expert width 14336, 8 experts,
     top-2; the reference's expert, GELU between w1 and w2; capacity
     factor 1.5; f32), one warm-up and 3 timed forward + backward steps at
     16,384 tokens (ms a step, tokens/s, peak memory, the bound of its
     expert products at the f32 peak, the kept pairs against the buffer's
     E·C rows, one profiled step: the expert GEMMs' share of the device
     time); the same widths at 512 tokens on the card against the CPU
     (slots equal; output, aux loss and every gradient within their
     tolerances); MoELayer and FusedEcMoe at a small width against the
     CPU. It reaches no hand-written kernel and adds no entry to the
     kernels line;
  6e. hybrid parallelism over NCCL: min(cards, 4) ranks spawned, one a
     card (paddle_tpu_torch.distributed.spawn, start method "spawn"; they
     load the kernels phase 1 built), each printed with its card. On one
     card, an NCCL world of one: HybridTrainer over an all-ones mesh, a
     2-layer bf16 model at the flagship row's width and batch (4 x 4096),
     3 steps, each held to the training phase's launch counts, its losses,
     its clip norms and every parameter and moment (gathered) held to
     HybridTrainer(mesh=None) on the same card, bit for bit or within
     the stated tolerance (which, is logged); then the eager pipeline
     engines at pp 1 (the "pipeline" path of the kernels line): a
     PipelineLayer of the eager Llama's layers at the flagship widths (4
     decoder layers, AMP O1 bf16, 4 micro-batches of 2 x 512) through
     1F1B, VPP and ZB-H1, 2 AdamW steps each, held to the same layers
     stepped whole through micro-batch accumulation, every training
     kernel launched. With 2 cards, the same check of a 2-layer f32 model
     at Llama-2 7B's width over mp 2, the pipelined trainer at pp 2 with
     and without overlap_sends (4 layers, 8 x 512 in 4 micro-batches:
     each stage's launches held, the replicated leaves bit for bit equal
     on every pp rank) and the engines at pp 2 over NCCL; with 4, mp 2 x
     sharding 2, pp 2 x mp 2 and pp 4, the engines at pp 2 x mp 2, then
     the Llama-2 7B rows (32 layers, bf16, remat) at mp 2 x sharding 2
     (one 4096-token sequence a data rank), at pp 2 x mp 2 (8 sequences in
     8 micro-batches) and at sep 2 x mp 2 (4 sequences, each sep rank
     holding 2048 positions of each). Over 'sep' the parity jobs run the
     ring at sep 2 (2 cards) and at sep 4, sep 2 x mp 2, sep 2 x sharding
     2 and pp 2 x sep 2 (4 cards), each sep rank's launches held to its
     ring's hops and every leaf bit for bit equal over the sep group.
     remat_policy="save_attn" through the mesh path (one card: an all-ones
     mesh, the "save_attn_mesh" path; 2 cards mp 2; 4 cards sep 2 x mp 2
     and pp 2 x mp 2) is held to "full" on the same mesh, the flash
     forward once a layer a step (as "full" under pp); the eager Llama
     under group_sharded_parallel (one card: "p_g_os" in a world of one,
     AMP O1 bf16, the "group_sharded" path; 2 cards "os_g" and "p_g_os", 4
     cards "p_g_os", at 7B's width, 2 layers, f32) is held to rank 0's
     plain eager step; moe_block_stacked over the world as an expert group
     (2 and 4 cards, Mixtral's widths, 2048 tokens, 3 SGD steps) is held
     to rank 0's group=None run with the slots equal. With 4 cards two
     more rows: the eager Llama-2 7B under "p_g_os" at sharding 4 (AMP O1
     bf16, one 4096-token sequence a card; run first: bytes held between
     steps and at peak), and moe_block_stacked at ep 4 (16,384 tokens, 2
     experts a card: the exchange's host sync, bytes and NCCL time against
     the expert GEMMs'). The rows take one warm-up and 10 timed steps (ms,
     the median of the later 5 and the window's slope, tokens/s a card,
     share of 989 TF/s, peak memory a card, the host's share of each
     step, launches a step on every stage) and one profiled step on rank
     0 and over pp and sep on each stage's and each sep rank's first rank
     (NCCL and point-to-point kernels' device time against the rest, the
     flash kernels', and how much of the point-to-point time ran beside
     compute). ``python3 chip_smoke.py --hybrid`` runs the build and this
     phase alone at worlds 2 and 4, each followed by phase 6g at that
     world;
  6g. auto-parallel through the launcher, after the hybrid phase: ``python
     -m paddle_tpu_torch.distributed.launch --nproc_per_node W --log_dir
     <dir> <worker>`` as a user runs it (NCCL; the worker a stub under
     paddle_tpu_torch/build/ that calls launch_worker), W = 1 over a
     ("dp", "mp") mesh [[0]] (``--hybrid``: W = 2 at mp 2 and W = 4 at dp 2
     x mp 2). Each worker, on its own card: 2 layers at BERT-base's width
     (f32, dropout 0) with the FFN weights sharded on "mp", 3
     dist.to_static steps, rank 0 holding the losses and every gathered
     parameter and moment to its unsharded one-process step on its card;
     then BertForPretraining(BertConfig()) at 32 x 512 global under
     strategy.amp bf16, dropout 0.1, 3 warm-up and 8 timed steps, each
     held to 12 flash forward (D = 64, dropout), 12 dK/dV and 12 dQ
     launches and no dense attention: step ms, tokens/s a card, share of
     989 TF/s, peak memory, a profiled step's flash, NCCL and copy device
     ms; at W = 1 the TrainStep step of 6c timed in turns with it. The
     launches are the "auto_parallel" path of the kernels line (the BERT
     D = 64 rows);
  6h. vision, after the launcher (phase_vision): ResNet-50 as
     bench.py::bench_resnet50 writes it (resnet50(num_classes=1000),
     amp.decorate O2 bf16, Momentum(0.1, 0.9), TrainStep with
     CrossEntropyLoss under auto_cast O1, batch 256 x 224 from
     RandomState(0) staged once): a warm-up and 8 timed steps (step ms
     median, fastest and slowest, images/s, the share of 989 TF/s from the
     model's own conv and fc FLOPs x 3, peak memory over the phase's
     start, the losses, finite), every hand-written kernel's counter 0;
     MNIST LeNet through paddle_tpu_torch.Model (prepare, fit over the
     synthetic MNIST at batch 64 with the data on the host, evaluate: wall
     s, samples/s, ms a batch, the last loss and the accuracy); and the
     card against the CPU in f32 (_vision_parity: ResNet-50 on running
     statistics, its train-mode loss and running statistics, ResNet-18's
     train-mode step, LeNet's fit losses). No kernel of the port is on
     this path: conv and pooling are cuDNN's and PyTorch's ops;
  7. profile, last: each kernel's device time and the device time of a
     fresh-prefill step, a decode window (16 replays of its graph, after
     an unprofiled window that captured it) of the bf16, the int8 and each
     weight-streaming engine, a training step, an eager training step,
     the eager generate, a packed training step and a BERT-base and a
     GPT-2 pretraining step (with their device time by kernel class), by
     torch.profiler, with the device kernels a replayed decode step
     launches in all (the artifact engine's too); the composition
     rope_append replaced, its device time and kernels a call; the
     ResNet-50 step's device ms by kernel class (each kernel attributed to
     the op, layer or autograd node that launched it) and busy share, and
     the LeNet fit's busy share.
The last line is {"ok": true, "device": {...}}; the line before it holds
the kernels' numbers. Imports only torch, numpy and paddle_tpu_torch.
"""
import contextlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
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
# the training path's shape: the flagship row's batch and sequence
TRAIN_BATCH, TRAIN_SEQ = 4, 4096
# the packed-training path: the training row's tokens in one packed batch
PACKED_TOKENS = TRAIN_BATCH * TRAIN_SEQ
PACKED_SEED = 2026                 # document lengths
# the kernels' correctness check of the varlen backward: one sequence's
# worth of packed documents with a padding tail
VARLEN_CHECK_TOKENS = 4096
# spin kernels launched first in a profiled region (profile_kernels), and
# the decode windows profiled at most for one exact count of launches
PROFILE_PAD_LAUNCHES = 1024
PROFILE_ATTEMPTS = 3
# the kernels each path must launch
SERVING_KERNELS = ("rms_norm", "varlen_attention_fwd",
                   "paged_attention", "rope_append")
INT8_SERVING_KERNELS = ("rms_norm", "varlen_attention_fwd",
                        "paged_attention_int8", "rope_append")
TRAINING_KERNELS = ("rms_norm", "rms_norm_bwd", "flash_attention_fwd",
                    "flash_attention_bwd_dkv", "flash_attention_bwd_dq")
PACKED_KERNELS = ("varlen_attention_fwd", "varlen_attention_bwd_dkv",
                  "varlen_attention_bwd_dq")
STREAM_KERNELS = ("rms_norm", "varlen_attention_fwd", "paged_attention",
                  "weight_dequant", "rope_append")
# the deploy artifact's engine: the three kernels through registered ops
ARTIFACT_KERNELS = ("rms_norm", "paged_attention", "rope_append")
PATHS = {"serving": SERVING_KERNELS, "int8_serving": INT8_SERVING_KERNELS,
         "training": TRAINING_KERNELS, "packed_training": PACKED_KERNELS,
         "weight_stream": STREAM_KERNELS, "artifact": ARTIFACT_KERNELS,
         "eager": TRAINING_KERNELS, "hybrid": TRAINING_KERNELS,
         "pipeline": TRAINING_KERNELS}
# the models' attention at head dim 64 (GPT-2 small and BERT-base: 12 heads
# of 64), dropout 0.1 inside the flash kernels (their general
# instantiations): the shapes a pretraining step gives them
D64_SHAPES = {"bert": dict(batch=32, seq=512, causal=False),
              "gpt2": dict(batch=8, seq=1024, causal=True)}
ATTN_DROPOUT = 0.1
PRETRAIN_KERNELS = ("flash_attention_fwd", "flash_attention_bwd_dkv",
                    "flash_attention_bwd_dq")
# the sep phase's virtual ring sizes: the ring attention's hops run through
# the three flash kernels
SEP_RANKS = (2, 4)
PATHS["sep"] = PRETRAIN_KERNELS
# the eager Llama under group_sharded_parallel "p_g_os", and the mesh
# trainer under remat_policy="save_attn" (phase 6e's one-card jobs)
PATHS["group_sharded"] = TRAINING_KERNELS
PATHS["save_attn_mesh"] = TRAINING_KERNELS
# the flash sources whose instantiations ptxas -v reports on
PTXAS_SOURCES = ("flash_attention_fwd.cu", "flash_attention_bwd.cu")
# the weight-streaming modes of phase 4e, int4 first so that the int8
# engines' shared quantization is the model's current one for the versions
STREAM_MODES = ("int4", "int8", "int8-noprefetch")
# the bf16 tensor-core kernels whose SASS is searched for HGMMA
SASS_SYMBOLS = {"flash_attention_fwd": "flash_fwd_kernel",
                "flash_attention_bwd_dkv": "flash_bwd_dkv_kernel",
                "flash_attention_bwd_dq": "flash_bwd_dq_kernel",
                "varlen_attention_fwd": "varlen_fwd_kernel",
                "varlen_attention_bwd_dkv": "varlen_bwd_dkv_kernel",
                "varlen_attention_bwd_dq": "varlen_bwd_dq_kernel"}


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


def time_ms_turns(fns, calls=50, windows=7, warmup=10):
    """{name: milliseconds per call} of host-bound calls compared with each
    other: time_ms's windows taken in turns, one window of each function
    after the other, so that a slow spell of the host falls on all of
    them; the median of each function's windows."""
    for fn in fns.values():
        for _ in range(warmup):
            fn()
    torch.cuda.synchronize()
    per_call = {name: [] for name in fns}
    for _ in range(windows):
        for name, fn in fns.items():
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            for _ in range(calls):
                fn()
            e.record()
            e.synchronize()
            per_call[name].append(s.elapsed_time(e) / calls)
    return {name: statistics.median(v) for name, v in per_call.items()}


def profile_kernels(fn, calls=1, intervals=None):
    """{kernel name: (launches, total device us)} of ``calls`` calls of
    ``fn`` under torch.profiler (CUPTI), device-side kernel rows only.
    The profiler may lose the first device records it takes (one more
    every ~15 s of process life, now and then a few hundred:
    tools/torch_profiler_window.py), so PROFILE_PAD_LAUNCHES one-cycle spin
    kernels go first, and the result leaves them out. ``intervals``, a
    list, gets each device kernel's (name, start us, end us)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_PAD_LAUNCHES):
            torch.cuda._sleep(1)
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    if intervals is not None:
        intervals.extend((evt.key, evt.time_range.start, evt.time_range.end)
                         for evt in prof.events()
                         if _is_device_kernel_row(evt)
                         and "spin_kernel" not in evt.key)
    out = {}
    for evt in prof.key_averages():
        if not _is_device_kernel_row(evt):
            continue
        us = evt.self_device_time_total
        if us > 0 and "spin_kernel" not in evt.key:
            n, tot = out.get(evt.key, (0, 0.0))
            out[evt.key] = (n + evt.count, tot + us)
    return out


def _overlap_ms(intervals, picked, beside):
    """Milliseconds of the device time of the kernels ``picked`` (a
    predicate of the name) during which a kernel ``beside`` picks ran on
    the card too (``intervals`` as profile_kernels gives them)."""
    import bisect

    spans = []
    for s, e in sorted((s, e) for k, s, e in intervals if beside(k)):
        if spans and s <= spans[-1][1]:
            spans[-1][1] = max(spans[-1][1], e)
        else:
            spans.append([s, e])
    starts = [s for s, _ in spans]
    total = 0.0
    for k, s, e in intervals:
        if not picked(k):
            continue
        i = max(bisect.bisect_right(starts, s) - 1, 0)
        while i < len(spans) and spans[i][0] < e:
            total += max(0.0, min(e, spans[i][1]) - max(s, spans[i][0]))
            i += 1
    return total / 1e3


def _is_device_kernel_row(evt):
    """Whether a key_averages row is a device kernel (or copy): a CUDA row
    that is not a user-annotation range. c10d wraps each collective's
    kernel in a device range of the same length ("nccl:all_reduce" around
    ncclDevKernel_AllReduce_...), which would count its time twice."""
    if not str(getattr(evt, "device_type", "")).endswith("CUDA"):
        return False
    return not (getattr(evt, "is_user_annotation", False)
                or evt.key.startswith("nccl:"))


def kernel_device_ms(fn, kernel_symbol, calls=50, kernels=None):
    """Mean device time of one launch of the kernel whose name contains
    ``kernel_symbol``; for a tuple of symbols (a wrapper that launches
    several kernels), the sum over them (None when the profiler records no
    device time for one); for None, the device time of every kernel one
    call of ``fn`` launches. ``kernels``, a list, gets the device kernels
    a call launched in all."""
    fn()
    torch.cuda.synchronize()
    prof = profile_kernels(fn, calls)
    if kernels is not None:
        kernels.append(sum(n for n, _ in prof.values()) / calls)
    if kernel_symbol is None:
        return sum(us for _, us in prof.values()) / calls / 1e3
    total = 0.0
    for symbol in ((kernel_symbol,) if isinstance(kernel_symbol, str)
                   else kernel_symbol):
        found = [us / n for key, (n, us) in prof.items()
                 if symbol in key and n]
        if not found:
            return None
        total += found[0]
    return total / 1e3


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def bound(nbytes, ops, ops_per_s):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def card():
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr}")
    return smi.stdout.strip().splitlines()[0]


def phase_device_and_build():
    """The card, the kernels' build, and beside the build ptxas -v of the
    flash sources (registers and spill a bf16 instantiation). Returns
    (the HGMMA counts of log_tensor_core_sass, the ptxas report)."""
    log(card())
    from paddle_tpu_torch.ops.kernels import _build

    t0 = time.perf_counter()
    started = start_ptxas_report()
    try:
        so = _build.build()
        _build.library()
    finally:
        report = ptxas_report(started)
    log(f"build: {time.perf_counter() - t0:.1f} s -> "
        f"{os.path.relpath(so, HERE)} (nvcc "
        f"{' '.join(_build.ARCH_FLAGS)})")
    return log_tensor_core_sass(so), report


def start_ptxas_report():
    """nvcc -Xptxas -v of each of PTXAS_SOURCES into a scratch directory
    under the build directory, all started at once; ptxas_report waits for
    them."""
    from paddle_tpu_torch.ops.kernels import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=_build.BUILD_DIR, prefix="ptxas-")
    procs = [subprocess.Popen(
        [_build._nvcc()] + _build.NVCC_FLAGS
        + ["-Xptxas", "-v", "-c", str(_build._CSRC / name), "-o",
           os.path.join(tmp, name + ".o")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name in PTXAS_SOURCES]
    return tmp, procs


def ptxas_report(started):
    """{"flash_fwd_kernel<bf16, D=64, general>": {"registers": n,
    "stack": b, "spill_stores": b, "spill_loads": b}, ...} of the bf16
    flash instantiations, read from ptxas -v (printed); the compiles are
    waited for and their directory removed. A failed compile fails."""
    import re

    tmp, procs = started
    try:
        outs = [p.communicate(timeout=900)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    for name, p, out in zip(PTXAS_SOURCES, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc -Xptxas -v {name} failed:\n{out}")
    report, fn = {}, None
    for line in "\n".join(outs).splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties "
                      r"for )(\S+?)'?(?: for|$)", line)
        if m:
            k = re.search(r"((?:flash_bwd_d\w+|flash_fwd)_kernel)ILi(\d+)E"
                          r"(?:Lb([01])E)?EEvPK13__nv_bf", m.group(1))
            fn = (f"{k.group(1)}<bf16, D={k.group(2)}"
                  + {None: "", "1": ", plain", "0": ", general"}[k.group(3)]
                  + ">") if k else None
            continue
        if fn is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            report.setdefault(fn, {}).update(
                stack=int(m.group(1)), spill_stores=int(m.group(2)),
                spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            report.setdefault(fn, {})["registers"] = int(m.group(1))
    log("ptxas -v, bf16 flash instantiations: " + "; ".join(
        f"{f} {r.get('registers')} registers, spill {r.get('spill_stores')}"
        f"/{r.get('spill_loads')} bytes (stores/loads), stack "
        f"{r.get('stack')} bytes" for f, r in sorted(report.items())))
    return report


def log_tensor_core_sass(so):
    """Print the tensor-core instructions (HGMMA: wgmma, HMMA: mma.sync) in
    the SASS of the bf16 attention kernels (flash and varlen, forward and
    backward), where cuobjdump is on PATH or beside nvcc; returns
    {kernel symbol: {D: HGMMA count}}. Printed, not required."""
    import re
    import shutil

    from paddle_tpu_torch.ops.kernels import _build

    tool = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(_build._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        log("SASS: cuobjdump not found; tensor-core instructions not counted")
        return {}
    sass = subprocess.run([tool, "-sass", str(so)], capture_output=True,
                          text=True, timeout=120).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            # <D> or <D, PLAIN> (the flash forward), bf16 operands
            k = re.search(r"((?:flash_bwd_d\w+|flash_fwd|varlen_fwd"
                          r"|varlen_bwd_d\w+)_kernel)"
                          r"ILi(\d+)E(?:Lb([01])E)?EEvPK13__nv_bf",
                          m.group(1))
            fn = (f"{k.group(1)}<bf16, D={k.group(2)}"
                  + {None: "", "1": ", plain", "0": ", general"}[k.group(3)]
                  + ">") if k else None
            continue
        if fn:
            for op in ("HGMMA", "HMMA"):
                if re.search(rf"\b{op}\.", line):
                    counts.setdefault(fn, Counter())[op] += 1
    log("SASS tensor-core instructions: " + ("; ".join(
        f"{f} " + ", ".join(f"{op} {n}" for op, n in sorted(c.items()))
        for f, c in sorted(counts.items())) or "none found"))
    hgmma = {}
    for f, c in counts.items():
        sym, rest = re.match(r"(\w+)<bf16, (.*)>", f).groups()
        hgmma.setdefault(sym, {})[rest] = c["HGMMA"]
    return hgmma


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
    # the training path's case: x [B*S, h] bf16 with an f32 weight
    xt = (torch.randn(TRAIN_BATCH * TRAIN_SEQ, h, device=dev,
                      generator=gen) * 3).to(torch.bfloat16)
    wt = torch.randn(h, device=dev, generator=gen)
    got = RN.rms_norm(xt, wt)
    ref = RN._rms_norm_ref(xt, wt, 1e-6)
    torch.cuda.synchronize()
    d = (got.float() - ref.float()).abs()
    ok = got.dtype == torch.bfloat16 \
        and bool((d <= 2.0 ** -7 * ref.float().abs()).all())
    log(f"rms_norm [{xt.shape[0]}, {h}] bf16 x, f32 weight: max_abs_err "
        f"{float(d.max()):.3e} (tol 2**-7 * |ref|) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("rms_norm kernel (f32 weight) disagrees with "
                             "its plain version")
    rms_err = max(rms_err, float(d.max()))
    bt, byt = bound(2 * xt.numel() * 2 + h * 4, 4 * xt.numel(),
                    F32_OPS_PER_S)
    lib = torch.nn.functional.rms_norm
    training_shape = dict(
        shape=f"x [{xt.shape[0]}, {h}] bf16, weight [{h}] f32",
        ms=time_ms(lambda: RN.rms_norm(xt, wt), calls=20, windows=5),
        plain_ms=time_ms(lambda: RN._rms_norm_ref(xt, wt, 1e-6), calls=20,
                         windows=5),
        bound_ms=bt, bound_by=byt,
        # bf16 x with an f32 weight: F.rms_norm's composite path (it warns
        # that it cannot dispatch to its fused kernel)
        library_ms=time_ms(lambda: lib(xt, (h,), wt, 1e-6), calls=20,
                           windows=5))
    # the eager path's case under AMP O1 (rms_norm black-listed, its input
    # cast up): x [B*S, h] f32 with an f32 weight, eps 1e-5 as the
    # flagship's; f32 within 1e-5 * |ref| + 1e-6 (rsqrtf, sum order)
    xe = torch.randn(TRAIN_BATCH * TRAIN_SEQ, h, device=dev,
                     generator=gen) * 3
    got = RN.rms_norm(xe, wt, 1e-5)
    ref = RN._rms_norm_ref(xe, wt, 1e-5)
    torch.cuda.synchronize()
    d = (got - ref).abs()
    ok = got.dtype == torch.float32 \
        and bool((d <= 1e-5 * ref.abs() + 1e-6).all())
    log(f"rms_norm [{xe.shape[0]}, {h}] f32 x, f32 weight: max_abs_err "
        f"{float(d.max()):.3e} (tol 1e-5 * |ref| + 1e-6) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("rms_norm kernel (f32 x) disagrees with its "
                             "plain version")
    rms_err = max(rms_err, float(d.max()))
    be, bye = bound(2 * xe.numel() * 4 + h * 4, 4 * xe.numel(),
                    F32_OPS_PER_S)
    eager_shape = dict(
        shape=f"x [{xe.shape[0]}, {h}] f32, weight [{h}] f32 (the eager "
              f"path under AMP O1)",
        max_abs_err=float(d.max()),
        ms=time_ms(lambda: RN.rms_norm(xe, wt, 1e-5), calls=20, windows=5),
        plain_ms=time_ms(lambda: RN._rms_norm_ref(xe, wt, 1e-5), calls=20,
                         windows=5),
        bound_ms=be, bound_by=bye,
        library_ms=time_ms(lambda: lib(xe, (h,), wt, 1e-5), calls=20,
                           windows=5))
    x = (torch.randn(256, h, device=dev, generator=gen) * 3) \
        .to(torch.bfloat16)
    w = torch.randn(h, device=dev, generator=gen).to(torch.bfloat16)
    b, by = bound(2 * x.numel() * 2 + h * 2, 4 * x.numel(), F32_OPS_PER_S)
    # host-bound at this shape (~2 us of device time): timed in turns
    turns = time_ms_turns({"ms": lambda: RN.rms_norm(x, w),
                           "plain_ms": lambda: RN._rms_norm_ref(x, w, 1e-6),
                           "library_ms": lambda: lib(x, (h,), w, 1e-6)})
    results["rms_norm"] = dict(
        name="rms_norm", route="cuda",
        source="paddle_tpu_torch/ops/kernels/csrc/rms_norm.cu",
        replaces="paddle_tpu/ops/pallas/rms_norm.py:31",
        max_abs_err=rms_err, ms=turns["ms"], plain_ms=turns["plain_ms"],
        bound_ms=b, bound_by=by, library_ms=turns["library_ms"],
        shape="x [256, 2048] bf16, weight [2048]",
        at_training_shape=training_shape, at_eager_shape=eager_shape)

    results["rms_norm_bwd"], bwd_probes = _rms_norm_bwd_checks(
        dev, gen, xt, wt, xe)
    _rms_norm_widths(dev, gen)

    # -- varlen attention: the fresh-prefill shape, GQA 16q/8kv, D=128;
    # bf16 O element by element within 2**-6 * (|ref| + row RMS) + 1e-5
    # (_worst_of_tol: P is rounded to bf16 before PV in the kernel, as in
    # the TPU kernel, not in the dense plain version; both round O to
    # bf16), LSE within 1e-3 (f32 online vs dense logsumexp of bf16-valued
    # logits); the typical sizes are printed beside the errors
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
        ro = _worst_of_tol(o, o2, 2.0 ** -6, 1e-5)
        ok = ro <= 1.0 and el <= 1e-3 \
            and bool(torch.isfinite(o.float()).all())
        log(f"varlen_attention {label} causal bf16: O max_abs_err "
            f"{eo:.3e}, worst error / tol {ro:.3f} (tol 2**-6 * (|ref| + "
            f"row RMS) + 1e-5; RMS of O {_rms(o2):.3e}), LSE max_abs_err "
            f"{el:.3e} (tol 1e-3; RMS of LSE {_rms(lse2):.3e}) "
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
    # device-time probes, run under the profiler after the other phases:
    # name -> (call, kernel symbol, calls, the dict that gets device_ms)
    probes = {
        "rms_norm": (lambda: RN.rms_norm(x, w), "rms_norm_kernel", 50,
                     results["rms_norm"]),
        "rms_norm at the training shape": (
            lambda: RN.rms_norm(xt, wt), "rms_norm_kernel", 20,
            training_shape),
        "rms_norm at the eager shape": (
            lambda: RN.rms_norm(xe, wt, 1e-5), "rms_norm_kernel", 20,
            eager_shape),
        **bwd_probes,
        "varlen_attention_fwd": (lambda: VA.varlen_flash_attention_packed(
            q, k, v, seg, seg, True), "varlen_fwd_kernel", 50,
            results["varlen_attention_fwd"]),
    }
    return results, probes


def _rms_norm_bwd_worst(x, w, g, gx, gw, eps):
    """Worst ratios (gx, gw) of the gradient kernel's errors to their
    tolerances against its plain version: gx element by element within
    rtol * (|ref| + the RMS of ref's row) + floor (gx has cancellations),
    bf16 2**-7 and 1e-6, f32 1e-5 and 1e-7; gw per column within
    1e-4 * sum over rows of |g * xhat| + 1e-6, plus one bf16 ulp
    (2**-7 * |ref|) for a bf16 gw (both round f32 sums taken in other
    orders)."""
    from paddle_tpu_torch.ops.kernels import rms_norm as RN

    gxr, gwr = RN._rms_norm_bwd(x, w, eps, g)
    rtol, floor = (2.0 ** -7, 1e-6) if x.dtype == torch.bfloat16 \
        else (1e-5, 1e-7)
    rx = _worst_of_tol(gx, gxr, rtol, floor)
    if w is None:
        return rx, 0.0
    xf = x.float().reshape(-1, x.shape[-1])
    xhat = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    scale = (g.float().reshape(xf.shape) * xhat).abs().sum(0)
    gwr = gwr.float()
    tol = 1e-4 * scale + 1e-6 + (2.0 ** -7 * gwr.abs()
                                 if w.dtype == torch.bfloat16 else 0.0)
    return rx, float(((gw.float() - gwr).abs() / tol).max())


def _rms_norm_bwd_checks(dev, gen, xt, wt, xe):
    """The gradient kernel against its plain version at the serving shape
    (bf16 x and weight, [256, 2048]; with and without the weight), at the
    training shape (bf16 x [16384, 2048], f32 weight, eps 1e-5 as the
    flagship's) and at the eager path's (the same with f32 x, as AMP O1
    casts rms_norm's input up), twice at each of the last two for the same
    bits; then timed at both beside its plain version and
    torch.autograd.grad through F.rms_norm. Returns its kernels-line row
    and its device-time probes."""
    from paddle_tpu_torch.ops.kernels import rms_norm as RN

    h = xt.shape[-1]
    eps = 1e-5
    x = (torch.randn(256, h, device=dev, generator=gen) * 3) \
        .to(torch.bfloat16)
    w = torch.randn(h, device=dev, generator=gen).to(torch.bfloat16)
    g = torch.randn(256, h, device=dev, generator=gen).to(torch.bfloat16)
    gt = torch.randn(xt.shape, device=dev, generator=gen).to(torch.bfloat16)
    ge = torch.randn(xe.shape, device=dev, generator=gen)
    worst, err = (0.0, 0.0), 0.0
    err_eager = 0.0
    for label, (a, b, c) in {"[256, 2048] bf16, bf16 weight": (x, w, g),
                             "[256, 2048] bf16, no weight": (x, None, g),
                             f"[{xt.shape[0]}, {h}] bf16, f32 weight":
                             (xt, wt, gt),
                             f"[{xe.shape[0]}, {h}] f32, f32 weight":
                             (xe, wt, ge)}.items():
        gx, gw = RN._backward(a, b, eps, c)
        torch.cuda.synchronize()
        r = _rms_norm_bwd_worst(a, b, c, gx, gw, eps)
        ok = max(r) <= 1.0 and bool(torch.isfinite(gx.float()).all()) \
            and gx.dtype == a.dtype
        e = _max_err(gx, RN._rms_norm_bwd(a, b, eps, c)[0])
        err = max(err, e)
        tol = "2**-7 * (|ref| + row RMS) + 1e-6" \
            if a.dtype == torch.bfloat16 else \
            "1e-5 * (|ref| + row RMS) + 1e-7"
        log(f"rms_norm_bwd {label}: worst error / tol gx {r[0]:.3f}, gw "
            f"{r[1]:.3f} (gx {tol}; gw 1e-4 * sum |g * xhat| + 1e-6, + "
            f"2**-7 |ref| in bf16) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("rms_norm gradient kernel disagrees with "
                                 "its plain version")
        if a is xe:
            err_eager, worst_eager = e, r
        else:
            worst = tuple(max(p, q) for p, q in zip(worst, r))
        if b is wt:
            again = RN._backward(a, b, eps, c)
            torch.cuda.synchronize()
            if not (torch.equal(again[0], gx) and torch.equal(again[1], gw)):
                raise AssertionError(f"rms_norm gradient kernel {label}: "
                                     f"two calls differ")

    def timed(xx, gg):
        xl = xx.detach().requires_grad_(True)
        wl = wt.detach().requires_grad_(True)
        y = torch.nn.functional.rms_norm(xl, (h,), wl, eps)
        # read x and g, write gx (x's dtype); read the weight, write gw
        # (f32); ~10 f32 operations an element
        b, by = bound(3 * nbytes(xx) + 2 * nbytes(wt), 10 * xx.numel(),
                      F32_OPS_PER_S)
        return dict(
            ms=time_ms(lambda: RN._backward(xx, wt, eps, gg), calls=20,
                       windows=5),
            plain_ms=time_ms(lambda: RN._rms_norm_bwd(xx, wt, eps, gg),
                             calls=20, windows=5),
            bound_ms=b, bound_by=by,
            library_ms=time_ms(lambda: torch.autograd.grad(
                y, (xl, wl), gg, retain_graph=True), calls=20, windows=5))

    eager_shape = dict(
        shape=f"x, g [{xe.shape[0]}, {h}] f32, weight [{h}] f32 (the eager "
              f"path under AMP O1)",
        max_abs_err=err_eager, worst_ratio_gx=worst_eager[0],
        worst_ratio_gw=worst_eager[1], **timed(xe, ge))
    row = dict(
        name="rms_norm_bwd", route="cuda",
        source="paddle_tpu_torch/ops/kernels/csrc/rms_norm.cu",
        replaces="paddle_tpu/ops/pallas/rms_norm.py:88 (_bwd; no Pallas "
                 "kernel, XLA fuses it)",
        max_abs_err=err, worst_ratio_gx=worst[0], worst_ratio_gw=worst[1],
        **timed(xt, gt),
        shape=f"x, g [{xt.shape[0]}, {h}] bf16, weight [{h}] f32",
        at_eager_shape=eager_shape)
    for label, r in (("", row), (" at the eager shape", eager_shape)):
        log(f"rms_norm_bwd{label}: {r['ms']:.4f} ms a call, "
            f"{r['plain_ms']:.4f} ms plain, library {r['library_ms']:.4f} "
            f"ms (autograd.grad through F.rms_norm), bound "
            f"{r['bound_ms']:.5f} ms ({r['bound_by']})")
    symbols = ("rms_norm_bwd_kernel", "rms_norm_bwd_gw_kernel")
    probes = {"rms_norm_bwd": (lambda: RN._backward(xt, wt, eps, gt),
                               symbols, 20, row),
              "rms_norm_bwd at the eager shape": (
                  lambda: RN._backward(xe, wt, eps, ge), symbols, 20,
                  eager_shape)}
    return row, probes


def _rms_norm_widths(dev, gen):
    """Forward and gradient at widths off the main paths, against the plain
    versions: h = 100 (bf16: element loads) and h = 40,000 (two passes over
    each row), 64 rows, bf16 x with a bf16 weight; each call must count one
    launch."""
    from paddle_tpu_torch.ops.kernels import rms_norm as RN

    for h in (100, 40000):
        x = (torch.randn(64, h, device=dev, generator=gen) * 3) \
            .to(torch.bfloat16)
        w = torch.randn(h, device=dev, generator=gen).to(torch.bfloat16)
        g = torch.randn(64, h, device=dev, generator=gen).to(torch.bfloat16)
        before = (RN.launches, RN.launches_bwd)
        y = RN.rms_norm(x, w)
        gx, gw = RN._backward(x, w, 1e-6, g)
        torch.cuda.synchronize()
        yr = RN._rms_norm_ref(x, w, 1e-6).float()
        ok_y = bool(((y.float() - yr).abs() <= 2.0 ** -7 * yr.abs()).all())
        r = _rms_norm_bwd_worst(x, w, g, gx, gw, 1e-6)
        counted = (RN.launches, RN.launches_bwd) == (before[0] + 1,
                                                     before[1] + 1)
        ok = ok_y and max(r) <= 1.0 and counted
        log(f"rms_norm [64, {h}] bf16 ({'/'.join(RN.kernel_path(h, x.dtype))}"
            f" forward, {'/'.join(RN.kernel_path(h, x.dtype, True))} "
            f"gradient): forward within 2**-7 |ref| {ok_y}, gradient worst "
            f"error / tol gx {r[0]:.3f} gw {r[1]:.3f}, launches counted "
            f"{counted} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"rms_norm kernels fail at h={h}")


def _worst_of_tol(got, ref, rtol, floor):
    """Element by element, |got - ref| over rtol * (|ref| + the RMS of
    ref's row along the last axis) + floor; the worst ratio, at most 1 to
    pass. The row's RMS sets the scale where ref crosses zero, so each row
    is held to its own size, not to the largest value of the tensor."""
    got, ref = got.float(), ref.float()
    rms = ref.square().mean(-1, keepdim=True).sqrt()
    return float(((got - ref).abs()
                  / (rtol * (ref.abs() + rms) + floor)).max())


def _rms(t):
    """RMS of t's entries, leaving out the -1e30 of fully padded rows."""
    t = t.float()
    return float(t[t.abs() < 1e20].square().mean().sqrt())


def phase_flash_kernels(dev, results, probes):
    """The flash-attention kernels against their plain versions at the
    training shape's heads (B=1, H=16, S=4096, D=128, bf16, causal) and at
    a smaller shape with a key-padding bias and dropout 0.1, then timed at
    the training shape (B=4)."""
    from paddle_tpu_torch.ops.kernels import flash_attention as FA

    gen = torch.Generator(device=dev).manual_seed(1)
    H, S, D = 16, TRAIN_SEQ, 128

    def inputs(b, h, s, bias):
        q, k, v, do = [torch.randn(b, h, s, D, device=dev, generator=gen)
                       .to(torch.bfloat16) for _ in range(4)]
        kmask = None
        if bias:
            kmask = torch.zeros(b, s, device=dev)
            kmask[0, s // 3:] = -1e30
            kmask[-1, :] = -1e30          # a sequence whose keys are all pad
        return q, k, v, do, kmask

    # bf16 tolerances, element by element (_worst_of_tol): O, dQ, dK and dV
    # within 2**-6 * (|ref| + the RMS of ref's row over D) + 1e-5. Both
    # sides round to bf16 at the end (one bf16 ulp is up to 2**-7 |ref|),
    # and the kernels round P (forward) and p_used, dS (backward) to bf16
    # before their products, as the TPU kernels do, which moves a row by
    # about 2**-9 of its RMS; the dense plain versions keep them in f32.
    # LSE within 1e-3 absolute (both f32; its RMS is printed). The
    # fully padded sequence (every key -1e30: LSE rounds to -1e30, so the
    # backward's P is 1 on every key and its dV sums dO) is checked apart.
    RTOL, FLOOR = 2.0 ** -6, 1e-5
    errs = {"flash_attention_fwd": 0.0, "flash_attention_bwd_dkv": 0.0,
            "flash_attention_bwd_dq": 0.0}
    small = min(S, 1024)
    cases = {f"B=1 H={H} S={S} D={D} bf16 causal":
             (inputs(1, H, S, False), True, 0.0, 0),
             f"B=2 H=4 S={small} D={D} bf16 key padding + dropout 0.1":
             (inputs(2, 4, small, True), False, 0.1, -20240917)}
    for label, ((q, k, v, do, kmask), causal, p, seed) in cases.items():
        o, lse = FA.forward_with_lse(q, k, v, kmask, seed, causal, p)
        dq, dk, dv = FA.backward(q, k, v, kmask, seed, o, lse, do, causal, p)
        o2, lse2 = FA._forward_ref(q, k, v, kmask, seed, causal, p)
        dq2, dk2, dv2 = FA._backward_ref(q, k, v, kmask, seed, o, lse, do,
                                         causal, p)
        torch.cuda.synchronize()
        finite = all(bool(torch.isfinite(t.float()).all())
                     for t in (o, dq, dk, dv))
        el = _max_err(lse, lse2)
        # batches checked apart: the live ones, then the fully padded one
        parts = {"live": slice(0, q.shape[0] - 1 if kmask is not None
                               else q.shape[0])}
        if kmask is not None:
            parts["fully padded"] = slice(q.shape[0] - 1, q.shape[0])
        worst = 0.0
        for part, sl in parts.items():
            ratios = {n: _worst_of_tol(a[sl], b[sl], RTOL, FLOOR)
                      for n, (a, b) in (("O", (o, o2)), ("dQ", (dq, dq2)),
                                        ("dK", (dk, dk2)),
                                        ("dV", (dv, dv2)))}
            rms = {n: _rms(b[sl]) for n, b in (("O", o2), ("dQ", dq2),
                                               ("dK", dk2), ("dV", dv2))}
            worst = max(worst, max(ratios.values()))
            log(f"flash attention {label}, {part} batches: worst error / "
                f"tol " + ", ".join(f"{n} {ratios[n]:.3f} (RMS {rms[n]:.3e})"
                                    for n in ratios)
                + f"; tol 2**-6 * (|ref| + row RMS) + 1e-5")
        ok = finite and el <= 1e-3 and worst <= 1.0
        log(f"flash attention {label}: LSE max_abs_err {el:.3e} (tol 1e-3; "
            f"RMS of LSE {_rms(lse2):.3e}), O max_abs_err "
            f"{_max_err(o, o2):.3e}, worst ratio {worst:.3f} (tol 1) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("flash attention kernels disagree with "
                                 "their plain versions")
        errs["flash_attention_fwd"] = max(errs["flash_attention_fwd"],
                                          _max_err(o, o2))
        errs["flash_attention_bwd_dkv"] = max(
            errs["flash_attention_bwd_dkv"], _max_err(dk, dk2),
            _max_err(dv, dv2))
        errs["flash_attention_bwd_dq"] = max(
            errs["flash_attention_bwd_dq"], _max_err(dq, dq2))
        del o2, dq2, dk2, dv2
    del cases

    # times at the training shape: B=4, H=16, S=4096, D=128 bf16 causal
    B = TRAIN_BATCH
    q, k, v, do, _ = inputs(B, H, S, False)
    o, lse = FA.forward_with_lse(q, k, v, None, 0, True, 0.0)
    # the forward at the training shape's own grid (B*H = 64 heads): two
    # calls give the same bits, and O and LSE agree with the plain forward
    # with the tolerances of the cases above
    o_again, lse_again = FA.forward_with_lse(q, k, v, None, 0, True, 0.0)
    o2, lse2 = FA._forward_ref(q, k, v, None, 0, True, 0.0)
    torch.cuda.synchronize()
    same = torch.equal(o, o_again) and torch.equal(lse, lse_again)
    fwd_ratio = _worst_of_tol(o, o2, RTOL, FLOOR)
    el = _max_err(lse, lse2)
    ok = same and fwd_ratio <= 1.0 and el <= 1e-3 \
        and bool(torch.isfinite(o.float()).all())
    log(f"flash attention forward at q/k/v [{B}, {H}, {S}, {D}] bf16 causal: "
        f"two calls bit-identical {same}; vs plain: O worst error / tol "
        f"{fwd_ratio:.3f} (tol 2**-6 * (|ref| + row RMS) + 1e-5), LSE "
        f"max_abs_err {el:.3e} (tol 1e-3) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("flash attention forward kernel disagrees with "
                             "its plain version (or itself) at the training "
                             "shape")
    errs["flash_attention_fwd"] = max(errs["flash_attention_fwd"],
                                      _max_err(o, o2))
    del o_again, lse_again, o2, lse2
    _, _, _, _, _, _, delta = FA._bwd_inputs(q, k, v, None, o, lse, do,
                                             True)
    # no block writes another's rows (no atomics): two backward calls give
    # the same bits
    runs = [FA._launch_bwd_dkv(q, k, v, None, 0, do, lse, delta, True, 0.0)
            + (FA._launch_bwd_dq(q, k, v, None, 0, do, lse, delta, True,
                                 0.0),) for _ in range(2)]
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(*runs))
    log(f"flash attention backward at q/k/v [{B}, {H}, {S}, {D}] bf16 "
        f"causal: two calls give bit-identical dK, dV and dQ: "
        f"{'ok' if same else 'FAIL'}")
    if not same:
        raise AssertionError("flash attention backward is not "
                             "deterministic")
    # the kernels at the training shape's own grid (B*H = 64 heads) against
    # the plain backward, with the tolerances of the cases above
    dk, dv, dq = runs[0]
    dq2, dk2, dv2 = FA._backward_ref(q, k, v, None, 0, o, lse, do, True, 0.0)
    torch.cuda.synchronize()
    train_ratios = {n: _worst_of_tol(a, b, RTOL, FLOOR)
                    for n, (a, b) in (("dQ", (dq, dq2)), ("dK", (dk, dk2)),
                                      ("dV", (dv, dv2)))}
    finite = all(bool(torch.isfinite(t.float()).all()) for t in runs[0])
    ok = finite and max(train_ratios.values()) <= 1.0
    log(f"flash attention backward at q/k/v [{B}, {H}, {S}, {D}] bf16 "
        f"causal vs plain: worst error / tol "
        + ", ".join(f"{n} {r:.3f}" for n, r in train_ratios.items())
        + f"; tol 2**-6 * (|ref| + row RMS) + 1e-5 "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("flash attention backward kernels disagree "
                             "with their plain version at the training "
                             "shape")
    errs["flash_attention_bwd_dkv"] = max(
        errs["flash_attention_bwd_dkv"], _max_err(dk, dk2), _max_err(dv, dv2))
    errs["flash_attention_bwd_dq"] = max(errs["flash_attention_bwd_dq"],
                                         _max_err(dq, dq2))
    worst_at_train = {"flash_attention_fwd": fwd_ratio,
                      "flash_attention_bwd_dkv": max(train_ratios["dK"],
                                                     train_ratios["dV"]),
                      "flash_attention_bwd_dq": train_ratios["dQ"]}
    del runs, dq, dk, dv, dq2, dk2, dv2
    pairs = B * H * S * (S + 1) // 2            # causal (q, k) pairs
    fwd = lambda: FA.forward_with_lse(q, k, v, None, 0, True, 0.0)  # noqa
    dkv = lambda: FA._launch_bwd_dkv(q, k, v, None, 0, do, lse, delta,  # noqa
                                     True, 0.0)
    dqk = lambda: FA._launch_bwd_dq(q, k, v, None, 0, do, lse, delta,  # noqa
                                    True, 0.0)
    big = dict(calls=3, windows=3, warmup=1)
    plain_fwd_ms = time_ms(lambda: FA._forward_ref(q, k, v, None, 0, True,
                                                   0.0), **big)
    plain_bwd_ms = time_ms(lambda: FA._backward_ref(
        q, k, v, None, 0, o, lse, do, True, 0.0), **big)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qg, kg, vg = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    out = sdpa(qg, kg, vg, is_causal=True)
    lib_fwd_ms = time_ms(lambda: sdpa(q, k, v, is_causal=True), calls=10,
                         windows=5, warmup=2)
    lib_bwd_ms = time_ms(lambda: torch.autograd.grad(
        out, (qg, kg, vg), do, retain_graph=True), calls=10, windows=5,
        warmup=2)
    shape = f"q/k/v [{B}, {H}, {S}, {D}] bf16 causal, {pairs} pairs"
    lse_b, d_b = nbytes(lse), nbytes(delta)
    rows = {
        "flash_attention_fwd": dict(
            source="paddle_tpu_torch/ops/kernels/csrc/flash_attention_fwd.cu",
            replaces="paddle_tpu/ops/pallas/flash_attention.py:135",
            fn=fwd, ops=4 * D * pairs,
            nbytes=nbytes(q, k, v, o) + lse_b, plain_ms=plain_fwd_ms,
            library_ms=lib_fwd_ms, library="SDPA is_causal forward",
            symbol="flash_fwd_kernel"),
        "flash_attention_bwd_dkv": dict(
            source="paddle_tpu_torch/ops/kernels/csrc/flash_attention_bwd.cu",
            replaces="paddle_tpu/ops/pallas/flash_attention.py:315",
            fn=dkv, ops=8 * D * pairs,
            nbytes=nbytes(q, k, v, do, k, v) + lse_b + d_b,
            plain_ms=plain_bwd_ms, library_ms=lib_bwd_ms,
            library="SDPA backward (dQ, dK, dV together)",
            symbol="flash_bwd_dkv_kernel"),
        "flash_attention_bwd_dq": dict(
            source="paddle_tpu_torch/ops/kernels/csrc/flash_attention_bwd.cu",
            replaces="paddle_tpu/ops/pallas/flash_attention.py:389",
            fn=dqk, ops=6 * D * pairs,
            nbytes=nbytes(q, k, v, do, q) + lse_b + d_b,
            plain_ms=plain_bwd_ms, library_ms=lib_bwd_ms,
            library="SDPA backward (dQ, dK, dV together)",
            symbol="flash_bwd_dq_kernel"),
    }
    for name, r in rows.items():
        b, by = bound(r["nbytes"], r["ops"], BF16_OPS_PER_S)
        ms = time_ms(r["fn"], calls=5, windows=5, warmup=2)
        results[name] = dict(
            name=name, route="cuda", source=r["source"],
            replaces=r["replaces"], max_abs_err=errs[name], ms=ms,
            plain_ms=r["plain_ms"], bound_ms=b, bound_by=by,
            library_ms=r["library_ms"], library=r["library"], shape=shape,
            plain_note="one dense f32 backward computes dQ, dK and dV"
            if "bwd" in name else "dense f32 forward")
        # achieved rate over the causal pairs' operations, the share of
        # the bound, and the worst error / tol against the plain version
        # at this shape
        results[name]["tflops"] = r["ops"] / ms / 1e9
        results[name]["bound_share"] = b / ms
        results[name]["worst_ratio_at_shape"] = worst_at_train[name]
        extra = (f", {results[name]['tflops']:.1f} TFLOP/s, "
                 f"{100 * b / ms:.1f}% of the bound")
        probes[name] = (r["fn"], r["symbol"], 5, results[name])
        log(f"{name}: {ms:.3f} ms a call, "
            f"{r['plain_ms']:.3f} ms plain, library {r['library_ms']:.3f} "
            f"ms ({r['library']}), bound {b:.4f} ms ({by}){extra}")


def _d64_inputs(dev, gen, b, s, bias):
    """q, k, v, dO [b, 12, s, 64] bf16 and, with ``bias``, a key-padding
    bias [b, s] f32 padding each sequence's tail by 0 to s/2 keys (a
    padded BERT batch)."""
    q, k, v, do = [torch.randn(b, 12, s, 64, device=dev, generator=gen)
                   .to(torch.bfloat16) for _ in range(4)]
    kmask = None
    if bias:
        kmask = torch.zeros(b, s, device=dev)
        pads = torch.randint(0, s // 2 + 1, (b,), device=dev, generator=gen)
        kmask[torch.arange(s, device=dev)[None, :]
              >= (s - pads)[:, None]] = -1e30
    return q, k, v, do, kmask


def phase_flash_d64(dev, results, probes):
    """The flash kernels at the GPT-2 and BERT-base attention (12 heads of
    64, bf16) with dropout 0.1 drawn from the port's generator: their
    general instantiations at the shapes a pretraining step gives them
    (BERT [32, 12, 512, 64], GPT-2 [8, 12, 1024, 64] causal), and BERT's
    with a key-padding bias. O, LSE, dQ, dK and dV held element by element
    to the plain versions with phase_flash_kernels' tolerances; then each
    kernel timed beside its bound, its plain version and SDPA with
    dropout_p=0.1 (forward; backward), as new rows of the kernels line."""
    from paddle_tpu_torch.framework.random import generator
    from paddle_tpu_torch.ops.kernels import flash_attention as FA

    gen = torch.Generator(device=dev).manual_seed(64)
    RTOL, FLOOR, p = 2.0 ** -6, 1e-5, ATTN_DROPOUT
    sdpa = torch.nn.functional.scaled_dot_product_attention
    cases = [(m, c, False) for m, c in D64_SHAPES.items()] \
        + [("bert", D64_SHAPES["bert"], True)]
    for model, c, bias in cases:
        b, S, causal = c["batch"], c["seq"], c["causal"]
        q, k, v, do, kmask = _d64_inputs(dev, gen, b, S, bias)
        seed = FA.seed_from_generator(generator(dev))
        o, lse = FA.forward_with_lse(q, k, v, kmask, seed, causal, p)
        dq, dk, dv = FA.backward(q, k, v, kmask, seed, o, lse, do, causal,
                                 p)
        o2, lse2 = FA._forward_ref(q, k, v, kmask, seed, causal, p)
        dq2, dk2, dv2 = FA._backward_ref(q, k, v, kmask, seed, o, lse, do,
                                         causal, p)
        torch.cuda.synchronize()
        finite = all(bool(torch.isfinite(t.float()).all())
                     for t in (o, dq, dk, dv))
        ratios = {n: _worst_of_tol(a, r, RTOL, FLOOR)
                  for n, (a, r) in (("O", (o, o2)), ("dQ", (dq, dq2)),
                                    ("dK", (dk, dk2)), ("dV", (dv, dv2)))}
        el = _max_err(lse, lse2)
        label = (f"{model} q/k/v [{b}, 12, {S}, 64] bf16"
                 f"{' causal' if causal else ''}"
                 f"{' key padding' if bias else ''} dropout {p}")
        ok = finite and el <= 1e-3 and max(ratios.values()) <= 1.0
        log(f"flash attention D=64 {label}: worst error / tol "
            + ", ".join(f"{n} {r:.3f} (RMS {_rms(x):.3e})" for (n, r), x in
                        zip(ratios.items(), (o2, dq2, dk2, dv2)))
            + f"; LSE max_abs_err {el:.3e} (tol 1e-3) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"flash attention kernels at D=64 disagree "
                                 f"with their plain versions ({label})")
        errs = {"flash_attention_fwd": _max_err(o, o2),
                "flash_attention_bwd_dkv": max(_max_err(dk, dk2),
                                               _max_err(dv, dv2)),
                "flash_attention_bwd_dq": _max_err(dq, dq2)}
        worst = {"flash_attention_fwd": ratios["O"],
                 "flash_attention_bwd_dkv": max(ratios["dK"], ratios["dV"]),
                 "flash_attention_bwd_dq": ratios["dQ"]}
        del o2, lse2, dq2, dk2, dv2, dq, dk, dv
        if bias:
            continue
        _d64_times(dev, results, probes, model, q, k, v, do, seed, causal,
                   o, lse, errs, worst, sdpa)
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()
    _d64_offset_check(dev, gen, p, RTOL, FLOOR)


def _d64_offset_check(dev, gen, p, rtol, floor):
    """A data-parallel rank's rows (auto-parallel's SDPA on a batch
    shard): the BERT shape's batch in two, the kernels on the second half
    with the dropout hash's bh offset 16 x 12. Its O is held to the plain
    version of the whole batch (rows 16..31: the one-process mask), and
    its dQ, dK and dV to the plain backward of the shard at the same
    offset, with phase_flash_kernels' tolerances."""
    from paddle_tpu_torch.framework.random import generator
    from paddle_tpu_torch.ops.kernels import flash_attention as FA

    b, S = D64_SHAPES["bert"]["batch"], D64_SHAPES["bert"]["seq"]
    q, k, v, do, _ = _d64_inputs(dev, gen, b, S, False)
    half, heads = b // 2, q.shape[1]
    off = half * heads
    seed = FA.seed_from_generator(generator(dev))
    qs, ks, vs, dos = (t[half:].contiguous() for t in (q, k, v, do))
    o, lse = FA.forward_with_lse(qs, ks, vs, None, seed, False, p, off)
    dq, dk, dv = FA.backward(qs, ks, vs, None, seed, o, lse, dos, False, p,
                             off)
    o_all, lse_all = FA._forward_ref(q, k, v, None, seed, False, p)
    dq2, dk2, dv2 = FA._backward_ref(qs, ks, vs, None, seed, o, lse, dos,
                                     False, p, off)
    torch.cuda.synchronize()
    ratios = {n: _worst_of_tol(a, r, rtol, floor)
              for n, (a, r) in (("O", (o, o_all[half:])), ("dQ", (dq, dq2)),
                                ("dK", (dk, dk2)), ("dV", (dv, dv2)))}
    el = _max_err(lse, lse_all[half:])
    ok = el <= 1e-3 and max(ratios.values()) <= 1.0
    log(f"flash attention D=64 bh offset {off} (rows {half}..{b - 1} of "
        f"[{b}, {heads}, {S}, 64], dropout {p}): worst error / tol "
        + ", ".join(f"{n} {r:.3f}" for n, r in ratios.items())
        + f"; LSE max_abs_err {el:.3e} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("flash attention kernels with a bh offset "
                             "disagree with the one-process plain version")
    del q, k, v, do, o_all, lse_all
    torch.cuda.empty_cache()


def _d64_times(dev, results, probes, model, q, k, v, do, seed, causal, o,
               lse, errs, worst, sdpa):
    """phase_flash_d64's rows of one shape: each kernel's ms, bound, plain
    and library times."""
    from paddle_tpu_torch.ops.kernels import flash_attention as FA

    p = ATTN_DROPOUT
    b, H, S, D = q.shape
    pairs = b * H * S * (S + 1) // 2 if causal else b * H * S * S
    _, _, _, _, _, _, delta = FA._bwd_inputs(q, k, v, None, o, lse, do,
                                             causal)
    big = dict(calls=3, windows=3, warmup=1)
    plain_fwd = time_ms(lambda: FA._forward_ref(q, k, v, None, seed, causal,
                                                p), **big)
    plain_bwd = time_ms(lambda: FA._backward_ref(
        q, k, v, None, seed, o, lse, do, causal, p), **big)
    lib_fwd = time_ms(lambda: sdpa(q, k, v, dropout_p=p, is_causal=causal),
                      calls=10, windows=5, warmup=2)
    qg, kg, vg = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    out = sdpa(qg, kg, vg, dropout_p=p, is_causal=causal)
    lib_bwd = time_ms(lambda: torch.autograd.grad(
        out, (qg, kg, vg), do, retain_graph=True), calls=10, windows=5,
        warmup=2)
    del out, qg, kg, vg
    shape = (f"q/k/v [{b}, {H}, {S}, {D}] bf16{' causal' if causal else ''}"
             f", dropout {p}, {pairs} pairs")
    lse_b, d_b = nbytes(lse), nbytes(delta)
    rows = {
        "flash_attention_fwd": dict(
            source="paddle_tpu_torch/ops/kernels/csrc/flash_attention_fwd.cu",
            replaces="paddle_tpu/ops/pallas/flash_attention.py:135",
            fn=lambda: FA.forward_with_lse(q, k, v, None, seed, causal, p),
            ops=4 * D * pairs, nbytes=nbytes(q, k, v, o) + lse_b,
            plain_ms=plain_fwd, library_ms=lib_fwd,
            library="SDPA forward, dropout_p=0.1",
            symbol="flash_fwd_kernel"),
        "flash_attention_bwd_dkv": dict(
            source="paddle_tpu_torch/ops/kernels/csrc/flash_attention_bwd.cu",
            replaces="paddle_tpu/ops/pallas/flash_attention.py:315",
            fn=lambda: FA._launch_bwd_dkv(q, k, v, None, seed, do, lse,
                                          delta, causal, p),
            ops=8 * D * pairs, nbytes=nbytes(q, k, v, do, k, v) + lse_b + d_b,
            plain_ms=plain_bwd, library_ms=lib_bwd,
            library="SDPA backward, dropout_p=0.1 (dQ, dK, dV together)",
            symbol="flash_bwd_dkv_kernel"),
        "flash_attention_bwd_dq": dict(
            source="paddle_tpu_torch/ops/kernels/csrc/flash_attention_bwd.cu",
            replaces="paddle_tpu/ops/pallas/flash_attention.py:389",
            fn=lambda: FA._launch_bwd_dq(q, k, v, None, seed, do, lse,
                                         delta, causal, p),
            ops=6 * D * pairs, nbytes=nbytes(q, k, v, do, q) + lse_b + d_b,
            plain_ms=plain_bwd, library_ms=lib_bwd,
            library="SDPA backward, dropout_p=0.1 (dQ, dK, dV together)",
            symbol="flash_bwd_dq_kernel"),
    }
    for kernel, r in rows.items():
        name = f"{kernel}_d64_{model}"
        bnd, by = bound(r["nbytes"], r["ops"], BF16_OPS_PER_S)
        ms = time_ms(r["fn"], calls=5, windows=5, warmup=2)
        results[name] = dict(
            name=name, route="cuda", source=r["source"],
            replaces=r["replaces"], max_abs_err=errs[kernel], ms=ms,
            plain_ms=r["plain_ms"], bound_ms=bnd, bound_by=by,
            library_ms=r["library_ms"], library=r["library"], shape=shape,
            plain_note="one dense f32 backward computes dQ, dK and dV"
            if "bwd" in kernel else "dense f32 forward",
            tflops=r["ops"] / ms / 1e9, bound_share=bnd / ms,
            worst_ratio_at_shape=worst[kernel], kernel=kernel,
            paths=[model] + (["auto_parallel"] if model == "bert" else []))
        probes[name] = (r["fn"], r["symbol"], 5, results[name])
        log(f"{name}: {ms:.3f} ms a call, {r['plain_ms']:.3f} ms plain, "
            f"library {r['library_ms']:.3f} ms ({r['library']}), bound "
            f"{bnd:.4f} ms ({by}), {r['ops'] / ms / 1e9:.1f} TFLOP/s, "
            f"{100 * bnd / ms:.1f}% of the bound")


def phase_sep(dev):
    """The ring attention's hops (ops/kernels/ring_attention.py) at the
    flagship training shape, q/k/v [4, 16, 4096, 128] bf16 causal, for
    SEP_RANKS virtual sep ranks on this one card: each rank's hops composed
    from the module's own per-hop forward, merge and backward
    (compose_forward / compose_backward), every shard already on the card
    (the exchange runs in the --hybrid jobs). O, LSE, dQ, dK and dV held
    to the flash kernels over the whole sequence on the same inputs with
    phase_flash_kernels' tolerances; the launches held exactly (n ranks
    run n(n+1)/2 causal hops: that many forward, dK/dV and dQ launches);
    the composition's forward + backward timed beside the whole call's.
    Both sides are bf16 kernels that phase 2 holds within
    2**-6 * (|ref| + row RMS) + 1e-5 of the plain f32 versions, so they
    are held within twice that of each other (the composition rounds each
    hop's O, dK and dV to bf16 before it merges or adds them in f32)."""
    from paddle_tpu_torch import launch_counts, reset_launch_counts
    from paddle_tpu_torch.ops.kernels import flash_attention as FA
    from paddle_tpu_torch.ops.kernels import ring_attention as RA

    gen = torch.Generator(device=dev).manual_seed(18)
    B, H, S, D = TRAIN_BATCH, 16, TRAIN_SEQ, 128
    RTOL, FLOOR = 2.0 ** -5, 2e-5
    q, k, v, do = [torch.randn(B, H, S, D, device=dev, generator=gen)
                   .to(torch.bfloat16) for _ in range(4)]
    # the whole sequence, the comparison (its launches are not the path's)
    o, lse = FA.forward_with_lse(q, k, v, None, 0, True, 0.0)
    dq, dk, dv = FA.backward(q, k, v, None, 0, o, lse, do, True, 0.0)

    def whole():
        o_, lse_ = FA.forward_with_lse(q, k, v, None, 0, True, 0.0)
        FA.backward(q, k, v, None, 0, o_, lse_, do, True, 0.0)

    whole_ms = time_ms(whole, calls=3, windows=5, warmup=1)
    counts, out = Counter(), {"shape": f"q/k/v [{B}, {H}, {S}, {D}] bf16 "
                              f"causal", "whole_ms": whole_ms, "ranks": {}}
    for n in SEP_RANKS:
        qs, ks, vs, dos = ([c.contiguous() for c in t.chunk(n, dim=2)]
                           for t in (q, k, v, do))
        torch.cuda.synchronize()
        reset_launch_counts()
        os_, lses = RA.compose_forward(qs, ks, vs, True)
        dqs, dks, dvs = RA.compose_backward(qs, ks, vs, os_, lses, dos, True)
        torch.cuda.synchronize()
        got = launch_counts()
        hops = n * (n + 1) // 2
        want = {"flash_attention_fwd": hops, "flash_attention_bwd_dkv": hops,
                "flash_attention_bwd_dq": hops, "aligned16_copies": 0}
        ratios = {name: _worst_of_tol(torch.cat(a, 2), b, RTOL, FLOOR)
                  for name, (a, b) in (("O", (os_, o)), ("dQ", (dqs, dq)),
                                       ("dK", (dks, dk)), ("dV", (dvs, dv)))}
        el = _max_err(torch.cat(lses, 2), lse)
        finite = all(bool(torch.isfinite(torch.cat(t, 2).float()).all())
                     for t in (os_, dqs, dks, dvs))

        def composed():
            o_, l_ = RA.compose_forward(qs, ks, vs, True)
            RA.compose_backward(qs, ks, vs, o_, l_, dos, True)

        ms = time_ms(composed, calls=3, windows=5, warmup=1)
        launched = {name: got[name] for name in want}
        ok = finite and el <= 1e-3 and max(ratios.values()) <= 1.0 \
            and launched == want
        out["ranks"][n] = {"worst_ratio": ratios, "lse_max_abs_err": el,
                           "launches": launched, "ms": ms,
                           "ms_over_whole": ms / whole_ms,
                           "max_abs_err": {
                               "O": _max_err(torch.cat(os_, 2), o),
                               "dQ": _max_err(torch.cat(dqs, 2), dq),
                               "dK": _max_err(torch.cat(dks, 2), dk),
                               "dV": _max_err(torch.cat(dvs, 2), dv)}}
        log(f"sep: {n} virtual ranks over {out['shape']}: the ring's hops "
            f"against the whole flash call, worst error / tol "
            + ", ".join(f"{name} {r:.3f}" for name, r in ratios.items())
            + f" (tol 2**-5 * (|ref| + row RMS) + 2e-5), LSE max_abs_err "
            f"{el:.3e} (tol 1e-3); launches {launched} (want {want}); "
            f"forward + backward {ms:.3f} ms composed against {whole_ms:.3f}"
            f" ms whole {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"sep: the ring's hops at {n} ranks "
                                 f"disagree with the whole flash call, or "
                                 f"launched {launched} (want {want})")
        counts.update({name: got[name] for name in want})
        del qs, ks, vs, dos, os_, lses, dqs, dks, dvs
    log(json.dumps({"sep": out}))
    out["counts"] = counts
    out["per_call"] = {name: {f"{n} ranks": out["ranks"][n]["launches"][name]
                              for n in SEP_RANKS} for name in PRETRAIN_KERNELS}
    del q, k, v, do, o, lse, dq, dk, dv
    torch.cuda.empty_cache()
    return out


def _packed_lens(total, seed):
    """Document lengths log-uniform on [128, 4096] from a seeded
    numpy.random.default_rng, the last cut so they sum to ``total``."""
    rng = np.random.default_rng(seed)
    lens = []
    while sum(lens) < total:
        lens.append(int(round(float(np.exp(rng.uniform(np.log(128),
                                                       np.log(4096)))))))
    lens[-1] -= sum(lens) - total
    return lens


def _packed_segments(lens, total, dev):
    from paddle_tpu_torch.ops.kernels import varlen_attention as VA

    cu = np.concatenate([[0], np.cumsum(lens)])
    return torch.tensor(VA.segment_ids_from_cu_seqlens(cu, total),
                        device=dev)[None]


def _causal_segment_pairs(seg):
    """Valid causal (query, key) pairs of one head: the same non-negative
    segment, row >= col."""
    s = seg[0].long()
    n = torch.unique(s[s >= 0], return_counts=True)[1].long()
    return int((n * (n + 1) // 2).sum())


def phase_varlen_bwd_kernels(dev, results, probes):
    """The varlen backward kernels against their plain version at the
    flagship's attention width (H=16, D=128, bf16) over 4096 packed tokens
    with a padding tail and a query segment whose keys carry another id,
    causal and not: the live rows element by element, the dead rows
    (padding, and the segment with no valid key) and dead keys exactly 0.
    Then, at the packed-training shape (16,384 tokens, causal) and two
    document mixes, the forward and both backward kernels against their
    plain versions, and their times beside the plain versions and SDPA
    with the block-diagonal causal mask."""
    from paddle_tpu_torch.ops.kernels import varlen_attention as VA

    gen = torch.Generator(device=dev).manual_seed(2)
    H, D = 16, 128
    RTOL, FLOOR = 2.0 ** -6, 1e-5
    T = VARLEN_CHECK_TOKENS
    lens = _packed_lens(T - 96, PACKED_SEED + 1)
    seg = _packed_segments(lens, T, dev)
    segk = seg.clone()
    segk[segk == 1] = 10 ** 6                  # segment 1 finds no key
    dead_q = (seg[0] < 0) | (seg[0] == 1)
    dead_k = (segk[0] < 0) | (segk[0] == 10 ** 6)
    q, k, v, do = [torch.randn(1, H, T, D, device=dev, generator=gen)
                   .to(torch.bfloat16) for _ in range(4)]
    errs = {"varlen_attention_bwd_dkv": 0.0, "varlen_attention_bwd_dq": 0.0}
    for causal in (True, False):
        o, lse = VA.varlen_flash_attention_packed(q, k, v, seg, segk, causal)
        dq, dk, dv = VA.varlen_backward(q, k, v, seg, segk, o, lse, do,
                                        causal)
        dq2, dk2, dv2 = VA._varlen_bwd_ref(q, k, v, seg, segk, o, lse, do,
                                           causal)
        torch.cuda.synchronize()
        live = {n: (a[:, :, ~m].float(), b[:, :, ~m])
                for n, a, b, m in (("dQ", dq, dq2, dead_q),
                                   ("dK", dk, dk2, dead_k),
                                   ("dV", dv, dv2, dead_k))}
        # the worst ratio over the finite elements, and the count of the
        # others (each fails the check)
        ratios = {n: _worst_of_tol(torch.where(torch.isfinite(a), a,
                                               b.float()), b, RTOL, FLOOR)
                  for n, (a, b) in live.items()}
        nonfinite = {n: int((~torch.isfinite(a)).sum())
                     for n, (a, _) in live.items()}
        rms = {n: _rms(b[:, :, ~m]) for n, b, m in (("dQ", dq2, dead_q),
                                                   ("dK", dk2, dead_k),
                                                   ("dV", dv2, dead_k))}
        zero = all(bool((t[:, :, m] == 0).all())
                   for t, m in ((dq, dead_q), (dk, dead_k), (dv, dead_k),
                                (dq2, dead_q), (dk2, dead_k),
                                (dv2, dead_k)))
        finite = all(bool(torch.isfinite(t.float()).all())
                     for t in (dq, dk, dv))
        worst = max(ratios.values())
        ok = finite and zero and worst <= 1.0
        log(f"varlen backward H={H} T={T} D={D} bf16 causal={causal} "
            f"({len(lens)} documents + {int((seg < 0).sum())} padding "
            f"tokens): worst error / tol "
            + ", ".join(f"{n} {ratios[n]:.3f} (RMS {rms[n]:.3e}"
                        + (f", {nonfinite[n]} non-finite"
                           if nonfinite[n] else "") + ")"
                        for n in ratios)
            + f" (tol 2**-6 * (|ref| + row RMS) + 1e-5); "
            f"{int(dead_q.sum())} dead rows and {int(dead_k.sum())} dead "
            f"keys exactly 0: {zero} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("varlen backward kernels disagree with "
                                 "their plain version")
        errs["varlen_attention_bwd_dkv"] = max(
            errs["varlen_attention_bwd_dkv"], _max_err(dk, dk2),
            _max_err(dv, dv2))
        errs["varlen_attention_bwd_dq"] = max(
            errs["varlen_attention_bwd_dq"], _max_err(dq, dq2))
    del q, k, v, do, o, lse, dq, dk, dv, dq2, dk2, dv2

    # the packed-training shape (16,384 tokens, causal) with two document
    # mixes: the packed-training phase's 12 documents, and the flagship
    # row's own sequences packed (4 of 4096: long documents, so a larger
    # share of the causal tiles holds pairs of one document and the
    # backward kernels skip fewer). Each mix fills the whole axis, so no
    # row or key is dead. At each: the three kernels against their plain
    # versions (the forward's one head at a time), element by element as
    # above, then their times; the forward also gives the same bits twice.
    T = PACKED_TOKENS
    mixes = ((f"{len(_packed_lens(T, PACKED_SEED))} documents (seed "
              f"{PACKED_SEED})", _packed_lens(T, PACKED_SEED)),
             (f"{TRAIN_BATCH} documents of {T // TRAIN_BATCH}",
              [T // TRAIN_BATCH] * TRAIN_BATCH))
    fwd_err = fwd_ratio = 0.0
    for i, (mix, lens) in enumerate(mixes):
        seg = _packed_segments(lens, T, dev)
        q, k, v, do = [torch.randn(1, H, T, D, device=dev, generator=gen)
                       .to(torch.bfloat16) for _ in range(4)]
        o, lse = VA.varlen_flash_attention_packed(q, k, v, seg, seg, True)
        o_again, lse_again = VA.varlen_flash_attention_packed(q, k, v, seg,
                                                              seg, True)
        o2, lse2 = _varlen_ref_by_head(q, k, v, seg, True)
        got = VA.varlen_backward(q, k, v, seg, seg, o, lse, do, True)
        ref = VA._varlen_bwd_ref(q, k, v, seg, seg, o, lse, do, True)
        torch.cuda.synchronize()
        names = ("O", "dQ", "dK", "dV")
        ratios = {n: _worst_of_tol(a, b, RTOL, FLOOR)
                  for n, a, b in zip(names, (o, *got), (o2, *ref))}
        rms = {n: _rms(b) for n, b in zip(names, (o2, *ref))}
        el = _max_err(lse, lse2)
        finite = all(bool(torch.isfinite(t.float()).all())
                     for t in (o, *got))
        same = torch.equal(o, o_again) and torch.equal(lse, lse_again)
        del o_again, lse_again
        worst = max(ratios.values())
        ok = finite and same and el <= 1e-3 and worst <= 1.0
        log(f"varlen forward + backward H={H} T={T} D={D} bf16 causal, "
            f"{mix}: worst error / tol "
            + ", ".join(f"{n} {ratios[n]:.3f} (RMS {rms[n]:.3e})"
                        for n in names)
            + f" (tol 2**-6 * (|ref| + row RMS) + 1e-5); LSE max_abs_err "
            f"{el:.3e} (tol 1e-3; RMS of LSE {_rms(lse2):.3e}); finite "
            f"{finite}; two forward calls bit-identical {same} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("varlen attention kernels disagree with "
                                 "their plain versions at the packed shape")
        fwd_err = max(fwd_err, _max_err(o, o2))
        fwd_ratio = max(fwd_ratio, ratios["O"])
        errs["varlen_attention_bwd_dkv"] = max(
            errs["varlen_attention_bwd_dkv"], _max_err(got[1], ref[1]),
            _max_err(got[2], ref[2]))
        errs["varlen_attention_bwd_dq"] = max(
            errs["varlen_attention_bwd_dq"], _max_err(got[0], ref[0]))
        del o2, lse2, got, ref
        _time_varlen_packed(results, probes, mix, i == 0, q, k, v, do, seg,
                            o, lse)
    fp = results["varlen_attention_fwd"]["at_packed_shape"]
    fp["max_abs_err"] = fwd_err
    # worst error / tol of O against the plain version over both mixes
    fp["worst_ratio_at_shape"] = fwd_ratio
    for name in errs:
        results[name]["max_abs_err"] = errs[name]


def _varlen_ref_by_head(q, k, v, seg, causal):
    """The varlen forward's plain version one head at a time (a head's
    [T, T] f32 logits are 1 GiB at 16,384 tokens): (O, LSE)."""
    from paddle_tpu_torch.ops.kernels import varlen_attention as VA

    outs = [VA._varlen_ref(q[:, h:h + 1], k[:, h:h + 1], v[:, h:h + 1],
                           seg, seg, causal) for h in range(q.shape[1])]
    return (torch.cat([o for o, _ in outs], 1),
            torch.cat([lse for _, lse in outs], 1))


def _skip_tiles(seg):
    """(key tiles the segment-range skip leaves in, causal tiles), computed
    on the host from one sequence of segment ids [1, T] with T a multiple
    of 128, causal: query block i (128 rows) keeps key tile j (64 keys)
    below its diagonal when one of the tile's ids lies in [min, max] of the
    block's non-negative ids. Not counted on the card: a block with a row
    that finds no valid key visits every tile up to its bound as well (the
    mixes timed here have no such row), and a kernel that skipped nothing
    would not change these numbers; its measured times at the two mixes
    show the skip."""
    s = seg[0].cpu().numpy()
    tiles = s.reshape(-1, 64)
    kept = causal = 0
    for i, blk in enumerate(s.reshape(-1, 128)):
        live = blk[blk >= 0]
        n = 2 * i + 2
        causal += n
        if live.size:
            lo, hi = live.min(), live.max()
            kept += int(((tiles[:n] >= lo) & (tiles[:n] <= hi))
                           .any(axis=1).sum())
    return kept, causal


def _bwd_block_tiles(seg):
    """Streamed tiles each block of the varlen backward kernels visits,
    computed on the host from one sequence of segment ids [1, T] with T a
    multiple of 128, causal, self-attention: dK/dV block i (keys 128i..)
    visits query tile j >= 2i, dQ block i (queries 128i..) key tile j <
    2i + 2, when one of the tile's 64 ids lies in [min, max] of the block's
    non-negative ids. Returns (dK/dV counts, dQ counts), one a block and
    head."""
    s = seg[0].cpu().numpy()
    tiles = s.reshape(-1, 64)
    dkv, dq = [], []
    for i, blk in enumerate(s.reshape(-1, 128)):
        live = blk[blk >= 0]
        hit = ((tiles >= live.min()) & (tiles <= live.max())).any(axis=1) \
            if live.size else np.zeros(len(tiles), bool)
        dkv.append(int(hit[2 * i:].sum()))
        dq.append(int(hit[:2 * i + 2].sum()))
    return dkv, dq


def _time_varlen_packed(results, probes, mix, first, q, k, v, do, seg, o,
                        lse):
    """Times of the varlen kernels at the packed shape for one document
    mix, beside their plain versions and SDPA with the block-diagonal
    causal bool mask. The first mix makes the backward kernels' rows and
    the forward's ``at_packed_shape``; a later one adds ``at_<mix>`` to
    the backward rows and ``at_packed_shape_<mix>`` to the forward's."""
    from paddle_tpu_torch.ops.kernels import varlen_attention as VA

    sdpa = torch.nn.functional.scaled_dot_product_attention
    H, T, D = q.shape[1], q.shape[2], q.shape[3]
    delta = (do.float() * o.float()).sum(-1)
    pairs = H * _causal_segment_pairs(seg)
    all_pairs = H * T * (T + 1) // 2
    fwd = lambda: VA.varlen_flash_attention_packed(  # noqa: E731
        q, k, v, seg, seg, True)
    dkv = lambda: VA._launch_bwd_dkv(  # noqa: E731
        q, k, v, seg, seg, do, lse, delta, True)
    dqk = lambda: VA._launch_bwd_dq(  # noqa: E731
        q, k, v, seg, seg, do, lse, delta, True)
    pos = torch.arange(T, device=q.device)
    mask = (seg[0][:, None] == seg[0][None, :]) \
        & (pos[:, None] >= pos[None, :])
    qg, kg, vg = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    out = sdpa(qg, kg, vg, attn_mask=mask)
    lib_bwd_ms = time_ms(lambda: torch.autograd.grad(
        out, (qg, kg, vg), do, retain_graph=True), calls=5, windows=5,
        warmup=2)
    del out, qg, kg, vg
    plain_bwd_ms = time_ms(lambda: VA._varlen_bwd_ref(
        q, k, v, seg, seg, o, lse, do, True), calls=1, windows=3, warmup=1)
    shape = (f"q/k/v/dO [1, {H}, {T}, {D}] bf16 causal, {mix}, {pairs} "
             f"within-segment causal pairs ({pairs / all_pairs:.3f} of the "
             f"causal triangle)")
    lse_b, d_b, seg_b = nbytes(lse), nbytes(delta), 2 * nbytes(seg)
    lib_note = ("SDPA backward (dQ, dK, dV together), block-diagonal causal "
                "bool mask")
    # the forward at every mix: its tile skip visits the key tiles whose
    # segment ids meet its 128-row query block's, so its time follows the
    # mix
    lib_fwd_ms = time_ms(lambda: sdpa(q, k, v, attn_mask=mask), calls=5,
                         windows=5, warmup=2)
    b, by = bound(nbytes(q, k, v, o) + lse_b + seg_b, 4 * D * pairs,
                  BF16_OPS_PER_S)
    fwd_ms = time_ms(fwd, calls=5, windows=5, warmup=2)
    kept, causal_tiles = _skip_tiles(seg)
    fp = dict(
        shape=shape, ms=fwd_ms,
        plain_ms=time_ms(lambda: _varlen_ref_by_head(q, k, v, seg, True),
                         calls=1, windows=3, warmup=1),
        plain_note="the dense f32 plain version a head at a time",
        bound_ms=b, bound_by=by, library_ms=lib_fwd_ms,
        library="SDPA forward, block-diagonal causal bool mask",
        tflops=4 * D * pairs / fwd_ms / 1e9, bound_share=b / fwd_ms)
    key = "at_packed_shape" + ("" if first else "_" + "_".join(mix.split()))
    results["varlen_attention_fwd"][key] = fp
    probes[f"varlen_attention_fwd {key}"] = (fwd, "varlen_fwd_kernel", 5, fp)
    log(f"varlen_attention_fwd at the packed shape ({mix}): {fwd_ms:.3f} ms "
        f"a call, {fp['plain_ms']:.3f} ms plain, library {lib_fwd_ms:.3f} "
        f"ms, bound {b:.4f} ms ({by}), {fp['tflops']:.1f} TFLOP/s over the "
        f"within-segment pairs, {100 * fp['bound_share']:.1f}% of the bound")
    log(f"  the skip's rule keeps {kept} of the {causal_tiles} causal 128x64 "
        f"tiles ({100 * kept / causal_tiles:.1f}%): computed on the host from "
        f"the segment ids, not counted on the card")
    rows = {
        "varlen_attention_bwd_dkv": dict(
            replaces="paddle_tpu/ops/pallas/varlen_attention.py:147",
            fn=dkv, ops=8 * D * pairs,
            nbytes=nbytes(q, k, v, do, k, v) + lse_b + d_b + seg_b,
            symbol="varlen_bwd_dkv_kernel"),
        "varlen_attention_bwd_dq": dict(
            replaces="paddle_tpu/ops/pallas/varlen_attention.py:196",
            fn=dqk, ops=6 * D * pairs,
            nbytes=nbytes(q, k, v, do, q) + lse_b + d_b + seg_b,
            symbol="varlen_bwd_dq_kernel"),
    }
    # the spread of the work over the blocks: each block's visited tiles
    # (a block's time follows them), beside the grid of 128-row blocks;
    # worked out from the ids, so it stays in the log
    for name, n in zip(("varlen_attention_bwd_dkv", "varlen_attention_bwd_dq"),
                       _bwd_block_tiles(seg)):
        log(f"  {name} ({mix}): tiles visited a block (computed on the host "
            f"from the segment ids, {len(n)} blocks a head): min {min(n)}, "
            f"median {statistics.median(n)}, mean {statistics.mean(n):.2f}, "
            f"max {max(n)}; {sum(n)} in all")
    for name, r in rows.items():
        b, by = bound(r["nbytes"], r["ops"], BF16_OPS_PER_S)
        ms = time_ms(r["fn"], calls=5, windows=5, warmup=2)
        row = dict(ms=ms, plain_ms=plain_bwd_ms, bound_ms=b, bound_by=by,
                   library_ms=lib_bwd_ms, library=lib_note, shape=shape,
                   plain_note="one dense f32 backward, a head at a time, "
                              "computes dQ, dK and dV",
                   # achieved rate over the within-segment pairs' operations
                   # and the share of the bound
                   tflops=r["ops"] / ms / 1e9, bound_share=b / ms)
        if first:
            row = results[name] = dict(
                name=name, route="cuda",
                source="paddle_tpu_torch/ops/kernels/csrc/"
                       "varlen_attention_bwd.cu",
                replaces=r["replaces"], max_abs_err=None, **row)
            probes[name] = (r["fn"], r["symbol"], 5, row)
        else:
            key = "at_" + "_".join(mix.split())
            results[name][key] = row
            probes[f"{name} {key}"] = (r["fn"], r["symbol"], 5, row)
        log(f"{name} ({mix}): {row['ms']:.3f} ms a call, "
            f"{plain_bwd_ms:.3f} ms plain, library {lib_bwd_ms:.3f} ms, "
            f"bound {b:.4f} ms ({by}), {row['tflops']:.1f} TFLOP/s over the "
            f"within-segment pairs, {100 * row['bound_share']:.1f}% of the "
            f"bound")


@contextlib.contextmanager
def one_cpu_thread():
    """PyTorch on one intra-op thread inside the block, restored after: the
    parity phases' CPU reference passes run under it. With two or more
    threads, the first float exp of a process after its first MKL GEMM
    sometimes computes one thread's share at low accuracy (relative error
    up to 1.5e-4; tests/test_torch_varlen_attention.py). On an 8-thread
    H100 host it moved the training parity's CPU lm_head gradient to 4.4x
    its tolerance in one fresh process of eight (0.08x in the others),
    while the card's side repeated to the bit
    (tools/cpu_reference_spread.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _flagship_config():
    from paddle_tpu_torch.models.llama import LlamaConfig

    # bench.py:1966-1971, the TPU package's flagship training row
    return LlamaConfig(vocab_size=32000, hidden_size=2048,
                       intermediate_size=5632, num_hidden_layers=16,
                       num_attention_heads=16, num_key_value_heads=16,
                       max_position_embeddings=4096, dtype="bfloat16",
                       recompute=True)


def model_flops_per_token(cfg, n_params, seq):
    """6N + 12 * L * h * s a token (bench.py:116-120, PaLM appendix B)."""
    return 6 * n_params + 12 * cfg.num_hidden_layers * cfg.hidden_size * seq


def phase_training(dev):
    """The flagship row through HybridTrainer.step: one warm-up step, then
    3 timed steps with the launch counters read per step."""
    from paddle_tpu_torch import launch_counts, reset_launch_counts
    from paddle_tpu_torch.distributed.fleet import HybridTrainer
    from paddle_tpu_torch.models.llama import num_params

    cfg = _flagship_config()
    batch, seq, steps = TRAIN_BATCH, TRAIN_SEQ, 3
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    trainer = HybridTrainer(cfg, learning_rate=3e-4, seed=1234, device=dev)
    torch.cuda.synchronize()
    n_params = num_params(trainer.params)
    log(f"training: flagship {n_params / 1e9:.3f}B params, init "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.RandomState(0)
    ids = rng.randint(0, cfg.vocab_size, (batch, seq)).astype(np.int64)
    labels = np.roll(ids, -1, axis=1)
    ids_t = torch.tensor(ids, device=dev)
    labels_t = torch.tensor(labels, device=dev)
    t = time.perf_counter()
    warm = float(trainer.step(ids_t, labels_t))
    torch.cuda.synchronize()
    log(f"training warm-up step: {time.perf_counter() - t:.2f} s, loss "
        f"{warm:.4f}")
    # no input of the step's kernels needs a copy to a 16-byte boundary
    expect = {"rms_norm": 4 * cfg.num_hidden_layers + 1,
              "rms_norm_bwd": 2 * cfg.num_hidden_layers + 1,
              "flash_attention_fwd": 2 * cfg.num_hidden_layers,
              "flash_attention_bwd_dkv": cfg.num_hidden_layers,
              "flash_attention_bwd_dq": cfg.num_hidden_layers,
              "aligned16_copies": 0}
    losses, step_ms, per_step = [], [], []
    torch.cuda.synchronize()
    start = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    for _ in range(steps):
        before = launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss = trainer.step(ids_t, labels_t)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        losses.append(float(loss))
        per = {k: v - before[k] for k, v in launch_counts().items()}
        per_step.append(per)
        for name, n in expect.items():
            if per[name] != n:
                raise AssertionError(f"training step launched {name} "
                                     f"{per[name]} times, not {n}")
        if per["varlen_attention_fwd"]:
            raise AssertionError("the training step launched the varlen "
                                 "kernel")
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    if not all(np.isfinite(losses)):
        raise AssertionError(f"training losses not finite: {losses}")
    ms = statistics.median(step_ms)
    tps = batch * seq / (ms / 1e3)
    fpt = model_flops_per_token(cfg, n_params, seq)
    metrics = {
        "batch": batch, "seq": seq, "steps": steps,
        "step_ms": step_ms, "step_ms_median": ms, "tokens_per_s": tps,
        "losses": losses, "warmup_loss": warm,
        "model_flops_per_token": fpt,
        "share_of_989_tflops": tps * fpt / BF16_OPS_PER_S,
        # over the timed steps, and over their start (weights, moments)
        "peak_memory_gb": peak / 1e9,
        "peak_over_start_gb": (peak - start) / 1e9,
        # as counted in the last step (each step was held to `expect`)
        "launches_per_step": per_step[-1],
    }
    log(json.dumps({"training": metrics}))
    metrics["remat_policies"] = _remat_policies(dev, trainer, ids_t,
                                                labels_t, expect, metrics)
    return dict(metrics=metrics, counts=counts, trainer=trainer,
                ids=ids_t, labels=labels_t)


def _held_after_forward(dev, trainer, ids, labels):
    """Device bytes the step's forward leaves held for its backward: the
    memory allocated once the loss is computed, less the memory before."""
    from paddle_tpu_torch.models import llama

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(dev)
    loss = llama.loss_fn_stacked(trainer.params, (ids, labels),
                                 trainer.config, remat=trainer.remat)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated(dev) - before
    del loss
    return held


def _remat_policies(dev, trainer, ids, labels, expect, full):
    """The flagship step under each remat policy, on the same trainer:
    "full", timed by phase_training (``full``), recomputes each block in
    the backward; "save_attn" keeps each block's attention output O and
    LSE, recomputes q, k and v, and does not run the attention forward
    again (16 forward launches a step in place of 32). For "save_attn" its
    step time (median of as many steps as ``full`` after one warm-up) and
    peak device memory, absolute and over the step's start; for both, the
    bytes a forward leaves held for the backward. Their difference must be
    the layers' O and LSE, no more: what "save_attn" keeps beside "full".
    The policy is set back to "full" after."""
    from paddle_tpu_torch import launch_counts

    cfg = trainer.config
    layers, batch, seq = cfg.num_hidden_layers, ids.shape[0], ids.shape[1]
    out = {"full": {k: full[k] for k in (
        "step_ms", "step_ms_median", "peak_memory_gb", "peak_over_start_gb",
        "launches_per_step")}}
    held_full = _held_after_forward(dev, trainer, ids, labels)
    out["full"]["held_after_forward_gb"] = held_full / 1e9
    cfg.remat_policy = "save_attn"
    want = dict(expect, flash_attention_fwd=layers)
    trainer.step(ids, labels)
    torch.cuda.synchronize()
    start = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    step_ms = []
    for _ in range(full["steps"]):
        before = launch_counts()
        t = time.perf_counter()
        loss = float(trainer.step(ids, labels))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        per = {k: v - before[k] for k, v in launch_counts().items()}
        for name, n in want.items():
            if per[name] != n:
                raise AssertionError(f"training step under save_attn "
                                     f"launched {name} {per[name]} times, "
                                     f"not {n}")
        if not np.isfinite(loss):
            raise AssertionError(f"save_attn: loss {loss}")
    peak = torch.cuda.max_memory_allocated(dev)
    held = _held_after_forward(dev, trainer, ids, labels)
    cfg.remat_policy = "full"
    # a layer's O [B, H, S, D] bf16 and LSE [B, H, S] f32
    o_lse = layers * batch * cfg.num_attention_heads * seq * (
        cfg.hidden_size // cfg.num_attention_heads * 2 + 4)
    out["save_attn"] = {"step_ms": step_ms,
                        "step_ms_median": statistics.median(step_ms),
                        "peak_memory_gb": peak / 1e9,
                        "peak_over_start_gb": (peak - start) / 1e9,
                        "launches_per_step": per,
                        "held_after_forward_gb": held / 1e9}
    extra = held - held_full
    out["save_attn_held_over_full_gb"] = extra / 1e9
    out["layers_o_and_lse_gb"] = o_lse / 1e9
    log(json.dumps({"training_remat_policies": out}))
    # anything beyond O and LSE (say q, k, v, or O saved twice) is at
    # least a layer's [B, S, hidden] bf16 tensor, 67 MB at this shape
    if abs(extra - o_lse) > o_lse / (2 * layers):
        raise AssertionError(f"save_attn holds {extra / 1e9:.3f} GB over "
                             f"full after the forward, not the layers' O "
                             f"and LSE ({o_lse / 1e9:.3f} GB)")
    return out


def phase_training_parity(dev):
    """A 2-layer full-width f32 model at B=1, S=512: the loss and every
    gradient leaf on the card (kernels) against the same weights on the
    CPU (plain versions). Tolerance: loss 1e-4 relative, each gradient
    element within 1e-3 * (|ref| + its row's RMS) + 1e-12 (f32 sums over
    2048-5632 terms in other orders on the two devices)."""
    from paddle_tpu_torch import launch_counts, reset_launch_counts
    from paddle_tpu_torch.models import llama as TL

    base = _flagship_config()
    cfg = TL.LlamaConfig(**{**vars(base), "num_hidden_layers": 2,
                            "dtype": "float32"})
    params = TL.init_stacked_params(cfg, seed=7, device=dev)
    rng = np.random.RandomState(3)
    ids = torch.tensor(rng.randint(0, cfg.vocab_size,
                                   (1, min(512, TRAIN_SEQ))))
    labels = torch.roll(ids, -1, dims=1)
    out = []
    with one_cpu_thread():
        for where in (dev, torch.device("cpu")):
            p = {k: ({kk: vv.detach().to(where).requires_grad_(True)
                      for kk, vv in v.items()} if isinstance(v, dict)
                     else v.detach().to(where).requires_grad_(True))
                 for k, v in params.items()}
            reset_launch_counts()
            loss = TL.loss_fn_stacked(
                p, (ids.to(where), labels.to(where)), cfg)
            loss.backward()
            if where.type == "cuda":
                torch.cuda.synchronize()
                c = launch_counts()
                if min(c[n] for n in TRAINING_KERNELS) <= 0:
                    raise AssertionError(f"parity run missed a kernel: "
                                         f"{c}")
            out.append((float(loss.detach()),
                        {k: t.grad.detach().cpu()
                         for k, t in TL.leaves(p).items()}))
    (lc, gc), (lp, gp) = out
    ratios = {k: _worst_of_tol(gc[k], gp[k], 1e-3, 1e-12) for k in gp}
    worst_leaf = max(ratios, key=ratios.get)
    worst = ratios[worst_leaf]
    rel = abs(lc - lp) / abs(lp)
    ok = rel <= 1e-4 and worst <= 1.0 and len(gp) == 12
    log(f"training parity f32 2-layer full width B=1 S={ids.shape[1]}: "
        f"loss card "
        f"{lc:.6f} cpu {lp:.6f} (rel {rel:.2e}, tol 1e-4); every gradient "
        f"element within 1e-3 * (|ref| + row RMS) + 1e-12: worst ratio "
        f"{worst:.3e} ({worst_leaf}, RMS {_rms(gp[worst_leaf]):.3e}) over "
        f"{len(gp)} leaves {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("training on the card disagrees with the CPU")


def _eager_step(model, opt, ids, labels):
    """One step of the PaddlePaddle user's loop under AMP O1 bf16: the
    loss (a 0-d f32 Tensor), computed before the update."""
    import paddle_tpu_torch as paddle

    with paddle.amp.auto_cast(level="O1", dtype="bfloat16"):
        loss = model(ids, labels=labels)
    loss.backward()
    opt.step()
    opt.clear_grad()
    return loss


def phase_eager(dev):
    """The eager (dygraph) surface at the flagship row's widths: an eager
    LlamaForCausalLM (f32 parameters, recompute) trained by AdamW under
    amp.auto_cast("O1", "bfloat16") through loss.backward(), opt.step()
    and opt.clear_grad(): one warm-up and 3 timed steps, each held to the
    stacked trainer's launches (RMSNorm 65 and its gradient 33, flash
    forward 32, dK/dV 16, dQ 16, no 16-byte copy); then greedy generate
    of 16 tokens after a 128-token prompt (the prefill launches the flash
    forward 16 times, the one-token steps none: Sq = 1 takes the dense
    fallback); then a 2-layer f32 model at the same widths on the card
    against the CPU (loss, every gradient, one AdamW step, greedy
    tokens)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import launch_counts, reset_launch_counts
    from paddle_tpu_torch.models import llama as TL

    base = _flagship_config()
    cfg = TL.LlamaConfig(**vars(base))
    batch, seq, steps = TRAIN_BATCH, TRAIN_SEQ, 3
    paddle.set_device("gpu:0")
    torch.cuda.synchronize()
    start = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    paddle.seed(0)
    model = TL.LlamaForCausalLM(cfg)
    opt = paddle.optimizer.AdamW(learning_rate=3e-4,
                                 parameters=model.parameters())
    torch.cuda.synchronize()
    n_params = sum(p.size for p in model.parameters())
    if {p.dtype for p in model.parameters()} != {torch.float32} or \
            {p._value.device for p in model.parameters()} != {dev}:
        raise AssertionError("eager parameters are not f32 on the card")
    log(f"eager: flagship {n_params / 1e9:.3f}B f32 parameters, init "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.RandomState(0)
    ids_np = rng.randint(0, cfg.vocab_size, (batch, seq))
    ids = paddle.to_tensor(ids_np)
    labels = paddle.to_tensor(np.roll(ids_np, -1, axis=1))
    t = time.perf_counter()
    warm = float(_eager_step(model, opt, ids, labels))
    torch.cuda.synchronize()
    log(f"eager warm-up step: {time.perf_counter() - t:.2f} s, loss "
        f"{warm:.4f}")
    expect = {"rms_norm": 4 * cfg.num_hidden_layers + 1,
              "rms_norm_bwd": 2 * cfg.num_hidden_layers + 1,
              "flash_attention_fwd": 2 * cfg.num_hidden_layers,
              "flash_attention_bwd_dkv": cfg.num_hidden_layers,
              "flash_attention_bwd_dq": cfg.num_hidden_layers,
              "aligned16_copies": 0}
    losses, step_ms = [], []
    reset_launch_counts()
    for _ in range(steps):
        before = launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss = _eager_step(model, opt, ids, labels)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        losses.append(float(loss))
        per = {k: v - before[k] for k, v in launch_counts().items()}
        for name, n in expect.items():
            if per[name] != n:
                raise AssertionError(f"eager step launched {name} "
                                     f"{per[name]} times, not {n}")
        if per["varlen_attention_fwd"]:
            raise AssertionError("the eager step launched the varlen "
                                 "kernel")
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    if not all(np.isfinite([warm] + losses)):
        raise AssertionError(f"eager losses not finite: {warm}, {losses}")
    if not losses[-1] < warm:
        raise AssertionError(f"eager loss did not fall: {warm}, {losses}")
    ms = statistics.median(step_ms)
    tps = batch * seq / (ms / 1e3)
    fpt = model_flops_per_token(cfg, n_params, seq)
    metrics = {"batch": batch, "seq": seq, "steps": steps,
               "step_ms": step_ms, "step_ms_median": ms,
               "tokens_per_s": tps, "warmup_loss": warm, "losses": losses,
               "share_of_989_tflops": tps * fpt / BF16_OPS_PER_S,
               "peak_memory_gb": peak / 1e9,
               "peak_over_start_gb": (peak - start) / 1e9,
               "launches_per_step": per}

    # greedy generate: a 128-token prompt, 16 new tokens (f32, no AMP)
    prompt = paddle.to_tensor(np.random.RandomState(1).randint(
        0, cfg.vocab_size, (1, 128)))
    reset_launch_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    one = model.generate(prompt, max_new_tokens=1)
    torch.cuda.synchronize()
    t_one = time.perf_counter() - t
    gen_counts = launch_counts()
    t = time.perf_counter()
    out = model.generate(prompt, max_new_tokens=16)
    torch.cuda.synchronize()
    t_all = time.perf_counter() - t
    model.train()
    if out.shape != [1, 144] or not np.array_equal(
            out.numpy()[:, :129], one.numpy()):
        raise AssertionError(f"generate: {out.shape}, the first token "
                             f"differs from a one-token run")
    # the prefill's 16 layers at S = 128 launch the flash forward; the
    # decode step (Sq = 1) takes the dense fallback
    if gen_counts["flash_attention_fwd"] != cfg.num_hidden_layers:
        raise AssertionError(f"generate launched the flash forward "
                             f"{gen_counts['flash_attention_fwd']} times")
    metrics["generate"] = {
        "prompt": 128, "new_tokens": 16, "ms_all": t_all * 1e3,
        "ms_per_token": t_all * 1e3 / 16,
        "decode_ms_per_token": (t_all - t_one) * 1e3 / 15,
        "prefill_and_one_token_ms": t_one * 1e3,
        "launches_prefill_and_one_token": {
            k: gen_counts[k] for k in ("flash_attention_fwd", "rms_norm")}}
    log(json.dumps({"eager": metrics}))
    metrics["parity"] = _eager_parity(dev, base)
    return dict(metrics=metrics, counts=counts, model=model, opt=opt,
                ids=ids, labels=labels, prompt=prompt)


def _eager_parity(dev, base):
    """A 2-layer f32 eager model at the flagship widths, B=1, S=512, on
    the card (kernels) and on the CPU (plain versions), from the same
    weights: the loss within 1e-4 relative and every gradient within 1e-3
    of its leaf's largest magnitude; one AdamW step from the card's
    gradients on both devices, the parameters within 1e-6 of their
    largest magnitude (the same f32 update); then greedy generate (a
    128-token prompt, 8 tokens) equal token for token."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import launch_counts, reset_launch_counts
    from paddle_tpu_torch.models import llama as TL

    cfg = TL.LlamaConfig(**{**vars(base), "num_hidden_layers": 2,
                            "dtype": "float32"})
    rng = np.random.RandomState(3)
    ids_np = rng.randint(0, cfg.vocab_size, (1, min(512, TRAIN_SEQ)))
    labels_np = np.roll(ids_np, -1, axis=1)
    prompt_np = rng.randint(0, cfg.vocab_size, (1, 128))
    res = {}
    with one_cpu_thread():
        for where in ("gpu:0", "cpu"):
            paddle.set_device(where)
            paddle.seed(7)
            m = TL.LlamaForCausalLM(cfg)
            if where == "gpu:0":
                state = {k: v._value.detach().cpu().clone()
                         for k, v in m.state_dict().items()}
            else:
                m.set_state_dict(state)
            reset_launch_counts()
            loss = m(paddle.to_tensor(ids_np),
                     labels=paddle.to_tensor(labels_np))
            loss.backward()
            c = launch_counts()
            grads = {n: p.grad._value.detach().cpu().clone()
                     for n, p in m.named_parameters()}
            if where == "gpu:0":
                card_grads = grads
                if min(c[n] for n in TRAINING_KERNELS) <= 0:
                    raise AssertionError(f"eager parity run missed a "
                                         f"kernel: {c}")
            else:
                # the CPU's optimizer steps from the card's gradients
                for n, p in m.named_parameters():
                    p.grad = card_grads[n]
            opt = paddle.optimizer.AdamW(learning_rate=3e-4,
                                         parameters=m.parameters())
            opt.step()
            opt.clear_grad()
            params = {n: p._value.detach().cpu().clone()
                      for n, p in m.named_parameters()}
            tokens = m.generate(paddle.to_tensor(prompt_np),
                                max_new_tokens=8).numpy()
            res[where] = (float(loss), grads, params, tokens)
            del m, opt
    paddle.set_device("gpu:0")
    (lc, gc, pc, tc), (lp, gp, pp, tp) = res["gpu:0"], res["cpu"]
    rel = abs(lc - lp) / abs(lp)
    grad_ratio = {k: float((gc[k] - gp[k]).abs().max())
                  / (1e-3 * float(gp[k].abs().max())) for k in gp}
    param_ratio = {k: float((pc[k] - pp[k]).abs().max())
                   / (1e-6 * float(pp[k].abs().max())) for k in pp}
    worst_g = max(grad_ratio, key=grad_ratio.get)
    worst_p = max(param_ratio, key=param_ratio.get)
    same = bool(np.array_equal(tc, tp))
    ok = (rel <= 1e-4 and grad_ratio[worst_g] <= 1.0 and len(gp) == 21
          and param_ratio[worst_p] <= 1.0 and same)
    out = {"loss_card": lc, "loss_cpu": lp, "loss_rel": rel,
           "worst_gradient_ratio": grad_ratio[worst_g],
           "worst_gradient_leaf": worst_g,
           "worst_adamw_param_ratio": param_ratio[worst_p],
           "worst_adamw_param_leaf": worst_p,
           "generate_tokens_equal": same, "tokens_card": tc.tolist()}
    log(f"eager parity f32 2-layer full width B=1 S={ids_np.shape[1]}: "
        f"loss card {lc:.6f} cpu {lp:.6f} (rel {rel:.2e}, tol 1e-4); "
        f"gradients within 1e-3 of each leaf's largest magnitude: worst "
        f"ratio {grad_ratio[worst_g]:.3e} ({worst_g}); one AdamW step "
        f"within 1e-6: worst ratio {param_ratio[worst_p]:.3e} ({worst_p}); "
        f"greedy tokens equal: {same} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the eager model on the card disagrees with "
                             "the CPU")
    return out


# the registry ops' packed mix: tokens in all
REGISTRY_TOKENS = 8192
# the pretraining rows: bench.py::bench_bert's (batch 32, seq 512, 8 timed
# steps) and GPT-2 small at its context (batch 8, seq 1024)
PRETRAIN = {"bert": dict(batch=32, seq=512, steps=8),
            "gpt2": dict(batch=8, seq=1024, steps=8)}


def _pretrain_model(kind, **overrides):
    """(config, model): BertForPretraining(BertConfig()) (bert-base) or
    GPTForCausalLM(GPT_PRESETS["gpt2"]), the config's fields overridden."""
    from paddle_tpu_torch.models import bert as TB
    from paddle_tpu_torch.models import gpt as TG

    if kind == "bert":
        cfg = TB.BertConfig(**overrides)
        return cfg, TB.BertForPretraining(cfg)
    cfg = TG.GPTConfig(**{**vars(TG.GPT_PRESETS["gpt2"]), **overrides})
    return cfg, TG.GPTForCausalLM(cfg)


def _pretrain_step(kind, cfg, model, opt):
    """TrainStep(model, MLMLoss(), opt) as bench.py::bench_bert writes it
    (the MLM logits' cross-entropy, nn.CrossEntropyLoss), or
    TrainStep(model, None, opt) for GPT (the model's own loss)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.jit import TrainStep

    if kind != "bert":
        return TrainStep(model, None, opt)

    class MLMLoss(paddle.nn.Layer):
        def __init__(self):
            super().__init__()
            self.ce = paddle.nn.CrossEntropyLoss()

        def forward(self, outs, labels):
            mlm_logits = outs[0] if isinstance(outs, (tuple, list)) \
                else outs
            return self.ce(mlm_logits.reshape([-1, cfg.vocab_size]),
                           labels.reshape([-1]))
    return TrainStep(model, MLMLoss(), opt)


def _pretrain_batch(kind, cfg, batch, seq, seed):
    """ids and labels from numpy seed ``seed``: random labels for BERT's
    MLM (bench_bert's), next-token labels for GPT."""
    import paddle_tpu_torch as paddle

    rng = np.random.RandomState(seed)
    ids = rng.randint(0, cfg.vocab_size, (batch, seq))
    labels = rng.randint(0, cfg.vocab_size, (batch, seq)) \
        if kind == "bert" else np.roll(ids, -1, axis=1)
    return paddle.to_tensor(ids), paddle.to_tensor(labels)


@contextlib.contextmanager
def _attention_routes():
    """While open: each flash forward launch's (dropout_p, D, dtype,
    causal, bias given) in "fwd", and the calls of the dense attention
    (_attention_ref, _forward_fallback) in "dense"."""
    from paddle_tpu_torch.ops.kernels import flash_attention as FA

    seen = {"fwd": [], "dense": 0}
    real = {n: getattr(FA, n) for n in ("_launch_fwd", "_attention_ref",
                                        "_forward_fallback")}

    def launch(q, k, v, kmask, seed, causal, dropout_p):
        seen["fwd"].append((dropout_p, q.shape[-1], q.dtype, bool(causal),
                            kmask is not None))
        return real["_launch_fwd"](q, k, v, kmask, seed, causal, dropout_p)

    def dense(name):
        def fn(*a, **kw):
            seen["dense"] += 1
            return real[name](*a, **kw)
        return fn
    FA._launch_fwd = launch
    FA._attention_ref = dense("_attention_ref")
    FA._forward_fallback = dense("_forward_fallback")
    try:
        yield seen
    finally:
        for n, fn in real.items():
            setattr(FA, n, fn)


def _padded_mask(dev, batch, seq, seed):
    """A [B, 1, 1, S] bool key-padding mask (True attends): each sequence's
    tail padded by 0 to S/2 tokens."""
    import paddle_tpu_torch as paddle

    pads = np.random.RandomState(seed).randint(0, seq // 2 + 1, batch)
    keep = np.arange(seq)[None, :] < (seq - pads)[:, None]
    return paddle.to_tensor(keep[:, None, None, :])


def phase_pretrain(dev, kind):
    """BERT-base or GPT-2 small pretraining at full width as a Paddle user
    writes it: the model from a seed, amp.decorate(..., "O2", "bfloat16")
    (LayerNorm kept f32), AdamW at lr 1e-4, jit.TrainStep; a warm-up, then
    PRETRAIN[kind]["steps"] timed steps, each held to L flash forward, L
    dK/dV and L dQ launches, every forward at D = 64 in bf16 with dropout
    0.1, no dense attention and no 16-byte copy; the losses finite. BERT:
    then one BertModel forward with a [B, 1, 1, S] key-padding mask (eval),
    L forward launches with the bias. Then the 2-layer f32 card-vs-CPU
    parity (_pretrain_parity)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import launch_counts, reset_launch_counts

    sizes = PRETRAIN[kind]
    batch, seq, steps = sizes["batch"], sizes["seq"], sizes["steps"]
    paddle.set_device("gpu:0")
    torch.cuda.synchronize()
    start = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    paddle.seed(0)
    cfg, model = _pretrain_model(kind)
    model = paddle.amp.decorate(model, level="O2", dtype="bfloat16")
    dtypes = {("LayerNorm" if type(l).__name__ == "LayerNorm" else "other",
               p.dtype) for l in model.sublayers(include_self=True)
              for p in l._parameters.values() if p is not None}
    if dtypes != {("LayerNorm", torch.float32), ("other", torch.bfloat16)}:
        raise AssertionError(f"{kind}: O2 parameter dtypes {dtypes}")
    opt = paddle.optimizer.AdamW(learning_rate=1e-4,
                                 parameters=model.parameters())
    step = _pretrain_step(kind, cfg, model, opt)
    ids, labels = _pretrain_batch(kind, cfg, batch, seq, seed=0)
    n_params = sum(p.size for p in model.parameters())
    t = time.perf_counter()
    warm = float(step(ids, labels))
    torch.cuda.synchronize()
    log(f"{kind}: {n_params / 1e6:.1f}M parameters (O2 bf16), warm-up step "
        f"{time.perf_counter() - t:.2f} s, loss {warm:.4f}")
    L = cfg.num_hidden_layers
    expect = {"flash_attention_fwd": L, "flash_attention_bwd_dkv": L,
              "flash_attention_bwd_dq": L, "aligned16_copies": 0,
              "rms_norm": 0, "varlen_attention_fwd": 0}
    want_fwd = [(ATTN_DROPOUT, 64, torch.bfloat16, kind == "gpt2",
                 False)] * L
    losses, step_ms = [], []
    reset_launch_counts()
    with _attention_routes() as routes:
        for _ in range(steps):
            before = launch_counts()
            routes["fwd"].clear()
            torch.cuda.synchronize()
            t = time.perf_counter()
            loss = step(ids, labels)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t) * 1e3)
            losses.append(float(loss))
            per = {k: v - before[k] for k, v in launch_counts().items()}
            for name, n in expect.items():
                if per[name] != n:
                    raise AssertionError(f"{kind} step launched {name} "
                                         f"{per[name]} times, not {n}")
            if routes["fwd"] != want_fwd or routes["dense"]:
                raise AssertionError(f"{kind} step: flash forwards "
                                     f"{routes['fwd']}, dense attention "
                                     f"{routes['dense']} times")
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    if not all(np.isfinite([warm] + losses)):
        raise AssertionError(f"{kind} losses not finite: {warm}, {losses}")
    ms = statistics.median(step_ms)
    tps = batch * seq / (ms / 1e3)
    fpt = model_flops_per_token(cfg, n_params, seq)
    metrics = {"batch": batch, "seq": seq, "steps": steps,
               "n_params": n_params, "step_ms": step_ms,
               "step_ms_median": ms, "step_ms_min": min(step_ms),
               "step_ms_max": max(step_ms), "tokens_per_s": tps,
               "model_flops_per_step": fpt * batch * seq,
               "share_of_989_tflops": tps * fpt / BF16_OPS_PER_S,
               "warmup_loss": warm, "losses": losses,
               "peak_memory_gb": peak / 1e9,
               "peak_over_start_gb": (peak - start) / 1e9,
               "launches_per_step": per}
    if kind == "bert":
        mask = _padded_mask(dev, batch, seq, seed=1)
        model.eval()
        reset_launch_counts()
        with _attention_routes() as routes, paddle.no_grad():
            out, pooled = model.bert(ids, attention_mask=mask)
            torch.cuda.synchronize()
        model.train()
        c = launch_counts()
        if c["flash_attention_fwd"] != L or routes["dense"] or \
                {r[4] for r in routes["fwd"]} != {True} or \
                not bool(torch.isfinite(out._value.float()).all()):
            raise AssertionError(f"BertModel with a key-padding mask: "
                                 f"{c['flash_attention_fwd']} forwards, "
                                 f"{routes}")
        metrics["masked_forward_launches"] = c["flash_attention_fwd"]
    log(json.dumps({kind: metrics}))
    metrics["parity"] = _pretrain_parity(dev, kind)
    return dict(metrics=metrics, counts=counts, step=step, ids=ids,
                labels=labels)


def _pretrain_parity(dev, kind):
    """The model with 2 layers at full width, f32, dropout 0, from one seed
    on the card (the f32 flash kernels) and on the CPU (plain versions):
    one TrainStep each (B=2, S=512 for BERT; B=1, S=1024 for GPT-2), the
    gradients read at the optimizer's step, where the CPU's are replaced by
    the card's. Held as the eager phase holds its parity: the loss within
    1e-4 relative; every gradient within 1e-3 of its leaf's largest
    magnitude, plus 1e-6 of the largest gradient (the k projections' biases
    have a gradient of zero: round-off on both sides); after the update,
    the parameters within 1e-6 of their largest magnitude (the same f32
    AdamW from the same gradients). BERT also runs BertModel with a
    [B, 1, 1, S] key-padding mask (the f32 forward kernel with the bias):
    the sequence and pooled outputs within 1e-4 of their largest
    magnitude."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import launch_counts, reset_launch_counts

    b, S = (2, 512) if kind == "bert" else (1, 1024)
    res = {}
    with one_cpu_thread():
        for where in ("gpu:0", "cpu"):
            paddle.set_device(where)
            paddle.seed(7)
            cfg, model = _pretrain_model(kind, num_hidden_layers=2,
                                         dropout=0.0)
            if where == "gpu:0":
                state = {k: v._value.detach().cpu().clone()
                         for k, v in model.state_dict().items()}
            else:
                model.set_state_dict(state)
            opt = paddle.optimizer.AdamW(learning_rate=1e-4,
                                         parameters=model.parameters())
            grads = {}
            real_step = opt.step

            def step_with_card_grads():
                for n, p in model.named_parameters():
                    if p.grad is not None:
                        grads[n] = p.grad._value.detach().cpu().clone()
                        if where == "cpu":
                            p.grad = res["gpu:0"]["grads"][n]
                real_step()
            opt.step = step_with_card_grads
            step = _pretrain_step(kind, cfg, model, opt)
            ids, labels = _pretrain_batch(kind, cfg, b, S, seed=3)
            reset_launch_counts()
            loss = float(step(ids, labels))
            c = launch_counts()
            if where == "gpu:0" and min(c[n] for n in PRETRAIN_KERNELS) <= 0:
                raise AssertionError(f"{kind} parity run missed a kernel: "
                                     f"{c}")
            out = {"loss": loss, "grads": grads,
                   "params": {n: p._value.detach().cpu().clone()
                              for n, p in model.named_parameters()}}
            if kind == "bert":
                model.eval()
                with paddle.no_grad():
                    seq_out, pooled = model.bert(
                        ids, attention_mask=_padded_mask(dev, b, S, seed=4))
                out["masked"] = (seq_out._value.cpu(), pooled._value.cpu())
            res[where] = out
            del model, opt, step
    paddle.set_device("gpu:0")
    card, cpu = res["gpu:0"], res["cpu"]
    rel = abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"])
    top = max(float(g.abs().max()) for g in cpu["grads"].values())
    grad_ratio = {k: float((card["grads"][k] - g).abs().max())
                  / (1e-3 * float(g.abs().max()) + 1e-6 * top)
                  for k, g in cpu["grads"].items()}
    # a leaf of zeros (the biases the MLM loss leaves at 0) must be equal
    param_ratio = {k: float((card["params"][k] - v).abs().max())
                   / max(1e-6 * float(v.abs().max()), 1e-30)
                   for k, v in cpu["params"].items()}
    worst_g = max(grad_ratio, key=grad_ratio.get)
    worst_p = max(param_ratio, key=param_ratio.get)
    ok = (rel <= 1e-4 and set(card["grads"]) == set(cpu["grads"])
          and grad_ratio[worst_g] <= 1.0 and param_ratio[worst_p] <= 1.0)
    out = {"loss_card": card["loss"], "loss_cpu": cpu["loss"],
           "loss_rel": rel, "worst_gradient_ratio": grad_ratio[worst_g],
           "worst_gradient_leaf": worst_g,
           "worst_adamw_param_ratio": param_ratio[worst_p],
           "worst_adamw_param_leaf": worst_p}
    msg = ""
    if kind == "bert":
        mask_ratio = max(float((a - r).abs().max())
                         / (1e-4 * float(r.abs().max()))
                         for a, r in zip(card["masked"], cpu["masked"]))
        out["masked_forward_ratio"] = mask_ratio
        ok = ok and mask_ratio <= 1.0
        msg = (f"; BertModel with a key-padding mask within 1e-4: worst "
               f"ratio {mask_ratio:.3e}")
    log(f"{kind} parity f32 2-layer full width B={b} S={S}: loss card "
        f"{card['loss']:.6f} cpu {cpu['loss']:.6f} (rel {rel:.2e}, tol "
        f"1e-4); gradients within 1e-3 of each leaf's largest magnitude: "
        f"worst ratio {grad_ratio[worst_g]:.3e} ({worst_g}); one TrainStep "
        f"AdamW update within 1e-6: worst ratio {param_ratio[worst_p]:.3e} "
        f"({worst_p}){msg} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{kind} on the card disagrees with the CPU")
    return out


def phase_registry_ops(dev):
    """The registry's attention ops on the card (ops/yaml_extra.py):
    flash_attn_unpadded (the default scale) and flash_attn_varlen_qkvpacked
    over a packed mix (REGISTRY_TOKENS in documents of log-uniform lengths,
    12 heads of 64, bf16, causal), forward and backward: each equal to
    incubate.nn.functional.flash_attn_unpadded bit for bit, each call
    launching the varlen forward, dK/dV and dQ kernels once; flash_attn at
    [2, 1024, 12, 64] bf16 causal launching the flash forward, dK/dV and
    dQ once, equal to F.scaled_dot_product_attention bit for bit."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import launch_counts, reset_launch_counts
    from paddle_tpu_torch.incubate.nn import functional as IF
    from paddle_tpu_torch.ops import registry

    gen = torch.Generator(device=dev).manual_seed(15)
    total, H, D = REGISTRY_TOKENS, 12, 64
    lens = _packed_lens(total, PACKED_SEED + 15)
    cu = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    q, k, v, do = (torch.randn(total, H, D, device=dev, generator=gen)
                   .to(torch.bfloat16) for _ in range(4))
    op = {n: registry.get(n).fn for n in ("flash_attn", "flash_attn_unpadded",
                                          "flash_attn_varlen_qkvpacked")}
    routes = {
        "incubate": lambda a, b, c: IF.flash_attn_unpadded(
            a, b, c, cu, cu, causal=True)[0],
        "flash_attn_unpadded": lambda a, b, c: op["flash_attn_unpadded"](
            a, b, c, cu, cu, scale=None, causal=True)[0],
        "flash_attn_varlen_qkvpacked": lambda a, b, c: op[
            "flash_attn_varlen_qkvpacked"](torch.stack([a, b, c], dim=1),
                                           cu, cu, causal=True)[0]}
    got = {}
    for name, fn in routes.items():
        leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
        reset_launch_counts()
        out = fn(*leaves)
        grads = torch.autograd.grad(out, leaves, do)
        torch.cuda.synchronize()
        c = launch_counts()
        n = (c["varlen_attention_fwd"], c["varlen_attention_bwd_dkv"],
             c["varlen_attention_bwd_dq"])
        if n != (1, 1, 1):
            raise AssertionError(f"{name}: varlen launches {n}, not 1/1/1")
        got[name] = (out.detach(),) + grads
    same = {n: all(torch.equal(a, b) for a, b in zip(g, got["incubate"]))
            for n, g in got.items()}
    q4, k4, v4, do4 = (torch.randn(2, 1024, H, D, device=dev, generator=gen)
                       .to(torch.bfloat16) for _ in range(4))
    res = []
    for route in ("flash_attn", "sdpa"):
        leaves = [t.clone().requires_grad_(True) for t in (q4, k4, v4)]
        reset_launch_counts()
        if route == "flash_attn":
            out = op["flash_attn"](*leaves, causal=True)[0]
        else:
            out = paddle.nn.functional.scaled_dot_product_attention(
                *(paddle.Tensor._wrap(t) for t in leaves),
                is_causal=True)._value
        grads = torch.autograd.grad(out, leaves, do4)
        torch.cuda.synchronize()
        c = launch_counts()
        res.append(((out.detach(),) + grads,
                    tuple(c[n] for n in PRETRAIN_KERNELS)))
    flash_same = all(torch.equal(a, b) for a, b in zip(res[0][0], res[1][0]))
    ok = all(same.values()) and flash_same and res[0][1] == (1, 1, 1)
    log(f"registry ops: flash_attn_unpadded and flash_attn_varlen_qkvpacked "
        f"over {total} packed tokens in {len(lens)} documents (12 heads of "
        f"64, bf16, causal), forward and backward, bit for bit the incubate "
        f"function's: {same}, varlen launches 1/1/1 each; flash_attn at "
        f"[2, 1024, 12, 64] launches {res[0][1]} (fwd, dK/dV, dQ), bit for "
        f"bit F.scaled_dot_product_attention: {flash_same} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the registry's attention ops disagree")
    return {"varlen_equal": same, "flash_attn_equal": flash_same,
            "flash_attn_launches": res[0][1], "documents": len(lens)}


# ---------------------------------------------------------------------------
# phase 6f: MoE (moe_block_stacked) at Mixtral-8x7B's sparse-layer widths
# ---------------------------------------------------------------------------

# Mixtral-8x7B's sparse layer (Mistral AI's published config.json: hidden
# 4096, intermediate 14336, 8 local experts, 2 experts a token) with the
# reference's own expert (GELU between w1 and w2, no bias) and capacity
# factor 1.5, in f32 as the reference computes it
MOE_D, MOE_F, MOE_E, MOE_K, MOE_CF = 4096, 14336, 8, 2, 1.5
MOE_TOKENS = TRAIN_BATCH * TRAIN_SEQ       # 16,384 a step: C = 6144
MOE_CHECK_TOKENS = 512                     # the card-vs-CPU check
MOE_SEED = 4321
MOE_LR = 1.0                               # tests/test_moe_ep.py's SGD
# the card against the CPU (TF32 off): the output within 1e-4 and every
# gradient within 1e-3 of the CPU's largest magnitude, the aux loss within
# 1e-5 relative, the slots equal (the training parity phase's 1e-3 for
# the gradients: f32 sums over 4096 and 14336 terms in other orders)
MOE_OUT_TOL, MOE_GRAD_TOL, MOE_AUX_RTOL = 1e-4, 1e-3, 1e-5


def _moe_params(dev, gen):
    """{wg [D, E], w1 [E, D, F], w2 [E, F, D]} in f32, normal draws scaled
    by 1/sqrt(fan-in), from ``gen`` on ``dev``."""
    d, f, e = MOE_D, MOE_F, MOE_E

    def draw(*shape):
        return torch.randn(shape, generator=gen, device=dev) \
            * shape[-2] ** -0.5
    return {"wg": draw(d, e), "w1": draw(e, d, f), "w2": draw(e, f, d)}


def _moe_expert_flops(e, capacity):
    """The expert products of a forward and backward step: two GEMMs of
    2·C·D·F a expert forward, twice that backward."""
    return 12 * e * capacity * MOE_D * MOE_F


def _is_gemm(name):
    return any(s in name for s in ("gemm", "cutlass", "xmma", "nvjet",
                                   "sm90_", "sm80_"))


def _moe_loss(TM, p, x, y, total_rows, n=1, group=None):
    """The loss of tests/test_moe_ep.py, mean((out - y)^2) + 0.01·aux on
    the global batch, as this rank's share (its rows' squared errors over
    the global S·D, the aux term over the n ranks of the group), and the
    output and aux."""
    out, aux = TM.moe_block_stacked(p, x, MOE_K, MOE_CF, group=group)
    loss = ((out - y) ** 2).sum() / (total_rows * x.shape[1]) \
        + 0.01 * aux / n
    return loss, out, aux


def _moe_small_layers(dev):
    """MoELayer (d 64, 4 experts, exact GELU) and FusedEcMoe (64 -> 128,
    4 experts, tanh GELU) on the card against the same layers on the CPU:
    the outputs, the aux loss and every gradient within 1e-5 of the CPU's
    largest magnitude (plus 1e-6)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.incubate.distributed.models import moe as TM
    from paddle_tpu_torch.incubate.nn import FusedEcMoe

    rng = np.random.RandomState(7)
    x = rng.randn(2, 32, 64).astype(np.float32)
    gate = rng.randn(2, 32, 4).astype(np.float32)
    worst = {}
    for name in ("MoELayer", "FusedEcMoe"):
        res = {}
        for place in ("cpu", "gpu:0"):
            paddle.set_device(place)
            paddle.seed(8)
            layer = TM.MoELayer(64, num_experts=4, capacity_factor=1.0) \
                if name == "MoELayer" else FusedEcMoe(64, 128, 4)
            if place != "cpu":
                layer.set_state_dict(res["cpu"]["state"])
            xt = paddle.to_tensor(x, stop_gradient=False)
            if name == "MoELayer":
                out = layer(xt)
                total = out.sum() + layer.aux_loss
            else:
                out = layer(xt, paddle.to_tensor(gate))
                total = out.sum()
            total.backward()
            res[place] = {
                "state": {k: v.numpy() for k, v in
                          layer.state_dict().items()},
                "out": out.numpy(), "x_grad": xt.grad.numpy(),
                "aux": None if name != "MoELayer"
                else float(layer.aux_loss.numpy()),
                "grads": {k: p.grad.numpy() for k, p in
                          layer.named_parameters()}}
        cpu, gpu = res["cpu"], res["gpu:0"]
        pairs = [("out", gpu["out"], cpu["out"]),
                 ("x_grad", gpu["x_grad"], cpu["x_grad"])] + [
            (k, gpu["grads"][k], v) for k, v in cpu["grads"].items()]
        ratios = {k: float(np.abs(a - b).max())
                  / (1e-5 * float(np.abs(b).max()) + 1e-6)
                  for k, a, b in pairs}
        if cpu["aux"] is not None:
            ratios["aux"] = abs(gpu["aux"] - cpu["aux"]) / (
                1e-5 * abs(cpu["aux"]) + 1e-6)
        worst[name] = max(ratios.items(), key=lambda kv: kv[1])
        if worst[name][1] > 1.0:
            raise AssertionError(f"moe: {name} on the card disagrees with "
                                 f"the CPU: {ratios}")
    paddle.set_device("gpu:0")
    return worst


def phase_moe(dev):
    """moe_block_stacked at Mixtral-8x7B's sparse-layer widths, f32: one
    warm-up and 3 timed forward + backward steps at MOE_TOKENS tokens (ms a
    step, tokens/s, peak memory, the step's bound from the expert
    products at the f32 peak), the kept pairs against the buffer's E·C
    rows, one profiled step (the expert GEMMs' share of the device time
    against gating, dispatch and combine); then the same widths at
    MOE_CHECK_TOKENS tokens on the card against the CPU (the slots equal;
    the output, the aux loss and every gradient within their
    tolerances), and MoELayer and FusedEcMoe at a small width against the
    CPU. The MoE path reaches no hand-written kernel: this phase prints its
    own line and adds no entry to the kernels line."""
    from paddle_tpu_torch.incubate.distributed.models import moe as TM

    gen = torch.Generator(device=dev).manual_seed(MOE_SEED)
    params = _moe_params(dev, gen)
    x = torch.randn(MOE_TOKENS, MOE_D, generator=gen, device=dev)
    y = torch.randn(MOE_TOKENS, MOE_D, generator=gen, device=dev)
    leaves = {k: v.requires_grad_(True) for k, v in params.items()}

    def step():
        for t in leaves.values():
            t.grad = None
        loss, _, _ = _moe_loss(TM, leaves, x, y, MOE_TOKENS)
        loss.backward()
        return loss.detach()

    torch.cuda.synchronize()
    start = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    losses = [float(step())]
    step_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        losses.append(float(step()))
        step_ms.append((time.perf_counter() - t) * 1e3)
    peak = torch.cuda.max_memory_allocated(dev)
    if not all(np.isfinite(losses)):
        raise AssertionError(f"moe: losses not finite: {losses}")
    with torch.no_grad():
        slot, _, capacity, _ = TM.topk_sort_dispatch(
            x @ leaves["wg"], MOE_CF, MOE_K)
        kept = int((slot >= 0).sum())
    prof = profile_kernels(step)
    total_us = sum(us for _, us in prof.values())
    gemm_us = sum(us for k, (_, us) in prof.items() if _is_gemm(k))
    top = sorted(((k[:60], n, us / 1e3) for k, (n, us) in prof.items()),
                 key=lambda r: -r[2])[:10]
    flops = _moe_expert_flops(MOE_E, capacity)
    med = statistics.median(step_ms)
    out = {"tokens": MOE_TOKENS, "capacity": capacity, "step_ms": step_ms,
           "step_ms_median": med,
           "tokens_per_s": MOE_TOKENS / (med / 1e3),
           "peak_memory_gb": peak / 1e9,
           "peak_over_start_gb": (peak - start) / 1e9, "losses": losses,
           "kept_pairs": kept, "pairs": MOE_TOKENS * MOE_K,
           "buffer_rows": MOE_E * capacity,
           "padding_share_of_buffer": 1 - kept / (MOE_E * capacity),
           "expert_tflop_a_step": flops / 1e12,
           "bound_ms_f32": flops / F32_OPS_PER_S * 1e3,
           "device_ms_profiled": total_us / 1e3,
           "gemm_share_of_device_time": gemm_us / max(total_us, 1e-9),
           "gemm_device_ms": gemm_us / 1e3,
           "other_device_ms": (total_us - gemm_us) / 1e3, "top": top}
    del leaves, params, x, y, slot
    torch.cuda.empty_cache()
    out["check"] = _moe_check(dev)
    out["small_layers_worst_over_tol"] = _moe_small_layers(dev)
    log(json.dumps({"moe": out}))
    return out


def _moe_check(dev):
    """moe_block_stacked at the full widths on MOE_CHECK_TOKENS tokens,
    forward and backward on the card and on the CPU from the same
    numbers (the CPU under one_cpu_thread): the slots equal, the output,
    aux and gradients within MOE_OUT_TOL / MOE_AUX_RTOL / MOE_GRAD_TOL."""
    from paddle_tpu_torch.incubate.distributed.models import moe as TM

    gen = torch.Generator(device=dev).manual_seed(MOE_SEED + 1)
    params = _moe_params(dev, gen)
    x = torch.randn(MOE_CHECK_TOKENS, MOE_D, generator=gen, device=dev)
    y = torch.randn(MOE_CHECK_TOKENS, MOE_D, generator=gen, device=dev)
    res = {}
    for name, place in (("card", dev), ("cpu", torch.device("cpu"))):
        p = {k: v.detach().to(place).requires_grad_(True)
             for k, v in params.items()}
        xs = x.detach().to(place).requires_grad_(True)
        ctx = one_cpu_thread() if name == "cpu" else \
            contextlib.nullcontext()
        with ctx:
            loss, o, aux = _moe_loss(TM, p, xs, y.to(place),
                                     MOE_CHECK_TOKENS)
            loss.backward()
            with torch.no_grad():
                slot = TM.topk_sort_dispatch(xs @ p["wg"], MOE_CF,
                                             MOE_K)[0]
        res[name] = {"out": o.detach().cpu(), "aux": float(aux.detach()),
                      "slot": slot.cpu(), "x": xs.grad.cpu(),
                      **{k: t.grad.cpu() for k, t in p.items()}}
        del p, xs
    gpu, cpu = res["card"], res["cpu"]
    if not torch.equal(gpu["slot"], cpu["slot"]):
        raise AssertionError("moe: the card's slots differ from the CPU's")
    ratios = {"out": float((gpu["out"] - cpu["out"]).abs().max())
              / (MOE_OUT_TOL * float(cpu["out"].abs().max())),
              "aux": abs(gpu["aux"] - cpu["aux"])
              / (MOE_AUX_RTOL * abs(cpu["aux"]))}
    for k in ("x", "wg", "w1", "w2"):
        ratios[k] = float((gpu[k] - cpu[k]).abs().max()) \
            / (MOE_GRAD_TOL * float(cpu[k].abs().max()))
    log(f"moe check ({MOE_CHECK_TOKENS} tokens, card vs CPU): worst over "
        f"tolerance {ratios}; kept pairs "
        f"{int((cpu['slot'] >= 0).sum())}")
    if max(ratios.values()) > 1.0:
        raise AssertionError(f"moe: the card disagrees with the CPU: "
                             f"{ratios}")
    del params, x, y
    torch.cuda.empty_cache()
    return {"tokens": MOE_CHECK_TOKENS, "slots_equal": True,
            "worst_over_tol": ratios}


def _packed_qkv(x, w, heads):
    """q, k, v [T, heads, D] from a hidden state x [T, hidden] through
    bias-free projections w[n] [hidden, hidden]."""
    return [(x @ w[n]).view(x.shape[0], heads, -1) for n in "qkv"]


def phase_packed_training(dev):
    """flash_attn_unpadded trained at the flagship's attention width (16
    heads of 128, bf16) over PACKED_TOKENS packed tokens: q, k, v projected
    from a seeded hidden state, causal, loss sum(out * a fixed random
    cotangent), backward to the projections; 1 warm-up and 3 timed steps,
    each held to one launch of each varlen kernel and none of the flash
    kernels. Then a total of 16,300 tokens (padded to 16,384) and one step
    through flash_attn_varlen_qkvpacked."""
    from paddle_tpu_torch import launch_counts, reset_launch_counts
    from paddle_tpu_torch.incubate.nn import functional as IF
    from paddle_tpu_torch.ops.kernels import varlen_attention as VA

    cfg = _flagship_config()
    H = cfg.num_attention_heads
    hidden = cfg.hidden_size
    D = hidden // H
    T, steps = PACKED_TOKENS, 3
    lens = _packed_lens(T, PACKED_SEED)
    cu = np.concatenate([[0], np.cumsum(lens)])
    gen = torch.Generator(device=dev).manual_seed(11)
    bf16 = torch.bfloat16
    x = torch.randn(T, hidden, device=dev, generator=gen).to(bf16)
    w = {n: (torch.randn(hidden, hidden, device=dev, generator=gen)
             * hidden ** -0.5).to(bf16).requires_grad_(True) for n in "qkv"}
    cot = torch.randn(T, H, D, device=dev, generator=gen).to(bf16)
    log(f"packed training: H={H}, D={D}, bf16, {T} tokens in {len(lens)} "
        f"documents (lengths {lens})")

    def step():
        for t in w.values():
            t.grad = None
        q, k, v = _packed_qkv(x, w, H)
        out, _ = IF.flash_attn_unpadded(q, k, v, cu, cu, causal=True)
        loss = (out.float() * cot.float()).sum()
        loss.backward()
        return loss.detach()

    torch.cuda.reset_peak_memory_stats(dev)
    start_bytes = torch.cuda.memory_allocated(dev)
    t = time.perf_counter()
    warm = float(step())
    torch.cuda.synchronize()
    log(f"packed training warm-up step: {time.perf_counter() - t:.2f} s, "
        f"loss {warm:.4f}")
    # every other counter, aligned16_copies too, must stay at 0
    expect = {n: 1 for n in PACKED_KERNELS}
    losses, step_ms, per_step = [], [], []
    reset_launch_counts()
    for _ in range(steps):
        before = launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss = step()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        losses.append(float(loss))
        per = {k: v - before[k] for k, v in launch_counts().items()}
        per_step.append(per)
        for name, n in per.items():
            if n != expect.get(name, 0):
                raise AssertionError(f"packed training step launched "
                                     f"{name} {n} times, not "
                                     f"{expect.get(name, 0)}")
    counts = launch_counts()
    grads_ok = all(bool(torch.isfinite(t.grad.float()).all())
                   and float(t.grad.float().abs().max()) > 0
                   for t in w.values())
    if not (all(np.isfinite(losses)) and grads_ok):
        raise AssertionError(f"packed training: losses {losses}, finite "
                             f"non-zero weight gradients {grads_ok}")
    ms = statistics.median(step_ms)
    metrics = {
        "tokens": T, "heads": H, "head_dim": D, "documents": len(lens),
        "steps": steps, "step_ms": step_ms, "step_ms_median": ms,
        "tokens_per_s": T / (ms / 1e3), "losses": losses,
        "warmup_loss": warm,
        # the phase's own peak: the earlier phases' models stay allocated
        # for the profile phase
        "peak_memory_over_start_gb": (torch.cuda.max_memory_allocated(dev)
                                      - start_bytes) / 1e9,
        # as counted in the last step (each step was held to `expect`)
        "launches_per_step": per_step[-1],
    }
    log(json.dumps({"packed_training": metrics}))

    # 16,300 tokens pad to 16,384: the packed entry on the padded tensors
    # gives the padding rows exactly zero dQ, dK, dV under a cotangent that
    # is not zero there, and flash_attn_unpadded equals it on the live rows
    n = T - 84
    cu_n = np.concatenate([[0], np.cumsum(_packed_lens(n, PACKED_SEED))])
    with torch.no_grad():
        qkv = [t.detach() for t in _packed_qkv(x[:n], w, H)]
    live = [t.clone().requires_grad_(True) for t in qkv]
    n0 = launch_counts()
    out, _ = IF.flash_attn_unpadded(*live, cu_n, cu_n, causal=True)
    out.backward(cot[:n])
    per = {k: v - n0[k] for k, v in launch_counts().items()}
    seg = _packed_segments(np.diff(cu_n), T, dev)
    padded = [torch.cat([t, torch.zeros(T - n, H, D, device=dev,
                                        dtype=bf16)]).transpose(0, 1)[None]
              .contiguous().requires_grad_(True) for t in qkv]
    o = VA.varlen_flash_attention(*padded, seg, seg, is_causal=True)
    o.backward(cot.transpose(0, 1)[None])
    torch.cuda.synchronize()
    zero = all(bool((t.grad[:, :, n:] == 0).all()) for t in padded)
    same = torch.equal(out, o[0].transpose(0, 1)[:n]) and all(
        torch.equal(a.grad, b.grad[0].transpose(0, 1)[:n])
        for a, b in zip(live, padded))
    ok = zero and same and all(per[k] == 1 for k in PACKED_KERNELS)
    log(f"packed training, {n} tokens padded to {T}: padding rows' dQ, dK, "
        f"dV exactly 0: {zero}; flash_attn_unpadded equals the packed "
        f"entry on the live rows, bit for bit: {same}; launches {per} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("packed training with padding failed")

    # flash_attn_varlen_qkvpacked on the same q, k, v: the same bits
    qkvp = torch.stack(qkv, dim=1).requires_grad_(True)
    n0 = launch_counts()
    outp, _ = IF.flash_attn_varlen_qkvpacked(qkvp, cu_n, cu_n, causal=True)
    outp.backward(cot[:n])
    torch.cuda.synchronize()
    per = {k: v - n0[k] for k, v in launch_counts().items()}
    same = torch.equal(outp, out) and all(
        torch.equal(qkvp.grad[:, i], live[i].grad) for i in range(3))
    ok = same and all(per[k] == 1 for k in PACKED_KERNELS)
    log(f"packed training through flash_attn_varlen_qkvpacked: output and "
        f"gradients equal flash_attn_unpadded's bit for bit: {same}; "
        f"launches {per} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("flash_attn_varlen_qkvpacked disagrees")
    return dict(metrics=metrics, counts=counts, step=step)


def phase_packed_parity(dev):
    """The packed path in f32 at full attention width (16 heads of 128,
    hidden 2048) over 1000 tokens in 4 documents (padded to 1024): the
    output and the projections' gradients on the card (kernels) against
    the same inputs on the CPU (plain versions), each element within
    1e-4 * (|ref| + its row's RMS) + 1e-6 (f32 sums in other orders)."""
    from paddle_tpu_torch import launch_counts, reset_launch_counts
    from paddle_tpu_torch.incubate.nn import functional as IF

    cfg = _flagship_config()
    H, hidden = cfg.num_attention_heads, cfg.hidden_size
    lens = [300, 128, 450, 122]
    cu = np.concatenate([[0], np.cumsum(lens)])
    T = int(cu[-1])
    g = torch.Generator().manual_seed(5)
    x = torch.randn(T, hidden, generator=g)
    w = {n: torch.randn(hidden, hidden, generator=g) * hidden ** -0.5
         for n in "qkv"}
    cot = torch.randn(T, H, hidden // H, generator=g)
    res = []
    with one_cpu_thread():
        for where in (dev, torch.device("cpu")):
            ww = {n: t.to(where).requires_grad_(True) for n, t in w.items()}
            reset_launch_counts()
            out, _ = IF.flash_attn_unpadded(
                *_packed_qkv(x.to(where), ww, H), torch.tensor(cu), cu,
                causal=True)
            out.backward(cot.to(where))
            if where.type == "cuda":
                torch.cuda.synchronize()
                c = launch_counts()
                if any(c[k] != 1 for k in PACKED_KERNELS):
                    raise AssertionError(f"packed parity run: launches "
                                         f"{c}")
            res.append([out.detach().cpu()]
                       + [ww[n].grad.cpu() for n in "qkv"])
    names = ["out", "dWq", "dWk", "dWv"]
    ratios = {n: _worst_of_tol(a, b, 1e-4, 1e-6)
              for n, a, b in zip(names, *res)}
    worst = max(ratios.values())
    ok = worst <= 1.0
    log(f"packed parity f32 H={H} hidden={hidden} T={T} ({len(lens)} "
        f"documents, padded to 1024), card vs CPU: worst error / tol "
        + ", ".join(f"{n} {r:.3e}" for n, r in ratios.items())
        + f" (tol 1e-4 * (|ref| + row RMS) + 1e-6) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("packed attention on the card disagrees with "
                             "the CPU")


def _paged_inputs(dev, cfg, rows, dtype, gen, n_pad=0):
    """The paged-attention kernel's inputs at the serving config's widths
    for rows [(tokens, start position)], each on its own pages, and n_pad
    padding tokens in the trash row (last, block-table row all page 0,
    positions from 0): q [T, HQ, D], the stacked caches [L, num_blocks,
    HKV, bs, D] (random) and the step's metadata (t2b, pos) from
    IF.paged_metadata."""
    from paddle_tpu_torch.incubate.nn import functional as IF

    mb, bs = cfg.max_blocks_per_seq, cfg.block_size
    B1 = len(rows) + 1
    enc = torch.zeros(B1, dtype=torch.int64)
    dec = torch.zeros(B1, dtype=torch.int64)
    this = torch.zeros(B1, dtype=torch.int64)
    bt = torch.zeros(B1, mb, dtype=torch.int64)
    for i, (n, start) in enumerate(rows):
        dec[i], this[i] = start, n
        bt[i] = torch.arange(1 + i * mb, 1 + (i + 1) * mb)
    this[-1] = enc[-1] = n_pad
    cu = torch.zeros(B1 + 1, dtype=torch.int64)
    cu[1:] = torch.cumsum(this, 0)
    T = int(cu[-1])
    shape = (cfg.num_layers, cfg.num_blocks, cfg.num_kv_heads, bs,
             cfg.head_dim)
    kc = torch.randn(shape, device=dev, generator=gen).to(dtype)
    vc = torch.randn(shape, device=dev, generator=gen).to(dtype)
    q = torch.randn(T, cfg.num_heads, cfg.head_dim, device=dev,
                    generator=gen).to(dtype)
    rope = torch.zeros(2, B1, 1, mb * bs, cfg.head_dim // 2, device=dev)
    md = IF.paged_metadata(T, enc.to(dev), dec.to(dev), cu.to(dev),
                           bt.to(dev), bs, rope)
    return q, kc, vc, md.t2b, md.pos, bt.to(dev)


# the paged-attention kernel's timed shapes besides decode (whose positions
# the serving phase gives): (rows [(tokens, start position)], trash-row
# padding tokens). A chunked-prefill step (chunks appended at several
# depths, 256 tokens), and a speculative verify step (8 rows of 1 + k = 5
# tokens at positions 96-184, padded to 64 tokens as _spec_step pads to a
# power of two)
PAGED_SHAPES = {
    "chunked": ([(120, 64), (100, 90), (1, 170), (35, 0)], 0),
    "verify": ([(5, 96 + 12 * i) for i in range(8)], 24),
}


def _paged_bound(q, kc, t2b, pos, bt):
    """(bound ms, bound_by) of one paged-attention call: the K and V
    positions its tokens read, each once (a row's tokens share its keys:
    per row, the most any of its tokens reads; for int8 pages a byte an
    element plus the slot's f32 scale), plus q, out and the metadata, over
    the memory rate; against 4 D operations a (token, query head, key) at
    the card's peak for the operands' type, q's (int8 pages are
    dequantized to it): the bf16 tensor-core rate for bf16 (the least time
    the card could take, though the kernel runs on the CUDA cores), the
    f32 CUDA-core rate for f32."""
    T, HQ, D = q.shape
    HKV, esz = kc.shape[2], kc.element_size()
    max_seq = bt.shape[1] * kc.shape[3]
    keys = torch.clamp(pos + 1, max=max_seq)
    per_row = torch.zeros(bt.shape[0], dtype=torch.int64, device=q.device)
    per_row.scatter_reduce_(0, t2b, keys, "amax")
    scale_bytes = 4 if kc.dtype == torch.int8 else 0
    kv_bytes = 2 * int(per_row.sum()) * HKV * (D * esz + scale_bytes)
    nb = kv_bytes + 2 * nbytes(q) + nbytes(t2b, pos, bt)
    rate = BF16_OPS_PER_S if q.dtype == torch.bfloat16 else F32_OPS_PER_S
    return bound(nb, 4 * D * HQ * int(keys.sum()), rate)


def phase_paged_kernel(dev, results, probes, serving):
    """The paged-attention kernel (decode and chunked-prefill steps)
    against its plain version in bf16 and f32 at the serving config's
    widths: the flagship decode shape (8 rows, one token each, at the
    positions the serving phase's first decode window started from), a
    256-token chunked step and a speculative verify step (PAGED_SHAPES);
    then timed beside its plain version and one
    F.scaled_dot_product_attention call on the already-gathered dense view
    (kd[t2b], vd[t2b]; the gather is not timed) with a bool mask and GQA
    (enable_gqa). The timed calls cycle over the 16 layers' pools (134 MB
    of K and V in all, beyond the 50 MB L2), so each call finds its pages
    cold, as in a decode step."""
    from paddle_tpu_torch.ops.kernels import paged_attention as PA

    cfg = serving["cfg"]
    gen = torch.Generator(device=dev).manual_seed(17)
    L = cfg.num_layers
    shapes = {
        "decode": ([(1, p) for p in serving["run"]["decode_positions"]], 0),
        **PAGED_SHAPES,
    }
    errs = {}
    rows = {}
    for label, (spec, n_pad) in shapes.items():
        for dtype, tol in ((torch.bfloat16, (2.0 ** -6, 1e-5)),
                           (torch.float32, (1e-4, 1e-6))):
            q, kc, vc, t2b, pos, bt = _paged_inputs(dev, cfg, spec, dtype,
                                                    gen, n_pad)
            worst = 0.0
            for layer in (0, L - 1):
                got = PA.paged_attention(q, kc, vc, layer, t2b, pos, bt)
                ref = PA._paged_attention_ref(q, kc[layer], vc[layer], t2b,
                                              pos, bt)
                torch.cuda.synchronize()
                ratio = _worst_of_tol(got, ref, *tol)
                ok = ratio <= 1.0 and bool(torch.isfinite(got.float()).all())
                worst = max(worst, ratio)
                errs[(label, dtype)] = max(errs.get((label, dtype), 0.0),
                                           _max_err(got, ref))
                if not ok:
                    raise AssertionError(
                        f"paged_attention {label} {dtype} layer {layer}: "
                        f"{ratio:.3f} x its tolerance")
            log(f"paged_attention {label} T={q.shape[0]} {dtype}: max_abs_err "
                f"{errs[(label, dtype)]:.3e}, worst error / tol {worst:.3f} "
                f"(tol {tol[0]:.3g} * (|ref| + row RMS) + {tol[1]:g}; RMS "
                f"of out {_rms(ref):.3e}) ok")
            if dtype == torch.bfloat16:          # the serving path's dtype
                rows[label] = (q, kc, vc, t2b, pos, bt)

    sdpa = torch.nn.functional.scaled_dot_product_attention
    timed, calls = {}, {}
    for label, (q, kc, vc, t2b, pos, bt) in rows.items():
        T, HQ, D = q.shape
        turn = [0]

        def call(q=q, kc=kc, vc=vc, t2b=t2b, pos=pos, bt=bt):
            turn[0] = (turn[0] + 1) % L
            return PA.paged_attention(q, kc, vc, turn[0], t2b, pos, bt)

        def plain(q=q, kc=kc, vc=vc, t2b=t2b, pos=pos, bt=bt):
            turn[0] = (turn[0] + 1) % L
            return PA._paged_attention_ref(q, kc[turn[0]], vc[turn[0]], t2b,
                                           pos, bt)

        # the library call's inputs: each token's row gathered densely
        max_seq = bt.shape[1] * cfg.block_size
        kd = kc[0][bt].permute(0, 2, 1, 3, 4).reshape(
            bt.shape[0], cfg.num_kv_heads, max_seq, D)[t2b]
        vd = vc[0][bt].permute(0, 2, 1, 3, 4).reshape(
            bt.shape[0], cfg.num_kv_heads, max_seq, D)[t2b]
        mask = (torch.arange(max_seq, device=dev)[None, :]
                <= pos[:, None])[:, None, None, :]
        qd = q[:, :, None, :]

        def library():
            return sdpa(qd, kd, vd, attn_mask=mask, enable_gqa=True)

        calls[label] = call
        lib_err = _max_err(library()[:, :, 0], PA._paged_attention_ref(
            q, kc[0], vc[0], t2b, pos, bt))
        b, by = _paged_bound(q, kc, t2b, pos, bt)
        timed[label] = dict(
            shape=f"q [{T}, {HQ}, {D}] {q.dtype}, pools [{cfg.num_blocks}, "
                  f"{cfg.num_kv_heads}, {cfg.block_size}, {D}] a layer, "
                  f"positions {sorted(set(pos.tolist()))[:8]}...",
            ms=time_ms(call), plain_ms=time_ms(plain, calls=20, windows=5),
            bound_ms=b, bound_by=by,
            library_ms=time_ms(library),
            library_note="SDPA on the gathered dense view [T, HKV, "
                         f"{max_seq}, D] with a bool mask (gather not "
                         f"timed); its max_abs_err against the plain "
                         f"version {lib_err:.3e}")
        log(f"paged_attention {label}: {timed[label]}")
    row = dict(name="paged_attention", route="cuda",
               source="paddle_tpu_torch/ops/kernels/csrc/paged_attention.cu",
               replaces="paddle_tpu/incubate/nn/functional/__init__.py:733 "
                        "(no Pallas kernel; XLA-fused jnp in the reference)",
               max_abs_err=max(v for (_, dt), v in errs.items()
                               if dt == torch.bfloat16),
               max_abs_err_f32=max(v for (_, dt), v in errs.items()
                                   if dt == torch.float32),
               **timed["decode"], at_chunked_shape=timed["chunked"],
               at_verify_shape=timed["verify"])
    results["paged_attention"] = row
    for label, target in (("decode", row),
                          ("chunked", row["at_chunked_shape"]),
                          ("verify", row["at_verify_shape"])):
        probes[f"paged_attention {label}"] = (
            calls[label], "paged_attention_tc_kernel", 48, target)


def _prompts(rng, lens, vocab):
    return [list(rng.randint(1, vocab, n)) for n in lens]


def _graph_count(eng):
    return sum(w.graph is not None for w in eng._window_fns.values())


def _serving_drive(eng, first, later, sampling, max_new, measure):
    """8 requests on ``eng``: the ``first`` two prompts alone (one fresh
    prefill step of 256 tokens, timed and its launches counted), then the
    ``later`` six joining, steps until every request is at its decode tip,
    then decode_run(32) windows to the end. With ``measure``, the counts
    are set to 0 just before the first decode window that does not capture
    and read just after it (``window``: steps, tokens, counts); the counts
    made before that reset are kept in ``carried``."""
    from paddle_tpu_torch import launch_counts, reset_launch_counts

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
    positions = [r.cached for r in eng.pending()]
    windows = []                     # (s, steps, tokens, captured)
    # the launches counted before the decode window's reset
    carried, window = Counter(), None
    while eng.pending():
        graphs = _graph_count(eng)
        if measure and window is None:
            carried.update(launch_counts())
            reset_launch_counts()
        t = time.perf_counter()
        got = eng.decode_run(32)
        dt = time.perf_counter() - t
        if not got:
            raise AssertionError("decode_run made no progress")
        steps = max(Counter(r for r, _ in got).values())
        captured = _graph_count(eng) > graphs
        if measure and window is None and not captured:
            window = (steps, len(got), launch_counts())
        windows.append((dt, steps, len(got), captured))
    outs = {rid: list(eng._requests[rid].generated) for rid in rids}
    return dict(rids=rids, outs=outs, t_fresh=t_fresh, t_fill=t_fill,
                fill_steps=n_steps, windows=windows, per_step=per_step,
                first_logits=first_logits, decode_positions=positions,
                carried=carried, window=window)


def _window_rate(windows):
    """(ms a step, tokens/s, steps) over decode windows (s, steps, tokens,
    captured)."""
    t = sum(w[0] for w in windows)
    steps = sum(w[1] for w in windows)
    return t / steps * 1e3, sum(w[2] for w in windows) / t, steps


def phase_serving(dev):
    """llama_1b at full width serves 8 requests, twice on one engine: the
    first drive captures the decode windows' CUDA graphs (its decode is
    the all-in figure), the second is measured (decode over windows whose
    graphs exist already); in it the counts are set to 0 just before its
    first replayed decode window and read just after, which must launch
    RMSNorm 2L + 1, paged_attention L and rope_append L times a step. Then the graphs
    against the eager runner of the same body in turns on 8 more requests,
    token for token. Returns metrics, the kernels' launch counts of the
    measured run, the engine and prompts."""
    from paddle_tpu_torch import launch_counts, reset_launch_counts
    from paddle_tpu_torch.inference import (PagedCausalLM,
                                            PagedServingConfig,
                                            SamplingParams, ServingEngine)

    cfg = PagedServingConfig.llama_1b()
    torch.cuda.reset_peak_memory_stats(dev)   # not the kernel phases' peak
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
    eng = ServingEngine.from_model(model, cfg, seed=7, device=dev)

    def drive(measure):
        return _serving_drive(eng, first, later, sampling, max_new, measure)

    warm = drive(False)           # captures the graphs (and warms the rest)
    graphs = {f"{k[0]} rows, {k[1]}": w.capture_ms
              for k, w in eng._window_fns.items() if w.graph is not None}
    log(f"decode window graphs captured: {len(graphs)}, capture ms "
        f"{graphs}")
    if not graphs or len(graphs) != len(eng._window_fns):
        raise AssertionError("decode_run did not capture a CUDA graph for "
                             "each of its windows")
    reset_launch_counts()
    run = drive(True)
    counts = {k: n + run["carried"][k] for k, n in launch_counts().items()}
    log(f"serving launch counts: {counts}; first (fresh-prefill) step: "
        f"{run['per_step']}")
    if run["window"] is None:
        raise AssertionError("every measured decode window captured")
    steps, rows, made = run["window"]
    L = cfg.num_layers
    want = {k: 0 for k in made}
    want.update(rms_norm=(2 * L + 1) * steps, paged_attention=L * steps,
                rope_append=L * steps)
    if made != want:
        raise AssertionError(f"a replayed decode window of {steps} steps "
                             f"launched {made}, not {want}")
    decode_step = {k: n // steps for k, n in made.items()}
    log(f"measured decode window of {steps} steps over {rows // steps} "
        f"rows, counts set to 0 just before it: rms_norm "
        f"{made['rms_norm']}, paged_attention {made['paged_attention']}, "
        f"rope_append {made['rope_append']} ({decode_step['rms_norm']}, "
        f"{decode_step['paged_attention']} and {decode_step['rope_append']}"
        f" a step, counted under replay)")
    for name in SERVING_KERNELS:
        if counts[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"serving path")
    if counts["rms_norm_bwd"]:
        raise AssertionError("the serving run launched the rms_norm "
                             "gradient kernel")
    if counts["aligned16_copies"]:
        raise AssertionError(f"the serving run copied "
                             f"{counts['aligned16_copies']} inputs to a "
                             f"16-byte boundary")
    V = cfg.vocab_size
    for rid in run["rids"]:
        toks = run["outs"][rid]
        if len(toks) != max_new or not all(0 <= t < V for t in toks):
            raise AssertionError(f"request {rid}: bad output {toks[:8]}")

    steady = [w for w in run["windows"] if not w[3]]
    ms, tps, steps = _window_rate(steady)
    ms_all, tps_all, steps_all = _window_rate(warm["windows"])
    turns = _graph_against_eager(dev, eng, model, cfg, sampling)
    prompt_tokens = sum(map(len, first + later))
    metrics = {
        "requests": len(run["rids"]),
        "fresh_prefill_tokens_per_s": 256 / run["t_fresh"],
        "fresh_prefill_step_ms": run["t_fresh"] * 1e3,
        "prefill_tokens_per_s": prompt_tokens
        / (run["t_fresh"] + run["t_fill"]),
        "mixed_steps_to_decode_tip": run["fill_steps"],
        "decode_window_graphs": len(graphs),
        "decode_capture_ms": graphs,
        "decode_steps": steps,
        "decode_ms_per_step": ms,
        "decode_tokens_per_s": tps,
        "decode_mean_batch": sum(w[2] for w in steady) / steps,
        "decode_windows_that_captured": len(run["windows"]) - len(steady),
        "decode_ms_per_step_all_in": ms_all,
        "decode_tokens_per_s_all_in": tps_all,
        "decode_steps_all_in": steps_all,
        "decode_launches_per_step": decode_step,
        **turns,
        "peak_memory_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
    }
    log(json.dumps({"serving": metrics}))
    return dict(metrics=metrics, counts=counts, run=run, model=model,
                cfg=cfg, first=first, prompts=first + later,
                sampling=sampling)


def _graph_against_eager(dev, eng, model, cfg, sampling):
    """8 more requests (24-token prompts, 40 tokens each after the
    first) on the serving engine, whose graphs exist, and the same requests
    on a fresh engine run by the eager runner of the same window body
    (``_decode_run_eager``); 8-step windows taken in turns, graph then
    eager. Each window's tokens must be equal, bit for bit. Returns the
    ms/step medians of each."""
    from paddle_tpu_torch.inference import ServingEngine

    eager = ServingEngine.from_model(model, cfg, seed=7, device=dev)
    eager._next_rid = eng._next_rid          # the same request ids (salts)
    prompts = _prompts(np.random.RandomState(3), [24] * 8, cfg.vocab_size)
    for e in (eng, eager):
        for i, p in enumerate(prompts):
            e.add_request(p, max_new_tokens=41, sampling=sampling[i])
        e.step()                          # 192 tokens: one fresh prefill
    per = {"graph": [], "eager": []}
    while eng.pending():
        graphs = _graph_count(eng)
        torch.cuda.synchronize()
        t = time.perf_counter()
        got = eng.decode_run(8)
        dt = time.perf_counter() - t
        steps = max(Counter(r for r, _ in got).values())
        if _graph_count(eng) != graphs:
            raise AssertionError("the turns' graph window captured anew")
        per["graph"].append(dt / steps * 1e3)
        t = time.perf_counter()
        ref = eager._decode_run_eager(8)
        per["eager"].append((time.perf_counter() - t) / steps * 1e3)
        if got != ref:
            raise AssertionError("a decode window's tokens differ between "
                                 "its CUDA graph and the eager runner")
    if eager.pending():
        raise AssertionError("the eager runner's engine did not finish")
    log(f"parity: {len(per['graph'])} bf16 llama_1b decode windows (8 "
        f"rows) equal the eager runner's tokens bit for bit; ms/step in "
        f"turns: graph {per['graph']}, eager {per['eager']}")
    return {"decode_turns_graph_ms_per_step": statistics.median(per["graph"]),
            "decode_turns_eager_ms_per_step": statistics.median(per["eager"]),
            "decode_turns_windows": len(per["graph"])}


def _artifact_bytes(path):
    return sum(os.path.getsize(path + ext)
               for ext in (".pdmodel", ".pdiparams.npz", ".pdconfig"))


def _fixed_step_inputs(dev, cfg, prompts):
    """A 256-token step of two fresh 128-token rows (pages 1-4 and 5-8) as
    the engine stages it, and two zeroed pool pairs."""
    B1 = cfg.max_batch + 1
    pages = -(-len(prompts[0]) // cfg.block_size)
    enc = torch.zeros(B1, dtype=torch.int64)
    dec = torch.zeros(B1, dtype=torch.int64)
    this = torch.zeros(B1, dtype=torch.int64)
    bt = torch.zeros(B1, cfg.max_blocks_per_seq, dtype=torch.int64)
    for i, p in enumerate(prompts):
        this[i] = len(p)
        bt[i, :pages] = torch.arange(1 + i * pages, 1 + (i + 1) * pages)
    this[-1] = enc[-1] = cfg.token_budget - int(this.sum())
    cu = torch.zeros(B1 + 1, dtype=torch.int64)
    cu[1:] = torch.cumsum(this, 0)
    tokens = torch.tensor(sum(prompts, []) + [0] * int(this[-1]),
                          dtype=torch.int64)
    ins = [t.to(dev) for t in (tokens, enc, dec, this, cu, bt)]
    shape = (cfg.num_layers, cfg.num_blocks, cfg.num_kv_heads,
             cfg.block_size, cfg.head_dim)
    pools = [torch.zeros(shape, dtype=cfg.torch_dtype, device=dev)
             for _ in range(4)]
    return ins, pools


def _artifact_turns(dev, art, live, cfg, sampling):
    """8 more requests (24-token prompts, 41 tokens each) on the artifact
    engine and on the from_model engine, 8-step decode windows taken in
    turns, artifact then live; the windows that capture a graph are left
    out. Returns the ms/step of each (medians), and how many tokens the two
    engines' streams share."""
    prompts = _prompts(np.random.RandomState(3), [24] * 8, cfg.vocab_size)
    for e in (art, live):
        for i, p in enumerate(prompts):
            e.add_request(p, max_new_tokens=41, sampling=sampling[i])
        e.step()                          # 192 tokens
    per = {"artifact": [], "from_model": []}
    while art.pending() or live.pending():
        for name, e in (("artifact", art), ("from_model", live)):
            if not e.pending():
                continue
            graphs = _graph_count(e)
            torch.cuda.synchronize()
            t = time.perf_counter()
            got = e.decode_run(8)
            dt = time.perf_counter() - t
            if not got:
                raise AssertionError(f"{name}: decode_run made no progress")
            if _graph_count(e) == graphs:
                steps = max(Counter(r for r, _ in got).values())
                per[name].append(dt / steps * 1e3)
    if not per["artifact"] or not per["from_model"]:
        raise AssertionError("no decode window over an existing graph")
    return {k: statistics.median(v) for k, v in per.items()}


def phase_artifact(dev, serving):
    """The deploy artifact (save_paged_model, ServingEngine(path_prefix,
    cfg)) on the serving phase's llama_1b model, bf16, 16 layers:
    (a) save to a directory under build/ and load (the program moved to the
    card by move_to_device_pass, the weights placed once), timed, with the
    artifact's bytes on disk; (b) one fixed 256-token step through the
    loaded program and through the live serving copy's forward on the same
    inputs: the largest logit difference, relative L2 within 5e-2; (c) the
    serving phase's 8 requests through the artifact engine twice (the first
    captures its windows' graphs); in the second the counts are set to 0
    just before and read just after: RMSNorm, rope_append and paged
    attention must launch and the varlen forward must not; its first
    (eager) step and a replayed decode window must count RMSNorm 2L + 1,
    rope_append L, paged attention L and varlen 0 a step; (d) decode ms/step
    over windows whose graphs exist, in turns with the from_model engine's
    windows (the artifact's windows run the fixed 256 tokens a step, as the
    reference's do: reported, not judged); (e) a 2-layer f32 artifact
    engine's greedy streams (TF32 off) equal the from_model engine's, token
    for token; (f) a request with deadline_s=0 evicted at the next step and
    one past its deadline after a step, pages back, requeue_hook told; (g)
    create_predictor on a small MLP artifact saved on the CPU, served on
    the card, against the CPU's eager output. Returns metrics, the counts,
    the engine and the per-step launches."""
    from paddle_tpu_torch import launch_counts, reset_launch_counts
    from paddle_tpu_torch.inference import (Config, PagedCausalLM,
                                            PagedServingConfig,
                                            ServingEngine, create_predictor,
                                            save_inference_model,
                                            save_paged_model)
    from paddle_tpu_torch.jit import InputSpec
    from paddle_tpu_torch.nn.modules import TorchLinear as Linear

    model, cfg = serving["model"], serving["cfg"]
    first, prompts, sampling = (serving["first"], serving["prompts"],
                                serving["sampling"])
    gpu = card()
    L = cfg.num_layers
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="artifact-", dir=os.path.join(HERE,
                                                                "build"))
    try:
        path = os.path.join(tmp, "llama_1b")
        torch.cuda.synchronize()
        t = time.perf_counter()
        save_paged_model(path, model)
        t_save = time.perf_counter() - t
        size = _artifact_bytes(path)
        t = time.perf_counter()
        eng = ServingEngine(path, cfg, seed=7, device=dev)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t
        log(f"artifact ({gpu}): save_paged_model {t_save:.2f} s, "
            f"{size / 1e9:.3f} GB on disk; ServingEngine(path, cfg) "
            f"{t_load:.2f} s")

        # (b) one fixed step: the loaded program against the live forward
        live = ServingEngine.from_model(model, cfg, seed=7, device=dev)
        ins, (ka, va, kl, vl) = _fixed_step_inputs(dev, cfg, first)
        with torch.inference_mode():
            got = eng._program(eng._params, eng._buffers, *ins, ka, va)[0]
            ref = live._model(*ins, kl, vl)[0]
        torch.cuda.synchronize()
        got, ref = got[:2], ref[:2].float()
        diff = float((got - ref).abs().max())
        rel = float((got - ref).norm() / ref.norm())
        pools_equal = bool(torch.equal(ka, kl) and torch.equal(va, vl))
        log(f"artifact: one fixed 256-token step, loaded program against "
            f"the live model's forward: largest logit difference {diff}, "
            f"relative L2 {rel:.3e} (tol 5e-2), pools equal: {pools_equal}")
        if not rel <= 5e-2 or got.dtype != torch.float32:
            raise AssertionError("artifact: the loaded program's logits "
                                 "are not the live model's")
        del ka, va, kl, vl

        # (c) the serving phase's requests, twice
        def drive(measure):
            return _serving_drive(eng, first, prompts[2:], sampling, 48,
                                  measure)

        drive(False)
        if not _graph_count(eng):
            raise AssertionError("artifact: decode_run captured no graph")
        reset_launch_counts()
        run = drive(True)
        counts = {k: n + run["carried"][k]
                  for k, n in launch_counts().items()}
        if run["window"] is None:
            raise AssertionError("artifact: every measured window captured")
        steps, rows, made = run["window"]
        want = {k: 0 for k in made}
        want.update(rms_norm=2 * L + 1, paged_attention=L, rope_append=L)
        step_want = dict(want)
        want = {k: n * steps for k, n in want.items()}
        if made != want:
            raise AssertionError(f"artifact: a replayed window of {steps} "
                                 f"steps launched {made}, not {want}")
        if run["per_step"] != step_want:
            raise AssertionError(f"artifact: its first (eager) step "
                                 f"launched {run['per_step']}, not "
                                 f"{step_want}")
        for name in ARTIFACT_KERNELS:
            if counts[name] <= 0:
                raise AssertionError(f"kernel {name} was not launched on "
                                     f"the artifact path")
        if counts["varlen_attention_fwd"] or counts["aligned16_copies"]:
            raise AssertionError(f"artifact: varlen launched or inputs "
                                 f"copied: {counts}")
        V = cfg.vocab_size
        same = total = 0
        for rid, ref_rid in zip(run["rids"], serving["run"]["rids"]):
            toks = run["outs"][rid]
            if len(toks) != 48 or not all(0 <= x < V for x in toks):
                raise AssertionError(f"artifact request {rid}: bad output "
                                     f"{toks[:8]}")
            ref_toks = serving["run"]["outs"][ref_rid]
            same += sum(a == b for a, b in zip(toks, ref_toks))
            total += len(toks)
        steady = [w for w in run["windows"] if not w[3]]
        ms, tps, n_steps = _window_rate(steady)
        log(f"artifact: first (eager) step launched {run['per_step']}; a "
            f"replayed window of {steps} steps {made}; decode {ms:.3f} "
            f"ms/step over {n_steps} steps; {same} of {total} tokens equal "
            f"the from_model engine's (bf16 streams depend on the step's "
            f"shape)")

        # (d) windows in turns with the from_model engine
        turns = _artifact_turns(dev, eng, live, cfg, sampling)
        log(f"artifact: decode in turns ({gpu}): artifact "
            f"{turns['artifact']:.3f}, from_model {turns['from_model']:.3f}"
            f" ms/step (the artifact's windows run {cfg.token_budget} tokens"
            f" a step, the from_model engine's 8)")

        # (f) deadlines
        seen = []
        eng.requeue_hook = seen.append
        free0 = len(eng._free_pages)
        gone = eng.add_request(prompts[2], max_new_tokens=8, deadline_s=0)
        late = eng.add_request(prompts[3], max_new_tokens=8, deadline_s=1.0)
        eng.step()
        held = len(eng._requests[late].pages)
        time.sleep(max(0.0, eng._requests[late].deadline_t
                       - time.perf_counter()) + 0.01)
        eng.step()
        eng.requeue_hook = None
        if eng.timed_out_requests() != [gone, late] \
                or [d["rid"] for d in seen] != [gone, late] \
                or held == 0 or len(eng._free_pages) != free0 \
                or eng.pending():
            raise AssertionError(
                f"artifact deadlines: timed out {eng.timed_out_requests()}, "
                f"hook {[d['rid'] for d in seen]}, pages held {held}, free "
                f"{len(eng._free_pages)} of {free0}")
        log(f"artifact: deadline_s=0 evicted at the next step, a 1 s "
            f"deadline after a step holding {held} pages; every page back, "
            f"requeue_hook told twice")

        # (e) f32 parity, TF32 off
        if torch.backends.cuda.matmul.allow_tf32:
            raise AssertionError("TF32 must be off for the f32 parity")
        cfg32 = PagedServingConfig.llama_1b(num_layers=2, dtype="float32")
        m32 = PagedCausalLM(cfg32, device=dev, seed=99)
        path32 = os.path.join(tmp, "f32")
        save_paged_model(path32, m32)
        outs = []
        for e in (ServingEngine(path32, cfg32, device=dev),
                  ServingEngine.from_model(m32, cfg32, device=dev)):
            rids = [e.add_request(p, max_new_tokens=16) for p in prompts]
            while any(r.length - r.cached > 1 for r in e.pending()):
                e.step()
            while e.pending():
                if not e.decode_run(8):
                    raise AssertionError("f32: decode_run made no progress")
            outs.append([list(e._requests[r].generated) for r in rids])
        if outs[0] != outs[1]:
            raise AssertionError("artifact f32 greedy streams differ from "
                                 "the from_model engine's")
        log(f"artifact: f32 2-layer full width, TF32 off: {len(prompts)} "
            f"greedy streams of 16 tokens equal the from_model engine's, "
            f"token for token")
        del m32

        # (g) a predictor on the card over an artifact saved on the CPU
        mlp = torch.nn.Sequential(Linear(8, 16, bias_attr=True,
                                         device="cpu"),
                                  torch.nn.ReLU(),
                                  Linear(16, 4, bias_attr=True, device="cpu"))
        with torch.no_grad():
            for p in mlp.parameters():
                p.copy_(torch.randn(p.shape,
                                    generator=torch.Generator()
                                    .manual_seed(p.numel())))
        mlp_path = os.path.join(tmp, "mlp")
        save_inference_model(mlp_path, mlp, [InputSpec([None, 8], "float32",
                                                       "x")],
                             output_names=["y"])
        pred = create_predictor(Config(mlp_path))
        worst = 0.0
        for bs in (3, 5):
            x = np.random.RandomState(bs).randn(bs, 8).astype(np.float32)
            (y,) = pred.run([x])
            if pred._outputs["y"].device.type != dev.type:
                raise AssertionError("the predictor did not run on the card")
            with torch.no_grad():
                want_y = mlp(torch.from_numpy(x)).numpy()
            worst = max(worst, float(np.abs(y - want_y).max()))
        if not worst <= 1e-5:
            raise AssertionError(f"predictor on the card vs eager on the "
                                 f"CPU: {worst}")
        log(f"artifact: create_predictor on an MLP artifact saved on the "
            f"CPU, run on the card (batches 3 and 5): largest difference "
            f"from the CPU's eager output {worst} (tol 1e-5)")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    metrics = {
        "card": gpu,
        "save_s": t_save, "load_s": t_load, "artifact_bytes": size,
        "fixed_step_max_abs_logit_diff": diff,
        "fixed_step_rel_l2": rel, "fixed_step_pools_equal": pools_equal,
        "decode_ms_per_step": ms, "decode_tokens_per_s": tps,
        "decode_steps": n_steps,
        "decode_turns_artifact_ms_per_step": turns["artifact"],
        "decode_turns_from_model_ms_per_step": turns["from_model"],
        "fresh_step_ms": run["t_fresh"] * 1e3,
        "tokens_equal_from_model": [same, total],
        "launches_per_step": {"eager_step": run["per_step"],
                              "decode_step": step_want},
        "predictor_max_abs_err": worst,
    }
    log(json.dumps({"artifact": metrics}))
    return dict(metrics=metrics, counts=counts, engine=eng,
                per_step={k: {"eager_step": run["per_step"][k],
                              "decode_step": step_want[k]}
                          for k in ARTIFACT_KERNELS})


def _profiled_window(eng, prompts, sampling, label, want, seen_of,
                     ready=False):
    """Profile one 16-step decode window at batch 8 on ``eng``: the 8
    ``prompts`` added (already, when ``ready``) and stepped to their decode
    tips, an unprofiled window (it captures the window's graph, so the
    profile sees replays only), then the profiled one. ``seen_of`` maps
    the profile to {kernel: launches on the device}, which must equal
    ``want``. The profiler loses records now and then (profile_kernels)
    and never makes them up, and a graph replays the same launches every
    time: so a window that reads short is profiled again, on 8 new
    requests once the last ones are done, up to PROFILE_ATTEMPTS windows
    in all, and one that reads more than ``want`` fails at once. Returns
    the profile, what it saw and the launch counts the window added."""
    from paddle_tpu_torch import launch_counts

    for attempt in range(PROFILE_ATTEMPTS):
        if attempt:
            eng.run_to_completion()
        if attempt or not ready:
            for i, p in enumerate(prompts):
                eng.add_request(p, max_new_tokens=40, sampling=sampling[i])
        while any(r.length - r.cached > 1 for r in eng.pending()):
            eng.step()
        if len(eng.pending()) != 8:
            raise AssertionError(f"profile: the {label} decode batch is not "
                                 f"8 rows")
        eng.decode_run(16)
        graphs = _graph_count(eng)
        before = launch_counts()
        got = []
        dec = profile_kernels(lambda: got.extend(eng.decode_run(16)))
        counted = {k: n - before[k] for k, n in launch_counts().items()}
        if _graph_count(eng) != graphs or len(eng.pending()) != 8 \
                or len(got) != 16 * 8:
            raise AssertionError(f"profile: the profiled {label} decode "
                                 f"window did not replay one graph 16 "
                                 f"times over 8 rows")
        seen = seen_of(dec)
        if seen == want:
            return dec, seen, counted
        if any(seen[k] > n for k, n in want.items()):
            break
        log(f"profile: {label} window {attempt + 1}: the profiler kept "
            f"{seen} of {want} launches; profiling another window")
    raise AssertionError(f"profile: 16 {label} decode replays launched "
                         f"{seen} on the device, not {want}")


# kernel classes of a training step's profile: the first class whose
# substring a kernel's name holds (elementwise last)
# ---------------------------------------------------------------------------
# phase 6e: hybrid parallelism over NCCL (spawned ranks, one a card)
# ---------------------------------------------------------------------------

HYBRID_SEED = 1234
HYBRID_LR = 3e-4
# spawn's limit a world: past it every rank is killed and the run fails
HYBRID_TIMEOUT_S = {1: 420, 2: 600, 4: 1500}
# the eager engines' job: their losses and parameters against the same
# layers stepped whole (2 AdamW steps under AMP O1 bf16): the losses within
# ENGINE_LOSS_RTOL relative; of each gathered parameter all but a share
# ENGINE_PARAM_SHARE of the elements within 1e-3 of the leaf's largest
# magnitude plus a tenth of the learning rate, and every element within
# ENGINE_PARAM_LR learning rates (where a gradient lies within its
# round-off of eps, AdamW's m / sqrt(v) may take either sign: up to about
# 2 lr a step apart)
ENGINE_LOSS_RTOL = 1e-4
ENGINE_PARAM_SHARE = 3e-2
ENGINE_PARAM_LR = 6.0
# the group-sharded jobs' AdamW moments: every element within this share
# of the leaf's largest magnitude (the moments are linear in the clipped
# gradients and their squares: no sign to flip near eps)
ENGINE_MOMENT_RTOL = 1e-3


def _hybrid_config(width, dtype, layers=None):
    """The flagship row's widths (bench.py:1965-1969) or Llama-2 7B's
    (LLAMA_PRESETS["llama2-7b"]), in ``dtype``, at ``layers`` (the preset's
    depth when None)."""
    from paddle_tpu_torch.models.llama import LLAMA_PRESETS, LlamaConfig

    base = _flagship_config() if width == "flagship" else \
        LLAMA_PRESETS["llama2-7b"]
    over = {"dtype": dtype, "recompute": True}
    if layers is not None:
        over["num_hidden_layers"] = layers
    return LlamaConfig(**{**vars(base), **over})


def _hybrid_plan(world):
    """The jobs of a world: a parity job holds the mesh trainer to
    HybridTrainer(mesh=None) run by rank 0 on its own card (3 steps, the
    losses and every parameter and moment); an engines job runs the eager
    pipeline engines (_pipeline_engines); a row times the full Llama-2 7B
    at mp 2 x sharding 2, at pp 2 x mp 2 with 8 micro-batches, and at
    sep 2 x mp 2 (4 sequences). Over 'sep' the parity jobs run the ring at
    sep 2 (world 2) and sep 4, sep 2 x mp 2, sep 2 x sharding 2 and pp 2 x
    sep 2 (world 4). ``pipeline`` marks the jobs whose launches the
    pipeline path counts."""
    engines = dict(kind="engines", width="flagship", layers=4, batch=8,
                   seq=512, n_micro=4, steps=2, path=False, pipeline=True)
    if world == 1:
        # one card: a 2-layer bf16 model at the flagship row's
        # width and batch, through the mesh path in an NCCL world of one;
        # the eager engines at pp 1 (one stage holds every layer: no sends)
        return [dict(kind="parity", name="flagship_2l_bf16_world1",
                     width="flagship", dtype="bfloat16", layers=2,
                     mesh={"dp": 1, "pp": 1, "sharding": 1, "sep": 1,
                           "mp": 1},
                     batch=TRAIN_BATCH, seq=TRAIN_SEQ, path=True),
                dict(engines, name="engines_flagship_pp1", mesh={"pp": 1}),
                # remat_policy="save_attn" through the mesh path, held to
                # "full" on the same mesh (the "save_attn_mesh" path)
                dict(kind="save_attn", name="flagship_2l_bf16_world1_save_attn",
                     width="flagship", dtype="bfloat16", layers=2,
                     mesh={"dp": 1, "pp": 1, "sharding": 1, "sep": 1,
                           "mp": 1},
                     batch=TRAIN_BATCH, seq=TRAIN_SEQ, path="save_attn_mesh"),
                # the eager Llama under group_sharded_parallel "p_g_os" in
                # an NCCL world of one, AMP O1 bf16, held to the plain
                # eager step (the "group_sharded" path)
                dict(kind="group_sharded",
                     name="eager_flagship_2l_p_g_os_world1",
                     width="flagship", dtype="bfloat16", layers=2,
                     level="p_g_os", amp=True, batch=TRAIN_BATCH,
                     seq=TRAIN_SEQ, path="group_sharded")]
    parity = dict(kind="parity", width="llama2-7b", dtype="float32",
                  layers=2, batch=2, seq=512, path=False)
    # the eager Llama at 7B's width under group_sharded_parallel (f32, 2
    # layers, 4 x 512: 2 or 1 rows a rank) against rank 0's plain step
    sharded = dict(kind="group_sharded", width="llama2-7b",
                   dtype="float32", layers=2, batch=4, seq=512, path=False)
    # moe_block_stacked over the world as an expert group at Mixtral's
    # widths, 2048 global tokens, against rank 0's group=None
    moe = dict(kind="moe", tokens=2048, steps=3, path=False)
    # the pipelined trainer at 7B's width: 4 layers, 8 x 512 in 4
    # micro-batches of 2 rows (each splits into halves under overlap_sends)
    pipe = dict(parity, layers=4, batch=8, n_micro=4, pipeline=True)
    if world == 2:
        return [dict(parity, name="7b_width_2l_f32_mp2", mesh={"mp": 2}),
                dict(parity, name="7b_width_2l_f32_sep2", mesh={"sep": 2}),
                dict(pipe, name="7b_width_4l_f32_pp2", mesh={"pp": 2}),
                dict(pipe, name="7b_width_4l_f32_pp2_overlap",
                     mesh={"pp": 2}, overlap=True),
                dict(engines, name="engines_flagship_pp2", mesh={"pp": 2}),
                dict(sharded, name="eager_7b_width_2l_f32_os_g_sh2",
                     level="os_g"),
                dict(sharded, name="eager_7b_width_2l_f32_p_g_os_sh2",
                     level="p_g_os"),
                dict(moe, name="moe_mixtral_ep2"),
                dict(parity, kind="save_attn",
                     name="7b_width_2l_f32_mp2_save_attn", mesh={"mp": 2})]
    # the sep 2 x mp 2 row first of the jobs that make hybrid groups: it
    # holds every leaf and its f32 moments at half the model a rank (~47
    # GB, ~60 GB with the update's temporaries); the group-sharded row
    # before it runs over the world's own communicator. Each job's groups
    # are destroyed after it (_drop_groups): their NCCL communicators took
    # ~49 GB a card after 14 jobs, and the 15th ran out of memory
    return [dict(kind="group_sharded_row", name="llama2_7b_eager_p_g_os_sh4",
                 width="llama2-7b", layers=None, level="p_g_os", seq=4096,
                 steps=10, path=False),
            dict(kind="row", name="llama2_7b_sep2_mp2", width="llama2-7b",
                 dtype="bfloat16", layers=None, mesh={"sep": 2, "mp": 2},
                 # 4 sequences of 4096 (16,384 tokens a step), each sep
                 # rank holding 2048 positions of each at 16 heads a rank
                 seq=4096, batch=4, steps=10, path=False),
            dict(parity, name="7b_width_2l_f32_mp2_sh2",
                 mesh={"mp": 2, "sharding": 2}),
            dict(pipe, name="7b_width_4l_f32_pp2_mp2",
                 mesh={"pp": 2, "mp": 2}),
            dict(pipe, name="7b_width_4l_f32_pp4", mesh={"pp": 4}),
            # the ring over 'sep': 256 or 128 positions a rank
            dict(parity, name="7b_width_2l_f32_sep4", mesh={"sep": 4}),
            dict(parity, name="7b_width_2l_f32_sep2_mp2",
                 mesh={"sep": 2, "mp": 2}),
            dict(parity, name="7b_width_2l_f32_sep2_sh2",
                 mesh={"sep": 2, "sharding": 2}),
            dict(pipe, name="7b_width_4l_f32_pp2_sep2",
                 mesh={"pp": 2, "sep": 2}),
            dict(engines, name="engines_flagship_pp2_mp2",
                 mesh={"pp": 2, "mp": 2}),
            dict(kind="row", name="llama2_7b_mp2_sh2", width="llama2-7b",
                 dtype="bfloat16", layers=None,
                 mesh={"mp": 2, "sharding": 2}, seq=4096, steps=10,
                 path=True),
            # 8 sequences in 8 micro-batches: 32,768 tokens a step, GPipe
            # bubble (P - 1) / (M + P - 1) = 1/9
            dict(kind="row", name="llama2_7b_pp2_mp2", width="llama2-7b",
                 dtype="bfloat16", layers=None, mesh={"pp": 2, "mp": 2},
                 seq=4096, batch=8, n_micro=8, steps=10, path=False,
                 pipeline=True),
            dict(sharded, name="eager_7b_width_2l_f32_p_g_os_sh4",
                 level="p_g_os"),
            dict(moe, name="moe_mixtral_ep4"),
            # 16,384 global tokens: 4,096 and 2 experts a card
            dict(kind="moe_row", name="moe_mixtral_ep4_row",
                 tokens=MOE_TOKENS, steps=10, path=False),
            dict(parity, kind="save_attn",
                 name="7b_width_2l_f32_sep2_mp2_save_attn",
                 mesh={"sep": 2, "mp": 2}),
            dict(pipe, kind="save_attn", pipeline=False,
                 name="7b_width_4l_f32_pp2_mp2_save_attn",
                 mesh={"pp": 2, "mp": 2})]


def _hybrid_batches(cfg, batch, seq, steps, dev, seed=5):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(steps):
        ids = rng.randint(0, cfg.vocab_size, (batch, seq))
        out.append((torch.tensor(ids, device=dev),
                    torch.tensor(np.roll(ids, -1, axis=1), device=dev)))
    return out


class _GcClock:
    """Milliseconds the Python garbage collector ran while it is entered."""

    def __enter__(self):
        import gc

        self.ms, self._t = 0.0, None

        def cb(phase, info):
            if phase == "start":
                self._t = time.perf_counter()
            elif self._t is not None:
                self.ms += (time.perf_counter() - self._t) * 1e3
        self._cb = cb
        gc.callbacks.append(cb)
        return self

    def __exit__(self, *exc):
        import gc

        gc.callbacks.remove(self._cb)


def _timed_steps(dist, trainer, batches, probe=False):
    """Each step between a device sync and a barrier: (losses, step ms,
    launches a step, the clip's norm a step, the host's side of each step:
    the ms until ``step`` returned (issue_ms; the device has not been
    waited for yet), the ms the garbage collector took, and the caching
    allocator's cudaMalloc calls and retries in the step; with ``probe``,
    also _host_probe's launch time just before the step, untimed)."""
    from paddle_tpu_torch import launch_counts

    dev = trainer.device
    losses, step_ms, per_step, norms, host = [], [], [], [], []
    for ids, labels in batches:
        launch_us = _host_probe(dev)["launch_us"] if probe else None
        before = launch_counts()
        mem0 = torch.cuda.memory_stats(dev)
        torch.cuda.synchronize()
        dist.barrier()
        with _GcClock() as gc_clock:
            t = time.perf_counter()
            loss = trainer.step(ids, labels)
            issue = time.perf_counter()
            torch.cuda.synchronize()
            dist.barrier()
            end = time.perf_counter()
        mem1 = torch.cuda.memory_stats(dev)
        step_ms.append((end - t) * 1e3)
        host.append({"issue_ms": (issue - t) * 1e3, "gc_ms": gc_clock.ms,
                     "cuda_mallocs": mem1.get("num_device_alloc", 0)
                     - mem0.get("num_device_alloc", 0),
                     "alloc_retries": mem1.get("num_alloc_retries", 0)
                     - mem0.get("num_alloc_retries", 0),
                     "launch_us_before": launch_us})
        losses.append(float(loss))
        norms.append(None if trainer.last_grad_norm is None
                     else float(trainer.last_grad_norm))
        per_step.append({k: v - before[k]
                         for k, v in launch_counts().items()})
    return losses, step_ms, per_step, norms, host


def _training_launches(cfg, layers=None, calls=1, last=True, hops=1):
    """A remat'd step's launches: each of ``layers`` layers (all when None)
    ``calls`` times (micro-batches, halves) with its recomputation, and
    the final norm once where ``last`` holds it; each layer's attention
    ``hops`` flash calls (a causal ring's sep rank r runs r + 1)."""
    L = (cfg.num_hidden_layers if layers is None else layers) * calls
    return {"rms_norm": 4 * L + last, "rms_norm_bwd": 2 * L + last,
            "flash_attention_fwd": 2 * L * hops,
            "flash_attention_bwd_dkv": L * hops,
            "flash_attention_bwd_dq": L * hops, "aligned16_copies": 0}


def _launches_of(trainer, rows):
    """HybridTrainer's launches a step on this rank: the stacked step's,
    or over 'pp' its stage's: its num_hidden_layers / pp layers for each
    micro-batch (in two halves under overlap_sends with an even
    micro-batch of 2 or more rows), the final norm on the last stage.
    Over 'sep', sep rank r's causal ring runs r + 1 hops a layer."""
    cfg = trainer.config
    hcg = trainer.hcg
    hops = 1 if hcg is None else hcg.get_sep_parallel_rank() + 1
    if not trainer.pipelined:
        return _training_launches(cfg, hops=hops)
    pp = hcg.get_pipe_parallel_world_size()
    mb = rows // trainer.n_micro // trainer._data_ranks
    halves = 2 if trainer.overlap_sends and mb % 2 == 0 and mb >= 2 else 1
    return _training_launches(cfg, cfg.num_hidden_layers // pp,
                              trainer.n_micro * halves,
                              hcg.get_stage_id() == pp - 1, hops)


def _check_launches(per_step, want, what):
    for per in per_step:
        for name, n in want.items():
            if per[name] != n:
                raise AssertionError(f"{what}: a step launched {name} "
                                     f"{per[name]} times, not {n}")


def _replicas_equal(trainer):
    """Whether the replicas of each leaf are bit for bit this rank's
    (collective): over 'pp', each leaf that every stage holds whole
    (embedding, final norm, head) on every rank of the pp group; over
    'sep', every parameter and moment on every rank of the sep group.
    Keys "pp:<leaf>", "sep:<p|m|v>:<leaf>"."""
    from paddle_tpu_torch.distributed.fleet.layers.mpu.mp_ops import \
        gather_along
    from paddle_tpu_torch.models import llama as TL

    def same(t, group):
        pieces = gather_along(t.detach()[None], group, 0)
        return all(torch.equal(piece, t) for piece in pieces)

    hcg, out = trainer.hcg, {}
    if trainer.pipelined:
        group = hcg.get_pipe_parallel_group()
        for name, t in TL.leaves(trainer.params).items():
            if "pp" not in trainer._specs[name]:
                out["pp:" + name] = same(t, group)
    if hcg.get_sep_parallel_world_size() > 1:
        group = hcg.get_sep_parallel_group()
        for prefix, tree in (("p", trainer.params),
                             ("m", trainer.opt_state["m"]),
                             ("v", trainer.opt_state["v"])):
            for name, t in TL.leaves(tree).items():
                out[f"sep:{prefix}:{name}"] = same(t, group)
    return out


def _held_leaf(prefix, got, want, ref_moments):
    """One gathered leaf of the mesh trainer against the one-card
    trainer's after 3 steps. The mesh path sums each gradient in another
    order (over the mp split of its products and the sharding split of
    the batch), which the moments carry: m and v within 1e-4 of the
    leaf's largest magnitude at all but 1e-6 of its elements and within
    1e-3 of it at every element (a near-cancelling sum turns the last
    bits into a larger share of a small result). A parameter within 1e-4
    of its largest magnitude plus a tenth of the learning rate at all but
    1e-5 of its elements, and within three AdamW steps (3 lr) at every
    element: where a gradient lies within its round-off of eps,
    m / (sqrt(v) + eps) is not fixed by the gradient (at 7B's width the
    reference's m and v at the worst element read ~1e-9 and ~1e-17)."""
    a = want.float()
    diff = (got.float() - a).abs()
    scale = 1e-4 * float(a.abs().max())
    if prefix == "p":
        tol, share, cap = scale + 0.1 * HYBRID_LR, 1e-5, \
            scale + 3 * HYBRID_LR
    else:
        tol, share, cap = scale, 1e-6, 10 * scale
    rec = {"ratio": float(diff.max()) / tol,
           "share_over_tol": float((diff > tol).float().mean())}
    rec["ok"] = rec["share_over_tol"] <= share and float(diff.max()) <= cap
    if prefix == "p":
        at = int(diff.argmax())
        rec["max_over_lr"] = float(diff.max()) / HYBRID_LR
        rec["ref_m_v_at_worst"] = [float(t.reshape(-1)[at])
                                   for t in ref_moments]
    return rec


def _hybrid_parity(job, dist, dev):
    """The mesh trainer's 3 steps, then (rank 0) HybridTrainer(mesh=None)'s
    on the same card from the same seed: bit for bit, or (where the mesh
    path sums in another order) the losses within the training parity
    phase's 1e-4 relative, the clip's global norm of each step within 1e-5
    relative, and every parameter and moment gathered leaf by leaf as
    _held_leaf holds them. The norm is the check that sees a gradient
    scaled wrongly as a whole (a wrong division by the data ranks, a sum
    taken twice): the clip (active at this init) and AdamW's m / sqrt(v)
    cancel such a factor out of the parameters and moments, and the loss
    is reduced on its own. Over 'pp' (``n_micro`` micro-batches,
    ``overlap``) each rank's launches are its stage's (_launches_of), and
    the leaves every stage holds whole must be bit for bit equal on every
    rank of the pp group after the steps; over 'sep' each sep rank's
    launches are its ring's hops, and every leaf must be bit for bit equal
    on every rank of the sep group (_replicas_equal). The ring merges its
    hops in another order than the one-card flash call, so over 'sep' the
    bits are not expected to equal HybridTrainer(mesh=None)'s."""
    from paddle_tpu_torch import launch_counts, reset_launch_counts
    from paddle_tpu_torch.distributed.fleet import HybridTrainer
    from paddle_tpu_torch.models import llama as TL

    cfg = _hybrid_config(job["width"], job["dtype"], job["layers"])
    batches = _hybrid_batches(cfg, job["batch"], job["seq"], 3, dev)
    tr = HybridTrainer(cfg, job["mesh"], learning_rate=HYBRID_LR,
                       seed=HYBRID_SEED, device=dev,
                       pipeline_micro_batches=job.get("n_micro"),
                       overlap_sends=job.get("overlap", False))
    torch.cuda.synchronize()
    reset_launch_counts()
    losses, step_ms, per_step, norms, _ = _timed_steps(dist, tr, batches)
    counts = launch_counts()
    _check_launches(per_step, _launches_of(tr, job["batch"]),
                    f"hybrid {job['name']}")
    replicas = _replicas_equal(tr)
    if not all(replicas.values()):
        raise AssertionError(f"hybrid {job['name']}: the replicas of "
                             f"{[k for k, v in replicas.items() if not v]} "
                             f"differ")
    rank = dist.get_rank()
    ref = None
    if rank == 0:
        ref = HybridTrainer(cfg, learning_rate=HYBRID_LR, seed=HYBRID_SEED,
                            device=dev)
        ref_losses, ref_ms, ref_norms = [], [], []
        for i, lab in batches:
            torch.cuda.synchronize()
            t = time.perf_counter()
            ref_losses.append(float(ref.step(i, lab)))
            ref_ms.append((time.perf_counter() - t) * 1e3)
            ref_norms.append(float(ref.last_grad_norm))
    bits, by_leaf = True, {}
    for prefix, tree in (("p", tr.params), ("m", tr.opt_state["m"]),
                         ("v", tr.opt_state["v"])):
        ref_tree = None if ref is None else (
            ref.params if prefix == "p" else ref.opt_state[prefix])
        for name, t in TL.leaves(tree).items():
            full = tr._full(name, t).detach()   # collective: every rank
            if ref is None:
                continue
            want = TL.leaves(ref_tree)[name].detach()
            bits = bits and torch.equal(full, want)
            by_leaf[prefix + ":" + name] = _held_leaf(
                prefix, full, want, None if prefix != "p" else
                [TL.leaves(ref.opt_state[k])[name] for k in ("m", "v")])
    out = {"losses": losses, "grad_norms": norms, "step_ms": step_ms,
           "per_step": per_step[-1], "counts": counts, "mesh": job["mesh"],
           "n_micro": tr.n_micro, "overlap_sends": tr.overlap_sends,
           "stage": tr.hcg.get_stage_id(), "replicas_bit_equal": replicas}
    if ref is not None:
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
        norm_rel = max(abs(a - b) / abs(b) for a, b in zip(norms, ref_norms))
        bits = bits and losses == ref_losses and norms == ref_norms
        failed = [k for k, v in by_leaf.items() if not v["ok"]]
        ok = bits or (rel <= 1e-4 and norm_rel <= 1e-5 and not failed)
        out.update(ref_losses=ref_losses, ref_grad_norms=ref_norms,
                   ref_step_ms=ref_ms, loss_rel=rel, grad_norm_rel=norm_rel,
                   bits_equal=bits, ok=ok, by_leaf=by_leaf,
                   worst_over_tol=max(v["ratio"] for v in by_leaf.values()))
        log(json.dumps({"hybrid_parity_by_leaf": {job["name"]: by_leaf}}))
        log(f"hybrid {job['name']}: clip norms {norms} vs one card "
            f"{ref_norms} (rel {norm_rel:.2e}, tol 1e-5)")
        if not ok:
            raise AssertionError(
                f"hybrid {job['name']}: the mesh path disagrees with "
                f"HybridTrainer(mesh=None): losses {losses} vs "
                f"{ref_losses} (rel {rel:.2e}, tol 1e-4); clip norms "
                f"{norms} vs {ref_norms} (rel {norm_rel:.2e}, tol 1e-5); "
                f"leaves outside their tolerance: {failed}")
    del tr, ref
    torch.cuda.empty_cache()
    return out


def _slope(ys):
    """The least-squares slope of ``ys`` against their index."""
    x = np.arange(len(ys), dtype=np.float64)
    return float(np.polyfit(x, np.asarray(ys, dtype=np.float64), 1)[0])


def _host_probe(dev):
    """How fast this rank's host issues work, as the eager step feels it:
    microseconds a launch of 2000 in-place adds to a small tensor on the
    card (host clock, before the sync), beside the cores this process may
    use and the host's load average."""
    x = torch.zeros(16, device=dev)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(2000):
        x.add_(1)
    launch_us = (time.perf_counter() - t) / 2000 * 1e6
    torch.cuda.synchronize()
    return {"launch_us": launch_us, "cores": len(os.sched_getaffinity(0)),
            "loadavg": list(os.getloadavg())}


def _hybrid_row(job, dist, dev):
    """Llama-2 7B at full width and depth, bf16, remat, over the mesh: one
    sequence of ``seq`` tokens a data rank (or ``batch`` sequences in
    ``n_micro`` micro-batches over 'pp'), one warm-up and ``steps`` timed
    steps, then one profiled step (rank 0 profiles, and over 'pp' the
    first rank of every stage; every rank runs it). The rate is quoted at
    the median of the later half of the timed steps (``steady``), beside
    the whole window's median and its slope in ms a step, so that a step
    time that drifts shows."""
    from paddle_tpu_torch import reset_launch_counts, launch_counts
    from paddle_tpu_torch.distributed.fleet import HybridTrainer

    cfg = _hybrid_config(job["width"], job["dtype"], job["layers"])
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    tr = HybridTrainer(cfg, job["mesh"], learning_rate=HYBRID_LR,
                       seed=HYBRID_SEED, device=dev,
                       pipeline_micro_batches=job.get("n_micro"))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    data = tr._data_ranks
    world = dist.get_world_size()
    rows = job.get("batch", data)
    batches = _hybrid_batches(cfg, rows, job["seq"], job["steps"] + 2, dev)
    held = torch.cuda.memory_allocated(dev)
    probe = _host_probe(dev)
    warm = float(tr.step(*batches[0]))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    losses, step_ms, per_step, norms, host = _timed_steps(
        dist, tr, batches[1:-1], probe=True)
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    _check_launches(per_step, _launches_of(tr, rows), f"hybrid {job['name']}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"7B losses not finite: {losses}")
    # one profiled step: NCCL kernels' device time against the rest, on
    # rank 0 and over 'pp' and 'sep' on the first rank of every stage and
    # every sep rank
    rank = dist.get_rank()
    coords = tr.hcg.layout().coords
    profiles = all(v == 0 for a, v in coords.items()
                   if a not in ("pp", "sep"))
    wall, intervals = [], []

    def profiled_step():
        t = time.perf_counter()
        tr.step(*batches[-1])
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t) * 1e3)

    torch.cuda.synchronize()
    dist.barrier()
    prof = profile_kernels(profiled_step, intervals=intervals) if profiles \
        else profiled_step()
    dist.barrier()
    steady = statistics.median(step_ms[len(step_ms) // 2:])
    profile_out = None
    if profiles:
        nccl = {k: v for k, v in prof.items() if "nccl" in k.lower()}
        nccl_ms = sum(us for _, us in nccl.values()) / 1e3
        p2p = {k: v for k, v in nccl.items() if "sendrecv" in k.lower()}
        flash = {k: v for k, v in prof.items() if "flash_" in k}
        comp_ms = sum(us for k, (_, us) in prof.items()
                      if k not in nccl) / 1e3
        top = sorted(((k[:60], n, us / 1e3) for k, (n, us) in
                      prof.items()), key=lambda r: -r[2])
        profile_out = {"step_ms_profiled": wall[0],
                       "stage": tr.hcg.get_stage_id(),
                       "sep_rank": coords["sep"],
                       "flash_device_ms": sum(us for _, us in flash.values())
                       / 1e3,
                       "flash_kernels": sum(n for n, _ in flash.values()),
                       # how much of the point-to-point kernels' time
                       # compute kernels ran beside (the exchange hidden)
                       "p2p_ms_beside_compute": _overlap_ms(
                           intervals, lambda k: "sendrecv" in k.lower(),
                           lambda k: "nccl" not in k.lower()),
                       "nccl_device_ms": nccl_ms,
                       "nccl_kernels": sum(n for n, _ in nccl.values()),
                       "p2p_device_ms": sum(us for _, us in p2p.values())
                       / 1e3,
                       "p2p_kernels": sum(n for n, _ in p2p.values()),
                       "compute_device_ms": comp_ms,
                       "compute_kernels": sum(n for k, (n, _) in
                                              prof.items() if k not in nccl),
                       "compute_busy_share_profiled": comp_ms / wall[0],
                       "compute_device_ms_over_steady_step":
                       comp_ms / steady,
                       "nccl_share_of_device_ms":
                       nccl_ms / max(nccl_ms + comp_ms, 1e-9),
                       "top": top[:12]}
    full_params = _full_param_count(cfg)
    tokens = rows * job["seq"]
    tps_card = tokens / (steady / 1e3) / world
    fpt = model_flops_per_token(cfg, full_params, job["seq"])
    out = {"mesh": job["mesh"], "world": world, "data_ranks": data,
           "n_micro": tr.n_micro, "stage": tr.hcg.get_stage_id(),
           "tokens_per_step": tokens, "init_s": init_s,
           "params": full_params, "warmup_loss": warm, "losses": losses,
           "grad_norms": norms, "step_ms": step_ms,
           "step_ms_median": statistics.median(step_ms),
           "step_ms_steady": steady,
           "step_ms_slope_per_step": _slope(step_ms),
           "host": host, "host_probe": probe,
           "issue_ms_over_step_ms": [h["issue_ms"] / s
                                     for h, s in zip(host, step_ms)],
           "tokens_per_s_per_card": tps_card,
           "model_flops_per_token": fpt,
           "share_of_989_tflops": tps_card * fpt / BF16_OPS_PER_S,
           "held_before_steps_gb": held / 1e9, "peak_memory_gb": peak / 1e9,
           "per_step": per_step[-1], "counts": counts,
           "profile": profile_out}
    del tr
    torch.cuda.empty_cache()
    return out


def _to_bf16(x):
    """The eager model's cast of the embedding's output (llama.py's
    LlamaModel with dtype "bfloat16"), as a pipeline item."""
    return x.astype("bfloat16")


def _engine_descs(cfg):
    """The eager Llama's own layers as pipeline items: Embedding, the cast
    to bf16, LlamaDecoderLayer x L (tensor-parallel under mp), RMSNorm,
    the head Linear."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.distributed.meta_parallel import LayerDesc
    from paddle_tpu_torch.models import llama as TL

    h, v = cfg.hidden_size, cfg.vocab_size
    return ([LayerDesc(nn.Embedding, v, h), _to_bf16]
            + [LayerDesc(TL.LlamaDecoderLayer, cfg)
               for _ in range(cfg.num_hidden_layers)]
            + [LayerDesc(nn.RMSNorm, h, epsilon=cfg.rms_norm_eps),
               LayerDesc(nn.Linear, h, v, bias_attr=False)])


def _gathered_params(model, hcg):
    """{name: the whole parameter} of a stage (collective over 'mp')."""
    from paddle_tpu_torch.distributed.fleet.layers.mpu.mp_ops import \
        gather_along

    mp = hcg.get_model_parallel_group()
    return {n: (gather_along(p._value.detach(), mp, p.split_axis)
                if p.is_distributed else p._value.detach())
            for n, p in model.named_parameters()}


def _pipeline_engines(job, dist, dev):
    """The eager pipeline engines at the flagship row's widths: a
    PipelineLayer of the eager Llama's layers (_engine_descs, 4 decoder
    layers, f32 parameters, recompute) with CrossEntropyLoss, under
    fleet.init at the job's pp (and mp: the decoder layers' mp layers
    inside each stage), through fleet.distributed_model's three engines
    (1F1B, VPP v = 2, ZB-H1) in turn: ``n_micro`` micro-batches of a
    ``batch`` x ``seq`` batch, ``steps`` AdamW steps under AMP O1 bf16
    (train_batch). Every rank builds the whole model from HYBRID_SEED on
    its card and loads its stage's entries by global names; rank 0 then
    steps the whole model through micro-batch accumulation on its card
    (the same micro-batches, each loss divided by their count) and holds
    each engine's losses within ENGINE_LOSS_RTOL relative and every
    gathered parameter within ENGINE_PARAM_LR learning rates of it. Every
    rank that holds a decoder layer must launch each training kernel. At
    pp 2 and more every engine's sends and receives run over NCCL."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import (launch_counts, nn, optimizer,
                                  reset_launch_counts)
    from paddle_tpu_torch.distributed import fleet, topology
    from paddle_tpu_torch.distributed.meta_parallel import PipelineLayer
    from paddle_tpu_torch.models import llama as TL
    from paddle_tpu_torch.utils import stage_state_dict_from_paddle_tpu

    cfg = _hybrid_config(job["width"], "bfloat16", job["layers"])
    pp, mp = job["mesh"].get("pp", 1), job["mesh"].get("mp", 1)
    rank = dist.get_rank()
    rng = np.random.RandomState(11)
    ids_np = rng.randint(0, cfg.vocab_size, (job["batch"], job["seq"]))
    ids = paddle.to_tensor(ids_np)
    labels = paddle.to_tensor(np.roll(ids_np, -1, axis=1))
    n = job["n_micro"]
    # the whole plain model, from the seed, on every rank's card
    topology.set_hybrid_communicate_group(None)
    paddle.seed(HYBRID_SEED)
    whole = PipelineLayer(_engine_descs(cfg), loss_fn=nn.CrossEntropyLoss())
    state = {k: v.numpy() for k, v in whole.state_dict().items()}
    if rank != 0:
        del whole
    ref_params = None
    out = {"engines": {}, "pp": pp, "mp": mp}
    counts_all, kept = Counter(), {}
    for name, extra, v in (("1F1B", {}, 1), ("VPP", {"schedule_mode": "VPP"},
                                            2),
                           ("ZBH1", {"schedule_mode": "ZBH1"}, 1)):
        strategy = fleet.DistributedStrategy()
        strategy.hybrid_configs = {
            "dp_degree": 1, "mp_degree": mp, "pp_degree": pp,
            "sharding_degree": 1, "sep_degree": 1,
            "pp_configs": dict({"accumulate_steps": n}, **extra)}
        fleet.init(is_collective=True, strategy=strategy)
        hcg = fleet.get_hybrid_communicate_group()
        if pp == 1 and v > 1:
            v = 1           # one stage: the one chunk
        model = PipelineLayer(_engine_descs(cfg),
                              loss_fn=nn.CrossEntropyLoss(),
                              num_virtual_pipeline_stages=v)
        missing, unexpected = model.set_state_dict(
            stage_state_dict_from_paddle_tpu(state, model, hcg))
        if missing or unexpected:
            raise AssertionError(f"engines {name}: stage load missed "
                                 f"{missing}, unexpected {unexpected}")
        engine = fleet.distributed_model(model) if pp > 1 else \
            _engine_class(name)(model, hcg, strategy=strategy)
        opt = optimizer.AdamW(learning_rate=HYBRID_LR,
                              parameters=model.parameters())
        losses, step_ms = [], []
        torch.cuda.synchronize()
        dist.barrier()
        reset_launch_counts()
        for _ in range(job["steps"]):
            t = time.perf_counter()
            with paddle.amp.auto_cast(level="O1", dtype="bfloat16"):
                loss = engine.train_batch((ids, labels), opt)
            losses.append(float(loss))
            torch.cuda.synchronize()
            dist.barrier()
            step_ms.append((time.perf_counter() - t) * 1e3)
        counts = launch_counts()
        counts_all.update(counts)
        decoders = sum(isinstance(l, TL.LlamaDecoderLayer)
                       for l in model.layers_list.values())
        if decoders and min(counts[k] for k in TRAINING_KERNELS) <= 0:
            raise AssertionError(f"engines {name}: a stage holding "
                                 f"{decoders} decoder layers missed a "
                                 f"kernel: {counts}")
        out["engines"][name] = {
            "engine": type(engine).__name__, "losses": losses,
            "step_ms": step_ms, "decoder_layers_here": decoders,
            "launches": {k: counts[k] for k in TRAINING_KERNELS},
            "stage": hcg.get_stage_id()}
        kept[name] = _gathered_params(model, hcg)
        del model, engine, opt
        torch.cuda.empty_cache()
    topology.set_hybrid_communicate_group(None)
    dist.barrier()
    # rank 0 steps the whole model, then sends each of its parameters to
    # every rank, which holds its stage's against it
    ref_losses = None
    if rank == 0:
        ref_losses, ref_params = _engine_reference(whole, ids, labels, n,
                                                   job["steps"])
    # per engine: (the largest difference in learning rates, its leaf),
    # and (the largest share of a leaf's elements off by more than 1e-3
    # of the leaf's largest magnitude plus a tenth of the learning rate,
    # its leaf)
    worst = {name: [(-1.0, None), (-1.0, None)] for name in kept}
    for key in sorted(state):
        buf = ref_params[key].contiguous() if rank == 0 else torch.empty(
            state[key].shape, dtype=torch.float32, device=dev)
        dist.broadcast(buf, src=0)
        tol = 1e-3 * float(buf.abs().max()) + 0.1 * HYBRID_LR
        for name, params in kept.items():
            if key in params:
                diff = (params[key].float() - buf).abs()
                w = worst[name]
                w[0] = max(w[0], (float(diff.max()) / HYBRID_LR, key),
                           key=lambda r: r[0])
                w[1] = max(w[1], (float((diff > tol).float().mean()), key),
                           key=lambda r: r[0])
    if rank == 0:
        del whole, ref_params
    gathered = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, worst)
    for name, rec in out["engines"].items():
        big = max((g[name][0] for g in gathered), key=lambda r: r[0])
        share = max((g[name][1] for g in gathered), key=lambda r: r[0])
        rec.update(worst_param_over_lr=big[0], worst_param_leaf=big[1],
                   worst_share_over_tol=share[0],
                   worst_share_leaf=share[1])
        if rank == 0:
            rel = max(abs(a - b) / abs(b)
                      for a, b in zip(rec["losses"], ref_losses))
            rec.update(ref_losses=ref_losses, loss_rel=rel,
                       ok=rel <= ENGINE_LOSS_RTOL
                       and share[0] <= ENGINE_PARAM_SHARE
                       and big[0] <= ENGINE_PARAM_LR)
            log(f"engines {job['name']} {name} ({rec['engine']}): losses "
                f"{rec['losses']} vs whole {ref_losses} (rel {rel:.2e}, tol "
                f"{ENGINE_LOSS_RTOL}); parameters: largest difference "
                f"{big[0]:.3f} lr ({big[1]}; tol {ENGINE_PARAM_LR}), share "
                f"off by more than 1e-3 of the leaf's largest magnitude + "
                f"0.1 lr {share[0]:.2e} ({share[1]}; tol "
                f"{ENGINE_PARAM_SHARE}); step ms {rec['step_ms']}")
            if not rec["ok"]:
                raise AssertionError(f"engines {job['name']} {name} "
                                     f"disagree with the whole model")
    out["counts"] = dict(counts_all)
    out["stage"] = out["engines"]["1F1B"]["stage"]
    out["per_step"] = {k: n // job["steps"] for k, n in
                       out["engines"]["1F1B"]["launches"].items()}
    del kept
    torch.cuda.empty_cache()
    return out


def _engine_class(name):
    from paddle_tpu_torch.distributed.meta_parallel import (
        PipelineParallel, PipelineParallelWithInterleave,
        PipelineParallelZeroBubble)

    return {"1F1B": PipelineParallel, "VPP": PipelineParallelWithInterleave,
            "ZBH1": PipelineParallelZeroBubble}[name]


def _engine_reference(whole, ids, labels, n, steps):
    """The whole model on this card through micro-batch accumulation:
    each micro-batch's loss divided by their count, its gradients
    accumulated, then AdamW; the mean loss of each step and the
    parameters after the steps."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import optimizer

    opt = optimizer.AdamW(learning_rate=HYBRID_LR,
                          parameters=whole.parameters())
    rows = ids.shape[0] // n
    losses = []
    whole.train()
    for _ in range(steps):
        total = 0.0
        for m in range(n):
            with paddle.amp.auto_cast(level="O1", dtype="bfloat16"):
                x = ids[m * rows:(m + 1) * rows]
                y = labels[m * rows:(m + 1) * rows]
                loss = whole._loss_fn(whole(x), y)
            (loss / n).backward()
            total += float(loss)
        opt.step()
        opt.clear_grad()
        losses.append(total / n)
    params = {k: p._value.detach().float() for k, p in
              whole.named_parameters()}
    return losses, params


def _full_param_count(cfg):
    """The parameter count of the whole (unsharded) model."""
    h, i, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    kvh = cfg.num_key_value_heads * cfg.head_dim
    layer = 2 * h * h + 2 * h * kvh + 3 * h * i + 2 * h
    return 2 * v * h + h + cfg.num_hidden_layers * layer


def _moe_rank_inputs(dev, tokens, rank, world):
    """Every rank draws the whole MoE parameters and batch from MOE_SEED
    (each leaf whole, then sliced: any world starts from the numbers of
    one process) and keeps its rows and its E / world experts."""
    gen = torch.Generator(device=dev).manual_seed(MOE_SEED)
    full = _moe_params(dev, gen)
    x = torch.randn(tokens, MOE_D, generator=gen, device=dev)
    y = torch.randn(tokens, MOE_D, generator=gen, device=dev)
    rows, per = tokens // world, MOE_E // world
    mine = slice(rank * rows, (rank + 1) * rows)
    local = {"wg": full["wg"].clone(),
             "w1": full["w1"][rank * per:(rank + 1) * per].clone(),
             "w2": full["w2"][rank * per:(rank + 1) * per].clone()}
    return full, local, x, y, x[mine].clone(), y[mine].clone()


def _moe_sgd(TM, p, x, y, tokens, steps, group=None, n=1):
    """``steps`` SGD steps (MOE_LR) of _moe_loss; over a group the wg
    gradient summed over it first. The losses summed over the group."""
    from paddle_tpu_torch.distributed import collective

    losses = []
    for t in p.values():
        t.requires_grad_(True)
    for _ in range(steps):
        loss, _, _ = _moe_loss(TM, p, x, y, tokens, n, group)
        loss.backward()
        with torch.no_grad():
            if group is not None:
                collective.all_reduce(p["wg"].grad, group=group)
            for t in p.values():
                t -= MOE_LR * t.grad
                t.grad = None
        total = loss.detach().clone()
        if group is not None:
            collective.all_reduce(total, group=group)
        losses.append(float(total))
    return losses


def _moe_parity(job, dist, dev):
    """moe_block_stacked over an expert group of the world at Mixtral's
    widths (``tokens`` global tokens, each rank its rows and E / world
    experts) against rank 0's group=None run of the global batch: the
    slots of each rank's all-gathered logits equal rank 0's, and 3 SGD
    steps of the loss of tests/test_moe_ep.py: the losses within 1e-5
    relative, every parameter (the experts gathered) within 1e-5 of its
    largest magnitude, or bit for bit (which, is logged)."""
    from paddle_tpu_torch.distributed import collective
    from paddle_tpu_torch.incubate.distributed.models import moe as TM

    world, rank = dist.get_world_size(), dist.get_rank()
    group = collective._get_default_group()
    tokens = job["tokens"]
    full, p, _, _, xs, ys = _moe_rank_inputs(dev, tokens, rank, world)
    with torch.no_grad():
        logits = dist.all_gather(None, xs @ p["wg"], group=group)
        slot = TM.topk_sort_dispatch(logits, MOE_CF, MOE_K)[0]
    slots = dist.all_gather(None, slot, group=group)
    torch.cuda.synchronize()
    t = time.perf_counter()
    losses = _moe_sgd(TM, p, xs, ys, tokens, job["steps"], group, world)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3
    experts = {k: dist.all_gather(None, p[k].detach(), group=group)
               for k in ("w1", "w2")}
    out = {"world": world, "tokens": tokens, "losses": losses,
           "step_ms": [ms / job["steps"]]}
    if rank == 0:
        _, _, x, y, _, _ = _moe_rank_inputs(dev, tokens, 0, 1)
        ref = {k: v.clone() for k, v in full.items()}
        with torch.no_grad():
            ref_slot = TM.topk_sort_dispatch(x @ ref["wg"], MOE_CF,
                                             MOE_K)[0]
        ref_losses = _moe_sgd(TM, ref, x, y, tokens, job["steps"])
        slots_equal = all(torch.equal(s, ref_slot)
                          for s in slots.chunk(world, 0))
        got = dict(experts, wg=p["wg"].detach())
        ratios = {k: float((got[k] - ref[k].detach()).abs().max())
                  / (1e-5 * float(ref[k].detach().abs().max()))
                  for k in got}
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
        bits = all(torch.equal(got[k], ref[k].detach()) for k in got) \
            and losses == ref_losses
        ok = slots_equal and rel <= 1e-5 and max(ratios.values()) <= 1.0
        out.update(ref_losses=ref_losses, loss_rel=rel,
                   slots_equal=slots_equal, worst_over_tol=ratios,
                   bits_equal=bits, ok=ok,
                   kept_pairs=int((ref_slot >= 0).sum()))
        log(f"moe {job['name']}: losses {losses} vs group=None "
            f"{ref_losses} (rel {rel:.2e}); slots equal {slots_equal}; "
            f"parameters over 1e-5 of their largest magnitude {ratios}; "
            f"bits equal {bits}")
        if not ok:
            raise AssertionError(f"moe {job['name']}: the expert group "
                                 f"disagrees with group=None")
        del ref, x, y
    del full, p, experts
    torch.cuda.empty_cache()
    return out


def _moe_row(job, dist, dev):
    """moe_block_stacked over an expert group of the world at Mixtral's
    widths, ``tokens`` global tokens (tokens / world a card, E / world
    experts a card), one warm-up and ``steps`` timed SGD steps: ms a step,
    tokens/s a card, peak memory a card, each call's exchange plan (its
    host sync: the count matrix read to the host) timed, the rows and
    bytes each exchange moves, and one profiled step on rank 0 (the NCCL
    all-to-all kernels' device time against the expert GEMMs')."""
    from paddle_tpu_torch.distributed import collective
    from paddle_tpu_torch.incubate.distributed.models import moe as TM

    world, rank = dist.get_world_size(), dist.get_rank()
    group = collective._get_default_group()
    tokens = job["tokens"]
    full, p, _, _, xs, ys = _moe_rank_inputs(dev, tokens, rank, world)
    del full
    torch.cuda.empty_cache()
    plans = []
    route = TM._route

    def timed_route(*args, **kwargs):
        t = time.perf_counter()
        r = route(*args, **kwargs)
        plans.append(((time.perf_counter() - t) * 1e3, r[0], r[1]))
        return r

    TM._route = timed_route
    try:
        torch.cuda.reset_peak_memory_stats(dev)
        _moe_sgd(TM, p, xs, ys, tokens, 1, group, world)
        step_ms, losses = [], []
        for _ in range(job["steps"]):
            torch.cuda.synchronize()
            dist.barrier()
            t = time.perf_counter()
            losses += _moe_sgd(TM, p, xs, ys, tokens, 1, group, world)
            torch.cuda.synchronize()
            dist.barrier()
            step_ms.append((time.perf_counter() - t) * 1e3)
        peak = torch.cuda.max_memory_allocated(dev)
        prof = None
        dist.barrier()
        if rank == 0:
            prof = profile_kernels(
                lambda: _moe_sgd(TM, p, xs, ys, tokens, 1, group, world))
        else:
            _moe_sgd(TM, p, xs, ys, tokens, 1, group, world)
        dist.barrier()
    finally:
        TM._route = route
    capacity = max(int(MOE_CF * tokens * MOE_K / MOE_E), 1)
    sent = [sum(s) for _, s, _ in plans]
    steady = statistics.median(step_ms[len(step_ms) // 2:])
    flops = _moe_expert_flops(MOE_E // world, capacity)
    out = {"world": world, "tokens": tokens, "tokens_a_card": tokens // world,
           "experts_a_card": MOE_E // world, "capacity": capacity,
           "losses": losses, "step_ms": step_ms, "step_ms_steady": steady,
           "tokens_per_s_per_card": tokens / world / (steady / 1e3),
           "peak_memory_gb": peak / 1e9,
           "route_host_ms": [ms for ms, _, _ in plans],
           "route_host_ms_median": statistics.median(
               ms for ms, _, _ in plans),
           "rows_sent_a_call": sent,
           # dispatch and combine forward, their reverse in the backward
           "exchange_mb_a_direction": statistics.median(sent) * MOE_D * 4
           / 1e6,
           "expert_tflop_a_step_a_card": flops / 1e12,
           "expert_bound_ms_f32": flops / F32_OPS_PER_S * 1e3}
    if prof is not None:
        nccl = {k: v for k, v in prof.items() if "nccl" in k.lower()}
        a2a = {k: v for k, v in nccl.items() if "sendrecv" in k.lower()
               or "alltoall" in k.lower()}
        gemm_us = sum(us for k, (_, us) in prof.items() if _is_gemm(k))
        out["profile"] = {
            "all_to_all_device_ms": sum(us for _, us in a2a.values()) / 1e3,
            "all_to_all_kernels": sum(n for n, _ in a2a.values()),
            "nccl_device_ms": sum(us for _, us in nccl.values()) / 1e3,
            "expert_gemm_device_ms": gemm_us / 1e3,
            "device_ms": sum(us for _, us in prof.values()) / 1e3,
            "top": sorted(((k[:60], n, us / 1e3) for k, (n, us) in
                           prof.items()), key=lambda r: -r[2])[:10]}
    del p, xs, ys
    torch.cuda.empty_cache()
    return out


def _sharded_eager(cfg, level, group, clip=True):
    """The eager LlamaForCausalLM from HYBRID_SEED with AdamW (and the
    global-norm clip), through group_sharded_parallel at ``level`` over
    ``group`` (None: plain)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed.meta_parallel import \
        group_sharded_parallel
    from paddle_tpu_torch.models import llama as TL

    paddle.seed(HYBRID_SEED)
    model = TL.LlamaForCausalLM(cfg)
    opt = optimizer.AdamW(
        learning_rate=HYBRID_LR, parameters=model.parameters(),
        grad_clip=optimizer.ClipGradByGlobalNorm(1.0) if clip else None)
    if level is not None:
        model, opt, _ = group_sharded_parallel(model, opt, level,
                                               group=group)
    torch.cuda.empty_cache()
    return model, opt


def _eager_loss_step(model, opt, ids, labels, amp):
    """One eager step (under AMP O1 bf16 with ``amp``): its loss."""
    if amp:
        return _eager_step(model, opt, ids, labels)
    loss = model(ids, labels=labels)
    loss.backward()
    opt.step()
    opt.clear_grad()
    return loss


def _clip_norms(opt, group):
    """The list to which each step of ``opt`` appends the global norm of
    the gradient that its clip sees: a plain optimizer's clip as it
    computes it; a sharding optimizer's read after its reduction (stage 1
    the averaged full gradients, stages 2-3 the slices' squares summed
    over ``group``)."""
    from paddle_tpu_torch.distributed import collective
    from paddle_tpu_torch.distributed.meta_parallel import \
        DygraphShardingOptimizer

    norms = []
    if not isinstance(opt, DygraphShardingOptimizer):
        clip = opt._grad_clip
        norm_of = clip.global_norm

        def global_norm(grads):
            norm = norm_of(grads)
            norms.append(float(norm))
            return norm

        clip.global_norm = global_norm
        return norms
    reduce = opt.reduce_gradients

    def reduce_gradients():
        reduce()
        grads = [p._value.grad for p in opt._inner_opt._parameter_list
                 if p._value.grad is not None] if opt.stage == 1 else \
            list(opt._grad_slices.values())
        sq = sum(g.float().square().sum() for g in grads)
        if opt.stage > 1 and opt._n > 1:
            collective.all_reduce(sq, group=group)
        norms.append(float(torch.sqrt(sq)))

    opt.reduce_gradients = reduce_gradients
    return norms


def _group_sharded_parity(job, dist, dev):
    """group_sharded_parallel of the eager LlamaForCausalLM at ``level``
    over the world (each rank its rows of a ``batch`` x ``seq`` batch), 3
    AdamW steps with the global-norm clip (under AMP O1 bf16 with
    ``amp``), each held to the eager step's launches, against rank 0's
    unsharded model stepped on the whole batch on its card: bit for bit, or
    the losses and the clip's global norm each step within ENGINE_LOSS_RTOL
    relative, every parameter as the engines job holds it
    (ENGINE_PARAM_SHARE, ENGINE_PARAM_LR) and every AdamW moment within
    ENGINE_MOMENT_RTOL of its largest magnitude (AdamW's update and a
    clipped gradient do not change when every gradient is scaled: the norm
    and the moments are what show a group average taken wrong). Stage 3's
    parameter bytes held between steps are the slices'."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import launch_counts, reset_launch_counts
    from paddle_tpu_torch.distributed import collective

    cfg = _hybrid_config(job["width"], job["dtype"], job["layers"])
    world, rank = dist.get_world_size(), dist.get_rank()
    group = collective._get_default_group()
    amp = job.get("amp", False)
    batches = _hybrid_batches(cfg, job["batch"], job["seq"], 3, dev)
    rows = job["batch"] // world
    mine = slice(rank * rows, (rank + 1) * rows)
    model, opt = _sharded_eager(cfg, job["level"], group)
    norms = _clip_norms(opt, group)
    torch.cuda.synchronize()
    param_bytes = sum(p._value.numel() * p._value.element_size()
                      for p in model.parameters())
    reset_launch_counts()
    losses, per_step, step_ms = [], [], []
    for ids, labels in batches:
        before = launch_counts()
        torch.cuda.synchronize()
        dist.barrier()
        t = time.perf_counter()
        loss = _eager_loss_step(model, opt, paddle.to_tensor(ids[mine]),
                                paddle.to_tensor(labels[mine]), amp)
        total = loss.detach()._value.float().clone()
        collective.all_reduce(total, op="avg", group=group)
        losses.append(float(total))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        per_step.append({k: v - before[k]
                         for k, v in launch_counts().items()})
    counts = launch_counts()
    _check_launches(per_step, _training_launches(cfg),
                    f"group_sharded {job['name']}")
    state = model.state_dict()          # full values: collective
    moments = {k: v._value for k, v in opt.state_dict().items()
               if k != "_step_count"}   # likewise
    if rank != 0:
        del moments
    out = {"level": job["level"], "world": world, "losses": losses,
           "norms": norms,
           "step_ms": step_ms, "per_step": per_step[-1], "counts": counts,
           "param_bytes_held": param_bytes,
           "param_bytes_full": sum(v._value.numel() * v._value.element_size()
                                   for v in state.values())}
    if rank == 0:
        plain, popt = _sharded_eager(cfg, None, None)
        ref_norms = _clip_norms(popt, None)
        ref_losses = [float(_eager_loss_step(
            plain, popt, paddle.to_tensor(i), paddle.to_tensor(l), amp))
            for i, l in batches]
        ref = {k: v._value.detach() for k, v in plain.state_dict().items()}
        ref_moments = {k: v._value for k, v in popt.state_dict().items()
                       if k != "_step_count"}
        if sorted(moments) != sorted(ref_moments) or \
                len(norms) != len(ref_norms) or not norms:
            raise AssertionError(
                f"group_sharded {job['name']}: moments {sorted(moments)} "
                f"vs {sorted(ref_moments)}, norms {norms} vs {ref_norms}")
        bits = losses == ref_losses and norms == ref_norms and all(
            torch.equal(state[k]._value, v) for k, v in ref.items()) and \
            all(torch.equal(moments[k], v) for k, v in ref_moments.items())
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
        norm_rel = max(abs(a - b) / abs(b) for a, b in zip(norms, ref_norms))
        big = share = 0.0
        for k, want in ref.items():
            diff = (state[k]._value.detach().float() - want.float()).abs()
            tol = 1e-3 * float(want.abs().max()) + 0.1 * HYBRID_LR
            big = max(big, float(diff.max()) / HYBRID_LR)
            share = max(share, float((diff > tol).float().mean()))
        moment_rel = max(
            float((moments[k].float() - want.float()).abs().max())
            / max(float(want.abs().max()), 1e-30)
            for k, want in ref_moments.items())
        ok = bits or (rel <= ENGINE_LOSS_RTOL and share <= ENGINE_PARAM_SHARE
                      and big <= ENGINE_PARAM_LR
                      and norm_rel <= ENGINE_LOSS_RTOL
                      and moment_rel <= ENGINE_MOMENT_RTOL)
        out.update(ref_losses=ref_losses, loss_rel=rel, ref_norms=ref_norms,
                   norm_rel=norm_rel, worst_moment_rel=moment_rel,
                   bits_equal=bits, worst_param_over_lr=big,
                   worst_share_over_tol=share, ok=ok)
        log(f"group_sharded {job['name']}: losses {losses} vs unsharded "
            f"{ref_losses} (rel {rel:.2e}); clip norms {norms} vs "
            f"{ref_norms} (rel {norm_rel:.2e}); bits equal {bits}; "
            f"parameters worst {big:.3f} lr, share off {share:.2e}; "
            f"moments worst {moment_rel:.2e} of their largest; parameter "
            f"bytes held {param_bytes} of {out['param_bytes_full']}")
        if not ok:
            raise AssertionError(f"group_sharded {job['name']} disagrees "
                                 f"with the unsharded eager step")
        del plain, popt, ref, ref_moments, moments
    del model, opt, state
    torch.cuda.empty_cache()
    return out


def _group_sharded_row(job, dist, dev):
    """The eager Llama-2 7B (32 layers, f32 parameters, recompute) under
    group_sharded_parallel "p_g_os" over the world, AMP O1 bf16, AdamW, one
    sequence of ``seq`` a rank: one warm-up and ``steps`` timed steps
    (ms a step, tokens/s a card, share of 989 TF/s), the bytes held a card
    between steps and at peak, launches a step, and one profiled step on
    rank 0 (NCCL kernels' device time against the rest)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import launch_counts, reset_launch_counts
    from paddle_tpu_torch.distributed import collective

    cfg = _hybrid_config(job["width"], "bfloat16", job["layers"])
    world, rank = dist.get_world_size(), dist.get_rank()
    group = collective._get_default_group()
    t0 = time.perf_counter()
    model, opt = _sharded_eager(cfg, job["level"], group, clip=False)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    batches = _hybrid_batches(cfg, world, job["seq"], job["steps"] + 2, dev)
    mine = slice(rank, rank + 1)

    def step(i):
        ids, labels = batches[i]
        return float(_eager_step(model, opt, paddle.to_tensor(ids[mine]),
                                 paddle.to_tensor(labels[mine])))

    warm = step(0)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    losses, step_ms, per_step = [], [], []
    for i in range(1, job["steps"] + 1):
        before = launch_counts()
        torch.cuda.synchronize()
        dist.barrier()
        t = time.perf_counter()
        losses.append(step(i))
        torch.cuda.synchronize()
        dist.barrier()
        step_ms.append((time.perf_counter() - t) * 1e3)
        per_step.append({k: v - before[k]
                         for k, v in launch_counts().items()})
    peak = torch.cuda.max_memory_allocated(dev)
    counts = launch_counts()
    _check_launches(per_step, _training_launches(cfg),
                    f"group_sharded {job['name']}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"group_sharded 7B losses: {losses}")
    dist.barrier()
    prof = profile_kernels(lambda: step(len(batches) - 1)) if rank == 0 \
        else step(len(batches) - 1)
    dist.barrier()
    steady = statistics.median(step_ms[len(step_ms) // 2:])
    full_params = _full_param_count(cfg)
    fpt = model_flops_per_token(cfg, full_params, job["seq"])
    tps = job["seq"] / (steady / 1e3)
    out = {"level": job["level"], "world": world, "init_s": init_s,
           "warmup_loss": warm, "losses": losses, "step_ms": step_ms,
           "step_ms_steady": steady, "step_ms_slope_per_step": _slope(step_ms),
           "tokens_per_s_per_card": tps,
           "share_of_989_tflops": tps * fpt / BF16_OPS_PER_S,
           "held_between_steps_gb": held / 1e9, "peak_memory_gb": peak / 1e9,
           "param_bytes_a_card_gb": sum(
               p._value.numel() * p._value.element_size()
               for p in model.parameters()) / 1e9,
           "params": full_params, "per_step": per_step[-1],
           "counts": counts,
           # stage 1 at this size: f32 parameters and gradients whole and
           # the moments' slices, before any activation
           "stage1_would_hold_gb": (2 * 4 * full_params
                                    + 2 * 4 * full_params / world) / 1e9}
    if rank == 0:
        nccl_us = sum(us for k, (_, us) in prof.items()
                      if "nccl" in k.lower())
        comp_us = sum(us for k, (_, us) in prof.items()
                      if "nccl" not in k.lower())
        out["profile"] = {"nccl_device_ms": nccl_us / 1e3,
                          "compute_device_ms": comp_us / 1e3,
                          "top": sorted(((k[:60], n, us / 1e3) for k, (n, us)
                                         in prof.items()),
                                        key=lambda r: -r[2])[:10]}
    del model, opt
    torch.cuda.empty_cache()
    return out


def _save_attn_parity(job, dist, dev):
    """The mesh trainer under remat_policy "full", then "save_attn", 3
    steps each from the same seed: the losses, clip norms and every leaf
    (gathered) of save_attn bit for bit those of full, or within
    _hybrid_parity's tolerances; each step's launches held, the flash
    forward's once a layer (and hop) under save_attn where full runs it
    twice, and under pp the same as full (whole blocks recomputed)."""
    from paddle_tpu_torch import launch_counts, reset_launch_counts
    from paddle_tpu_torch.distributed.fleet import HybridTrainer
    from paddle_tpu_torch.models import llama as TL

    runs = {}
    for policy in ("full", "save_attn"):
        cfg = _hybrid_config(job["width"], job["dtype"], job["layers"])
        cfg.remat_policy = policy
        batches = _hybrid_batches(cfg, job["batch"], job["seq"], 3, dev)
        tr = HybridTrainer(cfg, job["mesh"], learning_rate=HYBRID_LR,
                           seed=HYBRID_SEED, device=dev,
                           pipeline_micro_batches=job.get("n_micro"))
        torch.cuda.synchronize()
        reset_launch_counts()
        losses, step_ms, per_step, norms, _ = _timed_steps(dist, tr,
                                                           batches)
        want = _launches_of(tr, job["batch"])
        if policy == "save_attn" and not tr.pipelined:
            want["flash_attention_fwd"] //= 2
        _check_launches(per_step, want, f"save_attn {job['name']} {policy}")
        leaves = {pre + ":" + n: tr._full(n, t).detach()
                  for pre, tree in (("p", tr.params),
                                    ("m", tr.opt_state["m"]),
                                    ("v", tr.opt_state["v"]))
                  for n, t in TL.leaves(tree).items()}
        runs[policy] = dict(losses=losses, norms=norms, step_ms=step_ms,
                            per_step=per_step[-1], counts=launch_counts(),
                            leaves=leaves)
        del tr
        torch.cuda.empty_cache()
    full, saved = runs["full"], runs["save_attn"]
    bits = full["losses"] == saved["losses"] and \
        full["norms"] == saved["norms"] and all(
            torch.equal(v, saved["leaves"][k])
            for k, v in full["leaves"].items())
    rel = max(abs(a - b) / abs(b) for a, b in zip(saved["losses"],
                                                   full["losses"]))
    norm_rel = max(abs(a - b) / abs(b) for a, b in zip(saved["norms"],
                                                        full["norms"]))
    by_leaf = {} if bits else {
        k: _held_leaf(k[0], saved["leaves"][k], v,
                      [full["leaves"][m + k[1:]] for m in "mv"])
        for k, v in full["leaves"].items()}
    failed = [k for k, v in by_leaf.items() if not v["ok"]]
    ok = bits or (rel <= 1e-4 and norm_rel <= 1e-5 and not failed)
    out = {"mesh": job["mesh"], "bits_equal": bits, "loss_rel": rel,
           "grad_norm_rel": norm_rel, "ok": ok,
           "stage": None, "counts": saved["counts"],
           "per_step": saved["per_step"], "full_per_step": full["per_step"],
           "losses": saved["losses"], "full_losses": full["losses"],
           "step_ms": saved["step_ms"], "full_step_ms": full["step_ms"]}
    fwd = "flash_attention_fwd"
    log(f"save_attn {job['name']} rank {dist.get_rank()}: bits equal to "
        f"full {bits}; flash forward a step {saved['per_step'][fwd]} (full "
        f"{full['per_step'][fwd]}); losses {saved['losses']} vs "
        f"{full['losses']}")
    if not ok:
        raise AssertionError(f"save_attn {job['name']}: disagrees with "
                             f"full: losses rel {rel:.2e}, norms rel "
                             f"{norm_rel:.2e}, leaves {failed}")
    return out


def _drop_groups(dist, made_before):
    """Destroy the process groups a job made (every rank, after a barrier;
    the world's own group, id 0, stays) and drop the current hybrid group:
    their NCCL communicators would otherwise stay allocated for the rest
    of the run, ~3.5 GB a card a job on four H100s, until a later job runs
    out of memory. A collection then frees what the job left in reference
    cycles (an optimizer whose method a job wrapped holds its parameters
    and moments until one runs)."""
    import gc

    from paddle_tpu_torch.distributed import collective, topology

    dist.barrier()
    topology.set_hybrid_communicate_group(None)
    for gid in sorted(set(collective._groups) - made_before - {0}):
        collective.destroy_process_group(collective._groups[gid])
    gc.collect()
    torch.cuda.empty_cache()


def _hybrid_rank(out_dir, plan):
    """One rank of phase_hybrid (a spawned process): NCCL, its own card,
    the plan's jobs in order; its results (or its error) to
    out_dir/rank<r>.json."""
    import faulthandler

    faulthandler.enable()     # a rank that dies on a signal shows where
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch import resolve_device
    from paddle_tpu_torch.distributed import collective

    dist.init_parallel_env()
    rank = dist.get_rank()
    dev = resolve_device(None)
    res = {"rank": rank, "device": str(dev),
           "card": torch.cuda.get_device_name(dev),
           "backend": dist.get_backend()}
    try:
        for job in plan:
            made_before = set(collective._groups)
            fn = {"parity": _hybrid_parity, "row": _hybrid_row,
                  "engines": _pipeline_engines, "moe": _moe_parity,
                  "moe_row": _moe_row,
                  "group_sharded": _group_sharded_parity,
                  "group_sharded_row": _group_sharded_row,
                  "save_attn": _save_attn_parity}[job["kind"]]
            log(f"hybrid rank {rank}: {job['name']} starts")
            res[job["name"]] = fn(job, dist, dev)
            _drop_groups(dist, made_before)
            log(f"hybrid rank {rank}: {job['name']} done")
    finally:
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()


def phase_hybrid(dev, world=None):
    """Hybrid parallelism over NCCL: ``world`` (min(cards, 4) when None)
    ranks spawned one a card, each running _hybrid_plan(world)'s jobs;
    fails if a rank fails. The parent first lets go of the cached device
    memory it holds no more, so rank 0 on its card has room."""
    import gc

    from paddle_tpu_torch.distributed import spawn
    from paddle_tpu_torch.ops.kernels import _build

    world = world or min(torch.cuda.device_count(), 4)
    plan = _hybrid_plan(world)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"hybrid: world {world}, parent holds "
        f"{torch.cuda.memory_allocated(dev) / 1e9:.2f} GB on {dev}; jobs "
        f"{[(j['name'], j.get('mesh')) for j in plan]}")
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out_dir = tempfile.mkdtemp(dir=_build.BUILD_DIR, prefix="hybrid-")
    t0 = time.perf_counter()
    try:
        spawn(_hybrid_rank, args=(out_dir, plan), nprocs=world,
              backend="nccl", timeout=HYBRID_TIMEOUT_S[world])
        ranks = []
        for r in range(world):
            with open(os.path.join(out_dir, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    wall = time.perf_counter() - t0
    log(f"hybrid: world {world} ran {wall:.1f} s; ranks on " + ", ".join(
        f"{r['rank']}: {r['device']} {r['card']} ({r['backend']})"
        for r in ranks))
    if sorted({r["device"] for r in ranks}) != sorted(
            f"cuda:{i}" for i in range(world)):
        raise AssertionError(f"hybrid: ranks did not each take their own "
                             f"card: {[r['device'] for r in ranks]}")
    out = {"world": world, "wall_s": wall, "jobs": {},
           "pipeline_counts": Counter(), "pipeline_per_step": {}}
    for job in plan:
        r0 = ranks[0][job["name"]]
        mine = {k: v for k, v in r0.items() if k not in ("counts",)}
        if job["kind"] == "engines":
            mine["engines_by_rank"] = [r[job["name"]]["engines"]
                                       for r in ranks]
        else:
            mine["step_ms_by_rank"] = [r[job["name"]].get("step_ms")
                                       for r in ranks]
        if job["kind"] in ("moe_row", "group_sharded_row"):
            mine["peak_memory_gb_by_rank"] = [
                r[job["name"]]["peak_memory_gb"] for r in ranks]
        if job["kind"] == "row":
            mine["peak_memory_gb_by_rank"] = [
                r[job["name"]]["peak_memory_gb"] for r in ranks]
            mine["host_probe_by_rank"] = [
                r[job["name"]]["host_probe"] for r in ranks]
            mine["issue_ms_over_step_ms_by_rank"] = [
                r[job["name"]]["issue_ms_over_step_ms"] for r in ranks]
            mine["profiles"] = [r[job["name"]]["profile"] for r in ranks
                                if r[job["name"]]["profile"]]
            if job["mesh"].get("sep", 1) > 1:
                # the contiguous shards' load: sep rank r runs r + 1 hops
                mine["sep_flash_device_ms_by_rank"] = {
                    p["sep_rank"]: p["flash_device_ms"]
                    for p in mine["profiles"]}
        out["jobs"][job["name"]] = mine
        log(json.dumps({"hybrid": {job["name"]: mine}}))
        if job["path"] is True:
            out["counts"] = r0["counts"]
            out["launches_per_step"] = r0["per_step"]
        elif job["path"]:
            out.setdefault("path_counts", {})[job["path"]] = r0["counts"]
            out.setdefault("path_per_step", {})[job["path"]] = \
                r0["per_step"]
        if job.get("pipeline"):
            # every stage's launches (each rank's), and a step's on the
            # first rank of each stage
            for r in ranks:
                out["pipeline_counts"].update(r[job["name"]]["counts"])
            out["pipeline_per_step"][job["name"]] = {
                f"stage {r[job['name']].get('stage', 0)}":
                r[job["name"]]["per_step"] for r in reversed(ranks)}
    out["pipeline_counts"] = dict(out["pipeline_counts"])
    return out


# ---------------------------------------------------------------------------
# 6g. auto-parallel through the launcher
# ---------------------------------------------------------------------------

# BERT-base at bench.py::bench_bert's batch, as one global batch over the
# mesh; 3 warm-up and 8 timed to_static steps; the parity job's 2 layers at
# BERT-base's width, f32, 3 steps
LAUNCH_ROW = dict(batch=32, seq=512, warmup=3, steps=8, lr=1e-4)
LAUNCH_PARITY = dict(batch=8, seq=512, layers=2, steps=3, lr=1e-3)
# the parity's tolerances against rank 0's unsharded one-process step on
# its card (f32; the mp reductions run in another order): each loss within
# 1e-4 relative; each parameter within 1e-4 of its largest magnitude plus
# half the learning rate (AdamW moves an element by about lr times the sign
# of its gradient), the k projections' biases (a zero gradient) within 3 lr
# of where they started; each moment within 1e-3 of its largest magnitude
# plus 1e-12
LAUNCH_LOSS_RTOL = 1e-4
LAUNCH_PARAM_SHARE = 1e-4
LAUNCH_MOMENT_SHARE = 1e-3
LAUNCH_TIMEOUT_S = {1: 420, 2: 480, 4: 600}
# the TrainStep step timed in turns with the Engine's at W = 1
LAUNCH_TURNS = 4
LAUNCH_WORKER = """import sys
sys.path.insert(0, {root!r})
import chip_smoke
sys.exit(chip_smoke.launch_worker(sys.argv[1:]))
"""


def _mlm_loss(cfg):
    """The MLM logits' cross entropy (bench.py::bench_bert's loss)."""
    from paddle_tpu_torch.nn import functional as F

    def loss(outs, labels):
        return F.cross_entropy(outs[0].reshape([-1, cfg.vocab_size]),
                               labels.reshape([-1]))
    return loss


def _place_ffn(dist, model, mesh):
    """tests/test_static_engine.py's placements: every encoder FFN weight
    sharded on "mp" (linear1 by columns, linear2 by rows)."""
    for name, p in model.named_parameters():
        if "linear1.weight" in name:
            dist.shard_tensor(p, mesh, [dist.Replicate(), dist.Shard(1)])
        elif "linear2.weight" in name:
            dist.shard_tensor(p, mesh, [dist.Replicate(), dist.Shard(0)])


def _launch_parity(dist, paddle, mesh, rank, dev):
    """2 layers at BERT-base's width (f32, dropout 0), the FFN placed on
    "mp", 3 dist.to_static steps (AdamW); rank 0 then runs the unsharded
    one-process step on its card (forward, backward, a zero gradient for a
    leaf the loss does not reach, as the Engine's step, AdamW) and holds
    the losses and every gathered parameter and moment to it."""
    from paddle_tpu_torch.core.tensor import full_value
    from paddle_tpu_torch.models import bert as TB

    c = LAUNCH_PARITY
    cfg = TB.BertConfig(num_hidden_layers=c["layers"], dropout=0.0)

    def build():
        paddle.seed(0)
        return TB.BertForPretraining(cfg)

    batches = [_pretrain_batch("bert", cfg, c["batch"], c["seq"], seed=i)
               for i in range(c["steps"])]
    model = build()
    start = {k: v.numpy() for k, v in model.state_dict().items()}
    _place_ffn(dist, model, mesh)
    opt = paddle.optimizer.AdamW(learning_rate=c["lr"],
                                 parameters=model.parameters())
    dm = dist.to_static(model, loss=_mlm_loss(cfg), optimizer=opt,
                        mesh=mesh)
    losses = [float(dm(*b).numpy()) for b in batches]
    engine = dm.engine
    params = {k: full_value(v).detach() for k, v in engine._params.items()}
    moments = {k: {sk: full_value(sv) for sk, sv in st.items()}
               for k, st in engine._opt_states.items()}
    out = {"losses": losses}
    if rank != 0:
        return out
    ref = build()
    ropt = paddle.optimizer.AdamW(learning_rate=c["lr"],
                                  parameters=ref.parameters())
    loss_fn = _mlm_loss(cfg)
    ref_losses = []
    for ids, labels in batches:
        loss = loss_fn(ref(ids), labels)
        loss.backward()
        for p in ref.parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p._value)
        ropt.step()
        ropt.clear_grad()
        ref_losses.append(float(loss))
    named = dict(ref.named_parameters())
    lr = c["lr"]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    ratios = {}
    for k, p in named.items():
        r = p._value.detach()
        if "k_proj.bias" in k:
            moved = float((params[k].cpu() - torch.from_numpy(start[k]))
                          .abs().max())
            ratios[k] = moved / (3 * lr)
            continue
        tol = LAUNCH_PARAM_SHARE * float(r.abs().max()) + 0.5 * lr
        ratios[k] = float((params[k] - r).abs().max()) / tol
        st = ropt._accumulators[id(p)]
        for sk, m in st.items():
            tol = LAUNCH_MOMENT_SHARE * float(m.abs().max()) + 1e-12
            ratios[f"{k}.{sk}"] = float((moments[k][sk] - m).abs().max()) \
                / tol
    worst = max(ratios, key=ratios.get)
    out.update(ref_losses=ref_losses, loss_rel=loss_rel,
               worst_ratio=ratios[worst], worst=worst,
               leaves=len(named), held=len(ratios))
    if loss_rel > LAUNCH_LOSS_RTOL or ratios[worst] > 1.0:
        raise AssertionError(f"launch parity: losses {losses} against "
                             f"{ref_losses} (rel {loss_rel:.2e}), worst "
                             f"{worst} at {ratios[worst]:.3f} of its "
                             f"tolerance")
    return out


def _launch_row(dist, paddle, mesh, rank, dev, world):
    """BertForPretraining(BertConfig()) (dropout 0.1) by dist.to_static
    under strategy.amp bf16 over the mesh, the FFN on "mp": the global
    batch of LAUNCH_ROW, warm-up, then timed steps, each held to 12 flash
    forward (D = 64, bf16, dropout 0.1), 12 dK/dV and 12 dQ launches and
    no dense attention on this rank; the peak memory, a profiled step's
    flash, NCCL and copy device ms. At world 1 the TrainStep step of
    phase_pretrain (amp.decorate O2) is timed in turns with it."""
    from paddle_tpu_torch import launch_counts, reset_launch_counts
    from paddle_tpu_torch.models import bert as TB

    c = LAUNCH_ROW
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    paddle.seed(0)
    cfg = TB.BertConfig()
    model = TB.BertForPretraining(cfg)
    n_params = sum(p.size for p in model.parameters())
    _place_ffn(dist, model, mesh)
    opt = paddle.optimizer.AdamW(learning_rate=c["lr"],
                                 parameters=model.parameters())
    strategy = dist.Strategy({"amp": {"enable": True,
                                      "dtype": "bfloat16"}})
    dm = dist.to_static(model, loss=_mlm_loss(cfg), optimizer=opt,
                        strategy=strategy, mesh=mesh)
    ids, labels = _pretrain_batch("bert", cfg, c["batch"], c["seq"], seed=0)
    warm = [float(dm(ids, labels).numpy()) for _ in range(c["warmup"])]
    L = cfg.num_hidden_layers
    expect = {"flash_attention_fwd": L, "flash_attention_bwd_dkv": L,
              "flash_attention_bwd_dq": L, "aligned16_copies": 0}
    want_fwd = [(ATTN_DROPOUT, 64, torch.bfloat16, False, False)] * L
    losses, step_ms = [], []
    reset_launch_counts()
    with _attention_routes() as routes:
        for _ in range(c["steps"]):
            before = launch_counts()
            routes["fwd"].clear()
            torch.cuda.synchronize()
            t = time.perf_counter()
            loss = float(dm(ids, labels).numpy())
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t) * 1e3)
            losses.append(loss)
            per = {k: v - before[k] for k, v in launch_counts().items()}
            for name, n in expect.items():
                if per[name] != n:
                    raise AssertionError(f"launch row: a step launched "
                                         f"{name} {per[name]} times, not {n}")
            if routes["fwd"] != want_fwd or routes["dense"]:
                raise AssertionError(f"launch row: flash forwards "
                                     f"{routes['fwd']}, dense attention "
                                     f"{routes['dense']} times")
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    if not all(np.isfinite(warm + losses)):
        raise AssertionError(f"launch row: losses {warm}, {losses}")
    ms = statistics.median(step_ms)
    tokens = c["batch"] * c["seq"]
    tps_card = tokens / (ms / 1e3) / world
    fpt = model_flops_per_token(cfg, n_params, c["seq"])
    prof = profile_kernels(lambda: dm(ids, labels).numpy())
    by_class = _device_ms_by_class(prof)
    flash = sum(us for k, (n, us) in prof.items() if "flash_" in k) / 1e3
    nccl = sum(us for k, (n, us) in prof.items() if "nccl" in k.lower()) \
        / 1e3
    copy = by_class.get("copy_cast", (0, 0.0))[1]
    out = {"world": world, "mesh": mesh.shape, "batch": c["batch"],
           "seq": c["seq"], "rows_here": c["batch"] // mesh.shape[0],
           "n_params": n_params, "step_ms": step_ms, "step_ms_median": ms,
           "tokens_per_s_per_card": tps_card,
           "share_of_989_tflops": tps_card * fpt / BF16_OPS_PER_S,
           "peak_memory_gb": peak / 1e9, "warmup_losses": warm,
           "losses": losses, "launches_per_step": per, "counts": counts,
           "profiled_step": {"flash_ms": flash, "nccl_ms": nccl,
                             "copy_ms": copy,
                             "device_ms": sum(us for _, us in prof.values())
                             / 1e3,
                             "by_class": by_class}}
    if world == 1:
        out["turns"] = _launch_turns(paddle, dm, cfg, ids, labels)
    return out


def _launch_turns(paddle, dm, cfg, ids, labels):
    """The Engine's step and phase_pretrain's TrainStep step (amp.decorate
    O2 bf16) in turns on this one card: what DTensor's dispatch costs."""
    paddle.seed(0)
    from paddle_tpu_torch.models import bert as TB

    model = paddle.amp.decorate(TB.BertForPretraining(cfg), level="O2",
                                dtype="bfloat16")
    opt = paddle.optimizer.AdamW(learning_rate=LAUNCH_ROW["lr"],
                                 parameters=model.parameters())
    step = _pretrain_step("bert", cfg, model, opt)
    float(step(ids, labels))
    times = {"engine": [], "train_step": []}
    fns = {"engine": lambda: float(dm(ids, labels).numpy()),
           "train_step": lambda: float(step(ids, labels))}
    for _ in range(LAUNCH_TURNS):
        for name, fn in fns.items():
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t) * 1e3)
    med = {k: statistics.median(v) for k, v in times.items()}
    return {"ms": times, "median_ms": med,
            "engine_over_train_step": med["engine"] / med["train_step"]}


def launch_worker(argv):
    """One worker of phase_launch, started by the launcher: NCCL from its
    environment, a dp x mp ProcessMesh over the world, the parity job,
    then the row; its results to <out_dir>/rank<r>.json."""
    import faulthandler

    faulthandler.enable()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out_dir, dp, mp = argv[0], int(argv[1]), int(argv[2])
    import paddle_tpu_torch as paddle
    import paddle_tpu_torch.distributed as dist

    env = dist.init_parallel_env()
    rank, world = env.rank, env.world_size
    dev = torch.device("cuda", torch.cuda.current_device())
    res = {"rank": rank, "world": world, "local_rank": env.local_rank,
           "device": str(dev), "card": torch.cuda.get_device_name(dev),
           "uuid": str(torch.cuda.get_device_properties(dev).uuid),
           "backend": dist.get_backend(),
           "endpoint": env.current_endpoint}
    mesh = dist.ProcessMesh(np.arange(world).reshape(dp, mp),
                            dim_names=["dp", "mp"])
    paddle.set_device(f"gpu:{dev.index}")
    res["parity"] = _launch_parity(dist, paddle, mesh, rank, dev)
    res["row"] = _launch_row(dist, paddle, mesh, rank, dev, world)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()
    return 0


def phase_launch(dev, world, mesh):
    """``python -m paddle_tpu_torch.distributed.launch --nproc_per_node
    world --log_dir <dir> <worker>`` as a user runs it (NCCL, one worker a
    card), each worker running launch_worker over a ``mesh`` = (dp, mp)
    ProcessMesh. Fails if the launcher returns non-zero (every workerlog's
    tail printed), a worker is not on its own card, or a worker's checks
    fail. The parent first lets go of the cached device memory it holds no
    more."""
    import gc

    from paddle_tpu_torch.ops.kernels import _build

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out_dir = tempfile.mkdtemp(dir=_build.BUILD_DIR, prefix="launch-")
    script = os.path.join(out_dir, "launch_worker.py")
    with open(script, "w") as f:
        f.write(LAUNCH_WORKER.format(root=HERE))
    log_dir = os.path.join(out_dir, "log")
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
           "--nproc_per_node", str(world), "--max_restart", "0",
           "--log_dir", log_dir, script, out_dir, str(mesh[0]),
           str(mesh[1])]
    env = dict(os.environ, PYTHONPATH=HERE + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    log(f"launch: world {world}, mesh dp {mesh[0]} x mp {mesh[1]}, parent "
        f"holds {torch.cuda.memory_allocated(dev) / 1e9:.2f} GB; "
        f"{' '.join(cmd[1:6])} ...")
    t0 = time.perf_counter()
    try:
        r = subprocess.run(cmd, cwd=HERE, env=env, capture_output=True,
                           text=True, timeout=LAUNCH_TIMEOUT_S[world])
        wall = time.perf_counter() - t0
        if r.returncode != 0:
            for i in range(world):
                path = os.path.join(log_dir, f"workerlog.{i}")
                tail = open(path).read()[-4000:] if os.path.exists(path) \
                    else "(none)"
                log(f"launch: workerlog.{i} tail:\n{tail}")
            raise AssertionError(f"launch: the launcher returned "
                                 f"{r.returncode}: {r.stderr[-2000:]}")
        ranks = []
        for i in range(world):
            with open(os.path.join(out_dir, f"rank{i}.json")) as f:
                ranks.append(json.load(f))
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    cards = [(w["device"], w["uuid"]) for w in ranks]
    log(f"launch: world {world} ran {wall:.1f} s; workers on " + ", ".join(
        f"{w['rank']}: {w['device']} {w['card']} ({w['backend']}, "
        f"{w['endpoint']})" for w in ranks))
    if sorted(d for d, _ in cards) != sorted(
            f"cuda:{i}" for i in range(world)) or \
            len({u for _, u in cards}) != world:
        raise AssertionError(f"launch: workers not each on their own card: "
                             f"{cards}")
    row = ranks[0]["row"]
    out = {"world": world, "mesh": list(mesh), "wall_s": wall,
           "parity": ranks[0]["parity"],
           "row": {k: v for k, v in row.items() if k != "counts"},
           "step_ms_by_rank": [w["row"]["step_ms_median"] for w in ranks],
           "peak_memory_gb_by_rank": [w["row"]["peak_memory_gb"]
                                      for w in ranks],
           "launches_per_step_by_rank": [
               {k: w["row"]["launches_per_step"][k]
                for k in PRETRAIN_KERNELS} for w in ranks]}
    log(json.dumps({"launch": out}))
    return dict(out, counts=row["counts"],
                launches_per_step=row["launches_per_step"])


# ---------------------------------------------------------------------------
# 6h. vision: ResNet-50 and MNIST LeNet
# ---------------------------------------------------------------------------

# bench.py::bench_resnet50's row on the card, not cut
VISION_ROW = dict(batch=256, size=224, steps=8)
# the card-against-CPU sizes (_vision_parity)
VISION_PARITY = dict(batch=4, size=32, train_size=64)
LENET_FIT = dict(batch_size=64, parity_batches=8)
# card against CPU, f32 with TF32 off (the other training phases' bounds)
VISION_LOSS_RTOL = 1e-4
VISION_GRAD_SHARE = 1e-3
VISION_PARAM_SHARE = 1e-3
VISION_STATS_RTOL = 1e-3
VISION_STATS_ATOL = 1e-5
VISION_R18_STATS_TOL = 1e-5
LENET_LOSS_RTOL = 1e-5
# the ResNet-50 step's device kernels by class (profile phase): each
# kernel is attributed to the op that launched it (the profiler's
# correlation), that op's enclosing ranges (a "vision::<Layer>" range a
# leaf layer's forward, "vision::Momentum" around the optimizer's step)
# and, for the backward, autograd's "evaluate_function: <Node>" range
VISION_LAYER_CLASS = {"Conv2D": "conv_fwd", "BatchNorm2D": "bn",
                      "ReLU": "relu", "MaxPool2D": "pooling",
                      "AdaptiveAvgPool2D": "pooling", "Linear": "fc",
                      "CrossEntropyLoss": "loss", "Momentum": "momentum"}
VISION_BACKWARD_CLASS = (
    ("ConvolutionBackward", "conv_bwd"), ("_BatchNormTrainBackward", "bn"),
    ("ReluBackward", "relu"), ("ThresholdBackward", "relu"),
    ("ClampMinBackward", "relu"), ("AddBackward", "residual_add"),
    ("ToCopyBackward", "amp_cast_copy"), ("MaxPool2DWithIndices", "pooling"),
    ("AdaptiveAvgPool2DBackward", "pooling"), ("MmBackward", "fc"),
    ("AddmmBackward", "fc"), ("MatmulBackward", "fc"))
_COPY_OPS = ("aten::_to_copy", "aten::copy_", "aten::to")


def _vision_kernel_class(chain, kernel):
    """The class of one device kernel launched by the innermost op of
    ``chain`` (the op's name, then its enclosing ops' and ranges')."""
    if "nchwToNhwc" in kernel or "nhwcToNchw" in kernel:
        return "layout_transpose"
    node = next((n.split("evaluate_function: ", 1)[1] for n in chain
                 if "evaluate_function: " in n), None)
    if node is not None:
        cls = next((c for sub, c in VISION_BACKWARD_CLASS if sub in node),
                   "loss_other_backward")
    else:
        label = next((n.split("::", 1)[1] for n in chain
                      if n.startswith("vision::")), None)
        cls = VISION_LAYER_CLASS.get(label, "residual_add"
                                     if chain[0] == "aten::add" else "other")
        if cls != "momentum" and chain[0] in _COPY_OPS:
            cls = "amp_cast_copy"
    if cls == "bn":
        cls = "bn_reduce" if "reduce_kernel" in kernel else "bn_elementwise"
    elif cls == "conv_bwd":
        cls = "conv_dgrad" if "dgrad" in kernel else "conv_wgrad" \
            if "wgrad" in kernel else "conv_bwd_gemm"
    return cls


def _vision_profile(step, model, opt):
    """{class: (launches, device ms)} of one profiled ``step``, each
    leaf layer's forward inside a "vision::<class name>" range and the
    optimizer's step inside "vision::Momentum"; the device ms the ops
    claimed, and the step's device ms in all. The profiler's first
    records are padded as profile_kernels pads them."""
    from torch.autograd.profiler import record_function
    from torch.profiler import ProfilerActivity, profile

    ranges, hooks = [], []

    def pre(layer, inputs):
        r = record_function(f"vision::{type(layer).__name__}")
        r.__enter__()
        ranges.append(r)

    def post(layer, inputs, out):
        ranges.pop().__exit__(None, None, None)

    for layer in model.sublayers():
        if type(layer).__name__ in VISION_LAYER_CLASS:
            hooks += [layer.register_forward_pre_hook(pre),
                      layer.register_forward_post_hook(post)]
    inner = opt.step

    def opt_step():
        with record_function("vision::Momentum"):
            inner()

    opt.step = opt_step
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILE_PAD_LAUNCHES):
                torch.cuda._sleep(1)
            step()
            torch.cuda.synchronize()
    finally:
        del opt.step
        for h in hooks:
            h.remove()
    out, claimed = {}, 0.0
    for evt in prof.events():
        if not evt.kernels:
            continue
        chain, e = [], evt
        while e is not None:
            chain.append(e.name)
            e = e.cpu_parent
        for k in evt.kernels:
            if "spin_kernel" in k.name:
                continue
            cls = _vision_kernel_class(chain, k.name)
            n, ms = out.get(cls, (0, 0.0))
            out[cls] = (n + 1, ms + k.duration / 1e3)
            claimed += k.duration / 1e3
    total = sum(evt.self_device_time_total for evt in prof.key_averages()
                if _is_device_kernel_row(evt)
                and "spin_kernel" not in evt.key) / 1e3
    return dict(sorted(out.items(), key=lambda kv: -kv[1][1])), claimed, \
        total


def _forward_flops(paddle, model, size):
    """2 x the multiply-adds of one image's forward at ``size``, from the
    model's own conv and fc shapes (forward post hooks on every Conv2D
    and Linear, one eval forward of a batch of 1)."""
    macs = []

    def hook(layer, inputs, out):
        if isinstance(layer, paddle.nn.Conv2D):
            k = layer.weight.shape
            macs.append(out.size * k[1] * k[2] * k[3])
        else:
            macs.append(layer.weight.shape[0] * layer.weight.shape[1])

    hooks = [l.register_forward_post_hook(hook)
             for l in model.sublayers()
             if isinstance(l, (paddle.nn.Conv2D, paddle.nn.Linear))]
    model.eval()
    with paddle.no_grad():
        model(paddle.to_tensor(np.zeros((1, 3, size, size), np.float32)))
    model.train()
    for h in hooks:
        h.remove()
    return 2 * sum(macs), len(macs)


def _zero_kernel_counts(counts, what):
    """The port's hand-written kernels must not launch on a vision path
    (the counters stay 0, so nothing else is timed by mistake)."""
    bad = {k: v for k, v in counts.items() if v}
    if bad:
        raise AssertionError(f"{what}: hand-written kernels launched {bad}")


def phase_vision(dev):
    """The vision slice on the card. ResNet-50 as bench.py::bench_resnet50
    writes it, at full size: resnet50(num_classes=1000) from seed 0,
    amp.decorate O2 bf16 (batch norms f32), Momentum(0.1, 0.9),
    TrainStep with CrossEntropyLoss, each step under auto_cast O1 bf16,
    batch 256 x 3 x 224 x 224 from RandomState(0) staged once on the card;
    a warm-up, then VISION_ROW["steps"] timed steps (step ms median,
    fastest and slowest, images/s, the share of 989 TF/s from the model's
    own conv and fc FLOPs x 3, peak memory over the phase's start, the
    losses, finite); the hand-written kernels' counters stay 0. Then MNIST
    LeNet through paddle_tpu_torch.Model: prepare(Adam(1e-3),
    CrossEntropyLoss(), Accuracy()), fit(vision.datasets.MNIST("train"),
    batch_size=64, epochs=1, verbose=0) (4096 synthetic samples, data on
    the host, the model on the card; wall s, samples/s, ms a batch, the
    last loss), then evaluate(MNIST("test")). Then the card against the
    CPU (_vision_parity). Device busy shares and the step's device ms by
    kernel class come from the profile phase."""
    import gc

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import launch_counts, reset_launch_counts
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.vision.models import LeNet, resnet50

    b, size, steps = (VISION_ROW[k] for k in ("batch", "size", "steps"))
    paddle.set_device("gpu:0")
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    start = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    paddle.seed(0)
    model = resnet50(num_classes=1000)
    fwd_flops, n_layers = _forward_flops(paddle, model, size)
    model = paddle.amp.decorate(model, level="O2", dtype="bfloat16")
    dtypes = {(type(l).__name__ == "BatchNorm2D", p.dtype)
              for l in model.sublayers(include_self=True)
              for p in l._parameters.values() if p is not None}
    if dtypes != {(True, torch.float32), (False, torch.bfloat16)}:
        raise AssertionError(f"resnet50: O2 parameter dtypes {dtypes}")
    opt = paddle.optimizer.Momentum(parameters=model.parameters(),
                                    learning_rate=0.1, momentum=0.9)
    train_step = TrainStep(model, paddle.nn.CrossEntropyLoss(), opt)
    rng = np.random.RandomState(0)
    x = paddle.to_tensor(rng.randn(b, 3, size, size).astype(np.float32))
    y = paddle.to_tensor(rng.randint(0, 1000, (b,)).astype(np.int64))

    def step():
        with paddle.amp.auto_cast(True, level="O1", dtype="bfloat16"):
            return train_step(x, y)

    n_params = sum(p.size for p in model.parameters())
    t = time.perf_counter()
    warm = float(step())
    log(f"resnet50: {n_params / 1e6:.2f}M parameters, {n_layers} conv/fc "
        f"layers, {fwd_flops / 1e9:.3f} GFLOP a 224 image forward; warm-up "
        f"step {time.perf_counter() - t:.2f} s, loss {warm:.4f}")
    reset_launch_counts()
    losses, step_ms = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss = step()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        losses.append(float(loss))
    counts = launch_counts()
    _zero_kernel_counts(counts, "resnet50")
    peak = torch.cuda.max_memory_allocated(dev)
    if not all(np.isfinite([warm] + losses)):
        raise AssertionError(f"resnet50 losses not finite: {warm} {losses}")
    ms = statistics.median(step_ms)
    ips = b / (ms / 1e3)
    step_flops = 3 * fwd_flops * b
    metrics = {"batch": b, "image_size": size, "steps": steps,
               "n_params": n_params, "step_ms": step_ms,
               "step_ms_median": ms, "step_ms_min": min(step_ms),
               "step_ms_max": max(step_ms), "images_per_s": ips,
               "forward_flops_per_image": fwd_flops,
               "train_flops_per_step": step_flops,
               "share_of_989_tflops": step_flops / (ms / 1e3)
               / BF16_OPS_PER_S,
               "warmup_loss": warm, "losses": losses,
               "peak_memory_gb": peak / 1e9,
               "peak_over_start_gb": (peak - start) / 1e9,
               "hand_written_kernel_launches": counts}
    log(json.dumps({"resnet50": metrics}))

    # MNIST LeNet through Model: host data, the model on the card
    paddle.seed(0)
    lenet = paddle.Model(LeNet())
    lenet.prepare(paddle.optimizer.Adam(learning_rate=1e-3,
                                        parameters=lenet.parameters()),
                  paddle.nn.CrossEntropyLoss(), paddle.metric.Accuracy())
    train = paddle.vision.datasets.MNIST(mode="train")
    seen = []
    record = type("Record", (paddle.callbacks.Callback,), {
        "on_train_batch_end": lambda s, i, logs=None:
        seen.append(logs["loss"])})()
    reset_launch_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    lenet.fit(train, batch_size=LENET_FIT["batch_size"], epochs=1,
              verbose=0, callbacks=[record])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    logs = lenet.evaluate(paddle.vision.datasets.MNIST(mode="test"),
                          batch_size=LENET_FIT["batch_size"], verbose=0)
    _zero_kernel_counts(launch_counts(), "lenet fit")
    if not (len(seen) == len(train) // LENET_FIT["batch_size"]
            and np.isfinite(seen).all() and np.isfinite(logs["loss"])):
        raise AssertionError(f"lenet fit: {len(seen)} batches, {logs}")
    if lenet.network.parameters()[0]._value.device.type != "cuda":
        raise AssertionError("lenet: the model is not on the card")
    lenet_metrics = {"samples": len(train), "batches": len(seen),
                     "fit_wall_s": wall,
                     "samples_per_s": len(train) / wall,
                     "ms_per_batch": wall / len(seen) * 1e3,
                     "first_loss": seen[0], "last_loss": seen[-1],
                     "eval": {k: float(v) for k, v in logs.items()}}
    log(json.dumps({"lenet_fit": lenet_metrics}))
    parity = _vision_parity(dev)
    return dict(metrics=metrics, lenet=lenet_metrics, parity=parity,
                step=step, model=model, opt=opt, lenet_model=lenet,
                lenet_data=train)


def _vision_state(layer):
    return {k: v._value.detach().cpu().clone()
            for k, v in layer.state_dict().items()}


def _vision_share(got, want):
    got, want = got.double().cpu(), want.double().cpu()
    return float((got - want).abs().max()
                 / max(float(want.abs().max()), 1e-30))


def _resnet_on(paddle, device, state, depth=50):
    from paddle_tpu_torch.vision import models

    paddle.set_device(device)
    m = getattr(models, f"resnet{depth}")(num_classes=10)
    m.set_state_dict(state)
    return m


def _vision_grads(paddle, model, x, y, train):
    model.train() if train else model.eval()
    loss = paddle.nn.CrossEntropyLoss()(model(paddle.to_tensor(x)),
                                        paddle.to_tensor(y))
    loss.backward()
    grads = {n: p.grad._value.detach().cpu().clone()
             for n, p in model.named_parameters()}
    model.clear_gradients()
    return float(loss), grads


def _vision_steps(paddle, model, x, y, train, steps):
    """``steps`` Momentum TrainStep steps: the losses, the state after
    them, and the velocities after the first (its gradients: no decay)."""
    from paddle_tpu_torch.jit import TrainStep

    opt = paddle.optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                                    parameters=model.parameters())
    step = TrainStep(model, paddle.nn.CrossEntropyLoss(), opt, train=train)
    names = {id(p): n for n, p in model.named_parameters()}
    losses, grads = [], None
    for _ in range(steps):
        losses.append(float(step(paddle.to_tensor(x), paddle.to_tensor(y))))
        if grads is None:
            grads = {names[id(p)]: opt._accumulators[id(p)]["velocity"]
                     .cpu().clone() for p in opt._parameter_list}
    return losses, _vision_state(model), grads


def _vision_parity(dev):
    """The card against the CPU, f32 with TF32 off. ResNet-50
    (num_classes=10) from one seed at batch 4 x 32 x 32 with its batch
    norms on their running statistics: the loss within 1e-4 relative,
    every gradient within 1e-3 of its leaf's largest magnitude, and after
    2 Momentum TrainStep steps (train=False) the losses, every parameter
    within 1e-3 of its largest magnitude and the buffers unchanged. On
    batch statistics a freshly drawn ResNet-50's f32 gradients are
    ill-conditioned (tools/torch_vision_conditioning.py on the CPU, f32
    against float64: 54% and 14% of a leaf's largest magnitude at the
    worst leaf, batch 4 at 32 x 32 and 64 x 64), so its train-mode step at
    batch 4 x 64 x 64 holds the loss (1e-4 relative) and the running
    statistics it leaves (1e-3 relative, 1e-5 absolute); and ResNet-18,
    the family's BasicBlock member, takes the train-mode bounds at batch
    4 x 64 x 64 for one Momentum step (f32 within 6.2e-6 of float64 there;
    2.0e-3 after a second step of lr 0.1): the loss within 1e-4
    relative, every gradient (the step's velocities) within 1e-3 of its
    leaf's largest magnitude, every parameter after it within 1e-3 and
    the running statistics within 1e-5 (relative and absolute).
    LeNet: the per-batch losses of 8
    batches of Model.fit(shuffle=False) from the same weights within
    1e-5 relative. The CPU passes run on one thread (one_cpu_thread), the
    card's ResNet passes under ``cudnn.deterministic`` (restored after):
    with the algorithms cuDNN picks by default, 1 of 4 repeats of the
    2-step check put layer3.2.bn1.bias 1.4e-3 of its largest magnitude
    off, every other repeat and every repeat with deterministic
    algorithms or without cuDNN 1e-6 (tools/torch_vision_probe.py
    steps)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.vision.models import LeNet, resnet18, resnet50

    bsz, size, tsize = (VISION_PARITY[k] for k in
                        ("batch", "size", "train_size"))
    rng = np.random.RandomState(1)
    x = rng.randn(bsz, 3, size, size).astype(np.float32)
    y = rng.randint(0, 10, (bsz,)).astype(np.int64)
    xt = rng.randn(bsz, 3, tsize, tsize).astype(np.float32)
    yt = rng.randint(0, 10, (bsz,)).astype(np.int64)
    paddle.set_device("cpu")
    paddle.seed(3)
    state = _vision_state(resnet50(num_classes=10))
    state18 = _vision_state(resnet18(num_classes=10))
    out, worst = {}, {}

    def runs(device):
        return {"eval": _vision_grads(
            paddle, _resnet_on(paddle, device, state), x, y, False),
            "steps": _vision_steps(paddle, _resnet_on(
                paddle, device, state), x, y, False, 2),
            "train": _vision_steps(paddle, _resnet_on(
                paddle, device, state), xt, yt, True, 1),
            "r18": _vision_steps(paddle, _resnet_on(
                paddle, device, state18, 18), xt, yt, True, 1)}

    deterministic = torch.backends.cudnn.deterministic
    try:
        with one_cpu_thread():
            cpu = runs("cpu")
        torch.backends.cudnn.deterministic = True
        card = runs("gpu:0")
    finally:
        torch.backends.cudnn.deterministic = deterministic
        paddle.set_device("gpu:0")
    (cl, cg), (gl, gg) = cpu["eval"], card["eval"]
    out["eval_loss_rel"] = abs(gl - cl) / abs(cl)
    worst["eval_grad"] = max((_vision_share(gg[k], v), k)
                             for k, v in cg.items())
    (cls, cs, _), (gls, gs, _) = cpu["steps"], card["steps"]
    out["steps_loss_rel"] = max(abs(a - c) / abs(c)
                                for a, c in zip(gls, cls))
    worst["steps_param"] = max((_vision_share(gs[k], v), k)
                               for k, v in cs.items()
                               if not k.endswith(("_mean", "_variance")))
    buffers_kept = all(torch.equal(gs[k], state[k]) for k in state
                       if k.endswith(("_mean", "_variance")))

    def stats_off(got, want, rtol, atol):
        return [k for k, v in want.items()
                if k.endswith(("_mean", "_variance")) and not torch.allclose(
                    got[k].double(), v.double(), rtol=rtol, atol=atol)]

    (tl, ts, _), (gtl, gts, _) = cpu["train"], card["train"]
    out["train_loss_rel"] = abs(gtl[0] - tl[0]) / abs(tl[0])
    stats_bad = stats_off(gts, ts, VISION_STATS_RTOL, VISION_STATS_ATOL)
    (rl, rs, rg), (grl, grs, grg) = cpu["r18"], card["r18"]
    out["r18_loss_rel"] = abs(grl[0] - rl[0]) / abs(rl[0])
    worst["r18_grad"] = max((_vision_share(grg[k], v), k)
                            for k, v in rg.items())
    worst["r18_param"] = max((_vision_share(grs[k], v), k)
                             for k, v in rs.items()
                             if not k.endswith(("_mean", "_variance")))
    worst["r18_stats"] = max((_vision_share(grs[k], v), k)
                             for k, v in rs.items()
                             if k.endswith(("_mean", "_variance")))
    r18_stats_bad = stats_off(grs, rs, VISION_R18_STATS_TOL,
                              VISION_R18_STATS_TOL)

    # LeNet: 8 batches of fit, shuffle off, from the same weights
    paddle.set_device("cpu")
    paddle.seed(5)
    lstate = _vision_state(LeNet())
    lenet_losses = {}
    try:
        for device in ("cpu", "gpu:0"):
            paddle.set_device(device)
            net = LeNet()
            net.set_state_dict(lstate)
            model = paddle.Model(net)
            model.prepare(paddle.optimizer.Adam(
                learning_rate=1e-3, parameters=model.parameters()),
                paddle.nn.CrossEntropyLoss())
            seen = []
            record = type("Record", (paddle.callbacks.Callback,), {
                "on_train_batch_end": lambda s, i, logs=None:
                seen.append(logs["loss"])})()
            ctx = one_cpu_thread() if device == "cpu" else \
                contextlib.nullcontext()
            with ctx:
                model.fit(paddle.vision.datasets.MNIST(mode="train"),
                          batch_size=LENET_FIT["batch_size"], epochs=1,
                          verbose=0, shuffle=False, callbacks=[record],
                          num_iters=LENET_FIT["parity_batches"])
            lenet_losses[device] = seen
    finally:
        paddle.set_device("gpu:0")
    out["lenet_loss_rel"] = max(
        abs(a - c) / abs(c) for a, c in zip(lenet_losses["gpu:0"],
                                            lenet_losses["cpu"]))
    out["worst"] = {k: {"share": v[0], "leaf": v[1]}
                    for k, v in worst.items()}
    log(json.dumps({"vision_parity": out}))
    fails = []
    if out["eval_loss_rel"] > VISION_LOSS_RTOL:
        fails.append("eval loss")
    if worst["eval_grad"][0] > VISION_GRAD_SHARE:
        fails.append(f"gradient {worst['eval_grad']}")
    if out["steps_loss_rel"] > VISION_LOSS_RTOL:
        fails.append("step losses")
    if worst["steps_param"][0] > VISION_PARAM_SHARE:
        fails.append(f"parameter {worst['steps_param']}")
    if not buffers_kept:
        fails.append("running statistics moved with train=False")
    if out["train_loss_rel"] > VISION_LOSS_RTOL:
        fails.append("train-mode loss")
    if stats_bad:
        fails.append(f"running statistics {stats_bad[:4]}")
    if out["r18_loss_rel"] > VISION_LOSS_RTOL:
        fails.append("resnet18 loss")
    if worst["r18_grad"][0] > VISION_GRAD_SHARE:
        fails.append(f"resnet18 gradient {worst['r18_grad']}")
    if worst["r18_param"][0] > VISION_PARAM_SHARE:
        fails.append(f"resnet18 parameter {worst['r18_param']}")
    if r18_stats_bad:
        fails.append(f"resnet18 running statistics {r18_stats_bad[:4]}")
    if len(lenet_losses["gpu:0"]) != LENET_FIT["parity_batches"] or \
            out["lenet_loss_rel"] > LENET_LOSS_RTOL:
        fails.append(f"lenet losses {lenet_losses}")
    if fails:
        raise AssertionError(f"vision parity: {fails}")
    return out


KERNEL_CLASSES = (
    ("attention", ("flash_", "varlen_")),
    ("gemm", ("nvjet", "gemm", "cutlass", "xmma", "sm90_")),
    ("embedding_backward", ("embedding_backward", "indexing_backward",
                            "compute_grad_weight", "sum_and_scatter")),
    ("copy_cast", ("direct_copy", "Memcpy", "copy_kernel")),
    ("optimizer", ("multi_tensor_apply",)),
    ("layer_norm", ("layer_norm", "LayerNorm")),
    ("softmax_loss", ("softmax", "nll_loss", "cross_entropy")),
    ("random", ("distribution", "philox")),
    ("reduce", ("reduce_kernel",)),
    ("elementwise", ("elementwise",)),
)


def _device_ms_by_class(prof):
    """{class: (launches, device ms)} of one profiled step by
    KERNEL_CLASSES, "other" for the rest."""
    out = {}
    for key, (n, us) in prof.items():
        cls = next((c for c, subs in KERNEL_CLASSES
                    if any(sub in key for sub in subs)), "other")
        launches, ms = out.get(cls, (0, 0.0))
        out[cls] = (launches + n, ms + us / 1e3)
    return dict(sorted(out.items(), key=lambda kv: -kv[1][1]))


def _kernels_a_step(prof, steps):
    """Device kernels (and copies) a step of a profile over ``steps``."""
    return sum(n for n, _ in prof.values()) / steps


def phase_profile(dev, serving, training, packed, kernels, probes, int8,
                  stream, artifact, eager, pretrain, vision):
    """Under torch.profiler, last (the profiler stays attached to the
    process once started, and would slow what follows): each kernel's
    device time, and the device time of one fresh-prefill step, of one
    16-step decode window at batch 8, of one training step and of one
    packed training step, beside the wall times of the unprofiled runs —
    the device's busy share and its top kernels. The profiled decode
    window's replays must show the RMSNorm, paged-attention and
    RoPE-and-append kernels launched 2L + 1, L and L times a step on the
    device, as many as the counters added for the replays; the int8
    engine's, its paged-attention and RoPE-and-append kernels L times a
    step; each weight-streaming engine's, its dequant and RoPE-and-append
    kernels L times a step (_profiled_window); the artifact engine's,
    RMSNorm 2L + 1, paged attention and RoPE-and-append L times a step and
    the varlen forward never. Each decode window's device kernels a step,
    in all, are logged. A probe with no kernel symbol (a
    composition of tensor ops) records its device kernels a call too. The
    ResNet-50 step's device ms by kernel class (_vision_profile) and busy
    share, and the LeNet fit's busy share (a second epoch profiled against
    the first's wall time)."""
    from paddle_tpu_torch.inference import ServingEngine

    for name, (fn, symbol, calls, target) in probes.items():
        kernels = []
        target["device_ms"] = kernel_device_ms(fn, symbol, calls, kernels)
        if symbol is None:
            target["device_kernels_a_call"] = kernels[0]
        log(f"{name}: {target['device_ms']} ms on the device, "
            f"{kernels[0]} device kernels a call")
    model, cfg = serving["model"], serving["cfg"]
    prompts, sampling = serving["prompts"], serving["sampling"]
    metrics = serving["metrics"]

    def summary(kernels, per):
        total = sum(us for _, us in kernels.values()) / 1e3 / per
        log(f"profile: {sum(n for n, _ in kernels.values()) / per} device "
            f"kernels, {total:.4f} ms of device time a step")
        top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:6]
        return total, [{"kernel": k[:70], "launches": n // per,
                        "ms": us / 1e3 / per} for k, (n, us) in top]

    eng = ServingEngine.from_model(model, cfg, seed=7, device=dev)
    for i, p in enumerate(prompts[:2]):
        eng.add_request(p, max_new_tokens=40, sampling=sampling[i])
    fresh_ms, fresh_top = summary(profile_kernels(eng.step), 1)
    for i, p in enumerate(prompts[2:]):
        eng.add_request(p, max_new_tokens=40, sampling=sampling[2 + i])
    L = cfg.num_layers

    def launched(dec, names):
        return {name: sum(n for key, (n, _) in dec.items()
                          if any(f"::{sym}<" in key for sym in syms))
                for name, syms in names}

    want = {"rms_norm": (2 * L + 1) * 16, "paged_attention": L * 16,
            "rope_append": L * 16}
    dec, seen, counted = _profiled_window(
        eng, prompts, sampling, "bf16", want, ready=True,
        seen_of=lambda d: launched(d, (
            ("rms_norm", ("rms_norm_kernel", "rms_norm_two_pass_kernel")),
            ("paged_attention", ("paged_attention_tc_kernel",)),
            ("rope_append", ("rope_append_kernel",)))))
    if any(counted[k] != n for k, n in want.items()):
        raise AssertionError(f"profile: 16 decode replays launched {seen} "
                             f"on the device and counted {counted}, not "
                             f"{want}")
    log(f"profile: 16 decode replays launched {seen} on the device, as "
        f"counted")
    dec_ms, dec_top = summary(dec, 16)
    # the int8 engine's decode window (its graph exists from the int8
    # phase)
    dec8, _, _ = _profiled_window(
        int8["engine"], prompts, sampling, "int8",
        {"paged_attention_int8": L * 16, "rope_append": L * 16,
         "kv_quant": 0},
        seen_of=lambda d: launched(d, (
            ("paged_attention_int8", ("paged_attention_tc_kernel",)),
            ("rope_append", ("rope_append_kernel",)),
            ("kv_quant", ("kv_quant_kernel",)))))
    dec8_ms, dec8_top = summary(dec8, 16)
    # each weight-streaming engine's decode window, as the int8 engine's
    stream_prof = {}
    for ws, eng_s in stream["engines"].items():
        dec_s, _, _ = _profiled_window(
            eng_s, prompts, sampling, ws,
            {"weight_dequant": L * 16, "rope_append": L * 16},
            seen_of=lambda d: launched(d, (
                ("weight_dequant", ("weight_dequant_kernel",)),
                ("rope_append", ("rope_append_kernel",)))))
        ms_s, top_s = summary(dec_s, 16)
        dequant_ms = sum(us for key, (_, us) in dec_s.items()
                         if "weight_dequant_kernel<" in key) / 1e3 / 16
        step_ms = stream["metrics"][ws]["decode_ms_per_step"]
        stream_prof[ws] = {"decode_step_device_ms": ms_s,
                           "decode_device_kernels_a_step":
                           _kernels_a_step(dec_s, 16),
                           "decode_device_busy": ms_s / step_ms,
                           "dequant_device_ms_per_step": dequant_ms,
                           "decode_top": top_s}
    # the artifact engine's decode window: the program's call replayed
    dec_a, seen_a, _ = _profiled_window(
        artifact["engine"], prompts, sampling, "artifact",
        {"rms_norm": (2 * L + 1) * 16, "paged_attention": L * 16,
         "rope_append": L * 16, "varlen_attention_fwd": 0},
        seen_of=lambda d: launched(d, (
            ("rms_norm", ("rms_norm_kernel", "rms_norm_two_pass_kernel")),
            ("paged_attention", ("paged_attention_tc_kernel",)),
            ("rope_append", ("rope_append_kernel",)),
            ("varlen_attention_fwd", ("varlen_fwd_kernel",)))))
    log(f"profile: 16 artifact decode replays launched {seen_a} on the "
        f"device")
    art_ms, art_top = summary(dec_a, 16)
    art_step_ms = artifact["metrics"]["decode_ms_per_step"]
    trainer, tm = training["trainer"], training["metrics"]
    train_ms, train_top = summary(profile_kernels(
        lambda: trainer.step(training["ids"], training["labels"])), 1)
    em = eager["metrics"]
    eager_ms, eager_top = summary(profile_kernels(lambda: _eager_step(
        eager["model"], eager["opt"], eager["ids"], eager["labels"])), 1)
    gen_ms, gen_top = summary(profile_kernels(
        lambda: eager["model"].generate(eager["prompt"], max_new_tokens=16)),
        1)
    eager["model"].train()
    pretrain_prof = {}
    for kind, r in pretrain.items():
        prof_k = profile_kernels(lambda: r["step"](r["ids"], r["labels"]))
        ms_k, top_k = summary(prof_k, 1)
        pretrain_prof[kind] = {
            "step_device_ms": ms_k,
            "device_busy": ms_k / r["metrics"]["step_ms_median"],
            "device_ms_by_class": _device_ms_by_class(prof_k),
            "top": top_k}
        log(f"profile: {kind} step device ms by kernel class "
            f"{pretrain_prof[kind]['device_ms_by_class']}")
    pm = packed["metrics"]
    packed_ms, packed_top = summary(profile_kernels(packed["step"]), 1)
    vm = vision["metrics"]
    prof_v = profile_kernels(vision["step"])
    resnet_ms, resnet_top = summary(prof_v, 1)
    classes, claimed, total = _vision_profile(
        vision["step"], vision["model"], vision["opt"])
    log(f"profile: resnet50 step device ms by kernel class {classes} "
        f"({claimed:.3f} of {total:.3f} ms attributed to an op)")
    lm = vision["lenet"]
    prof_l = profile_kernels(lambda: vision["lenet_model"].fit(
        vision["lenet_data"], batch_size=LENET_FIT["batch_size"], epochs=1,
        verbose=0))
    lenet_ms, lenet_top = summary(prof_l, 1)
    prof = {
        "resnet50": {"step_device_ms": resnet_ms,
                     "device_busy": resnet_ms / vm["step_ms_median"],
                     "device_kernels_a_step": _kernels_a_step(prof_v, 1),
                     "device_ms_by_class": classes,
                     "attributed_ms": claimed, "top": resnet_top},
        "lenet_fit": {"fit_device_ms": lenet_ms,
                      "device_busy": lenet_ms / (lm["fit_wall_s"] * 1e3),
                      "top": lenet_top},
        "pretrain": pretrain_prof,
        "eager_training_step_device_ms": eager_ms,
        "eager_training_device_busy": eager_ms / em["step_ms_median"],
        "eager_training_top": eager_top,
        "eager_generate_device_ms": gen_ms,
        "eager_generate_device_busy": gen_ms / em["generate"]["ms_all"],
        "eager_generate_top": gen_top,
        "packed_training_step_device_ms": packed_ms,
        "packed_training_device_busy": packed_ms / pm["step_ms_median"],
        "packed_training_top": packed_top,
        "training_step_device_ms": train_ms,
        "training_device_busy": train_ms / tm["step_ms_median"],
        "training_top": train_top,
        "fresh_prefill_step_device_ms": fresh_ms,
        "fresh_prefill_device_busy": fresh_ms
        / metrics["fresh_prefill_step_ms"],
        "fresh_prefill_top": fresh_top,
        "decode_step_device_ms": dec_ms,
        "decode_device_kernels_a_step": _kernels_a_step(dec, 16),
        "decode_device_busy": dec_ms / metrics["decode_ms_per_step"],
        "decode_device_busy_all_in": dec_ms
        / metrics["decode_ms_per_step_all_in"],
        "decode_top": dec_top,
        "int8_decode_step_device_ms": dec8_ms,
        "int8_decode_device_kernels_a_step": _kernels_a_step(dec8, 16),
        "int8_decode_device_busy": dec8_ms
        / int8["metrics"]["decode_ms_per_step"],
        "int8_decode_top": dec8_top,
        "weight_stream_decode": stream_prof,
        "artifact_decode_step_device_ms": art_ms,
        "artifact_decode_device_kernels_a_step": _kernels_a_step(dec_a, 16),
        "artifact_decode_device_busy": art_ms / art_step_ms,
        "artifact_decode_top": art_top,
    }
    log(json.dumps({"profile": prof}))
    return prof


def _kv_quant_inputs(dev, cfg, T, dtype, gen):
    """kv_quant's inputs at the serving config's widths for a step of T
    tokens: k [T, HKV, D] contiguous (as RoPE leaves it) and v a view of
    the packed qkv, token 0's k head 0 all zero (scale 1e-8) and token 1's
    a tie head (max 127, so the scale is 1, values n + 0.5, each x / s a
    tie); each token on its own (page, slot), none on the trash page; the
    engine's zeroed stacked int8 pools and f32 scale pools."""
    HQ, HKV, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    L, NB, bs = cfg.num_layers, cfg.num_blocks, cfg.block_size
    qkv = (torch.randn(T, (HQ + 2 * HKV) * D, device=dev, generator=gen)
           * torch.exp(torch.randn(T, 1, device=dev, generator=gen)))
    qkv = qkv.to(dtype)
    k = qkv[:, HQ * D:(HQ + HKV) * D].reshape(T, HKV, D).contiguous()
    v = qkv[:, (HQ + HKV) * D:].reshape(T, HKV, D)
    k[0, 0] = 0
    k[1, 0] = (torch.arange(D, device=dev) % 9 + 0.5).to(dtype)
    k[1, 0, 0] = 127
    idx = torch.randperm((NB - 1) * bs, device=dev, generator=gen)[:T]
    page, slot = 1 + idx // bs, idx % bs
    pools = [torch.zeros(L, NB, HKV, bs, D, dtype=torch.int8, device=dev)
             for _ in range(2)]
    pools += [torch.zeros(L, NB, HKV, bs, device=dev) for _ in range(2)]
    return k, v, pools, page, slot


def phase_int8_kernels(dev, results, probes, serving):
    """The int8 cache-KV path's two kernels against their plain versions at
    the serving config's widths, then timed.

    kv_quant at the decode shape (8 tokens) and the 256-token step, bf16
    and f32 inputs: codes and scales bit for bit (a tie head and an all-zero
    head included); timed in turns with its plain version (no single
    PyTorch call computes it: library null). paged_attention_int8 at the
    float kernel's three shapes (8 decode rows at the serving phase's decode
    positions; PAGED_SHAPES' 256-token chunked step and speculative verify
    step), bf16 and f32 q, within the float kernel's
    tolerance of its plain version and bit for bit equal to the float
    kernel over pages of q's dtype that hold the same dequantized values;
    then timed in turns with that bf16 kernel on the same rows and with SDPA
    on the dequantized gathered view (the gather not timed), each call on
    the next layer's pools, as in a decode step."""
    from paddle_tpu_torch.ops.kernels import kv_quant as KQ
    from paddle_tpu_torch.ops.kernels import paged_attention as PA

    cfg = serving["cfg"]
    L = cfg.num_layers
    gen = torch.Generator(device=dev).manual_seed(23)
    HQ, HKV, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    # -- kv_quant
    kq_err, kq_rows, kq_calls = 0.0, {}, {}
    for label, T in (("decode", 8), ("step", cfg.token_budget)):
        for dtype in (torch.bfloat16, torch.float32):
            k, v, pools, page, slot = _kv_quant_inputs(dev, cfg, T, dtype,
                                                       gen)
            ref = [p.clone() for p in pools]
            KQ.kv_quant(k, v, *pools, L - 1, page, slot)
            KQ._kv_quant_ref(k, v, *ref, L - 1, page, slot)
            torch.cuda.synchronize()
            equal = all(torch.equal(a, b) for a, b in zip(pools, ref))
            sk = ref[2][L - 1].transpose(1, 2)[page, slot]     # [T, HKV]
            ties = int(((k.float() / sk[..., None]).frac().abs()
                        == 0.5).sum())
            zero = float(sk[0, 0])
            tie_scale = float(sk[1, 0])
            ok = equal and zero == float(np.float32(1e-8)) \
                and tie_scale == 1.0 and ties > 0
            log(f"kv_quant {label} T={T} {dtype}: codes and scales "
                f"{'bit for bit' if equal else 'DIFFER'} against the plain "
                f"version; {ties} elements at x/s = n + 0.5 exactly; zero "
                f"head's scale {zero:.3g}, tie head's {tie_scale} "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError("kv_quant kernel disagrees with its "
                                     "plain version")
            if dtype == torch.bfloat16:            # the serving dtype
                turn = [0]

                def call(k=k, v=v, pools=pools, page=page, slot=slot):
                    turn[0] = (turn[0] + 1) % L
                    KQ.kv_quant(k, v, *pools, turn[0], page, slot)

                def plain(k=k, v=v, pools=pools, page=page, slot=slot):
                    turn[0] = (turn[0] + 1) % L
                    KQ._kv_quant_ref(k, v, *pools, turn[0], page, slot)

                n_el = 2 * T * HKV * D
                b, by = bound(nbytes(k, v) + n_el + 2 * T * HKV * 4
                              + nbytes(page, slot), 6 * n_el,
                              F32_OPS_PER_S)
                turns = time_ms_turns({"ms": call, "plain_ms": plain})
                kq_rows[label] = dict(
                    shape=f"k, v [{T}, {HKV}, {D}] bf16 (v a view of the "
                          f"packed qkv) into int8 pools [{L}, "
                          f"{cfg.num_blocks}, {HKV}, {cfg.block_size}, {D}]"
                          f" and f32 scale pools",
                    ms=turns["ms"], plain_ms=turns["plain_ms"], bound_ms=b,
                    bound_by=by, library_ms=None,
                    library_note="none: no single PyTorch call computes "
                                 "the quantize-and-scatter")
                kq_calls[label] = call
    row = dict(name="kv_quant", route="cuda",
               source="paddle_tpu_torch/ops/kernels/csrc/kv_quant.cu",
               replaces="paddle_tpu/incubate/nn/functional/__init__.py:687 "
                        "(q8 and the page scatters; no Pallas kernel, "
                        "XLA-fused jnp in the reference)",
               max_abs_err=kq_err, **kq_rows["decode"],
               at_step_shape=kq_rows["step"])
    results["kv_quant"] = row
    log(f"kv_quant: {row}")
    probes["kv_quant decode"] = (kq_calls["decode"], "kv_quant_kernel", 48,
                                 row)
    probes["kv_quant step"] = (kq_calls["step"], "kv_quant_kernel", 48,
                               row["at_step_shape"])

    # -- paged attention over int8 pages
    shapes = {
        "decode": ([(1, p) for p in serving["run"]["decode_positions"]], 0),
        **PAGED_SHAPES,
    }
    errs, rows = {}, {}
    for label, (spec, n_pad) in shapes.items():
        for dtype, tol in ((torch.bfloat16, (2.0 ** -6, 1e-5)),
                           (torch.float32, (1e-4, 1e-6))):
            q, kc, _, t2b, pos, bt = _paged_inputs(dev, cfg, spec, dtype,
                                                   gen, n_pad)
            del kc
            k8, v8 = [torch.randint(-127, 128, (L, cfg.num_blocks, HKV,
                                                cfg.block_size, D),
                                    device=dev, generator=gen,
                                    dtype=torch.int8) for _ in range(2)]
            ks, vs = [torch.rand(L, cfg.num_blocks, HKV, cfg.block_size,
                                 device=dev, generator=gen) * 0.03 + 1e-3
                      for _ in range(2)]
            kd = (k8.float() * ks[..., None]).to(dtype)
            vd = (v8.float() * vs[..., None]).to(dtype)
            worst, same = 0.0, True
            for layer in (0, L - 1):
                got = PA.paged_attention(q, k8, v8, layer, t2b, pos, bt, ks,
                                         vs)
                ref = PA._paged_attention_ref(q, k8[layer], v8[layer], t2b,
                                              pos, bt, ks[layer], vs[layer])
                flt = PA.paged_attention(q, kd, vd, layer, t2b, pos, bt)
                torch.cuda.synchronize()
                ratio = _worst_of_tol(got, ref, *tol)
                worst = max(worst, ratio)
                same &= torch.equal(got, flt)
                errs[(label, dtype)] = max(errs.get((label, dtype), 0.0),
                                           _max_err(got, ref))
                if ratio > 1.0 or not same \
                        or not bool(torch.isfinite(got.float()).all()):
                    raise AssertionError(
                        f"paged_attention_int8 {label} {dtype} layer "
                        f"{layer}: {ratio:.3f} x its tolerance, bits equal "
                        f"to the float kernel on the dequantized pages: "
                        f"{same}")
            log(f"paged_attention_int8 {label} T={q.shape[0]} q {dtype}: "
                f"max_abs_err {errs[(label, dtype)]:.3e}, worst error / tol "
                f"{worst:.3f} (tol {tol[0]:.3g} * (|ref| + row RMS) + "
                f"{tol[1]:g}; RMS of out {_rms(ref):.3e}); bit for bit the "
                f"float kernel over the dequantized pages: {same} ok")
            if dtype == torch.bfloat16:
                rows[label] = (q, k8, v8, ks, vs, kd, vd, t2b, pos, bt)

    sdpa = torch.nn.functional.scaled_dot_product_attention
    timed, calls = {}, {}
    for label, (q, k8, v8, ks, vs, kd, vd, t2b, pos, bt) in rows.items():
        T = q.shape[0]
        turn = [0]

        def call(q=q, k8=k8, v8=v8, ks=ks, vs=vs, t2b=t2b, pos=pos, bt=bt):
            turn[0] = (turn[0] + 1) % L
            return PA.paged_attention(q, k8, v8, turn[0], t2b, pos, bt, ks,
                                      vs)

        def bf16(q=q, kd=kd, vd=vd, t2b=t2b, pos=pos, bt=bt):
            turn[0] = (turn[0] + 1) % L
            return PA.paged_attention(q, kd, vd, turn[0], t2b, pos, bt)

        def plain(q=q, k8=k8, v8=v8, ks=ks, vs=vs, t2b=t2b, pos=pos, bt=bt):
            turn[0] = (turn[0] + 1) % L
            return PA._paged_attention_ref(q, k8[turn[0]], v8[turn[0]], t2b,
                                           pos, bt, ks[turn[0]],
                                           vs[turn[0]])

        max_seq = bt.shape[1] * cfg.block_size
        kg = kd[0][bt].permute(0, 2, 1, 3, 4).reshape(
            bt.shape[0], HKV, max_seq, D)[t2b]
        vg = vd[0][bt].permute(0, 2, 1, 3, 4).reshape(
            bt.shape[0], HKV, max_seq, D)[t2b]
        mask = (torch.arange(max_seq, device=dev)[None, :]
                <= pos[:, None])[:, None, None, :]
        qd = q[:, :, None, :]

        def library(qd=qd, kg=kg, vg=vg, mask=mask):
            return sdpa(qd, kg, vg, attn_mask=mask, enable_gqa=True)

        calls[label] = call
        lib_err = _max_err(library()[:, :, 0], PA._paged_attention_ref(
            q, k8[0], v8[0], t2b, pos, bt, ks[0], vs[0]))
        b, by = _paged_bound(q, k8, t2b, pos, bt)
        bf_b, _ = _paged_bound(q, kd, t2b, pos, bt)
        turns = time_ms_turns({"ms": call, "bf16_kernel_ms": bf16,
                               "library_ms": library})
        timed[label] = dict(
            shape=f"q [{T}, {HQ}, {D}] bf16, int8 pools [{cfg.num_blocks}, "
                  f"{HKV}, {cfg.block_size}, {D}] + f32 scales a layer, "
                  f"positions {sorted(set(pos.tolist()))[:8]}...",
            ms=turns["ms"], plain_ms=time_ms(plain, calls=20, windows=5),
            bound_ms=b, bound_by=by, library_ms=turns["library_ms"],
            bf16_kernel_ms=turns["bf16_kernel_ms"], bf16_bound_ms=bf_b,
            library_note="SDPA on the dequantized gathered dense view [T, "
                         f"HKV, {max_seq}, D] bf16 with a bool mask (the "
                         f"gather and the dequant not timed); its "
                         f"max_abs_err against the plain version "
                         f"{lib_err:.3e}")
        log(f"paged_attention_int8 {label}: {timed[label]}")
    row = dict(name="paged_attention_int8", route="cuda",
               source="paddle_tpu_torch/ops/kernels/csrc/paged_attention.cu",
               replaces="paddle_tpu/incubate/nn/functional/__init__.py:738 "
                        "(the int8 dequant of the paged route; no Pallas "
                        "kernel, XLA-fused jnp in the reference)",
               max_abs_err=max(v for (_, dt), v in errs.items()
                               if dt == torch.bfloat16),
               max_abs_err_f32=max(v for (_, dt), v in errs.items()
                                   if dt == torch.float32),
               **timed["decode"], at_chunked_shape=timed["chunked"],
               at_verify_shape=timed["verify"])
    results["paged_attention_int8"] = row
    for label, target in (("decode", row),
                          ("chunked", row["at_chunked_shape"]),
                          ("verify", row["at_verify_shape"])):
        probes[f"paged_attention_int8 {label}"] = (
            calls[label], "paged_attention_tc_kernel", 48, target)


# the RoPE-and-append kernel's checked and timed steps besides decode (whose
# positions the serving phase gives): (rows [(tokens, start position)],
# trash-row padding tokens). The verify and 256-token chunked steps of
# PAGED_SHAPES, and a 256-token fresh-prefill step whose trash row pads 66
# tokens, more than a page: several of them write each slot of page 0
ROPE_SHAPES = {
    **PAGED_SHAPES,
    "fresh": ([(100, 0), (90, 0)], 66),
}


def _rope_append_inputs(dev, cfg, table, rows, n_pad, dtype, int8, gen):
    """rope_append's inputs at the serving config's widths: rows [(tokens,
    start position)], each on its own pages, and n_pad padding tokens in
    the trash row (last, block-table row all page 0); the packed qkv [T,
    (HQ + 2 HKV) D] (k and v spanning magnitudes, token 0's k head 0 all
    zero, token 1's v head 0 a tie head: max 127, so its int8 scale is 1,
    and values n + 0.5), the stacked pools (random earlier contents: bf16
    or f32 pages of q's dtype, or int8 with f32 scales) and the step's
    metadata from the model's RoPE table."""
    from paddle_tpu_torch.incubate.nn import functional as IF

    HQ, HKV, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    mb, bs = cfg.max_blocks_per_seq, cfg.block_size
    B1 = len(rows) + 1
    enc = torch.zeros(B1, dtype=torch.int64)
    dec = torch.zeros(B1, dtype=torch.int64)
    this = torch.zeros(B1, dtype=torch.int64)
    bt = torch.zeros(B1, mb, dtype=torch.int64)
    for i, (n, start) in enumerate(rows):
        dec[i], this[i] = start, n
        bt[i] = torch.arange(1 + i * mb, 1 + (i + 1) * mb)
    this[-1] = enc[-1] = n_pad
    cu = torch.zeros(B1 + 1, dtype=torch.int64)
    cu[1:] = torch.cumsum(this, 0)
    T = int(cu[-1])
    qkv = torch.randn(T, (HQ + 2 * HKV) * D, device=dev, generator=gen)
    qkv[:, HQ * D:] *= torch.exp(torch.randn(T, 1, device=dev,
                                             generator=gen))
    qkv[0, HQ * D:(HQ + 1) * D] = 0
    tie = (HQ + HKV) * D
    qkv[1, tie:tie + D] = torch.arange(D, device=dev) % 9 + 0.5
    qkv[1, tie] = 127
    qkv = qkv.to(dtype)
    shape = (cfg.num_layers, cfg.num_blocks, HKV, bs, D)
    if int8:
        pools = [torch.randint(-127, 128, shape, device=dev, generator=gen,
                               dtype=torch.int8) for _ in range(2)]
        pools += [torch.rand(shape[:-1], device=dev, generator=gen) * 0.05
                  for _ in range(2)]
    else:
        pools = [torch.randn(shape, device=dev, generator=gen).to(dtype)
                 for _ in range(2)] + [None, None]
    rope = table[:, None, None, :mb * bs].expand(2, B1, 1, mb * bs, D // 2)
    md = IF.paged_metadata(T, enc.to(dev), dec.to(dev), cu.to(dev),
                           bt.to(dev), bs, rope)
    return qkv, pools, md


def _old_rope_append(qkv, kc, vc, ks, vs, layer, md, heads_first=False):
    """The composition rope_append replaced in block_multihead_attention:
    RoPE's tensor ops and the casts, then the page scatter (index_put_) for
    float pages, or the old kv_quant kernel for int8 pages."""
    from paddle_tpu_torch.ops.kernels import kv_quant as KQ
    from paddle_tpu_torch.ops.kernels import rope_append as RA

    q, k, v = RA._split(qkv, kc.shape[2], kc.shape[-1])
    q = RA._rope(q, md.cos, md.sin).to(qkv.dtype)
    k = RA._rope(k, md.cos, md.sin).to(qkv.dtype)
    if ks is not None:
        KQ.kv_quant(k, v, kc, vc, ks, vs, layer, md.page, md.slot)
    else:
        kc[layer].transpose(1, 2)[md.page, md.slot] = k
        vc[layer].transpose(1, 2)[md.page, md.slot] = v
    if heads_first:
        return tuple(t.transpose(0, 1).contiguous() for t in (q, k, v))
    return q


def _rope_append_bound(qkv, pools, heads_first):
    """(bound ms, bound_by) of one rope_append call: qkv, the angles and
    page/slot read once; q (and k, v heads first), the K/V rows and their
    scales written once; against 3 f32 operations an element of q and k
    (RoPE: 4 products and 2 sums a pair) and 4 an element of k and v for
    int8 pages (abs-max, division, rounding, clamp) at the f32 rate."""
    kc, ks = pools[0], pools[2]
    T = qkv.shape[0]
    HKV, D = kc.shape[2], kc.shape[-1]
    HQ = qkv.shape[1] // D - 2 * HKV
    esz = qkv.element_size()
    kv_el = 2 * T * HKV * D
    nb = (nbytes(qkv) + 2 * T * (D // 2) * 4 + 2 * T * 8
          + T * HQ * D * esz + kv_el * kc.element_size()
          + (2 * T * HKV * 4 if ks is not None else 0)
          + (kv_el * esz if heads_first else 0))
    ops = 3 * T * (HQ + HKV) * D + (4 * kv_el if ks is not None else 0)
    return bound(nb, ops, F32_OPS_PER_S)


def phase_rope_append_kernel(dev, results, probes, serving):
    """rope_append against its plain version, then timed. At the decode
    shape (8 rows at the serving phase's decode positions) and ROPE_SHAPES'
    verify, 256-token chunked and fresh-prefill steps, each in both output
    layouts (q [T, HQ, D]; q, k, v heads first), bf16 and f32 q, float
    pages of q's dtype and int8 pages: q (and k, v) and every pool byte
    outside the trash page 0 bit for bit (the fresh step's padding tokens
    share page 0's slots, and which of them a scatter keeps is unordered,
    in index_put_ as in the kernel; no live row reads page 0), the all-zero
    head's int8 scale 1e-8 and the tie head's 1. Then, bf16 q, each shape
    in its path's layout (heads first for the fresh step), timed in turns
    with its plain version and with the composition it replaced in
    block_multihead_attention (for float pages that composition is the
    plain version; for int8 pages the old kv_quant kernel quantizes), each
    call on the next layer's pools; the kernel's and the old composition's
    device time and device kernels a call by the profile phase (no single
    PyTorch call computes it: library null)."""
    from paddle_tpu_torch.ops.kernels import rope_append as RA

    cfg, model = serving["cfg"], serving["model"]
    L = cfg.num_layers
    HQ, HKV, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    table = model.rope_cos_sin(dev)
    gen = torch.Generator(device=dev).manual_seed(29)
    shapes = {
        "decode": ([(1, p) for p in serving["run"]["decode_positions"]], 0),
        **ROPE_SHAPES,
    }
    checks, timed, calls = 0, {}, {}
    for label, (rows, n_pad) in shapes.items():
        for dtype in (torch.bfloat16, torch.float32):
            for pages in ("float", "int8"):
                qkv, pools, md = _rope_append_inputs(
                    dev, cfg, table, rows, n_pad, dtype, pages == "int8",
                    gen)
                T = qkv.shape[0]
                for heads_first in (False, True):
                    got_pools = [None if p is None else p.clone()
                                 for p in pools]
                    ref_pools = [None if p is None else p.clone()
                                 for p in pools]
                    got = RA.rope_append(qkv, *got_pools, L - 1, md,
                                         heads_first=heads_first)
                    ref = RA._rope_append_ref(qkv, *ref_pools, L - 1, md,
                                              heads_first=heads_first)
                    torch.cuda.synchronize()
                    got = got if heads_first else (got,)
                    ref = ref if heads_first else (ref,)
                    same = all(a.shape == b.shape and _bits_equal(a, b)
                               for a, b in zip(got, ref))
                    same &= all(
                        torch.equal(a[:, 1:].view(torch.uint8),
                                    b[:, 1:].view(torch.uint8))
                        for a, b in zip(got_pools, ref_pools)
                        if a is not None)
                    if pages == "int8":
                        ks, vs = ref_pools[2][L - 1], ref_pools[3][L - 1]
                        same &= float(ks[md.page[0], 0, md.slot[0]]) \
                            == float(np.float32(1e-8))
                        same &= float(vs[md.page[1], 0, md.slot[1]]) == 1.0
                    if not same:
                        raise AssertionError(
                            f"rope_append {label} T={T} {dtype} {pages} "
                            f"pages heads_first={heads_first}: not bit for "
                            f"bit its plain version")
                    checks += 1
                log(f"rope_append {label} T={T} q {dtype}, {pages} pages: "
                    f"q, k, v and the pools outside page 0 bit for bit the "
                    f"plain version's, both layouts; zero and tie heads' "
                    f"int8 scales 1e-8 and 1 ok")
                if dtype != torch.bfloat16:
                    continue
                heads_first = label == "fresh"      # the path's layout
                turn = [0]

                def call(fn, qkv=qkv, pools=pools, md=md,
                         heads_first=heads_first, turn=turn):
                    turn[0] = (turn[0] + 1) % L
                    return fn(qkv, *pools, turn[0], md,
                              heads_first=heads_first)

                fns = {"ms": lambda call=call: call(RA.rope_append),
                       "plain_ms":
                       lambda call=call: call(RA._rope_append_ref)}
                if pages == "int8":
                    fns["old_composition_ms"] = \
                        lambda call=call: call(_old_rope_append)
                turns = time_ms_turns(fns)
                if pages == "float":      # the old composition is the plain
                    turns["old_composition_ms"] = turns["plain_ms"]
                b, by = _rope_append_bound(qkv, pools, heads_first)
                key = f"{label} {pages}"
                timed[key] = dict(
                    shape=f"qkv [{T}, {(HQ + 2 * HKV) * D}] bf16 "
                          f"({HQ}/{HKV} heads of {D}) into "
                          f"{'bf16' if pages == 'float' else 'int8'} pools "
                          f"[{L}, {cfg.num_blocks}, {HKV}, {cfg.block_size},"
                          f" {D}]" + (" + f32 scales" if pages == "int8"
                                      else "")
                          + (", q, k, v out heads first" if heads_first
                             else ", q out [T, HQ, D]"),
                    **turns, bound_ms=b, bound_by=by, library_ms=None,
                    library_note="none: no single PyTorch call rotates, "
                                 "casts and scatters",
                    old_composition=dict(
                        note="RoPE's tensor ops, the casts and "
                             + ("index_put_ into the pages" if
                                pages == "float" else
                                "the old kv_quant kernel")))
                calls[key] = (fns["ms"],
                              lambda call=call: call(_old_rope_append))
                log(f"rope_append {key}: {timed[key]}")
    row = dict(name="rope_append", route="cuda",
               source="paddle_tpu_torch/ops/kernels/csrc/rope_append.cu",
               replaces="paddle_tpu/incubate/nn/functional/__init__.py:655 "
                        "(RoPE of q and k, the casts, q8 and the page "
                        "scatters; no Pallas kernel, XLA-fused jnp in the "
                        "reference)",
               max_abs_err=0.0, bit_for_bit_checks=checks,
               **timed["decode float"])
    for key, t in timed.items():
        if key != "decode float":
            row["at_" + key.replace(" ", "_")] = t
    results["rope_append"] = row
    for key, (kernel, old) in calls.items():
        target = row if key == "decode float" \
            else row["at_" + key.replace(" ", "_")]
        probes[f"rope_append {key}"] = (kernel, "rope_append_kernel", 48,
                                        target)
        probes[f"rope_append old composition {key}"] = (
            old, None, 48, target["old_composition"])


def phase_int8_serving(dev, serving):
    """PagedServingConfig.llama_1b(cache_quant="int8") over the serving
    phase's model and requests, driven as that phase drives the bf16
    engine: twice on one engine (the first drive captures the windows'
    graphs), the second measured; its first replayed decode window, counts
    set to 0 just before it, must launch RMSNorm 2L + 1, the int8 paged
    kernel L and rope_append L times a step, and the bf16 paged kernel and
    the old kv_quant kernel not at all. The int8 greedy and sampled streams against the bf16 engine's (the
    same request ids, so the same salts): the tokens equal and each
    request's first divergence, printed, not required equal. Then the int8
    windows' graphs against the eager runner, token for token."""
    from paddle_tpu_torch import launch_counts, reset_launch_counts
    from paddle_tpu_torch.inference import PagedServingConfig, ServingEngine

    model = serving["model"]
    cfg = PagedServingConfig.llama_1b(cache_quant="int8")
    L = cfg.num_layers
    torch.cuda.reset_peak_memory_stats(dev)
    at_start = torch.cuda.memory_allocated(dev)
    eng = ServingEngine.from_model(model, cfg, seed=7, device=dev)
    first, sampling = serving["first"], serving["sampling"]
    later = serving["prompts"][len(first):]

    def drive(measure):
        return _serving_drive(eng, first, later, sampling, 48, measure)

    warm = drive(False)
    graphs = {f"{k[0]} rows, {k[1]}": w.capture_ms
              for k, w in eng._window_fns.items() if w.graph is not None}
    if not graphs or len(graphs) != len(eng._window_fns):
        raise AssertionError("int8 decode_run did not capture a CUDA graph "
                             "for each of its windows")
    reset_launch_counts()
    run = drive(True)
    counts = {k: n + run["carried"][k] for k, n in launch_counts().items()}
    if run["window"] is None:
        raise AssertionError("every measured int8 decode window captured")
    steps, n_tok, made = run["window"]
    want = {k: 0 for k in made}
    want.update(rms_norm=(2 * L + 1) * steps,
                paged_attention_int8=L * steps, rope_append=L * steps)
    if made != want:
        raise AssertionError(f"a replayed int8 decode window of {steps} "
                             f"steps launched {made}, not {want}")
    decode_step = {k: n // steps for k, n in made.items()}
    fresh = run["per_step"]
    want_fresh = {k: 0 for k in fresh}
    want_fresh.update(rms_norm=2 * L + 1, varlen_attention_fwd=L,
                      rope_append=L)
    if fresh != want_fresh:
        raise AssertionError(f"the int8 fresh-prefill step launched {fresh},"
                             f" not {want_fresh}")
    log(f"int8 serving launch counts: {counts}; fresh-prefill step "
        f"{fresh}; measured decode window of {steps} steps over "
        f"{n_tok // steps} rows, counts set to 0 just before it: "
        f"{ {k: n for k, n in made.items() if n} } ({decode_step['rms_norm']}"
        f", {decode_step['paged_attention_int8']} and "
        f"{decode_step['rope_append']} a step, counted under replay)")
    for name in INT8_SERVING_KERNELS:
        if counts[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"int8 serving path")
    for name in ("paged_attention", "kv_quant", "rms_norm_bwd",
                 "aligned16_copies"):
        if counts[name]:
            raise AssertionError(f"the int8 serving run counted {name} "
                                 f"{counts[name]}")
    V = cfg.vocab_size
    bf_outs = serving["run"]["outs"]
    equal = total = 0
    diverge = {}
    for rid in run["rids"]:
        toks = run["outs"][rid]
        if len(toks) != 48 or not all(0 <= t < V for t in toks):
            raise AssertionError(f"int8 request {rid}: bad output "
                                 f"{toks[:8]}")
        ref = bf_outs[rid]
        same = [a == b for a, b in zip(toks, ref)]
        equal += sum(same)
        total += len(ref)
        diverge[rid] = same.index(False) if not all(same) else None
    steady = [w for w in run["windows"] if not w[3]]
    ms, tps, n_steps = _window_rate(steady)
    ms_all, _, _ = _window_rate(warm["windows"])
    pools = nbytes(eng._kc, eng._vc, eng._ks, eng._vs)
    bf_pools = 2 * L * cfg.num_blocks * cfg.num_kv_heads * cfg.block_size \
        * cfg.head_dim * 2
    turns = _graph_against_eager(dev, eng, model, cfg, sampling)
    bm = serving["metrics"]
    metrics = {
        "fresh_prefill_step_ms": run["t_fresh"] * 1e3,
        "bf16_fresh_prefill_step_ms": bm["fresh_prefill_step_ms"],
        "decode_steps": n_steps,
        "decode_ms_per_step": ms,
        "decode_tokens_per_s": tps,
        "bf16_decode_ms_per_step": bm["decode_ms_per_step"],
        "decode_ms_per_step_all_in": ms_all,
        "decode_capture_ms": graphs,
        "decode_launches_per_step": decode_step,
        **turns,
        "tokens_equal_to_bf16": equal, "tokens": total,
        "first_divergence_by_request": diverge,
        "pools_bytes": pools, "bf16_pools_bytes": bf_pools,
        "peak_memory_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
        "peak_over_start_gb": (torch.cuda.max_memory_allocated(dev)
                               - at_start) / 1e9,
        "bf16_peak_memory_gb": bm["peak_memory_gb"],
    }
    log(json.dumps({"int8_serving": metrics}))
    return dict(metrics=metrics, counts=counts, run=run, cfg=cfg, engine=eng)


def _conserved(eng):
    """Every page is free or owned by the prefix cache, once, and no cache
    node holds a ref; raises otherwise."""
    cache = eng._prefix_cache
    owned = list(cache.owned_pages()) if cache is not None else []
    if sorted(eng._free_pages + owned) != list(range(1, eng.cfg.num_blocks)):
        raise AssertionError("pages lost or doubled: free "
                             f"{len(eng._free_pages)}, cache {len(owned)}, "
                             f"pool {eng.cfg.num_blocks - 1}")
    if cache is not None and any(n.refs for n in cache._nodes.values()):
        raise AssertionError("a prefix-cache node still holds a ref")
    return len(owned)


def phase_prefix_cache(dev, serving):
    """llama_1b (bf16) with and without the prefix cache: 8 requests that
    share a 96-token prefix (3 pages) with distinct suffixes of 16-64
    tokens (numpy seed 9), 16 new tokens each, greedy; request 0 alone to
    its first token, then the other 7 together. The prefill tokens
    computed and the time to first token of requests 1-7 (admission to
    first token, host clock; each step that samples syncs), with and
    without the cache; every page back in the pool or the cache with every
    refcount 0; the equal tokens of the two engines' streams, printed."""
    from paddle_tpu_torch.inference import PagedServingConfig, ServingEngine

    model = serving["model"]
    rng = np.random.RandomState(9)
    V = serving["cfg"].vocab_size
    prefix = list(rng.randint(1, V, 96))
    prompts = [prefix + list(rng.randint(1, V, n))
               for n in rng.randint(16, 65, 8)]
    out = {}
    for label, over in (("cache", dict(prefix_cache=True)),
                        ("no_cache", {})):
        cfg = PagedServingConfig.llama_1b(**over)
        eng = ServingEngine.from_model(model, cfg, seed=11, device=dev)
        computed, ttft = 0, {}
        torch.cuda.synchronize()
        r0 = eng.add_request(prompts[0], max_new_tokens=16)
        computed += len(prompts[0]) - eng._requests[r0].cached
        while not eng._requests[r0].generated:
            eng.step()
        t1 = time.perf_counter()
        rids = [eng.add_request(p, max_new_tokens=16) for p in prompts[1:]]
        computed += sum(len(p) - eng._requests[r].cached
                        for r, p in zip(rids, prompts[1:]))
        hits = [eng._requests[r].cached for r in rids]
        while len(ttft) < len(rids):
            eng.step()
            now = time.perf_counter()
            for r in rids:
                if r not in ttft and eng._requests[r].generated:
                    ttft[r] = (now - t1) * 1e3
        while eng.pending():
            if not eng.decode_run(16):
                eng.step()
        resident = _conserved(eng)
        out[label] = dict(
            prefill_tokens_computed=computed,
            prompt_tokens=sum(map(len, prompts)), cached_at_admission=hits,
            ttft_ms_requests_1_7=[ttft[r] for r in rids],
            ttft_ms_mean=statistics.mean(ttft.values()),
            cache_pages_resident=resident,
            streams={r: list(eng._requests[r].generated)
                     for r in [r0] + rids})
        if label == "cache":
            if hits != [96] * 7:
                raise AssertionError(f"prefix hits at admission {hits}, not "
                                     f"96 tokens each")
            out[label]["hit_rate"] = eng._prefix_cache.hit_rate()
    a, b = out["cache"]["streams"], out["no_cache"]["streams"]
    equal = sum(x == y for r in a for x, y in zip(a[r], b[r]))
    total = sum(len(v) for v in b.values())
    metrics = {k: {kk: vv for kk, vv in v.items() if kk != "streams"}
               for k, v in out.items()}
    metrics["tokens_equal_with_and_without_cache"] = equal
    metrics["tokens"] = total
    log(json.dumps({"prefix_cache": metrics}))
    return metrics


def phase_speculative(dev, serving):
    """llama_1b (bf16) with NGramDrafter, k = 4: 8 prompts, each a random
    16-token segment repeated 6 times (96 tokens, numpy seed 13), 48 new
    tokens each, greedy. A teach wave through the verify steps first (the
    drafter observes what is served); then waves of the same prompts in
    turns, each timed from the decode tip to the end: speculative (verify
    steps), the same engine's plain eager step() and its decode_run graph
    windows, in the order spec, step, graph, graph, step, spec. The
    acceptance rate and tokens emitted a row a verify step over the
    measured speculative waves, ms an emitted token of each mode (median
    of its waves), and the equal tokens of the speculative and graph
    streams against the plain step() streams, printed."""
    from paddle_tpu_torch.inference import (NGramDrafter, PagedServingConfig,
                                            ServingEngine)

    model = serving["model"]
    cfg = PagedServingConfig.llama_1b()
    rng = np.random.RandomState(13)
    prompts = [list(np.tile(rng.randint(1, cfg.vocab_size, 16), 6))
               for _ in range(8)]
    eng = ServingEngine.from_model(model, cfg, seed=5, device=dev)
    drafter = NGramDrafter(block_size=cfg.block_size)

    def wave(mode):
        eng.set_drafter(drafter if mode == "spec" else None, k=4)
        rids = [eng.add_request(p, max_new_tokens=48) for p in prompts]
        while any(r.length - r.cached > 1 for r in eng.pending()):
            eng.step()                       # prefill: not timed
        n0 = sum(len(eng._requests[r].generated) for r in rids)
        before = eng.spec_stats()
        torch.cuda.synchronize()
        t = time.perf_counter()
        while eng.pending():
            if mode == "graph":
                if not eng.decode_run(32):
                    eng.step()
            else:
                eng.step()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        n = sum(len(eng._requests[r].generated) for r in rids) - n0
        after = eng.spec_stats()
        _conserved(eng)
        return dict(ms_per_token=dt * 1e3 / n, tokens=n,
                    drafted=after["drafted"] - before["drafted"],
                    accepted=after["accepted"] - before["accepted"],
                    steps=after["steps"] - before["steps"],
                    rows=after["rows"] - before["rows"],
                    streams=[list(eng._requests[r].generated)
                             for r in rids])

    teach = wave("spec")
    wave("graph")              # captures the windows' graphs: not measured
    waves = {m: [] for m in ("spec", "step", "graph")}
    for mode in ("spec", "step", "graph", "graph", "step", "spec"):
        waves[mode].append(wave(mode))
    ref = waves["step"][0]["streams"]

    def equal(streams):
        return sum(a == b for s, r in zip(streams, ref)
                   for a, b in zip(s, r))

    drafted = sum(w["drafted"] for w in waves["spec"])
    accepted = sum(w["accepted"] for w in waves["spec"])
    vsteps = sum(w["steps"] for w in waves["spec"])
    vrows = sum(w["rows"] for w in waves["spec"])
    emitted = sum(w["tokens"] for w in waves["spec"])
    metrics = {
        "accept_rate": accepted / drafted if drafted else 0.0,
        "teach_wave_accept_rate": teach["accepted"] / teach["drafted"]
        if teach["drafted"] else 0.0,
        "verify_steps": vsteps,
        "tokens_per_row_verify_step": emitted / vrows if vrows else 0.0,
        "tokens_per_verify_step": emitted / vsteps if vsteps else 0.0,
        **{f"{m}_ms_per_token": statistics.median(
            w["ms_per_token"] for w in ws) for m, ws in waves.items()},
        **{f"{m}_ms_per_token_waves": [w["ms_per_token"] for w in ws]
           for m, ws in waves.items()},
        "tokens": waves["step"][0]["tokens"],
        "stream_tokens": sum(map(len, ref)),
        "spec_tokens_equal_to_step": equal(waves["spec"][0]["streams"]),
        "graph_tokens_equal_to_step": equal(waves["graph"][0]["streams"]),
        "step_waves_equal": waves["step"][1]["streams"] == ref,
    }
    if vsteps == 0 or accepted == 0:
        raise AssertionError("the speculative waves accepted no draft")
    metrics["gemm_rows_by_m"] = _gemm_by_m_probe(dev, eng._model)
    log(json.dumps({"speculative": metrics}))
    return metrics


def _gemm_by_m_probe(dev, served):
    """Why bf16 streams of one request differ between step shapes: the
    same 8 rows through one layer's qkv projection and the LM head as part
    of an M-row product, M = 8 (a decode window's bucket), 64 (a verify
    step's padded length) and 256 (an eager step's token budget): are rows
    0-7 the same bits as at M = 8? In bf16 (the served weights) and f32."""
    gen = torch.Generator(device=dev).manual_seed(31)
    out = {}
    with torch.inference_mode():
        for name, lin in (("qkv", served.qkv[0]), ("head", served.head)):
            w = lin.weight
            for dt in (torch.bfloat16, torch.float32):
                x = torch.randn(256, w.shape[1], device=dev, generator=gen)
                wt = w.to(dt)
                ref = torch.nn.functional.linear(x[:8].to(dt), wt)
                for m in (64, 256):
                    got = torch.nn.functional.linear(x[:m].to(dt), wt)[:8]
                    out[f"{name} {str(dt)[6:]} M={m}"] = dict(
                        equal_to_m8=bool(torch.equal(got, ref)),
                        max_abs_diff=_max_err(got, ref))
    log(f"GEMM rows by M (rows 0-7 of an M-row product against M = 8): "
        f"{out}")
    return out


def _stream_group_shapes(cfg):
    """(in, out) of a layer's four streamed Linears: qkv, proj, gate_up,
    down."""
    h, f = cfg.hidden_size, cfg.ffn_size
    kvw = cfg.num_kv_heads * cfg.head_dim
    return [(h, h + 2 * kvw), (h, h), (h, 2 * f), (f, h)]


def _quantized_group(dev, shapes, mode, gen):
    """Random bf16 weights of ``shapes`` quantized as the engine does
    (numpy on the host), codes and scales on the card."""
    from paddle_tpu_torch.inference import weight_stream as TW

    segs = []
    for n_in, n_out in shapes:
        w = (torch.randn(n_in, n_out, device=dev, generator=gen) * 0.02) \
            .to(torch.bfloat16)
        q, s = (TW.quantize_int4_grouped(w) if mode == "int4"
                else TW.quantize_per_channel(w))
        segs.append((torch.from_numpy(q).to(dev), torch.from_numpy(s).to(dev),
                     n_in))
    return segs


def _dequant_plain(segs, outs):
    from paddle_tpu_torch.ops.kernels import weight_dequant as WD

    for (q, s, n_in), o in zip(segs, outs):
        o.copy_(WD.dequantize(q, s, o.dtype) if q.dtype == torch.int8
                else WD.dequantize_int4(q, s, o.dtype, n_in))


def _bits_equal(a, b):
    view = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
    return torch.equal(a.contiguous().view(view), b.contiguous().view(view))


def phase_weight_dequant_kernel(dev, results, probes, cfg):
    """The weight-dequant kernel against its plain version, bit for bit: a
    llama_1b layer group (qkv [2048, 4096], proj [2048, 2048], gate_up
    [2048, 11264], down [5632, 2048]) and an odd group (inputs of 100, 33,
    1 and 257 rows, outputs multiples of 8 only), int8 and int4, bf16 and
    f32 out, the outputs in one workspace-like slot; then the llama_1b
    group timed (one launch a layer) beside its plain version. Its bound:
    the codes and scales read once and the bf16 outputs written once. No
    single PyTorch call dequantizes (library null); beside it, for scale,
    one decode layer's four bf16 GEMMs at M = 8 (their device time in the
    profile phase)."""
    from paddle_tpu_torch.inference import weight_stream as TW
    from paddle_tpu_torch.ops.kernels import weight_dequant as WD

    gen = torch.Generator(device=dev).manual_seed(41)
    groups = {"llama_1b": _stream_group_shapes(cfg),
              "odd": [(100, 64), (33, 200), (1, 16), (257, 48)]}
    checked = []
    timed, calls = {}, {}
    for mode in ("int8", "int4"):
        for label, shapes in groups.items():
            segs = _quantized_group(dev, shapes, mode, gen)
            for dtype in (torch.bfloat16, torch.float32):
                ws = TW.WeightStreamer(1, dtype)
                ws._shape = {(k, 0): sh for k, sh in zip(TW.STREAM_KINDS,
                                                         shapes)}
                (slot,) = ws.workspace(dev, 1)
                views = ws.slot_views(slot)
                outs = [views[k] for k in TW.STREAM_KINDS]
                refs = [torch.empty_like(o) for o in outs]
                WD.weight_dequant(segs, outs)
                _dequant_plain(segs, refs)
                torch.cuda.synchronize()
                if not all(_bits_equal(a, b) for a, b in zip(outs, refs)):
                    bad = sum(int((a.float() != b.float()).sum())
                              for a, b in zip(outs, refs))
                    worst = max(_max_err(a, b) for a, b in zip(outs, refs))
                    raise AssertionError(f"weight_dequant {mode} {label} "
                                         f"{dtype}: {bad} of "
                                         f"{sum(o.numel() for o in outs)} "
                                         f"outputs differ from the plain "
                                         f"version (max abs {worst:.3e})")
                checked.append(f"{mode} {label} {str(dtype)[6:]}")
                if label != "llama_1b" or dtype != torch.bfloat16:
                    continue

                def call(segs=segs, outs=outs):
                    WD.weight_dequant(segs, outs)

                def plain(segs=segs, refs=refs):
                    _dequant_plain(segs, refs)

                nb = sum(nbytes(q, s) for q, s, _ in segs) + nbytes(*outs)
                b, by = bound(nb, sum(o.numel() for o in outs),
                              F32_OPS_PER_S)
                calls[mode] = call
                timed[mode] = dict(
                    shape=f"{mode} codes of the llama_1b layer group "
                          f"{shapes} -> bf16 [in, out] in one slot",
                    ms=time_ms(call), plain_ms=time_ms(plain, calls=10,
                                                       windows=5),
                    bound_ms=b, bound_by=by, library_ms=None,
                    bytes=nb)
                log(f"weight_dequant {mode}: {timed[mode]}")
    log(f"weight_dequant: bit for bit its plain version in {len(checked)} "
        f"cases: {checked}")
    # one decode layer's four bf16 GEMMs at M = 8, for scale
    x = {n_in: torch.randn(8, n_in, device=dev, generator=gen)
         .to(torch.bfloat16) for n_in, _ in groups["llama_1b"]}
    ws_bf = [torch.randn(n_in, n_out, device=dev, generator=gen)
             .to(torch.bfloat16) for n_in, n_out in groups["llama_1b"]]

    def gemms():
        for w in ws_bf:
            x[w.shape[0]] @ w

    gemm = {"shape": "x [8, in] @ w [in, out] bf16 for the four Linears of "
                     "a llama_1b layer", "ms": time_ms(gemms)}
    row = dict(name="weight_dequant", route="cuda",
               source="paddle_tpu_torch/ops/kernels/csrc/weight_dequant.cu",
               replaces="paddle_tpu/inference/weight_stream.py:61 "
                        "(dequantize; no Pallas kernel, XLA-fused jnp in "
                        "the jitted step)",
               max_abs_err=0.0, bits_checked=checked, **timed["int8"],
               int4=dict(timed["int4"], max_abs_err=0.0,
                         replaces="paddle_tpu/inference/weight_stream.py:99 "
                                  "(dequantize_int4)"),
               decode_layer_gemms_m8=gemm)
    results["weight_dequant"] = row
    probes["weight_dequant int8"] = (calls["int8"], "weight_dequant_kernel",
                                     20, row)
    probes["weight_dequant int4"] = (calls["int4"], "weight_dequant_kernel",
                                     20, row["int4"])
    probes["decode layer GEMMs at M = 8"] = (gemms, None, 50, gemm)


def _dequantized_model(dev, cfg, seed, streamer):
    """A plain PagedCausalLM of ``seed`` whose streamed Linears hold the
    values ``streamer`` dequantizes (bf16 values kept in the f32 model:
    the serving cast gives them back exactly)."""
    from paddle_tpu_torch.inference import PagedCausalLM
    from paddle_tpu_torch.inference import weight_stream as TW

    m = PagedCausalLM(cfg, device=dev, seed=seed)
    with torch.no_grad():
        for kind in TW.STREAM_KINDS:
            for li, lin in enumerate(getattr(m, kind)):
                d = streamer.dequant_layer(li)[kind]
                lin.weight.copy_(d.float())
    return m


def _finish(eng, n=8):
    while eng.pending():
        if not eng.decode_run(n):
            eng.step()


def _all_graphs(eng):
    return sum(w.graph is not None for wins in eng._windows.values()
               for w in wins.values())


def phase_weight_stream(dev, serving, results, probes):
    """4e. Weight streaming and live weight versions at llama_1b (bf16).

    (1) the dequant kernel (phase_weight_dequant_kernel). (2) Engines
    with weight_stream "int4", "int8" and "int8-noprefetch" (the last two
    share one quantization) over a model of the serving phase's seed, each
    driving the serving phase's 8 requests twice (captures, then
    measured): a replayed decode step must launch RMSNorm 33, paged
    attention 16, weight_dequant 16 and rope_append 16 times; each engine's tokens must
    equal those of a plain bf16 engine whose weights are the dequantized
    ones, through the same route; the weights' bytes on the card, and peak
    memory. (3) measure_stream_win, prefetch against no prefetch, three
    times. (4) Versions on the int8 engine: a second model's set built,
    staged (timed), probed against a fresh engine over it; committed while
    4 rows are in flight, which finish with the tokens of an engine that
    never saw it, while new requests get a fresh version-1 engine's tokens
    through windows captured for version 1; rollback under 4 more rows
    gives version 0's streams; the freed version's windows gone and its
    memory back. (5) Nothing keeps a dropped engine's pools: an engine
    built, stepped and dropped gives its memory back."""
    import gc

    from paddle_tpu_torch import launch_counts, reset_launch_counts
    from paddle_tpu_torch.inference import (PagedCausalLM,
                                            PagedServingConfig,
                                            ServingEngine, build_weight_set,
                                            measure_stream_win)

    cfg = PagedServingConfig.llama_1b()
    L = cfg.num_layers
    phase_weight_dequant_kernel(dev, results, probes, cfg)
    model = PagedCausalLM(cfg, device=dev, seed=1234)   # the serving model's
    first, sampling = serving["first"], serving["sampling"]
    later = serving["prompts"][len(first):]
    bm = serving["metrics"]

    def clean():
        """Allocated bytes, after a collection. The cuBLAS workspaces
        PyTorch keeps a stream stay: the decode windows captured earlier
        (the int8 phase's, replayed in the profile phase) point at the one
        they ran with, and every capture's warm-up runs on one side stream
        a device (serving.py::_warmup_stream), so an engine adds none."""
        gc.collect()
        torch.cuda.synchronize()
        return torch.cuda.memory_allocated(dev)

    engines, out = {}, {}
    for ws in STREAM_MODES:
        m0 = clean()
        torch.cuda.reset_peak_memory_stats(dev)
        t = time.perf_counter()
        eng = ServingEngine.from_model(model, cfg, seed=7, device=dev,
                                       weight_stream=ws)
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t
        m1 = torch.cuda.memory_allocated(dev)
        warm = _serving_drive(eng, first, later, sampling, 48, False)
        reset_launch_counts()
        run = _serving_drive(eng, first, later, sampling, 48, True)
        counts = {k: n + run["carried"][k] for k, n in launch_counts().items()}
        if run["window"] is None:
            raise AssertionError(f"{ws}: every measured window captured")
        steps, n_tok, made = run["window"]
        want = {k: 0 for k in made}
        want.update(rms_norm=(2 * L + 1) * steps,
                    paged_attention=L * steps, weight_dequant=L * steps,
                    rope_append=L * steps)
        if made != want:
            raise AssertionError(f"a replayed {ws} decode window of {steps} "
                                 f"steps launched {made}, not {want}")
        fresh = run["per_step"]
        want_fresh = {k: 0 for k in fresh}
        want_fresh.update(rms_norm=2 * L + 1, varlen_attention_fwd=L,
                          weight_dequant=L, rope_append=L)
        if fresh != want_fresh:
            raise AssertionError(f"the {ws} fresh-prefill step launched "
                                 f"{fresh}, not {want_fresh}")
        for name in STREAM_KERNELS:
            if counts[name] <= 0:
                raise AssertionError(f"kernel {name} was not launched on the "
                                     f"{ws} streaming path")
        if counts["aligned16_copies"] or counts["rms_norm_bwd"]:
            raise AssertionError(f"the {ws} run counted {counts}")
        steady = [w for w in run["windows"] if not w[3]]
        ms, tps, n_steps = _window_rate(steady)
        set_bytes = nbytes(*eng._params)
        ws_bytes = nbytes(*eng._stream_ws.slots)
        engines[ws] = eng
        out[ws] = dict(
            run=run, counts=counts,
            metrics={
                "from_model_s": t_build,
                "decode_steps": n_steps, "decode_ms_per_step": ms,
                "decode_tokens_per_s": tps,
                "decode_ms_per_step_all_in": _window_rate(
                    warm["windows"])[0],
                "bf16_decode_ms_per_step": bm["decode_ms_per_step"],
                "fresh_prefill_step_ms": run["t_fresh"] * 1e3,
                "decode_launches_per_step": {k: n // steps
                                             for k, n in made.items()},
                "weight_set_bytes": set_bytes,
                "workspace_bytes": ws_bytes,
                "weights_bytes": set_bytes + ws_bytes,
                "from_model_allocated_bytes": m1 - m0,
                "kv_pool_bytes": nbytes(eng._kc, eng._vc),
                "peak_memory_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
                "peak_over_start_gb": (torch.cuda.max_memory_allocated(dev)
                                       - m0) / 1e9,
            })
        log(f"weight_stream {ws}: {json.dumps(out[ws]['metrics'])}")
    # the plain bf16 engine's weights: every parameter in bf16
    bf16_weights = 2 * sum(p.numel() for p in model.parameters())
    # each mode's tokens against a plain engine over its dequantized weights
    equal = {}
    for ws in STREAM_MODES:
        quant = "int4" if ws == "int4" else "int8"
        if quant not in equal:
            dq = _dequantized_model(dev, cfg, 1234, engines[quant]._streamer)
            plain = ServingEngine.from_model(dq, cfg, seed=7, device=dev)
            _serving_drive(plain, first, later, sampling, 48, False)
            equal[quant] = _serving_drive(plain, first, later, sampling, 48,
                                          False)["outs"]
            del plain, dq
        if out[ws]["run"]["outs"] != equal[quant]:
            same = sum(a == b for r, toks in out[ws]["run"]["outs"].items()
                       for a, b in zip(toks, equal[quant][r]))
            raise AssertionError(f"{ws}: the streamed engine's tokens differ "
                                 f"from the plain engine's over the "
                                 f"dequantized weights ({same} of "
                                 f"{sum(map(len, equal[quant].values()))} "
                                 f"equal)")
    n_tok = sum(map(len, equal["int8"].values()))
    log(f"weight_stream: int4, int8 and int8-noprefetch streams equal the "
        f"plain bf16 engine over their dequantized weights, {n_tok} tokens "
        f"each, through eager steps and window graphs")
    clean()

    # (3) the prefetch's price, in turns
    rng = np.random.RandomState(21)
    wprompts = _prompts(rng, [16] * 8, cfg.vocab_size)
    for ws in ("int8", "int8-noprefetch"):
        for p in wprompts:
            engines[ws].add_request(p, max_new_tokens=150)
        while any(r.length - r.cached > 1 for r in engines[ws].pending()):
            engines[ws].step()
    wins = []
    for _ in range(3):
        win_ms, t_s, t_b = measure_stream_win(
            lambda: engines["int8"].decode_run(8),
            lambda: engines["int8-noprefetch"].decode_run(8))
        wins.append(dict(win_ms_per_window=win_ms,
                         prefetch_ms_per_step=t_s * 1e3 / 8,
                         noprefetch_ms_per_step=t_b * 1e3 / 8))
    for ws in ("int8", "int8-noprefetch"):
        _finish(engines[ws], 32)
    log(f"measure_stream_win (8-step windows at batch 8, best of 3, "
        f"3 turns): {wins}")

    # (4) versions on the int8 engine
    eng = engines["int8"]
    model2 = PagedCausalLM(cfg, device=dev, seed=4321)
    t = time.perf_counter()
    arrays, crcs = build_weight_set(model2, None, cfg, weight_stream="int8")
    t_build_set = time.perf_counter() - t
    set_bytes = sum(a.numel() * a.element_size() for a in arrays)
    mem0 = clean()
    t = time.perf_counter()
    eng.stage_weight_set(1, arrays, crcs=crcs)
    torch.cuda.synchronize()
    t_stage = time.perf_counter() - t
    mem_staged = torch.cuda.memory_allocated(dev)
    del arrays
    ref1 = ServingEngine.from_model(model2, cfg, seed=7, device=dev,
                                    weight_stream="int8")
    probe = first[0][:64]
    if not np.array_equal(eng.probe_logits(probe, version=1),
                          ref1.probe_logits(probe)):
        raise AssertionError("probe_logits of the staged set differ from a "
                             "fresh engine's over those weights")
    if np.array_equal(eng.probe_logits(probe), ref1.probe_logits(probe)):
        raise AssertionError("the two weight sets probe the same logits")
    vp = _prompts(np.random.RandomState(22), [24, 40, 17, 33] * 3,
                  cfg.vocab_size)
    sp4 = sampling[:4]

    def start(e, prompts, rid0):
        e._next_rid = rid0
        rids = [e.add_request(p, max_new_tokens=40, sampling=sp)
                for p, sp in zip(prompts, sp4)]
        e.step()                                   # fresh prefill
        e.decode_run(8)
        return rids

    def streams(e, rids):
        return [list(e._requests[r].generated) for r in rids]

    rid0 = eng._next_rid
    rids0 = start(eng, vp[:4], rid0)
    t = time.perf_counter()
    eng.commit_weight_set(1)
    t_commit = time.perf_counter() - t
    rid1 = eng._next_rid
    rids1 = [eng.add_request(p, max_new_tokens=40, sampling=sp)
             for p, sp in zip(vp[4:8], sp4)]
    _finish(eng)
    if 1 not in eng._windows or not all(
            w.graph is not None for w in eng._windows[1].values()):
        raise AssertionError("no decode window captured for version 1")
    ref0 = ServingEngine.from_model(model, cfg, seed=7, device=dev,
                                    weight_stream="int8")
    start(ref0, vp[:4], rid0)
    _finish(ref0)
    ref1._next_rid = rid1
    for p, sp in zip(vp[4:8], sp4):
        ref1.add_request(p, max_new_tokens=40, sampling=sp)
    _finish(ref1)
    if streams(eng, rids0) != streams(ref0, rids0):
        raise AssertionError("rows in flight at the commit did not finish "
                             "with version 0's tokens")
    if streams(eng, rids1) != streams(ref1, range(rid1, rid1 + 4)):
        raise AssertionError("requests after the commit did not get "
                             "version 1's tokens")
    rid2 = eng._next_rid
    rids2 = start(eng, vp[8:], rid2)
    if {eng._requests[r].weight_version for r in rids2} != {1}:
        raise AssertionError("new requests were not pinned to version 1")
    t = time.perf_counter()
    eng.rollback_weight_set()
    t_rollback = time.perf_counter() - t
    if 1 in eng._windows or 1 in eng._weight_sets:
        raise AssertionError("rollback kept version 1's windows or set")
    _finish(eng)
    ref0._next_rid = rid2
    for p, sp in zip(vp[8:], sp4):
        ref0.add_request(p, max_new_tokens=40, sampling=sp)
    _finish(ref0)
    if streams(eng, rids2) != streams(ref0, rids2):
        raise AssertionError("rollback did not give version 0's streams")
    eng._gc_weight_sets()
    if set(eng._weight_sets) - {0} or set(eng._windows) - {0}:
        raise AssertionError(f"versions left after gc: sets "
                             f"{set(eng._weight_sets)}, windows "
                             f"{set(eng._windows)}")
    del ref0, ref1
    model2.__dict__.pop("_serving_shared", None)     # ref1's cast copy
    mem_after = clean()
    del model2
    if mem_after - mem0 >= set_bytes:
        raise AssertionError(f"memory after rollback and gc "
                             f"{mem_after} is not within a set of its value "
                             f"before staging {mem0}")
    versions = {
        "build_weight_set_s": t_build_set, "stage_s": t_stage,
        "commit_ms": t_commit * 1e3, "rollback_ms": t_rollback * 1e3,
        "set_bytes": set_bytes, "allocated_before_stage": mem0,
        "allocated_staged": mem_staged, "allocated_after_gc": mem_after,
        "streams_checked": 12,
    }
    log(f"weight versions (int8 engine): {json.dumps(versions)}")

    # (5) a dropped engine frees its pools (a first engine makes what the
    # model caches at first use: the cast copy and the rope table)
    cfg_b = PagedServingConfig.llama_1b()
    smodel = serving["model"]

    def engine_through_a_window():
        e = ServingEngine.from_model(smodel, cfg_b, seed=1, device=dev)
        e.add_request(first[0], max_new_tokens=4)
        e.step()
        e.decode_run(2)
        return e

    engine_through_a_window()
    before = clean()
    e = engine_through_a_window()
    held = clean() - before
    del e
    after = clean()
    if after != before or held <= 0:
        raise AssertionError(f"a dropped engine kept {after - before} bytes "
                             f"allocated (held {held} while alive)")
    log(f"repair: an engine holding {held} bytes after a step and a window "
        f"gave all of them back when dropped")
    metrics = {ws: o["metrics"] for ws, o in out.items()}
    metrics.update(
        bf16_weights_bytes=bf16_weights,
        bf16_peak_memory_gb=bm["peak_memory_gb"],
        prefetch_win=wins, versions=versions,
        dropped_engine_bytes_held=held)
    log(json.dumps({"weight_stream": metrics}))
    main_run = out["int8"]
    return dict(metrics=metrics, counts=main_run["counts"],
                run=main_run["run"],
                decode_launches_per_step=main_run["metrics"]
                ["decode_launches_per_step"],
                engines=engines, prompts=serving["prompts"],
                sampling=sampling)


@contextlib.contextmanager
def plain_kernels():
    """Inside, the kernels' wrappers run their plain PyTorch versions on
    the card's tensors: the route the exactness checks hold the kernels'
    route to. Patches the module attributes the serving path calls."""
    from paddle_tpu_torch.ops.kernels import kv_quant as KQ
    from paddle_tpu_torch.ops.kernels import paged_attention as PA
    from paddle_tpu_torch.ops.kernels import rms_norm as RN
    from paddle_tpu_torch.ops.kernels import rope_append as RA
    from paddle_tpu_torch.ops.kernels import varlen_attention as VA

    def paged(q, kc, vc, layer, t2b, pos, bt, ks=None, vs=None):
        return PA._paged_attention_ref(
            q, kc[layer], vc[layer], t2b, pos, bt,
            None if ks is None else ks[layer],
            None if vs is None else vs[layer])

    saved = (RN.rms_norm, VA._on_kernels, PA.paged_attention, KQ.kv_quant,
             RA.rope_append)
    RN.rms_norm = lambda x, weight=None, eps=1e-6: RN._rms_norm_ref(
        x, weight, eps)
    VA._on_kernels = lambda q: False
    PA.paged_attention = paged
    KQ.kv_quant = KQ._kv_quant_ref
    RA.rope_append = _plain_rope_append
    try:
        yield
    finally:
        (RN.rms_norm, VA._on_kernels, PA.paged_attention, KQ.kv_quant,
         RA.rope_append) = saved


def _plain_rope_append(qkv, kc, vc, ks, vs, layer, md, heads_first=False):
    """rope_append's plain version under the wrapper's signature."""
    from paddle_tpu_torch.ops.kernels import rope_append as RA

    return RA._rope_append_ref(qkv, kc, vc, ks, vs, layer, md,
                               heads_first=heads_first)


def phase_parity(dev, serving):
    """(a) 2-layer f32 engine greedy through decode_run's CUDA graphs ==
    forward_dense greedy, token for token; the same engine's model, f32,
    token for token equal to the plain engine's greedy streams, through
    (c) speculative verify steps (NGramDrafter taught the streams, k = 4),
    (d) prefix-cache hits (the suffixes as chunked steps over the cached
    pages) and (e) int8 pools, held to the int8 engine run with the plain
    kernels called directly on the card's tensors (TF32 is off); (b) bf16
    16-layer first-step logits near forward_dense. (The bf16 windows'
    tokens against the eager runner's, bit for bit, are held in the
    serving phase.) (f) the bf16 16-layer engine's greedy streams through
    rope_append against the same engine's with only rope_append patched to
    its plain version (_rope_append_streams)."""
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
    while any(r.length - r.cached > 1 for r in eng.pending()):
        eng.step()                              # to every decode tip
    while eng.pending():                        # replayed window graphs
        if not eng.decode_run(4):
            raise AssertionError("f32 decode_run made no progress")
    if not eng._window_fns or any(w.graph is None
                                  for w in eng._window_fns.values()):
        raise AssertionError("f32 parity: decode_run took no CUDA graph")
    outs = {rid: list(eng._requests[rid].generated) for rid in rids}
    dense = []
    for rid, p in zip(rids, prompts):
        ids = list(p)
        with torch.inference_mode():
            for _ in range(n_new):
                lg = m.forward_dense(torch.tensor([ids], device=dev))
                ids.append(int(lg[0, -1].argmax()))
        dense.append(ids[len(p):])
        if outs[rid] != ids[len(p):]:
            raise AssertionError(f"f32 greedy parity: request {rid} "
                                 f"{outs[rid]} != dense {ids[len(p):]}")
    log(f"parity (a) f32 2-layer full width: {len(rids)} greedy streams "
        f"through decode_run's replayed graphs ({len(eng._window_fns)} "
        f"windows) equal forward_dense token for token")
    _parity_features(dev, m, cfg, prompts, dense, n_new)

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
    _rope_append_streams(dev, serving)


def _rope_append_streams(dev, serving):
    """The bf16 llama_1b engine's greedy streams over the serving phase's 8
    prompts (a fresh-prefill step, mixed steps, then decode windows whose
    graphs it captures), twice on fresh engines over the same model: with
    rope_append, and with rope_append alone patched to its plain version on
    the card's tensors (every other kernel as it is; the bf16 paged kernel
    is held to a tolerance of its plain version, not to bits). The kernel
    is bit for bit its plain version and every GEMM keeps its shapes, so
    every token must be equal; the patched run must launch no rope_append
    kernel, the other at least one a layer."""
    from paddle_tpu_torch.inference import ServingEngine
    from paddle_tpu_torch.ops.kernels import rope_append as RA

    model, cfg = serving["model"], serving["cfg"]
    first = serving["first"]
    later = serving["prompts"][len(first):]
    greedy = [None] * len(serving["prompts"])
    runs = []
    for plain in (False, True):
        eng = ServingEngine.from_model(model, cfg, seed=7, device=dev)
        saved = RA.rope_append
        if plain:
            RA.rope_append = _plain_rope_append
        try:
            before = RA.launches
            outs = _serving_drive(eng, first, later, greedy, 32,
                                  False)["outs"]
            runs.append((outs, RA.launches - before))
        finally:
            RA.rope_append = saved
        del eng
    (got, n_kernel), (want, n_plain) = runs
    n_tok = sum(map(len, want.values()))
    if got != want or n_plain or n_kernel < cfg.num_layers \
            or n_tok != 32 * len(want):
        same = sum(a == b for r, toks in got.items()
                   for a, b in zip(toks, want[r]))
        raise AssertionError(f"bf16 greedy streams through rope_append: "
                             f"{same} of {n_tok} tokens equal the plain "
                             f"version's (rope_append launches {n_kernel} "
                             f"and {n_plain})")
    log(f"parity (f) bf16 16-layer greedy: {len(want)} streams, {n_tok} "
        f"tokens through rope_append ({n_kernel} launches counted) equal "
        f"the same engine's with only rope_append patched to its plain "
        f"version, token for token")


def _parity_features(dev, m, cfg, prompts, dense, n_new):
    """(c), (d) and (e) of phase_parity, on the f32 2-layer model."""
    from paddle_tpu_torch.inference import (NGramDrafter,
                                            PagedServingConfig,
                                            ServingEngine)

    # (c) speculative: verify steps of up to 5 tokens a row
    d = NGramDrafter(block_size=cfg.block_size)
    for p, r in zip(prompts, dense):
        d.observe(list(p) + r)
    spec = ServingEngine.from_model(m, cfg, seed=0, device=dev)
    spec.set_drafter(d, k=4)
    rids = [spec.add_request(p, max_new_tokens=n_new) for p in prompts]
    got = spec.run_to_completion()
    st = spec.spec_stats()
    if [got[r] for r in rids] != dense or not st["accepted"]:
        raise AssertionError(f"f32 speculative streams {got} != the plain "
                             f"engine's {dense} (accepted {st['accepted']})")
    _conserved(spec)
    log(f"parity (c) f32 speculative: {len(rids)} streams through "
        f"{st['steps']} verify steps ({st['accepted']} of {st['drafted']} "
        f"drafts accepted) equal the plain engine's token for token")

    # (d) prefix hits: a 96-token prefix (3 pages) shared, suffixes run as
    # chunked steps over the cached pages
    rng = np.random.RandomState(6)
    shared = list(rng.randint(1, cfg.vocab_size, 96))
    pp = [shared + list(rng.randint(1, cfg.vocab_size, n))
          for n in (20, 33, 50)]
    streams, hits = {}, []
    for label, c in (("plain", cfg),
                     ("prefix", PagedServingConfig.llama_1b(
                         num_layers=2, dtype="float32", prefix_cache=True))):
        e = ServingEngine.from_model(m, c, seed=0, device=dev)
        streams[label] = []
        for p in pp:                       # one after another: warm hits
            rid = e.add_request(p, max_new_tokens=n_new)
            if label == "prefix":
                hits.append(e._requests[rid].cached)
            streams[label].append(e.run_to_completion()[rid])
        _conserved(e)
    if streams["prefix"] != streams["plain"] or hits != [0, 96, 96]:
        raise AssertionError(f"f32 prefix-hit streams {streams['prefix']} "
                             f"!= the plain engine's {streams['plain']} "
                             f"(hits {hits})")
    log(f"parity (d) f32 prefix cache: {len(pp)} streams, hits at admission"
        f" {hits} tokens, equal the plain engine's token for token")

    # (e) int8 pools: the kernels' route (decode through the windows'
    # graphs) against the plain versions on the card's tensors (eager)
    cfg8 = PagedServingConfig.llama_1b(num_layers=2, dtype="float32",
                                       cache_quant="int8")
    outs = []
    for plain in (False, True):
        e = ServingEngine.from_model(m, cfg8, seed=0, device=dev)
        with plain_kernels() if plain else contextlib.nullcontext():
            rids = [e.add_request(p, max_new_tokens=n_new)
                    for p in prompts[:2]]
            e.step()                            # fresh prefill
            rids.append(e.add_request(prompts[2], max_new_tokens=n_new))
            while any(r.length - r.cached > 1 for r in e.pending()):
                e.step()
            while e.pending():
                run = e._decode_run_eager if plain else e.decode_run
                if not run(4):
                    raise AssertionError("int8 decode made no progress")
        if not plain and any(w.graph is None for w in e._window_fns.values()):
            raise AssertionError("int8 parity: decode_run took no graph")
        outs.append([list(e._requests[r].generated) for r in rids])
    equal_dense = sum(a == b for s, r in zip(outs[0], dense)
                      for a, b in zip(s, r))
    if outs[0] != outs[1]:
        raise AssertionError(f"f32 int8 streams {outs[0]} != the plain "
                             f"versions' {outs[1]}")
    log(f"parity (e) f32 int8 pools: {len(outs[0])} streams through the "
        f"kernels (decode_run's graphs) equal the plain versions' on the "
        f"card token for token; {equal_dense} of "
        f"{sum(map(len, dense))} tokens equal the f32 pools' streams")


def main_hybrid():
    """``python3 chip_smoke.py --hybrid``: the build, then phase_hybrid at
    every world of 2 and 4 the host's cards allow (the multi-card run:
    parity at mp 2, mp 2 x sharding 2, the pp and the sep meshes, the eager
    pipeline engines over NCCL, and the Llama-2 7B rows); fails if the
    pipeline path missed a training kernel on every stage."""
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} x {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    phase_device_and_build()
    dev = torch.device("cuda", 0)
    worlds = [w for w in (2, 4) if w <= torch.cuda.device_count()]
    if not worlds:
        raise AssertionError("--hybrid needs 2 or more cards")
    pipeline = Counter()
    for world in worlds:
        pipeline.update(phase_hybrid(dev, world)["pipeline_counts"])
        # once the ranks have let go of the cards: mp 2, then dp 2 x mp 2
        phase_launch(dev, world, (world // 2, 2))
    log(json.dumps({"pipeline_launches_every_stage": {
        k: pipeline[k] for k in TRAINING_KERNELS}}))
    if min(pipeline[k] for k in TRAINING_KERNELS) <= 0:
        raise AssertionError(f"the pipeline path missed a kernel: "
                             f"{dict(pipeline)}")
    log(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


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
    if sys.argv[1:] == ["--hybrid"]:
        return main_hybrid()
    dev = paddle_tpu_torch.resolve_device("cuda")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    hgmma, ptxas = phase_device_and_build()
    kernels, probes = phase_kernels(dev)
    phase_flash_kernels(dev, kernels, probes)
    phase_flash_d64(dev, kernels, probes)
    sep = phase_sep(dev)
    phase_varlen_bwd_kernels(dev, kernels, probes)
    serving = phase_serving(dev)
    artifact = phase_artifact(dev, serving)
    phase_paged_kernel(dev, kernels, probes, serving)
    phase_int8_kernels(dev, kernels, probes, serving)
    phase_rope_append_kernel(dev, kernels, probes, serving)
    phase_parity(dev, serving)
    int8 = phase_int8_serving(dev, serving)
    phase_prefix_cache(dev, serving)
    phase_speculative(dev, serving)
    stream = phase_weight_stream(dev, serving, kernels, probes)
    training = phase_training(dev)
    phase_training_parity(dev)
    # the eager phase after the packed ones: its model, gradients and AdamW
    # moments stay allocated for the profile phase, and the packed step is
    # timed before they exist (tools/torch_packed_after_eager.py)
    packed = phase_packed_training(dev)
    phase_packed_parity(dev)
    eager = phase_eager(dev)
    pretrain = {kind: phase_pretrain(dev, kind) for kind in PRETRAIN}
    phase_registry_ops(dev)
    phase_moe(dev)
    hybrid = phase_hybrid(dev)
    launch = phase_launch(dev, 1, (1, 1))
    vision = phase_vision(dev)
    phase_profile(dev, serving, training, packed, kernels, probes, int8,
                  stream, artifact, eager, pretrain, vision)
    by_path = {"serving": serving["counts"], "int8_serving": int8["counts"],
               "training": training["counts"],
               "packed_training": packed["counts"],
               "weight_stream": stream["counts"],
               "artifact": artifact["counts"], "eager": eager["counts"],
               "hybrid": hybrid["counts"],
               "pipeline": Counter(hybrid["pipeline_counts"]),
               "sep": sep["counts"], "auto_parallel": launch["counts"]}
    by_path.update(hybrid["path_counts"])
    by_path.update({kind: r["counts"] for kind, r in pretrain.items()})
    per_step = {p: {k: {"fresh_prefill_step": n,
                        "decode_step": r["metrics"]["decode_launches_per_step"]
                        [k]}
                    for k, n in r["run"]["per_step"].items()}
                for p, r in (("serving", serving), ("int8_serving", int8),
                             ("weight_stream", dict(stream, metrics={
                                 "decode_launches_per_step":
                                 stream["decode_launches_per_step"]})))}
    per_step.update({
                "training": training["metrics"]["launches_per_step"],
                "packed_training": packed["metrics"]["launches_per_step"],
                "artifact": artifact["per_step"],
                "eager": eager["metrics"]["launches_per_step"],
                "hybrid": hybrid["launches_per_step"],
                "pipeline": {k: {job: {stage: per[k] for stage, per in
                                       stages.items()}
                                 for job, stages in
                                 hybrid["pipeline_per_step"].items()}
                             for k in TRAINING_KERNELS},
                "sep": sep["per_call"],
                "auto_parallel": launch["launches_per_step"]})
    per_step.update(hybrid["path_per_step"])
    per_step.update({kind: r["metrics"]["launches_per_step"]
                     for kind, r in pretrain.items()})
    line = []
    for name, r in kernels.items():
        r = dict(r)
        # a D = 64 row counts its model's path; the others every path that
        # runs their kernel at the shapes they were timed at
        kernel = r.pop("kernel", name)
        paths = r.pop("paths", None) or [p for p, kset in PATHS.items()
                                         if kernel in kset]
        r["launches"] = sum(by_path[p][kernel] for p in paths)
        r["launches_by_path"] = {p: by_path[p][kernel] for p in paths}
        r["launches_per_step"] = {p: per_step[p].get(kernel)
                                  for p in paths}
        if SASS_SYMBOLS.get(kernel) in hgmma:
            r["sass_hgmma"] = hgmma[SASS_SYMBOLS[kernel]]
        sym = SASS_SYMBOLS.get(kernel, "")
        regs = {f: v for f, v in ptxas.items() if f.startswith(sym + "<")}
        if sym and regs:
            r["ptxas"] = regs
        line.append(r)
    log(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
