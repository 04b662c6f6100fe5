"""Disaggregated prefill/decode serving over the CRC/ACK TensorTransport
(port of paddle_tpu/inference/disagg.py).

Fleet-scale engines split the two serving phases onto different workers:
a PREFILL worker runs the compute-bound chunked prefill (the varlen
flash ``fresh_prefill`` specialization) and a DECODE worker runs the
weight-streaming-bound token loop — so a long prompt arriving never
spikes the TPOT of sequences already decoding (the P/D-disaggregation
deployments of production stacks: Splitwise / DistServe / vLLM-PD).

The hand-off ships, per request, over ``distributed.TensorTransport``
(CRC32-framed, ACK/NAK retransmit, idempotent dedup — a dropped or
corrupted frame is retried transparently and counted in ``comm/*``):

  1. a JSON metadata frame (prompt, progress, sampling, origin salt
     identity),
  2. the request's raw KV pages gathered from the prefill engine's pool
     (``[L, n_pages, HKV, block_size, D]``, plus the per-page scale
     pools when the cache is int8-quantized).

The page gather is one device-to-host copy a pool (the transport carries
CPU tensors in their own dtype, bf16 as bf16). The decode engine writes
the pages into ITS pool at freshly allocated page ids IN PLACE (an index
copy into ``_kc``/``_vc`` and the scale pools, never a rebinding: the
decode windows' CUDA graphs hold the pools' addresses) and resumes at the
decode tip. Because the KV bytes transfer verbatim, the sampling salts
keep the origin ``(seed, rid)`` identity, and both engines run the same
model and config, the decode-side token stream is the single-engine one
token for token (in f32; a bf16 step's GEMMs depend on its batch shape).
"""
from __future__ import annotations

import json
import time
from typing import List, Optional

import numpy as np
import torch

from ..distributed.resilience import faults as _faults
from ..distributed.resilience.errors import (EngineDeadError,
                                             PeerUnreachableError)
from ..profiler import metrics as _metrics
from ..profiler import tracing as _tracing
from .serving import SamplingParams, ServingEngine, _Request

__all__ = ["migrate_request", "receive_request", "PrefillWorker",
           "DecodeWorker", "DISAGG_CHANNEL"]

DISAGG_CHANNEL = "disagg"

_m_migrations = _metrics.counter("serving/migrations")


def migrate_request(engine: ServingEngine, rid: int, transport,
                    dst: int, channel: str = DISAGG_CHANNEL) -> None:
    """Ship request ``rid`` (fully prefilled, at its decode tip) from
    ``engine`` to the decode worker at transport rank ``dst``.  The
    source request finishes locally (pages released); ownership moves to
    the receiver."""
    r = engine._requests[rid]
    if r.done:
        raise ValueError(f"request {rid} already finished")
    if r.length - r.cached != 1:
        raise ValueError(
            f"request {rid} is not at its decode tip "
            f"(cached={r.cached}, length={r.length}): finish prefill "
            f"before migrating")
    # chaos site, consulted BEFORE the first frame ships so a failure
    # here never leaves a half-sent hand-off on the wire: ``drop`` means
    # the dying engine cannot ship its pages (PeerUnreachableError — the
    # supervisor falls back to requeue), ``kill`` fells the source
    # engine itself
    act = _faults.injector.on_event("migrate",
                                    getattr(engine, "fault_rank", 0),
                                    peer=dst)
    if act is not None:
        if act.kind == "drop":
            raise PeerUnreachableError(dst, None, 1)
        if act.kind == "kill":
            engine.dead = True
            raise EngineDeadError(getattr(engine, "name", "engine"),
                                  "migrate")
        if act.kind == "delay":
            import time as _time

            _time.sleep(act.delay_ms / 1e3)
    pages = np.asarray(r.pages, np.int64)
    sp = r.sampling
    # the migrate span's context ships in the meta frame: the receiver
    # parents its migrate_in span (and everything after) to it, so the
    # request's pre- and post-migration spans share one trace id
    t_mig0 = time.perf_counter()
    mig_ctx = _tracing.child_of(r.trace) if r.trace is not None else None
    meta = {
        "prompt": list(r.prompt),
        "generated": list(r.generated),
        "max_new": int(r.max_new),
        "cached": int(r.cached),
        "eos_token_id": r.eos_token_id,
        "sampling": [sp.temperature, sp.top_k, sp.top_p],
        "salt_rid": int(r.salt_rid),
        "salt_seed": int(engine.seed if r.salt_seed is None
                         else r.salt_seed),
        "quant": engine._ks is not None,
        "n_pages": int(pages.size),
        # the stream's pinned weight version travels with its KV: the
        # receiver resumes under the SAME version (its pages were
        # produced by those params) — version-bitwise hand-off identity
        "weight_version": int(getattr(r, "weight_version", 0) or 0),
    }
    if mig_ctx is not None:
        _tracing.inject(meta, mig_ctx)
    transport.send(np.frombuffer(json.dumps(meta).encode(), np.uint8),
                   dst, channel)
    # raw page gather: [L, n_pages, HKV, block_size, D] in the cache
    # dtype, one device-to-host copy a pool: the KV bytes the decode
    # engine resumes from, verbatim
    idx = torch.from_numpy(pages).to(engine._kc.device)
    pools = [engine._kc, engine._vc]
    if meta["quant"]:
        pools += [engine._ks, engine._vs]
    for pool in pools:
        transport.send(pool.index_select(1, idx).cpu(), dst, channel)
    if mig_ctx is not None:
        _tracing.record_span(
            "serving::migrate", t_mig0, time.perf_counter(), ctx=mig_ctx,
            args={"rid": rid, "engine": getattr(engine, "name", "?"),
                  "dst": dst})
    _m_migrations.inc()
    r.done = True
    engine._release(r)


def receive_request(engine: ServingEngine, transport, src: int,
                    channel: str = DISAGG_CHANNEL) -> int:
    """Install one migrated request into ``engine``: allocate pages,
    scatter the shipped KV into this engine's pool, and admit the
    request at its decode tip under its ORIGIN salt identity.  Returns
    the local rid."""
    t_rx0 = time.perf_counter()
    meta = json.loads(bytes(transport.recv(src, channel)).decode())
    kc = transport.recv(src, channel)
    vc = transport.recv(src, channel)
    scales = None
    if meta["quant"]:
        if engine._ks is None:
            raise ValueError("int8-KV request migrated to a non-quant "
                             "decode engine (configs must match)")
        scales = (transport.recv(src, channel),
                  transport.recv(src, channel))
    writes = [(engine._kc, kc), (engine._vc, vc)]
    if scales is not None:
        writes += [(engine._ks, scales[0]), (engine._vs, scales[1])]
    for pool, part in writes:
        if part.dtype != pool.dtype:
            raise ValueError(f"migrated pages are {part.dtype}, this "
                             f"engine's pool is {pool.dtype} (configs "
                             f"must match)")
    n_pages = int(meta["n_pages"])
    pages = [engine._take_free_page() for _ in range(n_pages)]
    # in place: the pools keep their storage (captured decode windows
    # replay against these addresses)
    idx = torch.tensor(pages, dtype=torch.int64, device=engine._kc.device)
    for pool, part in writes:
        pool.index_copy_(1, idx, part.to(pool.device))

    rid = engine._next_rid
    engine._next_rid += 1
    t, k, p = meta["sampling"]
    req = _Request(rid, meta["prompt"], meta["max_new"],
                   SamplingParams(t, k, p), meta["eos_token_id"])
    req.generated = [int(x) for x in meta["generated"]]
    req.cached = int(meta["cached"])
    req.pages = pages
    req.salt_rid = int(meta["salt_rid"])
    req.salt_seed = int(meta["salt_seed"])
    # resume under the pinned origin version ("weight_version" absent
    # in pre-publish senders: the build-time set). The decode engine
    # must be able to serve it — a version it neither serves nor
    # retains would silently decode the shipped KV under the WRONG
    # params, so fail the hand-off loudly instead.
    wv = int(meta.get("weight_version", 0) or 0)
    if hasattr(engine, "has_weight_version") \
            and not engine.has_weight_version(wv):
        engine._release(req)
        raise ValueError(
            f"migrated request pinned to weight version {wv}, but "
            f"decode engine {getattr(engine, 'name', '?')} serves "
            f"{engine.active_weight_version} and does not retain it")
    req.weight_version = wv
    # TTFT was observed on the prefill worker (the first token samples
    # there); suppress a second observation on this engine
    req.first_tok_t = req.submit_t
    # adopt the shipped trace identity: the migrate_in span parents to
    # the sender's migrate span, and the request's later decode spans
    # parent to migrate_in — one connected tree across both engines
    mig_ctx = _tracing.extract(meta)
    if mig_ctx is not None:
        req.trace = _tracing.record_span(
            "serving::migrate_in", t_rx0, time.perf_counter(),
            parent=mig_ctx,
            args={"rid": rid, "engine": getattr(engine, "name", "?"),
                  "src": src})
    engine._requests[rid] = req
    _m_migrations.inc()
    return rid


class PrefillWorker:
    """Prefill side of the disaggregated pair: admits requests, drives
    chunked prefill to the decode tip (first token sampled here — TTFT
    is a prefill-side number), then migrates each request's KV pages +
    state to the decode worker."""

    def __init__(self, engine: ServingEngine, transport, decode_rank: int,
                 channel: str = DISAGG_CHANNEL):
        self.engine = engine
        self.transport = transport
        self.decode_rank = decode_rank
        self.channel = channel
        self._live: List[int] = []

    def submit(self, prompt_tokens, **kw) -> int:
        rid = self.engine.add_request(prompt_tokens, **kw)
        self._live.append(rid)
        return rid

    def pump(self, max_steps: int = 1000) -> List[int]:
        """Run prefill steps until every live request migrated (or
        finished locally — a max_new==1 request never reaches the decode
        worker).  Returns the migrated rids."""
        moved: List[int] = []
        for _ in range(max_steps):
            if not self._live:
                break
            self.engine.step()
            for rid in list(self._live):
                r = self.engine._requests[rid]
                if r.done:
                    self._live.remove(rid)
                elif r.generated and r.length - r.cached == 1:
                    migrate_request(self.engine, rid, self.transport,
                                    self.decode_rank, self.channel)
                    self._live.remove(rid)
                    moved.append(rid)
        return moved


class DecodeWorker:
    """Decode side: accepts migrated requests and runs the multi-step
    decode windows (one host sync per window), prefill-free — no
    prefill chunk ever lands in its step batches, so TPOT stays flat."""

    def __init__(self, engine: ServingEngine, transport,
                 prefill_rank: int, channel: str = DISAGG_CHANNEL):
        self.engine = engine
        self.transport = transport
        self.prefill_rank = prefill_rank
        self.channel = channel

    def accept(self, n: int = 1) -> List[int]:
        return [receive_request(self.engine, self.transport,
                                self.prefill_rank, self.channel)
                for _ in range(n)]

    def run(self, window: int = 16, max_steps: int = 1000) -> dict:
        """Decode every accepted request to completion; returns
        {local_rid: generated tokens}."""
        for _ in range(max_steps):
            if not self.engine.pending():
                break
            if self.engine._drafter is not None:
                # speculative engine: step() diverts decode-tip batches
                # through the draft+verify path (more tokens per
                # dispatch than the one-token-per-step scan window)
                self.engine.step()
            elif not self.engine.decode_run(window):
                self.engine.step()      # page-tight fallback (can preempt)
        return {rid: list(r.generated)
                for rid, r in self.engine._requests.items()}
