"""Live weight publishing: versioned hot-swap into a serving fleet (port
of paddle_tpu/inference/weight_publish.py).

The trainer keeps producing better weights while the fleet serves; this
module moves them into live engines without draining:

1. **Build**: ``build_weight_set`` runs new parameters through
   ``ServingEngine.from_model``'s serving pipeline. A set is the engine's
   flat weight list: the floating parameters cast to the serving dtype, in
   sorted name order (the order ``jax.tree_util.tree_flatten`` gives a
   dict in the reference), each streamed decoder Linear a 0-d placeholder
   under ``weight_stream``, then its codes and scales, (kind, layer) in
   STREAM_KINDS order. The reference's host arrays and CRC-32s slot in
   position for position. ``publish_from_checkpoint`` feeds it from a
   ``distributed.checkpoint`` directory.
2. **Ship**: ``send_weight_set`` / ``receive_weight_set`` frame a set over
   the CRC/ACK ``TensorTransport`` surface (a JSON meta frame with each
   tensor's dtype, shape and CRC-32, then each tensor's bytes as a uint8
   frame). The receiving engine checks every CRC before staging
   (``WeightTransferError`` drops a torn set) and keeps the staged
   version N+1 beside the serving N.
3. **Canary**: the first healthy replica stages N+1 and is probed over a
   golden prompt set through ``probe_logits`` against the STAGED set, so a
   poisoned version serves no token anywhere: a nonfinite logit refuses
   it (``canary_nonfinite``), so does the candidate's NLL of the active
   version's greedy token past the policy's bound (``canary_drift``).
4. **Promote**: on a pass the fleet commits replica by replica, each swap
   at a step boundary; every request streams under the one version pinned
   at its admission, and a replica killed mid-transfer (``kill@publish``)
   keeps N whole. Rollout epochs are fenced through the store
   (``fenced_set``): a stale controller's publish is refused with
   ``PublishRejectedError('stale_version')``, and a replica offline during
   the rollout catches up at restart (``FleetSupervisor.weight_catchup``).
5. **Rollback**: every engine goes back to the kept N set
   (``rollback_weight_set``); in-flight streams pinned to the bad version
   restart under N with their origin salts, so they regenerate the
   pre-publish tokens.

``publish(draft_params=...)`` republishes a ``DraftModelDrafter``'s
weights, or swaps speculation down to an ``NGramDrafter``;
``check_spec_health`` alarms when a post-swap accept rate collapses.
"""
from __future__ import annotations

import json
import time
import zlib
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..distributed.resilience.errors import (EngineDeadError,
                                             PeerUnreachableError,
                                             PublishRejectedError,
                                             StaleGenerationError,
                                             TransportError,
                                             WeightTransferError)
from ..profiler import metrics as _metrics
from ..profiler import tracing as _tracing
from .weight_stream import WeightStreamer

__all__ = ["PublishPolicy", "PublishReport", "WeightPublisher",
           "build_weight_set", "send_weight_set", "receive_weight_set",
           "host_tensor", "crc32", "PUBLISH_CHANNEL"]

PUBLISH_CHANNEL = "publish"

_m_publishes = _metrics.counter("serving/weight_publishes")
_m_rejected = _metrics.counter("serving/publish_rejected")
_m_canary_fail = _metrics.counter("serving/canary_failures")
_m_bytes = _metrics.counter("serving/publish_bytes")
_m_ms = _metrics.histogram("serving/publish_ms")
_m_catchups = _metrics.counter("serving/publish_catchups")
_m_missed = _metrics.counter("serving/publish_missed")
_m_drafter_repub = _metrics.counter("serving/spec_drafter_republished")
_m_drafter_fb = _metrics.counter("serving/spec_drafter_fallbacks")
_m_accept_alarm = _metrics.counter("serving/spec_accept_alarms")

# the wire's dtype names (numpy's, as the reference writes them)
_WIRE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "float16": torch.float16, "float64": torch.float64,
                "int8": torch.int8, "uint8": torch.uint8,
                "int16": torch.int16, "int32": torch.int32,
                "int64": torch.int64, "bool": torch.bool}
_WIRE_NAMES = {v: k for k, v in _WIRE_DTYPES.items()}


def host_tensor(a) -> torch.Tensor:
    """A weight-set entry as a contiguous CPU tensor of its own dtype: a
    tensor (any device), or a numpy array; bfloat16 arrives as ml_dtypes'
    type from the reference and keeps its bits."""
    if isinstance(a, torch.Tensor):
        return a.detach().contiguous().cpu()
    a = np.asarray(a)
    if not (a.flags.c_contiguous and a.flags.writeable):
        a = a.copy(order="C")          # ascontiguousarray makes 0-d 1-d
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def crc32(t: torch.Tensor) -> int:
    """CRC-32 of a CPU tensor's bytes in C order: the reference's
    ``zlib.crc32(array.tobytes())``."""
    raw = t.contiguous().reshape(-1).view(torch.uint8).numpy()
    return zlib.crc32(raw) & 0xFFFFFFFF


def build_weight_set(model, params, cfg, weight_stream=None
                     ) -> Tuple[List[torch.Tensor], List[int]]:
    """Run new parameters through ``ServingEngine.from_model``'s serving
    pipeline: floating entries cast to ``cfg.dtype``, the decoder Linear
    stacks quantized out under ``weight_stream`` (int8 per channel or int4
    grouped, each replaced by the 0-d placeholder), the entries in sorted
    name order with the streamed codes and scales after them. ``params``
    maps ``model``'s parameter names to tensors or numpy arrays (None: the
    model's own). Returns ``(host tensors, crcs)`` in exactly the flat order
    of an engine built with the same ``(cfg.dtype, weight_stream)``, which
    ``stage_weight_set`` accepts position for position."""
    if params is None:
        params = dict(model.named_parameters())
    tgt = cfg.torch_dtype
    cast = {}
    for name, a in params.items():
        t = a.detach() if isinstance(a, torch.Tensor) else host_tensor(a)
        if t.is_floating_point():
            t = t.to(tgt)               # on its own device: the same bits
        cast[name] = t.cpu()
    flat = []
    if weight_stream is not None:
        streamer = WeightStreamer.build(
            model, cast, tgt, prefetch=weight_stream != "int8-noprefetch",
            mode="int4" if weight_stream == "int4" else "int8",
            device="cpu")
        flat = streamer.flat()
    host = [cast[n].contiguous() for n in sorted(cast)] + flat
    return host, [crc32(t) for t in host]


def _host_params(named) -> Dict[str, torch.Tensor]:
    """A name -> tensor or numpy array map as CPU tensors (the publisher's
    retained source of a version)."""
    return {k: (v.detach().cpu().clone() if isinstance(v, torch.Tensor)
                else host_tensor(v)) for k, v in named.items()}


# ---------------------------------------------------------------------------
# wire format: meta frame + per-tensor byte frames
# ---------------------------------------------------------------------------

def send_weight_set(transport, dst: int, version: int, arrays,
                    crcs: Sequence[int],
                    channel: str = PUBLISH_CHANNEL) -> int:
    """Ship one versioned weight set (weight_publish.py:154-177): a JSON
    meta frame (version, each tensor's dtype name, shape and CRC-32), then
    each tensor's raw bytes as a uint8 frame. ``arrays``: tensors or numpy
    arrays. Returns the payload bytes shipped."""
    host = [host_tensor(a) for a in arrays]
    meta = {"version": int(version), "n": len(host),
            "dtypes": [_WIRE_NAMES[t.dtype] for t in host],
            "shapes": [list(t.shape) for t in host],
            "crcs": [int(c) for c in crcs]}
    transport.send(np.frombuffer(json.dumps(meta).encode(), np.uint8),
                   dst, channel)
    total = 0
    for t in host:
        b = t.reshape(-1).view(torch.uint8).numpy()
        transport.send(b, dst, channel)
        total += int(b.size)
    _m_bytes.inc(total)
    return total


def receive_weight_set(engine, transport, src: int,
                       channel: str = PUBLISH_CHANNEL) -> int:
    """Receive one weight set and stage it (kept beside the serving set,
    not serving) into ``engine`` (weight_publish.py:180-195). The engine
    checks every CRC against the meta frame before staging: a byte torn
    anywhere between the builder and the buffer raises
    ``WeightTransferError`` and leaves the active version as it was.
    Returns the staged version."""
    meta = json.loads(bytes(np.asarray(transport.recv(src, channel),
                                       np.uint8)).decode())
    arrays = []
    for dt, shape in zip(meta["dtypes"], meta["shapes"]):
        raw = torch.from_numpy(np.asarray(transport.recv(src, channel),
                                          np.uint8))
        arrays.append(raw.view(_WIRE_DTYPES[dt]).reshape(shape))
    engine.stage_weight_set(int(meta["version"]), arrays,
                            crcs=[int(c) for c in meta["crcs"]])
    return int(meta["version"])


# ---------------------------------------------------------------------------
# policy + report
# ---------------------------------------------------------------------------

def _default_golden_prompts(vocab_size: int
                            ) -> Tuple[Tuple[int, ...], ...]:
    hi = max(int(vocab_size) - 1, 2)
    raw = ((1, 2, 3, 4, 5, 6), (5, 3, 2, 7), (11, 4, 9, 2, 6, 1))
    return tuple(tuple(1 + (t % (hi - 1)) for t in p) for p in raw)


def _nll(logits, tok: int) -> float:
    x = np.asarray(logits, np.float64)
    m = float(x.max())
    return m + float(np.log(np.sum(np.exp(x - m)))) - float(x[tok])


@dataclass
class PublishPolicy:
    """Canary gate + drafter-health knobs.

    ``golden_prompts`` is the probe set (defaults to a fixed small set
    folded into the model's vocab); ``drift_nll_factor``/
    ``drift_nll_slack`` bound how much worse (in nats) the candidate
    may score the active version's greedy continuation before the
    publish is refused; ``accept_alarm_factor`` is the post-swap
    speculative accept-rate floor, as a fraction of the pre-swap
    baseline, below which ``check_spec_health`` alarms."""

    golden_prompts: Optional[Sequence[Sequence[int]]] = None
    drift_nll_factor: float = 4.0
    drift_nll_slack: float = 2.0
    accept_alarm_factor: float = 0.5


@dataclass
class PublishReport:
    """What one publish actually did, replica by replica."""

    version: int
    canary: Optional[str]
    committed: List[str]
    missed: List[str]
    publish_s: float
    bytes_shipped: int


# ---------------------------------------------------------------------------
# the publisher
# ---------------------------------------------------------------------------

class WeightPublisher:
    """Rollout controller for one serving fleet.

    Owns the version counter, the fenced store epoch, the per-mode
    payload cache (for restart catch-up), and the canary policy.
    ``publish`` is the whole rollout — build, canary, promote — and
    either commits fleet-wide or raises ``PublishRejectedError``
    leaving the fleet serving exactly what it served before.

    Wired into the recovery path: constructing with ``supervisor=``
    installs ``catch_up`` as the supervisor's ``weight_catchup`` hook,
    so a replica restarted after a crash (including ``kill@publish``)
    is brought to the committed version before re-entering rotation.
    """

    def __init__(self, router, model, store=None, domain: str = "weights",
                 supervisor=None, policy: Optional[PublishPolicy] = None,
                 transport_factory: Optional[Callable] = None):
        self.router = router
        self.model = model
        self.store = store
        self.domain = domain
        self.supervisor = supervisor
        self.policy = policy or PublishPolicy()
        self._transport_factory = transport_factory
        self.version = 0          # last fleet-committed epoch
        self._next = 1            # next epoch a publish will claim
        # True while a publish() epoch is between its fence claim and
        # its terminal state (committed/rejected).  The autoscaler
        # freezes resize actions on this flag: a replica joining
        # mid-promote would race the payload build, and one retiring
        # mid-canary could strand the only staged copy.
        self.in_flight = False
        # per-version source params (host) + per-(version, mode) payload
        # cache: catch_up rebuilds any mode a late replica needs, and
        # rollback re-anchors on the PREVIOUS version's source — so two
        # generations of source are retained
        self._history: Dict[int, Dict[str, torch.Tensor]] = {}
        self._payloads: Dict[Tuple[int, Optional[str]],
                             Tuple[List[torch.Tensor], List[int]]] = {}
        self._draft_state = None
        self._accept_baseline: Dict[str, float] = {}
        if store is not None:
            # a fresh controller (restarted, or a second one taking
            # over) resumes AFTER the last epoch the store has seen —
            # it must never re-claim a consumed epoch number
            try:
                cur = json.loads(bytes(store.get_nowait(
                    f"publish/{domain}/manifest")).decode())
                self._next = int(cur.get("version", 0)) + 1
            except (KeyError, ValueError):
                pass
        if supervisor is not None:
            supervisor.weight_catchup = self.catch_up

    # -- transport ---------------------------------------------------------
    def _transport(self):
        if self._transport_factory is not None:
            return self._transport_factory()
        from .fleet_supervisor import LoopbackTransport

        return LoopbackTransport()

    def _ship(self, engine, version: int,
              payload: Tuple[List[torch.Tensor], List[int]]) -> int:
        arrays, crcs = payload
        tp = self._transport()
        n = send_weight_set(tp, 0, version, arrays, crcs)
        receive_weight_set(engine, tp, 0)
        return n

    # -- store fencing -----------------------------------------------------
    def _fence(self, version: int, state: str, **extra) -> None:
        """Claim rollout epoch ``version`` in the store.  The fenced
        write IS the split-brain guard: a second controller (or a
        zombie that slept through a newer rollout) loses here with
        ``stale_version`` before any replica stages a byte."""
        if self.store is None:
            return
        key = f"publish/{self.domain}/manifest"
        if state == "staging":
            # same-epoch exclusivity on top of the generation fence:
            # fenced_set admits EQUAL generations (two writes within one
            # epoch are legitimate — staging then committed), so a
            # second controller re-claiming an already-claimed epoch
            # must be refused by reading the manifest it would clobber
            try:
                cur = json.loads(bytes(self.store.get_nowait(key)
                                       ).decode())
            except (KeyError, ValueError):
                cur = None
            if cur is not None and int(cur.get("version", -1)) \
                    >= int(version):
                _m_rejected.inc()
                raise PublishRejectedError(
                    "stale_version", int(version),
                    fence_version=int(cur["version"]),
                    detail=f"epoch {cur['version']} already "
                           f"{cur.get('state', 'claimed')}")
        payload = json.dumps({"version": int(version), "state": state,
                              "domain": self.domain,
                              "t": time.time(), **extra})
        try:
            self.store.fenced_set(f"publish/{self.domain}/manifest",
                                  payload, self.domain, gen=int(version))
        except StaleGenerationError as e:
            _m_rejected.inc()
            raise PublishRejectedError(
                "stale_version", int(version),
                fence_version=e.fence_gen, detail=str(e)) from e

    # -- canary ------------------------------------------------------------
    def _canary_check(self, engine, version: int) -> None:
        """Golden-prompt probe of the STAGED (uncommitted) version on
        one replica.  Rejection discards the staged buffer — the bad
        version never became active anywhere, so 'never serves a
        token' holds by construction."""
        pol = self.policy
        prompts = pol.golden_prompts
        if prompts is None:
            prompts = _default_golden_prompts(
                getattr(engine.cfg, "vocab_size", 0)
                or self.model.cfg.vocab_size)
        for prompt in prompts:
            base = engine.probe_logits(prompt)
            cand = engine.probe_logits(prompt, version=version)
            if not np.all(np.isfinite(cand)):
                self._canary_fail(engine, version, "canary_nonfinite",
                                  f"nonfinite logits on golden prompt "
                                  f"{list(prompt)}")
            tok = int(np.argmax(base))
            b_nll = _nll(base, tok)
            c_nll = _nll(cand, tok)
            bound = pol.drift_nll_factor * max(b_nll, 0.05) \
                + pol.drift_nll_slack
            if c_nll > bound:
                self._canary_fail(
                    engine, version, "canary_drift",
                    f"candidate NLL {c_nll:.3f} of active greedy token "
                    f"{tok} exceeds bound {bound:.3f} "
                    f"(baseline {b_nll:.3f}) on {list(prompt)}")

    def _canary_fail(self, engine, version: int, reason: str,
                     detail: str) -> None:
        engine.discard_staged(version)
        _m_canary_fail.inc()
        _m_rejected.inc()
        _tracing.flight_note("publish_canary_rejected", version=version,
                             reason=reason,
                             replica=getattr(engine, "name", "?"))
        self._fence(version, "rejected")
        self._next = version + 1
        raise PublishRejectedError(reason, version, detail=detail)

    # -- drafter hand-off (speculative decoding across a swap) -------------
    def _refresh_drafter(self, engine) -> None:
        from .speculative import DraftModelDrafter, NGramDrafter

        d = getattr(engine, "_drafter", None)
        if d is None or not isinstance(d, DraftModelDrafter):
            return
        if self._draft_state is not None:
            d.refresh(self._draft_state)
            _m_drafter_repub.inc()
        else:
            # no fresh draft weights: a stale draft model proposes the
            # OLD distribution and acceptance collapses — degrade to the
            # model-free n-gram drafter instead (bitwise-safe either
            # way; only throughput is at stake)
            engine.set_drafter(
                NGramDrafter(block_size=engine.cfg.block_size),
                k=max(engine._spec_k, 1))
            _m_drafter_fb.inc()
            _tracing.flight_note("spec_drafter_fallback",
                                 engine=getattr(engine, "name", "?"))
        self._accept_baseline[getattr(engine, "name", "?")] = float(
            engine._m.spec_accept_rate.value)

    def check_spec_health(self) -> List[str]:
        """Post-swap speculative health: alarm every engine whose
        accept rate collapsed below ``accept_alarm_factor`` of its
        pre-swap baseline (``serving/spec_accept_alarms``).  Call after
        the fleet has decoded under the new version for a while."""
        alarmed: List[str] = []
        for rep in self.router.replicas:
            eng = rep.engine
            name = getattr(eng, "name", "?")
            base = self._accept_baseline.get(name)
            if base is None or base <= 0.0 \
                    or getattr(eng, "_drafter", None) is None:
                continue
            rate = float(eng._m.spec_accept_rate.value)
            if rate < self.policy.accept_alarm_factor * base:
                _m_accept_alarm.inc()
                _tracing.flight_note("spec_accept_collapse", engine=name,
                                     baseline=base, rate=rate)
                alarmed.append(name)
        return alarmed

    # -- payload bookkeeping ----------------------------------------------
    def _payload_for(self, version: int, mode: Optional[str], cfg
                     ) -> Tuple[List[torch.Tensor], List[int]]:
        key = (int(version), mode)
        hit = self._payloads.get(key)
        if hit is None:
            src = self._history.get(int(version))
            if src is None:
                raise KeyError(
                    f"no retained source for version {version} "
                    f"(committed is {self.version})")
            hit = build_weight_set(self.model, dict(src), cfg,
                                   weight_stream=mode)
            self._payloads[key] = hit
        return hit

    # -- the rollout -------------------------------------------------------
    def publish(self, params=None, version: Optional[int] = None,
                draft_params=None) -> PublishReport:
        """One full rollout: build per-mode weight sets, canary on the
        first healthy replica, promote fleet-wide, converge stragglers.

        ``params`` (name -> array, serving-model layout) defaults to
        the live model's current parameters — the trainer snapshot.
        ``draft_params`` optionally republishes the speculative draft
        model alongside (satellite: a stale drafter collapses accept
        rates).  Raises ``PublishRejectedError`` on fence or canary
        refusal; the fleet then serves exactly what it served before.
        """
        t0 = time.perf_counter()
        live = [(i, rep) for i, rep in enumerate(self.router.replicas)
                if rep.healthy()]
        if not live:
            _m_rejected.inc()
            raise PublishRejectedError("no_replicas", self._next)
        v = int(version) if version is not None else self._next
        if v <= self.version:
            _m_rejected.inc()
            raise PublishRejectedError("stale_version", v,
                                       fence_version=self.version)
        # epoch claim precedes any byte hitting any replica
        self._fence(v, "staging")
        self.in_flight = True
        try:
            return self._publish_epoch(v, t0, live, params,
                                       draft_params)
        finally:
            self.in_flight = False

    def _publish_epoch(self, v: int, t0: float, live, params,
                       draft_params) -> PublishReport:
        src = _host_params(params if params is not None
                           else dict(self.model.named_parameters()))
        payloads: Dict[Optional[str],
                       Tuple[List[torch.Tensor], List[int]]] = {}
        for _, rep in live:
            mode = getattr(rep.engine, "_weight_stream_mode", None)
            if mode not in payloads:
                payloads[mode] = build_weight_set(
                    self.model, dict(src), rep.engine.cfg,
                    weight_stream=mode)
        if draft_params is not None:
            self._draft_state = _host_params(draft_params)
        else:
            self._draft_state = None

        bytes_shipped = 0
        missed: List[str] = []
        committed: List[str] = []
        canary_name: Optional[str] = None

        # canary: stage + probe on ONE replica before anything commits.
        # A canary replica dying mid-stage is a replica fault, not a
        # verdict on the weights — the next healthy replica canaries.
        remaining = list(live)
        while remaining:
            idx, rep = remaining[0]
            eng = rep.engine
            mode = getattr(eng, "_weight_stream_mode", None)
            try:
                bytes_shipped += self._ship(eng, v, payloads[mode])
            except (EngineDeadError, PeerUnreachableError,
                    TransportError, WeightTransferError) as e:
                remaining.pop(0)
                missed.append(rep.name)
                self._note_replica_fault(idx, rep, e)
                continue
            canary_name = rep.name
            self._canary_check(eng, v)      # raises on rejection
            eng.commit_weight_set(v)
            self._refresh_drafter(eng)
            committed.append(rep.name)
            remaining.pop(0)
            break
        if canary_name is None:
            _m_rejected.inc()
            self._fence(v, "rejected")
            self._next = v + 1
            raise PublishRejectedError(
                "no_replicas", v,
                detail="every replica failed to stage the canary set")

        # fleet promote: replica-by-replica; a replica lost here misses
        # the rollout (catches up via restart hook / reconcile), it
        # does not abort the fleet
        for idx, rep in remaining:
            eng = rep.engine
            mode = getattr(eng, "_weight_stream_mode", None)
            try:
                bytes_shipped += self._ship(eng, v, payloads[mode])
                eng.commit_weight_set(v)
            except (EngineDeadError, PeerUnreachableError,
                    TransportError, WeightTransferError,
                    PublishRejectedError) as e:
                missed.append(rep.name)
                self._note_replica_fault(idx, rep, e)
                continue
            self._refresh_drafter(eng)
            committed.append(rep.name)

        prev_committed = self.version
        self.version = v
        self._next = v + 1
        self._history = {ver: s for ver, s in self._history.items()
                         if ver == prev_committed}
        self._history[v] = src
        self._payloads = {(v, mode): p for mode, p in payloads.items()}
        self._fence(v, "committed")
        _m_publishes.inc()
        dt = time.perf_counter() - t0
        _m_ms.observe(dt * 1e3)
        _tracing.flight_note("weight_publish", version=v,
                             canary=canary_name, committed=committed,
                             missed=missed)
        return PublishReport(version=v, canary=canary_name,
                             committed=committed, missed=missed,
                             publish_s=dt, bytes_shipped=bytes_shipped)

    def publish_from_checkpoint(self, path: str, **kw) -> PublishReport:
        """Publish a trainer checkpoint (``distributed.checkpoint``
        layout): shards saved under ANY trainer mesh are reassembled to
        full tensors (reshard-on-load), matched to the serving model's
        parameter names, and pushed through the normal rollout."""
        from ..distributed.checkpoint import load_state_dict

        current = _host_params(dict(self.model.named_parameters()))
        sd = {k: cur.clone() for k, cur in current.items()}
        load_state_dict(sd, path)     # KeyError for a missing parameter
        params = {k: getattr(sd[k], "_value", sd[k]).to(cur.dtype)
                  for k, cur in current.items()}
        return self.publish(params=params, **kw)

    def _note_replica_fault(self, idx: int, rep, err) -> None:
        _m_missed.inc()
        _tracing.flight_note("publish_replica_missed", replica=rep.name,
                             error=type(err).__name__)
        if getattr(rep.engine, "dead", False):
            # dead engine: take it out of rotation now; the normal
            # supervisor pump restarts it and the weight_catchup hook
            # converges its version before it serves again
            rep.mark_unhealthy()

    # -- convergence -------------------------------------------------------
    def catch_up(self, engine) -> bool:
        """Bring one engine to the committed fleet version (restart
        hook: ``FleetSupervisor.restart`` calls this on the fresh
        engine before it re-enters rotation).  No-op when the engine
        already serves (or outruns) the committed epoch."""
        if self.version <= 0:
            return False
        if engine.active_weight_version >= self.version:
            return False
        mode = getattr(engine, "_weight_stream_mode", None)
        payload = self._payload_for(self.version, mode, engine.cfg)
        self._ship(engine, self.version, payload)
        engine.commit_weight_set(self.version)
        self._refresh_drafter(engine)
        _m_catchups.inc()
        _tracing.flight_note("publish_catchup",
                             engine=getattr(engine, "name", "?"),
                             version=self.version)
        return True

    def reconcile(self) -> List[str]:
        """Converge every live replica onto the committed epoch —
        replicas that missed the rollout (drop@publish, offline window)
        and were not restarted through the supervisor hook."""
        updated: List[str] = []
        for rep in self.router.replicas:
            eng = rep.engine
            if getattr(eng, "dead", False):
                continue
            try:
                if self.catch_up(eng):
                    updated.append(rep.name)
            except (EngineDeadError, PeerUnreachableError,
                    TransportError, WeightTransferError):
                continue
        return updated

    # -- rollback ----------------------------------------------------------
    def rollback(self, reason: str = "anomaly") -> int:
        """Fleet-wide revert to the retained previous buffer.  Every
        engine still on the anomalous version swaps back bitwise (its
        in-flight streams pinned to the bad version restart under the
        previous params with their original salts — the regenerated
        tokens equal a run where the promote never happened).  Returns
        the version now serving."""
        bad = self.version
        prev: Optional[int] = None
        rolled: List[str] = []
        for rep in self.router.replicas:
            eng = rep.engine
            if getattr(eng, "dead", False):
                continue
            if eng.active_weight_version != bad:
                continue
            prev = eng.rollback_weight_set()
            rolled.append(rep.name)
        if prev is None:
            raise PublishRejectedError(
                "no_previous", bad,
                detail="no live replica had a retained previous buffer")
        self.version = prev
        self._next = max(self._next, bad + 1)
        self._history.pop(bad, None)
        self._payloads = {}
        self._draft_state = None
        # the fence stays at the highest CONSUMED epoch, which may be
        # past ``bad`` — a candidate rejected after the promote already
        # advanced the store's generation high-water, and an equal
        # generation is the most a fenced write may reuse.  The NEXT
        # publish claims past it, so a zombie re-push of the
        # rolled-back version is refused as stale.
        self._fence(max(bad, self._next - 1), "rolled_back",
                    bad_version=bad, now_serving=prev)
        _tracing.flight_note("weight_rollback", bad_version=bad,
                             now_serving=prev, reason=reason,
                             replicas=rolled)
        return prev
