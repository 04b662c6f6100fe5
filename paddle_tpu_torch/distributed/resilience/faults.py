"""Deterministic fault injection for the eager transport.

The chaos harness: a process-wide ``FaultInjector`` that the transport
consults at well-defined sites (``send`` per outgoing data-frame
attempt, ``dial`` per connect attempt, ``recv`` per delivered frame),
plus two training-loop sites: ``step`` (the elastic supervisor consults
it at the top of every train step) and ``save`` (the distributed
checkpoint consults it between writing shard files and publishing the
manifest — a ``kill@save`` leaves exactly the torn checkpoint a real
mid-save death leaves), plus four SERVING sites the fleet tier consults
(``inference/``): ``prefill`` and ``decode`` (the engine, once per step
that schedules a prefill chunk / a decode row), ``migrate`` (per
in-flight KV hand-off in ``disagg.migrate_request``), ``cache_save``
(the prefix-cache snapshot, between writing the page data and
publishing the manifest — a ``kill@cache_save`` leaves exactly the torn
snapshot a real mid-save death leaves) and ``publish`` (the live
weight-publish path in ``inference/weight_publish.py``, consulted once
per replica transfer: ``kill`` fells the receiving engine mid-stage —
the manifest-last commit means version N keeps serving — ``drop``
makes the transfer vanish so the replica catches up later, ``corrupt``
flips a staged byte the CRC check must catch, ``delay`` stalls the
rollout). A ``FaultPlan`` names which
fault fires where —
armed from the ``PT_FAULT_PLAN`` environment variable or
programmatically — so the failure modes a cluster actually exhibits
(dropped connections, slow hosts, corrupted frames, killed ranks)
are reproducible on the 2-process CPU mesh in tier-1 tests.

Plan DSL (comma/semicolon separated clauses)::

    PT_FAULT_PLAN="drop@send#2,corrupt@send#4"
    PT_FAULT_PLAN="kill@send#3:rank=1"
    PT_FAULT_PLAN="kill@step#5:rank=1"          # die at the 5th step
    PT_FAULT_PLAN="kill@save#1"                 # die mid-checkpoint
    PT_FAULT_PLAN="kill@host#1:host=host1"      # fell a whole host
    PT_FAULT_PLAN="partition@dial#1:rank=1"     # sever rank 1's dials
    PT_FAULT_PLAN="delay@send#1:ms=250,dup@send#2"
    PT_FAULT_PLAN="seed=7,drop@send%0.05"

Each clause is ``<kind>@<site>`` plus either ``#n`` (fire on the n-th
matching event, exactly once) or ``%p`` (fire each matching event with
probability p from the seeded RNG — deterministic per ``seed=N``).
Optional filters: ``:rank=R`` (only this global rank injects) and
``:peer=P`` (only events involving that peer). Kinds:

- ``drop``    close the peer connection (exercises redial + retransmit)
- ``delay``   sleep ``ms`` (default 100) before the event proceeds
- ``dup``     transmit the frame twice (exercises seq-based dedup)
- ``corrupt`` flip a payload byte after CRC is computed (exercises
  CRC verification + NAK retransmit)
- ``kill``    ``os._exit(code)`` (default 1) — a rank dying
  mid-collective (exercises watchdog escalation on the survivors),
  mid-step (exercises supervisor re-form + snapshot restore), or
  mid-save (exercises torn-checkpoint discovery)
- ``overload`` (``admit`` only) a traffic storm: each arrival at the
  gateway becomes ``x`` arrivals (``:x=4``, default 4)

At the ``step``/``save``/``host`` sites only ``kill`` and ``delay``
are meaningful; frame-level kinds (drop/dup/corrupt) are REJECTED by
the plan parser there — a plan that could only no-op fails validation
instead of silently passing CI.

The ``host`` site makes the HOST the failure unit: the supervisor (per
train step, with its ``host_id``) and the serving router (per engine
step, with ``engine.host_id``) consult it, and a fired ``kill@host`` is
STICKY — the felled ``host_id`` is remembered, so every co-hosted rank
and engine dies at its next consult, not just the one that tripped the
``#n`` trigger. Target a specific host with ``:host=H``; in subprocess
chaos runs each rank's injector is per-process, so every rank sharing
the target ``PT_HOST_ID`` exits at its first host-site consult. The
``partition`` kind (valid only at ``dial``) makes connect attempts fail
the way a severed DCN link would — both the transport's peer dials and
the ``FailoverStore``'s store redials consult it.
At the serving engine sites (``prefill``/``decode``/``cache_save``)
``kill`` fells the ENGINE, not the process: the engine sets its
``dead`` flag and raises ``EngineDeadError`` — the in-process replica
analog of a replica process dying, which the fleet supervisor answers
by draining + restarting (``inference/fleet_supervisor.py``). At
``migrate``, ``drop`` raises ``PeerUnreachableError`` (the dying
engine cannot ship its KV pages — exercises the requeue fallback) and
``kill`` again fells the source engine. Use ``:rank=R`` with the
engine's ``fault_rank`` to target one replica of an in-process fleet.

The ``admit`` site is the traffic-storm site: the FleetGateway
(``inference/gateway.py``) consults it once per arriving request.
``overload`` (valid ONLY at ``admit``) turns each arrival into ``x``
arrivals (``:x=4`` — the gateway injects ``x - 1`` synthetic
best-effort clones, a reproducible 4x burst), ``drop`` sheds the
arrival the way a vanished client would, and ``delay`` stalls it.
Process/frame kinds (kill/dup/corrupt/partition) are rejected at
``admit`` — requests do not die there, fleets do::

    PT_FAULT_PLAN="overload@admit%1.0:x=4"    # sustained 4x storm
    PT_FAULT_PLAN="overload@admit#1:x=8"      # one 8x burst

The ``spawn`` and ``retire`` sites are the AutoScaler's resize sites
(``inference/autoscaler.py``): ``spawn`` is consulted once per
scale-up attempt, after the new replica is built but BEFORE its weight
catch-up completes — ``kill`` fells the half-built replica (the
autoscaler sweeps it and retries under backoff, bounded by
``max_spawn_failures``; the serving fleet never stops) and ``delay``
slows the converge against ``catchup_timeout_s``.  ``retire`` is
consulted once per scale-down as the draining replica hands off its
in-flight work — ``kill`` fells it mid-drain, so the KV hand-off
falls back to the requeue path with zero lost requests.  Both are
process events: frame kinds are rejected.  Use ``:rank=R`` to target
the replica slot being spawned / the replica index being retired::

    PT_FAULT_PLAN="kill@spawn#1"              # first spawn attempt dies
    PT_FAULT_PLAN="kill@retire#1:rank=2"      # replica 2 dies mid-drain

The ``replica`` site is the PROCESS-event site for subprocess replicas
(``inference/remote_replica.py``): the PARENT consults it once per
``RemoteEngine.step`` against the child's real PID, so the fault is an
actual OS signal, not a flag.  ``sigkill`` delivers SIGKILL (the child
vanishes mid-decode — exercises missed-heartbeat detection, the
requeue-fallback drain, and the exit-code taxonomy in flight dumps),
``hang`` delivers SIGSTOP (the process survives but its heartbeats
stop — liveness must be INFERRED, the hang indistinguishable from
death until a SIGCONT lets the half-open probe restore it), and
``delay`` stalls the parent's step.  ``sigkill``/``hang`` are only
meaningful against a real PID, so they are valid ONLY at ``replica``;
frame kinds are rejected there, matching the spawn/retire precedent.
Use ``:rank=R`` with the replica's ``fault_rank``::

    PT_FAULT_PLAN="sigkill@replica#4:rank=1"  # SIGKILL child 1 mid-run
    PT_FAULT_PLAN="hang@replica#2"            # SIGSTOP: beats go quiet

Every injected fault increments ``faults/injected`` and
``faults/<kind>`` in the metrics registry so a chaos run's report shows
exactly what was thrown at the system.

Validate a plan offline (CI / before launching a pod)::

    python -m paddle_tpu_torch.distributed.resilience.faults --check "<plan>"
"""
from __future__ import annotations

import os
import random
import threading
from dataclasses import dataclass, field
from typing import List, Optional

from ...profiler import metrics as _metrics

__all__ = ["FaultAction", "FaultRule", "FaultPlan", "FaultInjector",
           "injector", "arm", "disarm", "is_armed", "parse_plan",
           "maybe_arm_from_env", "FAULT_KINDS", "FAULT_SITES"]

FAULT_KINDS = ("drop", "delay", "dup", "corrupt", "kill", "partition",
               "overload", "sigkill", "hang")
FAULT_SITES = ("send", "dial", "recv", "step", "save",
               "prefill", "decode", "migrate", "cache_save", "host",
               "admit", "publish", "spawn", "retire", "replica")

# frame-level kinds are meaningless away from the wire: the validator
# REJECTS them at the process/host sites instead of silently no-oping
_FRAME_KINDS = ("drop", "dup", "corrupt")
_PROCESS_SITES = ("step", "save", "host")
# a partition severs links: it only means something where dials happen
_PARTITION_SITES = ("dial",)
# a traffic storm only means something at the gateway's admission site,
# and the only failures admission exhibits are storms, vanished clients
# (drop) and stalls (delay) — anything else at admit is a typo'd plan
_OVERLOAD_SITES = ("admit",)
_ADMIT_KINDS = ("overload", "drop", "delay")
# the publish site sits on a CRC/ACK weight transfer into a live
# replica: kill (replica dies mid-stage — torn-update fencing), delay
# (slow rollout), drop (the transfer never lands — replica catches up
# later) and corrupt (a flipped byte the CRC check must catch) are the
# failures a rollout exhibits; dup is meaningless (staging is
# idempotent per version) and rejected so a no-op plan fails CI
_PUBLISH_KINDS = ("kill", "delay", "drop", "corrupt")
# the autoscaler's resize sites are PROCESS events, not wire frames:
# spawn fires between a new replica's build and its weight catch-up
# (kill = the half-built replica dies mid-catch-up and is swept; delay
# = a slow converge against catchup_timeout_s), retire fires as a
# draining replica hands off its last in-flight work (kill = it dies
# mid-drain and the hand-off falls back to requeue).  Frame kinds are
# rejected so a no-op plan fails CI instead of silently passing.
_RESIZE_SITES = ("spawn", "retire")
_RESIZE_KINDS = ("kill", "delay")
# the replica site is a PROCESS event against a real child PID: the
# parent delivers an actual OS signal (sigkill → SIGKILL, hang →
# SIGSTOP), so those two kinds mean nothing anywhere else, and frame
# kinds mean nothing there — both directions are rejected so a no-op
# plan fails CI instead of silently passing (spawn/retire precedent)
_REPLICA_SITES = ("replica",)
_REPLICA_KINDS = ("sigkill", "hang", "delay")
_SIGNAL_KINDS = ("sigkill", "hang")


@dataclass(frozen=True)
class FaultAction:
    """What the transport should do at an injection site."""

    kind: str                      # one of FAULT_KINDS
    delay_ms: float = 100.0        # for kind == "delay"
    exit_code: int = 1             # for kind == "kill"
    factor: int = 4                # for kind == "overload": arrival x


@dataclass
class FaultRule:
    kind: str
    site: str
    nth: Optional[int] = None      # fire on the n-th matching event
    prob: float = 0.0              # or: fire with this probability
    rank: Optional[int] = None     # only inject on this global rank
    peer: Optional[int] = None     # only on events involving this peer
    host: Optional[str] = None     # only on events from this host_id
    delay_ms: float = 100.0
    exit_code: int = 1
    factor: int = 4                # overload: arrivals per real arrival
    # runtime state
    seen: int = 0
    fired: int = 0

    def matches(self, site: str, rank: int, peer: Optional[int],
                host: Optional[str] = None) -> bool:
        if site != self.site:
            return False
        if self.rank is not None and rank != self.rank:
            return False
        if self.peer is not None and peer != self.peer:
            return False
        if self.host is not None and host != self.host:
            return False
        return True


@dataclass
class FaultPlan:
    rules: List[FaultRule] = field(default_factory=list)
    seed: int = 0

    def describe(self) -> str:
        out = []
        for r in self.rules:
            tok = f"{r.kind}@{r.site}"
            tok += f"#{r.nth}" if r.nth is not None else f"%{r.prob}"
            if r.rank is not None:
                tok += f":rank={r.rank}"
            if r.host is not None:
                tok += f":host={r.host}"
            out.append(tok)
        return ",".join(out) or "<empty>"


def parse_plan(spec: str) -> FaultPlan:
    """Parse the PT_FAULT_PLAN DSL (see module docstring)."""
    plan = FaultPlan()
    for clause in spec.replace(";", ",").split(","):
        clause = clause.strip()
        if not clause:
            continue
        if clause.startswith("seed="):
            plan.seed = int(clause[5:])
            continue
        head, *opts = clause.split(":")
        if "@" not in head:
            raise ValueError(
                f"bad PT_FAULT_PLAN clause {clause!r}: expected "
                f"<kind>@<site>#n or <kind>@<site>%p")
        kind, _, rest = head.partition("@")
        if kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {kind!r} in {clause!r} "
                             f"(known: {', '.join(FAULT_KINDS)})")
        rule = FaultRule(kind=kind, site="", )
        if "#" in rest:
            site, _, n = rest.partition("#")
            rule.nth = int(n)
        elif "%" in rest:
            site, _, p = rest.partition("%")
            rule.prob = float(p)
        else:
            site, rule.nth = rest, 1
        if site not in FAULT_SITES:
            raise ValueError(f"unknown fault site {site!r} in {clause!r} "
                             f"(known: {', '.join(FAULT_SITES)})")
        rule.site = site
        if kind in _FRAME_KINDS and site in _PROCESS_SITES:
            raise ValueError(
                f"frame-level kind {kind!r} is meaningless at the "
                f"{site!r} site in {clause!r} (only kill/delay fire at "
                f"{'/'.join(_PROCESS_SITES)})")
        if kind == "partition" and site not in _PARTITION_SITES:
            raise ValueError(
                f"kind 'partition' only applies at the "
                f"{'/'.join(_PARTITION_SITES)} site(s), not {site!r} in "
                f"{clause!r}")
        if kind == "overload" and site not in _OVERLOAD_SITES:
            raise ValueError(
                f"kind 'overload' only applies at the "
                f"{'/'.join(_OVERLOAD_SITES)} site(s), not {site!r} in "
                f"{clause!r}")
        if site == "admit" and kind not in _ADMIT_KINDS:
            raise ValueError(
                f"kind {kind!r} is meaningless at the 'admit' site in "
                f"{clause!r} (only {'/'.join(_ADMIT_KINDS)} fire there)")
        if site == "publish" and kind not in _PUBLISH_KINDS:
            raise ValueError(
                f"kind {kind!r} is meaningless at the 'publish' site "
                f"in {clause!r} (only {'/'.join(_PUBLISH_KINDS)} fire "
                f"there)")
        if site in _RESIZE_SITES and kind not in _RESIZE_KINDS:
            raise ValueError(
                f"kind {kind!r} is meaningless at the {site!r} site in "
                f"{clause!r} (a resize is a process event — only "
                f"{'/'.join(_RESIZE_KINDS)} fire at "
                f"{'/'.join(_RESIZE_SITES)})")
        if site in _REPLICA_SITES and kind not in _REPLICA_KINDS:
            raise ValueError(
                f"kind {kind!r} is meaningless at the {site!r} site in "
                f"{clause!r} (a subprocess replica dies by OS signal — "
                f"only {'/'.join(_REPLICA_KINDS)} fire at "
                f"{'/'.join(_REPLICA_SITES)})")
        if kind in _SIGNAL_KINDS and site not in _REPLICA_SITES:
            raise ValueError(
                f"kind {kind!r} delivers a real OS signal to a child "
                f"PID: it only applies at the "
                f"{'/'.join(_REPLICA_SITES)} site(s), not {site!r} in "
                f"{clause!r}")
        for opt in opts:
            k, _, v = opt.partition("=")
            if k == "rank":
                rule.rank = int(v)
            elif k == "peer":
                rule.peer = int(v)
            elif k == "host":
                rule.host = v
            elif k == "ms":
                rule.delay_ms = float(v)
            elif k == "code":
                rule.exit_code = int(v)
            elif k == "x":
                rule.factor = int(v)
                if rule.factor < 2:
                    raise ValueError(
                        f"overload factor x={rule.factor} in {clause!r} "
                        f"must be >= 2 (x arrivals per real arrival)")
            else:
                raise ValueError(f"unknown option {opt!r} in {clause!r}")
        plan.rules.append(rule)
    return plan


class FaultInjector:
    """Process-wide injection point. Disarmed (the default) costs one
    attribute read per event; armed, each matching rule fires per its
    ``#n`` / ``%p`` trigger. Thread-safe: transport send paths race."""

    def __init__(self):
        self._lock = threading.Lock()
        self._plan: Optional[FaultPlan] = None
        self._rng: Optional[random.Random] = None
        # hosts a kill@host already felled: STICKY — every later event
        # from a felled host keeps firing kill, so an in-process fleet
        # loses all its co-hosted engines, not just the one whose event
        # happened to trip the ``#n`` trigger
        self._felled_hosts: set = set()

    # -- arming ----------------------------------------------------------
    def arm(self, plan) -> FaultPlan:
        if isinstance(plan, str):
            plan = parse_plan(plan)
        with self._lock:
            self._plan = plan
            self._rng = random.Random(plan.seed)
            self._felled_hosts = set()
        return plan

    def disarm(self):
        with self._lock:
            self._plan = None
            self._rng = None
            self._felled_hosts = set()

    def felled_hosts(self) -> set:
        with self._lock:
            return set(self._felled_hosts)

    # The lock-free reads of self._plan below (is_armed, plan, the
    # on_event fast path, counts) are by design and grandfathered in
    # .ptlint-baseline.json: the injector sits on every transport event,
    # and the disarmed case must cost one attribute read, not a lock
    # round-trip. _plan is swapped atomically (a single rebind under
    # _lock in arm/disarm), so a stale read only delays arming by one
    # event — it never observes a half-built plan.
    def is_armed(self) -> bool:
        return self._plan is not None

    @property
    def plan(self) -> Optional[FaultPlan]:
        return self._plan

    # -- the hook the transport calls ------------------------------------
    def on_event(self, site: str, rank: int,
                 peer: Optional[int] = None,
                 host: Optional[str] = None) -> Optional[FaultAction]:
        """Record one event at `site`; return the action to inject, or
        None. At most one rule fires per event (first match wins)."""
        plan = self._plan
        if plan is None:
            return None
        action = None
        with self._lock:
            if site == "host" and host is not None \
                    and host in self._felled_hosts:
                # the host is already down: everything on it stays dead
                _metrics.inc("faults/injected")
                _metrics.inc("faults/kill")
                return FaultAction("kill")
            # every matching rule observes every event (so '#n' counts
            # site events, not rule evaluations); the first rule whose
            # trigger matches wins the event
            for rule in plan.rules:
                if not rule.matches(site, rank, peer, host):
                    continue
                rule.seen += 1
                if action is not None:
                    continue
                fire = False
                if rule.nth is not None:
                    fire = rule.seen == rule.nth
                elif self._rng is not None and rule.prob > 0:
                    fire = self._rng.random() < rule.prob
                if not fire:
                    continue
                rule.fired += 1
                _metrics.inc("faults/injected")
                _metrics.inc(f"faults/{rule.kind}")
                action = FaultAction(rule.kind, delay_ms=rule.delay_ms,
                                     exit_code=rule.exit_code,
                                     factor=rule.factor)
                if site == "host" and rule.kind == "kill" \
                        and host is not None:
                    self._felled_hosts.add(host)
        return action

    def counts(self) -> dict:
        """{kind: times fired} for the armed plan (chaos-test probe)."""
        plan = self._plan
        if plan is None:
            return {}
        out: dict = {}
        with self._lock:
            for r in plan.rules:
                out[r.kind] = out.get(r.kind, 0) + r.fired
        return out


injector = FaultInjector()


def arm(plan) -> FaultPlan:
    return injector.arm(plan)


def disarm():
    injector.disarm()


def is_armed() -> bool:
    return injector.is_armed()


def maybe_arm_from_env() -> bool:
    """Arm from PT_FAULT_PLAN if set and not already armed. Called by
    the transport at init so chaos plans reach subprocess workers
    through the environment alone."""
    if injector.is_armed():
        return True
    spec = os.environ.get("PT_FAULT_PLAN", "").strip()
    if not spec:
        return False
    injector.arm(spec)
    return True


def main(argv=None) -> int:
    """Offline PT_FAULT_PLAN validator: ``--check "<plan>"`` parses the
    plan and prints its normalized form (exit 0) or the parse error
    (exit 2) — so CI rejects a typo'd chaos plan before it silently
    no-ops on a real pod."""
    import argparse

    parser = argparse.ArgumentParser(
        "paddle_tpu_torch.distributed.resilience.faults",
        description="Validate a PT_FAULT_PLAN chaos plan offline.")
    parser.add_argument("plan", nargs="?", default=None,
                        help="plan string (defaults to $PT_FAULT_PLAN)")
    parser.add_argument("--check", dest="check", default=None,
                        metavar="PLAN", help="plan string to validate")
    args = parser.parse_args(argv)
    spec = args.check if args.check is not None else args.plan
    if spec is None:
        spec = os.environ.get("PT_FAULT_PLAN", "")
    if not spec.strip():
        print("no plan given (arg, --check, or $PT_FAULT_PLAN)")
        return 2
    try:
        plan = parse_plan(spec)
    except ValueError as e:
        print(f"invalid PT_FAULT_PLAN: {e}")
        return 2
    print(f"OK: {len(plan.rules)} rule(s), seed={plan.seed}: "
          f"{plan.describe()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
