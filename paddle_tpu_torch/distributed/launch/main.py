"""Launch CLI: ``python -m paddle_tpu_torch.distributed.launch [...]
train.py`` (paddle_tpu/distributed/launch/main.py; reference:
python/paddle/distributed/launch/main.py:21 and its controllers).

The TPU package starts ONE worker a host, whose single controller drives
every local chip. The port starts one worker a card, as PaddlePaddle's
collective launcher does, each with the environment ``init_parallel_env``
reads (env.py): ``PADDLE_TRAINER_ID`` (its global rank),
``PADDLE_TRAINERS_NUM``, ``PADDLE_TRAINER_ENDPOINTS`` (one endpoint a
worker; rank 0 serves ``torch.distributed``'s store at the first),
``PADDLE_CURRENT_ENDPOINT`` and ``PADDLE_LOCAL_RANK`` (its card: the
``--devices`` entry, else its index on the node). Nodes meet through the
launcher's store (store.py): each registers its workers' endpoints and
reads the others'. Worker i of a node writes ``workerlog.<global rank>``
under ``--log_dir``; a failed worker takes its whole pod down, and the
pod is started again up to ``--max_restart`` times, after which the
launcher returns the failing worker's exit code.

Elastic mode (``--nnodes lo:hi``, the reference's :95-251 and
fleet/elastic/manager.py:124-277): every controller heartbeats its node
into the store; a stale peer heartbeat (``--elastic_ttl``), a worker's
exit, the comm watchdog's ``__unhealthy__`` mark or a node joining bumps
the job's generation, and every controller kills its workers and meets
again at the new generation: fresh rendezvous keys (``<job>/g<N>/...``),
node ranks re-mapped in order of arrival, the world cut to the nodes
present (at least lo, at most hi), and the workers spawned again with
``PADDLE_ELASTIC_GENERATION`` and ``PT_SUPERVISOR_REJOIN=1``. A worker
resumes from its checkpoint (``resilience.resume_from_latest`` or the
supervisor's tiers), resharded on load. The supervisor's knobs reach the
workers as ``PT_SUPERVISOR_MAX_RESTARTS`` (``--max_restart``),
``PT_CKPT_ROOT`` (``--ckpt_dir``) and ``PT_SNAPSHOT_EVERY``
(``--snapshot_every``).
"""
from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import time
from typing import List, Optional

__all__ = ["launch", "main", "parse_args", "Controller", "Pod"]


def _free_port():
    s = socket.socket()
    s.bind(("", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def parse_args(argv=None):
    parser = argparse.ArgumentParser("paddle_tpu_torch.distributed.launch")
    parser.add_argument("--master", default=None,
                        help="host:port of the rendezvous store "
                             "(default: local)")
    parser.add_argument("--nnodes", default="1",
                        help="node count, or lo:hi range for elastic")
    parser.add_argument("--rank", type=int, default=-1,
                        help="node rank (default: assigned by the store)")
    parser.add_argument("--nproc_per_node", type=int, default=None,
                        help="workers a node, one a card (default: the "
                             "visible cards, or the --devices count)")
    parser.add_argument("--devices", "--gpus", "--xpus", default=None,
                        help="comma-separated card ids, one a worker: "
                             "each worker's PADDLE_LOCAL_RANK")
    parser.add_argument("--job_id", default="default")
    parser.add_argument("--log_dir", default="log")
    parser.add_argument("--max_restart", type=int, default=3)
    parser.add_argument("--ckpt_dir", default=None,
                        help="checkpoint root for the elastic "
                             "supervisor's disk tier (PT_CKPT_ROOT)")
    parser.add_argument("--standby", default=None,
                        help="host:port of the hot-standby rendezvous "
                             "store replica (PT_STORE_STANDBY); every "
                             "store client fails over to it")
    parser.add_argument("--snapshot_every", type=int, default=0,
                        help="in-memory replicated snapshot interval "
                             "in steps for supervised workers "
                             "(PT_SNAPSHOT_EVERY; 0 = leave unset)")
    parser.add_argument("--elastic_timeout", type=float, default=30.0)
    parser.add_argument("--elastic_ttl", type=float, default=10.0,
                        help="heartbeat staleness after which a peer node "
                             "is considered gone (elastic mode)")
    parser.add_argument("--host", default=None)
    parser.add_argument("training_script")
    parser.add_argument("training_script_args", nargs=argparse.REMAINDER)
    return parser.parse_args(argv)


class Pod:
    """This node's workers: ``rank`` the node's, ``world`` every
    worker's endpoint in global rank order, ``cards`` the card of each
    local worker."""

    def __init__(self, rank: int, world: List[str], cards: List[int]):
        self.rank = rank
        self.world = world
        self.cards = cards
        self.procs: List[subprocess.Popen] = []

    @property
    def local_procs(self) -> int:
        return len(self.cards)


class Controller:
    """reference controller.py:79: build the pod, spawn, watch."""

    def __init__(self, args):
        self.args = args
        lo, _, hi = args.nnodes.partition(":")
        self.min_nodes = int(lo)
        self.max_nodes = int(hi) if hi else self.min_nodes
        self.elastic = bool(hi)
        self.cards = self._cards()
        local_only = self.max_nodes == 1 and args.master is None
        self.host = args.host or ("127.0.0.1" if local_only else
                                  socket.gethostbyname(socket.gethostname()))
        self.store = None
        self.standby = None
        self.is_master = False
        self.generation = 0
        self._missing_since = {}      # (gen, rank) -> first-seen-missing
        self._worker_failures = 0     # elastic exit codes, cumulative

    def _cards(self) -> List[int]:
        """The card of each local worker."""
        args = self.args
        if args.devices:
            cards = [int(d) for d in str(args.devices).split(",") if d != ""]
            n = args.nproc_per_node or len(cards)
            if n != len(cards):
                raise ValueError(f"--nproc_per_node {n} with {len(cards)} "
                                 f"--devices")
            return cards
        n = args.nproc_per_node
        if n is None:
            import torch

            n = torch.cuda.device_count() if torch.cuda.is_available() \
                else 0
            if n == 0:
                raise RuntimeError(
                    "paddle_tpu_torch launch: no CUDA card is visible "
                    "(one worker a card); pass --nproc_per_node, and "
                    "PADDLE_DISTRI_BACKEND=gloo for CPU workers")
        if n < 1:
            raise ValueError(f"--nproc_per_node {n}: at least one worker")
        return list(range(n))

    # -- rendezvous --------------------------------------------------------
    def _connect_store(self):
        from ..store import connect_store

        standby = self.args.standby \
            or os.environ.get("PT_STORE_STANDBY") or None
        if self.args.master is None:
            # port 0: the OS gives one, held from the bind on
            self.store = connect_store("127.0.0.1", 0, is_master=True,
                                       standby=standby or "")
            self.is_master = True
        else:
            host, _, port = self.args.master.partition(":")
            try:
                self.store = connect_store(host, int(port),
                                           is_master=False, timeout=5.0,
                                           standby=standby or "")
            except ConnectionError:
                try:
                    self.store = connect_store(host, int(port),
                                               is_master=True,
                                               standby=standby or "")
                    self.is_master = True
                except OSError:
                    # a peer controller bound the port between our probe
                    # and our bind: join it as a client
                    self.store = connect_store(host, int(port),
                                               is_master=False,
                                               timeout=30.0,
                                               standby=standby or "")
        self._maybe_host_standby(standby)

    def _maybe_host_standby(self, standby: Optional[str]):
        """Serve the hot-standby replica when --standby names an endpoint
        of this host and this controller is not the master of a
        multi-node job (or the job is one node). A peer already serving
        it (the port taken) is fine."""
        if not standby:
            return
        host, _, port = standby.partition(":")
        local = host in ("127.0.0.1", "localhost", self.host)
        if not local or (self.is_master and self.args.master is not None):
            return
        from ..store import StandbyStore

        primary = self.store.endpoints[0]
        try:
            self.standby = StandbyStore(primary[0], primary[1],
                                        host=host, port=int(port),
                                        timeout=30.0)
        except (ConnectionError, OSError) as e:
            print(f"[launch] standby store at {standby} not started: "
                  f"{e!r}", file=sys.stderr)

    def _ns(self):
        return f"{self.args.job_id}/g{self.generation}"

    def _gen_bump(self, delta: int = 0) -> int:
        return self.store.add(f"{self.args.job_id}/gen_bump", delta)

    def build_pod(self) -> Pod:
        """This node's rank and every worker's endpoint (reference
        build_pod, :163-226): one node needs no rendezvous; several
        register their workers' endpoints in the store, under keys of the
        current generation, and read the others'. Elastic: wait until the
        membership is stable within [lo, hi] nodes; a node past hi stands
        by until the pod re-forms."""
        if self.store is None:
            self._connect_store()
        mine = ",".join(f"{self.host}:{_free_port()}" for _ in self.cards)
        if self.max_nodes <= 1 and self.args.master is None:
            return Pod(0, mine.split(","), self.cards)
        if self.elastic:
            self.generation = self._gen_bump()
        rank = self.args.rank
        if rank < 0 or self.elastic:
            rank = self.store.add(f"{self._ns()}/nodes", 1) - 1
        self.store.set(f"{self._ns()}/ep/{rank}", mine)
        if self.elastic:
            deadline = time.time() + self.args.elastic_timeout
            last_n, stable_since = 0, time.time()
            while True:
                bump = self._gen_bump()
                if bump > self.generation:
                    # someone re-triggered mid-rendezvous: move up
                    self.generation = bump
                    rank = self.store.add(f"{self._ns()}/nodes", 1) - 1
                    self.store.set(f"{self._ns()}/ep/{rank}", mine)
                    last_n, stable_since = 0, time.time()
                n = self.store.add(f"{self._ns()}/nodes", 0)
                if n != last_n:
                    last_n, stable_since = n, time.time()
                if n >= self.min_nodes \
                        and time.time() - stable_since >= 1.0:
                    break
                if time.time() > deadline:
                    if n >= self.min_nodes:
                        break
                    raise RuntimeError(
                        f"elastic rendezvous timeout: {n} nodes < "
                        f"min {self.min_nodes}")
                time.sleep(0.2)
            world_n = min(last_n, self.max_nodes)
            if rank >= world_n:
                # pod is full: stand by as a spare until it re-forms
                # (a member death bumps the generation; we then rejoin)
                print(f"[launch] node rank {rank} standing by (pod full "
                      f"at {world_n})", file=sys.stderr)
                cur = self._gen_bump()
                while self._gen_bump() == cur:
                    time.sleep(1.0)
                self.generation = self._gen_bump()
                return self.build_pod()
        else:
            world_n = self.min_nodes
        world = []
        for r in range(world_n):
            world += self.store.get(f"{self._ns()}/ep/{r}").decode() \
                .split(",")
        self._heartbeat_now(rank)
        return Pod(rank, world, self.cards)

    # -- spawn -------------------------------------------------------------
    def _worker_env(self, pod: Pod, local_idx: int):
        env = dict(os.environ)
        global_rank = pod.rank * pod.local_procs + local_idx
        env.update({
            "PADDLE_TRAINER_ID": str(global_rank),
            "PADDLE_TRAINERS_NUM": str(len(pod.world)),
            "PADDLE_TRAINER_ENDPOINTS": ",".join(pod.world),
            "PADDLE_CURRENT_ENDPOINT": pod.world[global_rank],
            "PADDLE_LOCAL_RANK": str(pod.cards[local_idx]),
            "FLAGS_selected_gpus": str(pod.cards[local_idx]),
            "PADDLE_JOB_ID": self.args.job_id,
            "PADDLE_MASTER": self.args.master
            or f"127.0.0.1:{self.store.port}",
            "PADDLE_ELASTIC_GENERATION": str(self.generation),
        })
        # elastic-supervisor contract (distributed/resilience/supervisor):
        # restart budget follows the launcher's, and a worker spawned
        # into a re-formed pod knows it is rejoining (so its supervisor
        # bumps the rendezvous generation instead of matching a stale one)
        env["PT_SUPERVISOR_MAX_RESTARTS"] = str(self.args.max_restart)
        if self.args.ckpt_dir:
            env["PT_CKPT_ROOT"] = self.args.ckpt_dir
        if self.args.snapshot_every > 0:
            env["PT_SNAPSHOT_EVERY"] = str(self.args.snapshot_every)
        if self.generation > 0:
            env["PT_SUPERVISOR_REJOIN"] = "1"
        # host-level fault domain contract: workers learn the standby
        # store endpoint (FailoverStore redial target) and their host_id
        # (membership + ring placement); an explicit PT_HOST_ID from the
        # environment (chaos tests) wins over the controller's host
        if self.args.standby:
            env.setdefault("PT_STORE_STANDBY", self.args.standby)
        env.setdefault("PT_HOST_ID", self.host)
        return env

    def spawn(self, pod: Pod):
        os.makedirs(self.args.log_dir, exist_ok=True)
        for i in range(pod.local_procs):
            env = self._worker_env(pod, i)
            log = open(os.path.join(
                self.args.log_dir,
                f"workerlog.{env['PADDLE_TRAINER_ID']}"), "ab")
            try:
                p = subprocess.Popen(
                    [sys.executable, self.args.training_script]
                    + self.args.training_script_args,
                    env=env, stdout=log, stderr=subprocess.STDOUT)
            finally:
                log.close()
            pod.procs.append(p)

    # -- watch loop --------------------------------------------------------
    def _reform(self, pod: Pod, why: str):
        print(f"[launch] elastic: {why}; re-forming pod", file=sys.stderr)
        self._kill(pod)
        return ("reform", self._gen_bump(1))

    def _watch_elastic(self, pod: Pod):
        """The elastic triggers (reference manager.py:124-277), or None:
        another controller's generation bump, a stale peer heartbeat, the
        comm watchdog's unhealthy mark (a hung rank still heartbeats),
        a node that joined after this generation settled."""
        self._heartbeat_now(pod.rank)
        bump = self._gen_bump()
        if bump > self.generation:
            self._kill(pod)
            return ("reform", bump)
        stale = self._stale_peer(pod)
        if stale is not None:
            return self._reform(pod, f"node {stale} heartbeat stale")
        unhealthy = self._unhealthy_group()
        if unhealthy is not None:
            self._clear_unhealthy(unhealthy)
            return self._reform(pod, f"group {unhealthy} marked unhealthy "
                                     f"by comm watchdog")
        n_now = self.store.add(f"{self._ns()}/nodes", 0)
        if n_now > self._nodes(pod) and self._nodes(pod) < self.max_nodes:
            return self._reform(pod, f"{n_now} nodes registered (pod has "
                                     f"{self._nodes(pod)})")
        return None

    def _nodes(self, pod: Pod) -> int:
        return len(pod.world) // pod.local_procs

    def watch(self, pod: Pod):
        """Returns ("done", 0) | ("exit", code) | ("reform", generation).

        Not elastic: a failure kills the pod; within the budget the pod
        starts again, on fresh endpoints when it is the only node
        (reference :280-360). Elastic: a failure re-forms the pod (the
        budget counts real failures across re-formations)."""
        from ..elastic import ELASTIC_EXIT_CODE

        restarts = 0
        while True:
            if self.elastic:
                verdict = self._watch_elastic(pod)
                if verdict is not None:
                    return verdict
            statuses = [p.poll() for p in pod.procs]
            if all(s == 0 for s in statuses):
                return ("done", 0)
            failed = [s for s in statuses if s not in (None, 0)]
            if failed:
                self._kill(pod)
                if self.elastic:
                    if ELASTIC_EXIT_CODE not in failed:
                        self._worker_failures += 1
                        if self._worker_failures > self.args.max_restart:
                            return ("exit", failed[0])
                    print(f"[launch] worker exit {failed[0]}; elastic "
                          f"re-formation", file=sys.stderr)
                    return ("reform", self._gen_bump(1))
                if restarts >= self.args.max_restart:
                    print(f"[launch] worker failed (exit {failed[0]}); "
                          f"restart budget exhausted", file=sys.stderr)
                    return ("exit", failed[0])
                restarts += 1
                print(f"[launch] worker failed (exit {failed[0]}); "
                      f"restart {restarts}/{self.args.max_restart}",
                      file=sys.stderr)
                if self.max_nodes == 1 and self.args.master is None:
                    pod.world = [f"{self.host}:{_free_port()}"
                                 for _ in pod.cards]
                self.spawn(pod)
            time.sleep(0.2)

    def _kill(self, pod: Pod):
        for p in pod.procs:
            if p.poll() is None:
                p.terminate()
        for p in pod.procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        pod.procs = []

    def _heartbeat_now(self, rank: int):
        if self.store is not None:
            self.store.set(f"{self._ns()}/hb/{rank}", str(time.time()))

    def _unhealthy_group(self):
        """Group id marked unhealthy by a worker's watchdog escalation
        (only the world group 0 is checked: a stall on any group marks
        the world's key too), or None."""
        from ..watchdog import read_unhealthy

        return 0 if read_unhealthy(self.store, 0) is not None else None

    def _clear_unhealthy(self, gid: int):
        """Consume/clear an ``__unhealthy__`` mark. Also called before
        every (re-)spawn: a mark set by a dying worker AFTER the re-form
        decision must not immediately re-trigger escalation against the
        fresh pod."""
        from ..watchdog import clear_unhealthy

        try:
            clear_unhealthy(self.store, gid)
        except Exception as e:
            # the store owner may be mid-death; the next watch iteration
            # retries — losing the delete only delays one re-form
            print(f"[launch] could not clear unhealthy mark: {e!r}",
                  file=sys.stderr)

    def _stale_peer(self, pod: Pod):
        now = time.time()
        for r in range(self._nodes(pod)):
            if r == pod.rank:
                continue
            try:
                ts = float(self.store.get_nowait(f"{self._ns()}/hb/{r}"))
                self._missing_since.pop((self.generation, r), None)
            except KeyError:
                # never-written heartbeat: TTL clock starts at first
                # sighting (a node dead between register and first
                # heartbeat must not stall the pod forever)
                first = self._missing_since.setdefault(
                    (self.generation, r), now)
                if now - first > self.args.elastic_ttl:
                    return r
                continue
            if now - ts > self.args.elastic_ttl:
                return r
        return None

    def run(self) -> int:
        pod = None
        reforms = 0
        try:
            while True:
                pod = self.build_pod()
                if self.elastic:
                    # a stale mark from the previous incarnation must
                    # not trip the watchdog consumer on the fresh pod
                    self._clear_unhealthy(0)
                self.spawn(pod)
                result, arg = self.watch(pod)
                if result == "done":
                    return 0
                if result == "exit":
                    return arg
                # re-form at the (possibly newer) generation
                self.generation = max(arg, self._gen_bump())
                reforms += 1
                if reforms > max(self.args.max_restart, 3) * 3:
                    print("[launch] elastic re-formation budget "
                          "exhausted", file=sys.stderr)
                    return 1
        finally:
            if pod is not None:
                self._kill(pod)
            if self.standby is not None:
                self.standby.close()
            if self.store is not None:
                self.store.close()


def launch(argv=None) -> int:
    args = parse_args(argv)
    return Controller(args).run()


def main():
    sys.exit(launch())


if __name__ == "__main__":
    main()
