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

Elastic re-formation (``--nnodes lo:hi``, heartbeats, the generation
bump, the comm watchdog's unhealthy mark) and the supervisor's
``--ckpt_dir`` / ``--snapshot_every`` need elastic.py, watchdog.py and
resilience/supervisor.py: they raise naming ROADMAP.md, queue 1, item 8.
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

_ITEM_8 = ("needs the elastic controller, the comm watchdog and the "
           "resilience supervisor (ROADMAP.md, queue 1, item 8)")


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
                        help="node count (a lo:hi range, elastic, is not "
                             "ported yet)")
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
                        help="checkpoint root of the elastic supervisor "
                             "(not ported yet)")
    parser.add_argument("--standby", default=None,
                        help="host:port of the hot-standby rendezvous "
                             "store replica (PT_STORE_STANDBY); every "
                             "store client fails over to it")
    parser.add_argument("--snapshot_every", type=int, default=0,
                        help="in-memory snapshot interval of the "
                             "supervisor (not ported yet)")
    parser.add_argument("--elastic_timeout", type=float, default=30.0)
    parser.add_argument("--elastic_ttl", type=float, default=10.0)
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
        if hi or args.ckpt_dir or args.snapshot_every > 0:
            which = ("--nnodes lo:hi" if hi else
                     "--ckpt_dir" if args.ckpt_dir else "--snapshot_every")
            raise NotImplementedError(
                f"paddle_tpu_torch launch: {which} {_ITEM_8}")
        self.nnodes = int(lo)
        self.cards = self._cards()
        local_only = self.nnodes == 1 and args.master is None
        self.host = args.host or ("127.0.0.1" if local_only else
                                  socket.gethostbyname(socket.gethostname()))
        self.store = None
        self.standby = None
        self.is_master = False

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

    def build_pod(self) -> Pod:
        """This node's rank and every worker's endpoint (reference
        build_pod, :163-226): one node needs no rendezvous; several
        register their workers' endpoints in the store and read the
        others'."""
        if self.store is None:
            self._connect_store()
        mine = ",".join(f"{self.host}:{_free_port()}" for _ in self.cards)
        if self.nnodes == 1 and self.args.master is None:
            return Pod(0, mine.split(","), self.cards)
        ns = self.args.job_id
        rank = self.args.rank
        if rank < 0:
            rank = self.store.add(f"{ns}/nodes", 1) - 1
        self.store.set(f"{ns}/ep/{rank}", mine)
        world = []
        for r in range(self.nnodes):
            world += self.store.get(f"{ns}/ep/{r}").decode().split(",")
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
        })
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
    def watch(self, pod: Pod):
        """("done", 0) once every worker exited 0, or ("exit", code) once
        a failure finds the restart budget spent (reference :280-360). A
        failure kills the pod; within the budget the pod starts again,
        on fresh endpoints when it is the only node."""
        restarts = 0
        while True:
            statuses = [p.poll() for p in pod.procs]
            if all(s == 0 for s in statuses):
                return ("done", 0)
            failed = [s for s in statuses if s not in (None, 0)]
            if failed:
                self._kill(pod)
                if restarts >= self.args.max_restart:
                    print(f"[launch] worker failed (exit {failed[0]}); "
                          f"restart budget exhausted", file=sys.stderr)
                    return ("exit", failed[0])
                restarts += 1
                print(f"[launch] worker failed (exit {failed[0]}); "
                      f"restart {restarts}/{self.args.max_restart}",
                      file=sys.stderr)
                if self.nnodes == 1 and self.args.master is None:
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

    def run(self) -> int:
        pod = None
        try:
            pod = self.build_pod()
            self.spawn(pod)
            result, arg = self.watch(pod)
            return 0 if result == "done" else arg
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
