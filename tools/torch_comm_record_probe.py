"""The comm record's host cost a call, and its pieces, on one card.

    python tools/torch_comm_record_probe.py [ROOT ...]   (needs one CUDA card)

With no ROOT it measures the paddle_tpu_torch beside this script, in this
process; with ROOTs (checkouts of the repo) it runs itself once for each,
in a fresh process, in the order ROOT1 ... ROOTn ROOTn ... ROOT1, so that
two trees compare in turns within one call. A run prints one JSON line:
the card's name and power limit, and the microseconds a call (median of
the turns; each turn `calls` back-to-back calls, the states in the order
off, on, on, off) of

- ``record_off`` / ``record_on``: ``collective.record_collective(
  "all_reduce", ...)`` then ``issued(t)`` on a CUDA tensor (what every
  collective of collective.py adds), with the comm watchdog off and on;
- ``event``: a ``torch.cuda.Event()`` made and recorded (the watchdog's
  completion probe of one NCCL collective);
- ``start_task``: the watchdog's ``start_task`` alone;
- ``poll_ms``: one pass of the watchdog's poll over ``calls`` recorded
  tasks (its thread makes one a second, holding the manager's lock).

No collective is issued: the tensor's record is what is timed.
"""
import json
import os
import statistics
import subprocess
import sys
import time

CALLS = 4000


def _card():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else "nvidia-smi unavailable"


def _us(fn, calls=CALLS):
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    return (time.perf_counter() - t) * 1e6 / calls


def measure(root):
    sys.path.insert(0, root)
    import torch

    from paddle_tpu_torch.distributed import collective
    from paddle_tpu_torch.distributed.watchdog import (
        comm_task_manager, disable_comm_watchdog, enable_comm_watchdog)

    t = torch.ones(1024, device="cuda")

    def record():
        collective.record_collective("all_reduce", 1, [0, 1], t).issued(t)

    def event():
        torch.cuda.Event().record()

    def start_task():
        comm_task_manager.start_task("all_reduce", 1, [0, 1], 0)

    got = {k: [] for k in ("record_off", "record_on", "event",
                           "start_task", "poll_ms")}
    record()
    for how in ("off", "on", "on", "off"):
        if how == "on":
            enable_comm_watchdog(600.0)
        else:
            disable_comm_watchdog()
        got["record_" + how].append(_us(record))
        got["event"].append(_us(event))
        if how == "on":
            got["start_task"].append(_us(start_task))
            tasks = comm_task_manager.pending()
            t0 = time.perf_counter()
            for task in tasks:
                task.poll()
            got["poll_ms"].append((time.perf_counter() - t0) * 1e3)
    disable_comm_watchdog()
    return {"root": root, "card": _card(), "torch": torch.__version__,
            "calls": CALLS, "turns": got,
            "median": {k: statistics.median(v) for k, v in got.items()}}


def main(argv):
    import torch

    if not torch.cuda.is_available():
        print("torch_comm_record_probe: no CUDA card", file=sys.stderr)
        return 1
    if not argv:
        here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        print(json.dumps(measure(here)), flush=True)
        return 0
    for root in argv + argv[::-1]:
        env = dict(os.environ, PROBE_ROOT=os.path.abspath(root))
        r = subprocess.run([sys.executable, os.path.abspath(__file__)],
                           env=env)
        if r.returncode:
            return r.returncode
    return 0


if __name__ == "__main__":
    if os.environ.get("PROBE_ROOT"):
        import torch

        if not torch.cuda.is_available():
            sys.exit(1)
        print(json.dumps(measure(os.environ["PROBE_ROOT"])), flush=True)
        sys.exit(0)
    sys.exit(main(sys.argv[1:]))
