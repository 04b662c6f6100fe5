"""The port's resilience worlds (paddle_tpu_torch only, never jax), spawned
2x by tests/test_torch_resilience.py and tests/test_torch_supervisor.py.

Modes (env RESILIENCE_MODE):

- ``kill``: two eager all_reduces over the TCP transport through the
  supervisor's watchdog-tracked ``StepContext.all_reduce``. PT_FAULT_PLAN
  kills rank 1 at its 2nd data-frame send (mid-collective); rank 0 runs
  with the comm watchdog enabled and must raise a structured
  CommTimeoutError within the watchdog timeout (escalation: the store's
  ``__unhealthy__/0`` mark and the aborted transport), writing a marker
  json the parent checks.

- ``group_abort``: a world of one over gloo with no transport (as an
  NCCL trainer runs: its collectives go through torch process groups).
  One collective on a sub-group is recorded and never issued; the
  watchdog must escalate on its own: the ``__unhealthy__`` marks go to
  the launcher's store at PADDLE_MASTER, the group's process group is
  aborted, and the next collective on the group raises CommTimeoutError.

- ``elastic``: tests/resilience_worker.py's 2-rank data-parallel toy run
  under the port's self-healing supervisor: PT_FAULT_PLAN kills rank 1 at
  a step site, the survivor's watchdog escalates, the parent relaunches
  rank 1 with PT_SUPERVISOR_REJOIN=1, the group re-forms, the rejoiner
  restores from the survivor's in-memory ring replica and both finish;
  a first-encounter NaN at TOY_NAN_STEP exercises the skip path. Each
  rank dumps its weights, losses, report and train/* metrics.
"""
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

TOY_DIM = 4
TOY_ROWS = 8          # per rank
TOY_STEPS = 12
TOY_LR = 0.1
_TOY_W_TRUE = (np.arange(TOY_DIM, dtype=np.float64) + 1.0) / TOY_DIM


def _base(rank):
    return np.arange(8, dtype=np.float32) + 10 * (rank + 1)


def toy_batch(step, rank):
    """Deterministic per-(step, rank) regression batch, float64 (the
    reference worker's)."""
    r = np.random.RandomState(10_000 + 97 * step + rank)
    x = r.rand(TOY_ROWS, TOY_DIM)
    return x, x @ _TOY_W_TRUE


def toy_grad_loss(w, step, rank):
    x, y = toy_batch(step, rank)
    err = x @ w - y
    return 2.0 * x.T @ err / len(y), float((err * err).mean())


def run_kill(out_dir, rank):
    from paddle_tpu_torch.distributed.resilience.errors import \
        CommTimeoutError
    from paddle_tpu_torch.distributed.resilience.supervisor import \
        StepContext
    from paddle_tpu_torch.distributed.transport import init_transport
    from paddle_tpu_torch.distributed.watchdog import enable_comm_watchdog

    tp = init_transport()
    enable_comm_watchdog(float(os.environ.get("WATCHDOG_TIMEOUT", "2")))
    ctx = StepContext(rank=rank, world=2, step=0, transport=tp,
                      group_ranks=[0, 1], gid=0)
    out = ctx.all_reduce(_base(rank), "sum")     # rank 1's send #1
    np.testing.assert_array_equal(out, _base(0) + _base(1))
    t0 = time.time()
    marker = {"rank": rank, "error": None, "elapsed": None}
    try:
        ctx.all_reduce(_base(rank) + 1, "sum")   # rank 1 dies on send #2
        marker["error"] = "none"
    except CommTimeoutError as e:
        marker["error"] = "CommTimeoutError"
        marker["elapsed"] = time.time() - t0
        marker["op"] = e.op
        marker["unhealthy"] = json.loads(
            tp._store.get_nowait("__unhealthy__/0"))
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(marker, f)


def run_group_abort(out_dir, rank):
    import torch

    from paddle_tpu_torch.distributed import collective, env
    from paddle_tpu_torch.distributed.resilience.errors import \
        CommTimeoutError
    from paddle_tpu_torch.distributed.transport import get_transport
    from paddle_tpu_torch.distributed.watchdog import (
        comm_task_manager, disable_comm_watchdog, enable_comm_watchdog)
    from paddle_tpu_torch.profiler import metrics

    env.init_parallel_env(backend="gloo")
    g = collective.new_group([0])
    comm_task_manager._POLL_S = 0.05
    enable_comm_watchdog(0.3)
    t = torch.ones(4)
    collective.record_collective("all_reduce", g.id, g.ranks, t)
    t0 = time.time()
    while g.aborted is None and time.time() - t0 < 10:
        time.sleep(0.05)
    marker = {"gid": g.id, "transport": get_transport() is not None,
              "aborted_after_s": time.time() - t0, "error": None}
    try:
        collective.all_reduce(t, group=g)
    except CommTimeoutError as e:
        marker["error"] = "CommTimeoutError"
        marker["op"], marker["group_id"] = e.op, e.group_id
    snap = metrics.snapshot()["counters"]
    marker["counters"] = {k: int(v) for k, v in snap.items()
                          if k.startswith("comm/")}
    disable_comm_watchdog()
    collective.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(marker, f)


def run_elastic_mode(out_dir, rank):
    from paddle_tpu_torch.distributed.resilience.guards import GuardConfig
    from paddle_tpu_torch.distributed.resilience.supervisor import (
        Supervisor, SupervisorConfig)
    from paddle_tpu_torch.profiler import metrics

    nan_step = int(os.environ.get("TOY_NAN_STEP", "-1"))
    nan_fired = []

    def train_fn(state, step, ctx):
        grad, loss = toy_grad_loss(state["w"], step, rank)
        grad = ctx.all_reduce(grad, "avg")
        loss = float(ctx.all_reduce(np.asarray([loss]), "avg")[0])
        if step == nan_step and not nan_fired:
            nan_fired.append(step)
            loss = float("nan")
        return {"w": state["w"] - TOY_LR * grad}, loss

    cfg = SupervisorConfig.from_env(
        snapshot_every=2, replicate_async=False, max_restarts=1,
        transport_timeout_s=60.0,
        watchdog_timeout_s=float(os.environ.get("WATCHDOG_TIMEOUT", "2")),
        reform_timeout_s=float(os.environ.get("REFORM_TIMEOUT", "60")),
        heartbeat_ttl_s=3.0, backoff_base_s=0.1,
        guard=GuardConfig(max_consecutive=3, warmup_steps=100))
    sup = Supervisor(cfg)
    state, report = sup.run(
        train_fn, {"w": np.zeros(TOY_DIM, dtype=np.float64)},
        num_steps=TOY_STEPS)
    snap = metrics.snapshot()
    counters = {k: int(v) for k, v in snap["counters"].items()
                if k.startswith(("train/", "faults/", "elastic/"))}
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
             w=state["w"], losses=np.asarray(report["losses"]),
             report=json.dumps({
                 "final_step": report["final_step"],
                 "restarts": report["restarts"],
                 "skipped": report["skipped"],
                 "recovery_sources": report["recovery_sources"]}),
             metrics=json.dumps(counters))


def main():
    mode = os.environ["RESILIENCE_MODE"]
    out_dir = os.environ["RESILIENCE_OUT_DIR"]
    rank = int(os.environ["PADDLE_TRAINER_ID"])
    {"kill": run_kill, "group_abort": run_group_abort,
     "elastic": run_elastic_mode}[mode](out_dir, rank)


if __name__ == "__main__":
    main()
