"""The port's launch CLI (``python -m paddle_tpu_torch.distributed.launch``)
on the CPU, its workers over gloo, against the JAX package's launcher
(paddle_tpu.distributed.launch).

Two workers of tests/torch_launch_worker.py read the environment contract
and train a Linear under DataParallel (tests/test_models_launch.py's
numbers: SGD 0.1, 5 steps, each rank half of 8 rows); both ranks' weights
agree to 1e-6 and equal the reference's single-process full-batch run
within 1e-5 relative and 1e-6 absolute (the gradient mean taken by the
all-reduce, in another order). A worker that fails once is restarted
and the launcher returns 0; with the budget spent it returns the
worker's code. ``parse_args`` keeps the reference's options and defaults,
but for ``--nproc_per_node`` (one worker a card: the visible cards) and
``--devices`` (each worker's card). ``--ckpt_dir`` and ``--snapshot_every``
reach the workers' environment, and an elastic job (``--nnodes 1:2``,
two controllers of one gloo worker each) re-forms at one node after the
other node's processes are killed, its worker resuming from the last
checkpoint. ``--standby`` serves the store's hot replica and tells every
worker of it.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from paddle_tpu.distributed.launch import main as jlaunch
from paddle_tpu_torch.distributed.launch import main as tlaunch

ROOT = Path(__file__).resolve().parents[1]


def _env(tmp_path):
    env = dict(os.environ, OUT_DIR=str(tmp_path),
               PADDLE_DISTRI_BACKEND="gloo",
               PYTHONPATH=str(ROOT) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    return env


def test_launch_cli_dataparallel_matches_the_full_batch_reference(tmp_path):
    import paddle_tpu as jpaddle
    import paddle_tpu.nn as jnn

    jpaddle.seed(0)
    ref = jnn.Linear(4, 2)
    np.savez(tmp_path / "init.npz", weight=np.asarray(ref.weight.numpy()),
             bias=np.asarray(ref.bias.numpy()))
    r = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--nproc_per_node", "2", "--devices", "0,1", "--log_dir",
         str(tmp_path / "log"), str(ROOT / "tests" / "torch_launch_worker.py"),
         "--flag", "x"],
        env=_env(tmp_path), timeout=240, capture_output=True, cwd=str(ROOT))
    logs = {p.name: p.read_text()[-600:]
            for p in (tmp_path / "log").glob("workerlog.*")}
    assert r.returncode == 0, (r.stderr.decode()[-800:], logs)
    assert sorted(logs) == ["workerlog.0", "workerlog.1"]
    envs = [json.loads((tmp_path / f"env{i}.json").read_text())
            for i in range(2)]
    eps = envs[0]["env"]["PADDLE_TRAINER_ENDPOINTS"].split(",")
    assert len(eps) == 2 and len(set(eps)) == 2
    for i, got in enumerate(envs):
        e = got["env"]
        assert (got["rank"], got["world"], got["local"]) == (i, 2, i)
        assert e["PADDLE_TRAINER_ID"] == str(i)
        assert e["PADDLE_TRAINERS_NUM"] == "2"
        assert e["PADDLE_TRAINER_ENDPOINTS"].split(",") == eps
        assert e["PADDLE_CURRENT_ENDPOINT"] == eps[i]
        assert e["PADDLE_LOCAL_RANK"] == str(i)
        assert e["PADDLE_JOB_ID"] == "default"
        assert e["PADDLE_MASTER"].startswith("127.0.0.1:")
        assert got["argv"] == ["--flag", "x"]
    w0, w1 = np.load(tmp_path / "w0.npy"), np.load(tmp_path / "w1.npy")
    np.testing.assert_allclose(w0, w1, rtol=0, atol=1e-6)
    opt = jpaddle.optimizer.SGD(parameters=ref.parameters(),
                                learning_rate=0.1)
    loss_fn = jnn.MSELoss()
    rng = np.random.RandomState(42)
    x_full = rng.randn(8, 4).astype("float32")
    y_full = rng.randn(8, 2).astype("float32")
    for _ in range(5):
        loss = loss_fn(ref(jpaddle.to_tensor(x_full)),
                       jpaddle.to_tensor(y_full))
        loss.backward()
        opt.step()
        opt.clear_grad()
    np.testing.assert_allclose(w0, np.asarray(ref.weight.numpy()),
                               rtol=1e-5, atol=1e-6)


def _script(tmp_path, body):
    script = tmp_path / "worker.py"
    script.write_text(body)
    return str(script)


def test_launch_restarts_a_failed_worker(tmp_path, monkeypatch):
    script = _script(tmp_path, (
        "import os, sys\n"
        "marker = os.path.join(os.environ['OUT_DIR'], 'attempt')\n"
        "n = int(open(marker).read()) if os.path.exists(marker) else 0\n"
        "open(marker, 'w').write(str(n + 1))\n"
        "sys.exit(1 if n == 0 else 0)\n"))
    monkeypatch.setenv("OUT_DIR", str(tmp_path))
    rc = tlaunch.launch(["--nproc_per_node", "1", "--max_restart", "2",
                         "--log_dir", str(tmp_path / "log"), script])
    assert rc == 0
    assert (tmp_path / "attempt").read_text() == "2"


def test_launch_returns_the_worker_code_once_the_budget_is_spent(
        tmp_path, monkeypatch):
    script = _script(tmp_path, (
        "import os, sys\n"
        "open(os.path.join(os.environ['OUT_DIR'], 'runs'), 'a')"
        ".write(os.environ['PADDLE_TRAINER_ID'])\n"
        "sys.exit(3 if os.environ['PADDLE_TRAINER_ID'] == '1' else 0)\n"))
    monkeypatch.setenv("OUT_DIR", str(tmp_path))
    rc = tlaunch.launch(["--nproc_per_node", "2", "--max_restart", "1",
                         "--log_dir", str(tmp_path / "log"), script])
    assert rc == 3
    # the pod ran twice: the first try and the one restart
    assert sorted((tmp_path / "runs").read_text()) == ["0", "0", "1", "1"]


def test_parse_args_defaults_match_the_reference():
    argv = ["train.py", "--lr", "1"]
    ref, got = vars(jlaunch.parse_args(argv)), vars(tlaunch.parse_args(argv))
    assert sorted(got) == sorted(ref)
    # one worker a card, so the default is the visible cards (None here:
    # resolved by the Controller), where the reference's is one a host
    assert ref["nproc_per_node"] == 1 and got["nproc_per_node"] is None
    for k in ref:
        if k != "nproc_per_node":
            assert got[k] == ref[k], k
    assert got["training_script_args"] == ["--lr", "1"]
    got = tlaunch.parse_args(["--gpus", "2,3", "x.py"])
    assert got.devices == "2,3"


ELASTIC_WORKER = """
import json, os, time
import torch
torch.set_num_threads(1)
import paddle_tpu_torch.distributed as dist
from paddle_tpu_torch.distributed.resilience.recovery import (
    resume_from_latest, save_checkpoint)

out, root = os.environ["OUT_DIR"], os.environ["PT_CKPT_ROOT"]
dist.init_parallel_env()
rank, world = dist.get_rank(), dist.get_world_size()
gen = int(os.environ["PADDLE_ELASTIC_GENERATION"])
state = {"w": torch.zeros(4)}
start = resume_from_latest(state, root) or 0
for step in range(start, 8):
    t = torch.ones(4)
    dist.all_reduce(t)
    state["w"] += t / world          # one a step, at any world
    save_checkpoint(state, root, step + 1, keep=2)
    time.sleep(0.1)
with open(os.path.join(out, f"g{gen}r{rank}.json"), "w") as f:
    json.dump({"world": world, "start": start, "w": state["w"].tolist(),
               "snapshot_every": os.environ.get("PT_SNAPSHOT_EVERY"),
               "rejoin": os.environ.get("PT_SUPERVISOR_REJOIN")}, f)
dist.destroy_process_group()
"""


def _elastic_job(tmp_path):
    """Two elastic controllers (``--nnodes 1:2``) of one worker each on a
    store this test serves; node B's process group is killed once a
    checkpoint exists, and node A re-forms at world 1 and resumes."""
    import signal
    import time

    from paddle_tpu_torch.distributed.resilience.recovery import \
        latest_checkpoint
    from paddle_tpu_torch.distributed.store import TCPStore

    script = _script(tmp_path, ELASTIC_WORKER)
    store = TCPStore("127.0.0.1", 0, is_master=True)
    ckpt = str(tmp_path / "ckpt")

    def node(name):
        cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
               "--nnodes", "1:2", "--master", f"127.0.0.1:{store.port}",
               "--nproc_per_node", "1", "--host", "127.0.0.1",
               "--elastic_ttl", "1.5", "--elastic_timeout", "20",
               "--ckpt_dir", ckpt, "--snapshot_every", "3",
               "--log_dir", str(tmp_path / f"log{name}"), script]
        return subprocess.Popen(cmd, env=_env(tmp_path), cwd=str(ROOT),
                                start_new_session=True,
                                stdout=subprocess.DEVNULL,
                                stderr=subprocess.PIPE)

    t0 = time.monotonic()
    a, b = node("A"), node("B")
    try:
        while True:
            found = latest_checkpoint(ckpt)
            if found is not None and found[0] >= 2:
                break
            assert time.monotonic() - t0 < 60, "no checkpoint in 60 s"
            time.sleep(0.05)
        os.killpg(b.pid, signal.SIGKILL)
        rc = a.wait(timeout=60)
        err = a.stderr.read().decode()
        return rc, err, time.monotonic() - t0
    finally:
        for p in (a, b):
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
        store.close()


@pytest.mark.parametrize("flag", ["--nnodes", "--ckpt_dir",
                                  "--snapshot_every"])
def test_launch_elastic_and_supervisor_flags(tmp_path, flag):
    """--ckpt_dir and --snapshot_every reach the worker's environment as
    PT_CKPT_ROOT and PT_SNAPSHOT_EVERY (and the restart budget as
    PT_SUPERVISOR_MAX_RESTARTS, a re-formed pod's workers as rejoiners);
    --nnodes 1:2 re-forms a 2-node job at 1 node after a node dies, and
    its worker resumes from the checkpoint at a step > 0."""
    if flag != "--nnodes":
        args = tlaunch.parse_args(["--nnodes", "1", "--max_restart", "4",
                                   "--ckpt_dir", str(tmp_path / "ck"),
                                   "--snapshot_every", "8",
                                   "--nproc_per_node", "1", "x.py"])
        c = tlaunch.Controller(args)
        pod = tlaunch.Pod(0, ["127.0.0.1:1234"], c.cards)
        c.store = type("S", (), {"port": 0})()
        env = c._worker_env(pod, 0)
        want = {"--ckpt_dir": ("PT_CKPT_ROOT", str(tmp_path / "ck")),
                "--snapshot_every": ("PT_SNAPSHOT_EVERY", "8")}[flag]
        assert env[want[0]] == want[1]
        assert env["PT_SUPERVISOR_MAX_RESTARTS"] == "4"
        assert env["PADDLE_ELASTIC_GENERATION"] == "0"
        assert "PT_SUPERVISOR_REJOIN" not in env
        c.generation = 2
        env = c._worker_env(pod, 0)
        assert env["PT_SUPERVISOR_REJOIN"] == "1"
        assert env["PADDLE_ELASTIC_GENERATION"] == "2"
        return
    rc, err, seconds = _elastic_job(tmp_path)
    assert rc == 0, err[-2000:]
    assert "re-forming pod" in err or "elastic re-formation" in err, err
    first = [json.loads((tmp_path / f"g0r{r}.json").read_text())
             for r in range(2) if (tmp_path / f"g0r{r}.json").exists()]
    assert first == []                     # generation 0 never finished
    done = sorted(tmp_path.glob("g*r0.json"))
    assert len(done) == 1 and done[0].name != "g0r0.json"
    got = json.loads(done[0].read_text())
    assert got["world"] == 1 and got["start"] >= 2
    assert got["w"] == [8.0] * 4           # resumed, not restarted
    assert got["snapshot_every"] == "3" and got["rejoin"] == "1"
    assert seconds < 30, seconds


def test_launch_devices_name_the_workers_cards():
    args = tlaunch.parse_args(["--devices", "3,1", "x.py"])
    c = tlaunch.Controller(args)
    pod = tlaunch.Pod(0, ["127.0.0.1:1", "127.0.0.1:2"], c.cards)
    c.store = type("S", (), {"port": 9})()
    envs = [c._worker_env(pod, i) for i in range(2)]
    assert [e["PADDLE_LOCAL_RANK"] for e in envs] == ["3", "1"]
    assert [e["PADDLE_TRAINER_ID"] for e in envs] == ["0", "1"]
    with pytest.raises(ValueError, match="--devices"):
        tlaunch.Controller(tlaunch.parse_args(
            ["--devices", "0,1", "--nproc_per_node", "3", "x.py"]))


def test_launch_serves_the_standby_store(tmp_path, monkeypatch):
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    script = _script(tmp_path, (
        "import os\n"
        "open(os.path.join(os.environ['OUT_DIR'], 'standby'), 'w')"
        ".write(os.environ['PT_STORE_STANDBY'])\n"))
    monkeypatch.setenv("OUT_DIR", str(tmp_path))
    args = tlaunch.parse_args(["--nproc_per_node", "1", "--standby",
                               f"127.0.0.1:{port}", "--log_dir",
                               str(tmp_path / "log"), script])
    c = tlaunch.Controller(args)
    assert c.run() == 0
    # the controller served the replica, and every worker was told of it
    assert c.standby is not None and c.standby.port == port
    assert (tmp_path / "standby").read_text() == f"127.0.0.1:{port}"
    assert ("127.0.0.1", port) in c.store.endpoints
