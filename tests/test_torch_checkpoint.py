"""The port's distributed checkpoint (paddle_tpu_torch.distributed.
checkpoint) and its step_<N> recovery (resilience/recovery.py) on the CPU,
against the JAX package's.

Every comparison is exact (a checkpoint moves bits; bf16 goes out as f32,
which holds every bf16 value). A round trip of eager Tensors, torch
tensors (bf16 among them) and numpy arrays; a load with a missing key or
another shape raises. One gloo world of 2 (tests/torch_dist_workers.py::
checkpoint_reshard) saves DTensor shards and loads them back into other
placements; this process then loads that world-2 checkpoint at world 1,
into torch tensors and into the reference's Tensors. A checkpoint the
reference writes (bf16 included, as ml_dtypes arrays) loads in the port
as bf16. ``resume_from_latest`` skips and sweeps a torn step directory,
whether a test makes it or a ``kill@save`` chaos fault in a process.
"""
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
from paddle_tpu.distributed import checkpoint as JC
from paddle_tpu_torch import distributed as dist
from paddle_tpu_torch.core.tensor import Tensor
from paddle_tpu_torch.distributed import checkpoint as TC
from paddle_tpu_torch.distributed.resilience.recovery import (
    latest_checkpoint, list_checkpoints, resume_from_latest,
    save_checkpoint)

import torch_dist_workers as W

ROOT = Path(__file__).resolve().parents[1]


def _arrays():
    r = np.random.RandomState(0)
    b = torch.from_numpy(r.randn(4, 10).astype(np.float32)).to(
        torch.bfloat16).float().numpy()
    return {"w": r.randn(8, 6).astype(np.float32), "b": b,
            "r": r.randn(6, 3).astype(np.float32),
            "plain": r.randn(5).astype(np.float32),
            "np": r.randn(2, 2)}


def test_round_trip_and_refusals(tmp_path):
    a = _arrays()
    state = {"w": Tensor(torch.from_numpy(a["w"])),
             "b": torch.from_numpy(a["b"]).to(torch.bfloat16),
             "i": torch.arange(7, dtype=torch.int64),
             "np": a["np"]}
    TC.save_state_dict(state, str(tmp_path / "c"))
    meta = TC._read_metadata(str(tmp_path / "c"))
    # bf16 goes out as f32
    assert meta.state_dict_metadata["b"][0].dtype == "float32"
    target = {"w": Tensor(torch.zeros(8, 6)),
              "b": torch.zeros(4, 10, dtype=torch.bfloat16),
              "i": torch.zeros(7, dtype=torch.int64), "np": None}
    TC.load_state_dict(target, str(tmp_path / "c"))
    assert torch.equal(target["w"]._value, torch.from_numpy(a["w"]))
    assert target["b"].dtype == torch.bfloat16
    assert torch.equal(target["b"].float(), torch.from_numpy(a["b"]))
    assert torch.equal(target["i"], torch.arange(7))
    np.testing.assert_array_equal(target["np"].numpy(), a["np"])
    with pytest.raises(KeyError, match="missing"):
        TC.load_state_dict({"missing": torch.zeros(1)}, str(tmp_path / "c"))
    with pytest.raises(ValueError, match="shape"):
        TC.load_state_dict({"w": torch.zeros(6, 8)}, str(tmp_path / "c"))


def test_dtensor_save_at_world_2_reshards_and_loads_everywhere(tmp_path):
    a = _arrays()
    dist.spawn(W.checkpoint_reshard, args=(str(tmp_path), a), nprocs=2,
               backend="gloo", timeout=180)
    got = [pickle.loads((tmp_path / f"rank{r}.pkl").read_bytes())
           for r in range(2)]
    for g in got:
        for k in ("w", "b", "r", "plain", "np"):
            np.testing.assert_array_equal(g[k], a[k], err_msg=k)
        assert g["b_dtype"] == "paddle.bfloat16" or "bfloat16" in \
            g["b_dtype"]
        assert g["r_local_rows"] == 3           # Shard(0) of 6 rows
    # per-rank shard files and one manifest
    assert got[0]["files"] == ["0.metadata", "0_0.distcp", "1_0.distcp"]
    path = str(tmp_path / "ckpt")
    meta = TC._read_metadata(path)
    offsets = sorted(m.global_offset for m in meta.state_dict_metadata["w"])
    assert offsets == [(0, 0), (4, 0)]
    # world 1: into plain torch tensors
    target = {k: torch.zeros(v.shape, dtype=torch.float64 if k == "np"
                             else torch.float32) for k, v in a.items()}
    TC.load_state_dict(target, path)
    for k, v in a.items():
        np.testing.assert_array_equal(target[k].numpy(), v, err_msg=k)
    # and into the reference's Tensors (f32: the f64 array is cast to
    # the target's dtype, as the reference casts)
    jt = {k: jpaddle.to_tensor(np.zeros_like(v)) for k, v in a.items()}
    JC.load_state_dict(jt, path)
    for k, v in a.items():
        got = np.asarray(jt[k].numpy())
        np.testing.assert_array_equal(got, v.astype(got.dtype), err_msg=k)


def test_reference_checkpoint_loads_in_the_port(tmp_path):
    import ml_dtypes

    a = _arrays()
    ref_state = {"w": jpaddle.to_tensor(a["w"]),
                 "b": jpaddle.to_tensor(a["b"]).astype("bfloat16"),
                 "np": a["np"]}
    JC.save_state_dict(ref_state, str(tmp_path / "ref"))
    meta = TC._read_metadata(str(tmp_path / "ref"))
    assert isinstance(meta, TC.Metadata)
    assert meta.state_dict_metadata["b"][0].dtype == "bfloat16"
    target = {"w": torch.zeros(8, 6),
              "b": torch.zeros(4, 10, dtype=torch.bfloat16),
              "np": torch.zeros(2, 2, dtype=torch.float64)}
    TC.load_state_dict(target, str(tmp_path / "ref"))
    assert torch.equal(target["w"], torch.from_numpy(a["w"]))
    assert torch.equal(target["b"], torch.from_numpy(a["b"]).to(
        torch.bfloat16))
    assert torch.equal(target["np"], torch.from_numpy(a["np"]))
    # a non-tensor target takes the saved bf16 as a bf16 Tensor
    loose = {"b": None}
    TC.load_state_dict(loose, str(tmp_path / "ref"))
    assert loose["b"]._value.dtype == torch.bfloat16
    assert ml_dtypes.bfloat16 is not None


def _torn_dir(root, step):
    d = os.path.join(root, f"step_{step:08d}")
    os.makedirs(d)
    with open(os.path.join(d, "0_0.distcp"), "wb") as f:
        f.write(b"torn")
    return d


def test_torn_saves_are_skipped_and_swept(tmp_path):
    root = str(tmp_path / "ckpts")
    save_checkpoint({"w": torch.arange(4, dtype=torch.float32)}, root, 2)
    torn = _torn_dir(root, 7)
    # a process killed by the chaos plan between shards and manifest
    code = ("import sys, torch; sys.path.insert(0, %r); "
            "from paddle_tpu_torch.distributed.resilience.recovery import "
            "save_checkpoint; "
            "save_checkpoint({'w': torch.ones(4)}, %r, 9); "
            "raise SystemExit('kill@save did not fire')" % (str(ROOT), root))
    env = dict(os.environ, PT_FAULT_PLAN="kill@save#1")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 1, out.stderr
    assert os.path.isdir(os.path.join(root, "step_00000009"))
    assert latest_checkpoint(root)[0] == 2
    target = {"w": torch.zeros(4)}
    assert resume_from_latest(target, root) == 2
    assert torch.equal(target["w"], torch.arange(4, dtype=torch.float32))
    assert not os.path.exists(torn)
    assert not os.path.exists(os.path.join(root, "step_00000009"))
    assert [s for s, _ in list_checkpoints(root)] == [2]
    assert resume_from_latest({}, str(tmp_path / "empty")) is None
    # the reference reads the port's step directory
    jt = {"w": jpaddle.to_tensor(np.zeros(4, np.float32))}
    assert __import__("paddle_tpu.distributed.resilience.recovery",
                      fromlist=["x"]).resume_from_latest(jt, root) == 2
    np.testing.assert_array_equal(np.asarray(jt["w"].numpy()),
                                  np.arange(4, dtype=np.float32))
