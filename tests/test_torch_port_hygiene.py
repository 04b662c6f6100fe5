"""The port stands alone: paddle_tpu_torch and its scripts (chip_smoke.py,
tools/torch_*.py) import neither jax nor paddle_tpu (nor ml_dtypes, which
the card's machine lacks), and its entry points
default to CUDA and raise where there is none instead of running on the
CPU quietly."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import paddle_tpu_torch as paddle
from paddle_tpu_torch.inference import (PagedCausalLM, PagedServingConfig,
                                        ServingEngine)
from paddle_tpu_torch.models import llama
from paddle_tpu_torch.ops.kernels import resolve_device

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "paddle_tpu", "ml_dtypes")


def _port_files():
    files = sorted((ROOT / "paddle_tpu_torch").rglob("*.py"))
    files += sorted((ROOT / "tools").glob("torch_*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_sources_import_no_jax_or_reference():
    files = _port_files()
    assert len(files) > 10 and files[-1].exists()
    bad = [(str(f.relative_to(ROOT)), name) for f in files
           for name in _imports(f)
           if name.split(".")[0] in FORBIDDEN]
    assert bad == []


def test_spawned_rank_functions_import_no_jax():
    # the multi-rank tests' ranks run tests/torch_dist_workers.py and the
    # port's distributed package, never the reference
    worker = ROOT / "tests" / "torch_dist_workers.py"
    assert [n for n in _imports(worker)
            if n.split(".")[0] in FORBIDDEN] == []
    code = ("import sys; sys.path.insert(0, 'tests'); "
            "import torch_dist_workers, paddle_tpu_torch.distributed; "
            "import paddle_tpu_torch.distributed.fleet; "
            "import paddle_tpu_torch.distributed.meta_parallel; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'paddle_tpu')))")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_import_leaves_jax_unloaded():
    code = ("import sys, paddle_tpu_torch, paddle_tpu_torch.inference; "
            "import paddle_tpu_torch.utils.convert; "
            "import paddle_tpu_torch.models.llama; "
            "import paddle_tpu_torch.models.gpt, paddle_tpu_torch.models.bert; "
            "import paddle_tpu_torch.nn.layer.transformer; "
            "import paddle_tpu_torch.ops.yaml_extra, paddle_tpu_torch.jit; "
            "import paddle_tpu_torch.distributed.fleet.trainer; "
            "import paddle_tpu_torch.ops.kernels.flash_attention; "
            "import paddle_tpu_torch.distributed.auto_parallel; "
            "import paddle_tpu_torch.distributed.store; "
            "import paddle_tpu_torch.distributed.launch.main; "
            "import paddle_tpu_torch.vision.models.resnet; "
            "import paddle_tpu_torch.hapi.model, paddle_tpu_torch.io; "
            "import paddle_tpu_torch.metric, paddle_tpu_torch.framework.io; "
            "import paddle_tpu_torch.optimizer.lr; "
            "import paddle_tpu_torch.profiler; "
            "import paddle_tpu_torch.amp.debugging; "
            "import paddle_tpu_torch.profiler.tracing; "
            "import paddle_tpu_torch.distributed.transport; "
            "import paddle_tpu_torch.distributed.watchdog; "
            "import paddle_tpu_torch.distributed.checkpoint; "
            "import paddle_tpu_torch.distributed.elastic; "
            "import paddle_tpu_torch.distributed.resilience.faults; "
            "import paddle_tpu_torch.distributed.resilience.guards; "
            "import paddle_tpu_torch.distributed.resilience.recovery; "
            "import paddle_tpu_torch.distributed.resilience.supervisor; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'paddle_tpu', 'ml_dtypes')))")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is valid")
    cfg = PagedServingConfig()
    with pytest.raises(RuntimeError, match="CUDA"):
        PagedCausalLM(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(cfg=cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    model = PagedCausalLM(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine.from_model(model, cfg)
    assert resolve_device("cpu") == torch.device("cpu")
    # the eager surface: its default place is "gpu:0"
    assert paddle.get_device() == "gpu:0"
    with pytest.raises(RuntimeError, match="CUDA"):
        paddle.to_tensor([1.0, 2.0])
    with pytest.raises(RuntimeError, match="CUDA"):
        paddle.nn.Layer().create_parameter([2, 2])
    with pytest.raises(RuntimeError, match="CUDA"):
        llama.LlamaForCausalLM(llama.LLAMA_PRESETS["debug"])
    p = paddle.Parameter(torch.zeros(2))      # a CPU tensor stays there
    p.grad = torch.ones(2)
    opt = paddle.optimizer.AdamW(parameters=[p], learning_rate=0.1)
    with pytest.raises(RuntimeError, match="CUDA"):
        opt.step()                            # the moments' default place


def test_launcher_engine_and_device_mesh_default_to_cuda():
    # one worker a card and NCCL by default: without CUDA each raises
    # instead of falling back to CPU workers or gloo
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is valid")
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed.launch import main as launch

    with pytest.raises(RuntimeError, match="CUDA"):
        launch.Controller(launch.parse_args(["train.py"]))
    with pytest.raises(RuntimeError, match="CUDA"):
        dist.init_parallel_env()
    mesh = dist.ProcessMesh([0], dim_names=["dp"])
    with pytest.raises(RuntimeError, match="CUDA"):
        mesh.to_device_mesh()
    engine = dist.auto_parallel.Engine(paddle.nn.Layer())
    with pytest.raises(RuntimeError, match="CUDA"):
        engine.prepare(mesh=mesh)


def test_vision_entry_points_default_to_cuda(tmp_path):
    # the vision slice's models, data pipeline, metrics' op and load make
    # their tensors on the default place, "gpu:0": without CUDA each
    # raises instead of running on the CPU
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is valid")
    import numpy as np

    from paddle_tpu_torch.vision.models import LeNet, resnet50

    with pytest.raises(RuntimeError, match="CUDA"):
        resnet50()
    with pytest.raises(RuntimeError, match="CUDA"):
        LeNet()
    loader = paddle.io.DataLoader(
        paddle.vision.datasets.FakeImageDataset(8), batch_size=4,
        num_workers=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        next(iter(loader))
    with pytest.raises(RuntimeError, match="CUDA"):
        paddle.nn.BatchNorm2D(3)
    path = str(tmp_path / "w.pdparams")
    paddle.save({"w": np.zeros(2, np.float32)}, path)
    assert isinstance(paddle.load(path, return_numpy=True)["w"], np.ndarray)
    import pickle

    with open(path, "wb") as f:
        pickle.dump({"w": ("__tensor__", np.zeros(2, np.float32))}, f)
    with pytest.raises(RuntimeError, match="CUDA"):
        paddle.load(path)
