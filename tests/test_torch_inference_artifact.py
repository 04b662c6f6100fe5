"""The port's deploy artifact (paddle_tpu_torch.inference:
save_inference_model -> Config -> create_predictor -> Predictor.run)
against the JAX package's (tests/test_inference_serving.py's first five
cases), on the CPU.

One SmallMLP (8 -> 16 -> 4, relu, biased Linears) is built in the JAX
package from a seed; its parameters go into the port's SmallMLP of the same
names (utils.convert.load_params_from_paddle_tpu). Each package saves its
own artifact and loads it in its own predictor. f32 outputs agree to
rtol/atol 1e-5: both sides compute in f32, two products of depth 8 and 16
summed in other orders. The bf16 artifacts (weights and inputs cast to
bf16, products accumulated in f32 on both sides, then rounded) agree with
each other and with the f32 model within 5e-2, the reference's own bound.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu import inference as JI
from paddle_tpu.jit.api import InputSpec as JInputSpec
from paddle_tpu.jit.functional import current_params

from paddle_tpu_torch import inference as TI
from paddle_tpu_torch.jit import InputSpec
from paddle_tpu_torch.nn.modules import TorchLinear as Linear
from paddle_tpu_torch.utils import load_params_from_paddle_tpu

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    # one PyTorch thread while the test runs, restored after (see
    # test_torch_serving.py: the first float exp after MKL's first GEMM)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class JaxMLP(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.fc1 = jnn.Linear(8, 16)
        self.fc2 = jnn.Linear(16, 4)

    def forward(self, x):
        return self.fc2(jnn.functional.relu(self.fc1(x)))


class SmallMLP(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.fc1 = Linear(8, 16, bias_attr=True, device="cpu")
        self.fc2 = Linear(16, 4, bias_attr=True, device="cpu")

    def forward(self, x):
        return self.fc2(torch.relu(self.fc1(x)))


def _models(seed):
    paddle.seed(seed)
    jm = JaxMLP()
    jm.eval()
    named = {k: np.asarray(v) for k, v in current_params(jm).items()}
    # biases start at zero in both packages: give them values to carry
    rng = np.random.RandomState(seed)
    for k in named:
        if k.endswith("bias"):
            named[k] = rng.randn(*named[k].shape).astype(np.float32)
    jm.set_state_dict({k: paddle.to_tensor(v) for k, v in named.items()})
    tm = load_params_from_paddle_tpu(SmallMLP(), named)
    return jm, tm


def _cpu_config(prefix):
    cfg = TI.Config(prefix)
    cfg.disable_gpu()
    return cfg


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    d = tmp_path_factory.mktemp("artifact")
    jm, tm = _models(0)
    jprefix, tprefix = str(d / "jax_mlp"), str(d / "torch_mlp")
    JI.save_inference_model(jprefix, jm,
                            [JInputSpec([None, 8], "float32", "x")],
                            output_names=["y"])
    TI.save_inference_model(tprefix, tm, [InputSpec([None, 8], "float32",
                                                    "x")],
                            output_names=["y"])
    x = np.random.RandomState(0).randn(3, 8).astype(np.float32)
    return jm, tm, jprefix, tprefix, x


def _jax_run(jprefix, x):
    (y,) = JI.create_predictor(JI.Config(jprefix)).run([x])
    return np.asarray(y)


def test_predictor_matches_jax_predictor(saved):
    jm, tm, jprefix, tprefix, x = saved
    pred = TI.create_predictor(_cpu_config(tprefix))
    assert pred.get_input_names() == ["x"]
    (got,) = pred.run([x])
    np.testing.assert_allclose(got, _jax_run(jprefix, x), rtol=TOL,
                               atol=TOL)
    with torch.no_grad():
        eager = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, eager, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("bs", [1, 5])
def test_dynamic_batch(saved, bs):
    """One program serves every batch size: the None dim exported as a
    Dim (traced at 2; torch.export specializes 0 and 1)."""
    _, _, jprefix, tprefix, _ = saved
    pred = TI.create_predictor(_cpu_config(tprefix))
    xb = np.random.RandomState(bs).randn(bs, 8).astype(np.float32)
    (got,) = pred.run([xb])
    assert got.shape == (bs, 4)
    np.testing.assert_allclose(got, _jax_run(jprefix, xb), rtol=TOL,
                               atol=TOL)


def test_handle_api(saved):
    _, _, jprefix, tprefix, x = saved
    pred = TI.create_predictor(_cpu_config(tprefix))
    h = pred.get_input_handle("x")
    h.copy_from_cpu(x)
    assert h.shape() == [3, 8]
    assert pred.run() is True
    names = pred.get_output_names()
    assert names == ["y"]
    out = pred.get_output_handle(names[0])
    assert out.shape() == [3, 4]
    np.testing.assert_allclose(out.copy_to_cpu(), _jax_run(jprefix, x),
                               rtol=TOL, atol=TOL)


def test_fresh_process_predict(saved, tmp_path):
    """The deploy contract: a process that imports only
    paddle_tpu_torch.inference (never the model's class) loads the
    artifact and predicts, without loading jax or paddle_tpu."""
    _, _, jprefix, tprefix, x = saved
    xin, yout = tmp_path / "x.npy", tmp_path / "y.npy"
    np.save(xin, x)
    script = textwrap.dedent(f"""
        import sys
        import numpy as np
        from paddle_tpu_torch.inference import Config, create_predictor
        cfg = Config({tprefix!r})
        cfg.disable_gpu()
        (y,) = create_predictor(cfg).run([np.load({str(xin)!r})])
        np.save({str(yout)!r}, y)
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "paddle_tpu"))
        assert not bad, bad
    """)
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", script], env=env,
                         capture_output=True, timeout=180)
    assert out.returncode == 0, out.stderr.decode()
    np.testing.assert_allclose(np.load(yout), _jax_run(jprefix, x),
                               rtol=TOL, atol=TOL)


def test_bf16_precision_knob(tmp_path):
    jm, tm = _models(1)
    jprefix, tprefix = str(tmp_path / "jax_bf16"), str(tmp_path / "t_bf16")
    JI.save_inference_model(jprefix, jm, [JInputSpec([2, 8], "float32",
                                                     "x")],
                            precision=JI.PrecisionType.Bfloat16)
    TI.save_inference_model(tprefix, tm, [InputSpec([2, 8], "float32",
                                                    "x")],
                            precision=TI.PrecisionType.Bfloat16)
    x = np.random.RandomState(1).randn(2, 8).astype(np.float32)
    (got,) = TI.create_predictor(_cpu_config(tprefix)).run([x])
    assert got.dtype == np.float32
    with torch.no_grad():
        want = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=5e-2, atol=5e-2)
    np.testing.assert_allclose(got, _jax_run(jprefix, x), rtol=5e-2,
                               atol=5e-2)


def test_artifact_keeps_the_reference_files_and_keys(saved):
    """The three files of both packages, the same archive keys and the
    same signature keys and values; the program holds no weights."""
    _, _, jprefix, tprefix, _ = saved
    for prefix in (jprefix, tprefix):
        for ext in (".pdmodel", ".pdiparams.npz", ".pdconfig"):
            assert os.path.isfile(prefix + ext)
    sig = {}
    for prefix in (jprefix, tprefix):
        with open(prefix + ".pdconfig") as f:
            sig[prefix] = json.load(f)
    assert sig[jprefix] == sig[tprefix]
    with np.load(jprefix + ".pdiparams.npz") as j, \
            np.load(tprefix + ".pdiparams.npz") as t:
        assert sorted(j.files) == sorted(t.files)
        for k in j.files:
            np.testing.assert_array_equal(j[k], t[k])
    program, params, buffers, _ = TI.load_inference_model(tprefix, "cpu")
    assert len(params) == 4 and buffers == []
    assert not any(n.op == "get_attr" for n in program.graph.nodes)
    # nor does the .pdmodel keep the traced example inputs (the weights
    # again, and buffers as large as a server's KV pools)
    with open(tprefix + ".pdmodel", "rb") as f:
        exported = torch.export.load(f)
    assert exported.example_inputs is None and not exported.state_dict


def test_bf16_params_round_trip_through_the_archive(tmp_path):
    """bf16 parameters are kept as uint8 bytes with their dtype and shape
    in the signature, and come back bit for bit."""
    _, tm = _models(2)
    prefix = str(tmp_path / "mlp")
    TI.save_inference_model(prefix, tm, [InputSpec([2, 8])],
                            precision=TI.PrecisionType.Bfloat16)
    _, params, _, sig = TI.load_inference_model(prefix, "cpu")
    names = sorted(dict(tm.named_parameters()))
    assert sorted(sig["array_meta"]) == [f"p{i}" for i in range(4)]
    for name, p in zip(names, params):
        assert p.dtype == torch.bfloat16
        assert torch.equal(p, dict(tm.named_parameters())[name]
                           .to(torch.bfloat16))


def test_predictor_defaults_to_cuda(saved):
    """Config selects the card unless disable_gpu() is called; where
    there is no CUDA, the predictor raises instead of running on the CPU
    quietly."""
    _, _, _, tprefix, _ = saved
    cfg = TI.Config(tprefix)
    assert cfg.use_gpu()
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        TI.create_predictor(cfg)
    cfg.enable_use_tpu()
    assert cfg.use_gpu()
    cfg.disable_gpu()
    assert not cfg.use_gpu()
