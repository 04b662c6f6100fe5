"""Weight streaming in the port (paddle_tpu_torch.inference.weight_stream and
ServingEngine.from_model(weight_stream=...)) against the JAX reference
(paddle_tpu.inference.weight_stream), on the CPU.

The quantizers and the dequant are held to the reference's bits
(tolerance 0): the same numpy arithmetic on the same bf16-cast weights,
and one f32 multiply rounded once. Streamed engines are f32 (2 layers,
hidden 64, ffn 128; int4 also at ffn 100, whose down projection pads its
input rows to 128): their greedy streams must equal the JAX engine's with
the same ``weight_stream`` token for token, prefetch and no prefetch must
give the same bits, and a streamed engine must give the bits of a plain
port engine over the dequantized weights.
"""
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.inference import serving as JS
from paddle_tpu.inference import weight_stream as JW
from paddle_tpu.jit.functional import current_params

from paddle_tpu_torch.inference import serving as TS
from paddle_tpu_torch.inference import weight_stream as TW
from paddle_tpu_torch.ops.kernels import weight_dequant as WD

BASE = dict(vocab_size=97, hidden_size=64, num_layers=2, num_heads=4,
            num_kv_heads=2, ffn_size=128, block_size=8, num_blocks=48,
            max_batch=3, max_blocks_per_seq=6, token_budget=32)
MODES = ("int8", "int8-noprefetch", "int4")


@pytest.fixture(autouse=True)
def _one_thread():
    # one PyTorch thread while the test runs (see test_torch_serving.py)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bits(t):
    t = t.contiguous()
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _weights(shape, seed):
    """f32 weights from numpy, cast to bf16 by both frameworks."""
    w = np.random.RandomState(seed).randn(*shape).astype(np.float32) * 0.05
    w[:, 3] = 0                           # a zero column: scale 1.0
    return (jnp.asarray(w).astype(jnp.bfloat16),
            torch.from_numpy(w).to(torch.bfloat16))


@pytest.mark.parametrize("shape", [(64, 128), (100, 64), (128, 200)])
def test_quantizers_match_reference_bit_for_bit(shape):
    jw, tw = _weights(shape, sum(shape))
    q, s = TW.quantize_per_channel(tw)
    jq, js = JW.quantize_per_channel(jw)
    assert q.dtype == np.int8 and s.dtype == np.float32
    np.testing.assert_array_equal(q, jq)
    np.testing.assert_array_equal(s.view(np.int32), js.view(np.int32))
    p, g = TW.quantize_int4_grouped(tw)
    jp, jg = JW.quantize_int4_grouped(jw)
    assert p.dtype == np.uint8 and p.shape == (-(-shape[0] // 32) * 16,
                                               shape[1])
    np.testing.assert_array_equal(p, jp)
    np.testing.assert_array_equal(g.view(np.int32), jg.view(np.int32))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", [(64, 128), (100, 64)])
def test_dequantize_matches_reference_bit_for_bit(shape, dtype):
    jw, tw = _weights(shape, 7 + shape[0])
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)
    q, s = TW.quantize_per_channel(tw)
    got = TW.dequantize(torch.from_numpy(q), torch.from_numpy(s), tdt)
    ref = np.asarray(JW.dequantize(q, s, jdt).astype(jnp.float32))
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.float().numpy(), ref)
    p, g = TW.quantize_int4_grouped(tw)
    got4 = TW.dequantize_int4(torch.from_numpy(p), torch.from_numpy(g), tdt,
                              shape[0])
    ref4 = np.asarray(JW.dequantize_int4(p, g, jdt, shape[0])
                      .astype(jnp.float32))
    assert tuple(got4.shape) == shape
    np.testing.assert_array_equal(got4.float().numpy(), ref4)
    # the kernel wrapper's CPU route writes the same bits into its outputs
    outs = [torch.empty(shape, dtype=tdt) for _ in range(2)]
    WD.weight_dequant([(torch.from_numpy(q), torch.from_numpy(s),
                        shape[0])], outs[:1])
    WD.weight_dequant([(torch.from_numpy(p), torch.from_numpy(g),
                        shape[0])], outs[1:])
    assert torch.equal(_bits(outs[0]), _bits(got))
    assert torch.equal(_bits(outs[1]), _bits(got4))


def test_dequant_wrapper_refuses_what_no_path_takes():
    q = torch.zeros(64, 32, dtype=torch.int8)
    s = torch.ones(32)
    out = torch.empty(64, 32)
    with pytest.raises(TypeError):                  # int16 codes
        WD.weight_dequant([(q.short(), s, 64)], [out])
    with pytest.raises(TypeError):                  # f16 output
        WD.weight_dequant([(q, s, 64)], [out.half()])
    with pytest.raises(ValueError):                 # output shape
        WD.weight_dequant([(q, s, 64)], [out[:32]])
    with pytest.raises(ValueError):                 # int4 rows for in 100
        WD.weight_dequant([(torch.zeros(48, 32, dtype=torch.uint8),
                            torch.ones(4, 32), 100)],
                          [torch.empty(100, 32)])
    with pytest.raises(ValueError):                 # five segments
        WD.weight_dequant([(q, s, 64)] * 5, [out] * 5)


class _Entries:
    """Stand-in for the kernel library's extension module."""

    def __init__(self):
        self.calls = []

    def weight_dequant(self, *args):
        self.calls.append(args)
        return 0


def test_dequant_launch_passes_one_descriptor(monkeypatch):
    """The CUDA route's argument list, driven with CPU tensors and a
    recorder for the library: mode, dtype, the count, each segment's
    pointers and sizes, the unused segments empty, the stream; one count a
    launch; and the kernel's refusals (width not a multiple of 8, an
    unaligned or strided output)."""
    entries = _Entries()
    monkeypatch.setattr(WD._build, "py_module", lambda: entries)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda device: 9, raising=False)
    p = torch.zeros(64, 48, dtype=torch.uint8)
    g = torch.ones(4, 48)
    q = torch.zeros(40, 16, dtype=torch.int8)
    s = torch.ones(16)
    o4 = torch.empty(100, 48, dtype=torch.bfloat16)
    o8 = torch.empty(40, 16, dtype=torch.bfloat16)
    before = WD.launches
    WD._launch([(p, g, 100)], [o4])
    assert WD.launches == before + 1
    (args,) = entries.calls
    assert args[:3] == (1, 1, 1)
    assert args[3:8] == (p.data_ptr(), g.data_ptr(), o4.data_ptr(), 100, 48)
    assert args[8:23] == (None, None, None, 0, 0) * 3 and args[23] == 9
    WD._launch([(q, s, 40), (q, s, 40)], [o8, torch.empty_like(o8)])
    assert entries.calls[-1][:3] == (0, 1, 2)
    with pytest.raises(ValueError):
        WD._launch([(torch.zeros(40, 12, dtype=torch.int8), torch.ones(12),
                     40)], [torch.empty(40, 12, dtype=torch.bfloat16)])
    wide = torch.empty(40, 24, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        WD._launch([(q, s, 40)], [wide[:, 8:]])
    flat = torch.empty(40 * 16 + 1, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        WD._launch([(q, s, 40)], [flat[1:].view(40, 16)])
    assert WD.launches == before + 2


@pytest.fixture(scope="module")
def pair():
    """One JAX model and the port's copy of its weights, per ffn size."""
    out = {}
    for ffn in (128, 100):
        paddle.seed(31 + ffn)
        jcfg = JS.PagedServingConfig(**{**BASE, "ffn_size": ffn})
        jm = JS.PagedCausalLM(jcfg)
        jm.eval()
        named = {k: np.asarray(v) for k, v in current_params(jm).items()}
        tcfg = TS.PagedServingConfig(**{**BASE, "ffn_size": ffn})
        tm = TS.PagedCausalLM(tcfg, device="cpu").load_paddle_tpu_params(
            named)
        out[ffn] = (jm, jcfg, tm, tcfg)
    return out


def _prompts(seed):
    rng = np.random.RandomState(seed)
    return [list(rng.randint(1, 97, n)) for n in (7, 12, 5)]


def _greedy(eng, prompts, n=6):
    rids = [eng.add_request(p, max_new_tokens=n) for p in prompts]
    res = eng.run_to_completion()
    return [res[r] for r in rids]


@pytest.mark.parametrize("mode,ffn", [("int8", 128), ("int8-noprefetch", 128),
                                      ("int4", 128), ("int4", 100)])
def test_streamed_engine_greedy_matches_jax(pair, mode, ffn):
    jm, jcfg, tm, tcfg = pair[ffn]
    prompts = _prompts(3)
    jm._serving_shared = None
    ref = _greedy(JS.ServingEngine.from_model(jm, jcfg, weight_stream=mode),
                  prompts)
    eng = TS.ServingEngine.from_model(tm, tcfg, device="cpu",
                                      weight_stream=mode)
    assert eng._weight_stream_mode == mode
    assert _greedy(eng, prompts) == ref


def _dequantized_model(tm, tcfg, mode):
    """A plain port model whose streamed weights hold the dequantized
    values (f32: exact)."""
    import copy

    ref = copy.deepcopy(tm)
    with torch.no_grad():
        for kind in TW.STREAM_KINDS:
            for lin in getattr(ref, kind):
                w = lin.weight
                if mode == "int4":
                    p, g = TW.quantize_int4_grouped(w)
                    d = TW.dequantize_int4(torch.from_numpy(p),
                                           torch.from_numpy(g),
                                           torch.float32, w.shape[0])
                else:
                    q, s = TW.quantize_per_channel(w)
                    d = TW.dequantize(torch.from_numpy(q),
                                      torch.from_numpy(s), torch.float32)
                w.copy_(d)
    return ref


def _logit_trace(eng, prompts, sampling):
    """Every step's logits and the streams, sampled, on eng."""
    rids = [eng.add_request(p, max_new_tokens=5, sampling=sp)
            for p, sp in zip(prompts, sampling)]
    logits = []
    while eng.pending():
        eng.step()
        logits.append(eng.last_logits.clone())
    return logits, [list(eng._requests[r].generated) for r in rids]


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_streamed_engine_is_plain_engine_over_dequantized(pair, mode):
    """Bit for bit: prefetch and at-use dequant, and a plain engine over the
    dequantized weights, give the same logits at every step and the same
    sampled streams."""
    _, _, tm, tcfg = pair[100]
    prompts = _prompts(5)
    sampling = [TS.SamplingParams(0.9, 20, 0.9), None,
                TS.SamplingParams(1.0, 0, 0.95)]
    runs = [_logit_trace(TS.ServingEngine.from_model(
        tm, tcfg, device="cpu", weight_stream=ws), prompts, sampling)
        for ws in ((mode, "int8-noprefetch") if mode == "int8"
                   else (mode,))]
    plain = _logit_trace(TS.ServingEngine.from_model(
        _dequantized_model(tm, tcfg, mode), tcfg, device="cpu"), prompts,
        sampling)
    for logits, streams in runs:
        assert streams == plain[1]
        assert len(logits) == len(plain[0])
        assert all(torch.equal(a, b) for a, b in zip(logits, plain[0]))


def test_streamed_weights_leave_the_engine(pair):
    """The streamed Linears' full-precision weights are not held: the
    serving copy keeps 0-d placeholders in their place, and the flat set
    holds each once as a placeholder, then its codes and scales."""
    _, _, tm, tcfg = pair[128]
    eng = TS.ServingEngine.from_model(tm, tcfg, device="cpu",
                                      weight_stream="int4")
    served = eng._model
    names = eng._names
    for kind in TW.STREAM_KINDS:
        for li in range(tcfg.num_layers):
            assert getattr(served, kind)[li].weight.shape == ()
            assert eng._params[names.index(f"{kind}.{li}.weight")].shape \
                == ()
    L = tcfg.num_layers
    tail = eng._params[len(names):]
    assert len(tail) == 2 * 4 * L
    assert [t.dtype for t in tail] == [torch.uint8, torch.float32] * 4 * L
    assert tuple(tail[0].shape) == (32, 64 + 2 * 32)      # qkv.0, packed
    assert eng._streamer.quantized_bytes() == sum(
        t.numel() * t.element_size() for t in tail)
    dense = sum(p.numel() for n, p in tm.named_parameters()
                if n.split(".")[0] in TW.STREAM_KINDS)
    assert sum(t.numel() for t in eng._params[:len(names)]) \
        == sum(p.numel() for p in tm.parameters()) - dense + 4 * L


def test_from_model_refuses_an_unknown_mode(pair):
    _, _, tm, tcfg = pair[128]
    with pytest.raises(ValueError, match="weight_stream"):
        TS.ServingEngine.from_model(tm, tcfg, device="cpu",
                                    weight_stream="int2")
    with pytest.raises(ValueError):
        TW.WeightStreamer(2, torch.float32, mode="fp8")


def test_decode_run_streams_match_steps(pair):
    """decode_run's window body (run eagerly on the CPU) over streamed
    weights gives the step() engine's greedy streams."""
    _, _, tm, tcfg = pair[128]
    prompts = _prompts(8)
    ref = _greedy(TS.ServingEngine.from_model(
        tm, tcfg, device="cpu", weight_stream="int8"), prompts)
    eng = TS.ServingEngine.from_model(tm, tcfg, device="cpu",
                                      weight_stream="int8")
    rids = [eng.add_request(p, max_new_tokens=6) for p in prompts]
    while any(r.length - r.cached > 1 for r in eng.pending()):
        eng.step()
    while eng.pending():
        assert eng.decode_run(4)
    assert [list(eng._requests[r].generated) for r in rids] == ref


def test_measure_stream_win_is_signed():
    win, t_s, t_b = TW.measure_stream_win(
        lambda: time.sleep(0.001), lambda: time.sleep(0.004), repeats=2,
        sync=lambda _: None)
    assert win > 0 and 0 < t_s < t_b
    win, _, _ = TW.measure_stream_win(
        lambda: time.sleep(0.004), lambda: time.sleep(0.001), repeats=2,
        sync=lambda _: None)
    assert win < 0
