"""Per-request deadlines and the backend handle of the port's serving
engine against the JAX package's (paddle_tpu/inference/serving.py:547-570,
:845-874, :966-1001; :106-123), on the CPU in f32.

Both engines (from_model over the same weights, as in
test_torch_serving.py) run under one patched ``time.perf_counter``, so the
deadlines expire at the same step in both. Eviction must match: the same
``timed_out_requests``, the same ``_requeue_info`` keys and values (the
sampling parameters compared by value; ``trace`` is the reference's
tracing context, None in the port until tracing is ported), every page
back in the pool, and the surviving greedy streams equal token for token.
"""
import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import serving as JS
from paddle_tpu.jit.functional import current_params

from paddle_tpu_torch.inference import serving as TS

_CFG = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=4,
            ffn_size=64, block_size=8, num_blocks=32, max_batch=3,
            max_blocks_per_seq=6, token_budget=32)


@pytest.fixture(autouse=True)
def _one_thread():
    # one PyTorch thread while the test runs, restored after (see
    # test_torch_serving.py: the first float exp after MKL's first GEMM)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def models():
    paddle.seed(5)
    jcfg = JS.PagedServingConfig(**_CFG)
    jm = JS.PagedCausalLM(jcfg)
    jm.eval()
    named = {k: np.asarray(v) for k, v in current_params(jm).items()}
    tcfg = TS.PagedServingConfig(**_CFG)
    tm = TS.PagedCausalLM(tcfg, device="cpu").load_paddle_tpu_params(named)
    return jm, jcfg, tm, tcfg


@pytest.fixture
def clock(monkeypatch):
    """One clock for both engines: ``time.perf_counter`` frozen at
    ``now[0]``, moved by the test."""
    now = [1000.0]
    monkeypatch.setattr(time, "perf_counter", lambda: now[0])
    return now


def _engines(models):
    jm, jcfg, tm, tcfg = models
    return (JS.ServingEngine.from_model(jm, jcfg),
            TS.ServingEngine.from_model(tm, tcfg, device="cpu"))


def _prompts(seed, lens):
    rng = np.random.RandomState(seed)
    return [list(rng.randint(1, _CFG["vocab_size"], n)) for n in lens]


def _info(d):
    out = dict(d)
    out.pop("trace")
    sp = out.pop("sampling")
    out["sampling"] = (sp.temperature, sp.top_k, sp.top_p)
    return out


def _pages_in_use(eng):
    return _CFG["num_blocks"] - 1 - len(eng._free_pages)


def test_deadline_eviction_matches_reference(models, clock):
    """Three requests: one expires after the first step, one carries a
    deadline that never comes, one none. The expired one is evicted before
    the next step's scheduling in both engines, alike; the others finish
    with equal streams."""
    prompts = _prompts(0, (5, 9, 7))
    sp = [None, JS.SamplingParams(temperature=0.7, top_k=5), None]
    tsp = [None, TS.SamplingParams(temperature=0.7, top_k=5), None]
    runs = []
    for eng, samp in zip(_engines(models), (sp, tsp)):
        seen = []
        eng.requeue_hook = seen.append
        rids = [eng.add_request(prompts[0], max_new_tokens=6,
                                deadline_s=5.0),
                eng.add_request(prompts[1], max_new_tokens=4,
                                sampling=samp[1], deadline_s=1e6),
                eng.add_request(prompts[2], max_new_tokens=5)]
        eng.step()
        held = len(eng._requests[rids[0]].pages)
        clock[0] += 10.0
        in_use = _pages_in_use(eng)
        eng.step()
        r0 = eng._requests[rids[0]]
        assert r0.timed_out and r0.done and r0.pages == [] and held > 0
        assert eng.timed_out_requests() == [rids[0]]
        outs = eng.run_to_completion()
        runs.append(dict(rids=rids, seen=[_info(d) for d in seen],
                         outs=outs, in_use=in_use, held=held,
                         pages=_pages_in_use(eng)))
    j, t = runs
    assert t["rids"] == j["rids"]
    assert t["seen"] == j["seen"] and len(t["seen"]) == 1
    assert t["seen"][0]["rid"] == t["rids"][0]
    assert t["seen"][0]["timed_out"] is True
    assert t["outs"][t["rids"][0]] == j["outs"][j["rids"][0]]
    assert t["outs"][t["rids"][2]] == j["outs"][j["rids"][2]]
    assert len(t["outs"][t["rids"][1]]) == 4          # kept to the end
    assert (t["in_use"], t["held"]) == (j["in_use"], j["held"])
    assert t["pages"] == j["pages"] == 0


def test_zero_deadline_evicted_at_next_step(models, clock):
    """deadline_s=0: evicted at the next step, before it is ever
    scheduled; its pages (none yet) stay in the pool and the hook gets its
    info; nothing else is served in its place."""
    prompts = _prompts(1, (6,))
    for eng in _engines(models):
        seen = []
        eng.requeue_hook = seen.append
        rid = eng.add_request(prompts[0], max_new_tokens=3, deadline_s=0)
        clock[0] += 1e-3
        assert eng.step() == []
        assert eng.timed_out_requests() == [rid]
        assert [d["rid"] for d in seen] == [rid]
        assert seen[0]["generated"] == [] and seen[0]["max_new"] == 3
        assert _pages_in_use(eng) == 0
        assert eng.pending() == []


def test_eviction_before_a_decode_run_window(models, clock):
    """Two rows at their decode tip, one past its deadline when the
    window starts: it is evicted first, its pages back, and only the other
    decodes; the window's tokens equal the reference's."""
    prompts = _prompts(2, (6, 10))
    runs = []
    for eng in _engines(models):
        rids = [eng.add_request(prompts[0], max_new_tokens=8,
                                deadline_s=2.0),
                eng.add_request(prompts[1], max_new_tokens=8)]
        eng.step()
        clock[0] += 3.0
        produced = eng.decode_run(4)
        assert {r for r, _ in produced} == {rids[1]}
        assert eng.timed_out_requests() == [rids[0]]
        assert eng._requests[rids[0]].pages == []
        runs.append((produced, _pages_in_use(eng),
                     list(eng._requests[rids[0]].generated)))
    assert runs[1] == runs[0]


def test_unexpired_deadline_changes_nothing(models, clock):
    (p,) = _prompts(3, (8,))
    t = _engines(models)[1]
    a = t.add_request(p, max_new_tokens=6, deadline_s=30.0)
    b = t.add_request(p, max_new_tokens=6)
    clock[0] += 29.0
    outs = t.run_to_completion()
    assert outs[a] == outs[b] and len(outs[a]) == 6
    assert t.timed_out_requests() == []


def test_backend_handle_resolution(models):
    """device= wins, then cfg.backend, then resolve_device(None) ("cuda");
    a CUDA handle with no card behind it raises, as the reference raises
    for a platform with no devices; the handle joins from_model's share
    key."""
    _, _, tm, _ = models
    assert TS.resolve_backend_device(None) is None
    assert TS.resolve_backend_device("cpu") == torch.device("cpu")
    assert TS.resolve_backend_device(torch.device("cpu")) \
        == torch.device("cpu")
    assert JS.resolve_backend_device(None) is None
    assert JS.resolve_backend_device("cpu").platform == "cpu"
    on_cpu = TS.PagedServingConfig(**_CFG, backend="cpu")
    assert TS.ServingEngine(cfg=on_cpu).device == torch.device("cpu")
    on_cuda = TS.PagedServingConfig(**_CFG, backend="cuda")
    assert TS.ServingEngine(cfg=on_cuda, device="cpu").device \
        == torch.device("cpu")
    with pytest.raises(ValueError):
        TS.resolve_backend_device("meta")
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="no devices"):
            TS.ServingEngine(cfg=on_cuda)
        with pytest.raises(RuntimeError, match="CUDA"):
            TS.ServingEngine(cfg=TS.PagedServingConfig(**_CFG))
    plain = TS.PagedServingConfig(**_CFG)
    a = TS.ServingEngine.from_model(tm, plain, device="cpu")
    b = TS.ServingEngine.from_model(tm, on_cpu)
    c = TS.ServingEngine.from_model(tm, on_cpu)
    assert a.device == b.device == torch.device("cpu")
    assert b._params[0] is c._params[0]
    assert a._params[0] is not b._params[0]
