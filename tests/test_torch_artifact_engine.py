"""The port's artifact engine (save_paged_model + ServingEngine(path_prefix,
cfg)) against the JAX package's (tests/test_serving_engine.py), on the CPU
in f32.

One JAX PagedCausalLM (vocab 97, hidden 32, 2 layers, 4 heads of 8, the
reference test's config) is built from a seed; its weights go into the
port's model (load_paddle_tpu_params). Each package saves its artifact and
serves it. Greedy streams must agree token for token: both artifacts run
every step at the fixed token length on the paged route in f32, and the
logits differ only by sums taken in other orders (~1e-6), far below these
streams' top-1 margins. The port's from_model engine (whose fresh-prefill
steps take the varlen route) must give the same streams. Sampled streams
are held to the port's own step loop: the port's Gumbel noise is a hash, not
JAX's threefry.
"""
import collections

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import serving as JS
from paddle_tpu.jit.functional import current_params

from paddle_tpu_torch.inference import serving as TS
from paddle_tpu_torch.inference import load_inference_model
from paddle_tpu_torch.inference.weight_publish import build_weight_set

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


def _port_model(jm, cfg, seed=0):
    named = {k: np.asarray(v) for k, v in current_params(jm).items()}
    return TS.PagedCausalLM(cfg, device="cpu", seed=seed) \
        .load_paddle_tpu_params(named)


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    d = tmp_path_factory.mktemp("paged")
    paddle.seed(42)
    jcfg = JS.PagedServingConfig(**_CFG)
    jm = JS.PagedCausalLM(jcfg)
    jm.eval()
    tcfg = TS.PagedServingConfig(**_CFG)
    tm = _port_model(jm, tcfg)
    jpath, tpath = str(d / "jax_lm"), str(d / "torch_lm")
    JS.save_paged_model(jpath, jm)
    TS.save_paged_model(tpath, tm)
    return jpath, jcfg, tpath, tcfg, tm


def _engines(artifacts, seed=0):
    jpath, jcfg, tpath, tcfg, _ = artifacts
    return (JS.ServingEngine(jpath, jcfg, seed=seed),
            TS.ServingEngine(tpath, tcfg, device="cpu", seed=seed))


def _prompts(seed, lens):
    rng = np.random.RandomState(seed)
    return [list(rng.randint(1, _CFG["vocab_size"], n)) for n in lens]


def test_concurrent_requests_match_jax_artifact_engine(artifacts):
    """Three requests, the third joining mid-flight: the port's artifact
    engine, the JAX artifact engine and the port's from_model engine give
    the same greedy streams."""
    prompts = _prompts(0, (5, 9, 3))
    tm, tcfg = artifacts[4], artifacts[3]
    engines = _engines(artifacts) + (
        TS.ServingEngine.from_model(tm, tcfg, device="cpu"),)
    outs = []
    for eng in engines:
        r0 = eng.add_request(prompts[0], max_new_tokens=6)
        r1 = eng.add_request(prompts[1], max_new_tokens=4)
        eng.step()
        eng.step()
        r2 = eng.add_request(prompts[2], max_new_tokens=5)
        res = eng.run_to_completion()
        outs.append([res[r] for r in (r0, r1, r2)])
    assert [len(o) for o in outs[0]] == [6, 4, 5]
    assert outs[1] == outs[0], (outs[1], outs[0])
    assert outs[2] == outs[0], (outs[2], outs[0])


def test_decode_run_on_artifact_engine(artifacts):
    """decode_run windows at the artifact's fixed token length give the
    step loop's tokens (sampled included), and the greedy row's tokens
    equal the JAX artifact engine's decode_run."""
    prompts = _prompts(9, (6, 11))
    sp = TS.SamplingParams(temperature=0.9, top_k=20, top_p=0.95)
    _, t1 = _engines(artifacts, seed=3)
    _, t2 = _engines(artifacts, seed=3)
    for e in (t1, t2):
        e.add_request(prompts[0], max_new_tokens=7, sampling=sp)
        e.add_request(prompts[1], max_new_tokens=7)            # greedy
    ref = t1.run_to_completion()
    t2.step()                    # prefill both + the first sampled token
    produced = []
    while t2.pending():
        got = t2.decode_run(16)
        assert got, "decode_run must make progress"
        produced += got
    assert len(produced) == 12
    assert {rid: list(r.generated) for rid, r in t2._requests.items()} \
        == ref
    assert all(w.tokens.numel() == _CFG["token_budget"]
               for w in t2._window_fns.values())

    j, t = _engines(artifacts, seed=3)
    for e in (j, t):
        e.add_request(prompts[1], max_new_tokens=7)
        e.step()
        while e.pending():
            e.decode_run(4)
    assert [r.generated for r in t._requests.values()] \
        == [r.generated for r in j._requests.values()]


def test_pages_recycled_across_many_requests(artifacts):
    j, t = _engines(artifacts)
    free0 = len(t._free_pages)
    rng = np.random.RandomState(1)
    for wave in range(4):
        prompts = [list(rng.randint(1, _CFG["vocab_size"], 6))
                   for _ in range(3)]
        outs = []
        for eng in (j, t):
            rids = [eng.add_request(p, max_new_tokens=3) for p in prompts]
            res = eng.run_to_completion()
            outs.append([res[r] for r in rids])
        assert all(len(o) == 3 for o in outs[1])
        assert outs[1] == outs[0]
    assert len(t._free_pages) == free0 == len(j._free_pages)


def test_chunked_prefill_beyond_token_budget(artifacts):
    j, t = _engines(artifacts)
    n = _CFG["token_budget"] + _CFG["token_budget"] // 4
    (prompt,) = _prompts(7, (n,))
    outs = []
    for eng in (j, t):
        rid = eng.add_request(prompt, max_new_tokens=4)
        assert eng.step() == []        # the first chunk only
        outs.append(eng.run_to_completion()[rid])
    assert outs[1] == outs[0]


def test_exported_graph_calls_the_registered_ops(artifacts):
    """The program reaches the kernels only through the three registered
    ops: RMSNorm 2L + 1 times, rope_append and paged attention L times
    each, nothing else of the port; it holds no weights."""
    program, params, buffers, sig = load_inference_model(artifacts[2],
                                                         "cpu")
    calls = collections.Counter(
        str(n.target) for n in program.graph.nodes
        if n.op == "call_function" and "paddle_tpu_torch" in str(n.target))
    L = _CFG["num_layers"]
    assert calls == {"paddle_tpu_torch.rms_norm.default": 2 * L + 1,
                     "paddle_tpu_torch.rope_append.default": L,
                     "paddle_tpu_torch.paged_attention.default": L}
    assert not any(n.op == "get_attr" for n in program.graph.nodes)
    assert len(params) == len(dict(artifacts[4].named_parameters()))
    assert buffers == []
    assert sig["output_names"] == ["logits", "key_caches", "value_caches"]


def test_set_drafter_raises_on_artifact_engine(artifacts):
    from paddle_tpu.inference.speculative import NGramDrafter as JDrafter
    from paddle_tpu_torch.inference.speculative import NGramDrafter

    j, t = _engines(artifacts)
    with pytest.raises(ValueError, match="verify"):
        j.set_drafter(JDrafter(), k=2)
    with pytest.raises(ValueError, match="verify"):
        t.set_drafter(NGramDrafter(), k=2)
    with pytest.raises(ValueError, match="fresh-prefill"):
        t.probe_logits([1, 2, 3])


def test_int8_save_paged_model_raises(artifacts, tmp_path):
    cfg = TS.PagedServingConfig(**_CFG, cache_quant="int8")
    model = TS.PagedCausalLM(cfg, device="cpu")
    with pytest.raises(ValueError, match="scale pools"):
        TS.save_paged_model(str(tmp_path / "q8"), model)
    with pytest.raises(ValueError, match="scale pools"):
        TS.ServingEngine(artifacts[2], cfg, device="cpu")


def test_artifact_refuses_another_config(artifacts):
    other = TS.PagedServingConfig(**dict(_CFG, token_budget=16))
    with pytest.raises(ValueError, match="shapes"):
        TS.ServingEngine(artifacts[2], other, device="cpu")


def test_weight_versions_feed_the_artifact(artifacts, tmp_path):
    """A version staged and committed on an artifact engine feeds its
    program: new requests get the streams of an artifact saved from the
    new weights, streams admitted before finish under theirs, and a
    rollback restores the first version's streams."""
    _, _, tpath, tcfg, tm = artifacts
    paddle.seed(7)
    jm2 = JS.PagedCausalLM(JS.PagedServingConfig(**_CFG))
    tm2 = _port_model(jm2, tcfg)
    path2 = str(tmp_path / "lm2")
    TS.save_paged_model(path2, tm2)
    (p,) = _prompts(11, (7,))

    def stream(path):
        eng = TS.ServingEngine(path, tcfg, device="cpu")
        rid = eng.add_request(p, max_new_tokens=5)
        return eng.run_to_completion()[rid]

    eng = TS.ServingEngine(tpath, tcfg, device="cpu")
    old = eng.add_request(p, max_new_tokens=5)
    eng.step()
    host, crcs = build_weight_set(tm2, None, tcfg)
    eng.stage_weight_set(1, host, crcs)
    assert eng.commit_weight_set(1) == 0
    new = eng.add_request(p, max_new_tokens=5)
    outs = eng.run_to_completion()
    assert outs[old] == stream(tpath)
    assert outs[new] == stream(path2)
    assert outs[old] != outs[new]
    assert eng.rollback_weight_set() == 0
    again = eng.add_request(p, max_new_tokens=5)
    assert eng.run_to_completion()[again] == outs[old]


def _op_calls(fn):
    """{registered op of the port: calls} a call of ``fn`` made through the
    dispatcher (torch.profiler's CPU events carry the op's name)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return collections.Counter(e.name for e in prof.events()
                               if e.name.startswith("paddle_tpu_torch::"))


def test_only_the_traced_program_calls_the_registered_ops(artifacts):
    """An eager step of a from_model engine reaches the kernels' wrappers
    directly (no dispatcher); the artifact engine's step goes through the
    three ops, 2L + 1, L and L times."""
    _, _, tpath, tcfg, tm = artifacts
    L = _CFG["num_layers"]
    live = TS.ServingEngine.from_model(tm, tcfg, device="cpu")
    art = TS.ServingEngine(tpath, tcfg, device="cpu")
    for eng in (live, art):
        eng.add_request([5, 6, 7, 8], max_new_tokens=3)
    assert _op_calls(live.step) == {}
    assert _op_calls(art.step) == {"paddle_tpu_torch::rms_norm": 2 * L + 1,
                                   "paddle_tpu_torch::rope_append": L,
                                   "paddle_tpu_torch::paged_attention": L}
