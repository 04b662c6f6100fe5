"""The port's speculative decoding (paddle_tpu_torch.inference.speculative
and ServingEngine.set_drafter / _spec_step) against the JAX reference, on
the CPU in f32.

- NGramDrafter proposes what the JAX drafter proposes over the same
  observe history, its block table (keyed by the prefix cache's chained
  digests) included.
- Speculative greedy streams equal the port's plain streams, the dense
  path's and the JAX speculative engine's, token for token; sampled
  streams equal the port's plain sampled streams (the port's Gumbel noise
  is a hash, not JAX's threefry, so sampled tokens are not expected to
  equal the JAX engine's; each verify position is sampled under the salt
  the plain path uses there, across the 31-bit wrap too).
- Rows at different depths speculate together, and pages holding only
  rejected positions roll back to the pool (the counterpart of
  tests/test_speculative.py::test_spec_mixed_batch_and_page_rollback),
  over full-precision and int8 pools and beside the prefix cache.
- set_drafter's validation, from_env, and DraftModelDrafter end to end.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import serving as JS
from paddle_tpu.inference import speculative as JSP
from paddle_tpu.jit.functional import current_params

from paddle_tpu_torch.inference import serving as TS
from paddle_tpu_torch.inference import speculative as TSP

BASE = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=4,
            num_kv_heads=2, ffn_size=64, block_size=8, num_blocks=48,
            max_batch=3, max_blocks_per_seq=6, token_budget=32)


@pytest.fixture(autouse=True)
def _one_thread():
    # one PyTorch thread while the test runs, restored after: in a fresh
    # process with two or more threads, the first float exp after MKL's
    # first GEMM sometimes computes one thread's share with a low-accuracy
    # exp (relative error up to 1.5e-4); see test_torch_varlen_attention.py
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def models():
    paddle.seed(3)
    jm = JS.PagedCausalLM(JS.PagedServingConfig(**BASE))
    jm.eval()
    named = {k: np.asarray(v) for k, v in current_params(jm).items()}
    tm = TS.PagedCausalLM(TS.PagedServingConfig(**BASE),
                          device="cpu").load_paddle_tpu_params(named)
    return jm, tm


def _engine(tm, seed=0, **over):
    return TS.ServingEngine.from_model(
        tm, TS.PagedServingConfig(**{**BASE, **over}), seed=seed,
        device="cpu")


def _run(eng, prompts, max_new=8, sampling=None):
    rids = [eng.add_request(p, max_new_tokens=max_new, sampling=sampling)
            for p in prompts]
    out = eng.run_to_completion()
    return [out[r] for r in rids]


def _dense_greedy(tm, prompt, n):
    ids = list(prompt)
    with torch.inference_mode():
        for _ in range(n):
            lg = tm.forward_dense(torch.tensor([ids]))
            ids.append(int(lg[0, -1].argmax()))
    return ids[len(prompt):]


def _taught(drafter_cls, tm, prompts, max_new=8):
    d = drafter_cls(block_size=BASE["block_size"])
    for p in prompts:
        d.observe(list(p) + _dense_greedy(tm, p, max_new))
    return d


def test_ngram_drafter_matches_jax():
    rng = np.random.RandomState(7)
    seg = list(rng.randint(1, 30, 11))
    streams = [seg * 3 + list(rng.randint(1, 30, 5)),
               list(rng.randint(1, 30, 40)), list(range(1, 17)) * 2]
    drafters = [JSP.NGramDrafter(n=3, block_size=4),
                TSP.NGramDrafter(n=3, block_size=4),
                JSP.NGramDrafter(n=2), TSP.NGramDrafter(n=2)]
    for d in drafters:
        for s in streams:
            d.observe(s[:20])
            d.observe(s, start=20)
    queries = [s[:n] for s in streams for n in (4, 8, 9, 12, 17, 20, 33)]
    queries += [[90, 91], [], seg[:3]]
    for jd, td in zip(drafters[::2], drafters[1::2]):
        assert td._gram == jd._gram
        assert td._blocks == jd._blocks
        for q in queries:
            for k in (1, 4, 6):
                assert td.propose(q, k) == jd.propose(q, k), (q, k)
    # a whole remembered block on a block boundary
    assert drafters[1].propose(list(range(1, 17)) * 2, 4) == [1, 2, 3, 4]


def test_spec_greedy_matches_plain_dense_and_jax(models):
    jm, tm = models
    rng = np.random.RandomState(40)
    prompts = [list(rng.randint(1, 97, n)) for n in (9, 5, 12)]
    ref = _run(_engine(tm), prompts)
    assert ref == [_dense_greedy(tm, p, 8) for p in prompts]
    eng = _engine(tm)
    eng.set_drafter(_taught(TSP.NGramDrafter, tm, prompts), k=4)
    assert _run(eng, prompts) == ref
    st = eng.spec_stats()
    assert st["steps"] > 0 and st["accept_rate"] > 0.5
    assert st["tokens_per_row_step"] > 1.0
    # the JAX speculative engine over the same weights
    jm._serving_shared = None
    jeng = JS.ServingEngine.from_model(jm, JS.PagedServingConfig(**BASE))
    jeng.set_drafter(_taught(JSP.NGramDrafter, tm, prompts), k=4)
    assert _run(jeng, prompts) == ref
    assert len(eng._free_pages) == BASE["num_blocks"] - 1


@pytest.mark.parametrize("sp", [
    TS.SamplingParams(temperature=0.8, top_k=20, top_p=0.95),
    TS.SamplingParams(temperature=1.1, top_k=0, top_p=0.9)])
def test_spec_sampled_matches_plain(models, sp):
    _, tm = models
    rng = np.random.RandomState(41)
    prompts = [list(rng.randint(1, 97, n)) for n in (7, 10)]
    # request 0's salts cross the 31-bit wrap inside a verify step
    inv = pow(1000003, -1, 1 << 31)
    seed = (((1 << 31) - 3) * inv) % (1 << 31)
    assert TS.sampling_salt(seed, 0, 3) == 0
    ref = _run(_engine(tm, seed=seed), prompts, max_new=12, sampling=sp)
    eng = _engine(tm, seed=seed)
    d = TSP.NGramDrafter(block_size=BASE["block_size"])
    for p, toks in zip(prompts, ref):
        d.observe(list(p) + toks)
    eng.set_drafter(d, k=4)
    assert _run(eng, prompts, max_new=12, sampling=sp) == ref
    assert eng.spec_stats()["accepted"] > 0


@pytest.mark.parametrize("over", [{}, {"cache_quant": "int8"},
                                  {"prefix_cache": True}])
def test_spec_mixed_batch_and_page_rollback(models, over):
    """An adversarial drafter (a good prefix, then garbage) forces
    rejections mid-proposal and page rollback on most steps."""
    _, tm = models
    rng = np.random.RandomState(44)
    prompts = [list(rng.randint(1, 97, n)) for n in (4, 15, 9)]
    ref = _run(_engine(tm, **over), prompts, max_new=10)
    eng = _engine(tm, **over)
    free0 = len(eng._free_pages)
    taught = _taught(TSP.NGramDrafter, tm, prompts, max_new=10)

    class Tailed(TSP.Drafter):
        def propose(self, tokens, k):
            good = taught.propose(tokens, max(k - 2, 1))
            return (good + [1, 2])[:k]

        def observe(self, tokens, start=0):
            taught.observe(tokens, start=start)

    eng.set_drafter(Tailed(), k=4)
    assert _run(eng, prompts, max_new=10) == ref
    st = eng.spec_stats()
    assert 0 < st["accepted"] < st["drafted"]
    cache = eng._prefix_cache
    owned = list(cache.owned_pages()) if cache is not None else []
    assert sorted(eng._free_pages + owned) == list(
        range(1, BASE["num_blocks"]))
    assert len(eng._free_pages) + len(owned) == free0
    if cache is not None:
        assert all(n.refs == 0 for n in cache._nodes.values())


def test_spec_after_decode_windows_and_alien_drafts(models):
    """Verify steps and decode_run windows share one engine; drafts outside
    the vocabulary stop a proposal; a mute drafter degrades to plain
    steps."""
    _, tm = models
    rng = np.random.RandomState(45)
    prompts = [list(rng.randint(1, 97, n)) for n in (6, 13)]
    ref = _run(_engine(tm), prompts, max_new=14)

    class Alien(TSP.Drafter):
        def propose(self, tokens, k):
            return [500] * k

    class Mute(TSP.Drafter):
        def propose(self, tokens, k):
            return []

    for drafter in (Alien(), Mute()):
        eng = _engine(tm)
        rids = [eng.add_request(p, max_new_tokens=14) for p in prompts]
        while any(r.length - r.cached > 1 for r in eng.pending()):
            eng.step()
        eng.decode_run(4)
        eng.set_drafter(drafter, k=3)
        out = eng.run_to_completion()
        assert [out[r] for r in rids] == ref
        assert eng.spec_stats()["drafted"] == 0
    eng = _engine(tm)
    rids = [eng.add_request(p, max_new_tokens=14) for p in prompts]
    eng.set_drafter(_taught(TSP.NGramDrafter, tm, prompts, 14), k=4)
    eng.step()
    eng.step()
    eng.set_drafter(None)                     # windows again
    while eng.pending():
        assert eng.decode_run(4) or eng.step()
    assert [list(eng._requests[r].generated) for r in rids] == ref


def test_set_drafter_validation(models, monkeypatch):
    _, tm = models
    eng = _engine(tm)
    with pytest.raises(ValueError):
        eng.set_drafter(TSP.NGramDrafter(), k=0)
    eng.set_drafter(TSP.NGramDrafter(), k=2)
    assert eng._spec_k == 2
    eng.set_drafter(None)                     # off again
    assert eng._drafter is None
    bare = TS.ServingEngine(cfg=TS.PagedServingConfig(**BASE), device="cpu")
    with pytest.raises(ValueError):
        bare.set_drafter(TSP.NGramDrafter(), k=2)
    monkeypatch.setenv("PT_SPEC_K", "5")
    e2 = _engine(tm)
    e2.set_drafter(TSP.NGramDrafter())
    assert e2._spec_k == 5
    with pytest.raises(ValueError):
        TSP.NGramDrafter(n=0)
    monkeypatch.setenv("PT_SPEC_DRAFTER", "off")
    assert TSP.from_env(_engine(tm)) is None
    monkeypatch.setenv("PT_SPEC_DRAFTER", "ngram")
    monkeypatch.setenv("PT_SPEC_K", "3")
    e3 = _engine(tm)
    d = TSP.from_env(e3)
    assert isinstance(d, TSP.NGramDrafter) and e3._spec_k == 3
    assert d.block_size == BASE["block_size"]
    monkeypatch.setenv("PT_SPEC_DRAFTER", "bogus")
    with pytest.raises(ValueError):
        TSP.from_env(_engine(tm))


def test_draft_model_drafter_end_to_end(models):
    """Self-draft (draft model == target) accepts every greedy draft;
    refresh installs new draft weights in place."""
    jm, tm = models
    prompt = [5, 9, 3, 7, 1]
    d = TSP.DraftModelDrafter(tm)
    assert d.propose(prompt, 3) == _dense_greedy(tm, prompt, 3)
    assert d.propose(prompt, 3) == JSP.DraftModelDrafter(jm).propose(
        prompt, 3)
    assert d.propose([96, 200], 2) == []      # outside the draft vocab
    rng = np.random.RandomState(43)
    prompts = [list(rng.randint(1, 97, 6))]
    ref = _run(_engine(tm), prompts)
    eng = _engine(tm)
    eng.set_drafter(d, k=3)
    assert _run(eng, prompts) == ref
    assert eng.spec_stats()["accept_rate"] == 1.0
    draft = TS.PagedCausalLM(TS.PagedServingConfig(**BASE), device="cpu",
                             seed=1)
    dd = TSP.DraftModelDrafter(draft)
    dd.refresh({k: v.detach().clone() for k, v in tm.named_parameters()})
    assert dd.propose(prompt, 3) == _dense_greedy(tm, prompt, 3)
    with pytest.raises(KeyError):
        dd.refresh({"nope": torch.zeros(1)})
