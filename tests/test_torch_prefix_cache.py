"""The port's prefix cache (paddle_tpu_torch.inference.prefix_cache and its
engine wiring) against the JAX reference, on the CPU in f32.

- One sequence of match / insert / release / evict / quota / probe calls
  gives the same pages, keys and counts in the port's PrefixCache as in
  the JAX one (the digests are the same bytes).
- Greedy streams of a prefix-cache engine equal the JAX prefix-cache
  engine's and the dense path's, token for token, over full-precision
  pools and int8 pools (a hit moves ``cached`` past the shared blocks, and
  the suffix runs as a chunked step over the cached pages, as in the
  reference).
- A snapshot saved by the JAX engine restores into the port (the on-disk
  format is the reference's) and serves hits with the same streams; the
  port's own snapshots round-trip and torn ones are swept.
- Every page comes back to the pool or the cache, with every refcount at
  0; eviction feeds step() and decode_run's reserve-ahead.

The JAX engines here run f32 models with the weights of the port's model
(load_paddle_tpu_params), so greedy streams must agree token for token.
"""
import os

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import prefix_cache as JP
from paddle_tpu.inference import serving as JS
from paddle_tpu.jit.functional import current_params

from paddle_tpu_torch.inference import prefix_cache as TP
from paddle_tpu_torch.inference import serving as TS

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


def _jax_engine(jm, **over):
    cfg = JS.PagedServingConfig(**{**BASE, **over})
    cached = getattr(jm, "_serving_shared", None)
    if cached is not None and cached[0][:2] != (cfg.dtype, cfg.cache_quant):
        jm._serving_shared = None
    return JS.ServingEngine.from_model(jm, cfg, seed=0)


def _engine(tm, **over):
    return TS.ServingEngine.from_model(
        tm, TS.PagedServingConfig(**{**BASE, **over}), device="cpu")


def _dense_greedy(tm, prompt, n):
    ids = list(prompt)
    with torch.inference_mode():
        for _ in range(n):
            lg = tm.forward_dense(torch.tensor([ids]))
            ids.append(int(lg[0, -1].argmax()))
    return ids[len(prompt):]


def _conserved(eng):
    """Every page is free or owned by the cache, once, and no cache node
    holds a ref."""
    cache = eng._prefix_cache
    owned = list(cache.owned_pages()) if cache is not None else []
    pages = sorted(eng._free_pages + owned)
    assert pages == list(range(1, eng.cfg.num_blocks))
    if cache is not None:
        assert all(n.refs == 0 for n in cache._nodes.values())


def test_prefix_cache_ops_match_jax():
    bs = 4
    rng = np.random.RandomState(9)
    caches = (JP.PrefixCache(bs, page_quota=6), TP.PrefixCache(bs,
                                                               page_quota=6))
    a = list(rng.randint(1, 50, 13))
    b = a[:8] + list(rng.randint(1, 50, 9))
    c = list(rng.randint(1, 50, 21))
    trace = []
    for cache in caches:
        out = []
        out.append(cache.insert(a, [10, 11, 12]))
        out.append(cache.match(a))                    # caps at len - 1
        out.append(cache.match(b))                    # diverges in block 2
        out.append(cache.probe(b))
        out.append(cache.insert(b, [10, 11, 20, 21]))
        out.append(cache.insert(c, [30, 31, 32, 33, 34]))   # quota stops it
        out.append(cache.insert(c, [40], namespace="t1"))
        out.append(cache.probe(c, namespace="t2"))
        out.append((cache.evictable_count(), cache.namespace_pages(None),
                    cache.namespace_pages("t1"), len(cache)))
        for keys in out[:8]:
            if isinstance(keys, tuple):
                cache.release(keys[1])
            elif isinstance(keys, list):
                cache.release(keys)
        out.append(cache.evictable_count())
        out.append(sorted(cache.evict(3)))
        cache.set_quota("t1", 0)
        out.append(cache.insert(c, [50], namespace="t1"))
        out.append(sorted(cache.evict(100)))
        out.append((len(cache), cache.hit_rate(), sorted(cache.owned_pages())))
        trace.append(out)
    assert trace[0] == trace[1]
    assert trace[1][1][2] == 12 and trace[1][2][2] == 8


@pytest.mark.parametrize("quant", [None, "int8"])
def test_prefix_engine_streams_match_jax(models, quant):
    jm, tm = models
    rng = np.random.RandomState(0)
    prefix = list(rng.randint(1, 97, 24))               # 3 full blocks
    prompts = [prefix + list(rng.randint(1, 97, n)) for n in (5, 3, 11)]

    def drive(eng):
        outs, cached = [], []
        for p in prompts:                 # one after another: warm hits
            rid = eng.add_request(p, max_new_tokens=5)
            cached.append(eng._requests[rid].cached)
            outs.append(eng.run_to_completion()[rid])
        return outs, cached

    ref, ref_cached = drive(_jax_engine(jm, prefix_cache=True,
                                        cache_quant=quant))
    eng = _engine(tm, prefix_cache=True, cache_quant=quant)
    got, cached = drive(eng)
    assert got == ref
    assert cached == ref_cached == [0, 24, 24]
    assert eng._prefix_cache.hit_rate() == pytest.approx(2 / 3)
    _conserved(eng)
    if quant is None:
        assert got == [_dense_greedy(tm, p, 5) for p in prompts]
        # the port's engine without the cache: the same streams
        assert drive(_engine(tm))[0] == got


def test_shared_pages_are_the_same_physical_pages(models):
    _, tm = models
    eng = _engine(tm, prefix_cache=True)
    rng = np.random.RandomState(1)
    prefix = list(rng.randint(1, 97, 16))               # 2 full blocks
    pa = prefix + list(rng.randint(1, 97, 6))
    pb = prefix + list(rng.randint(1, 97, 9))
    ra = eng.add_request(pa, max_new_tokens=3)
    eng.step()                                          # prefill a
    pages_a = list(eng._requests[ra].pages)
    rb = eng.add_request(pb, max_new_tokens=3)          # a still live
    reqb = eng._requests[rb]
    assert reqb.pages[:2] == pages_a[:2] and reqb.cached == 16
    eng.step()                                          # b's suffix, chunked
    assert reqb.pages[2:] and not set(reqb.pages[2:]) & set(pages_a)
    # both rows decode together through windows over the shared pages
    while eng.pending():
        assert eng.decode_run(4) or eng.step()
    out = {r: list(eng._requests[r].generated) for r in (ra, rb)}
    assert out[ra] == _dense_greedy(tm, pa, 3)
    assert out[rb] == _dense_greedy(tm, pb, 3)
    _conserved(eng)


def test_eviction_feeds_step_and_decode_run(models):
    """Zero-ref cached pages are reclaimed when the free pool runs dry:
    by step() (admission and prefill) and by decode_run's reserve-ahead,
    whose window counts the evictable pages."""
    _, tm = models
    eng = _engine(tm, prefix_cache=True, num_blocks=16)
    rng = np.random.RandomState(2)
    free0 = len(eng._free_pages)
    for _ in range(6):
        rid = eng.add_request(list(rng.randint(1, 97, 17)),
                              max_new_tokens=2)
        assert len(eng.run_to_completion()[rid]) == 2
    resident = len(eng._prefix_cache.owned_pages())
    assert resident and len(eng._free_pages) + resident == free0
    assert eng._prefix_cache.evictable_count() == resident
    # a burst needing more pages than the free pool
    prompts = [list(rng.randint(1, 97, 30)) for _ in range(3)]
    rids = [eng.add_request(p, max_new_tokens=2) for p in prompts]
    out = eng.run_to_completion()
    for rid, p in zip(rids, prompts):
        assert out[rid] == _dense_greedy(tm, p, 2)
    _conserved(eng)
    # decode_run: the free pool alone cannot hold the window, evictable
    # pages can
    rid = eng.add_request(list(rng.randint(1, 97, 7)), max_new_tokens=24)
    while eng._requests[rid].length - eng._requests[rid].cached > 1:
        eng.step()
    take = list(eng._free_pages)
    eng._free_pages.clear()                 # only evictable pages remain
    assert eng._prefix_cache.evictable_count() >= 3
    got = eng.decode_run(16)
    assert len(got) == 16
    eng._free_pages.extend(take)
    out = eng.run_to_completion()[rid]
    assert out == _dense_greedy(tm, eng._requests[rid].prompt, 24)
    _conserved(eng)


@pytest.mark.parametrize("quant", [None, "int8"])
def test_jax_snapshot_restores_into_port(models, tmp_path, quant):
    jm, tm = models
    rng = np.random.RandomState(41)
    shared = list(rng.randint(1, 90, 17))
    jeng = _jax_engine(jm, prefix_cache=True, cache_quant=quant,
                       prefix_snapshot_root=str(tmp_path))
    for tail in ([5, 6], [7, 8]):
        jeng.add_request(shared + tail, max_new_tokens=3)
    jeng.run_to_completion()
    path = jeng.save_prefix_cache()
    assert path and os.path.exists(os.path.join(path, "MANIFEST.json"))
    # a torn snapshot beside it (no manifest) is ignored and swept
    os.makedirs(tmp_path / "cache_00000099")
    eng = _engine(tm, prefix_cache=True, cache_quant=quant,
                  prefix_snapshot_root=str(tmp_path))
    assert len(eng._prefix_cache) == len(jeng._prefix_cache._nodes) == 2
    assert sorted(os.listdir(tmp_path)) == [os.path.basename(path)]
    # the restored pages hold the JAX engine's KV, and scales, exactly
    for jn, (key, node) in zip(
            (jeng._prefix_cache._nodes[k] for k in eng._prefix_cache._nodes),
            eng._prefix_cache._nodes.items()):
        names = ("_kc", "_vc") + (("_ks", "_vs") if quant else ())
        for name in names:
            np.testing.assert_array_equal(
                getattr(eng, name)[:, node.page].numpy(),
                np.asarray(getattr(jeng, name))[:, jn.page])
    prompt = shared + [9, 9]
    rid = eng.add_request(prompt, max_new_tokens=3)
    assert eng._requests[rid].cached == 16
    out = eng.run_to_completion()[rid]
    jrid = jeng.add_request(prompt, max_new_tokens=3)
    assert out == jeng.run_to_completion()[jrid]
    if quant is None:
        assert out == _dense_greedy(tm, prompt, 3)
    _conserved(eng)


def test_port_snapshot_round_trip(models, tmp_path):
    _, tm = models
    rng = np.random.RandomState(42)
    shared = list(rng.randint(1, 90, 25))
    eng = _engine(tm, prefix_cache=True, cache_quant="int8",
                  prefix_snapshot_root=str(tmp_path))
    for tail in ([5, 6], [7, 8, 9]):
        eng.add_request(shared + tail, max_new_tokens=3)
    eng.run_to_completion()
    first = eng.save_prefix_cache()
    second = eng.save_prefix_cache(keep=1)               # prunes the first
    assert not os.path.exists(first) and os.path.exists(second)
    assert TP.latest_snapshot(str(tmp_path))[1] == second
    e2 = _engine(tm, prefix_cache=True, cache_quant="int8")
    assert e2.restore_prefix_cache(str(tmp_path)) == 3
    rid = e2.add_request(shared + [1], max_new_tokens=4)
    assert e2._requests[rid].cached == 24
    cold = _engine(tm, cache_quant="int8", prefix_cache=True)
    cold.add_request(shared + [5, 6], max_new_tokens=1)
    cold.run_to_completion()                 # the same cached blocks, live
    rc = cold.add_request(shared + [1], max_new_tokens=4)
    assert e2.run_to_completion()[rid] == cold.run_to_completion()[rc]
    # an engine of another cache mode does not take the snapshot
    assert _engine(tm, prefix_cache=True).restore_prefix_cache(
        str(tmp_path)) == 0
    with pytest.raises(ValueError):
        _engine(tm, prefix_cache=True).save_prefix_cache()
    _conserved(e2)


def test_tenants_do_not_share_and_quota_caps_ownership(models):
    _, tm = models
    eng = _engine(tm, prefix_cache=True, prefix_page_quota=2)
    rng = np.random.RandomState(5)
    prompt = list(rng.randint(1, 97, 33))               # 4 full blocks
    for tenant in ("a", "a", "b"):
        rid = eng.add_request(prompt, max_new_tokens=2, tenant=tenant)
        hit = eng._requests[rid].cached
        eng.run_to_completion()
    assert hit == 0                          # tenant b: no cross-tenant hit
    cache = eng._prefix_cache
    assert cache.namespace_pages("a") == cache.namespace_pages("b") == 2
    assert cache.probe(prompt, namespace="a") == 16
    assert cache.probe(prompt, namespace="c") == 0
    _conserved(eng)
