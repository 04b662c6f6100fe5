"""The port's serving path (paddle_tpu_torch.inference.serving) against the
JAX reference (paddle_tpu.inference.serving), on the CPU in f32.

One JAX PagedCausalLM (GQA 2q/1kv, 2 layers, head_dim 64, vocab 256) is
built from a seed; its weights go through params_from_paddle_tpu into the
port. Logits must agree to 1e-4: both compute in f32, the sums run in
another order, and two layers of residual adds leave ~1e-6 absolute
differences on logits of magnitude ~1. Greedy streams must agree token for
token. Sampled streams are held against the port's own dense path: its
Gumbel noise is a hash, not JAX's threefry, so they are not expected to
equal the JAX engine's.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import serving as JS
from paddle_tpu.jit.functional import current_params

from paddle_tpu_torch.inference import serving as TS
from paddle_tpu_torch.utils import params_from_paddle_tpu

_CFG = dict(vocab_size=256, hidden_size=128, num_layers=2, num_heads=2,
            num_kv_heads=1, ffn_size=256, block_size=8, num_blocks=32,
            max_batch=3, max_blocks_per_seq=8, token_budget=32)
ATOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    # one PyTorch thread while the test runs, restored after: in a fresh
    # process with two or more threads, the first float exp after MKL's
    # first GEMM sometimes computes one thread's share with a low-accuracy
    # exp (relative error up to 1.5e-4), which moves the plain versions'
    # softmax and LSE past the tolerance; see test_torch_varlen_attention.py
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def models():
    paddle.seed(123)
    jcfg = JS.PagedServingConfig(**_CFG)
    jm = JS.PagedCausalLM(jcfg)
    jm.eval()
    named = {k: np.asarray(v) for k, v in current_params(jm).items()}
    tcfg = TS.PagedServingConfig(**_CFG)
    tm = TS.PagedCausalLM(tcfg, device="cpu").load_paddle_tpu_params(named)
    return jm, jcfg, tm, tcfg


def _jt(a):
    return paddle.to_tensor(np.asarray(a))


def _step_inputs(cfg, rows, n_total):
    """Packed step inputs for rows [(tokens, start_pos, pages)] padded to
    n_total tokens (the trash row takes the padding)."""
    B1 = cfg.max_batch + 1
    enc = np.zeros(B1, np.int64)
    dec = np.zeros(B1, np.int64)
    this = np.zeros(B1, np.int64)
    bt = np.zeros((B1, cfg.max_blocks_per_seq), np.int64)
    packed = []
    for i, (toks, start, pages) in enumerate(rows):
        dec[i] = start
        this[i] = len(toks)
        bt[i, :len(pages)] = pages
        packed.extend(toks)
    n_pad = n_total - len(packed)
    this[B1 - 1] = n_pad
    enc[B1 - 1] = n_pad
    cu = np.zeros(B1 + 1, np.int64)
    cu[1:] = np.cumsum(this)
    tokens = np.asarray(packed + [0] * n_pad, np.int64)
    return tokens, enc, dec, this, cu, bt


def _jax_step(jm, ins, kc, vc, fresh):
    object.__setattr__(jm, "_step_mode", "fresh_prefill" if fresh else None)
    try:
        out = jm(*[_jt(a) for a in ins], _jt(kc), _jt(vc))
    finally:
        object.__setattr__(jm, "_step_mode", None)
    return [np.asarray(o.numpy()) for o in out]


def _torch_step(tm, ins, kc, vc, fresh):
    kc_t, vc_t = torch.tensor(kc), torch.tensor(vc)
    with torch.inference_mode():
        logits, _, _ = tm(*[torch.tensor(a) for a in ins], kc_t, vc_t,
                          fresh_prefill=fresh)
    return logits.numpy(), kc_t.numpy(), vc_t.numpy()


def test_paged_step_logits_match_jax(models):
    """A fresh-prefill step of two rows, then a mixed decode + chunk step
    over the caches it wrote: live-row logits and both caches agree."""
    jm, jcfg, tm, tcfg = models
    rng = np.random.RandomState(0)
    shape = (tcfg.num_layers, tcfg.num_blocks, tcfg.num_kv_heads,
             tcfg.block_size, tcfg.head_dim)
    kc = np.zeros(shape, np.float32)
    vc = np.zeros(shape, np.float32)
    p0 = list(rng.randint(1, 256, 11))
    p1 = list(rng.randint(1, 256, 17))
    ins = _step_inputs(tcfg, [(p0, 0, [3, 4]), (p1, 0, [5, 6, 7])], 32)
    lj, kj, vj = _jax_step(jm, ins, kc, vc, True)
    lt, kt, vt = _torch_step(tm, ins, kc, vc, True)
    np.testing.assert_allclose(lt[:2], lj[:2], atol=ATOL, rtol=0)
    np.testing.assert_allclose(kt[:, 1:], kj[:, 1:], atol=1e-5, rtol=0)
    np.testing.assert_allclose(vt[:, 1:], vj[:, 1:], atol=1e-5, rtol=0)

    # row 0 decodes one token at position 11; row 1 appends a 6-token chunk
    ins = _step_inputs(tcfg, [([7], 11, [3, 4]),
                              (list(rng.randint(1, 256, 6)), 17,
                               [5, 6, 7])], 12)
    lj2, kj2, vj2 = _jax_step(jm, ins, kj, vj, False)
    lt2, kt2, vt2 = _torch_step(tm, ins, kj, vj, False)
    np.testing.assert_allclose(lt2[:2], lj2[:2], atol=ATOL, rtol=0)
    np.testing.assert_allclose(kt2[:, 1:], kj2[:, 1:], atol=1e-5, rtol=0)
    np.testing.assert_allclose(vt2[:, 1:], vj2[:, 1:], atol=1e-5, rtol=0)


def test_forward_dense_matches_jax(models):
    jm, _, tm, _ = models
    ids = np.random.RandomState(1).randint(1, 256, (1, 23))
    lj = jm.forward_dense(paddle.to_tensor(ids)).numpy()
    with torch.inference_mode():
        lt = tm.forward_dense(torch.tensor(ids)).numpy()
    np.testing.assert_allclose(lt, lj, atol=ATOL, rtol=0)


def _prompts(seed, lens):
    rng = np.random.RandomState(seed)
    return [list(rng.randint(1, 256, n)) for n in lens]


def _midflight(eng):
    p = _prompts(2, (5, 9, 3))
    a = eng.add_request(p[0], max_new_tokens=6)
    b = eng.add_request(p[1], max_new_tokens=4)
    eng.step()
    eng.step()
    c = eng.add_request(p[2], max_new_tokens=5)
    outs = eng.run_to_completion()
    return [outs[a], outs[b], outs[c]]


def _chunked(eng):
    (p,) = _prompts(3, (45,))          # 1.4x the token budget
    rid = eng.add_request(p, max_new_tokens=4)
    assert eng.step() == []            # first chunk only: nothing sampled
    return [eng.run_to_completion()[rid]]


def _preempt(eng):
    # 6 free pages of 8 slots; two requests each grow to 4 pages, so the
    # newest is preempted once the pool runs dry and re-prefills later
    eng._free_pages = eng._free_pages[:6]
    p = _prompts(4, (14, 15))
    rids = [eng.add_request(q, max_new_tokens=16) for q in p]
    outs = eng.run_to_completion()
    assert len(eng._free_pages) == 6
    return [outs[r] for r in rids]


@pytest.mark.parametrize("scenario", [_midflight, _chunked, _preempt],
                         ids=["midflight", "chunked_prefill", "preemption"])
def test_greedy_streams_match_jax_engine(models, scenario):
    jm, jcfg, tm, tcfg = models
    ref = scenario(JS.ServingEngine.from_model(jm, jcfg))
    got = scenario(TS.ServingEngine.from_model(tm, tcfg, device="cpu"))
    assert got == ref
    assert all(len(s) > 0 for s in got)


def test_preemption_scenario_preempts_newest(models):
    _, _, tm, tcfg = models
    eng = TS.ServingEngine.from_model(tm, tcfg, device="cpu")
    preempted = []
    release = eng._release

    def spy(req):
        if not req.done:
            preempted.append(req.rid)
        release(req)

    eng._release = spy
    _preempt(eng)
    assert preempted and set(preempted) == {1}


def test_decode_run_matches_stepwise_and_jax(models):
    jm, jcfg, tm, tcfg = models
    p = _prompts(5, (6, 11, 4))
    sp = TS.SamplingParams(temperature=0.9, top_k=20, top_p=0.95)

    def submit(eng, sampling):
        return [eng.add_request(q, max_new_tokens=7,
                                sampling=sampling if i == 0 else None)
                for i, q in enumerate(p)]

    ref_eng = TS.ServingEngine.from_model(tm, tcfg, seed=3, device="cpu")
    submit(ref_eng, sp)
    ref = ref_eng.run_to_completion()
    eng = TS.ServingEngine.from_model(tm, tcfg, seed=3, device="cpu")
    submit(eng, sp)
    eng.step()                     # prefill all + first token
    produced = []
    while eng.pending():           # tail windows round to powers of two
        got = eng.decode_run(4)
        assert got, "decode_run must make progress"
        produced += got
    assert len(produced) == 3 * 6
    assert {rid: list(r.generated) for rid, r in
            eng._requests.items()} == ref
    # the greedy rows equal the JAX engine's stepwise streams
    jeng = JS.ServingEngine.from_model(jm, jcfg, seed=3)
    jrids = [jeng.add_request(q, max_new_tokens=7) for q in p[1:]]
    jout = jeng.run_to_completion()
    assert [ref[1], ref[2]] == [jout[r] for r in jrids]


def test_sampled_streams_match_own_dense_path(models):
    _, _, tm, tcfg = models
    seed = 7
    sp = TS.SamplingParams(temperature=0.8, top_k=12, top_p=0.9)
    eng = TS.ServingEngine.from_model(tm, tcfg, seed=seed, device="cpu")
    prompts = _prompts(6, (9, 14, 5))
    rids = [eng.add_request(q, max_new_tokens=5, sampling=sp)
            for q in prompts]
    outs = eng.run_to_completion()
    for rid, prompt in zip(rids, prompts):
        ids = list(prompt)
        ref = []
        for i in range(5):
            with torch.inference_mode():
                logits = tm.forward_dense(torch.tensor([ids]))[0, -1]
            nxt = TS.sample_logits(logits, sp,
                                   TS.sampling_salt(seed, rid, i))
            assert nxt in torch.topk(logits, sp.top_k).indices.tolist()
            ref.append(nxt)
            ids.append(nxt)
        assert outs[rid] == ref, (rid, outs[rid], ref)
    assert len({tuple(o) for o in outs.values()}) > 1


def test_topk_fast_path_equals_full_sampler():
    rng = np.random.RandomState(8)
    logits = torch.tensor(rng.randn(6, 300).astype(np.float32) * 3)
    temps = torch.tensor([0.7, 1.0, 0.0, 1.3, 0.5, 2.0])
    topks = torch.tensor([5, 50, 0, 128, 1, 20])
    topps = torch.tensor([1.0, 0.8, 1.0, 0.95, 1.0, 0.5])
    salts = torch.tensor([TS.sampling_salt(1, r, 0) for r in range(6)])
    full = TS._sample_core(logits, temps, topks, topps, salts)
    fast = TS._sample_topk_core(logits, temps, topks, topps, salts)
    assert full.tolist() == fast.tolist()
    assert int(full[2]) == int(logits[2].argmax())


def test_engine_admission_rules(models):
    _, _, tm, tcfg = models
    cfg = TS.PagedServingConfig(**dict(_CFG, max_queue=2))
    eng = TS.ServingEngine.from_model(tm, cfg, device="cpu")
    with pytest.raises(ValueError):
        eng.add_request([])
    with pytest.raises(ValueError):
        eng.add_request([1, 2, 3], max_new_tokens=cfg.max_seq)
    eng.add_request([1, 2], max_new_tokens=2)
    eng.add_request([3, 4], max_new_tokens=2)
    with pytest.raises(TS.EngineOverloadedError):
        eng.add_request([5], max_new_tokens=2)
    eng.run_to_completion()
    assert len(eng._free_pages) == cfg.num_blocks - 1
