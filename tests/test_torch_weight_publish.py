"""Live weight versions in the port's serving engine (stage, commit, swap,
rollback, probe; paddle_tpu_torch.inference.weight_publish.
build_weight_set), on the CPU in f32, mirroring the reference's
engine-contract tests (tests/test_weight_publish.py:121-323).

Streams are held token for token to fresh single-version engines with the
same seed and request ids (the sampling salts), which is the reference's
referee. The reference's own ``build_weight_set`` output (numpy, bf16 as
ml_dtypes) must stage position for position and equal the port's build bit
for bit, in each weight-stream mode.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import serving as JS
from paddle_tpu.inference import weight_publish as JP
from paddle_tpu.jit.functional import current_params

from paddle_tpu_torch.distributed.resilience.errors import (
    PublishRejectedError, WeightTransferError)
from paddle_tpu_torch.inference import serving as TS
from paddle_tpu_torch.inference.weight_publish import build_weight_set

BASE = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=4,
            num_kv_heads=2, ffn_size=64, block_size=8, num_blocks=48,
            max_batch=3, max_blocks_per_seq=6, token_budget=32)
SP = TS.SamplingParams(temperature=0.7, top_k=12, top_p=0.9)


@pytest.fixture(autouse=True)
def _one_thread():
    # one PyTorch thread while the test runs (see test_torch_serving.py)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def model():
    return TS.PagedCausalLM(TS.PagedServingConfig(**BASE), device="cpu",
                            seed=3)


def _engine(model, seed=0, ws=None, **over):
    cfg = TS.PagedServingConfig(**{**BASE, **over})
    return TS.ServingEngine.from_model(model, cfg, seed=seed, device="cpu",
                                       weight_stream=ws)


def _perturbed(model, scale=0.05, seed=5):
    """Another set of weights: each tensor plus noise at a few percent of
    its own spread (numpy, from a seed)."""
    rng = np.random.RandomState(seed)
    out = {}
    for k, v in model.named_parameters():
        f = v.detach().numpy()
        out[k] = (f + rng.normal(0.0, scale * (np.std(f) + 1e-6),
                                 f.shape)).astype(np.float32)
    return out


def _model_with(named):
    m = TS.PagedCausalLM(TS.PagedServingConfig(**BASE), device="cpu")
    with torch.no_grad():
        for k, p in m.named_parameters():
            p.copy_(torch.from_numpy(named[k]))
    return m


def _publish(engine, model, params, version, ws=None):
    arrays, crcs = build_weight_set(model, params, engine.cfg,
                                    weight_stream=ws)
    engine.stage_weight_set(version, arrays, crcs=crcs)
    engine.commit_weight_set(version)


def _drain(engine):
    for _ in range(600):
        if not engine.pending():
            break
        engine.step()
    return {rid: list(r.generated) for rid, r in engine._requests.items()}


def _regen(model, prompt, rid, seed, max_new, params=None, ws=None,
           sampling=SP):
    """A fresh engine holding only the stream's version, the same seed and
    request id: the bit-for-bit referee."""
    eng = _engine(model if params is None else _model_with(params), seed,
                  ws)
    eng._next_rid = rid
    eng.add_request(list(prompt), max_new_tokens=max_new, sampling=sampling)
    return _drain(eng)[rid]


def test_stage_commit_swap_contract(model):
    eng = _engine(model, seed=1)
    arrays, crcs = build_weight_set(model, _perturbed(model), eng.cfg)
    assert eng.active_weight_version == 0
    assert eng.stage_weight_set(1, arrays, crcs=crcs) == 1
    assert not eng.has_weight_version(1)          # staged serves nothing
    assert eng.commit_weight_set(1) == 0 and eng.active_weight_version == 1
    assert eng.has_weight_version(0) and eng.has_weight_version(1)
    assert eng._params is eng._weight_sets[1]     # a swap of references
    assert all(torch.equal(a, b) for a, b in zip(eng._params, arrays))
    rid = eng.add_request([5, 6, 7], max_new_tokens=2, sampling=SP)
    assert eng._requests[rid].weight_version == 1
    _drain(eng)
    with pytest.raises(PublishRejectedError) as ei:
        eng.commit_weight_set(1)
    assert ei.value.reason == "stale_version" and ei.value.fence_version == 1
    with pytest.raises(PublishRejectedError) as ei:
        eng.commit_weight_set(7)
    assert ei.value.reason == "not_staged"
    eng.stage_weight_set(2, arrays)
    eng.discard_staged(2)
    with pytest.raises(PublishRejectedError):
        eng.commit_weight_set(2)


def test_stage_rejects_torn_and_mismatched_sets(model):
    eng = _engine(model, seed=1)
    arrays, crcs = build_weight_set(model, _perturbed(model), eng.cfg)
    with pytest.raises(WeightTransferError, match="tensor count"):
        eng.stage_weight_set(2, arrays[:-1])
    wrong_shape = list(arrays)
    wrong_shape[0] = torch.zeros(3)
    with pytest.raises(WeightTransferError, match="tensor 0"):
        eng.stage_weight_set(2, wrong_shape)
    wrong_dtype = [a.double() if i == 2 else a for i, a in enumerate(arrays)]
    with pytest.raises(WeightTransferError, match="tensor 2"):
        eng.stage_weight_set(2, wrong_dtype)
    bad = [a.numpy().copy() for a in arrays]
    big = max(range(len(bad)), key=lambda i: bad[i].nbytes)
    buf = bytearray(bad[big].tobytes())
    buf[len(buf) // 2] ^= 0xFF
    bad[big] = np.frombuffer(bytes(buf), bad[big].dtype).reshape(
        bad[big].shape)
    with pytest.raises(WeightTransferError, match="CRC"):
        eng.stage_weight_set(2, bad, crcs=crcs)
    with pytest.raises(WeightTransferError, match="crc count"):
        eng.stage_weight_set(2, arrays, crcs=crcs[:-1])
    assert 2 not in eng._staged_weights and eng.active_weight_version == 0
    assert eng._params is eng._params_for(0)


def test_pinned_version_streams_bitwise_across_swap(model):
    """A stream admitted under N finishes under N when N+1 lands
    mid-flight; both cohorts equal fresh single-version regenerations."""
    new = _perturbed(model)
    eng = _engine(model, seed=7)
    prompt_a, prompt_b = [5, 6, 7, 8], [9, 10, 11]
    rid_a = eng.add_request(prompt_a, max_new_tokens=6, sampling=SP)
    eng.step()                                  # A in flight
    assert eng._requests[rid_a].generated
    _publish(eng, model, new, 1)
    rid_b = eng.add_request(prompt_b, max_new_tokens=6, sampling=SP)
    assert eng._requests[rid_a].weight_version == 0
    assert eng._requests[rid_b].weight_version == 1
    out = _drain(eng)
    assert out[rid_a] == _regen(model, prompt_a, rid_a, 7, 6)
    assert out[rid_b] == _regen(model, prompt_b, rid_b, 7, 6, params=new)
    # the two versions disagree on one of the streams at least
    assert out[rid_a] != _regen(model, prompt_a, rid_a, 7, 6, params=new) \
        or out[rid_b] != _regen(model, prompt_b, rid_b, 7, 6)


def test_scheduler_never_mixes_versions_in_one_step(model):
    eng = _engine(model, seed=2)
    rids0 = [eng.add_request([3 + i, 4, 5], max_new_tokens=4, sampling=SP)
             for i in range(2)]
    eng.step()
    _publish(eng, model, _perturbed(model), 1)
    rids1 = [eng.add_request([20 + i, 21], max_new_tokens=4, sampling=SP)
             for i in range(2)]
    schedule = eng._schedule
    seen = []

    def checked():
        rows = schedule()
        seen.append({r.weight_version for r, _ in rows})
        assert len(seen[-1]) <= 1, f"mixed versions in one step: {seen}"
        return rows

    eng._schedule = checked
    out = _drain(eng)
    assert all(len(out[r]) == 4 for r in rids0 + rids1)
    assert {0} in seen and {1} in seen


def test_decode_window_binds_one_version(model):
    """decode_run takes the oldest tip row's version and only its rows; a
    window after a commit runs the new weights (the window body eagerly
    on the CPU), equal to a fresh engine over them."""
    new = _perturbed(model)
    eng = _engine(model, seed=4)
    rid_a = eng.add_request([5, 6, 7, 8], max_new_tokens=8)
    eng.step()
    _publish(eng, model, new, 1)
    prompt_b = [9, 10, 11, 12, 13]
    rid_b = eng.add_request(prompt_b, max_new_tokens=8)
    eng.step()                            # only A's version: B waits
    assert eng._requests[rid_b].cached == 0
    got = eng.decode_run(4)
    assert {r for r, _ in got} == {rid_a}
    while eng.pending():
        if not eng.decode_run(4):
            eng.step()
    assert set(eng._windows) == {0, 1}
    assert list(eng._window_fns) == list(eng._windows[1])
    ref = _engine(_model_with(new), seed=4)
    ref._next_rid = rid_b
    ref.add_request(prompt_b, max_new_tokens=8)
    while ref.pending():
        if not ref.decode_run(4):
            ref.step()
    assert eng._requests[rid_b].generated == ref._requests[rid_b].generated
    assert eng._requests[rid_a].generated == _regen(
        model, [5, 6, 7, 8], rid_a, 4, 8, sampling=None)


def test_rollback_bitwise_and_inflight_reset(model):
    eng = _engine(model, seed=9)
    _publish(eng, model, _perturbed(model), 1)
    prompt = [4, 5, 6, 7]
    rid = eng.add_request(prompt, max_new_tokens=6, sampling=SP)
    eng.step()
    while not eng.decode_run(2):
        eng.step()
    r = eng._requests[rid]
    assert r.weight_version == 1 and r.generated and 1 in eng._windows
    assert eng.rollback_weight_set() == 0 and eng.active_weight_version == 0
    assert r.weight_version == 0 and r.generated == [] and r.cached == 0
    assert 1 not in eng._weight_sets and 1 not in eng._windows
    assert 1 not in eng._views
    assert _drain(eng)[rid] == _regen(model, prompt, rid, 9, 6)
    with pytest.raises(PublishRejectedError) as ei:
        eng.rollback_weight_set()
    assert ei.value.reason == "no_previous"


def test_gc_keeps_active_previous_and_pinned(model):
    """Commits keep the active version, the previous one and every version
    an in-flight stream is pinned to; the others go with their views and
    decode windows."""
    eng = _engine(model, seed=3)
    sets = [_perturbed(model, seed=s) for s in (11, 12, 13)]
    rid_a = eng.add_request([3, 4, 5, 6], max_new_tokens=12)
    eng.step()
    eng.decode_run(2)                      # a version-0 window
    _publish(eng, model, sets[0], 1)
    rid_b = eng.add_request([7, 8, 9], max_new_tokens=12)
    _publish(eng, model, sets[1], 2)
    assert set(eng._weight_sets) == {0, 1, 2}     # A pins 0, B pins 1
    _drain(eng)
    _publish(eng, model, sets[2], 3)
    assert set(eng._weight_sets) == {2, 3}
    assert set(eng._windows) <= {2, 3} and set(eng._views) <= {2, 3}
    assert not eng.has_weight_version(0) and not eng.has_weight_version(1)
    with pytest.raises(KeyError):
        eng._params_for(1)
    assert eng._requests[rid_a].done and eng._requests[rid_b].done


def test_pin_weight_version_retakes_the_prefix_under_the_pin(model):
    eng = _engine(model, seed=6, prefix_cache=True)
    prompt = list(range(1, 17))
    eng.add_request(prompt + [40], max_new_tokens=2, sampling=SP)
    _drain(eng)
    _publish(eng, model, _perturbed(model), 1)
    rid = eng.add_request(prompt + [41], max_new_tokens=2, sampling=SP)
    assert eng._requests[rid].cached == 0         # v0 pages are not v1's
    eng.pin_weight_version(rid, 0)
    assert eng._requests[rid].weight_version == 0
    assert eng._requests[rid].cached == 16        # v0's prefix pages
    with pytest.raises(KeyError):
        eng.pin_weight_version(rid, 5)
    _drain(eng)


def test_probe_logits_is_stateless_and_scores_staged(model):
    eng = _engine(model, seed=4)
    new = _perturbed(model)
    free0 = len(eng._free_pages)
    pools = eng._kc[:, 1:].clone(), eng._vc[:, 1:].clone()
    base = eng.probe_logits([5, 6, 7])
    assert base.shape == (BASE["vocab_size"],) and base.dtype == np.float32
    arrays, crcs = build_weight_set(model, new, eng.cfg)
    eng.stage_weight_set(1, arrays, crcs=crcs)
    staged = eng.probe_logits([5, 6, 7], version=1)
    assert not np.allclose(base, staged)
    np.testing.assert_array_equal(
        staged, _engine(_model_with(new)).probe_logits([5, 6, 7]))
    eng.commit_weight_set(1)
    np.testing.assert_array_equal(staged, eng.probe_logits([5, 6, 7]))
    assert len(eng._free_pages) == free0 and not eng.pending()
    assert torch.equal(eng._kc[:, 1:], pools[0])
    assert torch.equal(eng._vc[:, 1:], pools[1])
    with pytest.raises(ValueError):
        eng.probe_logits([])


def test_engine_prefix_reuse_stays_within_version(model):
    eng = _engine(model, seed=6, prefix_cache=True)
    prompt = list(range(1, 17))                 # two full blocks
    eng.add_request(prompt + [40], max_new_tokens=2, sampling=SP)
    _drain(eng)
    rid1 = eng.add_request(prompt + [41], max_new_tokens=2, sampling=SP)
    assert eng._requests[rid1].cached > 0
    _drain(eng)
    _publish(eng, model, _perturbed(model), 1)
    rid2 = eng.add_request(prompt + [42], max_new_tokens=2, sampling=SP)
    assert eng._requests[rid2].weight_version == 1
    assert eng._requests[rid2].cached == 0
    _drain(eng)
    rid3 = eng.add_request(prompt + [43], max_new_tokens=2, sampling=SP)
    assert eng._requests[rid3].cached > 0       # v1's own prefix now
    _drain(eng)


@pytest.mark.parametrize("ws", [None, "int8", "int4"])
def test_reference_weight_sets_slot_in(ws):
    """The reference's build_weight_set output (numpy; bf16 as ml_dtypes)
    stages on the port's engine position for position, its CRCs accepted,
    and equals the port's own build bit for bit (bf16 serving)."""
    paddle.seed(17)
    jcfg = JS.PagedServingConfig(**BASE, dtype="bfloat16")
    jm = JS.PagedCausalLM(jcfg)
    jm.eval()
    named = {k: np.asarray(v) for k, v in current_params(jm).items()}
    tcfg = TS.PagedServingConfig(**BASE, dtype="bfloat16")
    tm = TS.PagedCausalLM(tcfg, device="cpu").load_paddle_tpu_params(named)
    ref, ref_crcs = JP.build_weight_set(jm, None, jcfg, weight_stream=ws)
    host, crcs = build_weight_set(tm, None, tcfg, weight_stream=ws)
    assert crcs == [c & 0xFFFFFFFF for c in ref_crcs]
    eng = TS.ServingEngine.from_model(tm, tcfg, device="cpu",
                                      weight_stream=ws)
    assert len(eng._params) == len(ref) == len(host)
    eng.stage_weight_set(1, ref, crcs=ref_crcs)
    for got, mine, live, r in zip(eng._staged_weights[1], host,
                                  eng._params, ref):
        assert tuple(got.shape) == tuple(r.shape) and got.dtype == live.dtype
        assert torch.equal(got, mine) and torch.equal(got, live)
    eng.commit_weight_set(1)
    np.testing.assert_array_equal(eng.probe_logits([3, 4, 5]),
                                  eng.probe_logits([3, 4, 5], version=0))


def test_streamed_engine_versions(model):
    """Under int8 streaming a committed version's codes drive the steps: a
    stream admitted after the commit equals a fresh streaming engine's over
    the new weights."""
    new = _perturbed(model)
    eng = _engine(model, seed=8, ws="int8")
    _publish(eng, model, new, 1, ws="int8")
    rid = eng.add_request([4, 5, 6, 7, 8], max_new_tokens=6, sampling=SP)
    while eng.pending():
        if not eng.decode_run(4):
            eng.step()
    assert eng._requests[rid].generated == _regen(
        model, [4, 5, 6, 7, 8], rid, 8, 6, params=new, ws="int8")
    codes = eng._views[1].stream._q[("qkv", 0)]
    assert codes is eng._weight_sets[1][len(eng._names)]
    assert codes.dtype == torch.int8


# -- the transport and the rollout controller (weight_publish.py:154-695) --

def test_weight_set_over_loopback_is_crc_checked(model):
    from paddle_tpu_torch.inference.fleet_supervisor import LoopbackTransport
    from paddle_tpu_torch.inference.weight_publish import (
        receive_weight_set, send_weight_set)

    for ws in (None, "int8"):
        eng = _engine(model, seed=2, ws=ws)
        arrays, crcs = build_weight_set(model, _perturbed(model), eng.cfg,
                                        weight_stream=ws)
        tp = LoopbackTransport()
        n = send_weight_set(tp, 0, 1, arrays, crcs)
        assert n == sum(a.numel() * a.element_size() for a in arrays)
        assert receive_weight_set(eng, tp, 0) == 1
        for got, want in zip(eng._staged_weights[1], arrays):
            assert torch.equal(got, want)
        # one byte torn between the builder and the engine: refused, the
        # engine serving as before with nothing staged
        eng.discard_staged()
        tp = LoopbackTransport()
        send_weight_set(tp, 0, 2, arrays, crcs)
        frames = tp._q["publish"]
        big = max(range(1, len(frames)), key=lambda i: frames[i].size)
        frames[big] = frames[big].copy()
        frames[big][frames[big].size // 3] ^= 0x40
        with pytest.raises(WeightTransferError, match="CRC"):
            receive_weight_set(eng, tp, 0)
        assert eng._staged_weights == {} and eng.active_weight_version == 0


def _port_fleet(model, n=3):
    from paddle_tpu_torch.inference.fleet_supervisor import (
        FleetSupervisor, FleetSupervisorConfig)
    from paddle_tpu_torch.inference.router import Replica, ReplicaRouter

    engs = [_engine(model, seed=50 + i) for i in range(n)]
    for i, e in enumerate(engs):
        e.fault_rank = i
    router = ReplicaRouter([Replica(e, name=f"r{i}", restore_after=1)
                            for i, e in enumerate(engs)])
    sup = FleetSupervisor(router, lambda idx: _engine(model, seed=50 + idx),
                          FleetSupervisorConfig(backoff_base_s=0.0))
    return router, sup


def test_publisher_canary_rollout_rollback_and_catch_up(model):
    from paddle_tpu_torch.distributed.resilience import faults
    from paddle_tpu_torch.inference.weight_publish import WeightPublisher

    router, sup = _port_fleet(model)
    pub = WeightPublisher(router, model, supervisor=sup)
    assert sup.weight_catchup == pub.catch_up
    prompts = [[3, 4, 5, 6, 7], [9, 8, 7], [1, 2, 3, 4, 5, 6, 7, 8, 9]]
    before = [router.submit(p, max_new_tokens=6, sampling=SP)
              for p in prompts]
    router.step_all()
    new = _perturbed(model)
    # a replica felled mid-stage misses the rollout, the rest commit
    faults.arm("kill@publish:rank=2")
    try:
        rep = pub.publish(params=new)
    finally:
        faults.disarm()
    assert rep.version == 1 and rep.canary == "r0"
    assert rep.committed == ["r0", "r1"] and rep.missed == ["r2"]
    assert rep.bytes_shipped > 0
    after = [router.submit(p, max_new_tokens=6, sampling=SP)
             for p in prompts]
    sup.pump()                                  # restart + catch-up
    assert [r.engine.active_weight_version for r in router.replicas] == \
        [1, 1, 1]
    res = router.run_to_completion()
    # each stream runs under the version it was admitted under
    for handles, params in ((before, None), (after, new)):
        for h in handles:
            idx, rid = router._handles[h]
            r = router.replicas[idx].engine._requests[rid]
            seed = router.replicas[idx].engine.seed if r.salt_seed is None \
                else r.salt_seed
            assert res[h] == _regen(model, r.prompt, r.salt_rid, seed, 6,
                                    params=params)
    # rollback: the whole fleet back on version 0
    assert pub.rollback() == 0
    assert [r.engine.active_weight_version for r in router.replicas] == \
        [0, 0, 0]
    # a poisoned candidate never commits anywhere
    bad = dict(new)
    bad["head.weight"] = bad["head.weight"].copy()
    bad["head.weight"][0, :3] = np.nan
    with pytest.raises(PublishRejectedError, match="canary_nonfinite"):
        pub.publish(params=bad)
    assert all(r.engine.active_weight_version == 0
               and r.engine._staged_weights == {}
               for r in router.replicas)


def test_version_one_logits_equal_the_reference_engine():
    from paddle_tpu.inference import fleet_supervisor as JFS
    from paddle_tpu.inference import router as JR
    from paddle_tpu_torch.inference.weight_publish import WeightPublisher

    paddle.seed(23)
    jcfg = JS.PagedServingConfig(**BASE)
    jm = JS.PagedCausalLM(jcfg)
    jm.eval()
    named = {k: np.asarray(v) for k, v in current_params(jm).items()}
    tm = TS.PagedCausalLM(TS.PagedServingConfig(**BASE),
                          device="cpu").load_paddle_tpu_params(named)
    rng = np.random.RandomState(4)
    v1 = {k: (v + rng.normal(0, 0.05 * (np.std(v) + 1e-6), v.shape)
              ).astype(np.float32) for k, v in named.items()}
    jr = JR.ReplicaRouter([JS.ServingEngine.from_model(jm, jcfg, seed=s)
                           for s in (1, 2)])
    JP.WeightPublisher(jr, jm).publish(params=v1)
    tr, _ = _port_fleet(tm, n=2)
    rep = WeightPublisher(tr, tm).publish(params=v1)
    assert rep.committed == ["r0", "r1"]
    for prompt in ([3, 4, 5], [7, 1, 9, 2, 8, 6, 5]):
        want = jr.replicas[0].engine.probe_logits(prompt)
        for r in tr.replicas:
            got = r.engine.probe_logits(prompt)
            assert r.engine.active_weight_version == 1
            np.testing.assert_allclose(got, want, rtol=1e-5,
                                       atol=1e-5 * np.abs(want).max())
    # and bit for bit against a port engine built on the version-1 weights
    fresh = TS.ServingEngine.from_model(
        _model_with(v1), TS.PagedServingConfig(**BASE), device="cpu")
    np.testing.assert_array_equal(
        fresh.probe_logits([3, 4, 5]), tr.replicas[0].engine.probe_logits(
            [3, 4, 5]))


@pytest.mark.parametrize("name", ["PublishPolicy", "PublishReport",
                                  "WeightPublisher", "build_weight_set",
                                  "send_weight_set", "receive_weight_set",
                                  "PUBLISH_CHANNEL"])
def test_publisher_surface_matches_reference(name):
    from paddle_tpu_torch.inference import weight_publish as TP

    assert name in JP.__all__ and name in TP.__all__
    assert hasattr(TP, name)
