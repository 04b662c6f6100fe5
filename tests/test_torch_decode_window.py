"""The port's serving decode window (ServingEngine.decode_run over
_DecodeWindow, the counterpart of the reference's _decode_window_fn) on
the CPU, where the window's body runs eagerly (on a card it is one CUDA
graph a (row bucket, sampling mode), replayed a step; the GPU tests hold
the graphs to this body bit for bit).

- Greedy streams through decode_run windows equal the JAX engine's
  decode_run streams over the same weights (load_paddle_tpu_params), token
  for token: both compute in f32 (2 layers, hidden 64, GQA 4 q / 2 kv
  heads of 16).
- Sampled rows equal the port's own step() streams: the window advances
  each live row's salt on the device, (s + 1) & 0x7FFFFFFF, which must be
  the host's sampling_salt(seed, rid, n + 1), across the 31-bit wrap too.
- Batch drift inside a power-of-two row bucket reuses the window (4 rows,
  then 3); a new bucket (2 rows) adds one: the counterpart of
  tests/test_speculative.py::test_decode_window_retrace_bounded_by_bucketing.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import serving as JS
from paddle_tpu.jit.functional import current_params

from paddle_tpu_torch.inference import serving as TS

_CFG = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
            num_kv_heads=2, ffn_size=128, block_size=8, num_blocks=40,
            max_batch=4, max_blocks_per_seq=6, token_budget=32)


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
    paddle.seed(321)
    jcfg = JS.PagedServingConfig(**_CFG)
    jm = JS.PagedCausalLM(jcfg)
    jm.eval()
    named = {k: np.asarray(v) for k, v in current_params(jm).items()}
    tcfg = TS.PagedServingConfig(**_CFG)
    tm = TS.PagedCausalLM(tcfg, device="cpu").load_paddle_tpu_params(named)
    return jm, jcfg, tm, tcfg


def _prompts(seed, lens):
    rng = np.random.RandomState(seed)
    return [list(rng.randint(1, 256, n)) for n in lens]


def _to_tip(eng):
    while any(r.length - r.cached > 1 for r in eng.pending()):
        eng.step()


def _windows(eng, n):
    produced = []
    while eng.pending():
        got = eng.decode_run(n)
        assert got, "decode_run must make progress"
        produced += got
    return produced


def test_greedy_windows_match_jax_engine(models):
    jm, jcfg, tm, tcfg = models
    prompts = _prompts(0, (5, 12, 9))

    def drive(eng):
        rids = [eng.add_request(p, max_new_tokens=10 + i)
                for i, p in enumerate(prompts)]
        _to_tip(eng)
        produced = _windows(eng, 4)
        return [list(eng._requests[r].generated) for r in rids], produced

    ref, ref_order = drive(JS.ServingEngine.from_model(jm, jcfg))
    eng = TS.ServingEngine.from_model(tm, tcfg, device="cpu")
    got, order = drive(eng)
    assert got == ref
    assert order == ref_order                  # the same (rid, token) order
    assert all(len(s) == 10 + i for i, s in enumerate(got))
    # 3 rows, then 2, then 1 as the requests finish: buckets 4, 2, 1
    assert set(eng._window_fns) == {(4, "greedy"), (2, "greedy"),
                                    (1, "greedy")}


def _salt_seed(target):
    """An engine seed whose request 0 draws salt ``target`` for its first
    generated token (sampling_salt is linear in the seed mod 2**31)."""
    inv = pow(1000003, -1, 1 << 31)
    return (target * inv) % (1 << 31)


@pytest.mark.parametrize("mode,sp", [
    ("topk", TS.SamplingParams(temperature=0.8, top_k=12, top_p=0.9)),
    ("full", TS.SamplingParams(temperature=1.2, top_k=0, top_p=0.95))])
def test_sampled_windows_match_step_streams(models, mode, sp):
    _, _, tm, tcfg = models
    # request 0's salts run 2**31 - 3, -2, -1, then wrap to 0, 1, ...
    seed = _salt_seed((1 << 31) - 3)
    assert TS.sampling_salt(seed, 0, 3) == 0
    prompts = _prompts(1, (7, 4, 10))

    def submit(eng):
        return [eng.add_request(p, max_new_tokens=9,
                                sampling=sp if i != 1 else None)
                for i, p in enumerate(prompts)]

    ref_eng = TS.ServingEngine.from_model(tm, tcfg, seed=seed, device="cpu")
    rids = submit(ref_eng)
    ref = ref_eng.run_to_completion()              # step() only: host salts
    eng = TS.ServingEngine.from_model(tm, tcfg, seed=seed, device="cpu")
    assert submit(eng) == rids
    _to_tip(eng)
    ngen = [len(eng._requests[r].generated) for r in rids]
    first = eng.decode_run(4)
    assert len(first) == 3 * 4
    win = eng._window_fns[(4, mode)]
    # the salts the device advanced equal the host formula for the next
    # token of each live row
    for i, rid in enumerate(rids):
        assert int(win.salts[i]) == TS.sampling_salt(seed, rid, ngen[i] + 4)
    _windows(eng, 4)
    got = {rid: list(r.generated) for rid, r in eng._requests.items()}
    assert got == ref
    assert len({tuple(v) for v in got.values()}) > 1


def test_window_reuse_bounded_by_bucketing(models):
    _, _, tm, tcfg = models
    eng = TS.ServingEngine.from_model(tm, tcfg, device="cpu")
    rng = np.random.RandomState(46)

    def drain(n_prompts, max_new):
        for i in range(n_prompts):
            eng.add_request(list(rng.randint(1, 97, 6 + i)),
                            max_new_tokens=max_new)
        _to_tip(eng)
        _windows(eng, 4)

    drain(4, max_new=8)       # full batch; tail windows shrink 4->2->1
    assert list(eng._window_fns) == [(4, "greedy")]
    win = eng._window_fns[(4, "greedy")]
    drain(3, max_new=8)       # 3 rows -> bucketed up to 4: full reuse
    assert list(eng._window_fns) == [(4, "greedy")]
    assert eng._window_fns[(4, "greedy")] is win
    drain(2, max_new=8)       # a genuinely new row bucket adds a window
    assert list(eng._window_fns) == [(4, "greedy"), (2, "greedy")]
    assert len(eng._free_pages) == tcfg.num_blocks - 1
