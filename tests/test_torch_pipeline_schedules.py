"""The port's pipeline schedules and PipelineLayer in one process, held to
the JAX package's.

The schedules are a copy (paddle_tpu_torch/distributed/meta_parallel/
pipeline_schedules.py): every instruction stream, makespan and bubble
ratio must equal the reference's, over a grid of (stages, micro-batches,
chunks), ZB-H1 at 2 and 4 stages included; they are the contract between
the pipeline ranks. PipelineLayer without a pp group holds every stage, as
the reference's does: the same segmentation (uniform and "layer:<Cls>"),
the same parameter names, and the same forward on the same weights
(within 1e-6 of the largest magnitude: f32 GEMMs of two frameworks).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
from paddle_tpu import nn as jnn
from paddle_tpu.distributed import topology as jtopology
from paddle_tpu.distributed.meta_parallel import pipeline_schedules as jps
from paddle_tpu.distributed.meta_parallel.pp_layers import (
    LayerDesc as JDesc, PipelineLayer as JPipe)

import paddle_tpu_torch as paddle
from paddle_tpu_torch import nn
from paddle_tpu_torch.distributed.meta_parallel import (LayerDesc,
                                                        PipelineLayer)
from paddle_tpu_torch.distributed.meta_parallel import \
    pipeline_schedules as tps

GRID = [(p, m, v) for p in (1, 2, 3, 4) for m in (1, 2, 4, 5, 8, 12)
        for v in (1, 2, 3)]


@pytest.fixture(autouse=True)
def _cpu_one_thread():
    threads = torch.get_num_threads()
    device = paddle.get_device()
    torch.set_num_threads(1)
    paddle.set_device("cpu")
    saved = jtopology.get_hybrid_communicate_group()
    jtopology.set_hybrid_communicate_group(None)
    yield
    jtopology.set_hybrid_communicate_group(saved)
    paddle.set_device(device)
    torch.set_num_threads(threads)


@pytest.mark.parametrize("kind", ["fthenb", "1f1b", "interleave", "zb_h1"])
def test_streams_simulate_and_bubble_equal_reference(kind):
    checked = 0
    for p, m, v in GRID:
        if kind in ("fthenb", "1f1b", "zb_h1") and v > 1:
            continue
        if kind == "interleave" and v > 1 and m % p:
            with pytest.raises(ValueError):
                tps.gen_interleave_1f1b(0, p, m, v)
            continue
        if kind == "zb_h1":
            mine = tps._zb_h1_all_stages(p, m)
            ref = jps._zb_h1_all_stages(p, m)
            assert mine == ref
            assert [tps.gen_zero_bubble_h1(s, p, m) for s in range(p)] \
                == ref
        else:
            gen = {"fthenb": "gen_fthenb", "1f1b": "gen_1f1b",
                   "interleave": "gen_interleave_1f1b"}[kind]
            args = (m, v) if kind == "interleave" else (m,)
            mine = [getattr(tps, gen)(s, p, *args) for s in range(p)]
            ref = [getattr(jps, gen)(s, p, *args) for s in range(p)]
            assert mine == ref, (p, m, v)
        mk = tps.simulate(mine, p, m, v if kind == "interleave" else 1)
        assert mk == jps.simulate(ref, p, m, v if kind == "interleave"
                                  else 1)
        has_w = kind == "zb_h1"
        chunks = v if kind == "interleave" else 1
        assert tps.bubble_ratio(mk, p, m, chunks, has_w) == \
            jps.bubble_ratio(mk, p, m, chunks, has_w)
        checked += 1
    assert checked >= 6
    if kind == "zb_h1":
        for p in (2, 4):
            mk = tps.simulate(tps._zb_h1_all_stages(p, 8), p, 8)
            assert mk < tps.simulate([tps.gen_1f1b(s, p, 8)
                                      for s in range(p)], p, 8) + 8


def _models(seg_method="uniform", stages=2):
    jpaddle.seed(3)
    ref = JPipe([JDesc(jnn.Linear, 6, 6) if i % 2 == 0 else jnn.Tanh()
                 for i in range(10)], num_stages=stages,
                seg_method=seg_method)
    mine = PipelineLayer([LayerDesc(nn.Linear, 6, 6) if i % 2 == 0
                          else nn.Tanh() for i in range(10)],
                         num_stages=stages, seg_method=seg_method)
    return ref, mine


@pytest.mark.parametrize("seg_method,stages", [("uniform", 2),
                                               ("uniform", 3),
                                               ("layer:Linear", 2),
                                               ("layer:Linear", 4)])
def test_pipeline_layer_holds_every_stage_without_pp(seg_method, stages):
    ref, mine = _models(seg_method, stages)
    assert mine.stage_id is None and mine.num_stages == stages
    assert mine._stage_bounds == ref._stage_bounds
    state = {k: np.asarray(v.numpy()) for k, v in ref.state_dict().items()}
    assert sorted(state) == sorted(mine.state_dict())
    assert mine.set_state_dict(state) == ([], [])
    x = np.random.RandomState(0).randn(4, 6).astype(np.float32)
    want = np.asarray(ref(jpaddle.to_tensor(x)).numpy())
    got = mine(paddle.to_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
    # stage by stage, as the reference's forward_stage
    h = paddle.to_tensor(x)
    for s in range(stages):
        h = mine.forward_stage(h, s)
    np.testing.assert_array_equal(h.numpy(), got)
