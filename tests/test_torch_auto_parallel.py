"""Auto-parallel over DTensor (paddle_tpu_torch.distributed.auto_parallel)
against the JAX package's (paddle_tpu.distributed.auto_parallel) on the
CPU.

Without ranks: the placements' mapping onto DTensor's and back, the
ProcessMesh queries and ``placements_to_spec``, case by case against the
reference's. With ranks: one gloo world of 4 (tests/torch_dist_workers.py::
auto_parallel) runs every job of this file on a 2 x 2 dp x mp mesh, the
BERT ``debug`` preset (f32, dropout 0) with the FFN weights placed as
tests/test_static_engine.py places them, the reference's parameters
loaded into the DTensors (each rank keeping its shard). This process runs
the reference's Engine on the same 2 x 2 ProcessMesh (its CPU devices)
over the same parameters and batches.

Tolerances, f32 (the sums are split over ranks and run in other orders on
the two sides): the losses within 1e-5 relative; each parameter within
1e-4 of its largest magnitude plus half the learning rate (AdamW moves an
element by about lr times the sign of its gradient, so a gradient near
its round-off moves by a part of lr either way), the k projections'
biases (a gradient of zero: softmax ignores a shift shared by every key,
so both sides hold round-off) within 3 lr of their start; each moment
within 1e-4 of its largest magnitude plus 1e-9 (moment1) or 1e-12
(moment2) absolute, the k biases' moments within 1e-6 and 1e-9 absolute
(round-off of a zero gradient). Under the global-norm clip the same,
and the first step's norm over the sharded gradients within 1e-5
relative of the eager reference's. A frozen leaf stays bit for bit; a leaf
the loss does not reach decays as the reference's: p (1 - lr wd)^3 within
1e-6 relative. The save/load resume equals the unbroken run bit for bit;
reshard and unshard are exact; SDPA over dp-sharded DTensors equals the
unsharded call, dropout mask included, to 1e-6 (the same kernels' plain
versions on each rank's rows).
"""
import pickle
import threading

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
from paddle_tpu.distributed.auto_parallel import (Engine as JEngine,
                                                  ProcessMesh as JMesh)
from paddle_tpu.distributed.auto_parallel import placement as JP
from paddle_tpu.distributed.auto_parallel.api import \
    placements_to_spec as j_spec
import paddle_tpu.distributed as jdist
import paddle_tpu.nn as jnn
from paddle_tpu.models import bert as JB

import torch_dist_workers as W
from paddle_tpu_torch import distributed as dist
from paddle_tpu_torch.distributed.auto_parallel import placement as TP
from paddle_tpu_torch.distributed.auto_parallel.api import \
    placements_to_spec as t_spec

LR, WD = 1e-3, 0.01
CLIP = 0.05          # below the gradients' global norm: the clip acts


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# without ranks
# ---------------------------------------------------------------------------

PLACEMENTS = [("Shard", (0,)), ("Shard", (2,)), ("Replicate", ()),
              ("Partial", ()), ("Partial", ("max",)), ("Partial", ("avg",)),
              ("Partial", (1,)), ("Partial", (4,))]


@pytest.mark.parametrize("kind,args", PLACEMENTS)
def test_placement_maps_onto_dtensor_and_back(kind, args):
    from torch.distributed import tensor as dt

    ref, port = getattr(JP, kind)(*args), getattr(TP, kind)(*args)
    assert repr(port) == repr(ref)
    assert (port.is_shard(), port.is_replicated(), port.is_partial()) == \
        (ref.is_shard(), ref.is_replicated(), ref.is_partial())
    mapped = TP.to_dtensor(port)
    want = {"Shard": dt.Shard, "Replicate": dt.Replicate,
            "Partial": dt.Partial}[kind]
    assert isinstance(mapped, want)
    back = TP.from_dtensor(mapped)
    assert type(back) is type(port)
    if kind == "Partial":
        assert back.reduce_name() == port.reduce_name()
        assert mapped.reduce_op == {"sum": "sum", "max": "max",
                                    "avg": "avg"}[port.reduce_name()]
    else:
        assert back == port and hash(back) == hash(port)


@pytest.mark.parametrize("reduce_type", ["any", "all", 5, 6])
def test_partial_without_a_dtensor_reduction_raises(reduce_type):
    with pytest.raises(NotImplementedError, match="DTensor"):
        TP.to_dtensor(TP.Partial(reduce_type))


MESHES = [([[0, 1], [2, 3]], ["dp", "mp"]), ([0, 1, 2, 3], ["x"]),
          ([[[0, 1], [2, 3]], [[4, 5], [6, 7]]], ["a", "b", "c"]),
          ([[3, 1], [0, 2]], None)]


@pytest.mark.parametrize("mesh,names", MESHES)
def test_process_mesh_queries_match_the_reference(mesh, names):
    ref, port = JMesh(mesh, names), dist.ProcessMesh(mesh, names)
    assert port.shape == ref.shape and port.ndim == ref.ndim
    assert port.dim_names == ref.dim_names
    assert port.process_ids == ref.process_ids
    for d in ref.dim_names:
        assert port.get_dim_size(d) == ref.get_dim_size(d)
        for pid in ref.process_ids + [99]:
            assert port.get_rank_by_dim_and_process_id(d, pid) == \
                ref.get_rank_by_dim_and_process_id(d, pid)
    assert port == dist.ProcessMesh(mesh, names)
    assert hash(port) == hash(dist.ProcessMesh(mesh, names))
    assert port != dist.ProcessMesh(np.asarray(mesh) * 0 + 9, names)
    assert repr(port) == repr(ref)


@pytest.mark.parametrize("placements", [
    ["Shard(0)", "Replicate()"], ["Replicate()", "Shard(1)"],
    ["Shard(1)", "Shard(1)"], ["Replicate()", "Replicate()"],
    ["Partial()", "Shard(2)"]])
def test_placements_to_spec_matches_the_reference(placements):
    def build(mod):
        return [eval(p, {"Shard": mod.Shard, "Replicate": mod.Replicate,
                         "Partial": mod.Partial}) for p in placements]

    names = ["dp", "mp"]
    ref = j_spec(JMesh([[0, 1], [2, 3]], names), build(JP))
    got = t_spec(dist.ProcessMesh([[0, 1], [2, 3]], names), build(TP))
    assert got == tuple(ref)


@pytest.mark.parametrize("rows,p", [((0, 2), 0.1), ((2, 4), 0.1),
                                    ((3, 4), 0.5), ((1, 3), 0.9)])
def test_dropout_hash_offset_gives_the_one_process_rows(rows, p):
    # a rank holding batch rows r0..r1 of the one-process batch passes
    # bh_offset = r0 * H: its mask is those rows of the reference's mask,
    # and the kernels' seed fold (kernel_seed) gives the same bits
    import jax.numpy as jnp

    from paddle_tpu.ops.pallas import flash_attention as JF
    from paddle_tpu_torch.ops.kernels import flash_attention as FA

    b, h, sq, sk = 4, 3, 64, 96
    r0, r1 = rows
    for seed in (0, 7, -1, 2 ** 31 - 1, -2 ** 31):
        ref = np.asarray(JF._full_keep_mask(jnp.asarray([seed], jnp.int32),
                                            b, h, sq, sk, p))[r0:r1]
        got = FA._full_keep_mask(seed, r1 - r0, h, sq, sk, p, "cpu",
                                 bh_offset=r0 * h).numpy()
        np.testing.assert_array_equal(got, ref)
        folded = FA._full_keep_mask(FA.kernel_seed(seed, r0 * h), r1 - r0,
                                    h, sq, sk, p, "cpu").numpy()
        np.testing.assert_array_equal(folded, ref)


def test_device_mesh_raises_before_init_parallel_env():
    with pytest.raises(RuntimeError, match="init_parallel_env"):
        dist.ProcessMesh([[0, 1], [2, 3]], ["dp", "mp"]).to_device_mesh()


# ---------------------------------------------------------------------------
# one world of 4 gloo ranks
# ---------------------------------------------------------------------------

def _reference():
    """The reference's model, parameters and batches, and a function
    running its Engine on the 2 x 2 mesh: the plain run, the clipped one,
    and one with a frozen embedding and a leaf the loss does not reach."""
    cfg = dict(vars(JB.BERT_PRESETS["debug"]))
    mesh = JMesh(np.arange(4).reshape(2, 2), dim_names=["dp", "mp"])

    def model(unused=False, frozen=()):
        jpaddle.seed(0)
        m = JB.BertForSequenceClassification(JB.BertConfig(**cfg),
                                             num_classes=4)
        if unused:
            jpaddle.seed(1)
            m.unused = jnn.Linear(4, 4)
        for name, p in m.named_parameters():
            if "linear1.weight" in name:
                jdist.shard_tensor(p, mesh, [JP.Replicate(), JP.Shard(1)])
            elif "linear2.weight" in name:
                jdist.shard_tensor(p, mesh, [JP.Replicate(), JP.Shard(0)])
            if name in frozen:
                p.stop_gradient = True
        return m

    class Loss(jnn.Layer):
        def __init__(self):
            super().__init__()
            self.ce = jnn.CrossEntropyLoss()

        def forward(self, logits, label):
            return self.ce(logits, label)

    def engine(m, clip=None):
        opt = jpaddle.optimizer.AdamW(
            parameters=m.parameters(), learning_rate=LR,
            grad_clip=None if clip is None else
            jpaddle.nn.ClipGradByGlobalNorm(clip))
        e = JEngine(m, loss=Loss(), optimizer=opt)
        e.prepare(mesh=mesh)
        return e

    rng = np.random.RandomState(0)
    batches = [(rng.randint(0, cfg["vocab_size"], (8, 16)).astype(np.int64),
                rng.randint(0, 4, (8,)).astype(np.int64)) for _ in range(4)]

    def tb(i):
        return tuple(jpaddle.to_tensor(a) for a in batches[i])

    m = model(unused=True)
    params = {n: np.asarray(p.numpy()).copy()
              for n, p in m.named_parameters()}
    frozen = ("bert.embeddings.word_embeddings.weight",)
    return cfg, params, batches, frozen, lambda: _runs(model, engine, Loss,
                                                       tb, frozen)


def _runs(model, engine, Loss, tb, frozen):
    ref = {}
    e = engine(model())
    ref["losses"] = [float(np.asarray(e.run_step(*tb(i)).numpy()))
                     for i in range(3)]
    ref["params"] = {k: np.asarray(v) for k, v in e._params.items()}
    ref["moments"] = {k: {sk: np.asarray(sv) for sk, sv in st.items()}
                      for k, st in e._opt_states.items()}
    ref["eval"] = e.evaluate([tb(3)])["loss"]
    ref["predict"] = np.asarray(e.predict([(tb(3)[0],)])[0])
    # the first step's global gradient norm, from the eager reference
    m = model()
    loss = Loss()(m(*tb(0)[:1]), tb(0)[1])
    loss.backward()
    ref["first_norm"] = float(np.sqrt(sum(
        float(np.sum(np.square(np.asarray(p.grad.numpy()))))
        for p in m.parameters() if p.grad is not None)))
    e = engine(model(), clip=CLIP)
    ref["clip_losses"] = [float(np.asarray(e.run_step(*tb(i)).numpy()))
                          for i in range(3)]
    ref["clip_params"] = {k: np.asarray(v) for k, v in e._params.items()}
    e = engine(model(unused=True, frozen=frozen))
    ref["fz_losses"] = [float(np.asarray(e.run_step(*tb(i)).numpy()))
                        for i in range(3)]
    ref["fz_params"] = {k: np.asarray(v.numpy())
                        for k, v in e.state_dict().items()}
    return ref


def _world(out):
    cfg, params, batches, frozen, runs = _reference()
    rng = np.random.RandomState(5)
    attn = tuple(rng.randn(4, 128, 2, 64).astype(np.float32)
                 for _ in range(4)) + (0.25,)
    # the reference's Engine runs in a thread while the ranks run
    box = {}

    def reference():
        try:
            box["ref"] = runs()
        except BaseException as e:     # re-raised below, in the test
            box["error"] = e

    thread = threading.Thread(target=reference)
    thread.start()
    try:
        dist.spawn(W.auto_parallel, args=(str(out), cfg, params, batches,
                                          LR, attn),
                   nprocs=4, backend="gloo", timeout=300)
    finally:
        thread.join()
    if "error" in box:
        raise box["error"]
    ref = box["ref"]
    got = [pickle.loads((out / f"rank{r}.pkl").read_bytes())
           for r in range(4)]
    return dict(params=params, ref=ref, got=got, frozen=frozen)


def _close_params(got, ref, start):
    for name, a in ref.items():
        g = got[name]
        assert g.shape == a.shape, name
        if "k_proj.bias" in name:
            assert float(np.abs(g - start[name]).max()) <= 3 * LR, name
            continue
        tol = 1e-4 * float(np.abs(a).max()) + 0.5 * LR
        assert float(np.abs(g - a).max()) <= tol, name


def _check_engine_steps(world):
    ref, params = world["ref"], world["params"]
    for got in world["got"]:
        np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-5)
        assert got["step_count"] == 3
        _close_params(got["params"], ref["params"], params)
        for name, st in ref["moments"].items():
            for sk, a in st.items():
                g = got["moments"][name][sk]
                if "k_proj.bias" in name:
                    atol = 1e-6 if sk == "moment1" else 1e-9
                else:
                    atol = 1e-4 * float(np.abs(a).max()) + (
                        1e-9 if sk == "moment1" else 1e-12)
                np.testing.assert_allclose(g, a, rtol=0, atol=atol,
                                           err_msg=f"{name}.{sk}")
    # the gradients' sums were recorded under the mesh dimensions' own
    # group ids: at least one a step over each rank's dp group
    for rank, got in enumerate(world["got"]):
        sums = {tuple(ranks): ops.get("all_reduce", 0)
                for gid, (ranks, ops) in got["comm_groups"].items()
                if gid != 0}
        assert sums.get((rank % 2, rank % 2 + 2), 0) >= 3, sums
    # the completion: annotated FFN weights sharded on mp, the rest
    # replicated
    pl = world["got"][0]["placements"]
    assert pl["bert.encoder.layers.0.linear1.weight"] == \
        ["Replicate", "Shard(1)"]
    assert pl["bert.encoder.layers.0.linear2.weight"] == \
        ["Replicate", "Shard(0)"]
    assert pl["bert.encoder.layers.0.linear1.bias"] == \
        ["Replicate", "Replicate"]


def _check_clip(world):
    ref, params = world["ref"], world["params"]
    for got in world["got"]:
        np.testing.assert_allclose(got["clip_losses"], ref["clip_losses"],
                                   rtol=1e-5)
        # the clipped steps end elsewhere than the plain ones; the first
        # step's norm over the sharded gradients is the whole model's
        assert got["clip_losses"][2] != got["losses"][2]
        np.testing.assert_allclose(got["clip_norms"][0], ref["first_norm"],
                                   rtol=1e-5)
        assert all(n > CLIP for n in got["clip_norms"])
        _close_params(got["clip_params"], ref["clip_params"], params)


def _check_frozen_and_unreached(world):
    ref, params, frozen = world["ref"], world["params"], world["frozen"]
    for got in world["got"]:
        np.testing.assert_allclose(got["fz_losses"], ref["fz_losses"],
                                   rtol=1e-5)
        fz = got["fz_params"]
        for name in frozen:
            np.testing.assert_array_equal(fz[name], params[name])
        for name in ("unused.weight", "unused.bias"):
            decayed = params[name] * (1 - LR * WD) ** 3
            np.testing.assert_allclose(fz[name], decayed, rtol=1e-6)
            np.testing.assert_allclose(fz[name], ref["fz_params"][name],
                                       rtol=1e-6)
        _close_params({k: v for k, v in fz.items()},
                      ref["fz_params"], params)


def _check_evaluate_predict_dist_model(world):
    ref = world["ref"]
    for got in world["got"]:
        np.testing.assert_allclose(got["eval"], ref["eval"], rtol=1e-5)
        # predict after the same three steps
        p = ref["predict"]
        assert got["predict"].shape == p.shape == (8, 4)
        np.testing.assert_allclose(got["predict"], p,
                                   atol=1e-4 * float(np.abs(p).max()))
        # to_static's DistModel: train steps as the Engine's, eval mode
        # between them neither steps nor changes the next train step
        np.testing.assert_allclose(got["dm_train"], ref["losses"],
                                   rtol=1e-5)
        assert np.isfinite(got["dm_eval"])
        assert any("linear1" in k for k in got["dm_state_names"])
        assert got["cost"]["flops"] > 0
        assert got["cost"]["peak_memory_bytes"] == 0
        assert "queue 1, item 9" in got["program"]


def _check_state_dict_and_resume(world):
    for got in world["got"]:
        # the snapshot is a copy: the next step leaves it as it was
        changed = [k for k in got["mid_sd"]
                   if not np.array_equal(got["mid_sd"][k],
                                         got["mid_after"][k])]
        assert changed == [], changed
        assert all(np.isfinite(v).all() for v in got["mid_sd"].values())
        # two steps, save, a fresh Engine loads, one step: the unbroken
        # run's third step, bit for bit
        assert got["resumed_loss"] == got["losses"][2]
        for k, v in got["params"].items():
            np.testing.assert_array_equal(got["resumed_params"][k], v)
        for k, st in got["moments"].items():
            for sk, v in st.items():
                np.testing.assert_array_equal(
                    got["resumed_moments"][k][sk], v)


def _check_fit_and_mesh(world):
    for got in world["got"]:
        history, steps, lr = got["fit"]
        # steps at lr, lr / 2 and lr / 4: the first two losses are the
        # plain run's, the third (after a halved step) is not
        assert steps == 3 and lr == LR / 8
        assert history[:2] == got["losses"][:2]
        assert history[2] != got["losses"][2] and np.isfinite(history[2])
        assert "world's ranks" in got["bad_mesh"]


def _check_reshard(world):
    for r, got in enumerate(world["got"]):
        assert got["reshard"] == [(4, 6), (8, 6), (8, 3)]
        assert got["reshard_equal"]


def _check_attention(world):
    for got in world["got"]:
        for a, b in zip(got["attn_sharded"], got["attn_plain"]):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
        # dropout ran: the output differs from the one without it
        assert not np.allclose(got["attn_plain"][0], got["attn_nodrop"],
                               atol=1e-3)


def test_world_of_four_gloo_ranks(tmp_path):
    # one spawn for every check (a fixture would spawn once an xdist
    # worker that runs one of them)
    world = _world(tmp_path)
    for check in (_check_engine_steps, _check_clip,
                  _check_frozen_and_unreached,
                  _check_evaluate_predict_dist_model,
                  _check_state_dict_and_resume, _check_fit_and_mesh,
                  _check_reshard, _check_attention):
        check(world)
