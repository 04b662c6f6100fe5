"""Rank functions for the port's multi-rank CPU tests
(tests/test_torch_{collective,hybrid_trainer,fleet_eager}.py).

``paddle_tpu_torch.distributed.spawn`` starts each in new processes, one a
rank, over gloo; each imports only torch, numpy and paddle_tpu_torch (never
jax or paddle_tpu: the parent test holds the JAX side), runs on one
PyTorch thread, and writes what the parent compares into
``out_dir/rank{r}.npz`` (or ``.pkl``).
"""
import os
import pickle
import time

import numpy as np
import torch


def _start():
    torch.set_num_threads(1)
    import paddle_tpu_torch.distributed as dist

    dist.init_parallel_env(backend="gloo")
    return dist, dist.get_rank()


def _dump(out_dir, rank, results):
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)


def _np(t):
    from paddle_tpu_torch import Tensor

    t = t._value if isinstance(t, Tensor) else t
    return t.detach().float().numpy().copy()


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def collectives(out_dir, eager):
    """Every collective at 4 ranks, on torch tensors or (``eager``) the
    eager Tensors."""
    dist, rank = _start()
    import paddle_tpu_torch as paddle

    world = dist.get_world_size()
    mk = (lambda a: paddle.to_tensor(a)) if eager else \
        (lambda a: torch.from_numpy(np.array(a)))
    res = {}
    base = np.arange(6, dtype=np.float32).reshape(2, 3) + 10 * (rank + 1)
    for op in ("sum", "max", "min", "prod", "avg"):
        t = mk(base.copy())
        task = dist.all_reduce(t, op=op)
        assert task.wait() and task.is_completed()
        res[f"all_reduce_{op}"] = _np(t)
    t = mk(base.copy())
    task = dist.all_reduce(t, sync_op=False)
    task.wait()
    res["all_reduce_async"] = _np(t)
    t = mk(base.astype(np.float32))
    if eager:
        t = t.astype("bfloat16")
    else:
        t = t.to(torch.bfloat16)
    dist.all_reduce(t)
    res["all_reduce_bf16"] = _np(t)
    parts = []
    dist.all_gather(parts, mk(base.copy()))
    assert type(parts[0]) is type(mk(base))
    res["all_gather_list"] = np.stack([_np(p) for p in parts])
    res["all_gather_axis0"] = _np(dist.all_gather(None, mk(base.copy())))
    res["all_gather_axis1"] = _np(dist.all_gather(None, mk(base.copy()),
                                                  axis=1))
    objs = []
    dist.all_gather_object(objs, {"rank": rank, "tag": "x" * (rank + 1)})
    res["all_gather_object"] = [(o["rank"], o["tag"]) for o in objs]
    full = np.arange(8, dtype=np.float32) + 100 * (rank + 1)
    out = mk(np.zeros(2, np.float32))
    dist.reduce_scatter(out, mk(full.copy()))
    res["reduce_scatter"] = _np(out)
    out = mk(np.zeros(2, np.float32))
    dist.reduce_scatter(out, [mk(p) for p in np.split(full, world)],
                        op="max")
    res["reduce_scatter_list_max"] = _np(out)
    ins = [mk(np.full(2, 10.0 * rank + i, np.float32)) for i in range(world)]
    outs = []
    dist.all_to_all(outs, ins)
    res["all_to_all"] = np.stack([_np(o) for o in outs])
    out = mk(np.zeros(world, np.float32))
    dist.all_to_all_single(out, mk(np.arange(world, dtype=np.float32)
                                   + 10 * rank))
    res["all_to_all_single"] = _np(out)
    # uneven: rank r sends r + 1 elements to each peer
    send = np.full(world * (rank + 1), float(rank), np.float32)
    out = mk(np.zeros(sum(r + 1 for r in range(world)), np.float32))
    dist.all_to_all_single(out, mk(send), [r + 1 for r in range(world)],
                           [rank + 1] * world)
    res["all_to_all_single_uneven"] = _np(out)
    t = mk(base.copy())
    dist.broadcast(t, src=2)
    res["broadcast"] = _np(t)
    olist = [{"from": rank}, rank * 3] if rank == 1 else [None, None]
    dist.broadcast_object_list(olist, src=1)
    res["broadcast_object_list"] = olist
    t = mk(base.copy())
    dist.reduce(t, dst=3)
    res["reduce"] = _np(t)
    t = mk(np.zeros(2, np.float32))
    pieces = [mk(np.full(2, float(i), np.float32)) for i in range(world)] \
        if rank == 0 else None
    dist.scatter(t, pieces, src=0)
    res["scatter"] = _np(t)
    got = []
    dist.scatter_object_list(got, [f"o{i}" for i in range(world)]
                             if rank == 0 else None, src=0)
    res["scatter_object_list"] = got[0]
    gl = []
    dist.gather(mk(base.copy()), gl, dst=1)
    res["gather"] = np.stack([_np(g) for g in gl]) if rank == 1 else None
    # send / recv around a ring, then the same posted asynchronously
    nxt, prv = (rank + 1) % world, (rank - 1) % world
    buf = mk(np.zeros(3, np.float32))
    if rank % 2 == 0:
        dist.send(mk(np.full(3, float(rank), np.float32)), dst=nxt)
        dist.recv(buf, src=prv)
    else:
        dist.recv(buf, src=prv)
        dist.send(mk(np.full(3, float(rank), np.float32)), dst=nxt)
    res["send_recv"] = _np(buf)
    buf = mk(np.zeros(3, np.float32))
    tasks = [dist.irecv(buf, src=prv),
             dist.isend(mk(np.full(3, rank + 0.5, np.float32)), dst=nxt)]
    for task in tasks:
        task.wait()
    res["isend_irecv"] = _np(buf)
    # batched p2p with the receive listed first on every rank
    rbuf = mk(np.zeros(3, np.float32))
    tasks = dist.batch_isend_irecv([
        dist.P2POp(dist.irecv, rbuf, prv),
        dist.P2POp(dist.isend, mk(np.full(3, rank + 1.0, np.float32)),
                   nxt)])
    for task in tasks:
        task.wait()
    res["batch_isend_irecv"] = _np(rbuf)
    # a group of the even ranks: every rank makes it, the members use it
    evens = dist.new_group([0, 2])
    odds = dist.new_group([1, 3])
    mine = evens if rank % 2 == 0 else odds
    assert dist.get_group(mine.id) is mine
    t = mk(base.copy())
    dist.all_reduce(t, group=mine)
    res["subgroup_all_reduce"] = _np(t)
    res["subgroup_rank"] = (mine.rank, mine.nranks, mine.is_member(),
                            evens.is_member())
    res["backend"] = dist.get_backend()
    dist.wait(t)
    dist.barrier()
    dist.barrier(mine)
    _dump(out_dir, rank, res)
    dist.destroy_process_group()


def sleeper(out_dir):
    _start()
    time.sleep(120)


def raiser(out_dir):
    dist, rank = _start()
    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    time.sleep(120)


# ---------------------------------------------------------------------------
# HybridTrainer over a mesh
# ---------------------------------------------------------------------------

def _llama_config(cfg_dict, policy=None):
    """The config, under remat policy ``policy`` (the dict's when None)."""
    from paddle_tpu_torch.models import llama as TL

    if policy is not None:
        cfg_dict = dict(cfg_dict, remat_policy=policy)
    return TL.LlamaConfig(**cfg_dict)


class _FlashForwards:
    """Counts the flash forward's calls while entered (the kernel's
    wrapper, whose plain version runs on the CPU): each attention's
    forward, each ring hop's, and each recomputation's."""

    def __enter__(self):
        from paddle_tpu_torch.ops.kernels import flash_attention as fa

        self._fa, self._orig, self.n = fa, fa.forward_with_lse, 0

        def counted(*args, **kwargs):
            self.n += 1
            return self._orig(*args, **kwargs)

        fa.forward_with_lse = counted
        return self

    def __exit__(self, *exc):
        self._fa.forward_with_lse = self._orig


def _trainer_from(cfg, mesh, np_params, lr, clip=1.0):
    """A mesh trainer whose parameters are this rank's slices of the
    reference's arrays, through the converter."""
    from paddle_tpu_torch.distributed.fleet import HybridTrainer
    from paddle_tpu_torch.models import llama as TL
    from paddle_tpu_torch.utils import stacked_params_from_paddle_tpu

    tr = HybridTrainer(cfg, mesh, learning_rate=lr, grad_clip_norm=clip,
                       device="cpu")
    mine = TL.leaves(stacked_params_from_paddle_tpu(np_params, tr.hcg))
    with torch.no_grad():
        for name, t in TL.leaves(tr.params).items():
            t.copy_(mine[name])
    return tr


def trainer_mesh(out_dir, cfg_dict, mesh, np_params, batches, lr):
    """3 steps on ``mesh``: losses, grad norms, the gathered state."""
    dist, rank = _start()
    tr = _trainer_from(_llama_config(cfg_dict), mesh, np_params, lr)
    losses, norms = [], []
    for ids, labels in batches:
        losses.append(float(tr.step(ids, labels)))
        norms.append(float(tr.last_grad_norm))
    state = tr.elastic_state()
    from paddle_tpu_torch.models import llama as TL

    local = {k: tuple(v.shape) for k, v in TL.leaves(tr.params).items()}
    if rank == 0:
        _dump(out_dir, rank, {"losses": losses, "norms": norms,
                              "state": state, "local_shapes": local})
    dist.destroy_process_group()


def trainer_elastic(out_dir, cfg_dict, np_params, batches, lr):
    """Steps under mp 2 x sharding 2, a snapshot, one more step; the
    snapshot loaded under dp 4 and the same step there."""
    dist, rank = _start()
    cfg = _llama_config(cfg_dict)
    tr = _trainer_from(cfg, {"mp": 2, "sharding": 2}, np_params, lr)
    for ids, labels in batches[:-1]:
        tr.step(ids, labels)
    snap = tr.elastic_state()
    ids, labels = batches[-1]
    next_loss = float(tr.step(ids, labels))
    from paddle_tpu_torch.distributed.fleet import HybridTrainer

    dp4 = HybridTrainer(cfg, {"dp": 4}, learning_rate=lr, device="cpu")
    dp4.load_elastic_state(snap)
    loaded = dp4.elastic_state()
    dp4_loss = float(dp4.step(ids, labels))
    after = dp4.elastic_state()
    after_mp = tr.elastic_state()
    if rank == 0:
        _dump(out_dir, rank, {
            "next_loss": next_loss, "dp4_loss": dp4_loss,
            "reload_exact": all(np.array_equal(loaded[k], snap[k])
                                for k in snap),
            "after_gap": max(float(np.abs(after[k] - after_mp[k]).max())
                             for k in after if k != "step")})
    dist.destroy_process_group()


def trainer_norms(out_dir, cfg_dict, np_params, batches, lr, clip, meshes):
    """The clip's global norms, step by step, on each mesh."""
    dist, rank = _start()
    cfg = _llama_config(cfg_dict)
    norms = {}
    for mesh in meshes:
        tr = _trainer_from(cfg, mesh, np_params, lr, clip)
        norms[str(mesh)] = []
        for ids, labels in batches:
            tr.step(ids, labels)
            norms[str(mesh)].append(float(tr.last_grad_norm))
    if rank == 0:
        _dump(out_dir, rank, norms)
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# fleet and the eager layers
# ---------------------------------------------------------------------------

def _fleet(dist, **degrees):
    from paddle_tpu_torch.distributed import fleet

    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = dict(
        {"dp_degree": 1, "mp_degree": 1, "pp_degree": 1,
         "sharding_degree": 1, "sep_degree": 1}, **degrees)
    fleet.init(is_collective=True, strategy=strategy)
    return fleet, fleet.get_hybrid_communicate_group()


def _gathered(p, group):
    """The full parameter from every mp rank's shard."""
    from paddle_tpu_torch.distributed.fleet.layers.mpu.mp_ops import \
        gather_along

    t = p._value.detach()
    if not getattr(p, "is_distributed", False):
        return t.numpy().copy()
    return gather_along(t, group, p.split_axis).numpy().copy()


def fleet_tp_layers(out_dir):
    """fleet.init(dp 2, mp 2) and the reference's TP-layers parity check
    (tests/test_distributed.py:175-197), gathered."""
    dist, rank = _start()
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.distributed.meta_parallel import (
        ColumnParallelLinear, RowParallelLinear)

    paddle.seed(11)
    fleet, hcg = _fleet(dist, dp_degree=2, mp_degree=2)
    info = {"mode": hcg.get_parallel_mode(), "degrees": hcg.degrees(),
            "mp_rank": hcg.get_model_parallel_rank(),
            "dp_rank": hcg.get_data_parallel_rank(),
            "mp_ranks": hcg.get_model_parallel_group().ranks,
            "dp_ranks": hcg.get_data_parallel_group().ranks,
            "worker": (fleet.worker_num(), fleet.worker_index(),
                       fleet.is_first_worker()),
            "mesh": dict(dist.get_mesh().shape)}
    mp = hcg.get_model_parallel_group()
    col = ColumnParallelLinear(16, 32, has_bias=True, gather_output=False)
    # the column layer's output stays split: the row layer's input is
    # parallel (the reference's one-process layers need not say so)
    row = RowParallelLinear(32, 16, input_is_parallel=True)
    gathered = ColumnParallelLinear(16, 32, has_bias=True,
                                    gather_output=True)
    info["flags"] = (col.weight.is_distributed, col.weight.split_axis,
                     row.weight.is_distributed, row.weight.split_axis,
                     row.bias.is_distributed, tuple(col.weight.shape),
                     tuple(row.weight.shape))
    x = paddle.to_tensor(np.random.RandomState(0).rand(4, 16)
                         .astype(np.float32), stop_gradient=False)
    y = row(col(x))
    y.sum().backward()
    g = gathered(x)
    # a row layer over a whole input slices it first
    row_split = RowParallelLinear(32, 16)
    z = row_split(g)
    out = {"info": info, "x": x.numpy(), "y": y.numpy(),
           "x_grad": x.grad.numpy(), "g": g.numpy(),
           "col_w": _gathered(col.weight, mp), "col_b": _gathered(col.bias, mp),
           "row_w": _gathered(row.weight, mp), "row_b": _gathered(row.bias, mp),
           "z": z.numpy(), "rs_w": _gathered(row_split.weight, mp),
           "rs_b": _gathered(row_split.bias, mp),
           "g_w": _gathered(gathered.weight, mp),
           "g_b": _gathered(gathered.bias, mp),
           "col_w_grad": gather_grad(col.weight, mp),
           "row_w_grad": gather_grad(row.weight, mp),
           "row_b_grad": row.bias.grad.numpy()}
    fleet.barrier_worker()
    _dump(out_dir, rank, out)
    dist.destroy_process_group()


def gather_grad(p, group):
    from paddle_tpu_torch.distributed.fleet.layers.mpu.mp_ops import \
        gather_along

    return gather_along(p._value.grad, group, p.split_axis).numpy().copy()


def vocab_and_cross_entropy(out_dir):
    """VocabParallelEmbedding and ParallelCrossEntropy at mp 4 against
    their dense forms over the gathered table and logits."""
    dist, rank = _start()
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.distributed.meta_parallel import (
        ParallelCrossEntropy, VocabParallelEmbedding)

    paddle.seed(5)
    fleet, hcg = _fleet(dist, mp_degree=4)
    mp = hcg.get_model_parallel_group()
    rng = np.random.RandomState(1)
    ids = rng.randint(0, 64, (3, 5))
    emb = VocabParallelEmbedding(64, 8)
    x = emb(paddle.to_tensor(ids))
    cot = rng.standard_normal((3, 5, 8)).astype(np.float32)
    (x * paddle.to_tensor(cot)).sum().backward()
    logits_full = rng.standard_normal((3, 5, 64)).astype(np.float32) * 3
    labels = rng.randint(0, 64, (3, 5))
    labels[0, 0] = -100
    r = hcg.get_model_parallel_rank()
    local = paddle.to_tensor(logits_full[..., r * 16:(r + 1) * 16].copy(),
                             stop_gradient=False)
    loss = ParallelCrossEntropy()(local, paddle.to_tensor(labels))
    loss.sum().backward()
    out = {"ids": ids, "x": x.numpy(), "cot": cot,
           "table": _gathered(emb.weight, mp),
           "table_grad": gather_grad(emb.weight, mp),
           "logits": logits_full, "labels": labels, "loss": loss.numpy(),
           "logits_grad": _np(dist.all_gather(None, local.grad._value,
                                              group=mp, axis=2))}
    _dump(out_dir, rank, out)
    dist.destroy_process_group()


def sharding_stage1(out_dir, lr):
    """DygraphShardingOptimizer at sharding 4 over AdamW: each rank's
    moments are 1/4 of each parameter; two steps against AdamW on the
    averaged gradients in the same process."""
    dist, rank = _start()
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import nn, optimizer
    from paddle_tpu_torch.distributed.meta_parallel import \
        DygraphShardingOptimizer

    fleet, hcg = _fleet(dist, sharding_degree=4)
    paddle.seed(3)
    lin = nn.Linear(10, 7)                      # 70 weights (not / 4), 7 bias
    paddle.seed(3)
    ref = nn.Linear(10, 7)
    opt = DygraphShardingOptimizer(optimizer.AdamW(
        learning_rate=lr, parameters=lin.parameters(), weight_decay=0.1),
        hcg)
    ref_opt = optimizer.AdamW(learning_rate=lr, parameters=ref.parameters(),
                              weight_decay=0.1)
    every = np.random.RandomState(100)
    xs_all = [every.rand(4, 4, 10).astype(np.float32) for _ in range(2)]
    for step in range(2):
        xr = paddle.to_tensor(xs_all[step][rank])
        (lin(xr) ** 2).mean().backward()
        opt.step()
        opt.clear_grad()
        # the reference: the mean of the ranks' gradients
        for k in range(4):
            ((ref(paddle.to_tensor(xs_all[step][k])) ** 2).mean()
             * 0.25).backward()
        ref_opt.step()
        ref_opt.clear_grad()
    moments = {k: tuple(v.shape) for k, v in opt.local_state_dict().items()
               if k != "_step_count"}
    full = {k: tuple(v.shape) for k, v in opt.state_dict().items()
            if k != "_step_count"}
    out = {"moments": moments, "full_moments": full,
           "w": lin.weight.numpy(), "b": lin.bias.numpy(),
           "ref_w": ref.weight.numpy(), "ref_b": ref.bias.numpy()}
    out.update(_stage3(hcg.get_sharding_parallel_group(), rank))
    _dump(out_dir, rank, out)
    dist.destroy_process_group()


def _stage3(group, rank):
    """stage3_forward over 3 layers whose weights live as 4 row shards,
    with and without the prefetch overlap, against the dense layers: the
    output, and the shards' gradients (the full gradient's rows)."""
    from paddle_tpu_torch.distributed.meta_parallel import stage3_forward

    full = [torch.from_numpy(np.random.RandomState(40 + i).standard_normal(
        (8, 8)).astype(np.float32)) for i in range(3)]
    x = torch.from_numpy(np.random.RandomState(50 + rank).standard_normal(
        (5, 8)).astype(np.float32))

    def stage_fn(p, h):
        return torch.tanh(h @ p["w"])

    out = {}
    for overlap in (False, True):
        shards = [{"w": w.chunk(4, 0)[rank].clone().requires_grad_(True)}
                  for w in full]
        y = stage3_forward(stage_fn, shards, x, group, overlap=overlap)
        y.square().sum().backward()
        out[f"stage3_y_{overlap}"] = y.detach().numpy()
        out[f"stage3_g_{overlap}"] = [s["w"].grad.numpy() for s in shards]
    # the dense reference: every rank's input, the gradients summed
    dense = [w.clone().requires_grad_(True) for w in full]
    total = 0
    for r in range(4):
        h = torch.from_numpy(np.random.RandomState(50 + r).standard_normal(
            (5, 8)).astype(np.float32))
        for w in dense:
            h = torch.tanh(h @ w)
        if r == rank:
            out["stage3_dense_y"] = h.detach().numpy()
        total = total + h.square().sum()
    total.backward()
    out["stage3_dense_g"] = [w.grad.chunk(4, 0)[rank].numpy()
                             for w in dense]
    return out


def data_parallel(out_dir):
    """DataParallel at 4 ranks: the parameters broadcast from rank 0, the
    gradients averaged; inside no_sync() they stay local."""
    dist, rank = _start()
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import nn

    paddle.seed(rank)                  # different on each rank at first
    model = dist.DataParallel(nn.Linear(6, 3))
    x = np.random.RandomState(7).rand(4, 2, 6).astype(np.float32)
    model(paddle.to_tensor(x[rank])).sum().backward()
    synced = model._layers.weight.grad.numpy().copy()
    model._layers.clear_gradients()
    with model.no_sync():
        model(paddle.to_tensor(x[rank])).sum().backward()
    local = model._layers.weight.grad.numpy().copy()
    _dump(out_dir, rank, {"w": model._layers.weight.numpy(), "x": x,
                          "synced": synced, "local": local,
                          "scaled": float(model.scale_loss(
                              paddle.to_tensor(2.0)))})
    dist.destroy_process_group()


def eager_llama(out_dir, cfg_dict, state, ids, labels, lr):
    """The eager LlamaForCausalLM at mp 2 x dp 2 through distributed_model
    and distributed_optimizer (AdamW with the global-norm clip): the
    global batch's loss and the gathered parameters after one step."""
    dist, rank = _start()
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.models import llama as TL
    from paddle_tpu_torch.utils import state_dict_from_paddle_tpu

    fleet, hcg = _fleet(dist, dp_degree=2, mp_degree=2)
    model = TL.LlamaForCausalLM(TL.LlamaConfig(**cfg_dict))
    missing, unexpected = model.set_state_dict(
        state_dict_from_paddle_tpu(state, hcg))
    assert missing == [] and unexpected == [], (missing, unexpected)
    kinds = {type(model.model.embed_tokens).__name__,
             type(model.model.layers[0].self_attn.q_proj).__name__,
             type(model.model.layers[0].mlp.down_proj).__name__,
             type(model.lm_head).__name__}
    table = model.model.embed_tokens.weight
    model = fleet.distributed_model(model)
    opt = fleet.distributed_optimizer(optimizer.AdamW(
        learning_rate=lr, parameters=model.parameters(), weight_decay=0.1,
        grad_clip=optimizer.ClipGradByGlobalNorm(1.0)))
    r, n = hcg.get_data_parallel_rank(), 2
    rows = ids.shape[0] // n
    loss = model(paddle.to_tensor(ids[r * rows:(r + 1) * rows]),
                 labels=paddle.to_tensor(labels[r * rows:(r + 1) * rows]))
    loss.backward()
    mp = hcg.get_model_parallel_group()
    # the table's gradient (with tied embeddings: the lookup's and the
    # head's), whole over mp and averaged over dp (the global batch's)
    from paddle_tpu_torch.distributed.fleet.layers.mpu.mp_ops import \
        gather_along

    g = gather_along(table._value.grad, mp, 0).clone()
    dist.all_reduce(g, op="avg", group=hcg.get_data_parallel_group())
    opt.step()
    opt.clear_grad()
    total = loss.detach()._value.clone()
    dist.all_reduce(total, op="avg", group=hcg.get_data_parallel_group())
    params = {name: _gathered(p, mp) for name, p in model.named_parameters()}
    if rank == 0:
        _dump(out_dir, rank, {"loss": float(total), "params": params,
                              "kinds": sorted(kinds),
                              "table_grad": g.numpy()})
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# pipeline parallelism
# ---------------------------------------------------------------------------

def _seq_descs(n_layers=8, width=12, shared=False):
    """The TPU package's test model (tests/test_pipeline_schedules.py::
    _seq_model) as descs: Linear, Tanh, ...; with ``shared``, its first and
    last Linear one tied layer."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.distributed.meta_parallel import (LayerDesc,
                                                            SharedLayerDesc)

    out = []
    for i in range(n_layers):
        if shared and i in (0, n_layers - 1):
            out.append(SharedLayerDesc("tie", nn.Linear, None, "weight",
                                       width, width))
        else:
            out.append(LayerDesc(nn.Linear, width, width))
        out.append(LayerDesc(nn.Tanh))
    return out


def _pp_strategy(pp, **pp_configs):
    from paddle_tpu_torch.distributed import fleet

    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {
        "dp_degree": 1, "mp_degree": 1, "pp_degree": pp,
        "sharding_degree": 1, "sep_degree": 1,
        "pp_configs": dict({"accumulate_steps": 4}, **pp_configs)}
    fleet.init(is_collective=True, strategy=strategy)
    return strategy, fleet.get_hybrid_communicate_group()


def _grads(model):
    return {n: _np(p.grad) for n, p in model.named_parameters()
            if p.grad is not None}


def pipeline_engines(out_dir, state, shared_state, x, y):
    """The three engines at pp = world over the TPU package's test model
    (its state loaded by global names): each engine's loss and gradients
    of one forward_backward_pipeline, 3 train_batch steps of SGD with and
    without a GradScaler, eval_batch, a tied layer on the first and last
    stage, ZB-H1's pullbacks, Fleet's dispatch and the point-to-point
    helpers."""
    dist, rank = _start()
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import amp, nn, optimizer
    from paddle_tpu_torch.core import autograd
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.meta_parallel import (
        PipelineLayer, PipelineParallel, PipelineParallelWithInterleave,
        PipelineParallelZeroBubble)
    from paddle_tpu_torch.distributed.meta_parallel._p2p_communication \
        import p2p_of
    from paddle_tpu_torch.utils import stage_state_dict_from_paddle_tpu

    world = dist.get_world_size()
    strategy, hcg = _pp_strategy(world)
    xt, yt = paddle.to_tensor(x), paddle.to_tensor(y)
    res = {"stage": hcg.get_stage_id()}

    def build(v=1, shared=False):
        model = PipelineLayer(_seq_descs(shared=shared),
                              loss_fn=nn.MSELoss(),
                              num_virtual_pipeline_stages=v)
        whole = shared_state if shared else state
        mine = stage_state_dict_from_paddle_tpu(whole, model)
        res.setdefault("load", []).append(
            (model.set_state_dict(mine), model.set_state_dict(whole),
             len(mine) == len(model.state_dict())))
        return model

    engines = {"1f1b": (PipelineParallel, {}, 1),
               "vpp": (PipelineParallelWithInterleave,
                       {"num_virtual_pipeline_stages": 2}, 2),
               "zb": (PipelineParallelZeroBubble, {}, 1)}
    for name, (cls, kw, v) in engines.items():
        model = build(v)
        eng = cls(model, hcg, strategy=strategy, **kw)
        loss = eng.forward_backward_pipeline((xt, yt))
        res[name] = {"loss": float(loss), "grads": _grads(model),
                     "names": sorted(n for n, _ in model.named_parameters())}
        for use_scaler in (False, True):
            model = build(v)
            eng = cls(model, hcg, strategy=strategy, **kw)
            opt = optimizer.SGD(learning_rate=0.1,
                                parameters=model.parameters())
            scaler = amp.GradScaler(init_loss_scaling=1024.0) \
                if use_scaler else None
            res[name][f"train_{use_scaler}"] = [
                float(eng.train_batch((xt, yt), opt, scaler=scaler))
                for _ in range(3)]
            res[name][f"params_{use_scaler}"] = {
                n: _np(p) for n, p in model.named_parameters()}
        res[name]["eval"] = float(eng.eval_batch((xt, yt),
                                                 compute_loss=True))

    # a tied layer on the first and the last stage
    model = build(shared=True)
    eng = PipelineParallel(model, hcg, strategy=strategy)
    res["shared_loss"] = float(eng.forward_backward_pipeline((xt, yt)))
    model.allreduce_shared_weight_gradients()
    res["shared_grads"] = _grads(model)
    res["firstly_shared"] = {n: bool(p.is_firstly_shared)
                             for n, p in model.named_parameters()}
    # 3 steps of SGD under fleet's optimizer with an active global-norm
    # clip: the norm over every stage, the tied weight counted once
    model = build(shared=True)
    eng = PipelineParallel(model, hcg, strategy=strategy)
    opt = fleet.distributed_optimizer(optimizer.SGD(
        learning_rate=0.1, parameters=model.parameters(),
        grad_clip=optimizer.ClipGradByGlobalNorm(0.05)))
    res["clip_losses"] = [float(eng.train_batch((xt, yt), opt))
                          for _ in range(3)]
    res["clip_params"] = {n: _np(p) for n, p in model.named_parameters()}

    # ZB-H1: B is the input-gradient pullback, W the weights'
    calls, real = [], autograd.grad

    def spy(outputs, inputs, *a, **kw):
        ins = inputs if isinstance(inputs, list) else [inputs]
        calls.append(len(ins))
        return real(outputs, ins, *a, **kw)

    autograd.grad = spy
    try:
        model = build()
        PipelineParallelZeroBubble(model, hcg, strategy=strategy) \
            .forward_backward_pipeline((xt, yt))
    finally:
        autograd.grad = real
    res["zb_calls"] = calls

    # PipelineLayer.forward at pp > 1
    try:
        build()(xt)
        res["forward_error"] = None
    except RuntimeError as e:
        res["forward_error"] = str(e)

    # Fleet's dispatch
    kinds = []
    for extra, v in (({"schedule_mode": "ZBH1"}, 1), ({}, 2), ({}, 1),
                     ({"schedule_mode": "VPP"}, 2)):
        strategy, hcg = _pp_strategy(world, **extra)
        kinds.append(type(fleet.distributed_model(build(v))).__name__)
    res["dispatch"] = kinds

    # the point-to-point helpers, stage 0 with stage 1
    p2p = p2p_of(hcg)
    p2p.begin_batch()
    s = hcg.get_stage_id()
    a = torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10 * s
    like = ((2, 3), torch.float32)
    if s == 0:
        p2p.send_forward(a, "k")
        got = p2p.send_forward_recv_backward(a + 1, "k", like)
        res["p2p"] = [_np(got), _np(p2p.recv_backward(like))]
    elif s == 1:
        first = p2p.recv_forward("k")
        second = p2p.send_backward_recv_forward(a, "k")
        p2p.send_backward(a + 1)
        res["p2p"] = [_np(first), _np(second)]
    p2p.finish()
    _dump(out_dir, rank, res)
    dist.destroy_process_group()


def pipeline_spmd(out_dir, ws, wv, x, g, n_micro):
    """spmd_pipeline (plain, halves, an odd micro-batch) and
    spmd_pipeline_interleaved at pp = world: the last stage's outputs, and
    the gradients of sum(out * g) of each stage's weights and of x."""
    dist, rank = _start()
    from paddle_tpu_torch.distributed.meta_parallel import (
        spmd_pipeline, spmd_pipeline_interleaved)

    world = dist.get_world_size()
    _, hcg = _pp_strategy(world)
    s = hcg.get_stage_id()
    res = {"stage": s}

    def run(fn, w, xs, gs, **kw):
        w = torch.from_numpy(w).requires_grad_(True)
        xs = torch.from_numpy(xs).requires_grad_(True)
        out = fn(w, xs, **kw)
        (out * torch.from_numpy(gs)).sum().backward()
        return {"out": out.detach().numpy().copy(), "dw": w.grad.numpy(),
                "dx": xs.grad.numpy() if xs.grad is not None else None}

    def plain(w, xs, overlap_sends=False):
        return spmd_pipeline(lambda p, h: h @ p, w, xs, n_micro,
                             overlap_sends=overlap_sends)

    res["plain"] = run(plain, ws[s], x, g)
    res["halves"] = run(plain, ws[s], x, g, overlap_sends=True)
    odd = (slice(None), slice(0, 3))
    res["odd"] = run(plain, ws[s], x[odd], g[odd])
    res["odd_halves"] = run(plain, ws[s], x[odd], g[odd], overlap_sends=True)
    res["interleaved"] = run(
        lambda w, xs: spmd_pipeline_interleaved(
            lambda p, h: torch.tanh(h @ p), w, xs, n_micro, wv.shape[1]),
        wv[s], x, g)
    _dump(out_dir, rank, res)
    dist.destroy_process_group()


def trainer_pipeline(out_dir, cfg_dict, np_params, batches, lr, jobs):
    """HybridTrainer over meshes with a 'pp' axis: per job (mesh,
    micro-batches, overlap_sends, remat policy) 3 steps: losses, clip
    norms, the flash forward's calls a step, the gathered state, and this
    rank's replicated leaves; with ``elastic`` a snapshot
    after the second step loaded under dp = world and the third step
    there."""
    dist, rank = _start()
    from paddle_tpu_torch.distributed.fleet import HybridTrainer
    from paddle_tpu_torch.models import llama as TL
    from paddle_tpu_torch.utils import stacked_params_from_paddle_tpu

    res = {}
    for job in jobs:
        cfg = _llama_config(cfg_dict, job.get("policy"))
        tr = HybridTrainer(cfg, job["mesh"], learning_rate=lr,
                           pipeline_micro_batches=job["n_micro"],
                           overlap_sends=job.get("overlap", False),
                           device="cpu")
        mine = TL.leaves(stacked_params_from_paddle_tpu(np_params, tr.hcg))
        with torch.no_grad():
            for name, t in TL.leaves(tr.params).items():
                t.copy_(mine[name])
        out = {"losses": [], "norms": [],
               "coords": tr.hcg.layout().coords,
               "local_shapes": {k: tuple(v.shape) for k, v in
                                TL.leaves(tr.params).items()}}
        with _FlashForwards() as forwards:
            for i, (ids, labels) in enumerate(batches):
                if job.get("elastic") and i == len(batches) - 1:
                    snap = tr.elastic_state()
                out["losses"].append(float(tr.step(ids, labels)))
                out["norms"].append(float(tr.last_grad_norm))
        out["forwards_per_step"] = forwards.n / len(batches)
        out["replicated"] = {k: v.detach().numpy().copy() for k, v in
                             TL.leaves(tr.params).items()
                             if "blocks" not in k}
        out["state"] = tr.elastic_state()
        if job.get("elastic"):
            world = dist.get_world_size()
            dp = HybridTrainer(cfg, {"dp": world}, learning_rate=lr,
                               device="cpu")
            dp.load_elastic_state(snap)
            out["reload_exact"] = all(
                np.array_equal(dp.elastic_state()[k], snap[k]) for k in snap)
            out["dp_loss"] = float(dp.step(*batches[-1]))
            after = dp.elastic_state()
            out["after_gap"] = max(float(np.abs(after[k]
                                                - out["state"][k]).max())
                                   for k in after if k != "step")
        if rank != 0:
            out.pop("state")
        res[job["name"]] = out
    _dump(out_dir, rank, res)
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# sequence-dimension parallelism: ring attention, the sep trainer, SP
# ---------------------------------------------------------------------------

def ring_attention(out_dir, cases):
    """fleet.init at sep = world, then ring_attention_bhsd over its sep
    group for each case
    (q, k, v, the cotangent w [B, H, S, D] whole, and causal): this rank's
    shards in, its O and the gradients of sum(O * w) out; and the kernels'
    launches (none on the CPU)."""
    dist, rank = _start()
    from paddle_tpu_torch import launch_counts, reset_launch_counts
    from paddle_tpu_torch.ops.kernels.ring_attention import \
        ring_attention_bhsd

    world = dist.get_world_size()
    _, hcg = _fleet(dist, sep_degree=world)
    group = hcg.get_sep_parallel_group()
    reset_launch_counts()
    res = {"mode": hcg.get_parallel_mode(), "sep_ranks": group.ranks,
           "neighbours": hcg.get_sep_parallel_neighbours()}
    for name, case in cases.items():
        dtype = getattr(torch, case["dtype"])
        shard = [torch.tensor(case[x]).chunk(world, dim=2)[rank]
                 .to(dtype).contiguous() for x in ("q", "k", "v", "w")]
        q, k, v = (t.requires_grad_(True) for t in shard[:3])
        out = ring_attention_bhsd(q, k, v, group, is_causal=case["causal"])
        (out.float() * shard[3].float()).sum().backward()
        res[name] = {n: _np(t) for n, t in (("o", out), ("dq", q.grad),
                                             ("dk", k.grad), ("dv", v.grad))}
        res[name]["dtypes"] = [str(t.dtype) for t in (out, q.grad, k.grad,
                                                      v.grad)]
    res["launches"] = launch_counts()
    _dump(out_dir, rank, res)
    dist.destroy_process_group()


def trainer_sep(out_dir, cfg_dict, np_params, batches, lr, jobs):
    """HybridTrainer over meshes (with a 'sep' axis, or any): per job
    (mesh, micro-batches, remat policy) 3 steps from the reference's
    parameters: losses, clip norms, the flash forward's calls a step, the
    gathered state (rank 0), whether every leaf is bit for bit equal on
    every rank of this rank's sep group after the steps, and the
    ValueError of a sequence that sep does not divide."""
    dist, rank = _start()
    from paddle_tpu_torch.distributed.fleet import HybridTrainer
    from paddle_tpu_torch.distributed.fleet.layers.mpu.mp_ops import \
        gather_along
    from paddle_tpu_torch.models import llama as TL
    from paddle_tpu_torch.utils import stacked_params_from_paddle_tpu

    res = {}
    for job in jobs:
        cfg = _llama_config(cfg_dict, job.get("policy"))
        tr = HybridTrainer(cfg, job["mesh"], learning_rate=lr,
                           pipeline_micro_batches=job.get("n_micro"),
                           device="cpu")
        mine = TL.leaves(stacked_params_from_paddle_tpu(np_params, tr.hcg))
        with torch.no_grad():
            for name, t in TL.leaves(tr.params).items():
                t.copy_(mine[name])
        out = {"losses": [], "norms": [], "coords": tr.hcg.layout().coords}
        ids, labels = tr.place_batch(*batches[0])
        out["placed"] = tuple(ids.shape)
        with _FlashForwards() as forwards:
            for ids, labels in batches:
                out["losses"].append(float(tr.step(ids, labels)))
                out["norms"].append(float(tr.last_grad_norm))
        out["forwards_per_step"] = forwards.n / len(batches)
        sep = tr.hcg.get_sep_parallel_group()
        out["sep_replicas_equal"] = all(
            all(torch.equal(piece, t) for piece in
                gather_along(t.detach()[None], sep, 0))
            for tree in (tr.params, tr.opt_state["m"], tr.opt_state["v"])
            for t in TL.leaves(tree).values())
        ids, labels = batches[0]
        try:
            tr.place_batch(ids[:, :-1], labels[:, :-1])
        except ValueError as e:
            out["odd_sequence"] = str(e)
        out["state"] = tr.elastic_state()
        if rank != 0:
            out.pop("state")
        res[job["name"]] = out
    _dump(out_dir, rank, res)
    dist.destroy_process_group()


def sequence_parallel(out_dir, x, w, seq_x, seq_w, col_w, col_b, row_w,
                      row_b, bn=None):
    """fleet.init(mp = world): the four SP ops forward and backward on
    torch tensors (ScatterOp also on an eager Tensor), then
    ColumnSequenceParallelLinear -> RowSequenceParallelLinear over this
    rank's slice of ``seq_x`` [S, B, in] with the given full weights, the
    gradient of sum(y * seq_w) with the allreduce hooks registered;
    everything gathered back whole. With ``bn`` (x, cotangent, (weight,
    bias)): a SyncBatchNorm over this rank's slice of the batch, its
    output and its weight's and bias's gradients of sum(y * g)."""
    dist, rank = _start()
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.distributed.fleet import sequence_parallel_utils \
        as SP
    from paddle_tpu_torch.distributed.fleet.layers.mpu.mp_ops import \
        gather_along

    world = dist.get_world_size()
    fleet, hcg = _fleet(dist, mp_degree=world)
    mp = hcg.get_model_parallel_group()
    x, w = torch.tensor(x), torch.tensor(w)
    part = x.shape[0] // world
    mine = slice(rank * part, (rank + 1) * part)
    out = {}

    def run(op, inp, weight, *args):
        inp = inp.clone().requires_grad_(True)
        y = op.apply(inp, *args)
        (y * weight).sum().backward()
        return _np(y), _np(inp.grad)

    out["scatter"] = run(SP.ScatterOp, x, w[mine])
    out["gather"] = run(SP.GatherOp, x[mine], w)
    out["scatter_axis1"] = run(SP.ScatterOp, x, w[:, rank * 2:rank * 2 + 2],
                               1)
    # a rank-dependent input or cotangent, so that the sums show
    out["allgather"] = run(SP.AllGatherOp, x[mine], w * (rank + 1))
    out["reduce_scatter"] = run(SP.ReduceScatterOp, x * (rank + 1), w[mine])
    t = paddle.to_tensor(x.numpy(), stop_gradient=False)
    y = SP.ScatterOp.apply(t)
    (y * paddle.to_tensor(w[mine].numpy())).sum().backward()
    out["scatter_eager"] = (_np(y), _np(t.grad), type(y).__name__)

    col = SP.ColumnSequenceParallelLinear(col_w.shape[0], col_w.shape[1],
                                          has_bias=True)
    row = SP.RowSequenceParallelLinear(row_w.shape[0], row_w.shape[1],
                                       has_bias=True)
    cols = slice(rank * col_w.shape[1] // world,
                 (rank + 1) * col_w.shape[1] // world)
    with torch.no_grad():
        col.weight._value.copy_(torch.tensor(col_w)[:, cols])
        col.bias._value.copy_(torch.tensor(col_b)[cols])
        row.weight._value.copy_(torch.tensor(row_w)[cols])
        row.bias._value.copy_(torch.tensor(row_b))
    model = paddle.nn.LayerList([col, row])
    SP.register_sequence_parallel_allreduce_hooks(model)
    seq_x, seq_w = torch.tensor(seq_x), torch.tensor(seq_w)
    part = seq_x.shape[0] // world
    mine = slice(rank * part, (rank + 1) * part)
    xs = paddle.to_tensor(seq_x[mine].numpy(), stop_gradient=False)
    ys = row(col(xs))
    (ys * paddle.to_tensor(seq_w[mine].numpy())).sum().backward()
    out["pair"] = {
        "y": gather_along(ys._value.detach(), mp, 0).numpy(),
        "x_grad": gather_along(xs.grad._value, mp, 0).numpy(),
        "col_w_grad": gather_along(col.weight.grad._value, mp, 1).numpy(),
        "col_b_grad": gather_along(col.bias.grad._value, mp, 0).numpy(),
        "row_w_grad": gather_along(row.weight.grad._value, mp, 0).numpy(),
        "row_b_grad": row.bias.grad.numpy(),
        "marked": [p.sequence_parallel for p in (col.weight, col.bias,
                                                 row.weight, row.bias)],
        "local_y": tuple(ys.shape)}
    if bn is not None:
        bn_x, bn_g, (bn_w, bn_b) = bn
        part = bn_x.shape[0] // world
        mine = slice(rank * part, (rank + 1) * part)
        layer = paddle.nn.SyncBatchNorm(bn_x.shape[1])
        layer.weight.set_value(bn_w)
        layer.bias.set_value(bn_b)
        y = layer(paddle.to_tensor(bn_x[mine]))
        (y * paddle.to_tensor(bn_g[mine])).sum().backward()
        out["sync_bn"] = {"y": _np(y), "w_grad": _np(layer.weight.grad),
                          "b_grad": _np(layer.bias.grad),
                          "kind": type(layer).__name__,
                          "buffers": (_np(layer._mean),
                                      _np(layer._variance))}
    fleet.barrier_worker()
    _dump(out_dir, rank, out)
    dist.destroy_process_group()


def segment_parallel(out_dir):
    """fleet.init(dp 2, sep 2) and distributed_model of a Linear drawn from
    a seed of each rank's own: the wrapper's kind, the parameters before
    and after it, and its forward against the layer's."""
    dist, rank = _start()
    import paddle_tpu_torch as paddle

    fleet, hcg = _fleet(dist, dp_degree=2, sep_degree=2)
    paddle.seed(100 + rank)
    layer = paddle.nn.Linear(4, 3)
    before = _np(layer.weight)
    model = fleet.distributed_model(layer)
    x = paddle.to_tensor(np.arange(8, dtype=np.float32).reshape(2, 4))
    out = {"mode": hcg.get_parallel_mode(), "kind": type(model).__name__,
           "sep_ranks": hcg.get_sep_parallel_group().ranks,
           "before": before, "after": _np(layer.weight),
           "y": _np(model(x)), "y_inner": _np(layer(x))}
    fleet.barrier_worker()
    _dump(out_dir, rank, out)
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# MoE expert parallelism and the group-sharded stages
# ---------------------------------------------------------------------------

def moe_ep(out_dir, params_np, x, y, steps, lr, scatter):
    """moe_block_stacked over an expert group of the world: rank r holds
    rows r·S/n of x and its E / n experts. The slots of the routing over
    the all-gathered logits; ``steps`` SGD steps of the loss
    mean((out - y)^2) + 0.01·aux on the global batch, each rank's share
    written so that the ranks' losses sum to it (its rows' squared errors
    over S·D, the aux term over n), the wg gradients summed over the
    group: the summed losses, the first step's output rows and aux, the
    parameters after (rank 0, the experts gathered); then global_scatter /
    global_gather of ``scatter``'s rows and their gradient, and the
    ValueErrors."""
    dist, rank = _start()
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.distributed.utils import (global_gather,
                                                    global_scatter)
    from paddle_tpu_torch.incubate.distributed.models import moe as TM

    world = dist.get_world_size()
    group = dist.new_group(list(range(world)))
    rows = x.shape[0] // world
    mine = slice(rank * rows, (rank + 1) * rows)
    xs, ys = torch.from_numpy(x[mine].copy()), torch.from_numpy(y[mine].copy())
    p = {k: v.requires_grad_(True) for k, v in
         TM.moe_params_from_paddle_tpu(params_np, rank, world).items()}
    logits = dist.all_gather(None, xs @ p["wg"].detach(), group=group)
    res = {"slot": TM.topk_sort_dispatch(logits, 1.5, 2)[0].numpy(),
           "losses": []}
    total_rows, d = x.shape
    for step in range(steps):
        out, aux = TM.moe_block_stacked(p, xs, group=group)
        loss = ((out - ys) ** 2).sum() / (total_rows * d) \
            + 0.01 * aux / world
        loss.backward()
        with torch.no_grad():
            dist.all_reduce(p["wg"].grad, group=group)
            for t in p.values():
                t -= lr * t.grad
                t.grad = None
        total = loss.detach().clone()
        dist.all_reduce(total, group=group)
        res["losses"].append(float(total))
        if step == 0:
            res["out0"] = _np(out)
            res["aux0"] = float(aux)
    res["wg"] = _np(p["wg"])
    for key in ("w1", "w2"):
        res[key] = _np(dist.all_gather(None, p[key].detach(), group=group))
    # global_scatter / global_gather: rank r's rows of the global array
    per = scatter.shape[0] // world
    local = torch.from_numpy(scatter[rank * per:(rank + 1) * per].copy())
    counts = torch.full((world * 2,), per // (2 * world), dtype=torch.int64)
    src = local.clone().requires_grad_(True)
    out = global_scatter(src, counts, counts, group=group)
    (out * torch.arange(out.numel(), dtype=torch.float32)
     .reshape(out.shape)).sum().backward()
    res["scattered"] = _np(out)
    res["scatter_grad"] = _np(src.grad)
    res["round_trip"] = _np(global_gather(out, counts, counts, group=group))
    eager = global_scatter(paddle.to_tensor(local.numpy()), None, None,
                           group=group)
    res["eager_kind"] = type(eager).__name__
    res["eager_equal"] = bool(np.array_equal(_np(eager), res["scattered"]))
    errors = {}
    for name, call in (
            ("rows", lambda: global_scatter(local[:-1], None, None,
                                            group=group)),
            ("counts", lambda: global_scatter(
                local, torch.arange(world * 2), counts, group=group)),
            ("experts", lambda: TM.moe_block_stacked(
                {"wg": torch.zeros(x.shape[1], 2 * world + 1),
                 "w1": p["w1"], "w2": p["w2"]}, xs, group=group))):
        try:
            call()
        except ValueError as e:
            errors[name] = str(e)
    res["errors"] = errors
    _dump(out_dir, rank, res)
    dist.destroy_process_group()


def _eager_llama(cfg_dict, state, hcg=None):
    from paddle_tpu_torch.models import llama as TL
    from paddle_tpu_torch.utils import state_dict_from_paddle_tpu

    model = TL.LlamaForCausalLM(TL.LlamaConfig(**cfg_dict))
    missing, unexpected = model.set_state_dict(
        state_dict_from_paddle_tpu(state, hcg))
    assert missing == [] and unexpected == [], (missing, unexpected)
    return model


def _adamw(model, lr):
    from paddle_tpu_torch import optimizer

    return optimizer.AdamW(learning_rate=lr, parameters=model.parameters(),
                           weight_decay=0.1,
                           grad_clip=optimizer.ClipGradByGlobalNorm(1.0))


def _record_clip_norms(opt, norms):
    """Append to ``norms``, each step, the global norm of the gradient that
    ``opt``'s update clips: a hybrid clip's norm as it computes it (Fleet),
    else read after the sharding optimizer's reduction (stage 1 the
    averaged full gradients, stages 2-3 the slices' squares summed over
    its group)."""
    from paddle_tpu_torch.distributed import collective
    from paddle_tpu_torch.distributed.meta_parallel.hybrid_optimizer import \
        _HybridClip

    clip = opt._inner_opt._grad_clip
    if isinstance(clip, _HybridClip):
        norm_of = clip.global_norm

        def global_norm(*args, **kwargs):
            norm = norm_of(*args, **kwargs)
            norms.append(float(norm))
            return norm

        clip.global_norm = global_norm
        return
    reduce = opt.reduce_gradients

    def reduce_gradients():
        reduce()
        if opt.stage == 1:
            grads = [p._value.grad for p in opt._inner_opt._parameter_list
                     if p._value.grad is not None]
        else:
            grads = list(opt._grad_slices.values())
        sq = sum(g.float().square().sum() for g in grads)
        if opt.stage > 1 and opt._n > 1:
            collective.all_reduce(sq, group=opt._group)
        norms.append(float(torch.sqrt(sq)))

    opt.reduce_gradients = reduce_gradients


def _full_moments(opt, model, mp=None):
    """The optimizer's state_dict moments as numpy arrays, each gathered
    over ``mp`` where its parameter is split."""
    from paddle_tpu_torch.distributed.fleet.layers.mpu.mp_ops import \
        gather_along

    params = list(model.parameters())
    out = {}
    for key, v in opt.state_dict().items():
        if key == "_step_count":
            continue
        t = v._value.detach()
        p = params[int(key.split(".")[0][len("param_"):])]
        if mp is not None and getattr(p, "is_distributed", False):
            t = gather_along(t, mp, p.split_axis)
        out[key] = t.float().numpy().copy()
    return out


def _sharded_steps(model, opt, batches, group, rank_in, n):
    """Each step on this sharding rank's rows of the global batch; the
    losses averaged over ``group``."""
    import paddle_tpu_torch as paddle
    import paddle_tpu_torch.distributed as dist

    losses = []
    for ids, labels in batches:
        rows = ids.shape[0] // n
        mine = slice(rank_in * rows, (rank_in + 1) * rows)
        loss = model(paddle.to_tensor(ids[mine]),
                     labels=paddle.to_tensor(labels[mine]))
        loss.backward()
        opt.step()
        opt.clear_grad()
        total = loss.detach()._value.clone()
        if n > 1:
            dist.all_reduce(total, op="avg", group=group)
        losses.append(float(total))
    return losses


def group_sharded(out_dir, cfg_dict, state, batches, lr, jobs):
    """group_sharded_parallel of the eager Llama at each job's level over
    sharding 2 (ranks {0, 1} and {2, 3}, each pair the same job) or 4,
    3 AdamW steps with the global-norm clip: the losses, the clip's norm
    each step, the full state_dict after, each parameter's local storage,
    the optimizer's full moments; with ``reload`` a fresh model and
    optimizer loaded from both state_dicts and one more step beside the
    first's. Then the fleet jobs (fleet.init mp 2 x sharding 2 with
    sharding_configs stage 2 or 3, distributed_model and
    distributed_optimizer): the losses, the clip's norms, and the full
    parameters and moments, gathered over mp. And a Linear of 70 weights
    and 7 biases under "p_g_os" at sharding 4 against AdamW on the ranks'
    mean gradient, its parameters and moments."""
    dist, rank = _start()
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import nn, optimizer
    from paddle_tpu_torch.distributed.fleet.layers.mpu.mp_ops import \
        gather_along
    from paddle_tpu_torch.distributed.meta_parallel import \
        group_sharded_parallel

    pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    world = dist.new_group([0, 1, 2, 3])
    res = {}
    for job in jobs:
        if "fleet" in job:
            continue
        n = job["sharding"]
        group = world if n == 4 else pairs[rank // 2]
        model = _eager_llama(cfg_dict, state)
        model, opt, _ = group_sharded_parallel(model, _adamw(model, lr),
                                               job["level"], group=group)
        norms = []
        _record_clip_norms(opt, norms)
        out = {"losses": _sharded_steps(model, opt, batches, group,
                                        group.rank, n),
               "norms": list(norms)}
        out["local"] = {k: p._value.numel()
                        for k, p in model.named_parameters()}
        sd = model.state_dict()
        out["params"] = {k: _np(v) for k, v in sd.items()}
        osd = opt.state_dict()
        out["moments"] = _full_moments(opt, model)
        out["kind"] = type(model).__name__
        if job.get("reload"):
            again = _eager_llama(cfg_dict, state)
            again, opt2, _ = group_sharded_parallel(
                again, _adamw(again, lr), job["level"], group=group)
            assert again.set_state_dict(sd) == ([], [])
            opt2.set_state_dict(osd)
            out["next_loss"] = _sharded_steps(model, opt, batches[:1],
                                              group, group.rank, n)[0]
            out["reload_loss"] = _sharded_steps(again, opt2, batches[:1],
                                                group, group.rank, n)[0]
            a, b = model.state_dict(), again.state_dict()
            out["reload_gap"] = max(float((a[k]._value - b[k]._value)
                                          .abs().max()) for k in a)
        res[job["name"]] = out
    # an uneven layer at stage 3: 70 weights and 7 biases over 4 ranks
    paddle.seed(3)
    lin = nn.Linear(10, 7)
    paddle.seed(3)
    ref = nn.Linear(10, 7)
    lin_s, lin_opt, _ = group_sharded_parallel(
        lin, optimizer.AdamW(learning_rate=lr, parameters=lin.parameters(),
                             weight_decay=0.1), "p_g_os", group=world)
    ref_opt = optimizer.AdamW(learning_rate=lr, parameters=ref.parameters(),
                              weight_decay=0.1)
    every = np.random.RandomState(100)
    xs_all = [every.rand(4, 4, 10).astype(np.float32) for _ in range(2)]
    for step in range(2):
        (lin_s(paddle.to_tensor(xs_all[step][rank])) ** 2).mean().backward()
        lin_opt.step()
        lin_opt.clear_grad()
        for k in range(4):
            ((ref(paddle.to_tensor(xs_all[step][k])) ** 2).mean()
             * 0.25).backward()
        ref_opt.step()
        ref_opt.clear_grad()
    full = lin_s.state_dict()
    res["uneven"] = {"local": [p._value.numel() for p in lin.parameters()],
                     "w": _np(full["weight"]), "b": _np(full["bias"]),
                     "ref_w": _np(ref.weight), "ref_b": _np(ref.bias),
                     "moments": _full_moments(lin_opt, lin),
                     "ref_moments": _full_moments(ref_opt, ref)}
    for job in jobs:
        if "fleet" not in job:
            continue
        fleet, hcg = _fleet(dist, sharding_configs={"stage": job["stage"]},
                            **job["fleet"])
        model = _eager_llama(cfg_dict, state, hcg)
        model = fleet.distributed_model(model)
        opt = fleet.distributed_optimizer(_adamw(model, lr))
        n = hcg.get_sharding_parallel_world_size()
        norms = []
        _record_clip_norms(opt, norms)
        out = {"losses": _sharded_steps(
            model, opt, batches, hcg.get_sharding_parallel_group(),
            hcg.get_sharding_parallel_rank(), n), "norms": norms}
        mp = hcg.get_model_parallel_group()
        out["moments"] = _full_moments(opt, model, mp)
        sd = model.state_dict()
        out["params"] = {}
        for name, p in model.named_parameters():
            t = sd[name]._value.detach()
            if getattr(p, "is_distributed", False):
                t = gather_along(t, mp, p.split_axis)
            out["params"][name] = t.numpy().copy()
        out["local"] = {k: p._value.numel()
                        for k, p in model.named_parameters()}
        res[job["name"]] = out
    _dump(out_dir, rank, res)
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# auto-parallel (DTensor)
# ---------------------------------------------------------------------------

def _ap_model(cfg_dict, params, unused=False, frozen=()):
    """BertForSequenceClassification (4 classes) on a 2 x 2 dp x mp
    ProcessMesh: the FFN weights sharded on mp as tests/
    test_static_engine.py places them, then the reference's parameters
    loaded into the DTensors (each rank keeps its shard)."""
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.models import bert as TB
    from paddle_tpu_torch.utils import load_params_from_paddle_tpu

    model = TB.BertForSequenceClassification(TB.BertConfig(**cfg_dict),
                                             num_classes=4)
    if unused:
        model.unused = nn.Linear(4, 4)       # a leaf the loss does not reach
    mesh = dist.ProcessMesh(np.arange(4).reshape(2, 2),
                            dim_names=["dp", "mp"])
    for name, p in model.named_parameters():
        if "linear1.weight" in name:
            dist.shard_tensor(p, mesh, [dist.Replicate(), dist.Shard(1)])
        elif "linear2.weight" in name:
            dist.shard_tensor(p, mesh, [dist.Replicate(), dist.Shard(0)])
    load_params_from_paddle_tpu(model, {
        k: v for k, v in params.items()
        if unused or not k.startswith("unused.")})
    for name, p in model.named_parameters():
        if name in frozen:
            p.stop_gradient = True
    return model, mesh


class _CE:
    def __init__(self):
        from paddle_tpu_torch import nn

        self.ce = nn.CrossEntropyLoss()

    def __call__(self, logits, label):
        return self.ce(logits, label)


def _ap_engine(cfg_dict, params, lr, clip=None, **kw):
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch import optimizer

    model, mesh = _ap_model(cfg_dict, params, **kw)
    opt = optimizer.AdamW(learning_rate=lr, parameters=model.parameters(),
                          grad_clip=None if clip is None else
                          optimizer.ClipGradByGlobalNorm(clip))
    engine = dist.auto_parallel.Engine(model, loss=_CE(), optimizer=opt)
    engine.prepare(mesh=mesh)
    return engine, model, opt


def _ap_state(engine):
    """Losses aside: the full parameters and moments of the Engine."""
    from paddle_tpu_torch.core.tensor import full_value

    params = {k: full_value(v).detach().numpy().copy()
              for k, v in engine._params.items()}
    moments = {k: {sk: full_value(sv).numpy().copy()
                   for sk, sv in st.items()}
               for k, st in engine._opt_states.items()}
    return params, moments


def auto_parallel(out_dir, cfg_dict, params, batches, lr, attn):
    """The auto-parallel jobs at 4 gloo ranks on a 2 x 2 dp x mp mesh:
    Engine steps (plain, and with a frozen and an unreached leaf),
    state_dict mid-training, save/load, evaluate/predict, to_static's
    DistModel, reshard/unshard, and SDPA over dp-sharded DTensors."""
    dist, rank = _start()
    import paddle_tpu_torch as paddle

    paddle.set_device("cpu")
    res = {"placements": None}

    def batch(i):
        x, y = batches[i]
        return paddle.to_tensor(x), paddle.to_tensor(y)

    # Engine parity: 3 steps
    engine, model, _ = _ap_engine(cfg_dict, params, lr)
    res["placements"] = {
        k: [type(p).__name__ + (f"({p.dim})" if p.is_shard() else "")
            for p in v.placements]
        for k, v in engine._params.items() if "layers.0." in k}
    res["losses"] = [float(engine.run_step(*batch(i)).numpy())
                     for i in range(3)]
    res["params"], res["moments"] = _ap_state(engine)
    res["step_count"] = engine.optimizer._step_count
    # evaluate / predict, and to_static's DistModel in eval and train mode
    res["eval"] = engine.evaluate([batch(3)])["loss"]
    res["predict"] = engine.predict([(batch(3)[0],)])[0]
    res["cost"] = engine.cost_analysis(*batch(0))
    try:
        engine.dist_main_program("train", *batch(0))
    except NotImplementedError as e:
        res["program"] = str(e)
    model2, mesh = _ap_model(cfg_dict, params)
    from paddle_tpu_torch import optimizer

    opt2 = optimizer.AdamW(learning_rate=lr, parameters=model2.parameters())
    dm = dist.to_static(model2, loss=_CE(), optimizer=opt2, mesh=mesh)
    res["dm_train"] = [float(dm(*batch(i)).numpy()) for i in range(2)]
    dm.eval()
    res["dm_eval"] = float(dm(*batch(3)).numpy())
    dm.train()
    res["dm_train"].append(float(dm(*batch(2)).numpy()))
    sd = dm.state_dict()
    res["dm_state_names"] = sorted(sd)

    # the global-norm clip over the sharded gradients
    engine, model, _ = _ap_engine(cfg_dict, params, lr, clip=0.05)
    res["clip_losses"], res["clip_norms"] = [], []
    for i in range(3):
        res["clip_losses"].append(float(engine.run_step(*batch(i)).numpy()))
        res["clip_norms"].append(float(engine.last_grad_norm))
    res["clip_params"], _ = _ap_state(engine)

    # frozen embedding and an unreached leaf
    frozen = ("bert.embeddings.word_embeddings.weight",)
    engine, model, _ = _ap_engine(cfg_dict, params, lr, unused=True,
                                  frozen=frozen)
    res["fz_losses"] = [float(engine.run_step(*batch(i)).numpy())
                        for i in range(3)]
    sd = engine.state_dict()
    res["fz_params"] = {k: v.numpy() for k, v in sd.items()}

    # state_dict mid-training, then continue; save, load, resume
    engine, model, _ = _ap_engine(cfg_dict, params, lr)
    engine.run_step(*batch(0))
    sd = {k: v.numpy() for k, v in engine.state_dict().items()}
    engine.run_step(*batch(1))
    res["mid_sd"] = sd
    res["mid_after"] = {k: v.numpy()
                        for k, v in model.state_dict().items()}
    path = os.path.join(out_dir, "ckpt")
    engine.save(path, training=True)
    fresh, _, _ = _ap_engine(cfg_dict, params, lr)
    fresh.load(path)
    res["resumed_loss"] = float(fresh.run_step(*batch(2)).numpy())
    res["resumed_params"], res["resumed_moments"] = _ap_state(fresh)

    # fit steps the caller's scheduler after each step (reference
    # static_engine.py:235-255); a mesh that is not the world's raises
    class Halving:
        def __init__(self):
            self.lr, self.steps = lr, 0

        def __call__(self):
            return self.lr

        def step(self):
            self.lr, self.steps = self.lr / 2, self.steps + 1

    engine, model, opt = _ap_engine(cfg_dict, params, lr)
    opt._learning_rate = sched = Halving()
    history = engine.fit([batch(0), batch(1), batch(2)], epochs=1,
                         verbose=0)
    res["fit"] = (history, sched.steps, sched.lr)
    try:
        dist.ProcessMesh([0, 1], dim_names=["x"]).to_device_mesh()
        res["bad_mesh"] = None
    except ValueError as e:
        res["bad_mesh"] = str(e)

    # reshard / unshard, bit for bit
    full = torch.from_numpy(np.arange(48, dtype=np.float32).reshape(8, 6)
                            / 7.0)
    t = dist.shard_tensor(paddle.Tensor(full.clone()), mesh,
                          [dist.Shard(0), dist.Replicate()])
    r1 = dist.reshard(t, mesh, [dist.Replicate(), dist.Replicate()])
    r2 = dist.reshard(r1, mesh, [dist.Replicate(), dist.Shard(1)])
    res["reshard"] = [tuple(t._value.to_local().shape),
                      tuple(r1._value.to_local().shape),
                      tuple(r2._value.to_local().shape)]
    res["reshard_equal"] = all(
        torch.equal(dist.unshard_dtensor(x)._value, full)
        for x in (t, r1, r2)) and np.array_equal(r2.numpy(), full.numpy())

    # attention on dp-sharded q, k, v (kernel shape: the plain versions)
    q, k, v, g, p = attn
    from paddle_tpu_torch.nn import functional as F

    def run(sharded):
        ts = [paddle.to_tensor(a) for a in (q, k, v)]
        if sharded:
            ts = [dist.shard_tensor(x, mesh, [dist.Shard(0),
                                              dist.Replicate()])
                  for x in ts]
        for x in ts:
            x.stop_gradient = False
        paddle.seed(11)
        out = F.scaled_dot_product_attention(*ts, dropout_p=p,
                                             training=True)
        gt = paddle.to_tensor(g)
        if sharded:
            gt = dist.shard_tensor(gt, mesh, [dist.Shard(0),
                                              dist.Replicate()])
        (out * gt).sum().backward()
        return [out.numpy()] + [x.grad.numpy() for x in ts]

    res["attn_sharded"], res["attn_plain"] = run(True), run(False)
    p = 0.0
    res["attn_nodrop"] = run(False)[0]
    _dump(out_dir, rank, res)
    dist.destroy_process_group()
