"""Paged-KV attention of the serving decode, chunked-prefill, prefix-hit
and speculative-verify steps: the CUDA kernel (csrc/paged_attention.cu)
and its plain version.

Replaces the non-fresh route of paddle_tpu/incubate/nn/functional/
__init__.py::block_multihead_attention (:733-761), which the TPU package
writes as jnp for XLA to fuse (no Pallas kernel). Each token t of batch row
t2b[t], at cache position pos[t], attends its own row's cache positions
0..pos[t] (at most max_seq) in its kv-head group, K and V read from the
stacked page pools through the block table. Logits take the cache dtype's
operands with f32 accumulation, scaled by 1/sqrt(D); softmax in f32; the
probabilities are rounded to the cache dtype after normalising, P V
accumulates in f32 and is cast to the cache dtype: the reference's
rounding, which the plain version keeps. bf16 runs on the tensor cores, a
block a query tile of up to 32 tokens of one row sharing one read of its
pages; f32 keeps the CUDA-core kernel. The source note gives the bound and
the design.

The kernel takes float32 and bfloat16 caches, D a multiple of 8 up to 256
and HKV dividing HQ; other inputs raise. Padding tokens (the engine's
trash row, whose block-table row is all page 0) may sit at positions past
max_seq: their keys stop at max_seq, so no read leaves the pool.

Int8 pages (the dynamic int8 cache-KV path, :738-746): int8 pools with
f32 scale pools [L, num_blocks, HKV, bs], q float32 or bfloat16. The
reference dequantizes the gathered view, (code as f32 * scale) rounded to
q's dtype, before the products; the kernel's int8 instantiations and the
plain version do the same, and the rest is as above. Their launches are
counted apart (``launches_int8``).

A step calls the kernel once a layer with the same caches, metadata and
block tables, so the wrapper checks those once a step (``_launch``) and
calls the library through its extension module (csrc/pymodule.cu).

The kernel is also the registered op ``paddle_tpu_torch::paged_attention``:
while tracing (``torch.export`` of the serving step, the deploy artifact)
the wrapper calls the op, whose CUDA implementation is ``_launch`` and CPU
implementation the plain version; outside tracing it launches directly,
without the dispatcher's cost.
"""
from __future__ import annotations

import math
import weakref

import torch

from . import _build

__all__ = ["paged_attention"]

# kernel launches since the last reset (ops.kernels.reset_launch_counts):
# over float32 / bfloat16 pages, and over int8 pages
launches = 0
launches_int8 = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}   # pt::kFloat32, kBFloat16
_MAX_D = 256


def _paged_attention_ref(q, pool_k, pool_v, t2b, pos, block_tables,
                         scales_k=None, scales_v=None):
    """Plain PyTorch version over one layer's pools [num_blocks, HKV, bs,
    D]: gather whole pages into each row's dense view, then attend over ALL
    rows' views at once with every column of another row masked to -inf.
    That equals the reference's per-token gather kd[t2b] ([T, HKV, S, D])
    without materialising it: a masked column adds exactly 0. Int8 pools
    come with their layer's scale pools [num_blocks, HKV, bs]: the gathered
    view is dequantized to q's dtype first, as the reference's."""
    T, HQ, D = q.shape
    HKV = pool_k.shape[1]
    bt = block_tables.long()
    B, max_blocks = bt.shape
    max_seq = max_blocks * pool_k.shape[2]
    kd = pool_k[bt].permute(2, 0, 1, 3, 4).reshape(HKV, B * max_seq, D)
    vd = pool_v[bt].permute(2, 0, 1, 3, 4).reshape(HKV, B * max_seq, D)
    if scales_k is not None:
        sk = scales_k[bt].permute(2, 0, 1, 3).reshape(HKV, B * max_seq, 1)
        sv = scales_v[bt].permute(2, 0, 1, 3).reshape(HKV, B * max_seq, 1)
        kd = (kd.float() * sk).to(q.dtype)
        vd = (vd.float() * sv).to(q.dtype)
    qg = q.reshape(T, HKV, HQ // HKV, D)
    logits = torch.einsum("tkgd,kcd->tkgc", qg.float(), kd.float()) \
        / math.sqrt(D)
    col = torch.arange(B * max_seq, device=q.device)
    valid = ((col // max_seq)[None, :] == t2b[:, None]) \
        & ((col % max_seq)[None, :] <= pos[:, None])          # [T, B*S]
    logits = logits.masked_fill(~valid[:, None, None, :], float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("tkgc,kcd->tkgd", probs.to(q.dtype).float(),
                       vd.float()).to(q.dtype)
    return out.reshape(T, HQ, D)


def _check(q, key_cache, value_cache, layer_idx, t2b, pos, block_tables,
           k_scales, v_scales):
    if q.dim() != 3 or key_cache.dim() != 5 \
            or value_cache.shape != key_cache.shape:
        raise ValueError("paged_attention: q [T, HQ, D] and stacked caches "
                         "[L, num_blocks, HKV, block_size, D] of one shape")
    T, HQ, D = q.shape
    L, nb, HKV, bs, Dc = key_cache.shape
    if (k_scales is None) != (v_scales is None) \
            or (k_scales is None) != (key_cache.dtype is not torch.int8):
        raise ValueError("paged_attention: int8 caches come with both scale "
                         "pools, and only they do")
    if k_scales is not None and (
            k_scales.shape != (L, nb, HKV, bs)
            or v_scales.shape != k_scales.shape
            or k_scales.dtype is not torch.float32
            or v_scales.dtype is not torch.float32
            or k_scales.device != q.device or v_scales.device != q.device):
        raise ValueError("paged_attention: scale pools [L, num_blocks, HKV, "
                         "block_size] float32 on q's device")
    if Dc != D or HQ % HKV:
        raise ValueError(f"paged_attention: q's D={D} must match the "
                         f"caches' {Dc}, and HKV={HKV} divide HQ={HQ}")
    if not 0 <= layer_idx < L:
        raise ValueError(f"paged_attention: layer_idx {layer_idx} not in "
                         f"[0, {L})")
    if t2b.shape != (T,) or pos.shape != (T,) or block_tables.dim() != 2 \
            or any(t.dtype is not torch.int64
                   for t in (t2b, pos, block_tables)):
        raise ValueError("paged_attention: t2b and pos [T] and "
                         "block_tables [B, max_blocks], all int64")
    dev = q.device
    if any(t.device != dev for t in (key_cache, value_cache, t2b, pos,
                                     block_tables)):
        raise ValueError("paged_attention: every input on q's device")


def _validate(q, key_cache, value_cache, layer_idx, t2b, pos, block_tables,
              k_scales, v_scales):
    """Every check of a kernel call, and what its launches share while the
    step's inputs stay the same objects: (the C entry, the int8 flag, the
    pools' base pointers and layer strides in bytes, the index tensors'
    pointers, the sizes, the dtype code, sqrt(D)), or raise."""
    _check(q, key_cache, value_cache, layer_idx, t2b, pos, block_tables,
           k_scales, v_scales)
    T, HQ, D = q.shape
    L, _, HKV, bs, _ = key_cache.shape
    int8 = key_cache.dtype is torch.int8
    if q.dtype not in _DTYPES or value_cache.dtype is not key_cache.dtype \
            or not (int8 or key_cache.dtype is q.dtype):
        raise TypeError(f"paged_attention kernel takes float32 or bfloat16 "
                        f"q with caches of its dtype or int8, not {q.dtype}, "
                        f"{key_cache.dtype}, {value_cache.dtype}")
    if D % 8 or D > _MAX_D:
        raise ValueError(f"paged_attention kernel: D={D} must be a multiple "
                         f"of 8 up to {_MAX_D}")
    pools = (key_cache, value_cache) + ((k_scales, v_scales) if int8 else ())
    if not all(t.is_contiguous() for t in pools):
        raise ValueError("paged_attention kernel: the caches and scale "
                         "pools must be contiguous")
    index = (t2b.contiguous(), pos.contiguous(), block_tables.contiguous())
    mod = _build.py_module()
    return (mod.paged_attention_int8 if int8 else mod.paged_attention, int8,
            tuple((t.data_ptr(), t.stride(0) * t.element_size())
                  for t in pools),
            tuple(t.data_ptr() for t in index), index, L,
            (T, HQ, HKV, D, bs, block_tables.shape[1],
             block_tables.shape[0], _DTYPES[q.dtype], math.sqrt(D)),
            (q.shape, q.dtype, q.get_device()))


# the last validated call: weak references to its step inputs and
# _validate's result. A weak reference does not keep an engine's pools
# alive once the engine is dropped; a dead one, or one to another object,
# fails the identity check, so such a call is checked in full
# (ops.kernels.reset_launch_counts also clears it)
_step = None


def _launch(q, key_cache, value_cache, layer_idx, t2b, pos, block_tables,
            k_scales=None, v_scales=None):
    """The kernel's call. The step's inputs (caches, scale pools, t2b, pos,
    block tables) are the same objects for every layer of a step, so their
    checks run once: a call whose inputs are the last validated call's, q
    of the same shape, dtype and device, checks only layer_idx and q's
    layout; any other call is checked in full."""
    global launches, launches_int8, _step
    inputs = (key_cache, value_cache, t2b, pos, block_tables, k_scales,
              v_scales)
    st = _step
    if st is None or st[1] != (q.shape, q.dtype, q.get_device()) \
            or not _build.same_inputs(st[0], inputs):
        shared = _validate(q, key_cache, value_cache, layer_idx, t2b, pos,
                           block_tables, k_scales, v_scales)
        # the index tensors themselves are not kept: only their pointers
        st = (tuple(None if t is None else weakref.ref(t) for t in inputs),
              shared[-1], shared[:4] + shared[5:-1])
        # an index tensor copied to be contiguous would go stale: no reuse
        _step = st if all(a is b for a, b in zip(
            shared[4], (t2b, pos, block_tables))) else None
    fn, int8, pools, index, L, sizes = st[2]
    if not 0 <= layer_idx < L:
        raise ValueError(f"paged_attention: layer_idx {layer_idx} not in "
                         f"[0, {L})")
    if not q.is_contiguous():
        q = q.contiguous()
    q = _build.aligned16(q)
    out = torch.empty_like(q)
    if sizes[0] == 0:
        return out
    stream = torch._C._cuda_getCurrentRawStream(st[1][2])
    if int8:
        (k, ks), (v, vs), (sk, ss), (sv, _) = pools
        err = fn(q.data_ptr(), k + layer_idx * ks, v + layer_idx * vs,
                 sk + layer_idx * ss, sv + layer_idx * ss, out.data_ptr(),
                 *index, *sizes, stream)
        _build.check(err, "paged_attention_int8")
        launches_int8 += 1
        return out
    (k, ks), (v, vs) = pools
    err = fn(q.data_ptr(), k + layer_idx * ks, v + layer_idx * vs,
             out.data_ptr(), *index, *sizes, stream)
    _build.check(err, "paged_attention")
    launches += 1
    return out


def _plain(q, key_cache, value_cache, layer_idx, t2b, pos, block_tables,
           k_scales=None, v_scales=None):
    """The plain version over the stacked pools, after the call's checks."""
    _check(q, key_cache, value_cache, layer_idx, t2b, pos, block_tables,
           k_scales, v_scales)
    quant = k_scales is not None
    return _paged_attention_ref(
        q, key_cache[layer_idx], value_cache[layer_idx], t2b, pos,
        block_tables, k_scales[layer_idx] if quant else None,
        v_scales[layer_idx] if quant else None)


_op = torch.library.custom_op(
    "paddle_tpu_torch::paged_attention", _launch, mutates_args=(),
    device_types="cuda",
    schema="(Tensor q, Tensor key_cache, Tensor value_cache, int layer_idx, "
           "Tensor t2b, Tensor pos, Tensor block_tables, Tensor? k_scales, "
           "Tensor? v_scales) -> Tensor")
_op.register_kernel("cpu")(_plain)


@_op.register_fake
def _paged_attention_fake(q, key_cache, value_cache, layer_idx, t2b, pos,
                          block_tables, k_scales, v_scales):
    _check(q, key_cache, value_cache, layer_idx, t2b, pos, block_tables,
           k_scales, v_scales)
    return q.new_empty(q.shape)


def paged_attention(q, key_cache, value_cache, layer_idx, t2b, pos,
                    block_tables, k_scales=None, v_scales=None):
    """out [T, HQ, D] in q's dtype: q [T, HQ, D] (RoPE applied, rounded to
    the compute dtype) against layer ``layer_idx`` of the stacked page pools
    [L, num_blocks, HKV, block_size, D] (q's dtype, or int8 with the f32
    scale pools ``k_scales``, ``v_scales`` [L, num_blocks, HKV,
    block_size]); t2b and pos [T] int64 (each token's batch row and cache
    position), block_tables [B, max_blocks] int64. A CPU tensor takes the
    plain version, a CUDA tensor the kernel; while tracing, the registered
    op."""
    if torch.compiler.is_compiling():
        return torch.ops.paddle_tpu_torch.paged_attention(
            q, key_cache, value_cache, layer_idx, t2b, pos, block_tables,
            k_scales, v_scales)
    if q.is_cuda:
        return _launch(q, key_cache, value_cache, layer_idx, t2b, pos,
                       block_tables, k_scales, v_scales)
    if q.device.type == "cpu":
        return _plain(q, key_cache, value_cache, layer_idx, t2b, pos,
                      block_tables, k_scales, v_scales)
    _check(q, key_cache, value_cache, layer_idx, t2b, pos, block_tables,
           k_scales, v_scales)
    raise ValueError(f"paged_attention: no path for device {q.device}")
