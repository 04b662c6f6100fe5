"""RoPE and cache append of a paged serving step: the CUDA kernel
(csrc/rope_append.cu) and its plain version.

Replaces the rotation, the casts and the page scatters of
paddle_tpu/incubate/nn/functional/__init__.py::block_multihead_attention
(:655-704, the int8 ``q8`` included), which the TPU package writes as jnp
for XLA to fuse (no Pallas kernel). From a step's packed qkv [T, (HQ + 2
HKV) D] and its metadata (``PagedMetadata``: each token's page, slot and
RoPE angles), one launch a layer rotates q and k (interleaved RoPE in f32,
rounded once to qkv's dtype), writes k and v into slot[t] of page[t] in one
layer of the stacked pools (cast for pages of qkv's dtype; quantized with
an f32 scale a (token, head) for int8 pages, as ``kv_quant`` does) and
returns the rotated q: [T, HQ, D] for the paged kernel, or with
``heads_first`` q, k and v as [HQ, T, D], [HKV, T, D], [HKV, T, D], the
layout the varlen kernel reads (the fresh-prefill step attends over the
unquantized k and v). The kernel rounds as the plain version does, product
by product, so the two agree bit for bit.

The kernel takes float32 and bfloat16 qkv, pages of qkv's dtype or int8
with float32 scale pools, D a multiple of 8 up to 256; other inputs raise.
A step calls it once a layer with the same pools and metadata, so the
wrapper checks those once a step (``_launch``) and calls the library
through its extension module (csrc/pymodule.cu).

The kernel's paged-route call (q out as [T, HQ, D]) is also the registered
op ``paddle_tpu_torch::rope_append``, which declares that it writes the
pools: while tracing (``torch.export`` of the serving step, the deploy
artifact) the wrapper calls the op, whose CUDA implementation is
``_launch`` and CPU implementation the plain version; outside tracing it
launches directly, without the dispatcher's cost. The fresh-prefill layout
(``heads_first``) feeds the varlen kernel, which no traced program reaches
yet (it has no registered op): traced, it raises.
"""
from __future__ import annotations

import weakref
from typing import NamedTuple

import torch

from . import _build
from .kv_quant import _kv_quant_ref

__all__ = ["rope_append"]

# kernel launches since the last reset (ops.kernels.reset_launch_counts)
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}   # pt::kFloat32, kBFloat16
_MAX_D = 256


def _rope(t, cos_h, sin_h):
    """Rotate interleaved pairs of [T, heads, D] at f32 angles [T, 1, D/2]
    (use_neox_style=False in the reference); returns f32."""
    tf = t.float()
    t1, t2 = tf[..., 0::2], tf[..., 1::2]
    return torch.stack([t1 * cos_h - t2 * sin_h,
                        t2 * cos_h + t1 * sin_h], dim=-1).reshape(t.shape)


def _split(qkv, HKV, D):
    """q [T, HQ, D], k and v [T, HKV, D]: views of the packed qkv."""
    T = qkv.shape[0]
    HQ = qkv.shape[1] // D - 2 * HKV
    return (qkv[:, :HQ * D].reshape(T, HQ, D),
            qkv[:, HQ * D:(HQ + HKV) * D].reshape(T, HKV, D),
            qkv[:, (HQ + HKV) * D:].reshape(T, HKV, D))


def _rope_append_ref(qkv, key_cache, value_cache, k_scales, v_scales,
                     layer_idx, md, *, heads_first=False):
    """Plain PyTorch version: RoPE of q and k in f32, cast back to qkv's
    dtype, then k and v scattered into layer ``layer_idx`` of the pools in
    place (cast to the pages' dtype, or quantized by ``_kv_quant_ref`` when
    scale pools are given). Returns q [T, HQ, D], or (q, k, v) heads first
    with ``heads_first``."""
    q, k, v = _split(qkv, key_cache.shape[2], key_cache.shape[-1])
    # rope runs in f32; the cast back precedes the cache scatter
    q = _rope(q, md.cos, md.sin).to(qkv.dtype)
    k = _rope(k, md.cos, md.sin).to(qkv.dtype)
    if k_scales is not None:
        _kv_quant_ref(k, v, key_cache, value_cache, k_scales, v_scales,
                      layer_idx, md.page, md.slot)
    else:
        # in place: [pages, HKV, bs, D] viewed as [pages, bs, HKV, D]
        pool_k, pool_v = key_cache[layer_idx], value_cache[layer_idx]
        pool_k.transpose(1, 2)[md.page, md.slot] = k.to(pool_k.dtype)
        pool_v.transpose(1, 2)[md.page, md.slot] = v.to(pool_v.dtype)
    if heads_first:
        return tuple(t.transpose(0, 1).contiguous() for t in (q, k, v))
    return q


def _check(qkv, key_cache, value_cache, k_scales, v_scales, layer_idx, md):
    """Shapes, dtypes and devices of a call; raises on what no path
    takes."""
    if qkv.dim() != 2 or key_cache.dim() != 5 \
            or value_cache.shape != key_cache.shape:
        raise ValueError("rope_append: qkv [T, (HQ + 2 HKV) D] and stacked "
                         "caches [L, num_blocks, HKV, block_size, D] of one "
                         "shape")
    T = qkv.shape[0]
    L, nb, HKV, bs, D = key_cache.shape
    if D % 2 or qkv.shape[1] % D or qkv.shape[1] // D <= 2 * HKV:
        raise ValueError(f"rope_append: qkv [{T}, {qkv.shape[1]}] is not "
                         f"[T, (HQ + 2 x {HKV}) x {D}] with HQ >= 1, or D "
                         f"is odd")
    if qkv.dtype not in _DTYPES:
        raise TypeError(f"rope_append takes float32 or bfloat16 qkv, not "
                        f"{qkv.dtype}")
    int8 = key_cache.dtype is torch.int8
    if value_cache.dtype is not key_cache.dtype \
            or not (int8 or key_cache.dtype is qkv.dtype):
        raise TypeError(f"rope_append: caches of qkv's dtype or int8, not "
                        f"{key_cache.dtype}, {value_cache.dtype}")
    if (k_scales is None) != (v_scales is None) or (k_scales is None) == int8:
        raise ValueError("rope_append: int8 caches come with both scale "
                         "pools, and only they do")
    if int8 and (k_scales.shape != (L, nb, HKV, bs)
                 or v_scales.shape != k_scales.shape
                 or k_scales.dtype is not torch.float32
                 or v_scales.dtype is not torch.float32):
        raise ValueError("rope_append: scale pools [L, num_blocks, HKV, "
                         "block_size] float32")
    if not 0 <= layer_idx < L:
        raise ValueError(f"rope_append: layer_idx {layer_idx} not in "
                         f"[0, {L})")
    if md.page.shape != (T,) or md.slot.shape != (T,) \
            or md.page.dtype is not torch.int64 \
            or md.slot.dtype is not torch.int64:
        raise ValueError("rope_append: the metadata's page and slot [T] "
                         "int64")
    if any(t.dtype is not torch.float32 or t.numel() != T * (D // 2)
           for t in (md.cos, md.sin)):
        raise ValueError(f"rope_append: the metadata's cos and sin [T, 1, "
                         f"{D // 2}] float32")
    dev = qkv.device
    if any(t is not None and t.device != dev
           for t in (key_cache, value_cache, k_scales, v_scales, md.page,
                     md.slot, md.cos, md.sin)):
        raise ValueError("rope_append: every input on qkv's device")


def _validate(qkv, key_cache, value_cache, k_scales, v_scales, layer_idx,
              md):
    """Every check of a kernel call, and what its launches share while the
    step's inputs stay the same objects: (the pools' base pointers and
    layer strides in bytes, the metadata's pointers, the metadata tensors
    the pointers come from, L, the sizes, the dtype code, the int8 flag),
    or raise."""
    _check(qkv, key_cache, value_cache, k_scales, v_scales, layer_idx, md)
    T = qkv.shape[0]
    L, _, HKV, bs, D = key_cache.shape
    if D % 8 or D > _MAX_D:
        raise ValueError(f"rope_append kernel: D={D} must be a multiple of "
                         f"8 up to {_MAX_D}")
    int8 = key_cache.dtype is torch.int8
    pools = (key_cache, value_cache) + ((k_scales, v_scales) if int8 else ())
    if not all(t.is_contiguous() for t in pools):
        raise ValueError("rope_append kernel: the caches and scale pools "
                         "must be contiguous")
    meta = tuple(t.contiguous() for t in (md.cos, md.sin, md.page, md.slot))
    return (tuple((t.data_ptr(), t.stride(0) * t.element_size())
                  for t in pools),
            tuple(t.data_ptr() for t in meta), meta, L,
            (T, qkv.shape[1] // D - 2 * HKV, HKV, D, bs,
             _DTYPES[qkv.dtype], int(int8)))


# the last validated call: weak references to its step inputs, qkv's
# shape, dtype, device and strides, and _validate's result. A weak
# reference does not keep an engine's pools alive once the engine is
# dropped; a dead one, or one to another object, fails the identity check,
# so such a call is checked in full (ops.kernels.reset_launch_counts also
# clears it)
_step = None


def _launch(qkv, key_cache, value_cache, k_scales, v_scales, layer_idx, md,
            heads_first):
    """The kernel's call. The step's inputs (caches, scale pools and the
    metadata's cos, sin, page and slot) are the same objects for every
    layer of a step, so their checks run once: a call whose inputs are the
    last validated call's, with qkv of the same shape, dtype, device and
    strides, checks only layer_idx; any other call is checked in full."""
    global launches, _step
    inputs = (key_cache, value_cache, k_scales, v_scales, md.cos, md.sin,
              md.page, md.slot)
    key = (qkv.shape, qkv.dtype, qkv.get_device(), qkv.stride())
    st = _step
    if st is None or st[1] != key or not _build.same_inputs(st[0], inputs):
        if qkv.stride(-1) != 1:
            qkv = qkv.contiguous()
            key = (qkv.shape, qkv.dtype, qkv.get_device(), qkv.stride())
        shared = _validate(qkv, key_cache, value_cache, k_scales, v_scales,
                           layer_idx, md)
        st = (tuple(None if t is None else weakref.ref(t) for t in inputs),
              key, shared[:2] + shared[3:])
        # a metadata tensor copied to be contiguous would go stale: no reuse
        _step = st if all(a is b for a, b in zip(
            shared[2], inputs[4:])) else None
    pools, meta, L, sizes = st[2]
    if not 0 <= layer_idx < L:
        raise ValueError(f"rope_append: layer_idx {layer_idx} not in "
                         f"[0, {L})")
    T, HQ, HKV, D = sizes[:4]
    q = torch.empty((HQ, T, D) if heads_first else (T, HQ, D),
                    dtype=qkv.dtype, device=qkv.device)
    k = v = None
    if heads_first:
        k = torch.empty((HKV, T, D), dtype=qkv.dtype, device=qkv.device)
        v = torch.empty((HKV, T, D), dtype=qkv.dtype, device=qkv.device)
    if T:
        if sizes[-1]:
            (kc, ks), (vc, vs), (sk, ss), (sv, _) = pools
            scales = (sk + layer_idx * ss, sv + layer_idx * ss)
        else:
            (kc, ks), (vc, vs) = pools
            scales = (None, None)
        err = _build.py_module().rope_append(
            qkv.data_ptr(), qkv.stride(0), *meta, kc + layer_idx * ks,
            vc + layer_idx * vs, *scales, q.data_ptr(),
            None if k is None else k.data_ptr(),
            None if v is None else v.data_ptr(), *sizes,
            torch._C._cuda_getCurrentRawStream(key[2]))
        _build.check(err, "rope_append")
        launches += 1
    return (q, k, v) if heads_first else q


class _Meta(NamedTuple):
    """The metadata fields the kernel reads (``PagedMetadata``'s page,
    slot, cos and sin), as the registered op receives them."""
    page: torch.Tensor
    slot: torch.Tensor
    cos: torch.Tensor
    sin: torch.Tensor


def _op_cuda(qkv, key_cache, value_cache, k_scales, v_scales, layer_idx,
             cos, sin, page, slot):
    return _launch(qkv, key_cache, value_cache, k_scales, v_scales,
                   layer_idx, _Meta(page, slot, cos, sin), False)


def _op_cpu(qkv, key_cache, value_cache, k_scales, v_scales, layer_idx,
            cos, sin, page, slot):
    md = _Meta(page, slot, cos, sin)
    _check(qkv, key_cache, value_cache, k_scales, v_scales, layer_idx, md)
    return _rope_append_ref(qkv, key_cache, value_cache, k_scales,
                            v_scales, layer_idx, md)


_op = torch.library.custom_op(
    "paddle_tpu_torch::rope_append", _op_cuda,
    mutates_args=("key_cache", "value_cache", "k_scales", "v_scales"),
    device_types="cuda",
    schema="(Tensor qkv, Tensor(a!) key_cache, Tensor(b!) value_cache, "
           "Tensor(c!)? k_scales, Tensor(d!)? v_scales, int layer_idx, "
           "Tensor cos, Tensor sin, Tensor page, Tensor slot) -> Tensor")
_op.register_kernel("cpu")(_op_cpu)


@_op.register_fake
def _rope_append_fake(qkv, key_cache, value_cache, k_scales, v_scales,
                      layer_idx, cos, sin, page, slot):
    _check(qkv, key_cache, value_cache, k_scales, v_scales, layer_idx,
           _Meta(page, slot, cos, sin))
    HKV, D = key_cache.shape[2], key_cache.shape[-1]
    return qkv.new_empty((qkv.shape[0], qkv.shape[1] // D - 2 * HKV, D))


def rope_append(qkv, key_cache, value_cache, k_scales, v_scales, layer_idx,
                md, *, heads_first=False):
    """RoPE of a paged step's q and k, and its k and v written into layer
    ``layer_idx`` of the stacked pools in place. qkv [T, (HQ + 2 HKV) D]
    float32 or bfloat16 (a token's row contiguous, as a GEMM's output
    is); key_cache, value_cache [L, num_blocks, HKV, block_size, D] of
    qkv's dtype, or int8 with the f32 scale pools ``k_scales``,
    ``v_scales`` [L, num_blocks, HKV, block_size] (None for float pages);
    ``md`` the step's ``PagedMetadata`` (page, slot, cos, sin). Returns the
    rotated q [T, HQ, D] in qkv's dtype; with ``heads_first``, (q, k, v)
    as [HQ, T, D], [HKV, T, D], [HKV, T, D] (k rotated, neither
    quantized). A CPU tensor takes the plain version, a CUDA tensor the
    kernel; while tracing, the registered op (q only: ``heads_first``
    raises there)."""
    if torch.compiler.is_compiling():
        if heads_first:
            raise NotImplementedError(
                "rope_append: the fresh-prefill layout feeds the varlen "
                "kernel, which has no registered op; a traced step takes "
                "the paged route")
        return torch.ops.paddle_tpu_torch.rope_append(
            qkv, key_cache, value_cache, k_scales, v_scales, layer_idx,
            md.cos, md.sin, md.page, md.slot)
    if qkv.is_cuda:
        return _launch(qkv, key_cache, value_cache, k_scales, v_scales,
                       layer_idx, md, heads_first)
    _check(qkv, key_cache, value_cache, k_scales, v_scales, layer_idx, md)
    if qkv.device.type == "cpu":
        return _rope_append_ref(qkv, key_cache, value_cache, k_scales,
                                v_scales, layer_idx, md,
                                heads_first=heads_first)
    raise ValueError(f"rope_append: no path for device {qkv.device}")
