"""The eager Tensor (paddle_tpu/core/tensor.py).

A Tensor wraps one ``torch.Tensor`` (``_value``), as the TPU package's
wraps one jax array. It is not a torch.Tensor subclass: torch records the
autograd graph on ``_value`` itself, so ``stop_gradient`` is the inverse of
``requires_grad``, ``.grad`` wraps ``_value.grad`` and ``backward()`` is
``torch.autograd.backward`` on the wrapped roots. The op methods
(``t.reshape``, ``t + u``, ...) are patched on by
``paddle_tpu_torch.ops.patch_tensor_methods`` at import time.

Under auto-parallel ``_value`` may be a DTensor. ``numpy()``, ``item()``
and ``tolist()`` then give the full array, as ``np.asarray`` of a sharded
jax array does (a collective: every rank of the mesh calls them), and
``set_value`` takes a full value and keeps this rank's shard of it.
"""
from __future__ import annotations

import numpy as np
import torch

from .dtype import convert_dtype, dtype_name
from .place import Place, place_of, to_torch_device

__all__ = ["Tensor", "Parameter", "to_torch", "dtensor_class", "full_value",
           "shard_of", "replication_scope"]


def dtensor_class():
    """torch's DTensor class once torch.distributed.tensor is imported
    (by whoever made a DTensor), else None: until then nothing is one."""
    import sys

    mod = sys.modules.get("torch.distributed.tensor")
    return None if mod is None else mod.DTensor


def replication_scope(tensors):
    """DTensor's ``implicit_replication()`` where one of ``tensors`` is a
    DTensor (a plain tensor met beside one, in the ops or their backward,
    is taken as replicated), else a null context."""
    import contextlib

    dt = dtensor_class()
    if dt is None or not any(isinstance(t, dt) for t in tensors):
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication

    return implicit_replication()


def full_value(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself, or the full tensor of a DTensor (gathered)."""
    dt = dtensor_class()
    if dt is not None and isinstance(t, dt):
        return t.full_tensor()
    return t


def shard_of(full: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's shard of ``full`` as a DTensor on the DeviceMesh
    ``mesh`` with ``placements`` (DTensor's; sliced here, nothing sent).
    A Partial mesh dimension keeps the value on its first rank and the
    reduction's identity elsewhere."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    shape, offset = compute_local_shape_and_global_offset(full.shape, mesh,
                                                          placements)
    local = full[tuple(slice(o, o + n) for o, n in zip(offset, shape))]
    coord = mesh.get_coordinate()
    for i, p in enumerate(placements):
        if p.is_partial() and coord[i] != 0:
            op = getattr(p, "reduce_op", "sum")
            if op == "sum":
                local = torch.zeros_like(local)
            elif op == "product":
                local = torch.ones_like(local)
    # a copy: a view would keep the whole full tensor alive
    local = local.clone(memory_format=torch.contiguous_format)
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=full.shape,
                              stride=torch.empty(full.shape,
                                                 device="meta").stride())


def to_torch(data, dtype=None, place=None) -> torch.Tensor:
    """Any array-like (Tensor, torch.Tensor, numpy array, list, scalar) ->
    a torch.Tensor of ``dtype`` (kept when None) on ``place`` (a
    torch.Tensor stays where it is when None; host data goes to the default
    place). Python ints become int64 and floats float32, Paddle's defaults;
    numpy arrays keep their dtype."""
    if isinstance(data, Tensor):
        data = data._value
    d = convert_dtype(dtype)
    if isinstance(data, torch.Tensor):
        t = data
        if place is not None:
            t = t.to(to_torch_device(place))
    else:
        if d is None and not isinstance(data, np.ndarray):
            probe = np.asarray(data)
            if probe.dtype == np.float64:
                d = torch.float32
            elif probe.dtype.kind in "iu":
                d = torch.int64
        arr = np.asarray(data)
        if arr.dtype == object:
            raise TypeError(f"cannot make a tensor of {type(data)}")
        t = torch.from_numpy(np.array(arr, copy=True))
        t = t.to(to_torch_device(place))
    if d is not None and t.dtype != d:
        t = t.to(d)
    return t


class Tensor:
    # _dist_attr: the mesh and placements auto_parallel.shard_tensor gave
    # this Tensor (unset otherwise)
    __slots__ = ("_value", "name", "persistable", "_dist_attr",
                 "__weakref__")

    def __init__(self, data, dtype=None, place=None, stop_gradient=True,
                 name=None, persistable=False):
        self._value = to_torch(data, dtype, place)
        self.name = name
        self.persistable = persistable
        if not stop_gradient:
            self.stop_gradient = False

    @classmethod
    def _wrap(cls, t: torch.Tensor) -> "Tensor":
        """A Tensor over ``t`` as it is (no copy, no conversion)."""
        out = object.__new__(cls)
        out._value = t
        out.name = None
        out.persistable = False
        return out

    # -- properties ---------------------------------------------------------
    @property
    def shape(self):
        return list(self._value.shape)

    @property
    def ndim(self):
        return self._value.dim()

    def dim(self):
        return self._value.dim()

    @property
    def dtype(self):
        return self._value.dtype

    @property
    def size(self):
        return self._value.numel()

    def numel(self):
        return self._value.numel()

    @property
    def place(self) -> Place:
        return place_of(self._value)

    @property
    def is_leaf(self):
        return self._value.is_leaf

    # -- autograd -----------------------------------------------------------
    @property
    def stop_gradient(self):
        return not self._value.requires_grad

    @stop_gradient.setter
    def stop_gradient(self, value):
        t = self._value
        if not value:
            if not t.requires_grad:
                if not (t.is_floating_point() or t.is_complex()):
                    raise TypeError(f"a {dtype_name(t.dtype)} tensor "
                                    f"cannot take a gradient")
                t.requires_grad_(True)
        elif t.requires_grad:
            if t.is_leaf:
                t.requires_grad_(False)
            else:
                # a non-leaf stops the gradient from here on
                self._value = t.detach()

    @property
    def grad(self):
        t = self._value
        if not t.is_leaf and not t.retains_grad:
            return None
        g = t.grad
        return None if g is None else Tensor._wrap(g)

    @grad.setter
    def grad(self, value):
        self._value.grad = None if value is None else to_torch(
            value, place=self._value.device)

    def backward(self, grad_tensor=None, retain_graph=False):
        from . import autograd

        autograd.backward([self], None if grad_tensor is None
                          else [grad_tensor], retain_graph=retain_graph)

    def detach(self):
        out = Tensor._wrap(self._value.detach())
        out.name = self.name
        return out

    def clear_grad(self, set_to_zero: bool = False):
        g = self._value.grad
        if set_to_zero and g is not None:
            g.zero_()
        else:
            self._value.grad = None

    # -- conversion ---------------------------------------------------------
    def numpy(self):
        """A host numpy copy; bfloat16 (which numpy lacks) as float32."""
        t = full_value(self._value.detach())
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()

    def item(self, *args):
        if args:
            return self.numpy().item(*args)
        return full_value(self._value.detach()).item()

    def tolist(self):
        return full_value(self._value.detach()).tolist()

    def astype(self, dtype):
        from .dispatch import apply

        d = convert_dtype(dtype)
        return apply(lambda x: x.to(d), self, op_name="cast")

    def to(self, *args, **kwargs):
        """to(dtype), to(place), to("cpu"|"gpu:0"), to(device, dtype)."""
        out = self
        for a in list(args) + list(kwargs.values()):
            if a is None:
                continue
            if isinstance(a, (Place, torch.device)) or (
                    isinstance(a, str) and a.split(":")[0] in
                    ("cpu", "gpu", "cuda")):
                out = Tensor._wrap(out._value.to(to_torch_device(a)))
            else:
                out = out.astype(a)
        return out

    def cpu(self):
        return self.to("cpu")

    def cuda(self, device_id=0, blocking=True):
        return self.to(f"gpu:{device_id}")

    def clone(self):
        from .dispatch import apply

        return apply(torch.clone, self, op_name="clone")

    # -- mutation (gradient-free, in place on the wrapped tensor) ----------
    def set_value(self, value):
        """Replace the values, keeping shape, dtype and device (a DTensor's
        placements too: ``value`` is the full value, or a DTensor)."""
        dt = dtensor_class()
        target = self._value
        if dt is not None and isinstance(value, Tensor) \
                and isinstance(value._value, dt):
            value = value._value
        if dt is not None and isinstance(value, dt):
            value = value.full_tensor() if not isinstance(target, dt) else \
                value.redistribute(target.device_mesh, target.placements)
        v = to_torch(value, place=target.device)
        if tuple(v.shape) != tuple(target.shape):
            raise ValueError(f"set_value shape mismatch: {tuple(v.shape)} "
                             f"vs {tuple(target.shape)}")
        with torch.no_grad():
            if dt is not None and isinstance(target, dt):
                if not isinstance(v, dt):
                    v = shard_of(v.to(target.dtype), target.device_mesh,
                                 target.placements)
                target.to_local().copy_(v.to_local())
            else:
                target.copy_(v)
        return self

    def copy_(self, other, blocking=True):
        return self.set_value(other)

    # -- indexing -----------------------------------------------------------
    def __getitem__(self, idx):
        from .dispatch import apply

        idx = _unwrap_index(idx)
        return apply(lambda x: x[idx], self, op_name="getitem")

    def __setitem__(self, idx, value):
        # out of place, then rebound (tensor.py:255-274): gradients flow to
        # the old value and to ``value``
        idx = _unwrap_index(idx)
        v = to_torch(value, place=self._value.device)
        out = self._value.clone()
        out[idx] = v.to(out.dtype)
        self._value = out

    # -- misc ---------------------------------------------------------------
    def __len__(self):
        if self._value.dim() == 0:
            raise TypeError("len() of a 0-d tensor")
        return self._value.shape[0]

    def __bool__(self):
        return bool(self._value.detach())

    def __int__(self):
        return int(self._value.detach())

    def __float__(self):
        return float(self._value.detach())

    def __index__(self):
        return int(self._value.detach())

    __hash__ = object.__hash__

    def __repr__(self):
        grad = "" if self.stop_gradient else ", stop_gradient=False"
        data = np.array2string(self.numpy(), precision=6, separator=", ")
        return (f"Tensor(shape={self.shape}, dtype="
                f"{dtype_name(self.dtype)}, place={self.place}{grad},\n"
                f"       {data})")

    def __array__(self, dtype=None, copy=None):
        arr = self.numpy()
        return arr.astype(dtype) if dtype is not None else arr


def _unwrap_index(idx):
    if isinstance(idx, Tensor):
        return idx._value
    if isinstance(idx, tuple):
        return tuple(_unwrap_index(i) for i in idx)
    if isinstance(idx, list):
        return [_unwrap_index(i) for i in idx]
    return idx


class Parameter(Tensor):
    """A trainable leaf Tensor (paddle_tpu/core/tensor.py:412): its
    ``_value`` is a leaf torch tensor with ``requires_grad = trainable``.
    A model-parallel layer's parameter holds this rank's shard and says so
    (mp_layers.py:_shard_param): ``is_distributed`` True and
    ``split_axis`` the axis its full array is split on. A pipeline's shared
    weight (pp_layers.py) is held by every stage that uses it, and
    ``is_firstly_shared`` is True on the first of them only (a global-norm
    clip counts it there). ``sequence_parallel`` marks a parameter whose
    gradient each mp rank computes from its slice of the sequence
    (fleet/sequence_parallel_utils.py). ``_stage3`` is the record of a
    parameter held as this rank's slice between steps (ZeRO stage 3,
    distributed/meta_parallel/sharding_optimizer.py), None otherwise."""

    __slots__ = ("is_distributed", "split_axis", "is_firstly_shared",
                 "sequence_parallel", "_stage3")

    def __init__(self, data, dtype=None, name=None, trainable=True,
                 place=None):
        super().__init__(data, dtype=dtype, place=place, name=name,
                         persistable=True)
        self._value = self._value.detach()
        self._value.requires_grad_(bool(trainable))
        self.is_distributed = False
        self.split_axis = None
        self.is_firstly_shared = True
        self.sequence_parallel = False
        self._stage3 = None

    @property
    def trainable(self):
        return self._value.requires_grad

    @trainable.setter
    def trainable(self, value):
        self._value.requires_grad_(bool(value))

    def _replace(self, t: torch.Tensor):
        """Rebind to ``t`` (a dtype or device move), keeping a leaf with
        this parameter's requires_grad."""
        self._value = t.detach().requires_grad_(self._value.requires_grad)

    def __repr__(self):
        return "Parameter containing:\n" + super().__repr__()
