"""paddle.save / paddle.load (paddle_tpu/framework/io.py): a pickle of
the nested object with each Tensor as ("__tensor__", numpy array), the
reference's format, so a file either package saved loads in the other.

A bf16 Tensor is saved as f32 (exact; numpy has no bf16 without
ml_dtypes, which the port does not need); a bf16 array the reference saved
(an ml_dtypes array) loads as a bf16 Tensor. ``load`` makes Tensors on the
default place (``return_numpy`` keeps the arrays).
"""
from __future__ import annotations

import os
import pickle

import numpy as np

from ..core.tensor import Tensor

__all__ = ["save", "load", "async_save", "clear_async_save_task_queue"]

_PROTO = 4


def _to_storable(obj):
    if isinstance(obj, Tensor):
        return ("__tensor__", np.asarray(obj.numpy()))
    if isinstance(obj, dict):
        return {k: _to_storable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        t = [_to_storable(v) for v in obj]
        return t if isinstance(obj, list) else tuple(t)
    return obj


def _tensor(arr):
    from ..core.place import to_torch_device
    from ..utils.convert import tensor_from_numpy

    if arr.dtype.name == "bfloat16":
        return Tensor(tensor_from_numpy(arr), place=to_torch_device())
    return Tensor(arr)


def _from_storable(obj, return_numpy=False):
    if isinstance(obj, tuple) and len(obj) == 2 and \
            isinstance(obj[0], str) and obj[0] == "__tensor__":
        return obj[1] if return_numpy else _tensor(obj[1])
    if isinstance(obj, dict):
        return {k: _from_storable(v, return_numpy) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_from_storable(v, return_numpy) for v in obj]
    if isinstance(obj, tuple):
        return tuple(_from_storable(v, return_numpy) for v in obj)
    return obj


def save(obj, path, protocol=_PROTO, **configs):
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(_to_storable(obj), f, protocol=protocol)


def load(path, return_numpy=False, **configs):
    with open(path, "rb") as f:
        obj = pickle.load(f)
    return _from_storable(obj, return_numpy=return_numpy)


_async_tasks = []


def async_save(obj, path, protocol=_PROTO, sync_other_task=False,
               **configs):
    """Take a host copy of ``obj`` now and write it on a background thread
    (the caller may change the parameters right after the call); each call
    writes a temporary file of its own and renames it over ``path``."""
    import tempfile
    import threading

    if sync_other_task:
        clear_async_save_task_queue()
    snapshot = _to_storable(obj)

    def work():
        d = os.path.dirname(path) or "."
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                pickle.dump(snapshot, f, protocol=protocol)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    _async_tasks[:] = [t for t in _async_tasks if t.is_alive()]
    t = threading.Thread(target=work, daemon=True)
    t.start()
    _async_tasks.append(t)
    return t


def clear_async_save_task_queue():
    """Block until every queued async save has finished."""
    while _async_tasks:
        _async_tasks.pop().join()
