"""Distributed checkpoint with reshard-on-load (the port's copy of
paddle_tpu/distributed/checkpoint/__init__.py, in its file format).

Reference analog: python/paddle/distributed/checkpoint/
(save_state_dict.py:104, load_state_dict.py, metadata.py —
LocalTensorMetadata/LocalTensorIndex): per-rank shard files + a global
metadata manifest, resharded on load under a different parallel config.

Each process saves ONLY the shards it owns — a DTensor's local shard at its
global offset, once per replica group (the rank at coordinate 0 of every
replicated mesh dimension); a plain tensor or array whole, once (the
coordinator in a multi-process job) — plus a metadata manifest mapping
(tensor, global offset) -> file. Loading assembles each tensor from its
shards by global offset and writes it into the *target* tensor in place, on
its device and, for a DTensor, as this rank's shard of the target's
placements — any source/target mesh combination reshapes correctly because
shards are addressed by global offsets, not ranks.

The files are the reference's: pickled ``{index_key: numpy array}`` shard
files and a pickled ``Metadata`` manifest. A bf16 tensor is written as f32
(exact; numpy has no bf16 without ml_dtypes, which the port does not need),
and a bf16 array the reference wrote loads as bf16. The manifest pickles
under the reference's class names (``paddle_tpu.distributed.checkpoint.
Metadata``, ...), so the reference loads what the port writes; the port
reads those names back as its own classes, importing nothing of
``paddle_tpu``.
"""
from __future__ import annotations

import io
import os
import pickle
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

from .. import env

__all__ = ["save_state_dict", "load_state_dict", "LocalTensorMetadata",
           "LocalTensorIndex", "Metadata"]

# the module the reference's manifest classes live in
_REF_MODULE = "paddle_tpu.distributed.checkpoint"


@dataclass
class LocalTensorMetadata:
    global_offset: Tuple[int, ...]
    local_shape: Tuple[int, ...]
    dtype: str


@dataclass
class LocalTensorIndex:
    tensor_key: str
    global_offset: Tuple[int, ...]


@dataclass
class Metadata:
    state_dict_metadata: Dict[str, List[LocalTensorMetadata]] = \
        field(default_factory=dict)
    storage_metadata: Dict[str, str] = field(default_factory=dict)
    flat_mapping: Dict[str, str] = field(default_factory=dict)


_CLASSES = {c.__name__: c for c in (LocalTensorMetadata, LocalTensorIndex,
                                    Metadata)}
_REF_NAMES = {c: (_REF_MODULE, name) for name, c in _CLASSES.items()}
# numpy stand-ins (same item size) for the ml_dtypes scalar types a
# reference shard may hold; the manifest's dtype string says what the bits
# are
_ML_DTYPES_BITS = {"bfloat16": np.uint16, "float8_e4m3fn": np.uint8,
                   "float8_e5m2": np.uint8}


class _ManifestPickler(pickle._Pickler):
    """Writes the manifest classes under the reference's module name (the
    pure-Python pickler: only it lets a class be saved by another name)."""

    def save_global(self, obj, name=None):
        ref = _REF_NAMES.get(obj)
        if ref is None:
            return super().save_global(obj, name)
        module, qualname = ref
        self.save(module)
        self.save(qualname)
        self.write(pickle.STACK_GLOBAL)
        self.memoize(obj)


class _Unpickler(pickle.Unpickler):
    """Reads the reference's manifest classes as this module's, and an
    ml_dtypes array as its raw bits (see ``_ML_DTYPES_BITS``)."""

    def find_class(self, module, name):
        if module == _REF_MODULE and name in _CLASSES:
            return _CLASSES[name]
        if module.split(".")[0] == "ml_dtypes":
            if name not in _ML_DTYPES_BITS:
                raise pickle.UnpicklingError(
                    f"checkpoint holds an ml_dtypes.{name} array, which "
                    f"this loader does not read")
            return _ML_DTYPES_BITS[name]
        if module.split(".")[0] == "paddle_tpu":
            raise pickle.UnpicklingError(
                f"checkpoint references {module}.{name}")
        return super().find_class(module, name)


def _load_pickle(path: str):
    with open(path, "rb") as f:
        return _Unpickler(f).load()


def _index_key(key: str, offset) -> str:
    return f"{key}@{','.join(str(int(o)) for o in offset)}"


def _atomic_dump(obj, dest: str, manifest: bool = False):
    tmp = f"{dest}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        if manifest:
            buf = io.BytesIO()
            _ManifestPickler(buf, protocol=4).dump(obj)
            f.write(buf.getvalue())
        else:
            pickle.dump(obj, f, protocol=4)
    os.replace(tmp, dest)


def _dtensor_class():
    import sys

    mod = sys.modules.get("torch.distributed.tensor")
    return None if mod is None else mod.DTensor


def _raw(value):
    from ...core.tensor import Tensor

    return value._value if isinstance(value, Tensor) else value


def _host_array(t) -> np.ndarray:
    """A torch tensor's data as a numpy array on the host (bf16 and fp16
    as f32: exact)."""
    import torch

    t = t.detach()
    if t.dtype in (torch.bfloat16, torch.float16):
        t = t.float()
    return t.cpu().numpy()


def _owned_shards(value, rank: int, world: int,
                  coordinator_rank: int) -> List[Tuple[tuple, np.ndarray]]:
    """(global offset, data) of each shard of ``value`` this process
    saves."""
    arr = _raw(value)
    dt = _dtensor_class()
    if dt is not None and isinstance(arr, dt):
        from torch.distributed.tensor import Replicate
        from torch.distributed.tensor._utils import \
            compute_local_shape_and_global_offset

        if any(p.is_partial() for p in arr.placements):
            arr = arr.redistribute(arr.device_mesh, [
                Replicate() if p.is_partial() else p
                for p in arr.placements])
        coord = arr.device_mesh.get_coordinate()
        if coord is None or any(c != 0 for c, p in
                                zip(coord, arr.placements)
                                if not p.is_shard()):
            return []      # a replica of a shard another rank saves
        _, offset = compute_local_shape_and_global_offset(
            arr.shape, arr.device_mesh, arr.placements)
        return [(tuple(int(o) for o in offset),
                 _host_array(arr.to_local()))]
    if world > 1 and rank != coordinator_rank:
        return []
    if hasattr(arr, "detach"):
        data = _host_array(arr)
    else:
        data = np.asarray(arr)
    return [((0,) * data.ndim, data)]


def save_state_dict(state_dict, path, process_group=None,
                    coordinator_rank=0, unique_id=None, async_save=False):
    """Write per-process shard files + metadata manifest (collective in a
    multi-process job: every rank calls it)."""
    os.makedirs(path, exist_ok=True)
    rank = env.global_rank()
    world = env.get_world_size() if env.is_initialized() else 1
    meta = Metadata()
    shards = {}
    for key, value in state_dict.items():
        metas = []
        for offset, data in _owned_shards(value, rank, world,
                                          coordinator_rank):
            metas.append(LocalTensorMetadata(
                offset, tuple(data.shape), str(data.dtype)))
            shards[_index_key(key, offset)] = data
        meta.state_dict_metadata[key] = metas
    shard_file = f"{rank}_0.distcp"
    # tmp + atomic rename: a worker killed mid-save (elastic re-formation
    # SIGTERMs workers) must never leave a truncated shard/metadata file
    # for the re-formed pod to load
    _atomic_dump(shards, os.path.join(path, shard_file))
    # chaos site "save": between shard write and manifest publish — a
    # kill here leaves exactly the torn (manifest-less) directory that
    # resume discovery must skip
    from ..resilience import faults as _faults

    _faults.maybe_arm_from_env()
    act = _faults.injector.on_event("save", rank)
    if act is not None:
        if act.kind == "kill":
            os._exit(act.exit_code)
        elif act.kind == "delay":
            import time

            time.sleep(act.delay_ms / 1e3)
    for key, metas in meta.state_dict_metadata.items():
        for m in metas:
            meta.storage_metadata[_index_key(key, m.global_offset)] = \
                shard_file
    # merge metadata across processes
    if world > 1:
        all_meta = []
        from .. import collective as coll

        coll.all_gather_object(all_meta, meta)
        merged = Metadata()
        for m in all_meta:
            for k, v in m.state_dict_metadata.items():
                merged.state_dict_metadata.setdefault(k, []).extend(v)
            merged.storage_metadata.update(m.storage_metadata)
        meta = merged
    if rank == coordinator_rank:
        _atomic_dump(meta, os.path.join(path, "0.metadata"), manifest=True)
    if world > 1:
        # the manifest exists before any rank returns
        from .. import collective as coll

        coll.barrier()


def _read_metadata(path: str) -> Metadata:
    return _load_pickle(os.path.join(path, "0.metadata"))


def _global_shape(metas) -> List[int]:
    ndim = len(metas[0].local_shape)
    gshape = [0] * ndim
    for m in metas:
        for d in range(ndim):
            gshape[d] = max(gshape[d], m.global_offset[d] + m.local_shape[d])
    return gshape


def _assemble(key: str, meta: Metadata, path: str,
              cache: Dict[str, dict]) -> np.ndarray:
    """The whole of ``key`` from its shards, in the saved dtype (a
    reference bf16 tensor as its uint16 bits: see ``_saved_bf16``)."""
    metas = meta.state_dict_metadata[key]
    if not metas:
        raise KeyError(f"checkpoint at {path} holds no shard of {key!r}")
    gshape = _global_shape(metas)
    dtype = _ML_DTYPES_BITS.get(metas[0].dtype, metas[0].dtype)
    out = np.zeros(gshape, dtype)
    for m in metas:
        fkey = _index_key(key, m.global_offset)
        fname = meta.storage_metadata[fkey]
        if fname not in cache:
            cache[fname] = _load_pickle(os.path.join(path, fname))
        data = cache[fname][fkey]
        slices = tuple(
            slice(o, o + s) for o, s in zip(m.global_offset, m.local_shape))
        out[slices] = data
    return out


def _saved_bf16(meta: Metadata, key: str) -> bool:
    return meta.state_dict_metadata[key][0].dtype == "bfloat16"


def _as_torch(full: np.ndarray, bf16_bits: bool):
    import torch

    # np.ascontiguousarray would make a 0-d array 1-d
    t = torch.from_numpy(full if full.flags.c_contiguous else full.copy())
    return t.view(torch.bfloat16) if bf16_bits else t


def _fill(target, full, key: str):
    """Write the assembled ``full`` into the torch tensor ``target`` in
    place: its dtype and device, and for a DTensor this rank's shard of
    its placements."""
    import torch

    if tuple(full.shape) != tuple(target.shape):
        raise ValueError(f"checkpoint tensor {key!r} has shape "
                         f"{tuple(full.shape)}; the target has "
                         f"{tuple(target.shape)}")
    dt = _dtensor_class()
    with torch.no_grad():
        if dt is not None and isinstance(target, dt):
            from torch.distributed.tensor._utils import \
                compute_local_shape_and_global_offset

            shape, offset = compute_local_shape_and_global_offset(
                target.shape, target.device_mesh, target.placements)
            local = target.to_local()
            piece = full[tuple(slice(o, o + n)
                               for o, n in zip(offset, shape))]
            if any(p.is_partial() for p in target.placements):
                raise ValueError(f"load_state_dict: {key!r} targets a "
                                 f"Partial DTensor")
            local.copy_(piece.to(local.dtype))
        else:
            target.copy_(full.to(target.dtype))


def load_state_dict(state_dict, path, process_group=None,
                    coordinator_rank=0, unique_id=None, offload=False):
    """Fill `state_dict`'s tensors in place, resharding to each tensor's
    CURRENT placements (which may differ from the saved config). A key the
    checkpoint lacks raises KeyError, a shape that differs ValueError. A
    target that is not a tensor (a numpy array, None) is replaced by a
    Tensor of the saved values on the default place."""
    import torch

    from ...core.tensor import Tensor

    meta = _read_metadata(path)
    missing = [k for k in state_dict if k not in meta.state_dict_metadata]
    if missing:
        raise KeyError(f"checkpoint at {path} has no tensor named "
                       f"{missing}")
    cache: Dict[str, dict] = {}
    for key, target in state_dict.items():
        full = _as_torch(_assemble(key, meta, path, cache),
                         _saved_bf16(meta, key))
        raw = _raw(target)
        if isinstance(raw, torch.Tensor):
            _fill(raw, full, key)
        else:
            state_dict[key] = Tensor(full)
    return state_dict
