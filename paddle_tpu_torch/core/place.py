"""Device placement (paddle_tpu/core/place.py).

A Place is a hashable (device type, id) handle that resolves to a
torch.device. The default place, which creation ops, ``to_tensor``,
``Layer.create_parameter`` and the optimizers' state use, is ``"gpu:0"``:
without CUDA, making a tensor there raises instead of landing on the CPU.
``set_device("cpu")`` selects the CPU (the tests' choice). TPU places are
not carried over.
"""
from __future__ import annotations

import threading

import torch

__all__ = ["Place", "CPUPlace", "CUDAPlace", "get_device",
           "set_device", "get_default_place", "to_torch_device", "place_of"]


class Place:
    __slots__ = ("device_type", "device_id")

    def __init__(self, device_type: str, device_id: int = 0):
        self.device_type = device_type
        self.device_id = device_id

    def __repr__(self):
        if self.device_type == "cpu":
            return "Place(cpu)"
        return f"Place({self.device_type}:{self.device_id})"

    def __eq__(self, other):
        return (isinstance(other, Place)
                and self.device_type == other.device_type
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def is_cpu_place(self):
        return self.device_type == "cpu"

    def is_gpu_place(self):
        return self.device_type == "gpu"


def CPUPlace() -> Place:
    return Place("cpu", 0)


def CUDAPlace(device_id: int = 0) -> Place:
    return Place("gpu", device_id)


class _State(threading.local):
    def __init__(self):
        self.place = Place("gpu", 0)


_state = _State()


def _parse(device: str) -> Place:
    name, _, idx = str(device).partition(":")
    name = name.lower()
    if name in ("gpu", "cuda"):
        return Place("gpu", int(idx) if idx else 0)
    if name == "cpu":
        return Place("cpu", 0)
    raise ValueError(f"unsupported device {device!r}: 'gpu[:i]' or 'cpu'")


def set_device(device: str) -> Place:
    """set_device("gpu"), set_device("gpu:1") (or "cuda:1"),
    set_device("cpu")."""
    _state.place = _parse(device)
    return _state.place


def get_device() -> str:
    p = _state.place
    return "cpu" if p.device_type == "cpu" else f"gpu:{p.device_id}"


def get_default_place() -> Place:
    return _state.place


def to_torch_device(place=None) -> torch.device:
    """A Place, a device string, a torch.device or None (the default
    place) -> torch.device; a GPU place without CUDA raises."""
    from ..ops.kernels import resolve_device

    if place is None:
        place = _state.place
    elif isinstance(place, str):
        place = _parse(place)
    elif isinstance(place, torch.device):
        return resolve_device(place)
    if place.device_type == "cpu":
        return torch.device("cpu")
    return resolve_device(f"cuda:{place.device_id}")


def place_of(t: torch.Tensor) -> Place:
    if t.device.type == "cuda":
        return Place("gpu", t.device.index or 0)
    return Place("cpu", 0)
