"""Global RNG state (paddle_tpu/framework/random.py:86-104).

One explicit ``torch.Generator`` a device, made at its first draw and
seeded from the last ``seed(s)``; initializers and dropout draw from
``generator(device)``. The global torch generators are never seeded or
read here. The numbers differ from the TPU package's jax.random ones:
tests carry weights across instead.
"""
from __future__ import annotations

import torch

__all__ = ["seed", "get_rng_state", "set_rng_state", "generator",
           "default_seed"]

_DEFAULT_SEED = 34342423252
_seed = _DEFAULT_SEED
_generators: dict = {}


def default_seed():
    """The seed before any ``seed(s)`` (io.random_split draws from it, as
    the reference does)."""
    return _DEFAULT_SEED


def seed(s: int):
    """Reseed every device's generator with ``s``."""
    global _seed
    _seed = int(s)
    for g in _generators.values():
        g.manual_seed(_seed)
    return s


def generator(device) -> torch.Generator:
    """The generator of ``device`` (a torch.device)."""
    key = str(torch.device(device))
    g = _generators.get(key)
    if g is None:
        g = torch.Generator(device=device)
        g.manual_seed(_seed)
        _generators[key] = g
    return g


def get_rng_state():
    """(seed, {device: generator state}) of the generators drawn from."""
    return _seed, {k: g.get_state() for k, g in _generators.items()}


def set_rng_state(state):
    global _seed
    _seed, states = state
    for key, g in _generators.items():
        if key not in states:
            g.manual_seed(_seed)
    for key, st in states.items():
        generator(torch.device(key)).set_state(st)
