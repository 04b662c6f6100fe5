"""Placements (paddle_tpu/distributed/auto_parallel/placement.py;
reference: paddle.distributed.{Shard, Replicate, Partial}).

A list of placements has one entry a mesh dimension, as DTensor's has, so
each maps onto DTensor's placement of the same mesh dimension
(``to_dtensor`` / ``from_dtensor``). ``Partial(reduce_type)`` takes the
reduction by name ("sum", "avg", "max", "min", "prod", "any", "all") or
by its ``ReduceType`` number (kRedSum 0 ... kRedAll 6); DTensor has no
"any" or "all" reduction, and mapping one raises.
"""
from __future__ import annotations

__all__ = ["Placement", "Shard", "Replicate", "Partial", "to_dtensor",
           "from_dtensor"]

# ReduceType's numbers (kRedSum 0 ... kRedAll 6) by name
_REDUCE_NAMES = ("sum", "max", "min", "prod", "avg", "any", "all")
# the reductions DTensor's Partial carries (c10d's names)
_TO_C10D = {"sum": "sum", "max": "max", "min": "min", "prod": "product",
            "avg": "avg"}
_FROM_C10D = {v: k for k, v in _TO_C10D.items()}


class Placement:
    def is_shard(self, dim=None):
        return False

    def is_replicated(self):
        return False

    def is_partial(self):
        return False


class Shard(Placement):
    def __init__(self, dim):
        self.dim = int(dim)

    def is_shard(self, dim=None):
        return dim is None or dim == self.dim

    def get_dim(self):
        return self.dim

    def __eq__(self, other):
        return isinstance(other, Shard) and other.dim == self.dim

    def __hash__(self):
        return hash(("shard", self.dim))

    def __repr__(self):
        return f"Shard(dim={self.dim})"


class Replicate(Placement):
    def is_replicated(self):
        return True

    def __eq__(self, other):
        return isinstance(other, Replicate)

    def __hash__(self):
        return hash("replicate")

    def __repr__(self):
        return "Replicate()"


class Partial(Placement):
    def __init__(self, reduce_type="sum"):
        self.reduce_type = reduce_type

    def is_partial(self):
        return True

    def reduce_name(self) -> str:
        """The reduction's name, whether given by name or by number."""
        r = self.reduce_type
        if isinstance(r, int) and 0 <= r < len(_REDUCE_NAMES):
            return _REDUCE_NAMES[r]
        if isinstance(r, str) and r in _REDUCE_NAMES:
            return r
        raise ValueError(f"Partial: unknown reduce type {r!r}")

    def __eq__(self, other):
        return isinstance(other, Partial) and \
            other.reduce_type == self.reduce_type

    def __hash__(self):
        return hash(("partial", self.reduce_type))

    def __repr__(self):
        return f"Partial({self.reduce_type})"


def to_dtensor(placement):
    """The DTensor placement of one mesh dimension."""
    from torch.distributed import tensor as dt

    if isinstance(placement, Shard):
        return dt.Shard(placement.dim)
    if isinstance(placement, Replicate):
        return dt.Replicate()
    if isinstance(placement, Partial):
        name = placement.reduce_name()
        if name not in _TO_C10D:
            raise NotImplementedError(
                f"Partial({name!r}): DTensor has no {name!r} reduction")
        return dt.Partial(_TO_C10D[name])
    raise TypeError(f"not a placement: {placement!r}")


def from_dtensor(placement):
    """The placement of one mesh dimension from DTensor's."""
    if placement.is_shard():
        return Shard(placement.dim)
    if placement.is_replicate():
        return Replicate()
    if placement.is_partial():
        op = getattr(placement, "reduce_op", "sum")
        if op not in _FROM_C10D:
            raise NotImplementedError(f"DTensor Partial({op!r}) has no "
                                      f"counterpart")
        return Partial(_FROM_C10D[op])
    raise TypeError(f"not a DTensor placement: {placement!r}")
