"""Speculative decoding drafters for the paged serving engine.

Port of paddle_tpu/inference/speculative.py. A drafter proposes k
continuation tokens; the engine verifies the whole proposal in one paged
step (shaped like a chunked-prefill continuation, with logits at every
position: ``PagedCausalLM.forward(all_logits=True)``) and samples every
position under the salt the plain path would use there
(``sampling_salt(seed, rid, n_generated)``), accepting a draft only when
it EQUALS the token sampled at the previous position. The emitted stream
is the non-speculative engine's token for token, greedy or sampled; a bad
proposal costs a wasted verify position, never a wrong token.

- ``NGramDrafter``: model-free; most-recent-wins n-gram backoff over the
  streams the engine served, plus a block table keyed by the prefix
  cache's chained block digests (``PrefixCache._chain``): on a block
  boundary whose chain was seen, the whole remembered next block is
  proposed at once.
- ``DraftModelDrafter``: a small model with ``forward_dense`` rolled out
  greedily for k tokens (O(k * S^2) a proposal through the dense path).
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import torch

from .prefix_cache import PrefixCache

__all__ = ["Drafter", "NGramDrafter", "DraftModelDrafter", "from_env"]


class Drafter:
    """Proposal source for speculative decoding.

    ``propose(tokens, k)`` returns up to ``k`` draft tokens for the
    sequence (prompt + generated so far); ``[]`` makes the verify step a
    plain decode step. ``observe(tokens, start=)`` feeds served streams
    back; ``start`` is the first index not yet observed for this
    sequence."""

    def propose(self, tokens: List[int], k: int) -> List[int]:
        raise NotImplementedError

    def observe(self, tokens: List[int], start: int = 0) -> None:
        return None


class NGramDrafter(Drafter):
    """Model-free drafter over the engine's own served streams.

    Token level: a most-recent-wins table from each length-1..n context to
    the token that last followed it; proposals roll it forward greedily
    with longest-context backoff. Block level (``block_size`` set): the
    chained digest of blocks 0..i maps to the tokens of block i+1, and a
    proposal that starts on a known block boundary emits that whole
    block."""

    def __init__(self, n: int = 3, block_size: Optional[int] = None):
        if n < 1:
            raise ValueError("n-gram order must be >= 1")
        self.n = int(n)
        self._gram: Dict[Tuple[int, ...], int] = {}
        self.block_size = block_size
        # the prefix cache's digest chaining, so block keys here agree with
        # what the cache computes
        self._chainer = PrefixCache(block_size) if block_size else None
        self._blocks: Dict[bytes, List[int]] = {}

    # -- learning --------------------------------------------------------
    def observe(self, tokens, start: int = 0) -> None:
        toks = [int(t) for t in tokens]
        lo = max(1, int(start))
        for j in range(lo, len(toks)):
            for l in range(1, self.n + 1):
                if l > j:
                    break
                self._gram[tuple(toks[j - l:j])] = toks[j]
        if self._chainer is not None:
            bs = self.block_size
            n_full = len(toks) // bs
            if n_full >= 2:
                keys = self._chainer._chain(toks, n_full - 1)
                for i, key in enumerate(keys):
                    self._blocks[key] = toks[(i + 1) * bs:(i + 2) * bs]

    # -- proposing -------------------------------------------------------
    def _next(self, cur: List[int]) -> Optional[int]:
        for l in range(min(self.n, len(cur)), 0, -1):
            t = self._gram.get(tuple(cur[-l:]))
            if t is not None:
                return t
        return None

    def propose(self, tokens, k: int) -> List[int]:
        cur = [int(t) for t in tokens]
        out: List[int] = []
        while len(out) < k:
            blk = None
            if self._chainer is not None:
                bs = self.block_size
                if cur and len(cur) % bs == 0:
                    keys = self._chainer._chain(cur, len(cur) // bs)
                    blk = self._blocks.get(keys[-1])
            if blk is not None:
                take = blk[:k - len(out)]
                out.extend(take)
                cur.extend(take)
                continue
            t = self._next(cur)
            if t is None:
                break
            out.append(t)
            cur.append(t)
        return out


class DraftModelDrafter(Drafter):
    """Greedy rollout of a small draft model's dense reference path.

    ``model`` needs ``forward_dense(input_ids [1, S]) -> [1, S, V]``
    (PagedCausalLM has it) and runs on its parameters' device. Each
    proposal runs the dense path once a drafted token, O(k * S^2): for
    SMALL draft models, where the target's verify step still
    dominates."""

    def __init__(self, model, max_context: int = 256):
        self.model = model
        self.max_context = int(max_context)
        self._vocab = int(model.cfg.vocab_size) \
            if hasattr(model, "cfg") else None

    def refresh(self, params) -> None:
        """Install republished draft weights in place: ``params`` maps the
        draft model's ``named_parameters`` names to arrays or tensors.
        Speculative output stays exact either way (verify samples under
        the target); only the acceptance rate is at stake."""
        own = dict(self.model.named_parameters())
        unknown = sorted(set(params) - set(own))
        if unknown:
            raise KeyError(f"unknown draft parameters {unknown}")
        with torch.no_grad():
            for name, value in params.items():
                own[name].copy_(torch.as_tensor(value))

    def propose(self, tokens, k: int) -> List[int]:
        cur = [int(t) for t in tokens][-self.max_context:]
        if self._vocab is not None and any(
                t >= self._vocab for t in cur):
            return []          # sequence outside the draft vocab
        dev = next(self.model.parameters()).device
        out: List[int] = []
        with torch.inference_mode():
            for _ in range(k):
                ids = torch.tensor([cur], dtype=torch.int64, device=dev)
                logits = self.model.forward_dense(ids)
                nxt = int(logits[0, -1].float().argmax())
                out.append(nxt)
                cur.append(nxt)
        return out


def from_env(engine, default_k: int = 4):
    """Attach a drafter to ``engine`` from the environment:
    ``PT_SPEC_DRAFTER`` is ``off`` (default) or ``ngram``; ``PT_SPEC_K``
    sets the draft length (default ``default_k``). Returns the drafter,
    or None when speculation stays off."""
    kind = os.environ.get("PT_SPEC_DRAFTER", "off").strip().lower()
    if kind in ("", "off", "0", "none"):
        return None
    if kind == "ngram":
        drafter = NGramDrafter(block_size=engine.cfg.block_size)
    else:
        raise ValueError(
            f"PT_SPEC_DRAFTER={kind!r}: expected 'off' or 'ngram' "
            f"(draft-model speculation is attached in code via "
            f"DraftModelDrafter)")
    k = int(os.environ.get("PT_SPEC_K", str(default_k)))
    engine.set_drafter(drafter, k=k)
    return drafter
