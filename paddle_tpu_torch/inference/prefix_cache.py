"""Refcounted shared-prefix KV block cache over the serving page pool.

Port of paddle_tpu/inference/prefix_cache.py: requests that share a prompt
prefix map their first N KV pages to the SAME physical pool pages instead
of each prefilling the shared tokens again.

A trie keyed by chained token-block digests: each node covers one FULL
cache block (``block_size`` tokens) and records the page holding that
block's KV, a refcount of live requests sharing it and an LRU tick. The
digest of block i commits to every token of blocks 0..i (blake2b over the
parent digest and the block's tokens), so a node matches only a request
whose whole prefix up to that block is the same, the dependence KV has
(K/V at position t are a function of tokens 0..t). Only full, prompt-
covered blocks are shared, so a shared page is never written again and no
page is copied. ``match`` stops at ``len(prompt) - 1`` tokens: the tip
token's logits must be computed to sample the first generated token.

Ownership: pages enter the cache through ``insert`` (from the request's
private allocation); live requests co-own them by refcount, and the engine
reclaims zero-ref pages through ``evict`` when the free pool runs dry.

Persistence (``save_snapshot`` / ``restore_snapshot``): the trie and the
cache-owned KV pages (and their scales, for an int8 engine) go to a
``cache_<seq>`` directory under a root, page data first (``pages.npz``),
the JSON manifest last by tmp + rename: a directory without its manifest
is torn, which restore ignores and the sweep deletes. The on-disk format is
the reference's, so a snapshot written by the TPU package's engine
restores here; weight versions keep the reference's default version 0.
A snapshot consults the ``cache_save`` chaos site between the page data
and the manifest (a ``kill`` there fells the engine and leaves the torn
directory a real mid-save death leaves), and the cache writes the
reference's ``serving/cache_snapshots``, ``serving/cache_restore_ms`` and
``serving/prefix_hits_restored`` series.
"""
from __future__ import annotations

import hashlib
import os
import re
import shutil
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..profiler import metrics as _metrics

__all__ = ["PrefixCache", "save_snapshot", "restore_snapshot",
           "sweep_snapshots", "latest_snapshot", "CACHE_DIR_RE"]

_m_hits_restored = _metrics.counter("serving/prefix_hits_restored")
_m_restore_ms = _metrics.histogram("serving/cache_restore_ms")
_m_snapshots = _metrics.counter("serving/cache_snapshots")

CACHE_DIR_RE = re.compile(r"^cache_(\d+)$")


class _Node:
    __slots__ = ("page", "refs", "lru", "parent", "children", "restored",
                 "ns", "wv")

    def __init__(self, page: int, parent: Optional[bytes], lru: int,
                 ns: Optional[str] = None, wv: int = 0):
        self.page = page
        self.refs = 1          # created on behalf of the inserting request
        self.lru = lru
        self.parent = parent
        self.children = 0
        self.restored = False  # re-materialized from a disk snapshot
        self.ns = ns           # tenant namespace (None = shared default)
        # weight version whose params produced this block's KV, folded into
        # the digest chain (the reference's; 0 here)
        self.wv = wv


class PrefixCache:
    """Trie of cached full-block KV pages keyed by token-block digests.

    Tenant namespaces: every read and write takes a ``namespace``, whose
    digest chain is rooted at a namespace-seeded key, so the same prompt
    under two tenants lives on disjoint trie paths. ``page_quota`` (the
    default for every namespace) and ``set_quota`` (a per-namespace
    override) bound how many cache pages one namespace may OWN: insert
    stops registering once the namespace is at its quota."""

    def __init__(self, block_size: int,
                 page_quota: Optional[int] = None):
        self.block_size = int(block_size)
        self._nodes: Dict[bytes, _Node] = {}
        self._page_owner: Dict[int, bytes] = {}   # page -> node key
        self._tick = 0
        self.lookups = 0
        self.hits = 0
        self.page_quota = page_quota
        self._quotas: Dict[Optional[str], int] = {}
        self._ns_pages: Dict[Optional[str], int] = {}

    # -- namespaces --------------------------------------------------------
    def set_quota(self, namespace: Optional[str],
                  pages: Optional[int]) -> None:
        """Override the page quota for one namespace (None restores the
        cache-wide default)."""
        if pages is None:
            self._quotas.pop(namespace, None)
        else:
            self._quotas[namespace] = int(pages)

    def _quota(self, namespace: Optional[str]) -> Optional[int]:
        return self._quotas.get(namespace, self.page_quota)

    def namespace_pages(self, namespace: Optional[str]) -> int:
        """Pages currently owned by one namespace's nodes."""
        return self._ns_pages.get(namespace, 0)

    # -- keys --------------------------------------------------------------
    def _chain(self, tokens, n_blocks: int,
               namespace: Optional[str] = None,
               version: int = 0) -> List[bytes]:
        """Chained digests of the first ``n_blocks`` full blocks: the
        digest of block i commits to every token of blocks 0..i, to the
        namespace and, past version 0, to the weight version."""
        bs = self.block_size
        key = b"\x00prefix-root" if namespace is None \
            else b"\x00prefix-root:" + str(namespace).encode()
        if version:
            key += b"\x00wv:" + str(int(version)).encode()
        out = []
        for i in range(n_blocks):
            h = hashlib.blake2b(key, digest_size=16)
            h.update(np.asarray(tokens[i * bs:(i + 1) * bs],
                                np.int64).tobytes())
            key = h.digest()
            out.append(key)
        return out

    # -- read path ---------------------------------------------------------
    def match(self, prompt, namespace: Optional[str] = None,
              version: int = 0
              ) -> Tuple[List[int], List[bytes], int]:
        """Longest cached block chain covering a STRICT prefix of
        ``prompt``; acquires one ref on every matched node. Returns
        ``(pages, node_keys, n_tokens)``; the caller must
        ``release(node_keys)``."""
        self.lookups += 1
        n_max = max(len(prompt) - 1, 0) // self.block_size
        pages: List[int] = []
        held: List[bytes] = []
        for k in self._chain(prompt, n_max, namespace, version):
            node = self._nodes.get(k)
            if node is None:
                break
            node.refs += 1
            self._tick += 1
            node.lru = self._tick
            if node.restored:
                # this block's prefill was saved by a previous engine
                # incarnation: the restart paid no re-prefill for it
                _m_hits_restored.inc()
            held.append(k)
            pages.append(node.page)
        if held:
            self.hits += 1
        return pages, held, len(held) * self.block_size

    def probe(self, prompt, namespace: Optional[str] = None,
              version: int = 0) -> int:
        """How many leading tokens of ``prompt`` a ``match`` would serve
        now, without taking refs, touching LRU ticks or counting a
        lookup."""
        n_max = max(len(prompt) - 1, 0) // self.block_size
        n = 0
        for k in self._chain(prompt, n_max, namespace, version):
            if k not in self._nodes:
                break
            n += 1
        return n * self.block_size

    def release(self, keys) -> None:
        """Drop one ref a key. Zero-ref nodes stay resident until
        ``evict``."""
        for k in keys:
            node = self._nodes.get(k)
            if node is not None and node.refs > 0:
                node.refs -= 1

    # -- write path --------------------------------------------------------
    def insert(self, prompt, pages,
               namespace: Optional[str] = None,
               version: int = 0) -> List[bytes]:
        """Register the FULL prompt blocks backed by ``pages`` (block i at
        ``pages[i]``). Pages of blocks not yet cached pass to the cache;
        the caller holds one ref on each returned (new) key and must
        ``release`` them. Blocks already cached are skipped (the second
        copy stays a private page); registration stops at the namespace's
        page quota, at a page the cache already owns and at a gap in the
        chain."""
        n = min(len(prompt) // self.block_size, len(pages))
        keys = self._chain(prompt, n, namespace, version)
        quota = self._quota(namespace)
        new: List[bytes] = []
        parent: Optional[bytes] = None
        for i, k in enumerate(keys):
            if k in self._nodes:
                parent = k
                continue
            if quota is not None \
                    and self._ns_pages.get(namespace, 0) >= quota:
                break
            page = int(pages[i])
            if page in self._page_owner:
                break
            if parent is not None and parent not in self._nodes:
                break
            self._tick += 1
            self._nodes[k] = _Node(page, parent, self._tick,
                                   ns=namespace, wv=version)
            self._page_owner[page] = k
            self._ns_pages[namespace] = \
                self._ns_pages.get(namespace, 0) + 1
            if parent is not None:
                self._nodes[parent].children += 1
            new.append(k)
            parent = k
        return new

    # -- pool pressure -----------------------------------------------------
    def owned_pages(self) -> Dict[int, bytes]:
        """Pages the cache owns (the engine must not return these to its
        free pool on release)."""
        return self._page_owner

    def evictable_count(self) -> int:
        """Pages reclaimable by eviction now: every zero-ref node (a node's
        refcount is at least any descendant's, so zero-ref subtrees drain
        leaf first)."""
        return sum(1 for n in self._nodes.values() if n.refs == 0)

    def evict(self, n: int) -> List[int]:
        """Free up to ``n`` pages from zero-ref LEAF nodes, LRU first;
        returns the freed page ids for the engine's free pool."""
        freed: List[int] = []
        while len(freed) < n:
            best = None
            for k, node in self._nodes.items():
                if node.refs or node.children:
                    continue
                if best is None or node.lru < self._nodes[best].lru:
                    best = k
            if best is None:
                break
            node = self._nodes.pop(best)
            self._page_owner.pop(node.page, None)
            if self._ns_pages.get(node.ns, 0) > 0:
                self._ns_pages[node.ns] -= 1
            if node.parent is not None and node.parent in self._nodes:
                self._nodes[node.parent].children -= 1
            freed.append(node.page)
        return freed

    # -- introspection -----------------------------------------------------
    def hit_rate(self) -> float:
        return self.hits / self.lookups if self.lookups else 0.0

    def __len__(self) -> int:
        return len(self._nodes)


# ---------------------------------------------------------------------------
# snapshot persistence: cache_<seq>/pages.npz + MANIFEST.json, the manifest
# last and atomic (resilience/recovery.py's helpers)
# ---------------------------------------------------------------------------

def _topo_nodes(cache: PrefixCache):
    """Trie nodes parent before child, so any prefix of the order is a
    consistent trie (restore may stop early and leave every resident node
    reachable)."""
    order = []
    placed = set()
    pending = dict(cache._nodes)
    while pending:
        progressed = False
        for k in list(pending):
            node = pending[k]
            if node.parent is None or node.parent in placed:
                order.append((k, node))
                placed.add(k)
                del pending[k]
                progressed = True
        if not progressed:
            break              # orphaned chain fragment: not snapshotted
    return order


def _savable(t: torch.Tensor) -> np.ndarray:
    """npz-safe host copy of a KV slab: int8 and f32 as they are, bf16
    widened to f32 (exact; restore casts back to the cache dtype)."""
    if t.dtype in (torch.int8, torch.float32):
        return t.cpu().numpy()
    return t.float().cpu().numpy()


def sweep_snapshots(root: str, skip: Optional[str] = None) -> List[str]:
    """Delete torn ``cache_<seq>`` dirs (no manifest) under ``root``;
    returns the removed paths."""
    from ..distributed.resilience import recovery as _rec

    return _rec.sweep_torn_dirs(root, CACHE_DIR_RE,
                                metric="serving/cache_snapshots_swept",
                                skip=skip)


def latest_snapshot(root: str) -> Optional[Tuple[int, str]]:
    """(seq, path) of the newest COMPLETE snapshot under ``root``, or
    None."""
    from ..distributed.resilience import recovery as _rec

    found = _rec.complete_dirs(root, CACHE_DIR_RE)
    return found[-1] if found else None


def save_snapshot(engine, root: str,
                  keep: Optional[int] = None) -> Optional[str]:
    """Snapshot ``engine``'s prefix cache (trie + cache-owned KV pages, and
    their scales for an int8 engine) into a new ``cache_<seq>`` dir under
    ``root``: page data first, the manifest last. With ``keep``, prunes
    complete snapshots beyond the newest ``keep``. Returns the snapshot
    path, or None when the cache is empty or absent."""
    from ..distributed.resilience import recovery as _rec

    cache = engine._prefix_cache
    if cache is None:
        return None
    order = _topo_nodes(cache)
    if not order:
        return None
    os.makedirs(root, exist_ok=True)
    existing = _rec.complete_dirs(root, CACHE_DIR_RE)
    seq = existing[-1][0] + 1 if existing else 0
    path = os.path.join(root, f"cache_{seq:08d}")
    os.makedirs(path, exist_ok=True)

    pages = torch.tensor([node.page for _, node in order],
                         dtype=torch.int64, device=engine._kc.device)
    quant = engine._ks is not None
    slabs = {"kc": _savable(engine._kc[:, pages]),
             "vc": _savable(engine._vc[:, pages])}
    if quant:
        slabs["ks"] = _savable(engine._ks[:, pages])
        slabs["vs"] = _savable(engine._vs[:, pages])
    np.savez(os.path.join(path, "pages.npz"), **slabs)

    # chaos site: a kill here is a death AFTER the page data landed but
    # BEFORE the manifest — exactly the torn snapshot the sweep exists
    # for. The engine (not the process) dies, per the serving-site
    # contract in resilience/faults.py.
    from ..distributed.resilience import faults as _faults
    from ..distributed.resilience.errors import EngineDeadError

    act = _faults.injector.on_event("cache_save",
                                    getattr(engine, "fault_rank", 0))
    if act is not None:
        if act.kind == "kill":
            engine.dead = True
            raise EngineDeadError(getattr(engine, "name", "engine"),
                                  "cache_save")
        if act.kind == "delay":
            time.sleep(act.delay_ms / 1e3)

    key_index = {k: i for i, (k, _) in enumerate(order)}
    _rec.publish_manifest(path, {
        "kind": "prefix_cache",
        "seq": seq,
        "block_size": int(cache.block_size),
        "quant": bool(quant),
        "n_pages": int(pages.numel()),
        "nodes": [{"key": k.hex(),
                   "parent": (node.parent.hex()
                              if node.parent is not None else None),
                   "slab": key_index[k],
                   "ns": node.ns,
                   "wv": node.wv}
                  for k, node in order],
    })
    _m_snapshots.inc()
    if keep is not None and keep > 0:
        for _, old in _rec.complete_dirs(root, CACHE_DIR_RE)[:-keep]:
            if old != path:
                shutil.rmtree(old, ignore_errors=True)
                _metrics.inc("serving/cache_snapshots_pruned")
    return path


def restore_snapshot(engine, root: str, sweep: bool = True) -> int:
    """Restore ``engine``'s prefix cache from the newest complete snapshot
    under ``root``: take free pool pages, write the saved KV (and scales)
    into the engine's pools in place, and rebuild the trie with zero-ref
    restored nodes. Returns the blocks restored (0: no usable snapshot;
    torn ones are ignored and, with ``sweep``, deleted). Stops early,
    consistently, when the free pool cannot hold every saved page; never
    evicts to make room."""
    cache = getattr(engine, "_prefix_cache", None)
    if cache is None or not root:
        return 0
    t0 = time.perf_counter()
    if sweep:
        sweep_snapshots(root)
    found = latest_snapshot(root)
    if found is None:
        return 0
    from ..distributed.resilience import recovery as _rec

    _, path = found
    man = _rec.read_manifest(path)
    if man is None or man.get("kind") != "prefix_cache":
        return 0
    quant = engine._ks is not None
    if int(man["block_size"]) != cache.block_size \
            or bool(man["quant"]) != quant:
        return 0               # engine config changed; snapshot unusable
    try:
        data = np.load(os.path.join(path, "pages.npz"))
    except (OSError, ValueError):
        return 0

    alloc = []                 # (record, pool page)
    seen = set(cache._nodes)
    for rec in man["nodes"]:
        key = bytes.fromhex(rec["key"])
        parent = rec["parent"]
        if key in seen:
            continue           # already resident (warm restart)
        if parent is not None and bytes.fromhex(parent) not in seen:
            continue           # parent not restored: child unreachable
        if not engine._free_pages:
            break              # pool full: partial prefix restore
        alloc.append((rec, engine._free_pages.pop()))
        seen.add(key)
    if not alloc:
        return 0

    dev = engine._kc.device
    idx = torch.tensor([p for _, p in alloc], dtype=torch.int64, device=dev)
    slab = [int(rec["slab"]) for rec, _ in alloc]
    names = ("kc", "vc") + (("ks", "vs") if quant else ())
    with torch.no_grad():
        for name in names:
            pool = getattr(engine, "_" + name)
            pool[:, idx] = torch.from_numpy(
                np.ascontiguousarray(data[name][:, slab])).to(dev, pool.dtype)

    for rec, page in alloc:
        key = bytes.fromhex(rec["key"])
        parent = bytes.fromhex(rec["parent"]) if rec["parent"] else None
        cache._tick += 1
        # "ns"/"wv" absent in older snapshots: the default namespace and
        # the build-time weight version
        node = _Node(int(page), parent, cache._tick, ns=rec.get("ns"),
                     wv=int(rec.get("wv", 0)))
        node.refs = 0          # no live request holds restored blocks
        node.restored = True
        cache._nodes[key] = node
        cache._page_owner[int(page)] = key
        cache._ns_pages[node.ns] = cache._ns_pages.get(node.ns, 0) + 1
        if parent is not None and parent in cache._nodes:
            cache._nodes[parent].children += 1
    _m_restore_ms.observe((time.perf_counter() - t0) * 1e3)
    return len(alloc)
