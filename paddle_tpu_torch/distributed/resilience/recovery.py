"""Elastic checkpoint-resume: restore the last complete checkpoint.

Reference analog: the Gemini-style fast-resume loop — training restarts
(elastic re-formation, preemption, a killed rank) resume from the
latest *consistent* checkpoint rather than step 0.

Builds directly on ``distributed.checkpoint``: each checkpoint is a
``step_<N>`` directory written by ``save_state_dict`` (per-rank shard
files, then the ``0.metadata`` manifest — written LAST and atomically
via tmp+rename, so the manifest's presence IS the completeness marker:
a worker killed mid-save leaves a directory without a manifest, which
discovery skips). Loading goes through ``load_state_dict``'s
reshard-on-load, so a pod that re-formed onto a different parallel
config (fewer hosts, remapped ranks) restores bitwise-identical values
under the new sharding.

Retention: ``save_checkpoint(..., keep=K)`` prunes complete checkpoints
beyond the newest K, and ``sweep_incomplete(root)`` (run at startup and
by ``resume_from_latest``) deletes torn ``step_<N>`` directories lacking
a manifest, so crash debris never accumulates. Both are counted
(``ckpt/pruned`` / ``ckpt/swept_incomplete``).
"""
from __future__ import annotations

import os
import re
import shutil
from typing import Dict, List, Optional, Tuple

from ...profiler import metrics as _metrics
from ..checkpoint import load_state_dict, save_state_dict

__all__ = ["save_checkpoint", "latest_checkpoint", "list_checkpoints",
           "resume_from_latest", "sweep_incomplete", "CKPT_DIR_RE",
           "publish_manifest", "read_manifest", "complete_dirs",
           "sweep_torn_dirs", "MANIFEST_JSON"]

CKPT_DIR_RE = re.compile(r"^step_(\d+)$")
_MANIFEST = "0.metadata"

# ---------------------------------------------------------------------------
# generic manifest-is-completeness-marker helpers
#
# The step_<N> checkpoint pattern above, factored so other snapshot
# families (the serving prefix-cache persistence in
# inference/prefix_cache.py) can reuse it: write every data file first,
# then publish a JSON manifest atomically (tmp+rename) — a directory
# whose manifest is missing is torn by definition and gets swept.
# ---------------------------------------------------------------------------

MANIFEST_JSON = "MANIFEST.json"


def publish_manifest(path: str, payload: Dict) -> str:
    """Atomically publish `payload` as ``MANIFEST.json`` inside `path`.
    Written via tmp+rename so the manifest either exists complete or not
    at all — its presence IS the snapshot's completeness marker. Call it
    LAST, after every data file has landed."""
    import json

    tmp = os.path.join(path, MANIFEST_JSON + ".tmp")
    with open(tmp, "w") as f:
        json.dump(payload, f)
        f.flush()
        os.fsync(f.fileno())
    final = os.path.join(path, MANIFEST_JSON)
    os.replace(tmp, final)
    return final


def read_manifest(path: str) -> Optional[Dict]:
    """The published manifest of snapshot dir `path`, or None when the
    snapshot is torn (no manifest) or unreadable/corrupt."""
    import json

    try:
        with open(os.path.join(path, MANIFEST_JSON)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def complete_dirs(root: str, pattern: "re.Pattern") -> List[Tuple[int, str]]:
    """All COMPLETE snapshot dirs under `root` whose name matches
    `pattern` (one integer group = sequence number), as (seq, path)
    ascending. Complete iff the JSON manifest exists."""
    out = []
    try:
        names = os.listdir(root)
    except OSError:
        return []
    for name in names:
        m = pattern.match(name)
        if not m:
            continue
        path = os.path.join(root, name)
        if os.path.isfile(os.path.join(path, MANIFEST_JSON)):
            out.append((int(m.group(1)), path))
    out.sort()
    return out


def sweep_torn_dirs(root: str, pattern: "re.Pattern",
                    metric: str = "ckpt/swept_incomplete",
                    skip: Optional[str] = None) -> List[str]:
    """Delete torn snapshot dirs (name matches, no manifest) under
    `root`; returns the removed paths. Same caveat as
    ``sweep_incomplete``: never run concurrently with an in-flight save
    (pass its path as `skip`)."""
    removed = []
    try:
        names = os.listdir(root)
    except OSError:
        return removed
    complete = {p for _, p in complete_dirs(root, pattern)}
    for name in names:
        cand = os.path.join(root, name)
        if pattern.match(name) and os.path.isdir(cand) \
                and cand not in complete and cand != skip:
            shutil.rmtree(cand, ignore_errors=True)
            removed.append(cand)
            _metrics.inc(metric)
    return removed


def _step_dir(root: str, step: int) -> str:
    return os.path.join(root, f"step_{step:08d}")


def list_checkpoints(root: str) -> List[Tuple[int, str]]:
    """All COMPLETE checkpoints under `root` as (step, path), ascending.
    A checkpoint is complete iff its manifest exists (the manifest is
    written last, atomically)."""
    out = []
    try:
        names = os.listdir(root)
    except OSError:
        return []
    for name in names:
        m = CKPT_DIR_RE.match(name)
        if not m:
            continue
        path = os.path.join(root, name)
        if os.path.isfile(os.path.join(path, _MANIFEST)):
            out.append((int(m.group(1)), path))
    out.sort()
    return out


def latest_checkpoint(root: str) -> Optional[Tuple[int, str]]:
    """(step, path) of the newest complete checkpoint, or None."""
    found = list_checkpoints(root)
    return found[-1] if found else None


def sweep_incomplete(root: str,
                     skip: Optional[str] = None) -> List[str]:
    """Delete torn ``step_<N>`` directories (no complete manifest: a
    writer killed mid-save) under `root`; returns the removed paths.

    Run at startup / before resume — never concurrently with another
    rank's in-flight ``save_checkpoint`` (a save in progress looks torn
    until its manifest lands; `skip` excludes one path from the sweep
    for exactly that reason)."""
    removed = []
    try:
        names = os.listdir(root)
    except OSError:
        return removed
    complete = {p for _, p in list_checkpoints(root)}
    for name in names:
        cand = os.path.join(root, name)
        if CKPT_DIR_RE.match(name) and os.path.isdir(cand) \
                and cand not in complete and cand != skip:
            shutil.rmtree(cand, ignore_errors=True)
            removed.append(cand)
            _metrics.inc("ckpt/swept_incomplete")
    return removed


def save_checkpoint(state_dict: Dict, root: str, step: int,
                    keep: Optional[int] = None) -> str:
    """Write `state_dict` as the step-`step` checkpoint under `root`.

    Delegates to ``save_state_dict`` (per-rank shards + atomic
    manifest). With `keep`, prunes the oldest complete checkpoints
    beyond the newest `keep` — incomplete directories (no manifest:
    a previous crash mid-save) are always pruned. Returns the
    checkpoint directory path."""
    os.makedirs(root, exist_ok=True)
    path = _step_dir(root, step)
    save_state_dict(state_dict, path)
    from .. import env
    if env.global_rank() == 0:
        sweep_incomplete(root, skip=path)
        if keep is not None and keep > 0:
            for _, old in list_checkpoints(root)[:-keep]:
                if old != path:
                    shutil.rmtree(old, ignore_errors=True)
                    _metrics.inc("ckpt/pruned")
    return path


def resume_from_latest(state_dict: Dict, root: str,
                       sweep: bool = True) -> Optional[int]:
    """Restore `state_dict` in place from the newest complete checkpoint
    under `root`, resharding each tensor to its CURRENT sharding (the
    surviving pod config). Returns the restored step, or None when no
    complete checkpoint exists (caller starts from scratch).

    With `sweep` (default), rank 0 first deletes torn ``step_<N>``
    directories — the startup sweep that keeps crash debris from
    accumulating across restarts.

    This is the resume half of the elastic recovery loop: after the
    launch controller re-forms the pod (dead heartbeat -> membership
    change -> fresh rendezvous), each worker rebuilds its model/optimizer
    state and calls ``resume_from_latest`` so the next train step
    continues with bitwise-identical values."""
    if sweep:
        from .. import env
        if env.global_rank() == 0:
            sweep_incomplete(root)
    found = latest_checkpoint(root)
    if found is None:
        return None
    step, path = found
    load_state_dict(state_dict, path)
    return step
