"""Eager cross-process tensor transport (the port's copy of
paddle_tpu/distributed/transport.py, on the same wire format: a rank of
either package talks to a rank of the other).

Reference analog: the CPU ProcessGroupGloo
(paddle/fluid/distributed/collective/process_group_gloo.h:34)
and the NCCL ProcessGroup's send/recv surface
(process_group.h:118-178) — the paths the reference uses when a collective
runs on *eager* (non-captured) tensors.

Here the hot path's collectives run over NCCL (collective.py). This module
is the correctness-bearing eager/control-plane path for multi-process jobs
(the elastic supervisor's snapshot ring and its step collectives): a full
peer-to-peer TCP mesh between ranks carrying raw tensor bytes with a JSON
header (never pickle), rendezvoused through the TCPStore. It carries numpy
arrays and torch tensors: the header names the dtype (and, for a torch
tensor, ``"lib": "torch"``), and the receiver rebuilds the same kind, a
bf16 tensor as bf16 (``torch.frombuffer``). A collective returns the kind
it was given, a torch tensor on the device it came from.

Topology per collective (eager path = small tensors, correctness first):
  - send/recv: direct peer socket, tag-sequenced per (src, dst, group).
  - broadcast: root fans out.
  - reduce / all_reduce: star onto the root, reduce on host, fan out
    (all_reduce) or keep at dst (reduce).
  - all_gather / gather: everyone -> root, root concatenates, fans out
    (all_gather) or keeps (gather).
  - scatter: src sends piece i to rank i.
  - all_to_all: pairwise exchange, deterministic peer order.
  - barrier: generation-counted store barrier.

Fault tolerance (resilience/): every data frame carries a CRC32 and a
per-peer frame sequence number and is ACKed by the receiver. The sender
retransmits on NAK (CRC mismatch), ack timeout, or connection loss —
redialing with exponential backoff — and the receiver dedups retried
frames by (src, fseq), so retransmits are idempotent. Failures surface
as the structured errors in resilience/errors.py, never a silent hang:
recv deadlines raise TransportTimeoutError naming the missing tag, a
corrupted frame that survives the retransmit budget raises
FrameCorruptError, an unreachable peer raises PeerUnreachableError.
The resilience/faults.py chaos injector hooks the send/dial/recv sites
(armed via PT_FAULT_PLAN) so all of this is exercised by tests on the
CPU. Retry traffic is counted in the metrics registry (comm/retries,
comm/redials, comm/corrupt_frames, comm/dup_frames).

The hub/star topologies above are rank-asymmetric BY DESIGN: this module
is the transport that *implements* eager collectives, and every branch's
send is matched by the peer's recv at the protocol level.
"""
from __future__ import annotations

import json
import os
import socket
import sys
import struct
import threading
import time
import zlib
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from ..profiler import metrics as _metrics
from .resilience import faults as _faults
from .resilience.backoff import delay as _backoff_delay
from .resilience.errors import (FrameCorruptError, PeerUnreachableError,
                                TransportClosedError, TransportError,
                                TransportTimeoutError)
from .store import TCPStore, _recv_exact, connect_store

__all__ = ["TensorTransport", "init_transport", "get_transport",
           "install_transport", "shutdown_transport"]

# retry/backoff knobs (env-overridable; see README "Fault tolerance")
_MAX_RETRIES = int(os.environ.get("PT_TRANSPORT_MAX_RETRIES", "5"))

_m_retries = _metrics.counter("comm/retries")
_m_redials = _metrics.counter("comm/redials")
_m_corrupt = _metrics.counter("comm/corrupt_frames")
_m_dup = _metrics.counter("comm/dup_frames")


def _torch():
    """torch when this process has imported it (a torch tensor can only
    come from such a process), else None: the transport itself never
    imports torch for numpy traffic."""
    return sys.modules.get("torch")


def _is_torch(x) -> bool:
    t = _torch()
    return t is not None and isinstance(x, t.Tensor)


def _dtype_to_name(dt) -> str:
    return np.dtype(dt).name


def _name_to_dtype(name: str):
    return np.dtype(name)


def _to_host(arr):
    """A contiguous host array of ``arr``'s kind: a torch tensor stays a
    torch tensor (on the CPU), anything else becomes a numpy array."""
    if _is_torch(arr):
        return arr.detach().to("cpu").contiguous()
    return np.ascontiguousarray(np.asarray(arr))


def _encode(arr) -> Tuple[dict, bytes]:
    """(the header's dtype and shape fields, the raw bytes) of a host
    array from ``_to_host``."""
    if _is_torch(arr):
        t = _torch()
        flat = arr.reshape(-1)
        raw = flat.view(t.uint8).numpy().tobytes() if flat.numel() \
            else b""
        return ({"dtype": str(arr.dtype).rsplit(".", 1)[-1],
                 "shape": list(arr.shape), "lib": "torch"}, raw)
    return ({"dtype": _dtype_to_name(arr.dtype), "shape": list(arr.shape)},
            arr.tobytes())


# dtypes numpy has only through ml_dtypes (which the reference sends as
# such arrays): always rebuilt as torch tensors here
_TORCH_ONLY = frozenset(("bfloat16", "float8_e4m3fn", "float8_e5m2"))


def _decode(header: dict, payload: bytes):
    """The array a frame carries: a torch tensor when the sender sent one,
    or when it is of a dtype numpy has only through ml_dtypes (the
    reference sends bf16 as such an array, named "bfloat16"); else a
    numpy array."""
    name, shape = header["dtype"], header["shape"]
    dt = None
    if header.get("lib") != "torch" and name not in _TORCH_ONLY:
        try:
            dt = _name_to_dtype(name)
        except TypeError:
            dt = None
    if dt is not None:
        return np.frombuffer(payload, dtype=dt).reshape(shape).copy()
    import torch

    tdt = getattr(torch, name, None)
    if not isinstance(tdt, torch.dtype):
        raise TransportError(f"frame with unknown dtype {name!r}")
    if not payload:
        return torch.empty(shape, dtype=tdt)
    return torch.frombuffer(bytearray(payload), dtype=tdt).reshape(shape)


def _like_input(out, proto):
    """A collective's result on the device of the torch tensor it was
    given (host arrays stay on the host)."""
    if _is_torch(proto) and _is_torch(out) and out.device != proto.device:
        return out.to(proto.device)
    return out


def _backoff(attempt: int) -> float:
    return _backoff_delay(attempt, base=0.05, cap=2.0)


def _send_frame(sock, header: dict, payload: bytes):
    h = json.dumps(header).encode()
    sock.sendall(struct.pack("!II", len(h), len(payload)) + h + payload)


def _recv_frame(sock) -> Tuple[dict, bytes]:
    hlen, plen = struct.unpack("!II", _recv_exact(sock, 8))
    header = json.loads(_recv_exact(sock, hlen).decode())
    payload = _recv_exact(sock, plen) if plen else b""
    return header, payload


class _Mailbox:
    """Tag-addressed inbox the receiver thread fills and recv() drains.

    ``abort()`` poisons the mailbox with a structured error — every
    blocked and future ``take()`` raises it. The watchdog escalation
    path uses this so a stalled collective raises on the waiting rank
    instead of hanging it until the transport deadline."""

    def __init__(self):
        self._cond = threading.Condition()
        self._msgs: Dict[str, List[np.ndarray]] = {}
        self._abort_exc: Optional[BaseException] = None

    def put(self, tag: str, arr: np.ndarray):
        with self._cond:
            self._msgs.setdefault(tag, []).append(arr)
            self._cond.notify_all()

    def abort(self, exc: BaseException):
        with self._cond:
            self._abort_exc = exc
            self._cond.notify_all()

    def pending_tags(self) -> List[str]:
        with self._cond:
            return sorted(self._msgs)

    def take(self, tag: str, timeout: float) -> np.ndarray:
        deadline = time.time() + timeout
        with self._cond:
            while not self._msgs.get(tag):
                if self._abort_exc is not None:
                    raise self._abort_exc
                remaining = deadline - time.time()
                if remaining <= 0:
                    raise TransportTimeoutError(
                        tag, pending=sorted(self._msgs),
                        timeout_s=timeout)
                self._cond.wait(min(remaining, 1.0))
            arr = self._msgs[tag].pop(0)
            if not self._msgs[tag]:
                del self._msgs[tag]
            return arr


class TensorTransport:
    """One per process. Listens on an advertised address, lazily dials
    peers, frames tensors as JSON header + raw bytes, and retransmits
    until the peer acknowledges (see module docstring)."""

    def __init__(self, rank: int, world_size: int, store: TCPStore,
                 bind_host: Optional[str] = None, timeout: float = 300.0,
                 max_retries: Optional[int] = None,
                 ack_timeout: Optional[float] = None,
                 job: Optional[str] = None):
        self.rank = rank
        self.world_size = world_size
        self.timeout = timeout
        self.max_retries = _MAX_RETRIES if max_retries is None \
            else int(max_retries)
        if ack_timeout is None:
            env_a = os.environ.get("PT_ACK_TIMEOUT", "").strip()
            ack_timeout = float(env_a) if env_a else min(timeout, 20.0)
        self.ack_timeout = ack_timeout
        self._store = store
        self._mailbox = _Mailbox()
        self._peers: Dict[int, socket.socket] = {}
        self._peer_locks: Dict[int, threading.Lock] = {}
        self._seq: Dict[str, int] = {}
        self._seq_lock = threading.Lock()
        # receiver-side dedup: fseqs already delivered, per source rank
        self._seen_fseq: Dict[int, Set[int]] = {}
        self._seen_lock = threading.Lock()
        self._conns: List[socket.socket] = []
        self._recv_threads: List[threading.Thread] = []
        self._closed = False
        self._abort_exc: Optional[BaseException] = None
        _faults.maybe_arm_from_env()

        # Bind to the advertised interface, not 0.0.0.0.
        host = bind_host or os.environ.get("POD_IP") \
            or (os.environ.get("PADDLE_CURRENT_ENDPOINT", "").split(":")[0]
                or "127.0.0.1")
        self._server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._server.bind((host, 0))
        self._server.listen(world_size * 4)
        port = self._server.getsockname()[1]
        self.address = f"{host}:{port}"
        # namespace by job id so a shared/long-lived launcher store never
        # serves another job's (or a previous incarnation's) addresses;
        # the elastic supervisor passes a per-generation job so a
        # re-formed pod never dials a dead incarnation's address
        self._job = job or os.environ.get("PADDLE_JOB_ID", "default")
        store.set(self._peer_key(rank), self.address)
        self._accept_thread = threading.Thread(target=self._accept_loop,
                                               daemon=True)
        self._accept_thread.start()

    # -- wiring ------------------------------------------------------------
    def _accept_loop(self):
        while not self._closed:
            try:
                conn, _ = self._server.accept()
            except OSError:
                break
            if self._closed:            # close()'s wake-up connect
                try:
                    conn.close()
                except OSError:
                    pass
                break
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._conns.append(conn)
            t = threading.Thread(target=self._recv_loop, args=(conn,),
                                 daemon=True)
            self._recv_threads.append(t)
            t.start()

    def _recv_loop(self, conn):
        try:
            while True:
                header, payload = _recv_frame(conn)
                if header.get("kind", "data") != "data":
                    continue            # stray control frame
                self._handle_data_frame(conn, header, payload)
        except (ConnectionError, OSError, struct.error,
                json.JSONDecodeError):
            # peer hung up / redialed / sent a torn frame — the sender
            # side owns retries, this conn is done
            try:
                conn.close()
            except OSError:
                _metrics.inc("comm/recv_loop_close_errors")

    def _handle_data_frame(self, conn, header: dict, payload: bytes):
        src = header.get("src")
        fseq = header.get("fseq")
        crc = header.get("crc")
        act = _faults.injector.on_event("recv", self.rank, src)
        if act is not None:
            if act.kind == "delay":
                time.sleep(act.delay_ms / 1e3)
            elif act.kind == "kill":
                os._exit(act.exit_code)
            elif act.kind == "drop":
                raise ConnectionError("fault injection: recv drop")
            elif act.kind == "corrupt" and payload:
                payload = bytes([payload[0] ^ 0xFF]) + payload[1:]
        if crc is not None and zlib.crc32(payload) != crc:
            _m_corrupt.inc()
            _send_frame(conn, {"kind": "nak", "fseq": fseq}, b"")
            return
        dup = False
        if src is not None and fseq is not None:
            with self._seen_lock:
                seen = self._seen_fseq.setdefault(int(src), set())
                if fseq in seen:
                    dup = True
                else:
                    seen.add(fseq)
        if dup:
            _m_dup.inc()
        else:
            self._mailbox.put(header["tag"], _decode(header, payload))
        # ACK even duplicates: the ack for the first copy may be the
        # thing that was lost
        if fseq is not None:
            _send_frame(conn, {"kind": "ack", "fseq": fseq}, b"")

    def _peer_key(self, rank: int) -> str:
        return f"__transport__/{getattr(self, '_job', 'default')}/{rank}"

    def _drop_peer(self, dst: int):
        sock = self._peers.pop(dst, None)
        if sock is not None:
            try:
                sock.close()
            except OSError:
                _metrics.inc("comm/peer_close_errors")

    def _dial(self, dst: int) -> socket.socket:
        sock = self._peers.get(dst)
        if sock is not None:
            return sock
        deadline = time.time() + self.timeout
        last = None
        addr = None
        attempt = 0
        while time.time() < deadline:
            # re-read each attempt: an elastically-restarted peer
            # re-registers under a new address
            addr = self._store.get(self._peer_key(dst)).decode()
            host, port = addr.rsplit(":", 1)
            try:
                act = _faults.injector.on_event("dial", self.rank, dst)
                if act is not None:
                    if act.kind == "delay":
                        time.sleep(act.delay_ms / 1e3)
                    elif act.kind == "kill":
                        os._exit(act.exit_code)
                    elif act.kind in ("drop", "partition"):
                        # partition: the link is severed, not the peer —
                        # indistinguishable at the dialer, by design
                        raise OSError(
                            f"fault injection: dial {act.kind}")
                sock = socket.create_connection((host, int(port)),
                                                timeout=self.timeout)
                break
            except OSError as e:
                last = e
                attempt += 1
                # exponential backoff: a dead peer being relaunched by
                # the elastic controller needs seconds, not a 10 Hz
                # hammer on its old address
                time.sleep(_backoff(attempt))
        else:
            raise PeerUnreachableError(dst, addr, attempt, last)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._peers[dst] = sock
        self._peer_locks.setdefault(dst, threading.Lock())
        return sock

    def _next_seq(self, key: str) -> int:
        with self._seq_lock:
            n = self._seq.get(key, 0)
            self._seq[key] = n + 1
            return n

    def _check_usable(self):
        if self._closed:
            raise TransportClosedError(
                f"transport on rank {self.rank} is closed")
        if self._abort_exc is not None:
            raise self._abort_exc

    def abort(self, exc: BaseException):
        """Poison the transport with a structured error: every blocked
        recv wakes and raises `exc`, and future send/recv raise it too.
        The watchdog escalation path calls this when a collective stalls
        past its timeout, so no rank is left hanging."""
        self._abort_exc = exc
        self._mailbox.abort(exc)

    # -- reliable framing --------------------------------------------------
    def _send_with_ack(self, dst: int, header: dict, payload: bytes):
        """Transmit one data frame and block until the peer ACKs it.

        Retries (up to max_retries) on: connection error (redial with
        exponential backoff), ack timeout (peer slow or frame lost), or
        NAK (CRC mismatch at the receiver). The frame's fseq makes
        retransmits idempotent — the receiver dedups and re-ACKs."""
        fseq = self._next_seq(f"frame:{dst}")
        header = dict(header, src=self.rank, fseq=fseq,
                      crc=zlib.crc32(payload))
        naks = 0
        last_exc: Optional[BaseException] = None
        for attempt in range(self.max_retries + 1):
            self._check_usable()
            if attempt > 0:
                _m_retries.inc()
            wire = payload
            dup = False
            try:
                act = _faults.injector.on_event("send", self.rank, dst)
                if act is not None:
                    if act.kind == "delay":
                        time.sleep(act.delay_ms / 1e3)
                    elif act.kind == "kill":
                        os._exit(act.exit_code)
                    elif act.kind == "drop":
                        # a dropped connection: the socket dies under the
                        # sender, surfacing as a send failure -> redial
                        self._drop_peer(dst)
                        raise ConnectionError(
                            "fault injection: connection dropped")
                    elif act.kind == "corrupt" and payload:
                        wire = bytes([payload[0] ^ 0xFF]) + payload[1:]
                    elif act.kind == "dup":
                        dup = True
                sock = self._dial(dst)
                with self._peer_locks[dst]:
                    sock.settimeout(self.ack_timeout)
                    try:
                        _send_frame(sock, header, wire)
                        if dup:
                            _send_frame(sock, header, wire)
                        resp = self._await_ack(sock, fseq)
                    finally:
                        sock.settimeout(None)
            except PeerUnreachableError:
                raise
            except (ConnectionError, OSError, struct.error,
                    json.JSONDecodeError) as e:
                last_exc = e
                self._drop_peer(dst)
                _m_redials.inc()
                time.sleep(_backoff(attempt))
                continue
            if resp.get("kind") == "ack":
                return
            naks += 1          # CRC mismatch at receiver: retransmit
        if naks:
            raise FrameCorruptError(dst, fseq, self.max_retries + 1)
        raise TransportError(
            f"send to rank {dst} failed after "
            f"{self.max_retries + 1} attempts: {last_exc!r}")

    def _await_ack(self, sock, fseq: int) -> dict:
        """Read ack/nak for `fseq`, discarding stale acks of earlier
        frames (a duplicated transmit produces two acks; the second
        shows up in front of the NEXT frame's ack)."""
        while True:
            resp, _ = _recv_frame(sock)
            if resp.get("kind") not in ("ack", "nak"):
                continue
            if resp.get("fseq") is not None and resp["fseq"] < fseq:
                continue
            return resp

    # -- p2p ---------------------------------------------------------------
    def send(self, arr, dst: int, channel: str = "p2p"):
        self._check_usable()
        fields, payload = _encode(_to_host(arr))
        seq = self._next_seq(f"tx:{channel}:{dst}")
        tag = f"{channel}:{self.rank}->{dst}:{seq}"
        self._send_with_ack(dst, dict(fields, tag=tag), payload)

    def recv(self, src: int, channel: str = "p2p"):
        """The next array from ``src`` on ``channel``, as sent: a numpy
        array, or a torch tensor on the CPU."""
        return self._mailbox.take(self.reserve_recv(src, channel),
                                  self.timeout)

    def reserve_recv(self, src: int, channel: str = "p2p") -> str:
        """Claim the next sequence tag for a receive without blocking —
        the async irecv posting half; redeem with take()."""
        seq = self._next_seq(f"rx:{channel}:{src}")
        return f"{channel}:{src}->{self.rank}:{seq}"

    def take(self, tag: str) -> np.ndarray:
        return self._mailbox.take(tag, self.timeout)

    # -- collectives over subsets of ranks ---------------------------------
    def _chan(self, op: str, gid: int) -> str:
        return f"c:{op}:{gid}"

    @staticmethod
    def _reduce_fn(op: str):
        return {"sum": np.add, "max": np.maximum, "min": np.minimum,
                "prod": np.multiply, "avg": np.add}[op]

    def _host_reduce(self, parts, op: str):
        if _is_torch(parts[0]):
            return self._torch_reduce(parts, op)
        fn = self._reduce_fn(op)
        dt = parts[0].dtype
        # fp16 accumulates in fp32
        widen = dt.itemsize < 4 and dt.kind in "fV"
        wide = [p.astype(np.float32) if widen else p for p in parts]
        acc = wide[0]
        for p in wide[1:]:
            acc = fn(acc, p)
        if op == "avg":
            acc = acc / len(parts)
        return acc.astype(parts[0].dtype)

    @staticmethod
    def _torch_reduce(parts, op: str):
        """The numpy reduce's order and widening on torch tensors: bf16
        and fp16 accumulate in fp32, "avg" sums then divides, the result
        in the first part's dtype."""
        import torch

        fn = {"sum": torch.add, "max": torch.maximum,
              "min": torch.minimum, "prod": torch.mul,
              "avg": torch.add}[op]
        dt = parts[0].dtype
        widen = dt in (torch.bfloat16, torch.float16)
        wide = [p.to(torch.float32) if widen
                else p.to(dt) for p in parts]
        acc = wide[0]
        for p in wide[1:]:
            acc = fn(acc, p)
        if op == "avg":
            acc = acc / len(parts)
        return acc.to(dt)

    def all_reduce(self, arr, op: str, ranks: List[int], gid: int):
        proto = arr
        arr = _to_host(arr)
        root = ranks[0]
        ch = self._chan(f"ar_{op}", gid)
        if self.rank == root:
            parts = [arr] + [self.recv(r, ch) for r in ranks
                             if r != root]
            out = self._host_reduce(parts, op)
            for r in ranks:
                if r != root:
                    self.send(out, r, ch + ":out")
            return _like_input(out, proto)
        self.send(arr, root, ch)
        return _like_input(self.recv(root, ch + ":out"), proto)

    def reduce(self, arr, op: str, dst: int, ranks: List[int], gid: int):
        proto = arr
        arr = _to_host(arr)
        ch = self._chan(f"red_{op}", gid)
        if self.rank == dst:
            parts = [arr] + [self.recv(r, ch) for r in ranks if r != dst]
            return _like_input(self._host_reduce(parts, op), proto)
        self.send(arr, dst, ch)
        return proto if _is_torch(proto) else arr

    def broadcast(self, arr, src: int, ranks: List[int], gid: int):
        ch = self._chan("bc", gid)
        if self.rank == src:
            host = _to_host(arr)
            for r in ranks:
                if r != src:
                    self.send(host, r, ch)
            return arr if _is_torch(arr) else host
        return _like_input(self.recv(src, ch), arr)

    def all_gather(self, arr, ranks: List[int], gid: int) -> List:
        proto = arr
        arr = _to_host(arr)
        root = ranks[0]
        ch = self._chan("ag", gid)
        if self.rank == root:
            parts = {root: arr}
            for r in ranks:
                if r != root:
                    parts[r] = self.recv(r, ch)
            ordered = [parts[r] for r in ranks]
            stacked = _torch().stack(ordered, 0) if _is_torch(arr) \
                else np.stack(ordered, axis=0)
            for r in ranks:
                if r != root:
                    self.send(stacked, r, ch + ":out")
            return [_like_input(p, proto) for p in ordered]
        self.send(arr, root, ch)
        stacked = self.recv(root, ch + ":out")
        return [_like_input(stacked[i], proto)
                for i in range(stacked.shape[0])]

    def gather(self, arr, dst: int, ranks: List[int],
               gid: int) -> Optional[List]:
        arr = _to_host(arr)
        ch = self._chan("ga", gid)
        if self.rank == dst:
            parts = {dst: arr}
            for r in ranks:
                if r != dst:
                    parts[r] = self.recv(r, ch)
            return [parts[r] for r in ranks]
        self.send(arr, dst, ch)
        return None

    def scatter(self, parts: Optional[List], src: int,
                ranks: List[int], gid: int):
        ch = self._chan("sc", gid)
        if self.rank == src:
            assert parts is not None and len(parts) == len(ranks)
            mine = None
            for r, piece in zip(ranks, parts):
                piece = _to_host(piece)
                if r == src:
                    mine = piece
                else:
                    self.send(piece, r, ch)
            return mine
        return self.recv(src, ch)

    def all_to_all(self, parts: List, ranks: List[int], gid: int) -> List:
        assert len(parts) == len(ranks)
        ch = self._chan("a2a", gid)
        out: Dict[int, object] = {}
        for r, piece in zip(ranks, parts):
            if r == self.rank:
                out[r] = _to_host(piece)
            else:
                self.send(_to_host(piece), r, ch)
        for r in ranks:
            if r != self.rank:
                out[r] = self.recv(r, ch)
        return [out[r] for r in ranks]

    def barrier(self, name: str, ranks: List[int]):
        seq = self._next_seq(f"barrier:{name}")
        self._store.barrier(f"{name}#{seq}", len(ranks),
                            timeout=self.timeout)

    def close(self):
        """Tear down reliably: wake every blocked recv with a structured
        error, unblock and join the accept thread, close all accepted
        connections so their recv threads exit, then close peers."""
        if self._closed:
            return
        self._closed = True
        self._mailbox.abort(TransportClosedError(
            f"transport on rank {self.rank} closed"))
        # a blocked accept() does not reliably wake on close alone:
        # shutdown the listening socket, then poke it with a loopback
        # connect in case the platform ignored the shutdown
        try:
            self._server.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._server.close()
        except OSError:
            _metrics.inc("comm/close_errors")
        try:
            host, port = self.address.rsplit(":", 1)
            socket.create_connection((host, int(port)),
                                     timeout=0.5).close()
        except OSError:
            pass
        self._accept_thread.join(timeout=2.0)
        for c in self._conns:
            try:
                c.close()
            except OSError:
                _metrics.inc("comm/close_errors")
        for t in self._recv_threads:
            t.join(timeout=1.0)
        for s in self._peers.values():
            try:
                s.close()
            except OSError:
                _metrics.inc("comm/close_errors")
        self._peers.clear()
        self._conns.clear()
        self._recv_threads.clear()


_transport: Optional[TensorTransport] = None


def _master_endpoint() -> Tuple[str, int]:
    master = os.environ.get("PADDLE_MASTER")
    if master:
        host, port = master.rsplit(":", 1)
        return host, int(port)
    eps = [e for e in os.environ.get("PADDLE_TRAINER_ENDPOINTS",
                                     "").split(",") if e]
    if eps:
        host, port = eps[0].rsplit(":", 1)
        return host, int(port) + 1
    return "127.0.0.1", 0


def init_transport(rank: Optional[int] = None,
                   world_size: Optional[int] = None,
                   timeout: Optional[float] = None) \
        -> Optional[TensorTransport]:
    """Bring up the eager tensor transport for this process. No-op (returns
    None) for single-process jobs. When the caller leaves `timeout` unset,
    PADDLE_STORE_TIMEOUT (seconds) overrides the 300 s default — an
    explicit argument always wins."""
    global _transport
    if _transport is not None:
        return _transport
    if timeout is None:
        env_t = os.environ.get("PADDLE_STORE_TIMEOUT", "").strip()
        timeout = float(env_t) if env_t else 300.0
    if rank is None:
        rank = int(os.environ.get("PADDLE_TRAINER_ID", 0))
    if world_size is None:
        world_size = int(os.environ.get("PADDLE_TRAINERS_NUM", 1))
    if world_size <= 1:
        return None
    host, port = _master_endpoint()
    if rank == 0:
        # Host the store unless the launcher already serves this address —
        # bind fails instantly (EADDRINUSE) in that case, so try hosting
        # first and join as a client on failure.
        try:
            store = connect_store(host, port, is_master=True,
                                  world_size=world_size, timeout=timeout,
                                  rank=rank)
        except OSError:
            store = connect_store(host, port, is_master=False,
                                  world_size=world_size, timeout=timeout,
                                  rank=rank)
    else:
        store = connect_store(host, port, is_master=False,
                              world_size=world_size, timeout=timeout,
                              rank=rank)
    _transport = TensorTransport(rank, world_size, store, timeout=timeout)
    return _transport


def get_transport() -> Optional[TensorTransport]:
    return _transport


def install_transport(tp: Optional[TensorTransport]) \
        -> Optional[TensorTransport]:
    """Make `tp` the process-global transport. The elastic supervisor
    uses this when it re-forms the group with a fresh transport, so the
    comm watchdog's escalation path (which aborts ``get_transport()``)
    targets the live incarnation, not the one that just died."""
    global _transport
    _transport = tp
    return tp


def shutdown_transport():
    global _transport
    if _transport is not None:
        _transport.close()
        _transport = None
