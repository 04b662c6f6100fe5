"""TCPStore — rendezvous key-value store with a hot-standby replica (the
port's copy of paddle_tpu/distributed/store.py, on the same wire protocol:
a client of either package talks to a server of the other).

Reference analog: paddle/phi/core/distributed/store/tcp_store.h:121 +
tcp_utils.cc (C++ socket KV store used to exchange NCCL unique ids and
barrier). The launcher (distributed/launch) needs a store before any
worker exists — this is that store: a length-prefixed TCP protocol with
set/get/wait/add/barrier, hosted by the launching controller.
``torch.distributed``'s own rendezvous is separate: rank 0 serves it at
the first of the workers' endpoints (env.py).

Host-level fault domain extensions:

- ``StandbyStore`` tails every mutating op from the primary over the
  same CRC/ACK discipline the transport uses (crc32 per record, ack/nak
  with bounded retransmit, seq dedup) and serves the replicated map from
  its own endpoint, so losing the primary's HOST no longer deadlocks
  every elastic re-form.
- ``FailoverStore`` is the client every resilience layer goes through:
  same set/get/add/wait/barrier surface, but on a dead endpoint it
  rotates to the standby under ``resilience/backoff`` and retries the
  op (``store/failovers`` counts endpoint switches).
- Generation fences: ``fenced_set`` carries the writer's generation and
  the server refuses writes older than the high-water mark for the
  fence domain (``StaleGenerationError``) — a rank returning from the
  minority side of a partition cannot corrupt the re-formed group.
  Fences live in the data map under ``__fence__/<domain>`` and are
  therefore replicated to the standby for free.
"""
from __future__ import annotations

import os
import socket
import struct
import threading
import time
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

from ..profiler import metrics as _metrics
from .resilience import faults as _faults
from .resilience.backoff import delay as _backoff_delay
from .resilience.errors import StaleGenerationError, StoreTimeoutError

__all__ = ["TCPStore", "StandbyStore", "FailoverStore", "connect_store",
           "FENCE_PREFIX"]

_OP_SET = 0
_OP_GET = 1
_OP_ADD = 2
_OP_WAIT = 3
_OP_DEL = 4
_OP_TAIL = 5

# reserved key namespace holding the per-domain generation fences;
# replicated like any other key so fences survive a standby takeover
FENCE_PREFIX = "__fence__/"

_m_failovers = _metrics.counter("store/failovers")
_m_redials = _metrics.counter("store/redials")
_m_tailer_drops = _metrics.counter("store/tailer_drops")
_m_replicated = _metrics.counter("store/replicated_records")
_m_repl_naks = _metrics.counter("store/replication_naks")
_m_takeovers = _metrics.counter("store/standby_takeovers")
_m_fenced = _metrics.counter("elastic/fenced_writes")

# replication tailers ack within this budget or are declared dead; kept
# short so a hung standby cannot wedge the primary's write path
_TAIL_ACK_TIMEOUT_S = 2.0
_TAIL_RETRANSMITS = 3


def _send_msg(sock, *parts: bytes):
    payload = b"".join(struct.pack("!I", len(p)) + p for p in parts)
    sock.sendall(struct.pack("!I", len(parts)) + payload)


def _recv_exact(sock, n):
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("store connection closed")
        buf += chunk
    return buf


def _recv_msg(sock):
    (n_parts,) = struct.unpack("!I", _recv_exact(sock, 4))
    parts = []
    for _ in range(n_parts):
        (ln,) = struct.unpack("!I", _recv_exact(sock, 4))
        parts.append(_recv_exact(sock, ln))
    return parts


def _record_crc(op: int, key: bytes, value: bytes, seq: int) -> int:
    return zlib.crc32(bytes([op]) + key + b"\x00" + value
                      + str(seq).encode()) & 0xFFFFFFFF


class _StoreServer(threading.Thread):
    def __init__(self, host, port):
        super().__init__(daemon=True)
        self.data: Dict[bytes, bytes] = {}
        self.cond = threading.Condition()
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.sock.bind((host, port))
        self.port = self.sock.getsockname()[1]
        self.sock.listen(128)
        self._stop = False
        self._tailers: List[socket.socket] = []
        self._conns: List[socket.socket] = []
        self._repl_seq = 0

    def run(self):
        while not self._stop:
            try:
                conn, _ = self.sock.accept()
            except OSError:
                break
            with self.cond:
                self._conns.append(conn)
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True).start()

    def _replicate(self, op: int, key: bytes, value: bytes):
        """Push one mutation record to every registered tailer. Called
        with ``self.cond`` held so records reach the standby in apply
        order. CRC per record; nak -> retransmit; a tailer that stops
        acking is dropped, never allowed to wedge the primary."""
        if not self._tailers:
            return
        self._repl_seq += 1
        seq = self._repl_seq
        crc = _record_crc(op, key, value, seq)
        dead = []
        for tail in self._tailers:
            try:
                for _ in range(_TAIL_RETRANSMITS):
                    _send_msg(tail, bytes([op]), key, value,
                              str(seq).encode(), str(crc).encode())
                    (ack,) = _recv_msg(tail)
                    if ack == b"ok":
                        _m_replicated.inc()
                        break
                    _m_repl_naks.inc()
                else:
                    dead.append(tail)
            except (ConnectionError, OSError):
                dead.append(tail)
        for tail in dead:
            self._tailers.remove(tail)
            _m_tailer_drops.inc()
            try:
                tail.close()
            except OSError:
                pass

    def _serve(self, conn):
        try:
            while True:
                parts = _recv_msg(conn)
                op = parts[0][0]
                if op == _OP_SET:
                    fenced_reply = None
                    with self.cond:
                        if len(parts) >= 5:
                            # fenced write: parts are (op, key, value,
                            # domain, generation)
                            fkey = (FENCE_PREFIX.encode() + parts[3])
                            gen = int(parts[4].decode())
                            cur = int(self.data.get(fkey, b"-1").decode())
                            if gen < cur:
                                fenced_reply = str(cur).encode()
                            elif gen > cur:
                                self.data[fkey] = parts[4]
                                self._replicate(_OP_SET, fkey, parts[4])
                        if fenced_reply is None:
                            self.data[parts[1]] = parts[2]
                            self.cond.notify_all()
                            self._replicate(_OP_SET, parts[1], parts[2])
                    if fenced_reply is None:
                        _send_msg(conn, b"ok")
                    else:
                        _send_msg(conn, b"fenced", fenced_reply)
                elif op == _OP_GET:
                    with self.cond:
                        val = self.data.get(parts[1])
                    _send_msg(conn, val if val is not None else b"",
                              b"1" if val is not None else b"0")
                elif op == _OP_ADD:
                    delta = int(parts[2].decode())
                    with self.cond:
                        cur = int(self.data.get(parts[1], b"0").decode())
                        cur += delta
                        self.data[parts[1]] = str(cur).encode()
                        self.cond.notify_all()
                        # an ADD replicates as the SET of its result so
                        # a retransmit replay stays idempotent
                        self._replicate(_OP_SET, parts[1],
                                        self.data[parts[1]])
                    _send_msg(conn, str(cur).encode())
                elif op == _OP_WAIT:
                    timeout = float(parts[2].decode())
                    deadline = time.time() + timeout
                    with self.cond:
                        while parts[1] not in self.data:
                            remaining = deadline - time.time()
                            if remaining <= 0:
                                break
                            self.cond.wait(min(remaining, 1.0))
                        ok = parts[1] in self.data
                    _send_msg(conn, b"1" if ok else b"0")
                elif op == _OP_DEL:
                    with self.cond:
                        self.data.pop(parts[1], None)
                        self._replicate(_OP_DEL, parts[1], b"")
                    _send_msg(conn, b"ok")
                elif op == _OP_TAIL:
                    with self.cond:
                        flat: List[bytes] = []
                        for k, v in self.data.items():
                            flat.append(k)
                            flat.append(v)
                        _send_msg(conn, b"snap",
                                  str(self._repl_seq).encode(), *flat)
                        conn.settimeout(_TAIL_ACK_TIMEOUT_S)
                        self._tailers.append(conn)
                    # the connection now belongs to the replication
                    # push path (_replicate writes records and reads
                    # acks); this reader must let go of it
                    return
        except (ConnectionError, OSError):
            pass

    def stop(self):
        self._stop = True
        # sever live client and tailer connections too, so "stop the
        # server" means what a host death means: every peer sees EOF.
        # Snapshot under cond: _serve threads mutate both lists (tail
        # registration, dead-tailer drops) while stop() iterates.
        with self.cond:
            conns = self._conns + self._tailers
        for conn in conns:
            try:
                conn.close()
            except OSError:
                pass
        try:
            self.sock.close()
        except OSError:
            pass


class TCPStore:
    """API parity with the reference TCPStore: set/get/add/wait."""

    def __init__(self, host: str, port: int, is_master: bool = False,
                 world_size: int = 1, timeout: float = 300.0):
        self.timeout = timeout
        self._server: Optional[_StoreServer] = None
        if is_master:
            self._server = _StoreServer(
                "0.0.0.0" if host not in ("127.0.0.1", "localhost")
                else host, port)
            self._server.start()
            port = self._server.port
        self.host, self.port = host, port
        deadline = time.time() + timeout
        last_err = None
        attempt = 0
        while time.time() < deadline:
            try:
                self._sock = socket.create_connection((host, port),
                                                      timeout=timeout)
                break
            except OSError as e:
                last_err = e
                attempt += 1
                # capped low: the master may be a peer process still
                # importing; connecting promptly once it binds matters
                # more than sparing a localhost SYN
                time.sleep(min(_backoff_delay(attempt, base=0.1,
                                              cap=0.5),
                               max(deadline - time.time(), 0.05)))
        else:
            raise ConnectionError(f"cannot reach store {host}:{port}: "
                                  f"{last_err}")
        self._lock = threading.Lock()

    @property
    def endpoint(self) -> str:
        return f"{self.host}:{self.port}"

    def set(self, key: str, value):
        if isinstance(value, str):
            value = value.encode()
        with self._lock:
            _send_msg(self._sock, bytes([_OP_SET]), key.encode(), value)
            _recv_msg(self._sock)

    def fenced_set(self, key: str, value, domain: str, gen: int):
        """Set guarded by the generation fence for ``domain``: refused
        (``StaleGenerationError``) when ``gen`` is older than the
        domain's high-water mark, which the write itself advances."""
        if isinstance(value, str):
            value = value.encode()
        with self._lock:
            _send_msg(self._sock, bytes([_OP_SET]), key.encode(), value,
                      domain.encode(), str(int(gen)).encode())
            reply = _recv_msg(self._sock)
        if reply and reply[0] == b"fenced":
            _m_fenced.inc()
            raise StaleGenerationError(key, domain, int(gen),
                                       int(reply[1].decode()))

    def get(self, key: str) -> bytes:
        deadline = time.time() + self.timeout
        while time.time() < deadline:
            with self._lock:
                _send_msg(self._sock, bytes([_OP_GET]), key.encode())
                val, found = _recv_msg(self._sock)
            if found == b"1":
                return val
            time.sleep(0.1)
        raise StoreTimeoutError(key, self.endpoint, self.timeout,
                                op="get")

    def get_nowait(self, key: str) -> bytes:
        with self._lock:
            _send_msg(self._sock, bytes([_OP_GET]), key.encode())
            val, found = _recv_msg(self._sock)
        if found != b"1":
            raise KeyError(key)
        return val

    def add(self, key: str, delta: int = 1) -> int:
        with self._lock:
            _send_msg(self._sock, bytes([_OP_ADD]), key.encode(),
                      str(delta).encode())
            (val,) = _recv_msg(self._sock)
        return int(val.decode())

    def wait(self, keys, timeout: Optional[float] = None):
        t = timeout if timeout is not None else self.timeout
        if isinstance(keys, str):
            keys = [keys]
        for key in keys:
            with self._lock:
                _send_msg(self._sock, bytes([_OP_WAIT]), key.encode(),
                          str(t).encode())
                (ok,) = _recv_msg(self._sock)
            if ok != b"1":
                raise StoreTimeoutError(key, self.endpoint, t, op="wait")

    def delete_key(self, key: str):
        with self._lock:
            _send_msg(self._sock, bytes([_OP_DEL]), key.encode())
            _recv_msg(self._sock)

    def barrier(self, name: str, world_size: int,
                timeout: Optional[float] = None):
        n = self.add(f"__barrier__/{name}", 1)
        if n >= world_size:
            self.set(f"__barrier__/{name}/done", b"1")
        self.wait([f"__barrier__/{name}/done"], timeout)

    def close(self):
        try:
            self._sock.close()
        except OSError:
            pass
        if self._server is not None:
            self._server.stop()


class StandbyStore:
    """Hot-standby replica of a primary store.

    Dials the primary, receives a full snapshot, then tails every
    mutating op over the CRC/ACK record framing into its OWN
    ``_StoreServer`` — which serves the replicated map (reads and, after
    a takeover, writes) on ``(self.host, self.port)`` the whole time.
    When the primary dies the tail thread notes it
    (``store/standby_takeovers``) and the standby keeps serving;
    ``FailoverStore`` clients redial onto it.
    """

    def __init__(self, primary_host: str, primary_port: int,
                 host: str = "127.0.0.1", port: int = 0,
                 timeout: float = 60.0):
        self._server = _StoreServer(
            "0.0.0.0" if host not in ("127.0.0.1", "localhost")
            else host, port)
        self._server.start()
        self.host, self.port = host, self._server.port
        self.primary = (primary_host, int(primary_port))
        self.primary_alive = True
        self._last_seq = 0
        deadline = time.time() + timeout
        last_err = None
        attempt = 0
        while time.time() < deadline:
            try:
                self._sock = socket.create_connection(
                    self.primary, timeout=timeout)
                break
            except OSError as e:
                last_err = e
                attempt += 1
                time.sleep(min(_backoff_delay(attempt, base=0.1, cap=0.5),
                               max(deadline - time.time(), 0.05)))
        else:
            self._server.stop()
            raise ConnectionError(
                f"standby cannot reach primary store "
                f"{primary_host}:{primary_port}: {last_err}")
        _send_msg(self._sock, bytes([_OP_TAIL]))
        snap = _recv_msg(self._sock)
        if not snap or snap[0] != b"snap":
            raise ConnectionError("primary store did not answer the "
                                  "tail handshake with a snapshot")
        self._last_seq = int(snap[1].decode())
        with self._server.cond:
            for i in range(2, len(snap) - 1, 2):
                self._server.data[snap[i]] = snap[i + 1]
            self._server.cond.notify_all()
        self._thread = threading.Thread(target=self._tail, daemon=True)
        self._thread.start()

    @property
    def endpoint(self) -> str:
        return f"{self.host}:{self.port}"

    def _tail(self):
        try:
            while True:
                parts = _recv_msg(self._sock)
                op, key, value = parts[0][0], parts[1], parts[2]
                seq = int(parts[3].decode())
                crc = int(parts[4].decode())
                if crc != _record_crc(op, key, value, seq):
                    _send_msg(self._sock, b"nak")
                    continue
                if seq > self._last_seq:    # dedup retransmitted records
                    self._last_seq = seq
                    with self._server.cond:
                        if op == _OP_DEL:
                            self._server.data.pop(key, None)
                        else:
                            self._server.data[key] = value
                        self._server.cond.notify_all()
                _send_msg(self._sock, b"ok")
        except (ConnectionError, OSError):
            # the primary (or its whole host) is gone; keep serving the
            # replica so clients can fail over onto this endpoint
            self.primary_alive = False
            _m_takeovers.inc()

    def close(self):
        try:
            self._sock.close()
        except OSError:
            pass
        # the closed socket unblocks _tail's recv; join so no tailer
        # thread outlives the store (bounded: the thread is a daemon
        # and its loop exits on the first post-close recv)
        self._thread.join(timeout=2.0)
        self._server.stop()


class FailoverStore:
    """Client-side failover over an ordered endpoint list.

    Same surface as ``TCPStore`` (set/get/get_nowait/add/wait/
    delete_key/barrier/fenced_set/close). A dead endpoint
    (``ConnectionError``/``OSError`` mid-op) triggers a redial sweep
    under ``resilience/backoff`` starting at the NEXT endpoint;
    switching endpoints counts ``store/failovers``. ``StoreTimeoutError``
    and ``StaleGenerationError`` pass through untouched — a timeout or a
    fence refusal is an answer, not a dead store.
    """

    _MAX_OP_RETRIES = 2

    def __init__(self, endpoints: Sequence[Tuple[str, int]],
                 is_master: bool = False, world_size: int = 1,
                 timeout: float = 300.0, rank: Optional[int] = None):
        if not endpoints:
            raise ValueError("FailoverStore needs at least one endpoint")
        self._endpoints = [(h, int(p)) for h, p in endpoints]
        self._idx = 0
        self._world_size = world_size
        self.timeout = timeout
        self._rank = rank if rank is not None else \
            int(os.environ.get("PADDLE_TRAINER_ID", "0") or 0)
        self._flock = threading.Lock()
        if is_master or len(self._endpoints) == 1:
            self._store = TCPStore(self._endpoints[0][0],
                                   self._endpoints[0][1],
                                   is_master=is_master,
                                   world_size=world_size, timeout=timeout)
            # a master bound to port 0 picked an ephemeral port: advertise
            self._endpoints[0] = (self._store.host, self._store.port)
        else:
            # a client with standbys must not burn its whole budget on a
            # dead primary — a rank rejoining AFTER the store host died
            # has to reach the standby within the same timeout. Rotate
            # through the endpoint list the way _redial does.
            deadline = time.time() + timeout
            dial_timeout = max(0.5, min(timeout / len(self._endpoints),
                                        5.0))
            last: Optional[BaseException] = None
            attempt = 0
            while True:
                idx = attempt % len(self._endpoints)
                host, port = self._endpoints[idx]
                try:
                    self._store = TCPStore(
                        host, port, is_master=False,
                        world_size=world_size,
                        timeout=dial_timeout)
                except (ConnectionError, OSError) as e:
                    last = e
                    attempt += 1
                    if time.time() >= deadline:
                        raise ConnectionError(
                            f"no store endpoint reachable out of "
                            f"{self._endpoints}: {last}") from last
                    time.sleep(_backoff_delay(attempt, base=0.05,
                                              cap=0.5))
                    continue
                if idx:
                    self._idx = idx
                    _m_failovers.inc()
                break

    @property
    def host(self) -> str:
        with self._flock:
            return self._endpoints[self._idx][0]

    @property
    def port(self) -> int:
        with self._flock:
            return self._endpoints[self._idx][1]

    @property
    def endpoint(self) -> str:
        return f"{self.host}:{self.port}"

    @property
    def endpoints(self) -> List[Tuple[str, int]]:
        return list(self._endpoints)

    @property
    def _server(self):
        with self._flock:
            return self._store._server

    def _redial(self, failed=None):
        """Rotate through the endpoint list (next first, wrapping) until
        one accepts, consulting the chaos ``dial`` site like the
        transport does — a ``partition`` fault makes the dial fail the
        way a severed network link would."""
        with self._flock:
            if failed is not None and self._store is not failed:
                # another caller already swapped the client while we
                # were failing; dialing again would close ITS fresh
                # socket and the two threads would invalidate each
                # other's stores until the retry budget ran out
                return
            old_idx = self._idx
            try:
                self._store._sock.close()
            except OSError:
                pass
            n = len(self._endpoints)
            last: Optional[BaseException] = None
            for attempt in range(max(n * 2, 2)):
                idx = (old_idx + 1 + attempt) % n
                act = _faults.injector.on_event("dial", self._rank)
                if act is not None:
                    if act.kind == "delay":
                        time.sleep(act.delay_ms / 1e3)
                    elif act.kind == "kill":
                        os._exit(act.exit_code)
                    elif act.kind in ("drop", "partition"):
                        last = OSError(
                            f"fault injection: {act.kind} at store dial")
                        time.sleep(_backoff_delay(attempt, base=0.05,
                                                  cap=0.5))
                        continue
                host, port = self._endpoints[idx]
                _m_redials.inc()
                try:
                    self._store = TCPStore(
                        host, port, is_master=False,
                        world_size=self._world_size,
                        timeout=min(self.timeout, 5.0))
                except (ConnectionError, OSError) as e:
                    last = e
                    time.sleep(_backoff_delay(attempt, base=0.05,
                                              cap=0.5))
                    continue
                if idx != old_idx:
                    self._idx = idx
                    _m_failovers.inc()
                return
            raise ConnectionError(
                f"store failover exhausted: no endpoint of "
                f"{self._endpoints} reachable: {last}")

    def _call(self, op, *args, **kwargs):
        attempts = 0
        while True:
            # pin the current client under _flock so a concurrent
            # _redial swap can't hand us a half-constructed store; the
            # blocking op itself runs outside the lock
            with self._flock:
                store = self._store
            try:
                return getattr(store, op)(*args, **kwargs)
            except (StoreTimeoutError, StaleGenerationError):
                raise
            except OSError:
                attempts += 1
                if attempts > self._MAX_OP_RETRIES:
                    raise
                self._redial(failed=store)

    def set(self, key: str, value):
        return self._call("set", key, value)

    def fenced_set(self, key: str, value, domain: str, gen: int):
        return self._call("fenced_set", key, value, domain, gen)

    def get(self, key: str) -> bytes:
        return self._call("get", key)

    def get_nowait(self, key: str) -> bytes:
        return self._call("get_nowait", key)

    def add(self, key: str, delta: int = 1) -> int:
        return self._call("add", key, delta)

    def wait(self, keys, timeout: Optional[float] = None):
        return self._call("wait", keys, timeout)

    def delete_key(self, key: str):
        return self._call("delete_key", key)

    def barrier(self, name: str, world_size: int,
                timeout: Optional[float] = None):
        # re-built over the failover-aware ops (instead of delegated)
        # so each leg can redial independently; the server-side ``>=``
        # check keeps a retried add harmless
        n = self.add(f"__barrier__/{name}", 1)
        if n >= world_size:
            self.set(f"__barrier__/{name}/done", b"1")
        self.wait([f"__barrier__/{name}/done"], timeout)

    def close(self):
        with self._flock:
            store = self._store
        store.close()


def _parse_endpoints(spec: str) -> List[Tuple[str, int]]:
    out: List[Tuple[str, int]] = []
    for ep in (spec or "").replace(";", ",").split(","):
        ep = ep.strip()
        if not ep:
            continue
        host, port = ep.rsplit(":", 1)
        out.append((host, int(port)))
    return out


def connect_store(host: str, port: int, *, is_master: bool = False,
                  world_size: int = 1, timeout: float = 300.0,
                  standby: Optional[str] = None,
                  rank: Optional[int] = None) -> FailoverStore:
    """The one way resilience layers obtain a store client: primary
    endpoint first, then any standbys from ``standby`` or the
    ``PT_STORE_STANDBY`` env (``host:port[,host:port]``), wrapped in
    ``FailoverStore``."""
    endpoints: List[Tuple[str, int]] = [(host, int(port))]
    spec = standby if standby is not None else \
        os.environ.get("PT_STORE_STANDBY", "")
    for ep in _parse_endpoints(spec):
        if ep not in endpoints:
            endpoints.append(ep)
    return FailoverStore(endpoints, is_master=is_master,
                         world_size=world_size, timeout=timeout,
                         rank=rank)
