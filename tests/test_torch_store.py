"""The port's rendezvous store (paddle_tpu_torch.distributed.store) on the
CPU, against the JAX package's (paddle_tpu.distributed.store): the
key-value operations and their timeouts, the two packages' clients and
servers talking to each other over the one wire protocol, the fenced
write, and the standby replica with a failover client
(tests/test_host_failover.py:75-130). Every store here listens on
127.0.0.1 on a port the OS gives."""
import threading
import time

import pytest

from paddle_tpu.distributed import store as J
from paddle_tpu_torch.distributed import store as T
from paddle_tpu_torch.distributed.resilience import (StaleGenerationError,
                                                     StoreTimeoutError)


def _ops(client):
    client.set("a", b"1")
    client.set("s", "text")
    assert client.get("a") == b"1" and client.get("s") == b"text"
    assert client.add("n", 5) == 5 and client.add("n", -2) == 3
    assert client.get("n") == b"3"
    assert client.get_nowait("a") == b"1"
    client.delete_key("a")
    with pytest.raises(KeyError):
        client.get_nowait("a")
    client.wait(["s", "n"], timeout=1.0)


@pytest.mark.parametrize("server,client", [("port", "port"),
                                           ("reference", "port"),
                                           ("port", "reference")])
def test_store_operations_over_the_wire_protocol(server, client):
    S, C = (T if server == "port" else J), (T if client == "port" else J)
    master = S.TCPStore("127.0.0.1", 0, is_master=True)
    peer = C.TCPStore("127.0.0.1", master.port, timeout=5.0)
    try:
        _ops(peer)
        # the master's own client sees the peer's writes
        assert master.get("n") == b"3"
        # a wait released by a write from the other side
        done = []

        def waiter():
            peer.wait("late", timeout=5.0)
            done.append(peer.get("late"))

        t = threading.Thread(target=waiter)
        t.start()
        time.sleep(0.2)
        master.set("late", b"now")
        t.join(5)
        assert done == [b"now"]
        # a barrier of two, one leg on each side
        t = threading.Thread(target=lambda: peer.barrier("b", 2, 5.0))
        t.start()
        master.barrier("b", 2, 5.0)
        t.join(5)
        assert not t.is_alive()
    finally:
        peer.close()
        master.close()


def test_store_timeouts_and_fences_are_structured():
    master = T.TCPStore("127.0.0.1", 0, is_master=True)
    client = T.TCPStore("127.0.0.1", master.port, timeout=0.3)
    try:
        with pytest.raises(StoreTimeoutError) as ei:
            client.get("missing")
        assert ei.value.key == "missing" and ei.value.op == "get"
        assert isinstance(ei.value, TimeoutError)
        with pytest.raises(StoreTimeoutError) as ei:
            client.wait(["never"], timeout=0.2)
        assert ei.value.op == "wait" and ei.value.timeout_s == 0.2
        client.fenced_set("k", b"v2", "dom", 2)
        with pytest.raises(StaleGenerationError) as ei:
            client.fenced_set("k", b"v1", "dom", 1)
        assert (ei.value.write_gen, ei.value.fence_gen) == (1, 2)
        assert client.get("k") == b"v2"
    finally:
        client.close()
        master.close()


@pytest.mark.parametrize("primary_kind", ["port", "reference"])
def test_standby_replica_and_failover_client(primary_kind):
    P = T if primary_kind == "port" else J
    primary = P.TCPStore("127.0.0.1", 0, is_master=True)
    primary.set("early", b"yes")            # before the standby dials
    standby = T.StandbyStore("127.0.0.1", primary.port)
    client = T.connect_store("127.0.0.1", primary.port, rank=0,
                             standby=f"{standby.host}:{standby.port}")
    try:
        assert (standby.host, standby.port) in client.endpoints
        client.set("k", b"v")
        client.add("ctr", 5)
        client.set("gone", b"x")
        client.delete_key("gone")
        probe = T.TCPStore("127.0.0.1", standby.port)
        try:
            assert probe.get_nowait("early") == b"yes"
            assert probe.get_nowait("k") == b"v"
            assert probe.get_nowait("ctr") == b"5"
            with pytest.raises(KeyError):
                probe.get_nowait("gone")
        finally:
            probe.close()
        primary._server.stop()              # the primary's host dies
        assert client.get("k") == b"v"      # answered by the standby
        assert client.endpoint == standby.endpoint
        client.set("post", b"takeover")
        assert client.add("ctr", 3) == 8
        deadline = time.time() + 5
        while standby.primary_alive and time.time() < deadline:
            time.sleep(0.05)
        assert standby.primary_alive is False
    finally:
        client.close()
        standby.close()
        primary.close()
