"""The port's NetRing (masa_tpu_torch/parallel/netring.py), the TCP
control-plane ring, on OS-picked localhost ports: the counterpart of
tests/test_netring.py, plus a ring that nodes of the port and of masa_tpu
share (the wire format is the reference's).  Every socket wait is bounded:
a call's connection and reads time out after ``CALL_TIMEOUT`` seconds and
a ring token after ``TOKEN_TIMEOUT``, so a hung ring fails and does not
stall the run."""

import socket

import pytest

from masa_tpu.parallel import netring as ref_netring
from masa_tpu_torch.parallel import netring
from masa_tpu_torch.parallel.netring import NetRing

CALL_TIMEOUT = 5.0   # NetRing._call: socket.create_connection(timeout=...)
TOKEN_TIMEOUT = 5.0  # NetRing.ring_test(timeout=...)


def close_all(nodes):
    for n in nodes:
        n.close()
    for n in nodes:
        assert not n._thread.is_alive()


def make_ring(classes):
    """Nodes 0..len-1 of the given classes, joined through node 0 and
    gossiped once."""
    nodes = []
    try:
        for k, cls in enumerate(classes):
            nodes.append(cls(k))
        for n in nodes[1:]:
            n.join(*nodes[0].addr)
        for n in nodes:
            n.discover()
    except BaseException:
        close_all(nodes)
        raise
    return nodes


@pytest.fixture
def ring4():
    nodes = make_ring([NetRing] * 4)
    try:
        yield nodes
    finally:
        close_all(nodes)


class TestNetRing:
    def test_join_and_discover(self, ring4):
        for n in ring4:
            assert sorted(n.peers) == [0, 1, 2, 3]

    def test_ring_token_travels_in_id_order(self, ring4):
        assert ring4[0].ring_test(timeout=TOKEN_TIMEOUT) == [0, 1, 2, 3]
        assert ring4[2].ring_test(timeout=TOKEN_TIMEOUT) == [2, 3, 0, 1]

    def test_notify_score_circulates(self, ring4):
        ring4[1].notify_score(100, 200, 777)
        for n in ring4:
            assert n.best_score == (100, 200, 777)
        # lower score never downgrades
        ring4[3].notify_score(1, 1, 5)
        for n in ring4:
            assert n.best_score == (100, 200, 777)

    def test_status_query(self, ring4):
        ring4[2].stage = 4
        ring4[2].notify_score(9, 9, 42)
        st = ring4[0].status_of(2)
        assert st["cmd"] == "STATUS_RESPONSE"
        assert st["id"] == 2 and st["stage"] == 4
        assert st["best"] == [9, 9, 42]

    def test_unknown_command_is_reported(self, ring4):
        reply = ring4[0]._call(ring4[1].addr, {"cmd": "BOGUS"})
        assert reply["cmd"] == "ERROR"

    def test_two_node_ring(self):
        a, b = NetRing(10), NetRing(11)
        try:
            b.join(*a.addr)
            a.discover()
            assert a.ring_test(timeout=TOKEN_TIMEOUT) == [10, 11]
        finally:
            close_all([a, b])


def test_calls_are_bounded():
    """What bounds a wait: a call's socket has a timeout (connection and
    reads), so a peer that accepts and never answers raises in the caller
    within ``CALL_TIMEOUT``."""
    silent = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    silent.bind(("127.0.0.1", 0))
    silent.listen(1)
    node = NetRing(0)
    try:
        with pytest.raises(socket.timeout):
            node._call(silent.getsockname(), {"cmd": "STATUS"})
    finally:
        silent.close()
        close_all([node])


@pytest.mark.parametrize("classes", [
    (NetRing, ref_netring.NetRing, NetRing, ref_netring.NetRing),
    (ref_netring.NetRing, NetRing),
], ids=["port-ref-port-ref", "ref-port"])
def test_mixed_ring_of_both_packages(classes):
    """Nodes of the port and of masa_tpu join one ring: handshake, gossip,
    the token, a score and a status query cross between them."""
    nodes = make_ring(classes)
    ids = list(range(len(nodes)))
    try:
        for n in nodes:
            assert sorted(n.peers) == ids
        assert nodes[0].ring_test(timeout=TOKEN_TIMEOUT) == ids
        assert nodes[-1].ring_test(timeout=TOKEN_TIMEOUT) == \
            ids[-1:] + ids[:-1]
        nodes[1].notify_score(3, 4, 55)
        for n in nodes:
            assert tuple(n.best_score) == (3, 4, 55)
        nodes[0].stage = 2
        assert nodes[-1].status_of(0) == {
            "cmd": "STATUS_RESPONSE", "id": 0, "stage": 2, "best": [3, 4, 55]}
    finally:
        close_all(nodes)


def test_wire_format_is_the_references():
    """A message framed by one package is read by the other's reader."""
    a, b = socket.socketpair()
    try:
        for s in (a, b):
            s.settimeout(CALL_TIMEOUT)
        msg = {"cmd": "NOTIFY_SCORE", "score": [1, 2, 3]}
        netring._send_msg(a, msg)
        assert ref_netring._recv_msg(b) == msg
        ref_netring._send_msg(b, msg)
        assert netring._recv_msg(a) == msg
    finally:
        a.close()
        b.close()
