"""Taken from ``masa_tpu/parallel/netring.py`` (the JAX reference).

NetRing: the TCP control-plane peer ring.

Functional re-creation of the reference's MasaNet subsystem
(masanet/MasaNet.cpp, Peer.cpp, command/* — handshake, discovery,
ring creation, score notification, status queries; ~2300 LoC of C++
that ships dormant: it is wired in at libmasa.cpp:1236-1247 and then
just sleeps).  Here it is small and it works: a ring of peers over
TCP with the same command vocabulary:

  JOIN            handshake: peer id + listen address
  DISCOVER        gossip the known-peer list (CmdDiscover/CmdPeerList)
  NOTIFY_SCORE    circulate a best-score candidate (CmdNotifyScore)
  STATUS          snapshot a peer's stage/score state (CmdStatusRequest)
  RING_TEST       token passed around the ring once (CmdTestRing)

Wire format: length-prefixed JSON objects (the reference uses ad-hoc
int32/VLS8 framing, Peer.hpp:78-91 — JSON keeps it debuggable without
changing the semantics).  In production runs the JAX distributed
runtime carries this role (parallel/mesh.py); NetRing exists for
socket-only deployments and parity with the reference's subsystem.
"""

from __future__ import annotations

import json
import socket
import struct
import threading
import time


def _send_msg(sock: socket.socket, obj: dict) -> None:
    raw = json.dumps(obj).encode()
    sock.sendall(struct.pack("<I", len(raw)) + raw)


def _recv_msg(sock: socket.socket) -> dict | None:
    hdr = b""
    while len(hdr) < 4:
        chunk = sock.recv(4 - len(hdr))
        if not chunk:
            return None
        hdr += chunk
    (ln,) = struct.unpack("<I", hdr)
    raw = b""
    while len(raw) < ln:
        chunk = sock.recv(ln - len(raw))
        if not chunk:
            return None
        raw += chunk
    return json.loads(raw)


class NetRing:
    """One ring node: a listener thread + a client connection to the next
    peer.  Peers are ordered by id; the ring closes from the highest id
    back to the lowest (MasaNet::createRing semantics)."""

    def __init__(self, node_id: int, host: str = "127.0.0.1",
                 port: int = 0):
        self.node_id = node_id
        self.best_score: tuple[int, int, int] = (0, 0, 0)  # (i, j, score)
        self.stage = 0
        self.peers: dict[int, tuple[str, int]] = {}
        self.ring_tokens: list[list[int]] = []
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(8)
        self.addr = self._srv.getsockname()
        self.peers[node_id] = self.addr
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    # --- server side ------------------------------------------------------

    def _serve(self) -> None:
        self._srv.settimeout(0.2)
        handlers = []
        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            t = threading.Thread(target=self._handle, args=(conn,),
                                 daemon=True)
            t.start()
            handlers.append(t)

    def _handle(self, conn: socket.socket) -> None:
        with conn:
            while not self._stop.is_set():
                conn.settimeout(0.5)
                try:
                    msg = _recv_msg(conn)
                except socket.timeout:
                    continue
                except OSError:
                    return
                if msg is None:
                    return
                reply = self._dispatch(msg)
                if reply is not None:
                    try:
                        _send_msg(conn, reply)
                    except OSError:
                        return

    def _dispatch(self, msg: dict) -> dict | None:
        cmd = msg.get("cmd")
        if cmd == "JOIN":
            with self._lock:
                self.peers[msg["id"]] = (msg["host"], msg["port"])
                peers = {str(k): list(v) for k, v in self.peers.items()}
            return {"cmd": "PEER_LIST", "peers": peers}
        if cmd == "DISCOVER":
            with self._lock:
                for k, v in msg["peers"].items():
                    self.peers.setdefault(int(k), tuple(v))
                peers = {str(k): list(v) for k, v in self.peers.items()}
            return {"cmd": "PEER_LIST", "peers": peers}
        if cmd == "NOTIFY_SCORE":
            with self._lock:
                if msg["score"][2] > self.best_score[2]:
                    self.best_score = tuple(msg["score"])
            return {"cmd": "ACK"}
        if cmd == "STATUS":
            with self._lock:
                return {"cmd": "STATUS_RESPONSE", "id": self.node_id,
                        "stage": self.stage,
                        "best": list(self.best_score)}
        if cmd == "RING_TEST":
            path = list(msg["path"])
            origin = msg["origin"]
            with self._lock:
                self.ring_tokens.append(path)
            if self.node_id != origin:
                path.append(self.node_id)
                nxt = self._next_peer()
                if nxt is not None:
                    self._call(nxt, {"cmd": "RING_TEST", "origin": origin,
                                     "path": path}, wait=False)
            return {"cmd": "ACK"}
        return {"cmd": "ERROR", "detail": f"unknown command {cmd!r}"}

    # --- client side ------------------------------------------------------

    def _call(self, addr: tuple[str, int], obj: dict,
              wait: bool = True) -> dict | None:
        with socket.create_connection(addr, timeout=5.0) as s:
            _send_msg(s, obj)
            if not wait:
                return None
            reply = _recv_msg(s)
            if reply is None:
                raise ConnectionError(
                    f"peer {addr} closed the connection before replying "
                    f"to {obj.get('cmd')!r}"
                )
            return reply

    def _next_peer(self) -> tuple[str, int] | None:
        with self._lock:
            ids = sorted(self.peers)
        if len(ids) < 2:
            return None
        k = ids.index(self.node_id)
        nxt = ids[(k + 1) % len(ids)]
        with self._lock:
            return self.peers[nxt]

    def join(self, host: str, port: int) -> None:
        """Handshake with a known peer and adopt its peer list
        (CmdJoin + CmdPeerList)."""
        reply = self._call((host, port), {
            "cmd": "JOIN", "id": self.node_id,
            "host": self.addr[0], "port": self.addr[1],
        })
        with self._lock:
            for k, v in reply["peers"].items():
                self.peers.setdefault(int(k), tuple(v))

    def discover(self) -> None:
        """One gossip round with every known peer (CmdDiscover)."""
        with self._lock:
            peers = {str(k): list(v) for k, v in self.peers.items()}
            targets = [v for k, v in self.peers.items()
                       if k != self.node_id]
        for addr in targets:
            reply = self._call(addr, {"cmd": "DISCOVER", "peers": peers})
            with self._lock:
                for k, v in reply["peers"].items():
                    self.peers.setdefault(int(k), tuple(v))

    def notify_score(self, i: int, j: int, score: int) -> None:
        """Circulate a best-score candidate to every peer
        (CmdNotifyScore)."""
        with self._lock:
            if score > self.best_score[2]:
                self.best_score = (i, j, score)
            targets = [v for k, v in self.peers.items()
                       if k != self.node_id]
        for addr in targets:
            self._call(addr, {"cmd": "NOTIFY_SCORE",
                              "score": [i, j, score]})

    def status_of(self, node_id: int) -> dict:
        with self._lock:
            addr = self.peers[node_id]
        return self._call(addr, {"cmd": "STATUS"})

    def ring_test(self, timeout: float = 5.0) -> list[int]:
        """Send a token around the ring; returns the path it traveled
        (CmdTestRing)."""
        nxt = self._next_peer()
        if nxt is None:
            return [self.node_id]
        self._call(nxt, {"cmd": "RING_TEST", "origin": self.node_id,
                         "path": [self.node_id]}, wait=True)
        deadline = time.time() + timeout
        want = None
        while time.time() < deadline:
            with self._lock:
                for tok in self.ring_tokens:
                    if tok and tok[0] == self.node_id and len(tok) == len(
                            self.peers):
                        want = tok
                if want:
                    return want
            time.sleep(0.02)
        raise TimeoutError("ring token did not return")

    def close(self) -> None:
        self._stop.set()
        try:
            self._srv.close()
        except OSError:
            pass
        self._thread.join(timeout=2)
