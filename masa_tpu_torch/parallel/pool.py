"""Taken from ``masa_tpu/parallel/pool.py`` (the JAX reference).

AlignerPool: inter-node control messages through a shared directory
with sentinel files (common/AlignerPool.cpp:28-215) — best scores flow to
the right neighbor, crosspoints to the left, stage-4 crosspoint files are
handed off whole.  Transport-agnostic consumers only see typed messages.
"""

from __future__ import annotations

import json
import os
import time

from masa_tpu_torch.types import BestScore, Crosspoint


class AlignerPool:
    def __init__(self, shared_dir: str, node_id: int, num_nodes: int,
                 poll: float = 0.01, timeout: float = 120.0):
        self.dir = shared_dir
        self.node = node_id
        self.num_nodes = num_nodes
        self.poll = poll
        self.timeout = timeout
        self._seq = {}
        os.makedirs(shared_dir, exist_ok=True)
        self._register()

    # --- registration (AlignerPool::registerNode) ---------------------

    def _register(self):
        self._send_to(self.node, "register", {"node": self.node})

    def is_first_node(self) -> bool:
        return self.node == 0

    def is_last_node(self) -> bool:
        return self.node == self.num_nodes - 1

    # --- typed messages ------------------------------------------------

    def _msg_path(self, dst: int, kind: str, seq: int) -> str:
        return os.path.join(self.dir, f"msg.{dst:02d}.{kind}.{seq:06d}")

    def _send_to(self, dst: int, kind: str, payload: dict):
        seq = self._seq.get((dst, kind), 0)
        self._seq[(dst, kind)] = seq + 1
        path = self._msg_path(dst, kind, seq)
        with open(path + ".tmp", "w") as f:
            json.dump(payload, f)
        os.replace(path + ".tmp", path)
        # the sentinel marks the message complete (the reference's
        # .signal files)
        open(path + ".signal", "w").close()

    def _recv(self, kind: str, seq_key: str):
        seq = self._seq.get(("recv", kind), 0)
        self._seq[("recv", kind)] = seq + 1
        path = self._msg_path(self.node, kind, seq)
        deadline = time.time() + self.timeout
        while not os.path.exists(path + ".signal"):
            if time.time() > deadline:
                raise TimeoutError(f"pool starved waiting for {path}")
            time.sleep(self.poll)
        with open(path) as f:
            return json.load(f)

    # --- protocol (sw_stage1.cpp:421-478, sw_stage2.cpp:133-235) -------

    def dispatch_score(self, score: BestScore):
        """Best score to the right neighbor (stage 1)."""
        if not self.is_last_node():
            self._send_to(self.node + 1, "score",
                          {"i": score.i, "j": score.j, "score": score.score})

    def receive_score(self) -> BestScore:
        d = self._recv("score", "score")
        return BestScore(d["i"], d["j"], d["score"])

    def dispatch_crosspoint(self, cp: Crosspoint, final: bool):
        """Crosspoint to the left neighbor (stage 2 pipeline)."""
        if not self.is_first_node():
            self._send_to(self.node - 1, "crosspoint",
                          {"i": cp.i, "j": cp.j, "score": cp.score,
                           "type": int(cp.type), "final": final})

    def receive_crosspoint(self) -> tuple[Crosspoint, bool]:
        d = self._recv("crosspoint", "crosspoint")
        return (Crosspoint(d["i"], d["j"], d["score"], d["type"]),
                d["final"])

    def dispatch_file(self, path: str, tag: str):
        """Whole-file handoff to the left neighbor (stage-4 crosspoints,
        sw_stage4.cpp:854-881)."""
        if not self.is_first_node():
            with open(path) as f:
                self._send_to(self.node - 1, f"file.{tag}",
                              {"name": os.path.basename(path),
                               "data": f.read()})

    def receive_file(self, tag: str, dst_dir: str) -> str:
        d = self._recv(f"file.{tag}", "file")
        out = os.path.join(dst_dir, d["name"])
        with open(out, "w") as f:
            f.write(d["data"])
        return out
