"""Taken from ``masa_tpu/io/cells.py`` (the JAX reference).

Cells reader/writer stack: uniform streams of (H, gap) border cells.

Re-creation of the reference's io/ family (libs/masa-core/src/common/io/):
InitialCellsReader (synthesized borders), File*/Socket* (bulk transport),
URL* (scheme dispatch: file:// socket:// null://), Buffered* (background
pump so compute overlaps transport), Tee (persist while forwarding),
Reversed, Split, Dummy.  Cells travel as little-endian int32 (H, gap)
pairs — the wire unit the multi-process column streaming uses.
"""

from __future__ import annotations

import os
import socket
import time
import threading
from queue import Queue

import numpy as np

from masa_tpu_torch.models.scoring import border_cells
from masa_tpu_torch.types import INF, InitType, ScoreParams


class CellsReader:
    """Abstract reader: read(n) -> (h, g) int32 arrays of length n."""

    init_type = InitType.CUSTOM

    def read(self, n: int):
        raise NotImplementedError

    def close(self):
        pass


class CellsWriter:
    """Abstract writer: write(h, g)."""

    def write(self, h, g):
        raise NotImplementedError

    def close(self):
        pass


class InitialCellsReader(CellsReader):
    """Synthesizes border cells for an init type
    (common/io/InitialCellsReader)."""

    def __init__(self, init_type: InitType, params: ScoreParams,
                 start: int = 0):
        self.init_type = init_type
        self.params = params
        self.pos = start

    def seek(self, pos: int):
        self.pos = pos

    def read(self, n: int):
        h, g = border_cells(n, self.init_type, self.params, start=self.pos)
        self.pos += n
        return h.astype(np.int32), g.astype(np.int32)


class MemoryCellsReader(CellsReader):
    def __init__(self, h, g):
        self.h = np.asarray(h, np.int32)
        self.g = np.asarray(g, np.int32)
        self.pos = 0

    def seek(self, pos: int):
        self.pos = pos

    def read(self, n: int):
        out = (self.h[self.pos : self.pos + n],
               self.g[self.pos : self.pos + n])
        self.pos += n
        return out


def _encode(h, g) -> bytes:
    arr = np.empty((len(h), 2), np.int32)
    arr[:, 0] = h
    arr[:, 1] = g
    return arr.tobytes()


def _decode(raw: bytes):
    arr = np.frombuffer(raw, np.int32).reshape(-1, 2)
    return arr[:, 0].copy(), arr[:, 1].copy()


class FileCellsWriter(CellsWriter):
    def __init__(self, path: str):
        self.f = open(path, "wb")

    def write(self, h, g):
        self.f.write(_encode(h, g))
        self.f.flush()

    def close(self):
        self.f.close()


class FileCellsReader(CellsReader):
    """Blocks until the producer has written enough cells (the reference's
    file streams poll the growing file the same way).

    The starvation timeout is progress-based: it resets whenever the file
    grows, so a legitimately slow producer on a chromosome-scale serial
    split is never killed — only a producer that makes NO progress for
    `timeout` seconds (the reference polls unboundedly,
    AlignerPool.cpp:201-215; a no-progress bound is strictly safer)."""

    def __init__(self, path: str, poll: float = 0.01, timeout: float = 60.0):
        self.path = path
        self.poll = poll
        self.timeout = timeout
        self.offset = 0

    def read(self, n: int):
        import time

        need = 8 * n
        deadline = time.time() + self.timeout
        last_size = -1
        while True:
            size = os.path.getsize(self.path) if os.path.exists(
                self.path) else -1
            if size >= self.offset + need:
                with open(self.path, "rb") as f:
                    f.seek(self.offset)
                    raw = f.read(need)
                self.offset += need
                return _decode(raw)
            if size > last_size:
                last_size = size
                deadline = time.time() + self.timeout
            if time.time() > deadline:
                raise TimeoutError(
                    f"cells stream {self.path} made no progress for "
                    f"{self.timeout}s")
            time.sleep(self.poll)


class SocketCellsWriter(CellsWriter):
    """Listens and streams cells to one peer
    (io/SocketCellsWriter semantics: the writer is the server)."""

    def __init__(self, port: int, host: str = "127.0.0.1"):
        self.srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.srv.bind((host, port))
        self.srv.listen(1)
        self.conn = None

    def _ensure(self):
        if self.conn is None:
            self.conn, _ = self.srv.accept()

    def write(self, h, g):
        self._ensure()
        self.conn.sendall(_encode(h, g))

    def close(self):
        if self.conn:
            self.conn.close()
        self.srv.close()


class SocketCellsReader(CellsReader):
    """Connects and reads cells (io/SocketCellsReader.cpp:33-80)."""

    def __init__(self, host: str, port: int, timeout: float = 60.0,
                 retry: float = 0.05):
        import time

        deadline = time.time() + timeout
        while True:
            try:
                self.sock = socket.create_connection((host, port),
                                                     timeout=timeout)
                break
            except OSError:
                if time.time() > deadline:
                    raise
                time.sleep(retry)

    def read(self, n: int):
        need = 8 * n
        chunks = []
        while need:
            got = self.sock.recv(min(need, 1 << 20))
            if not got:
                raise EOFError("cells socket closed early")
            chunks.append(got)
            need -= len(got)
        return _decode(b"".join(chunks))

    def close(self):
        self.sock.close()


class DummyCellsReader(CellsReader):
    """null:// source: constant cells (io/DummyCellsReader)."""

    def __init__(self, value: int = -INF):
        self.value = value

    def read(self, n: int):
        return (np.full(n, self.value, np.int32),
                np.full(n, -INF, np.int32))


class DummyCellsWriter(CellsWriter):
    def write(self, h, g):
        pass


class TeeCellsReader(CellsReader):
    """Forwards a stream while persisting it (io/TeeCellsReader)."""

    def __init__(self, inner: CellsReader, writer: CellsWriter):
        self.inner = inner
        self.writer = writer

    def read(self, n: int):
        h, g = self.inner.read(n)
        self.writer.write(h, g)
        return h, g

    def close(self):
        self.inner.close()
        self.writer.close()


class ReversedCellsReader(CellsReader):
    """Reads a whole in-memory stream backwards
    (io/ReversedCellsReader)."""

    def __init__(self, inner: CellsReader, total: int):
        h, g = inner.read(total)
        self.h = h[::-1].copy()
        self.g = g[::-1].copy()
        self.pos = 0

    def seek(self, pos: int):
        self.pos = pos

    def read(self, n: int):
        out = (self.h[self.pos : self.pos + n],
               self.g[self.pos : self.pos + n])
        self.pos += n
        return out


class SplitCellsReader(CellsReader):
    """Serves a sub-range of a seekable reader (io/SplitCellsReader)."""

    def __init__(self, inner, start: int, length: int):
        self.inner = inner
        self.inner.seek(start)
        self.remaining = length

    def read(self, n: int):
        n = min(n, self.remaining)
        self.remaining -= n
        return self.inner.read(n)


class BufferedCellsReader(CellsReader):
    """Background-thread pump: prefetches chunks through a queue so the
    consumer never blocks on transport (io/BufferedCellsReader + Buffer2's
    producer/consumer machinery)."""

    def __init__(self, inner: CellsReader, chunk: int = 4096,
                 depth: int = 8, total: int | None = None,
                 log_file: str | None = None):
        self.inner = inner
        self.chunk = chunk
        self.queue: Queue = Queue(maxsize=depth)
        self.total = total
        self.buf_h = np.empty(0, np.int32)
        self.buf_g = np.empty(0, np.int32)
        self.err = None
        # throughput statistics (Buffer2 stats + BufferLogger,
        # io/Buffer2.hpp:55-123)
        self.cells_in = 0
        self.blocked_s = 0.0
        self._t0 = time.time()
        self._log_file = log_file
        self.thread = threading.Thread(target=self._pump, daemon=True)
        self.thread.start()

    def _pump(self):
        left = self.total
        try:
            while left is None or left > 0:
                n = self.chunk if left is None else min(self.chunk, left)
                self.queue.put(self.inner.read(n))
                if left is not None:
                    left -= n
        except Exception as e:  # propagate to the consumer
            self.err = e
        self.queue.put(None)

    def read(self, n: int):
        while len(self.buf_h) < n:
            t0 = time.time()
            item = self.queue.get()
            self.blocked_s += time.time() - t0
            if item is None:
                if self.err:
                    raise self.err
                raise EOFError("buffered cells stream exhausted")
            self.cells_in += len(item[0])
            self.buf_h = np.concatenate([self.buf_h, item[0]])
            self.buf_g = np.concatenate([self.buf_g, item[1]])
        out = self.buf_h[:n], self.buf_g[:n]
        self.buf_h = self.buf_h[n:]
        self.buf_g = self.buf_g[n:]
        return out

    def stats(self) -> dict:
        """Throughput counters (cells received, consumer-blocked seconds,
        mean cells/s) — the Buffer2 statistics surface."""
        dt = max(time.time() - self._t0, 1e-9)
        st = {"cells": self.cells_in, "blocked_s": round(self.blocked_s, 3),
              "cells_per_s": round(self.cells_in / dt, 1)}
        if self._log_file:
            with open(self._log_file, "a") as f:
                f.write(repr(st) + "\n")
        return st


class BufferedCellsWriter(CellsWriter):
    """Background-thread flusher (io/BufferedCellsWriter)."""

    def __init__(self, inner: CellsWriter, depth: int = 8):
        self.inner = inner
        self.queue: Queue = Queue(maxsize=depth)
        self.err = None
        self.cells_out = 0
        self.blocked_s = 0.0
        self.thread = threading.Thread(target=self._pump, daemon=True)
        self.thread.start()

    def _pump(self):
        while True:
            item = self.queue.get()
            if item is None:
                break
            try:
                self.inner.write(*item)
            except Exception as e:
                self.err = e
                break

    def write(self, h, g):
        if self.err:
            raise self.err
        t0 = time.time()
        self.queue.put((np.asarray(h, np.int32).copy(),
                        np.asarray(g, np.int32).copy()))
        self.blocked_s += time.time() - t0
        self.cells_out += len(h)

    def stats(self) -> dict:
        return {"cells": self.cells_out,
                "blocked_s": round(self.blocked_s, 3)}

    def close(self):
        self.queue.put(None)
        self.thread.join(timeout=60)
        self.inner.close()


def open_reader(url: str, params: ScoreParams | None = None) -> CellsReader:
    """URL dispatch (io/URLCellsReader.cpp:29-58): file://path,
    socket://host:port, null://value."""
    if url.startswith("file://"):
        return FileCellsReader(url[7:])
    if url.startswith("socket://"):
        host, port = url[9:].rsplit(":", 1)
        return SocketCellsReader(host, int(port))
    if url.startswith("null://"):
        v = url[7:]
        return DummyCellsReader(int(v) if v else -INF)
    raise ValueError(f"unsupported cells URL {url}")


def open_writer(url: str) -> CellsWriter:
    if url.startswith("file://"):
        return FileCellsWriter(url[7:])
    if url.startswith("socket://"):
        host, port = url[9:].rsplit(":", 1)
        return SocketCellsWriter(int(port), host)
    if url.startswith("null://"):
        return DummyCellsWriter()
    raise ValueError(f"unsupported cells URL {url}")
