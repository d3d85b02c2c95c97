"""The port's own spans and counters, recorded while the kernels' launch
events are (``ops.kernels.event_log`` is a list: the one trace switch).

    with trace.stage("stage1", device): ...  # what is recorded inside
    with trace.span("rows.write"): ...       #   carries the stage's name
    trace.count("partitions")

``spans`` holds (name, stage, t0_ns, t1_ns) on ``time.time_ns``'s clock,
the clock of the profiler's device events, so a span lies against the
device's activity gap by gap; a stage's own span carries its own name as
its stage.  ``counts`` maps (stage, name) to a count.  A stage span ends
with a device sync on a CUDA device; no other span syncs.  With the
switch off a site costs a read of ``event_log`` and a test, and records
nothing.  Switching off keeps what was recorded; ``reset()`` empties it.
Nothing here is locked: a counter from threads at once may lose counts.
"""

from __future__ import annotations

import contextlib
import time

import torch

from masa_tpu_torch.ops import kernels

spans: list[tuple[str, str | None, int, int]] = []
counts: dict[tuple[str | None, str], int] = {}
_stage: str | None = None  # the stage the recorded sites run in
_OFF = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.time_ns()

    def __exit__(self, *exc):
        spans.append((self.name, _stage, self.t0, time.time_ns()))


class _Stage:
    __slots__ = ("name", "device", "outer", "t0")

    def __init__(self, name: str, device):
        self.name, self.device = name, device

    def __enter__(self):
        global _stage
        self.outer, _stage = _stage, self.name
        self.t0 = time.time_ns()

    def __exit__(self, exc_type, *exc):
        global _stage
        try:
            if exc_type is None:
                _sync(self.device)
            spans.append((self.name, self.name, self.t0, time.time_ns()))
        finally:
            _stage = self.outer


def _sync(device) -> None:
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def span(name: str):
    """A context manager that records the time inside it as ``name``."""
    if kernels.event_log is None:
        return _OFF
    return _Span(name)


def stage(name: str, device=None):
    """The span of stage ``name`` on ``device``: the spans and counts
    recorded inside it carry its name, and it ends with a device sync."""
    if kernels.event_log is None:
        return _OFF
    return _Stage(name, device)


def count(name: str, k: int = 1) -> None:
    """Add ``k`` to the counter ``name`` of the current stage."""
    if kernels.event_log is None:
        return
    key = (_stage, name)
    counts[key] = counts.get(key, 0) + k


def stage_runner(device, on_stage=None):
    """``run(name, fn, *args, **kw)``: ``fn(*args, **kw)`` inside
    ``stage(name, device)``; ``on_stage(name, seconds, result)``, when
    given, is called as it ends, with its host-clock seconds up to a
    device sync."""
    def run(name, fn, *args, **kw):
        t0 = time.perf_counter()
        with stage(name, device):
            out = fn(*args, **kw)
        if on_stage:
            _sync(device)
            on_stage(name, time.perf_counter() - t0, out)
        return out

    return run


def reset() -> None:
    """Forget every span and count."""
    global _stage
    spans.clear()
    counts.clear()
    _stage = None
