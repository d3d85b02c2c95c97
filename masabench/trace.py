"""The traced run's instruments, all in the benchmark's own files: a span
around each stage function the entry calls (synchronised at its end, with
the kernel milliseconds of the program's launch events and its launch
counters drained there), and the profiler's device activity over the
pairs, with its idle gaps labelled by the stage the host was in.

The profiler records the device's activity only (CUPTI): recording every
host operation as well doubled the library call's stage 3.  Its
timestamps are ns of the wall clock, so the spans are taken with
``time.time_ns`` beside it.  Nothing here runs in an untraced run."""

from __future__ import annotations

import collections
import contextlib
import functools
import importlib
import time

import torch


class Tracer:
    """Wraps ``stages`` (a list of (module, function)) for one run; every
    span lands in ``spans`` as a dict: pair, stage, seconds, kernel_ms
    {wrapper: ms}, launches {wrapper: count}."""

    def __init__(self, stages, device: torch.device):
        self.stages = stages
        self.cuda = device.type == "cuda"
        self.device = device
        self.spans: list[dict] = []
        self.pairs: list[tuple[int, int]] = []
        self.pair_index = -1
        self._saved = []
        self._prof = None

    def _counts(self):
        from masa_tpu_torch.ops import kernels

        return {k[:-5]: getattr(kernels, k).launches for k in dir(kernels)
                if k.endswith("_cuda") and hasattr(getattr(kernels, k),
                                                   "launches")}

    def _wrap(self, fn, stage):
        from masa_tpu_torch.ops import kernels

        @functools.wraps(fn)
        def span(*args, **kwargs):
            before = self._counts()
            t0 = time.time_ns()
            out = fn(*args, **kwargs)
            if self.cuda:
                torch.cuda.synchronize(self.device)
            t1 = time.time_ns()
            after = self._counts()
            self.spans.append({
                "pair": self.pair_index, "stage": stage,
                "seconds": (t1 - t0) / 1e9, "ns": (t0, t1),
                "kernel_ms": kernels.drain_events() if self.cuda else {},
                "launches": {k: after[k] - before[k] for k in after
                             if after[k] != before[k]}})
            return out

        return span

    def start(self):
        from masa_tpu_torch.ops import kernels

        for mod_name, fn_name, stage in self.stages:
            mod = importlib.import_module(mod_name)
            fn = getattr(mod, fn_name)
            self._saved.append((mod, fn_name, fn))
            setattr(mod, fn_name, self._wrap(fn, stage))
        if self.cuda:
            kernels.event_log = []
            self._prof = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA])
            self._prof.__enter__()

    @contextlib.contextmanager
    def pair(self, k: int):
        self.pair_index = k
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.pairs.append((t0, time.time_ns()))

    def stop(self):
        from masa_tpu_torch.ops import kernels

        if self._prof is not None:
            self._prof.__exit__(None, None, None)
        for mod, fn_name, fn in self._saved:
            setattr(mod, fn_name, fn)
        self._saved = []
        kernels.event_log = None

    def device_activity(self) -> dict | None:
        """busy_s, window_s and the breakdown over the pairs' spans, from
        the profiler's device events; None where it saw none."""
        from torch.autograd import DeviceType

        if self._prof is None:
            return None
        dev = []
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0:
                t0 = e.start_ns()
                dev.append((t0, t0 + e.duration_ns(), e.name()))
        if not dev or not self.pairs:
            return None
        stages = [(*s["ns"], s["stage"]) for s in self.spans]
        return reduce_activity(self.pairs, stages, dev)


def reduce_activity(pairs, stages, dev) -> dict:
    """From intervals in ns: ``pairs`` [(t0, t1)], host ``stages`` [(t0,
    t1, name)] and device operations [(t0, t1, name)], the seconds in
    which some operation ran on the device inside the pairs (``busy_s``),
    the pairs' seconds (``window_s``), the device operations that took
    most time and the idle seconds by the stage the host was in (the
    entry's own work between stages is ``entry``)."""
    by_op = collections.Counter()
    clipped = []
    for t0, t1, name in dev:
        for p0, p1 in pairs:
            a, b = max(t0, p0), min(t1, p1)
            if a < b:
                clipped.append((a, b))
                by_op[name] += (b - a) / 1e9
    clipped.sort()
    busy, merged = 0, []
    for a, b in clipped:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged)
    # idle gaps inside each pair, split over the stages the host was in
    gaps = []
    k = 0
    for p0, p1 in pairs:
        t = p0
        while k < len(merged) and merged[k][1] <= p1:
            if merged[k][0] > t:
                gaps.append((t, merged[k][0]))
            t = max(t, merged[k][1])
            k += 1
        if t < p1:
            gaps.append((t, p1))
    idle = collections.Counter()
    for a, b in gaps:
        left = b - a
        for s0, s1, n in stages:
            part = min(b, s1) - max(a, s0)
            if part > 0:
                idle[n] += part / 1e9
                left -= part
        if left > 0:
            idle["entry"] += left / 1e9
    window = sum(p1 - p0 for p0, p1 in pairs)
    return {"busy_s": busy / 1e9, "window_s": window / 1e9,
            "breakdown": {
                "device_ops": [[n[:160], s] for n, s in by_op.most_common(10)],
                "idle_gaps": [[n, s] for n, s in idle.most_common(10)]}}
