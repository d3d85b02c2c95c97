"""The arithmetic the metrics' readers share: rates over the window, and
per-pair totals of the traced run's spans, launch counters and device
activity.  Each returns None where the run has nothing to read."""

from __future__ import annotations

from masabench import frozen


def gcups(run):
    """The m*n of every pair finished in the window, over the window's
    seconds, in 10^9 cells a second."""
    if not run.cells or run.window_s <= 0:
        return None
    return sum(run.cells) / run.window_s / 1e9


def _per_pair(total, run):
    return total / run.pairs_done if run.pairs_done else None


def stage_s(stage):
    """A stage's seconds a pair: its spans, each ended by a device sync."""
    def read(run):
        spans = run.stage_s(stage)
        return _per_pair(sum(spans), run) if spans else None
    return read


def stage1_host_s(run):
    """Stage 1's seconds a pair less kernel 1's, by its launch events."""
    spans = run.stage_s("stage1")
    if not spans:
        return None
    return _per_pair(sum(spans) - sum(run.kernel_ms("stage1", "strip"))
                     / 1e3, run)


def launches(stage, wrapper):
    def read(run):
        got = run.launches(stage, wrapper)
        return _per_pair(sum(got), run) if got else None
    return read


def strip_roofline(run):
    """The matrix's cells x 5 INT32-lane instructions over the peak, as a
    share of kernel 1's event time in stage 1 (%)."""
    ms = sum(run.kernel_ms("stage1", "strip"))
    if ms <= 0:
        return None
    bound_s = (run.cells_of("stage1") * frozen.CELL_INSTRUCTIONS
               / frozen.INT32_PEAK)
    return 100.0 * bound_s / (ms / 1e3)


def device_idle(run):
    """The share of the pairs' time in which no operation ran on the
    device (%), from the profiler's device events."""
    a = run.activity
    if not a or a["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - a["busy_s"] / a["window_s"])
