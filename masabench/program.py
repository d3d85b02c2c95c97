"""Per-pair totals of the program's own records: the spans and counters
``masa_tpu_torch.utils.trace`` keeps while the traced run's switch
(``kernels.event_log``) is on, that is over the window.  A span is
(name, stage, t0_ns, t1_ns); a stage's own span carries its name as its
stage.  Each reader returns None where nothing was recorded, as on a
program without the recorder."""

from __future__ import annotations


def _recorder():
    try:
        from masa_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace


def span_s(stage: str, names: tuple[str, ...]):
    """The seconds a pair of the spans named ``names`` inside ``stage``."""
    def read(run):
        trace = _recorder()
        if trace is None or not run.pairs_done:
            return None
        got = [t1 - t0 for name, where, t0, t1 in trace.spans
               if where == stage and name in names]
        return sum(got) / 1e9 / run.pairs_done if got else None
    return read


def stage_s(stage: str):
    """The seconds a pair of the stage's own span (ended by a device
    sync)."""
    return span_s(stage, (stage,))


def count(stage: str, name: str):
    """The counter ``name`` of ``stage``, a pair."""
    def read(run):
        trace = _recorder()
        if trace is None or not run.pairs_done:
            return None
        k = trace.counts.get((stage, name))
        return k / run.pairs_done if k else None
    return read


# the four spans of a special row's way to its store; none nests in another
ROWS = ("rows.pack", "rows.pull", "rows.escapes", "rows.write")
# the host blocked on the card: a read of a result, and a row's copy
WAITS = ("wait", "rows.pull")
